"""What the sharded uplink step costs as the mesh grows, on the device
given.

Builds `make_mesh(n, device)` at each shard count (a (chan, time) grid;
every shard on the one card, or on the CPU) with `--chan-per-shard`
carriers on each channel shard, and times `sharded_uplink_pipeline`
three ways: in full (halo exchange, clock reduction, state carry),
without the state carry, and without collectives. For each it reports
ms a step, the mesh's bytes a step (`Mesh.traffic`: the bytes that land
on one shard, by collective) and K1's launches a step. With every shard
on one card this is the cost of the sharded program there, not a
measure of scaling across cards.

    python -m openbts_ttsou_tpu_torch.tools.scaling_bench \\
        [--shards 1,2,4] [--chan-per-shard 2,64]
"""

from __future__ import annotations

import numpy as np
import torch

from openbts_ttsou_tpu_torch.tools import common

TOOL = "scaling_bench"
WAYS = {"full": {}, "no_carry": {"carry_state": False},
        "no_collectives": {"collectives": False}}


def setup(n_shards: int, chan_per_shard: int, frames: int,
          dev: torch.device, seed: int = 0):
    """(mesh, cfg, spec, state_sh, samples) of one mesh size."""
    from openbts_ttsou_tpu_torch.parallel import make_mesh
    from openbts_ttsou_tpu_torch.parallel.sharded import (
        ShardedPipelineSpec, state_for_shards)
    from openbts_ttsou_tpu_torch.trx.engine import (ChanType, TrxConfig,
                                                    init_state)

    mesh = make_mesh(n_shards, str(dev))
    n_time = mesh.shape["time"]
    n_chan = chan_per_shard * mesh.shape["chan"]
    cfg = TrxConfig(n_chan=n_chan)
    spec = ShardedPipelineSpec(n_chan_total=n_chan, frames_per_shard=frames)
    ct = torch.zeros((n_chan, 8), dtype=torch.int32)
    ct[:, 1:] = ChanType.I
    state = init_state(cfg, dev)._replace(chan_type=ct.to(dev))
    rng = np.random.default_rng(seed)
    t = n_time * spec.block_in
    samples = torch.from_numpy(
        ((rng.standard_normal((n_chan, t))
          + 1j * rng.standard_normal((n_chan, t))) * 400.0
         ).astype(np.complex64)).to(dev)
    return mesh, cfg, spec, state_for_shards(state, n_time), samples


def one_size(n_shards: int, chan_per_shard: int, frames: int,
             dev: torch.device, reps: int) -> dict:
    from openbts_ttsou_tpu_torch.parallel.sharded import (
        sharded_uplink_pipeline)

    mesh, cfg, spec, st, x = setup(n_shards, chan_per_shard, frames, dev)
    row = {"shards": n_shards, "mesh": dict(mesh.shape),
           "carriers": cfg.n_chan, "chan_per_shard": chan_per_shard,
           "samples_per_step": cfg.n_chan * mesh.shape["time"]
           * spec.block_in}
    for way, kw in WAYS.items():
        step = sharded_uplink_pipeline(mesh, cfg, spec, **kw)
        step(st, x, 0)  # warm
        common.sync(dev)
        mesh.reset_traffic()
        k0 = common.k1_launches()
        step(st, x, 0)
        common.sync(dev)
        k1_step = common.k1_launches() - k0
        traffic = {k: list(v) for k, v in mesh.traffic.items()}
        r = common.measure(lambda: step(st, x, 0), dev, reps=reps,
                           warmup=0, profile=False)
        r["k1_launches_per_step"] = k1_step
        r["traffic"] = traffic
        r["bytes_per_step"] = sum(b for _, b in traffic.values())
        r["msamples_per_s"] = row["samples_per_step"] / r["wall_ms"] / 1e3
        row[way] = r
    return row


def main(argv=None) -> dict:
    ap = common.parser(__doc__)
    ap.add_argument("--shards", default="1,2,4")
    ap.add_argument("--chan-per-shard", default="2,64")
    ap.add_argument("--frames-per-shard", type=int, default=13)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    dev = common.device_of(args)
    rows = []
    for cps in (int(c) for c in args.chan_per_shard.split(",")):
        for n in (int(s) for s in args.shards.split(",")):
            rows.append(one_size(n, cps, args.frames_per_shard, dev,
                                 args.reps))
            common.log(TOOL, f"{n} shards x {cps}: "
                             f"{rows[-1]['full']['wall_ms']:.1f} ms a step")
    return common.emit({"tool": TOOL,
                        "note": "cost on one card, not scaling"
                        if dev.type == "cuda" else
                        "cost on the CPU, not scaling",
                        "rows": rows, **common.card(dev)})


if __name__ == "__main__":
    main()
