"""Dry run of the sharded pipelines over a mesh of N shards in one
process (the counterpart of the JAX package's
`__graft_entry__.dryrun_multichip`).

    python -m openbts_ttsou_tpu_torch.parallel.dryrun --shards 4
    python -m openbts_ttsou_tpu_torch.parallel.dryrun --shards 8 --device cpu

Over a (chan × time) mesh of N shards, 2 carriers a chan shard, random
noise at the device rate, it runs one sharded uplink step, one full
duplex step, the duplex fed by the chan-sharded TCH/FS + FACCH encoder
(`l1fec.tch_tx_window` on each chan shard's burst lanes), and two
chained steps of the streaming decode with the static slot split, and
checks their shapes. Then the collective inventory, from the mesh's own
byte counts for one step (what lands on one shard, as XLA's inventory
counts a device's): when time > 1 the rx halo ring moves
2·c_local·halo_in·8 B a step in 2 exchanges and the duplex adds the tx
symbol ring's 2·c_local·65·8 B; the sums and maxima stay under 1024 B;
and all traffic together stays under 5% of a shard's input. Prints one
JSON line, `"ok": true` when every check held; exits 1 otherwise.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from openbts_ttsou_tpu_torch.gsm import l1fec
from openbts_ttsou_tpu_torch.models.transceiver import DECODE_PRELUDE
from openbts_ttsou_tpu_torch.parallel.mesh import make_mesh
from openbts_ttsou_tpu_torch.parallel.sharded import (
    ShardedPipelineSpec,
    sharded_duplex_pipeline,
    sharded_uplink_pipeline,
    state_for_shards,
)
from openbts_ttsou_tpu_torch.trx.engine import (ChanType, TrxConfig,
                                                init_state, resolve_device)


def _traffic(mesh, fn) -> dict:
    """The mesh's collective traffic over one call of fn."""
    mesh.reset_traffic()
    fn()
    return {k: {"count": v[0], "bytes_per_step": v[1]}
            for k, v in mesh.traffic.items()}


class Steps(NamedTuple):
    """One sharded uplink step and one duplex step over a mesh, with
    their outputs and the mesh's traffic in each."""

    mesh: object
    cfg: TrxConfig
    spec: ShardedPipelineSpec
    state_sh: object
    samples: torch.Tensor
    att: torch.Tensor
    duplex: object
    uplink_out: tuple
    duplex_out: tuple
    traffic_up: dict
    traffic_dup: dict


def sharded_steps(n_shards: int, device="cuda",
                  carriers: int | None = None) -> Steps:
    """One sharded uplink step and one full duplex step (the time-sharded
    downlink: the tx symbol-halo ring and a 96/65 resample a shard) over
    a mesh of n_shards at `carriers` (default 2 a chan shard), on random
    noise at the device rate, each with the mesh's traffic."""
    dev = resolve_device(device)
    mesh = make_mesh(n_shards, dev)
    n_chan_dev, n_time = mesh.shape["chan"], mesh.shape["time"]
    n_chan = carriers or 2 * n_chan_dev
    if n_chan % n_chan_dev:
        raise ValueError(f"{n_chan} carriers do not split over "
                         f"{n_chan_dev} chan shards")
    cfg = TrxConfig(n_chan=n_chan)
    spec = ShardedPipelineSpec(n_chan_total=n_chan, frames_per_shard=13)
    frames_total = n_time * 13

    chan_type = torch.full((n_chan, 8), ChanType.I, dtype=torch.int32,
                           device=dev)
    chan_type[:, 0] = ChanType.IV
    state_sh = state_for_shards(
        init_state(cfg, dev)._replace(chan_type=chan_type), n_time)
    rng = np.random.default_rng(0)
    samples = torch.from_numpy(
        (rng.standard_normal((n_chan, n_time * spec.block_in))
         + 1j * rng.standard_normal((n_chan, n_time * spec.block_in))
         ).astype(np.complex64) * 400.0).to(dev)

    step = sharded_uplink_pipeline(mesh, cfg, spec)
    out = {}
    traffic_up = _traffic(mesh, lambda: out.update(up=step(state_sh, samples,
                                                           0)))
    bits = torch.zeros((frames_total, n_chan, 8, 148), dtype=torch.uint8,
                       device=dev)
    valid = torch.ones((frames_total, n_chan, 8), dtype=torch.bool,
                       device=dev)
    att = torch.zeros((frames_total, n_chan, 8), dtype=torch.float32,
                      device=dev)
    duplex = sharded_duplex_pipeline(mesh, cfg, spec)
    traffic_dup = _traffic(mesh, lambda: out.update(
        dup=duplex(state_sh, samples, bits, valid, att, 0)))
    return Steps(mesh, cfg, spec, state_sh, samples, att, duplex, out["up"],
                 out["dup"], traffic_up, traffic_dup)


def run(n_shards: int, device="cuda") -> dict:
    """Run the dry run; raises AssertionError on a failed check."""
    t0 = time.perf_counter()
    s = sharded_steps(n_shards, device)
    mesh, cfg, spec, state_sh, samples = (s.mesh, s.cfg, s.spec, s.state_sh,
                                          s.samples)
    traffic_up, traffic_dup = s.traffic_up, s.traffic_dup
    dev = samples.device
    n_chan_dev, n_time = mesh.shape["chan"], mesh.shape["time"]
    n_chan = cfg.n_chan
    c_local = n_chan // n_chan_dev
    frames_total = n_time * 13
    _, res, clock = s.uplink_out
    assert res.soft_bits.shape == (frames_total, n_chan, 8, 148)
    assert int(clock) == n_time * spec.block_in
    _, res2, tx, _ = s.duplex_out
    assert tx.shape == (n_chan, n_time * spec.block_in)
    assert res2.soft_bits.shape == (frames_total, n_chan, 8, 148)

    # the TCH/FS + FACCH downlink encoder, chan-sharded: each chan
    # shard's burst lanes encode on its device (the windowed diagonal
    # encoder, GSML1FEC.cpp:1106-1120), feeding the same duplex step
    lanes_local = c_local * 8
    gmax = int(l1fec._tch_tx_tables(frames_total)[2].max())
    rng2 = np.random.default_rng(1)
    speech = rng2.integers(0, 2, (gmax, n_chan * 8, 260)).astype(np.uint8)
    tbits, t_valid = [], []
    for c in range(n_chan_dev):
        sdev = mesh.at(c, 0).device
        lanes = slice(c * lanes_local, (c + 1) * lanes_local)
        b, isb, _hu, _carry = l1fec.tch_tx_window(
            torch.from_numpy(speech[:, lanes]).to(sdev),
            torch.ones((gmax, lanes_local), dtype=torch.bool, device=sdev),
            torch.zeros((gmax, lanes_local, 184), dtype=torch.uint8,
                        device=sdev),
            torch.zeros((gmax, lanes_local), dtype=torch.bool, device=sdev),
            l1fec.TchTxCarry.zeros(lanes_local, sdev),
            torch.zeros((), dtype=torch.int32, device=sdev), frames_total)
        tbits.append(b.reshape(frames_total, c_local, 8, 148).to(dev))
        t_valid.append(isb.reshape(frames_total, c_local, 8).to(dev))
    _, _, tx2, _ = s.duplex(state_sh, samples, torch.cat(tbits, 1),
                            torch.cat(t_valid, 1), s.att, 0)
    assert tx2.shape == (n_chan, n_time * spec.block_in)

    # the streaming FEC decode, time-sharded, with the static slot split:
    # the soft-bit prelude crosses shard boundaries (one hop along time)
    # and step boundaries (the carried prev_soft); two chained steps so
    # both crossings run
    dstep = sharded_uplink_pipeline(mesh, cfg, spec, mode="decoded",
                                    xcch_tns=(0, 1, 6, 7),
                                    tch_tns=(2, 3, 4, 5))
    prev = torch.zeros((1, DECODE_PRELUDE, n_chan, 8, 148),
                       dtype=torch.float32, device=dev)
    pvalid = torch.zeros((), dtype=torch.bool, device=dev)
    st_sh = state_sh
    for k in range(2):
        st_sh, res5, _, dec5 = dstep(st_sh, samples, 13 * n_time * k, prev,
                                     pvalid)
        prev = res5.soft_bits[-DECODE_PRELUDE:][None]
        pvalid = torch.ones((), dtype=torch.bool, device=dev)
    n_g = (DECODE_PRELUDE + 13) // 4  # groups a shard, prelude included
    assert dec5.bits.shape == (n_time * n_g, n_chan, 8, 184)
    assert dec5.tch_speech.shape[1:] == (n_chan, 8, 260)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    run_s = time.perf_counter() - t0

    # the collective inventory, from the mesh's byte counts
    want_cp = 2 * c_local * spec.halo_in * 8  # rx halo ring, complex64
    if n_time > 1:
        assert traffic_up["permute"] == {"count": 2,
                                         "bytes_per_step": want_cp}, \
            (traffic_up, want_cp)
        want_dup = want_cp + 2 * c_local * 65 * 8  # + the tx symbol ring
        assert traffic_dup["permute"]["bytes_per_step"] == want_dup, \
            (traffic_dup, want_dup)
    ar = traffic_up.get("all-reduce", {})
    assert ar.get("count", 0) >= 2 and ar.get("bytes_per_step", 0) < 1024, ar
    local_in = spec.block_in * 8 * c_local
    total_up = sum(v["bytes_per_step"] for v in traffic_up.values())
    total_dup = sum(v["bytes_per_step"] for v in traffic_dup.values())
    assert total_up < 0.05 * local_in, (total_up, local_in)
    assert total_dup < 0.05 * local_in, (total_dup, local_in)
    return {"ok": True, "shards": n_shards, "mesh": mesh.shape,
            "device": str(dev), "carriers": n_chan,
            "uplink_traffic": traffic_up, "duplex_traffic": traffic_dup,
            "uplink_bytes_per_step": total_up,
            "duplex_bytes_per_step": total_dup,
            "local_input_bytes_per_step": local_in, "run_s": run_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shards", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    try:
        out = run(args.shards, args.device)
    except AssertionError as e:
        print(json.dumps({"ok": False, "shards": args.shards,
                          "error": repr(e)}), flush=True)
        return 1
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
