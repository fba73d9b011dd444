"""One rank of a multi-process run of the sharded pipelines (the
counterpart of the JAX package's `tools/distributed_worker.py`).

The reference's two cooperating processes are joined by UDP
(Transceiver52M/Transceiver.cpp:42-44; SURVEY.md §2.2 P5); here each
rank owns a run of the time shards of a (1 × ranks·shards_per_rank)
mesh, feeds its rectangle of the global sample stream, and the halos
and the state merge ride `torch.distributed` between ranks.

    python -m openbts_ttsou_tpu_torch.parallel.worker --world-size 2 \\
        --rank 0 --init-method file:///tmp/rdv --device cpu [--duplex]

(one a rank; WORLD_SIZE/RANK/MASTER_ADDR/MASTER_PORT in the environment
work too). Every rank builds the same deterministic scenario (TSC-0
bursts at amplitude 9000 on slot 1 of every third frame), checks its
own shards against the port's serial chain (the full-stream resample
and `rx_step` frame by frame; with `--duplex` also the tx against
`downlink_block`), sums the mismatches over the ranks and prints one
JSON line. Exits 1 when a check failed. A step is timed from its call to
the device's end of it, the checks apart; `per_step_s` leaves out the
first step. The line also carries a digest of each of its frames' soft
bits and of each of its shards' tx a step, so runs that split the same
program differently over ranks compare bit for bit
(`tools/scaling_2proc.py`). `--backend gloo` puts ranks that share one
card in one group (NCCL refuses two ranks on one card).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from openbts_ttsou_tpu_torch.models.transceiver import (UplinkSpec,
                                                        _slot_windows,
                                                        downlink_block)
from openbts_ttsou_tpu_torch.ops import fir, gmsk
from openbts_ttsou_tpu_torch.parallel import distributed
from openbts_ttsou_tpu_torch.parallel.mesh import Mesh
from openbts_ttsou_tpu_torch.parallel.sharded import (
    ShardedPipelineSpec,
    sharded_duplex_pipeline,
    sharded_uplink_pipeline,
    state_for_shards,
)
from openbts_ttsou_tpu_torch.trx.engine import (ChanType, TrxConfig,
                                                init_state, resolve_device,
                                                rx_step)
from openbts_ttsou_tpu_torch.utils import constants as C


def scenario(n_carriers: int, frames_total: int) -> np.ndarray:
    """The device-rate stream [n_carriers, frames_total·24000/13]: one
    TSC-0 burst at amplitude 9000 on slot 1 of frames 1, 4, 7, …,
    upsampled 96/65 from the symbol rate."""
    rng = np.random.default_rng(7)
    bits = np.concatenate(
        [[0, 0, 0], rng.integers(0, 2, 57), [1], C.TRAINING_SEQUENCE[0],
         [1], rng.integers(0, 2, 57), [0, 0, 0]]).astype(np.uint8)
    wave = 9000.0 * gmsk.modulate_burst_np(bits[None], 1)[0]
    sym = np.zeros((1, frames_total * 1250), np.complex64)
    for f in range(1, frames_total, 3):
        sym[0, f * 1250 + 157: f * 1250 + 157 + len(wave)] += wave
    sym = np.broadcast_to(sym, (n_carriers, sym.shape[1])).copy()
    return fir.polyphase_resample(torch.from_numpy(sym), 96, 65,
                                  fir.resampler_lpf(96, 65, 651)).numpy()


def digest(a: np.ndarray) -> str:
    """A short digest of an array's bytes."""
    return hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world-size", type=int, default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--init-method", default=None,
                    help="tcp://host:port or file:///path (default: "
                         "MASTER_ADDR/MASTER_PORT)")
    ap.add_argument("--shards-per-rank", type=int, default=1)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--carriers", type=int, default=1)
    ap.add_argument("--duplex", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="seconds any collective may wait")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="process group backend (default: nccl on cuda, "
                         "gloo on the CPU)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    distributed.initialize(args.init_method, args.world_size, args.rank,
                           dev, args.timeout, args.backend)
    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    per = args.shards_per_rank
    n_time = world * per
    mesh = Mesh((1, n_time), [dev] * n_time,
                [i // per for i in range(n_time)])

    n = args.carriers
    cfg = TrxConfig(n_chan=n)
    spec = ShardedPipelineSpec(n_chan_total=n, frames_per_shard=13)
    frames_step = n_time * spec.frames_per_shard
    frames_total = args.steps * frames_step
    dev_rate = scenario(n, frames_total)
    chan_type = torch.zeros((n, 8), dtype=torch.int32, device=dev)
    chan_type[:, 1] = ChanType.I
    state0 = init_state(cfg, dev)._replace(chan_type=chan_type)

    # the serial chain on this rank's device: full-stream resample, then
    # rx_step frame by frame
    sym_back = fir.polyphase_resample(torch.from_numpy(dev_rate).to(dev),
                                      65, 96, fir.resampler_lpf(65, 96, 961))
    wins = _slot_windows(sym_back, frames_total)
    st = state0
    det_serial = []
    for f in range(frames_total):
        st, r = rx_step(cfg, st, wins[f])
        det_serial.append(r.detected)
    det_serial = torch.stack(det_serial).cpu().numpy()

    # this rank's rectangle: all carriers, its run of time shards
    chans, cols = distributed.host_local_shard((n, frames_total), mesh)
    t0, t1 = mesh.box[1].start, mesh.box[1].stop
    state_sh = state_for_shards(state0, n_time)
    state_sh = state_sh._replace(**{
        name: x[t0:t1] for name, x in state_sh._asdict().items()})
    block = n_time * spec.block_in
    lo_in, hi_in = t0 * spec.block_in, t1 * spec.block_in
    if args.duplex:
        rng2 = np.random.default_rng(11)
        dl_bits = rng2.integers(0, 2, (frames_total, n, 8, 148)
                                ).astype(np.uint8)
        dl_valid = rng2.random((frames_total, n, 8)) < 0.6
        dl_atten = np.zeros((frames_total, n, 8), np.float32)
        step_fn = sharded_duplex_pipeline(mesh, cfg, spec)
    else:
        step_fn = sharded_uplink_pipeline(mesh, cfg, spec)

    mismatches = hits = 0
    tx_err = 0.0
    clocks, times = [], []
    soft_digests, tx_digests = [], []
    for s in range(args.steps):
        x = torch.from_numpy(np.ascontiguousarray(
            dev_rate[chans, s * block + lo_in: s * block + hi_in])).to(dev)
        fn0 = s * frames_step
        f_lo = fn0 + t0 * spec.frames_per_shard
        f_hi = fn0 + t1 * spec.frames_per_shard
        if args.duplex:
            sl = slice(f_lo, f_hi)
            dl_in = [torch.from_numpy(a[sl]).to(dev)
                     for a in (dl_bits, dl_valid, dl_atten)]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_start = time.perf_counter()
        if args.duplex:
            state_sh, res, tx, clock = step_fn(state_sh, x, *dl_in, fn0)
        else:
            state_sh, res, clock = step_fn(state_sh, x, fn0)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t_start)
        soft = res.soft_bits.cpu().numpy()
        soft_digests += [digest(f) for f in soft]
        if args.duplex:
            tx_np = tx.cpu().numpy()
            tx_digests += [digest(tx_np[:, j * spec.block_in:
                                        (j + 1) * spec.block_in])
                           for j in range(t1 - t0)]
            want = downlink_block(
                cfg, UplinkSpec(frames=frames_step), state0,
                *(torch.from_numpy(a[fn0: fn0 + frames_step]).to(dev)
                  for a in (dl_bits, dl_valid, dl_atten)))[:, lo_in:hi_in]
            diff = (tx - want).abs()
            tx_err = max(tx_err, float(diff.max()))
            mismatches += int((diff > 2e-4 * float(want.abs().max())).sum())
        got = res.detected.cpu().numpy()
        clocks.append(int(clock))
        mismatches += int((got != det_serial[f_lo:f_hi]).sum())
        hits += int(got[:, :, 1].sum())

    # gloo carries CPU tensors only
    on_nccl = dist.is_initialized() and dist.get_backend() == "nccl"
    total = torch.tensor([mismatches], dtype=torch.int64,
                         device=dev if on_nccl else "cpu")
    if dist.is_initialized():
        dist.all_reduce(total)  # every rank learns the run's verdict
    ok = int(total) == 0 and hits > 0 and all(c == block for c in clocks)
    print(json.dumps({
        "process": rank, "n_processes": world, "n_shards": n_time,
        "shards_per_rank": per, "duplex": args.duplex, "carriers": n,
        "device": str(dev),
        "backend": dist.get_backend() if dist.is_initialized() else None,
        "verified": True, "ok": ok, "mismatches": mismatches,
        "mismatches_all_ranks": int(total), "local_hits": hits,
        "tx_max_abs_diff": tx_err if args.duplex else None,
        "clock": clocks[0], "steps": args.steps,
        "first_step_s": times[0],
        "per_step_s": sum(times[1:]) / max(len(times) - 1, 1),
        "traffic": mesh.traffic, "first_frame": t0 * spec.frames_per_shard,
        "first_shard": t0, "soft_digests": soft_digests,
        "tx_digests": tx_digests}), flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
