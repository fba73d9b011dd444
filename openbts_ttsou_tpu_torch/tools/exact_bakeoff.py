"""The two exact uplink schedules, timed from one entry state.

`process_block_exact` (the heavy work batched over the block's frames,
the threshold walk and the adoptions frame by frame) and
`process_block_frames` (`rx_step` frame by frame) compute the same
thing; `models/transceiver.py` `exact_schedule` picks one by the
carrier count. This times both on one 13-frame block at each carrier
count and records each schedule's device memory peak
(`torch.cuda.max_memory_allocated`, GiB; None on the CPU). It asserts
that they give equal detections, RACH flags, RSSI and timing, soft bits
within 2e-4, an equal final integer state and a final float state
within 1e-6 of the field's largest value (at least 1), the limits the
benchmark (`trxbench/limits/`) holds the receiver to. It prints the
largest carrier count at which the batched schedule was the faster and
peaked under a quarter of the card's memory
(`recommended_batch_max_chan`). It does not move the boundary.

    python -m openbts_ttsou_tpu_torch.tools.exact_bakeoff \\
        [--carriers 8,32,128,256,512] [--max-delay 5]
"""

from __future__ import annotations

import numpy as np
import torch

from openbts_ttsou_tpu_torch.tools import common

TOOL = "exact_bakeoff"
FRAMES = 13  # a block
SOFT_GAP = 2e-4  # soft bits, absolute
STATE_GAP = 1e-6  # float state, relative to the field's largest value


def block(n_chan: int, frames: int, dev: torch.device, max_delay: int = 0):
    """(cfg, entry state, symbol stream): slot 0 combination IV, slots
    1-7 TCH/F, `max_delay` symbols expected on every carrier (above 1 the
    channel estimate and the equalizer run); noise σ 10 with a TSC-0
    burst of amplitude 9000 on slot 1 of every frame."""
    from openbts_ttsou_tpu_torch.ops import gmsk
    from openbts_ttsou_tpu_torch.trx.engine import (ChanType, TrxConfig,
                                                    init_state)
    from openbts_ttsou_tpu_torch.utils import constants as C

    cfg = TrxConfig(n_chan=n_chan)
    ct = torch.full((n_chan, 8), ChanType.I, dtype=torch.int32)
    ct[:, 0] = ChanType.IV
    state = init_state(cfg, dev)._replace(
        chan_type=ct.to(dev),
        max_expected_delay=torch.full((n_chan,), max_delay,
                                      dtype=torch.int32, device=dev))
    rng = np.random.default_rng(0)
    sym = (rng.standard_normal((n_chan, frames * 1250))
           + 1j * rng.standard_normal((n_chan, frames * 1250))
           ).astype(np.complex64) * 10.0
    bits = np.concatenate(
        [[0, 0, 0], rng.integers(0, 2, 57), [1], C.TRAINING_SEQUENCE[0],
         [1], rng.integers(0, 2, 57), [0, 0, 0]]).astype(np.uint8)
    wave = 9000.0 * gmsk.modulate_burst_np(bits[None], 1)[0]
    for f in range(frames):
        sym[:, f * 1250 + 157: f * 1250 + 157 + 148] += wave
    return cfg, state, torch.from_numpy(sym).to(dev)


def state_gap(x: np.ndarray, ref: np.ndarray) -> float:
    """|x − ref| at its largest over the largest |ref| (at least 1),
    complex as two real planes: the benchmark's `state_gap`."""
    if x.size == 0:
        return 0.0
    if np.iscomplexobj(ref):
        x = np.stack([x.real, x.imag], -1)
        ref = np.stack([ref.real, ref.imag], -1)
    x, ref = x.astype(np.float64), ref.astype(np.float64)
    return float(np.abs(x - ref).max()) / max(1.0, float(np.abs(ref).max()))


def assert_same(a, b, n_chan: int) -> None:
    """The two schedules' (state, result) agree; b is the frame loop, the
    reference's schedule."""
    from openbts_ttsou_tpu_torch.convert import state_to_numpy

    (sa, ra), (sb, rb) = a, b
    for name in ("detected", "is_rach", "rssi", "timing"):
        if not torch.equal(getattr(ra, name), getattr(rb, name)):
            raise AssertionError(f"{n_chan} carriers: schedules differ in "
                                 f"{name}")
    err = float((ra.soft_bits - rb.soft_bits).abs().max())
    if err > SOFT_GAP:
        raise AssertionError(f"{n_chan} carriers: soft bits differ by {err}")
    xb = state_to_numpy(sb)
    for name, x in state_to_numpy(sa).items():
        if x.dtype == bool or np.issubdtype(x.dtype, np.integer):
            if not np.array_equal(x, xb[name]):
                raise AssertionError(f"{n_chan} carriers: final state {name}")
        elif (gap := state_gap(x, xb[name])) > STATE_GAP:
            raise AssertionError(f"{n_chan} carriers: final state {name} "
                                 f"differs by {gap} (relative)")


def main(argv=None) -> dict:
    from openbts_ttsou_tpu_torch.models import transceiver as T

    ap = common.parser(__doc__)
    ap.add_argument("--carriers", default="8,32,128,256,512")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--max-delay", type=int, default=0,
                    help="expected delay in symbols (above 1: the DFE on)")
    args = ap.parse_args(argv)
    dev = common.device_of(args)
    cuda = dev.type == "cuda"
    memory_gib = (torch.cuda.get_device_properties(dev).total_memory / 2**30
                  if cuda else None)
    rows = []
    for n_chan in (int(c) for c in args.carriers.split(",")):
        cfg, st0, sym = block(n_chan, FRAMES, dev, args.max_delay)
        outs, row = {}, {"carriers": n_chan}
        for name, fn in (("batched", T.process_block_exact),
                         ("frames", T.process_block_frames)):
            if cuda:
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            outs[name] = fn(cfg, FRAMES, st0, sym)
            row[name] = common.measure(lambda: fn(cfg, FRAMES, st0, sym),
                                       dev, reps=args.reps, profile=False)
            row[f"{name}_peak_gib"] = (
                torch.cuda.max_memory_allocated(dev) / 2**30 if cuda
                else None)
        assert_same(outs["batched"], outs["frames"], n_chan)
        row["detections"] = int(outs["batched"][1].detected.sum())
        row["batched_faster"] = (row["batched"]["wall_ms"]
                                 <= row["frames"]["wall_ms"])
        row["batched_fits"] = (memory_gib is None
                               or row["batched_peak_gib"] < memory_gib / 4)
        rows.append(row)
        common.log(TOOL, f"{n_chan}: batched {row['batched']['wall_ms']:.1f}"
                         f" ms, frames {row['frames']['wall_ms']:.1f} ms, "
                         f"batched peak {row['batched_peak_gib']} GiB")
    chosen = [r["carriers"] for r in rows
              if r["batched_faster"] and r["batched_fits"]]
    return common.emit({
        "tool": TOOL, "frames": FRAMES, "max_delay": args.max_delay,
        "rows": rows,
        "results_equal": True, "memory_gib": memory_gib,
        "recommended_batch_max_chan": max(chosen, default=0),
        "current_batch_max_chan": T.EXACT_BATCH_MAX_CHAN,
        **common.card(dev)})


if __name__ == "__main__":
    main()
