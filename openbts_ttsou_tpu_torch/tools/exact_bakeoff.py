"""The two exact uplink schedules, timed from one entry state.

`process_block_exact` (the heavy work batched over the block's frames,
the threshold walk and the adoptions frame by frame) and
`process_block_frames` (`rx_step` frame by frame) compute the same
thing; `models/transceiver.py` `EXACT_BATCH_MAX_CHAN` picks one by the
carrier count. This times both on one 13-frame block at each carrier
count, asserts that they give equal detections, RACH flags, RSSI,
timing, soft bits within 2e-4 and an equal final integer state, and
prints the largest carrier count at which the batched schedule was the
faster (`recommended_batch_max_chan`). It does not move the boundary.

    python -m openbts_ttsou_tpu_torch.tools.exact_bakeoff \\
        [--carriers 8,32,128,256,512]
"""

from __future__ import annotations

import numpy as np
import torch

from openbts_ttsou_tpu_torch.tools import common

TOOL = "exact_bakeoff"
FRAMES = 13  # a block


def block(n_chan: int, frames: int, dev: torch.device):
    """(cfg, entry state, symbol stream): slot 0 combination IV, slots
    1-7 TCH/F; noise σ 10 with a TSC-0 burst of amplitude 9000 on slot 1
    of every frame."""
    from openbts_ttsou_tpu_torch.ops import gmsk
    from openbts_ttsou_tpu_torch.trx.engine import (ChanType, TrxConfig,
                                                    init_state)
    from openbts_ttsou_tpu_torch.utils import constants as C

    cfg = TrxConfig(n_chan=n_chan)
    ct = torch.full((n_chan, 8), ChanType.I, dtype=torch.int32)
    ct[:, 0] = ChanType.IV
    state = init_state(cfg, dev)._replace(chan_type=ct.to(dev))
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


def assert_same(a, b, n_chan: int) -> None:
    """The two schedules' (state, result) agree."""
    from openbts_ttsou_tpu_torch.convert import state_to_numpy

    (sa, ra), (sb, rb) = a, b
    for name in ("detected", "is_rach", "rssi", "timing"):
        if not torch.equal(getattr(ra, name), getattr(rb, name)):
            raise AssertionError(f"{n_chan} carriers: schedules differ in "
                                 f"{name}")
    err = float((ra.soft_bits - rb.soft_bits).abs().max())
    if err > 2e-4:
        raise AssertionError(f"{n_chan} carriers: soft bits differ by {err}")
    xb = state_to_numpy(sb)
    for name, x in state_to_numpy(sa).items():
        if (x.dtype == bool or np.issubdtype(x.dtype, np.integer)) and \
                not np.array_equal(x, xb[name]):
            raise AssertionError(f"{n_chan} carriers: final state {name}")


def main(argv=None) -> dict:
    from openbts_ttsou_tpu_torch.models import transceiver as T

    ap = common.parser(__doc__)
    ap.add_argument("--carriers", default="8,32,128,256,512")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    dev = common.device_of(args)
    rows = []
    for n_chan in (int(c) for c in args.carriers.split(",")):
        cfg, st0, sym = block(n_chan, FRAMES, dev)
        outs, row = {}, {"carriers": n_chan}
        for name, fn in (("batched", T.process_block_exact),
                         ("frames", T.process_block_frames)):
            outs[name] = fn(cfg, FRAMES, st0, sym)
            row[name] = common.measure(lambda: fn(cfg, FRAMES, st0, sym),
                                       dev, reps=args.reps, profile=False)
        assert_same(outs["batched"], outs["frames"], n_chan)
        row["detections"] = int(outs["batched"][1].detected.sum())
        row["batched_faster"] = (row["batched"]["wall_ms"]
                                 <= row["frames"]["wall_ms"])
        rows.append(row)
        common.log(TOOL, f"{n_chan}: batched {row['batched']['wall_ms']:.1f}"
                         f" ms, frames {row['frames']['wall_ms']:.1f} ms")
    faster = [r["carriers"] for r in rows if r["batched_faster"]]
    return common.emit({
        "tool": TOOL, "frames": FRAMES, "rows": rows,
        "results_equal": True,
        "recommended_batch_max_chan": max(faster, default=0),
        "current_batch_max_chan": T.EXACT_BATCH_MAX_CHAN,
        **common.card(dev)})


if __name__ == "__main__":
    main()
