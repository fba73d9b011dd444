"""What the DFE equalizer costs the block: `uplink_block` with it off and
fully on.

`rx_step` runs `equalize_burst` over the whole batch behind a host sync
(`trx/engine.py`, `bool(use_dfe.any())`) whenever any burst of the frame
needs it, and `process_block_exact` gates its batched equalizer the same
way. This times one 13-frame `uplink_block` with the DFE off everywhere
(SETMAXDELAY ≤ 1) and on everywhere (SETMAXDELAY 4 on every carrier,
valid channel estimates, every slot a TCH), and reports the tax a frame,
wall and device apart.

The "on" leg must stay on: `chan_valid` clears when the energy gate
fires without a TSC detection, so the noise power is held under half the
initial threshold squared. After the run, outside the timed reps, the
probe checks that `use_dfe` held on every frame: no burst was detected
(nothing could re-validate a slot) and every slot's `chan_valid` is
still set.

    python -m openbts_ttsou_tpu_torch.tools.dfe_cost_probe [--carriers 128,512]
"""

from __future__ import annotations

import numpy as np
import torch

from openbts_ttsou_tpu_torch.tools import common

TOOL = "dfe_cost_probe"
FRAMES = 13  # a block


def legs(n_chan: int, frames: int, dev: torch.device, seed: int = 0):
    """(cfg, spec, samples, {"off": state, "on": state})."""
    from openbts_ttsou_tpu_torch.models.transceiver import UplinkSpec
    from openbts_ttsou_tpu_torch.trx import engine as eng
    from openbts_ttsou_tpu_torch.utils import constants as C

    cfg, spec = eng.TrxConfig(n_chan=n_chan), UplinkSpec(frames=frames)
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n_chan, spec.block_in)) * 100.0
         + 1j * rng.standard_normal((n_chan, spec.block_in)) * 100.0
         ).astype(np.complex64)
    noise_pwr = float(np.mean(np.abs(x) ** 2))
    if noise_pwr >= 0.5 * C.INITIAL_ENERGY_THRESHOLD ** 2:
        raise AssertionError(
            f"noise power {noise_pwr:.0f} too close to the energy gate "
            f"{C.INITIAL_ENERGY_THRESHOLD ** 2:.0f}; the DFE-on leg would "
            f"lose chan_valid mid-block")
    ct = torch.full((n_chan, 8), int(eng.ChanType.I), dtype=torch.int32,
                    device=dev)
    off = eng.init_state(cfg, dev)._replace(chan_type=ct)
    on = off._replace(
        max_expected_delay=torch.full((n_chan,), 4, dtype=torch.int32,
                                      device=dev),
        chan_valid=torch.ones((n_chan, 8), dtype=torch.bool, device=dev))
    return cfg, spec, torch.from_numpy(x).to(dev), {"off": off, "on": on}


def main(argv=None) -> dict:
    from openbts_ttsou_tpu_torch.models import transceiver as T

    ap = common.parser(__doc__)
    ap.add_argument("--carriers", default="128,512")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    dev = common.device_of(args)
    rows = []
    for n_chan in (int(c) for c in args.carriers.split(",")):
        cfg, spec, x, states = legs(n_chan, FRAMES, dev)
        row = {"carriers": n_chan,
               "schedule": ("batched" if n_chan <= T.EXACT_BATCH_MAX_CHAN
                            else "frames")}
        for mode, st in states.items():
            row[mode] = common.measure(
                lambda: T.uplink_block(cfg, spec, st, x), dev,
                reps=args.reps, profile=False)
        # outside the timed reps: the "on" leg kept use_dfe on every frame
        st, res = T.uplink_block(cfg, spec, states["on"], x)
        detections = int(res.detected.sum())
        held = detections == 0 and bool(st.chan_valid.all())
        if not held:
            raise AssertionError(
                f"{n_chan} carriers: the DFE-on leg lost use_dfe "
                f"({detections} detections, "
                f"{int((~st.chan_valid).sum())} slots invalidated)")
        row["use_dfe_every_frame"] = held
        for clock in ("wall_ms", "device_ms"):
            if clock in row["on"]:
                row[f"tax_{clock}_per_frame"] = (
                    row["on"][clock] - row["off"][clock]) / FRAMES
        rows.append(row)
        common.log(TOOL, f"{n_chan}: off {row['off']['wall_ms']:.1f} ms, "
                         f"on {row['on']['wall_ms']:.1f} ms a block")
    return common.emit({"tool": TOOL, "frames": FRAMES, "rows": rows,
                        **common.card(dev)})


if __name__ == "__main__":
    main()
