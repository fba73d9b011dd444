"""Per-stage time of the uplink chain, at the headline width.

Times each stage of one 13-frame block on its own, on inputs of the
block's shapes (random samples, every slot of every carrier a burst):
the 65/96 resample (K1), the slot windows (`models/transceiver.py`
`_slot_windows`), `energy_detect`, `analyze_traffic_burst` with channel
estimation, `detect_rach`, `demodulate_burst`, `design_dfe` and
`equalize_burst`, the DFE that `rx_step` runs behind a host sync when a
burst needs it. Each stage reports wall ms, device ms, busy ms,
launches and its idle share (`common.measure`).

    python -m openbts_ttsou_tpu_torch.tools.stage_bench [--carriers 512]
"""

from __future__ import annotations

import numpy as np
import torch

from openbts_ttsou_tpu_torch.tools import common

TOOL = "stage_bench"
FRAMES = 13  # a block


def stages(n_chan: int, frames: int, dev: torch.device) -> dict:
    """name → a callable running that stage once on the block's inputs."""
    from openbts_ttsou_tpu_torch.models.transceiver import (UplinkSpec,
                                                            _slot_windows)
    from openbts_ttsou_tpu_torch.ops import correlate as xcorr
    from openbts_ttsou_tpu_torch.ops import dfe, fir, gmsk
    from openbts_ttsou_tpu_torch.trx import engine as eng

    spec = UplinkSpec(frames=frames)
    rng = np.random.default_rng(0)

    def noise(*shape):
        return torch.from_numpy(
            ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
             * 50).astype(np.complex64)).to(dev)

    samples = noise(n_chan, spec.block_in)
    sym = noise(n_chan, spec.block_symbols)
    bursts = _slot_windows(sym, frames).reshape(-1, eng.SLOT_SAMPLES)
    n = bursts.shape[0]
    thr = torch.zeros(n, device=dev)
    tsc = torch.zeros(n, dtype=torch.int32, device=dev)
    amp = torch.ones(n, dtype=torch.complex64, device=dev)
    toa = torch.zeros(n, device=dev)
    chan = noise(n, 6) / 50
    snr = torch.full((n,), 10.0, device=dev)
    fwd, fb = dfe.design_dfe(chan, snr, eng.DFE_NF)
    lpf = fir.resampler_lpf(spec.p, spec.q, spec.taps)
    sps = 1
    return {
        "resample": lambda: fir.polyphase_resample(samples, spec.p, spec.q,
                                                   lpf),
        "slot_windows": lambda: _slot_windows(sym, frames),
        "energy_detect": lambda: xcorr.energy_detect(bursts, 20, thr),
        "analyze_traffic": lambda: xcorr.analyze_traffic_burst(
            bursts, tsc, sps, threshold=3.0, estimate_channel=True),
        "detect_rach": lambda: xcorr.detect_rach(bursts, sps, threshold=5.0),
        "demodulate": lambda: gmsk.demodulate_burst(bursts, sps, amp, toa),
        "design_dfe": lambda: dfe.design_dfe(chan, snr, eng.DFE_NF),
        "equalize": lambda: dfe.equalize_burst(bursts, toa, sps, fwd, fb),
    }


def main(argv=None) -> dict:
    ap = common.parser(__doc__)
    ap.add_argument("--carriers", type=int, default=512)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    dev = common.device_of(args)
    rows = {}
    for name, fn in stages(args.carriers, FRAMES, dev).items():
        k0 = common.k1_launches()
        rows[name] = common.measure(fn, dev, reps=args.reps)
        rows[name]["k1_launches"] = common.k1_launches() - k0
        common.log(TOOL, f"{name:18s} {rows[name]['wall_ms']:9.3f} ms wall")
    return common.emit({"tool": TOOL, "carriers": args.carriers,
                        "frames": FRAMES,
                        "bursts": args.carriers * FRAMES * 8,
                        "stages": rows, **common.card(dev)})


if __name__ == "__main__":
    main()
