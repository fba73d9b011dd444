"""RF sweep synthesizer (the reference's sweepGenerator): a stepped
frequency complex tone sweep written to an .npz IQ file. Numpy only:
`--device` is checked like every tool's, and nothing runs on it.

    python -m openbts_ttsou_tpu_torch.tools.sweep_generator [--out P] \\
        [--start -100e3] [--stop 100e3] [--steps 41]

P defaults to build/tools/sweep.npz.
"""

from __future__ import annotations

import numpy as np

from openbts_ttsou_tpu_torch.tools import common

TOOL = "sweep_generator"


def make_sweep(sample_rate: float, start_hz: float, stop_hz: float,
               steps: int, samples_per_step: int,
               amplitude: float = 10000.0) -> np.ndarray:
    out = []
    for f in np.linspace(start_hz, stop_hz, steps):
        t = np.arange(samples_per_step)
        out.append(amplitude *
                   np.exp(2j * np.pi * f / sample_rate * t))
    return np.concatenate(out).astype(np.complex64)


def main(argv=None) -> dict:
    ap = common.parser(__doc__)
    ap.add_argument("--out", default=None)
    ap.add_argument("--rate", type=float, default=1625e3 / 6.0)
    ap.add_argument("--start", type=float, default=-100e3)
    ap.add_argument("--stop", type=float, default=100e3)
    ap.add_argument("--steps", type=int, default=41)
    ap.add_argument("--samples-per-step", type=int, default=1250)
    args = ap.parse_args(argv)
    dev = common.device_of(args)
    path = common.out_path(args.out, "sweep.npz")
    iq = make_sweep(args.rate, args.start, args.stop, args.steps,
                    args.samples_per_step)
    np.savez(path, iq=iq[None], rate=args.rate)
    print(f"wrote {path}: {len(iq)} samples, "
          f"{args.start/1e3:.0f}..{args.stop/1e3:.0f} kHz")
    return common.emit({"tool": TOOL, "path": str(path),
                        "samples": len(iq), **common.card(dev)})


if __name__ == "__main__":
    main()
