"""The yardstick's arithmetic: the card's peaks and the work of a kernel
counted from its shapes.

The peaks are NVIDIA's data sheet for the H100 SXM part (dense, no
sparsity) at its full 700 W; a card set below that runs slower, so the
power limit is printed beside every share. The K1 count is frozen from
the port's `tools/roofline.py::k1_work`: each input sample read and each
output sample written once (complex64, 8 bytes), and 4 flops (a real tap
on a complex sample) for every nonzero tap of the branch each output
takes.
"""

from __future__ import annotations

import numpy as np

from trxbench.reference import fir

#: card name as `torch.cuda.get_device_name()` gives it → peaks
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "fp32_flops": 67e12},
}
C64 = 8  # bytes of a complex64 sample
RMAC = 4  # flops of a real tap on a complex sample


def k1_work(rows: int, t_in: int, p: int, q: int, taps: int
            ) -> tuple[float, float]:
    """(flops, bytes) of one resampler launch over [rows, t_in] at p/q
    with the repository's `taps`-tap low-pass filter."""
    lpf = fir.resampler_lpf(p, q, taps)
    bank, _, _ = fir._bank(p, q, taps, lpf.tobytes())
    nnz = (bank != 0).sum(0)  # nonzero taps of each phase
    t_out = fir.output_len(t_in, p, q)
    per_row = int(nnz[np.arange(t_out) % p].sum())
    return (float(RMAC * rows * per_row),
            float(rows * (t_in + t_out) * C64))


def bound_s(flops: float, nbytes: float, peaks: dict) -> float:
    """The least time the card could take: the larger of the work over
    each peak."""
    return max(nbytes / peaks["hbm_bytes_per_s"],
               flops / peaks["fp32_flops"])
