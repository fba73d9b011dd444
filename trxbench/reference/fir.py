"""Convolution, FIR design and rational resampling, plain PyTorch.

The convolutions and the filter design are the benchmark's frozen copy
of the port's `ops/fir.py` (sigProcLib.cpp:267-408, 1102-1150). The
resampler is the benchmark's own: the polyphase filter bank written out
from its definition and contracted in one float32 matrix product, where
the port runs its CUDA kernel (K1). That product is the one place where
`torch.backends.cuda.matmul.allow_tf32` changes the reference's numbers,
which the control (`trxbench/control.py`) relies on.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

FULL_SPAN = "full"
OVERLAP_ONLY = "overlap"
START_ONLY = "start"
WITH_TAIL = "with_tail"
NO_DELAY = "no_delay"
CUSTOM = "custom"


def _mode_window(La: int, Lb: int, mode: str, start: Optional[int],
                 length: Optional[int]):
    """(start, size) into the full convolution, per span mode
    (the startIndex/outSize switch at sigProcLib.cpp:276-304)."""
    if mode == FULL_SPAN:
        return 0, La + Lb - 1
    if mode == OVERLAP_ONLY:
        return La, abs(La - Lb) + 1
    if mode == START_ONLY:
        return 0, La
    if mode == WITH_TAIL:
        return Lb, La
    if mode == NO_DELAY:
        return (Lb // 2 if Lb % 2 else Lb // 2 - 1), La
    if mode == CUSTOM:
        if start is None or length is None:
            raise ValueError("custom span needs start and length")
        return start, length
    raise ValueError(f"unknown span mode {mode!r}")


def convolve(a: torch.Tensor, b: torch.Tensor, mode: str = FULL_SPAN, *,
             start: Optional[int] = None,
             length: Optional[int] = None) -> torch.Tensor:
    """Batched complex convolution with the reference's span modes.

    a: [..., La] complex; b: [Lb] shared or [..., Lb] per-batch, real or
    complex. Returns [..., outSize] complex64; out-of-range taps read as
    zero. Unfold-and-sum, so no TF32 path."""
    a = a.to(torch.complex64)
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1])
    b2 = b.reshape(-1, b.shape[-1]) if b.ndim > 1 else b
    La, Lb = a2.shape[-1], b2.shape[-1]
    s, n = _mode_window(La, Lb, mode, start, length)
    bk = b2.flip(-1)
    right = max(0, s + n - La)
    ap = F.pad(a2, (Lb - 1, right))[:, s: s + n + Lb - 1]
    wins = ap.unfold(-1, Lb, 1)
    out = (wins * (bk[:, None, :] if b.ndim > 1 else bk)).sum(-1)
    return out.to(torch.complex64).reshape(lead + (n,))


def correlate(a: torch.Tensor, b: torch.Tensor, mode: str = NO_DELAY, *,
              start: Optional[int] = None,
              length: Optional[int] = None) -> torch.Tensor:
    """Correlation = convolution with the time-reversed conjugate of b
    (sigProcLib.cpp:474-503)."""
    brc = torch.conj_physical(b).flip(-1)
    return convolve(a, brc, mode, start=start, length=length)


@functools.lru_cache(maxsize=None)
def design_lpf(cutoff: float, num_taps: int, dc_gain: float = 1.0
               ) -> np.ndarray:
    """Windowed-sinc low-pass FIR, DC-gain normalized
    (sigProcLib.cpp:1106-1118, 1141-1147)."""
    i = np.arange(num_taps, dtype=np.float64)
    t = i - (num_taps + 1) / 2.0
    ys = np.sinc(2.0 * cutoff * t)
    yw = 0.53836 - 0.46164 * np.cos(2.0 * np.pi * i / (num_taps + 1))
    taps = ys * yw
    taps *= dc_gain / taps.sum()
    return taps.astype(np.float32)


def resampler_lpf(p: int, q: int, num_taps: int) -> np.ndarray:
    """LPF of a P/Q resampler: cutoff 0.5/max(P,Q) at the P-upsampled
    rate, DC gain P (radioInterface.cpp:130-133, 218-222)."""
    return design_lpf(0.5 / max(p, q), num_taps, dc_gain=float(p))


def output_len(in_len: int, p: int, q: int) -> int:
    """ceil(in_len·P/Q) (sigProcLib.cpp:1171)."""
    return -(-in_len * p // q)


@functools.lru_cache(maxsize=None)
def _bank(p: int, q: int, taps: int, lpf_bytes: bytes):
    """The filter bank of one cycle of p outputs.

    Output i is y[i] = Σ_t h[t]·xs[(i0 + i)·q − t], xs the input with
    p − 1 zeros after each sample, i0 = (taps − 1)//(2q). Write
    i = m·p + s. With j = (i0 + s)·q, off_s = j // p and r_s = j % p,
    y[m·p + s] = Σ_k h[r_s + k·p]·x[m·q + off_s − k], k < ceil(taps/p).
    Cycle m reads the window x[m·q + lo − (K − 1) …], lo = min off_s, of
    K' = K + max off_s − lo samples; phase s takes h[r_s + k·p] at window
    position off_s − lo + K − 1 − k. Returns (bank [K', p] float32, the
    left pad K − 1 − lo, K')."""
    h = np.frombuffer(lpf_bytes, np.float32)
    i0 = (taps - 1) // 2 // q
    k = -(-taps // p)
    j = (i0 + np.arange(p)) * q
    off, r = j // p, j % p
    lo = int(off.min())
    width = k + int(off.max()) - lo
    bank = np.zeros((width, p), np.float32)
    for s in range(p):
        for kk in range(k):
            t = r[s] + kk * p
            if t < taps:
                bank[off[s] - lo + k - 1 - kk, s] = h[t]
    return bank, k - 1 - lo, width


def resample(x: torch.Tensor, p: int, q: int, lpf: np.ndarray,
             rows: int = 128) -> torch.Tensor:
    """P/Q rational resampling with group-delay compensation, the
    function the port's K1 computes (sigProcLib.cpp:1177-1205).

    x: [..., T] complex64 → [..., ceil(T·P/Q)] complex64, in blocks of
    `rows` rows so that the windows fit beside the program."""
    lpf = np.ascontiguousarray(lpf, np.float32)
    bank_np, pad_left, width = _bank(p, q, len(lpf), lpf.tobytes())
    lead, t_in = x.shape[:-1], x.shape[-1]
    x2 = x.to(torch.complex64).reshape(-1, t_in)
    n_out = output_len(t_in, p, q)
    cycles = -(-n_out // p)
    pad_right = max(0, (cycles - 1) * q + width - pad_left - t_in)
    bank = torch.from_numpy(bank_np).to(x.device)
    out = torch.empty((x2.shape[0], n_out), dtype=torch.complex64,
                      device=x.device)
    for b0 in range(0, x2.shape[0], rows):
        blk = x2[b0: b0 + rows]
        planes = torch.cat([blk.real, blk.imag])  # [2b, T] float32
        xp = F.pad(planes, (pad_left, pad_right))
        wins = xp.unfold(-1, width, q)[:, :cycles]  # [2b, M, K']
        y = torch.matmul(wins, bank).reshape(planes.shape[0], -1)[:, :n_out]
        nb = blk.shape[0]
        out[b0: b0 + nb] = torch.complex(y[:nb], y[nb:])
    return out.reshape(lead + (n_out,))
