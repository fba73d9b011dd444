"""Convolution, FIR design and polyphase rational resampling.

Port of `openbts_ttsou_tpu/ops/fir.py`. Reference behavior:
`Transceiver/sigProcLib.cpp:267-408` (convolve with span modes),
`:1102-1150` (createLPF), `:1154-1210` (polyphaseResampleVector).

Convolutions here are the short filters of the burst chain (41-, 21-,
16- and 7-tap). They are computed as unfold-and-sum over complex64
windows, only over the output span the mode asks for, so nothing goes
through cuDNN (whose float32 convolutions default to TF32). The
resampler runs the hand-written CUDA kernel on a GPU tensor and its
plain PyTorch form on a CPU tensor (`ops/cuda_fir.py`).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from openbts_ttsou_tpu_torch.utils.profiling import span

# Span modes, mirroring ConvType (Transceiver/sigProcLib.h:41-48 + 52M CUSTOM).
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

    a: [..., La] complex; b: [Lb] shared or [..., Lb] per-batch (leading
    axes match a's), real or complex. Returns [..., outSize] complex64.
    Out-of-range taps read as zero (the reference's iterator guards).
    """
    a = a.to(torch.complex64)
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1])
    b2 = b.reshape(-1, b.shape[-1]) if b.ndim > 1 else b
    La, Lb = a2.shape[-1], b2.shape[-1]
    s, n = _mode_window(La, Lb, mode, start, length)
    # full[k] = Σ_u ap[k + u]·bk[u] with ap = a left-padded by Lb − 1 and
    # bk = b reversed; only the window k ∈ [s, s + n) is computed
    bk = b2.flip(-1)
    right = max(0, s + n - La)
    ap = F.pad(a2, (Lb - 1, right))[:, s: s + n + Lb - 1]
    wins = ap.unfold(-1, Lb, 1)  # [B, n, Lb] view
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
def design_lpf(cutoff: float, num_taps: int, dc_gain: float = 1.0) -> np.ndarray:
    """Windowed-sinc low-pass FIR, DC-gain normalized
    (sigProcLib.cpp:1106-1118, 1141-1147)."""
    i = np.arange(num_taps, dtype=np.float64)
    t = i - (num_taps + 1) / 2.0
    ys = np.sinc(2.0 * cutoff * t)  # sin(2π fc t)/(2π fc t)
    yw = 0.53836 - 0.46164 * np.cos(2.0 * np.pi * i / (num_taps + 1))
    taps = ys * yw
    taps *= dc_gain / taps.sum()
    return taps.astype(np.float32)


def resampler_lpf(p: int, q: int, num_taps: int) -> np.ndarray:
    """LPF for a P/Q rational resampler: cutoff 0.5/max(P,Q) at the
    P-upsampled rate, DC gain P (radioInterface.cpp:130-133, 218-222)."""
    cutoff = 0.5 / max(p, q)
    return design_lpf(cutoff, num_taps, dc_gain=float(p))


def polyphase_output_len(in_len: int, p: int, q: int) -> int:
    """ceil(in_len * P / Q) (sigProcLib.cpp:1171)."""
    return -(-in_len * p // q)


@functools.lru_cache(maxsize=None)
def _polyphase_plan(p: int, q: int, taps: int):
    """Static per-(P,Q,filter) geometry of the filter-bank resampler.

    Output i corresponds to full-conv index j=(i0+i)·q with branch
    j mod p and input offset j//p; outputs sharing i mod p share a branch
    and advance q input samples per cycle. Returns
    (i0, branch, delta, k_max, k_prime, pad_left)."""
    i0 = (taps - 1) // 2 // q
    r = np.arange(p)
    j = (i0 + r) * q
    branch = j % p
    off = j // p
    k_max = -(-taps // p)  # ceil: taps per branch
    min_off = int(off.min())
    delta = off - min_off
    k_prime = k_max + int(delta.max())
    pad_left = (k_max - 1) - min_off
    return i0, branch, delta, k_max, k_prime, pad_left


def _polyphase_filter_bank(p: int, q: int, lpf: np.ndarray) -> np.ndarray:
    """Dense bank [p, 1, K'] float32: branch r's taps at columns
    (k_max − 1) + delta[r] − t (see _polyphase_plan)."""
    taps = len(lpf)
    _, branch, delta, k_max, k_prime, _ = _polyphase_plan(p, q, taps)
    rhs = np.zeros((p, 1, k_prime), np.float32)
    lpf = np.asarray(lpf, np.float32)
    for r in range(p):
        for t in range(k_max):
            h_idx = branch[r] + t * p
            if h_idx < taps:
                rhs[r, 0, (k_max - 1) + delta[r] - t] = lpf[h_idx]
    return rhs


def polyphase_resample(x: torch.Tensor, p: int, q: int,
                       lpf: np.ndarray) -> torch.Tensor:
    """P/Q rational resampling with group-delay compensation.

    x: [..., T] complex64. Returns [..., ceil(T*P/Q)] complex64: output i
    is the full convolution of the P-zero-stuffed input with the LPF,
    sampled at index (i0 + i)*Q, i0 = (len(lpf)-1)//(2*Q)
    (sigProcLib.cpp:1177-1205). A CUDA tensor goes through the CUDA
    kernel (K1); a CPU tensor through its plain PyTorch form.
    """
    from openbts_ttsou_tpu_torch.ops import cuda_fir

    with span("k1.resample"):
        if x.is_cuda:
            return cuda_fir.polyphase_resample_cuda(x, p, q, lpf)
        if x.device.type != "cpu":
            raise ValueError(f"polyphase_resample: no kernel for {x.device}")
        return cuda_fir.polyphase_resample_plain(x, p, q, lpf)
