"""GMSK modulation and demodulation.

Port of `openbts_ttsou_tpu/ops/gmsk.py`. Reference behavior:
`Transceiver/sigProcLib.cpp:411-430` (generateGSMPulse), `:214-264`
(rotation), `:521-565` (modulateBurst), `:507-519` (vectorSlicer),
`:1056-1097` (demodulateBurst), `:573-616` (delayVector).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from openbts_ttsou_tpu_torch.ops import fir
from openbts_ttsou_tpu_torch.utils.tables import copy_table


@functools.lru_cache(maxsize=None)
def gsm_pulse(sps: int, symbol_span: int = 2) -> np.ndarray:
    """0.96·exp(−1.1380 t² − 0.527 t⁴) over `symbol_span` symbols,
    energy-normalized (sigProcLib.cpp:411-430). float32 [span*sps+1]."""
    n = sps * symbol_span + 1
    t = (np.arange(n) - (n - 1) // 2) / float(sps)
    x = 0.96 * np.exp(-1.1380 * t * t - 0.527 * t ** 4)
    x /= np.sqrt(np.sum(x * x) / sps)
    return x.astype(np.float32)


@functools.lru_cache(maxsize=None)
def rotation(n: int, sps: int) -> np.ndarray:
    """exp(+j·(π/2)·k/sps), k=0..n-1 (sigProcLib.cpp:214-225). complex64."""
    phase = (np.pi / 2.0 / sps) * np.arange(n)
    return np.exp(1j * phase).astype(np.complex64)


def _rotation_t(n: int, sps: int, device) -> torch.Tensor:
    return copy_table(rotation(n, sps), device)


def gmsk_rotate(x: torch.Tensor, sps: int) -> torch.Tensor:
    """π/2-per-symbol phase ramp (GMSKRotate, sigProcLib.cpp:232-247)."""
    return x * _rotation_t(x.shape[-1], sps, x.device)


def gmsk_reverse_rotate(x: torch.Tensor, sps: int) -> torch.Tensor:
    """Conjugate ramp (GMSKReverseRotate, sigProcLib.cpp:249-264)."""
    return x * torch.conj_physical(_rotation_t(x.shape[-1], sps, x.device))


def modulate_burst(bits: torch.Tensor, sps: int, guard_len: int = 0,
                   pulse: torch.Tensor | None = None) -> torch.Tensor:
    """bits [..., N] {0,1} → GMSK baseband [..., sps·(N+guard_len)]
    complex64 (modulateBurst, sigProcLib.cpp:521-565): ±1 impulses at sps
    spacing → π/2-per-symbol rotation → pulse shaping, NO_DELAY span.

    The pulse is real, so `fir.convolve` multiplies each complex window
    by real taps: the real and imaginary planes are filtered separately
    in float32 (unfold-and-sum, no TF32 path)."""
    n = bits.shape[-1]
    total = sps * (n + guard_len)
    x = torch.zeros(bits.shape[:-1] + (total,), dtype=torch.float32,
                    device=bits.device)
    x[..., : n * sps: sps] = 2.0 * bits.to(torch.float32) - 1.0
    rot = gmsk_rotate(x.to(torch.complex64), sps)
    if pulse is None:
        pulse = copy_table(gsm_pulse(sps), bits.device)
    return fir.convolve(rot, pulse.to(device=bits.device,
                                      dtype=torch.float32), fir.NO_DELAY)


def modulate_burst_np(bits: np.ndarray, sps: int,
                      guard_len: int = 0) -> np.ndarray:
    """NumPy GMSK modulator for set-up constants (the filler table, test
    and bench bursts): ±1 impulses at sps spacing → π/2 rotation → pulse
    shaping, NO_DELAY span. [..., N] bits → [..., sps*(N+guard_len)]."""
    bits = np.asarray(bits)
    n = bits.shape[-1]
    total = sps * (n + guard_len)
    x = np.zeros(bits.shape[:-1] + (total,), np.complex128)
    x[..., : n * sps : sps] = 2.0 * bits - 1.0
    x = x * rotation(total, sps)
    pulse = gsm_pulse(sps).astype(np.float64)
    start = len(pulse) // 2 if len(pulse) % 2 else len(pulse) // 2 - 1
    out = np.empty_like(x)
    for idx in np.ndindex(x.shape[:-1]):
        full = np.convolve(x[idx], pulse)
        out[idx] = full[start: start + total]
    return out.astype(np.complex64)


def vector_slicer(x: torch.Tensor) -> torch.Tensor:
    """Soft-output slicer: clamp(0.5·(Re{x}+1), 0, 1) (sigProcLib.cpp:507-519)."""
    return torch.clamp(0.5 * (x.real + 1.0), 0.0, 1.0)


def fractional_delay_kernel(frac: torch.Tensor,
                            num_taps: int = 21) -> torch.Tensor:
    """Per-batch sinc interpolator delaying by `frac`:
    kernel[i] = sinc(i − c − frac), c = num_taps//2 (sigProcLib.cpp:582-592).
    Where |frac| ≤ 1e-2 the reference skips the filter: a unit impulse."""
    frac = frac.to(torch.float32)
    c = num_taps // 2
    i = torch.arange(num_taps, dtype=torch.float32, device=frac.device)
    kernel = torch.sinc(i - c - frac[..., None])
    delta = (i == c).to(torch.float32).expand_as(kernel)
    small = (frac.abs() <= 1e-2)[..., None]
    return torch.where(small, delta, kernel)


def delay_vector(x: torch.Tensor, delay: torch.Tensor, num_taps: int = 21,
                 max_shift: int = 40) -> torch.Tensor:
    """Delay each burst by a fractional number of samples (positive =
    later): a `num_taps` sinc interpolator at the fractional part, then
    a shift by the integer part, zero-filled (delayVector,
    sigProcLib.cpp:573-616). Integer shifts clamp to ±max_shift, as the
    reference's engine bounds TOA well inside that."""
    t = x.shape[-1]
    delay = torch.broadcast_to(delay.to(torch.float32), x.shape[:-1])
    fl = torch.floor(delay)
    int_off = torch.clamp(fl, -max_shift, max_shift).to(torch.int64)
    kernel = fractional_delay_kernel(delay - fl, num_taps)
    y = fir.convolve(x, kernel, fir.NO_DELAY)
    # out[n] = y[n − k], zero outside [0, t)
    src = torch.arange(t, device=x.device) - int_off[..., None]
    ok = (src >= 0) & (src < t)
    out = torch.gather(y, -1, src.clamp(0, t - 1))
    return torch.where(ok, out, torch.zeros((), dtype=y.dtype,
                                            device=y.device))


def decimate(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Every factor-th sample (decimateVector, sigProcLib.cpp:1039-1053)."""
    return x if factor <= 1 else x[..., ::factor]


def demodulate_burst(x: torch.Tensor, sps: int, channel: torch.Tensor,
                     toa: torch.Tensor) -> torch.Tensor:
    """Coherent GMSK demod to soft bits in [0,1]: scale by 1/channel →
    delay by −TOA → reverse-rotate → decimate → slicer
    (sigProcLib.cpp:1056-1097). x [..., T] → [..., T//sps] float32."""
    y = x / channel.to(torch.complex64)[..., None]
    y = delay_vector(y, -toa.to(torch.float32))
    y = gmsk_reverse_rotate(y, sps)
    return vector_slicer(decimate(y, sps))
