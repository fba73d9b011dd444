"""Elementwise vector ops and small utilities.

Port of `openbts_ttsou_tpu/ops/signal.py`. Reference behavior: the misc
helpers of Transceiver/sigProcLib.cpp — vectorNorm2/vectorPower
(:146-160), gaussianNoise Box-Muller (:618-637), frequencyShift NCO
(:432-471), dB/dBinv (:88-144), sinc (:567), interpolatePoint (:639),
resampleVector (:1213-1241). The iterative dB approximation is exact
log10, as in the JAX package.
"""

from __future__ import annotations

import torch


def norm2(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Σ|x|² (vectorNorm2)."""
    return (x.abs() ** 2).sum(dim)


def power(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """mean |x|² (vectorPower)."""
    return (x.abs() ** 2).mean(dim)


def db(x) -> torch.Tensor:
    """dB relative to 1.0, clamped like the reference (sigProcLib.cpp:88):
    ≥1 → 0 dB, ≤0 → −200 dB."""
    x = torch.as_tensor(x, dtype=torch.float32)
    val = 10.0 * torch.log10(torch.clamp(x, min=1e-20))
    return torch.clamp(val, -200.0, 0.0)


def db_inv(x_db) -> torch.Tensor:
    """10^(x/10), inverse of `db` (sigProcLib.cpp:117)."""
    x_db = torch.as_tensor(x_db, dtype=torch.float32)
    return torch.where(x_db >= 0.0, torch.ones_like(x_db),
                       10.0 ** (x_db / 10.0))


def frequency_shift(x: torch.Tensor, freq: float,
                    start_phase: float = 0.0) -> torch.Tensor:
    """NCO mix: y[t] = x[t]·e^{+j(start_phase + freq·t)} with freq in
    radians/sample (frequencyShift, sigProcLib.cpp:432-471)."""
    t = torch.arange(x.shape[-1], dtype=torch.float32, device=x.device)
    ph = start_phase + freq * t
    osc = torch.complex(torch.cos(ph), torch.sin(ph))
    return x * osc


def gaussian_noise(generator: torch.Generator, shape,
                   variance) -> torch.Tensor:
    """Circular complex Gaussian noise with per-sample variance `variance`
    (gaussianNoise, sigProcLib.cpp:618-637), drawn from `generator` on
    its device."""
    dev = generator.device
    std = torch.sqrt(torch.as_tensor(variance, dtype=torch.float32,
                                     device=dev) / 2.0)
    re = torch.randn(shape, generator=generator, dtype=torch.float32,
                     device=dev)
    im = torch.randn(shape, generator=generator, dtype=torch.float32,
                     device=dev)
    return torch.complex(std * re, std * im)


def sinc_interpolate(x: torch.Tensor, ix, half_width: int = 10
                     ) -> torch.Tensor:
    """Sinc-interpolate batched signals at fractional indices.

    x: [..., T]; ix: [...] fractional sample index. interpolatePoint
    (sigProcLib.cpp:639-659): a (2·half_width+1)-tap sinc around
    floor(ix), clamped to [0, T−1) as the reference's window end is.
    Returns [...] complex."""
    ix = torch.as_tensor(ix, dtype=torch.float32, device=x.device)
    t = x.shape[-1]
    base = torch.floor(ix).to(torch.int64) - half_width
    offs = torch.arange(2 * half_width + 1, device=x.device)
    idx = base[..., None] + offs  # [..., 2h+1]
    hi = torch.clamp(base + 2 * half_width + 1, max=t - 1)
    valid = ((idx >= torch.clamp(base, min=0)[..., None])
             & (idx < hi[..., None]) & (idx >= 0))
    w = torch.sinc(idx.to(torch.float32) - ix[..., None])
    xb = torch.broadcast_to(x, ix.shape + (t,))
    vals = torch.gather(xb, -1, idx.clamp(0, t - 1))
    return torch.where(valid, vals * w, torch.zeros((), dtype=vals.dtype,
                                                    device=x.device)).sum(-1)


def resample_linear(x: torch.Tensor, expansion: float,
                    out_len: int) -> torch.Tensor:
    """Linear-interpolation resampler (resampleVector,
    sigProcLib.cpp:1213-1241): y[i] = lerp(x, i/expansion), batched over
    leading dims; out-of-range reads clamp to the last sample."""
    t = (torch.arange(out_len, dtype=torch.float32, device=x.device)
         / torch.tensor(expansion, dtype=torch.float32))
    i0 = torch.clamp(torch.floor(t).to(torch.int64), 0, x.shape[-1] - 1)
    i1 = torch.clamp(i0 + 1, 0, x.shape[-1] - 1)
    frac = t - i0.to(torch.float32)
    if x.is_floating_point():
        frac = frac.to(x.dtype)
    return x[..., i0] * (1 - frac) + x[..., i1] * frac
