"""K1: the polyphase resampler as a hand-written CUDA kernel, and its
plain PyTorch form.

The kernel (`csrc/polyphase_resample.cu`) replaces the Pallas kernel
`openbts_ttsou_tpu/ops/pallas_fir.py::_kernel`. `polyphase_resample_cuda`
launches it on a CUDA tensor or raises; it never falls back.
`polyphase_resample_plain` computes the same function with PyTorch ops
(the strided filter-bank form of fir.py:390-398, as pad + unfold + one
float32 matmul); the CPU path and the kernel's checks use it.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from openbts_ttsou_tpu_torch.ops import fir

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from openbts_ttsou_tpu_torch import build

    lib = build.load("polyphase_resample")
    lib.polyphase_resample.argtypes = _ARGTYPES
    lib.polyphase_resample.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def branch_table(p: int, q: int, lpf_bytes: bytes):
    """Compact per-branch taps [p, k_max] float32 and input offsets [p]
    int32: out[m·p + r] = Σ_t x[m·q + base[r] − t]·taps[r, t]."""
    lpf = np.frombuffer(lpf_bytes, np.float32)
    n = len(lpf)
    _, branch, delta, k_max, _, pad_left = fir._polyphase_plan(p, q, n)
    taps = np.zeros((p, k_max), np.float32)
    for r in range(p):
        idx = branch[r] + np.arange(k_max) * p
        ok = idx < n
        taps[r, ok] = lpf[idx[ok]]
    base = ((k_max - 1) + delta - pad_left).astype(np.int32)
    return taps, base


@functools.lru_cache(maxsize=None)
def _device_table(p: int, q: int, lpf_bytes: bytes, device: torch.device):
    taps, base = branch_table(p, q, lpf_bytes)
    return (torch.from_numpy(taps).to(device),
            torch.from_numpy(base).to(device))


def polyphase_resample_cuda(x: torch.Tensor, p: int, q: int,
                            lpf: np.ndarray) -> torch.Tensor:
    """Launch K1. x: [..., T] complex64, contiguous, on a CUDA device.
    Returns [..., ceil(T·p/q)] complex64."""
    if not x.is_cuda:
        raise ValueError("polyphase_resample_cuda needs a CUDA tensor")
    if x.dtype != torch.complex64:
        raise TypeError(f"polyphase_resample_cuda takes complex64, "
                        f"not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("polyphase_resample_cuda needs a contiguous input")
    if x.ndim < 1 or p < 1 or q < 1:
        raise ValueError("polyphase_resample_cuda: bad shape or ratio")
    lpf_bytes = np.ascontiguousarray(lpf, np.float32).tobytes()
    t_in = x.shape[-1]
    n_out = fir.polyphase_output_len(t_in, p, q)
    rows = x.numel() // t_in if t_in else 0
    if max(rows, t_in, n_out) >= 2 ** 31:
        raise ValueError("polyphase_resample_cuda: dimension over 2^31")
    out = torch.empty(x.shape[:-1] + (n_out,), dtype=torch.complex64,
                      device=x.device)
    if rows == 0 or n_out == 0:
        return out
    taps, base = _device_table(p, q, lpf_bytes, x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().polyphase_resample(
            x.data_ptr(), out.data_ptr(), taps.data_ptr(), base.data_ptr(),
            rows, t_in, n_out, p, q, taps.shape[1], stream)
    if rc != 0:
        raise RuntimeError(f"polyphase_resample kernel launch failed: "
                           f"CUDA error {rc}")
    polyphase_resample_cuda.launches += 1
    return out


polyphase_resample_cuda.launches = 0


def polyphase_resample_plain(x: torch.Tensor, p: int, q: int,
                             lpf: np.ndarray) -> torch.Tensor:
    """Plain PyTorch K1: zero-pad, cut the K'-sample windows at stride q
    (unfold), contract them against the dense [p, K'] bank in float32,
    interleave the p phases. Same output as `polyphase_resample_cuda`."""
    lpf = np.asarray(lpf, np.float32)
    lead, t_in = x.shape[:-1], x.shape[-1]
    x2 = x.to(torch.complex64).reshape(-1, t_in)
    n_out = fir.polyphase_output_len(t_in, p, q)
    _, _, _, _, k_prime, pad_left = fir._polyphase_plan(p, q, len(lpf))
    m_cycles = -(-n_out // p)
    need = (m_cycles - 1) * q + k_prime
    pad_right = max(0, need - pad_left - t_in)
    bank = torch.from_numpy(fir._polyphase_filter_bank(p, q, lpf)[:, 0, :]
                            ).to(x.device)  # [p, K']
    planes = torch.cat([x2.real, x2.imag])  # [2B, T] float32
    xp = F.pad(planes, (pad_left, pad_right))
    wins = xp.unfold(-1, k_prime, q)[:, :m_cycles]  # [2B, M, K']
    out = torch.matmul(wins, bank.T)  # [2B, M, p]
    out = out.reshape(out.shape[0], -1)[:, :n_out]
    b = x2.shape[0]
    return torch.complex(out[:b], out[b:]).reshape(lead + (n_out,))
