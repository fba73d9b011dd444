"""K1: the polyphase resampler as a hand-written CUDA kernel, and its
plain PyTorch form.

The kernel (`csrc/polyphase_resample.cu`) replaces the Pallas kernel
`openbts_ttsou_tpu/ops/pallas_fir.py::_kernel`. `polyphase_resample_cuda`
launches it on a CUDA tensor or raises; it never falls back.
`polyphase_resample_plain` computes the same function with PyTorch ops
(the strided filter-bank form of fir.py:390-398, as pad + unfold + one
float32 matmul); the CPU path and the kernel's checks use it.

`tile_plan` is the geometry the wrapper hands the kernel: tiles of `mt`
output cycles, each staged as `mt` slab rows in shared memory, and the
phases cut into groups of `r` that read one union window of `u`
samples against zero-padded tap rows. The CPU tests evaluate the plan
with the kernel's own loops in numpy.

Shared memory bounds the geometries the kernel takes: a tile of one
cycle still holds two slab rows (the span of all phases' windows, about
(p−1)·q/p + k_max samples) and two output rows (p outputs), so
`row_stride + out_stride` may be at most 14016 float2 words. The
system's ratios use a few hundred; 3/20962 with 31 taps is the largest q
at p = 3 and q = 1 allows p up to 13985. Past the limit `tile_plan`
raises ValueError.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from openbts_ttsou_tpu_torch.ops import fir
from openbts_ttsou_tpu_torch.utils.tables import copy_table

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p]

#: (phases a group, union window, most groups) of the kernel's
#: compile-time instantiations, in the order the plan tries them; the
#: `INSTANCE(...)` lines of csrc/polyphase_resample.cu list the same.
#: 65/96 · 961 taps (k_max 15) takes the first, 96/65 · 651 (k_max 7)
#: the second; anything else runs the runtime-width instantiation.
INSTANCES = ((5, 21, 13), (4, 10, 24))
CYCLES = 2  # cycles a lane computes in those (kCycles in the source)
RUNTIME_WARPS = 8  # warps a block of the runtime-width instantiation
STAGES = 2  # slab buffers in the ring (kStages in the source)
LANES = 32  # output cycles a tile at most: one a lane
SMEM_BYTES = 232448  # shared memory a block may opt into on sm_90


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from openbts_ttsou_tpu_torch import build

    lib = build.load("polyphase_resample")
    lib.polyphase_resample.argtypes = _ARGTYPES
    lib.polyphase_resample.restype = ctypes.c_int
    return lib


class TilePlan(NamedTuple):
    """What the kernel is told about one (p, q, lpf).

    Tile (b, m0) computes output cycles m0 … m0+mt−1 of row b, outputs
    (m0+c)·p + r. Its slab row c holds the `row_stride` input samples
    from m0·q + slab_start + c·q on (zero outside [0, T)). Group g holds
    phases g·r … g·r+r−1 (the last group may be short); its outputs read
    row c at [wb[g], wb[g] + u) against taps[g] ([r, u], zero where a
    phase's k_max-tap window does not reach). A block has `threads`
    threads."""
    mt: int
    r: int
    u: int
    threads: int
    groups: int
    slab_start: int
    slab_len: int
    row_stride: int
    out_stride: int
    wb: np.ndarray
    taps: np.ndarray


def _one_mod_16(n: int) -> int:
    """Least stride ≥ n that is 1 mod 16 float2 words: 16 lanes reading
    one column of 16 rows then hit 16 different 8-byte bank pairs."""
    return n + (1 - n) % 16


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
def tile_plan(p: int, q: int, lpf_bytes: bytes) -> TilePlan:
    """The kernel's tile plan for this ratio and filter.

    Output (m, r) = Σ_t x[m·q + (k_max−1) + delta[r] − t − pad_left]·
    taps[r, t] (fir._polyphase_plan), so in slab row c of its tile it
    reads columns delta[r] … delta[r]+k_max−1. A group's union of those
    windows starts at wb = delta[first phase]; each phase's k_max taps
    land in its [r, u] row at column delta[r] − wb + (k_max−1) − t."""
    compact, _ = branch_table(p, q, lpf_bytes)
    n = len(lpf_bytes) // 4
    _, _, delta, k_max, k_prime, pad_left = fir._polyphase_plan(p, q, n)

    def union(r):
        return max(int(delta[min(g + r, p) - 1] - delta[g]) + k_max
                   for g in range(0, p, r))

    def lanes(row_stride):  # cycles a tile: one a lane, as shared memory allows
        return min(LANES, (SMEM_BYTES - 8192)
                   // ((STAGES * row_stride + 2 * out_stride) * 8))

    out_stride = _one_mod_16(p)
    for r, u, most in INSTANCES:
        wb = delta[::r].astype(np.int32)
        row_stride = _one_mod_16(int(wb.max()) + u)
        threads = LANES * -(-most // CYCLES)
        if (-(-p // r) <= most and union(r) <= u
                and lanes(row_stride) == LANES):
            break
    else:
        r, u, threads = 1, k_max, LANES * RUNTIME_WARPS
        wb = delta.astype(np.int32)
        row_stride = _one_mod_16(int(wb.max()) + u)
    groups = len(wb)
    taps = np.zeros((groups, r, u), np.float32)
    for ph in range(p):
        g, j = divmod(ph, r)
        col = delta[ph] - wb[g] + (k_max - 1) - np.arange(k_max)
        taps[g, j, col] = compact[ph]
    mt = lanes(row_stride)
    if mt < 1:
        raise ValueError(
            f"polyphase_resample_cuda: {p}/{q} with {n} taps needs a slab "
            f"row of {row_stride} and an output row of {out_stride} words; "
            f"a block's shared memory holds two of each up to "
            f"{(SMEM_BYTES - 8192) // 16} words together")
    return TilePlan(mt=mt, r=r, u=u, threads=threads, groups=groups,
                    slab_start=-int(pad_left),
                    slab_len=(mt - 1) * q + int(k_prime),
                    row_stride=row_stride, out_stride=out_stride,
                    wb=wb, taps=taps)


def instantiation(p: int, q: int, lpf: np.ndarray) -> str:
    """Which of the kernel's instantiations runs this ratio and filter:
    "R5U21"-style names for the compile-time ones (`INSTANCES`),
    "runtime" for the runtime-width one. The plan does not depend on
    the input length."""
    plan = tile_plan(p, q, np.ascontiguousarray(lpf, np.float32).tobytes())
    if any((plan.r, plan.u) == (r, u) for r, u, _ in INSTANCES):
        return f"R{plan.r}U{plan.u}"
    return "runtime"


@functools.lru_cache(maxsize=None)
def _device_plan(p: int, q: int, lpf_bytes: bytes, device: torch.device):
    plan = tile_plan(p, q, lpf_bytes)
    return copy_table(plan.taps, device), copy_table(plan.wb, device)


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
    plan = tile_plan(p, q, lpf_bytes)
    # slab row starts reach (cycles + mt)·q + row_stride in int32; tile
    # indices stay under 2^30
    cycles = -(-n_out // p)
    reach = (cycles + plan.mt) * q + plan.row_stride
    if max(rows, t_in, n_out, reach) >= 2 ** 31:
        raise ValueError("polyphase_resample_cuda: dimension over 2^31")
    if rows * -(-cycles // plan.mt) >= 2 ** 30:
        raise ValueError("polyphase_resample_cuda: over 2^30 tiles")
    out = torch.empty(x.shape[:-1] + (n_out,), dtype=torch.complex64,
                      device=x.device)
    if rows == 0 or n_out == 0:
        return out
    taps, wb = _device_plan(p, q, lpf_bytes, x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().polyphase_resample(
            x.data_ptr(), out.data_ptr(), taps.data_ptr(), wb.data_ptr(),
            rows, t_in, n_out, p, q, -plan.slab_start, plan.r, plan.u,
            plan.mt, plan.row_stride, plan.out_stride, stream)
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
