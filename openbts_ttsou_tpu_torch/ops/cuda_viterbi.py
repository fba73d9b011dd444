"""K8: the Viterbi decoder as a hand-written CUDA kernel.

The kernel (`csrc/viterbi.cu`) computes what
`gsm/fec.py::viterbi_decode_plain` computes, bit for bit, in one launch
a call: one thread a codeword runs the deferred-decision decoder's
K + 24 steps with its 16 path costs and survivor histories in registers
and its branch metrics computed from the soft bits as it goes.
`viterbi_decode_cuda` launches it on CUDA tensors or raises; it never
falls back. The JAX package runs the decoder as a `lax.scan` that XLA
fuses.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from openbts_ttsou_tpu_torch import build

    lib = build.load("viterbi")
    lib.viterbi_decode.argtypes = _ARGTYPES
    lib.viterbi_decode.restype = ctypes.c_int
    return lib


def viterbi_decode_cuda(soft: torch.Tensor) -> torch.Tensor:
    """Launch K8 on soft [rows, 2K] float32 on a CUDA device: each row's
    soft bits adjacent, the rows any stride apart (a slice of wider rows
    is read in place). Returns the [rows, K] uint8 hard bits."""
    if soft.dtype != torch.float32:
        raise TypeError(f"viterbi_decode_cuda: soft must be torch.float32, "
                        f"not {soft.dtype}")
    if not soft.is_cuda:
        raise ValueError(f"viterbi_decode_cuda: soft must be a CUDA tensor, "
                         f"not on {soft.device}")
    if soft.ndim != 2 or soft.shape[1] < 2 or soft.shape[1] % 2:
        raise ValueError(f"viterbi_decode_cuda: soft must be [rows, 2K] "
                         f"with K >= 1, not {tuple(soft.shape)}")
    rows, n_in = soft.shape
    if soft.stride(1) != 1:
        raise ValueError("viterbi_decode_cuda: a row's soft bits must be "
                         "adjacent (stride 1)")
    if soft.data_ptr() % 4:
        raise ValueError("viterbi_decode_cuda: soft must start on a 4-byte "
                         "boundary")
    if rows >= 2 ** 31:
        raise ValueError("viterbi_decode_cuda: over 2^31 codewords")
    out = torch.empty((rows, n_in // 2), dtype=torch.uint8,
                      device=soft.device)
    if rows == 0:
        return out
    with torch.cuda.device(soft.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().viterbi_decode(soft.data_ptr(), soft.stride(0), rows,
                                   n_in // 2, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"viterbi kernel launch failed: CUDA error {rc}")
    viterbi_decode_cuda.launches += 1
    return out


viterbi_decode_cuda.launches = 0
