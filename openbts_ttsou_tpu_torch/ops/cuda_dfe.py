"""K5: the DFE's feedback recursion as a hand-written CUDA kernel.

The kernel (`csrc/dfe_equalize.cu`) computes what
`ops/dfe.py::feedback_recursion_plain` computes, bit for bit, in one
launch: one thread a burst runs the T steps of the recursion with its
feedback taps and the history of its last ν rotated decisions in
registers, and slices each step's output to a soft bit as it goes.
`equalize_cuda` launches it on CUDA tensors or raises; it never falls
back. The JAX package runs the recursion as a `lax.scan` that XLA
fuses.
"""

from __future__ import annotations

import ctypes
import functools

import torch

#: the feedback depths the kernel is instantiated for: CHAN_TAPS − 1 = 5
#: on every program path, and 1
DEPTHS = (1, 5)

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from openbts_ttsou_tpu_torch import build

    lib = build.load("dfe_equalize")
    lib.dfe_equalize.argtypes = _ARGTYPES
    lib.dfe_equalize.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, shape: tuple) -> None:
    if t.dtype != torch.complex64:
        raise TypeError(f"equalize_cuda: {name} must be torch.complex64, "
                        f"not {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"equalize_cuda: {name} must have shape {shape}, "
                         f"not {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"equalize_cuda: {name} must be contiguous")
    if t.data_ptr() % 8:
        raise ValueError(f"equalize_cuda: {name} must start on an 8-byte "
                         f"boundary")


def equalize_cuda(pf: torch.Tensor, feedback: torch.Tensor,
                  rot: torch.Tensor) -> torch.Tensor:
    """Launch K5. pf [B, T] complex64, the feedforward filter's output;
    feedback [B, ν] complex64, ν one of `DEPTHS`; rot [T] complex64, the
    GMSK rotation; all contiguous on one CUDA device. Returns the soft
    bits [B, T] float32 in [0, 1]."""
    if pf.ndim != 2 or feedback.ndim != 2:
        raise ValueError(f"equalize_cuda: pf and feedback must be "
                         f"[B, T] and [B, nu], not {tuple(pf.shape)} and "
                         f"{tuple(feedback.shape)}")
    bsz, t = (int(n) for n in pf.shape)
    nu = int(feedback.shape[1])
    if nu not in DEPTHS:
        raise ValueError(f"equalize_cuda: {nu} feedback taps, not one of "
                         f"{DEPTHS}")
    if t < 1:
        raise ValueError("equalize_cuda: needs a step")
    if bsz * t >= 2 ** 31:
        raise ValueError("equalize_cuda: over 2^31 samples")
    for name, x, shape in (("pf", pf, (bsz, t)),
                           ("feedback", feedback, (bsz, nu)),
                           ("rot", rot, (t,))):
        _check(name, x, shape)
    dev = pf.device
    for name, x in (("pf", pf), ("feedback", feedback), ("rot", rot)):
        if not x.is_cuda or x.device != dev:
            raise ValueError(f"equalize_cuda: {name} must be a CUDA tensor "
                             f"on pf's device, not on {x.device}")
    soft = torch.empty((bsz, t), dtype=torch.float32, device=dev)
    if bsz == 0:
        return soft
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().dfe_equalize(pf.data_ptr(), feedback.data_ptr(),
                                 rot.data_ptr(), soft.data_ptr(), bsz, t, nu,
                                 stream)
    if rc != 0:
        raise RuntimeError(f"dfe_equalize kernel launch failed: CUDA error "
                           f"{rc}")
    equalize_cuda.launches += 1
    return soft


equalize_cuda.launches = 0
