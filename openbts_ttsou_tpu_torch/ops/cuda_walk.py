"""K7: the exact receiver's threshold walk as a hand-written CUDA kernel.

The kernel (`csrc/exact_walk.cu`) computes what
`trx/engine.py::exact_walk_plain` computes, bit for bit, in one
launch: one thread a carrier walks the block's frames and their 8 slots
in order, its threshold, last false-detect frame, validity bits,
estimate frames and last adoptions in registers. `exact_walk_cuda`
launches it on CUDA tensors or raises; it never falls back. The JAX
package runs the same recurrence as one `lax.scan` that XLA fuses.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_ARGTYPES = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from openbts_ttsou_tpu_torch import build

    lib = build.load("exact_walk")
    lib.exact_walk.argtypes = _ARGTYPES
    lib.exact_walk.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device, align: int) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"exact_walk_cuda: {name} must be a CUDA tensor on "
                         f"{device}, not on {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"exact_walk_cuda: {name} must be {dtype}, "
                        f"not {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"exact_walk_cuda: {name} must have shape {shape}, "
                         f"not {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"exact_walk_cuda: {name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"exact_walk_cuda: {name} must start on a "
                         f"{align}-byte boundary")


def exact_walk_cuda(fns, active, is_tsc, energy, detected, det_ok, need_dfe,
                    thr, prev_false, valid, est_fn) -> tuple:
    """Launch K7. fns [F] int32; active, is_tsc, detected, det_ok
    [F, C, 8] bool; energy [F, C, 8] float32; need_dfe [C] bool; the
    walk's entry state thr [C] float32, prev_false [C] int32, valid
    [C, 8] bool, est_fn [C, 8] int32; all contiguous on one CUDA device.
    Returns the `ExactWalk` fields in their order: success, valid_post
    [F, C, 8] bool, last_post [F, C, 8] int32, thr_entry [F, C] float32,
    thr [C] float32, prev_false [C] int32, valid [C, 8] bool, est_fn and
    last [C, 8] int32."""
    if energy.ndim != 3 or energy.shape[2] != 8:
        raise ValueError(f"exact_walk_cuda: energy must be [F, C, 8], not "
                         f"{tuple(energy.shape)}")
    f, c = int(energy.shape[0]), int(energy.shape[1])
    if f < 1 or c < 1:
        raise ValueError("exact_walk_cuda: needs a frame and a carrier")
    if f * c * 8 >= 2 ** 31:
        raise ValueError("exact_walk_cuda: over 2^31 slots")
    dev = energy.device
    for name, t, dtype, shape, align in (
            ("fns", fns, torch.int32, (f,), 4),
            ("active", active, torch.bool, (f, c, 8), 8),
            ("is_tsc", is_tsc, torch.bool, (f, c, 8), 8),
            ("energy", energy, torch.float32, (f, c, 8), 16),
            ("detected", detected, torch.bool, (f, c, 8), 8),
            ("det_ok", det_ok, torch.bool, (f, c, 8), 8),
            ("need_dfe", need_dfe, torch.bool, (c,), 1),
            ("thr", thr, torch.float32, (c,), 4),
            ("prev_false", prev_false, torch.int32, (c,), 4),
            ("valid", valid, torch.bool, (c, 8), 8),
            ("est_fn", est_fn, torch.int32, (c, 8), 16)):
        _check(name, t, dtype, shape, dev, align)

    def new(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = (new((f, c, 8), torch.bool), new((f, c, 8), torch.bool),
           new((f, c, 8), torch.int32), new((f, c), torch.float32),
           new((c,), torch.float32), new((c,), torch.int32),
           new((c, 8), torch.bool), new((c, 8), torch.int32),
           new((c, 8), torch.int32))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().exact_walk(
            *(t.data_ptr() for t in (fns, active, is_tsc, energy, detected,
                                     det_ok, need_dfe, thr, prev_false,
                                     valid, est_fn)),
            *(t.data_ptr() for t in out), f, c, stream)
    if rc != 0:
        raise RuntimeError(f"exact_walk kernel launch failed: CUDA error {rc}")
    exact_walk_cuda.launches += 1
    return out


exact_walk_cuda.launches = 0
