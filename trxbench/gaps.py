"""Pieces the entry adapters and the harness share: the pinned host copy
of a call's outputs, the widest gap between two sets of carried state,
and copies of nested state between the host and the card."""

from __future__ import annotations

import torch


class HostCopy:
    """Reused pinned host buffers for a call's outputs (plain host memory
    off the card)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.buffers = None

    def __call__(self, tensors: tuple) -> tuple:
        """Copy `tensors` to the host; returns once they are there."""
        if self.buffers is None:
            pin = self.device.type == "cuda"
            self.buffers = tuple(torch.empty(t.shape, dtype=t.dtype,
                                             pin_memory=pin) for t in tensors)
        for h, t in zip(self.buffers, tensors):
            h.copy_(t, non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return self.buffers


def state_gap(pairs) -> float:
    """The widest gap over (name, program, reference) fields: integers and
    flags exactly, floats (complex as two planes) against the field's
    largest reference value, at least 1."""
    worst = 0.0
    for name, p, r in pairs:
        p = torch.as_tensor(p).to(r.device)
        if p.shape != r.shape:
            raise ValueError(f"state field {name}: shape {tuple(p.shape)} "
                             f"against {tuple(r.shape)}")
        if not r.numel():
            continue
        if p.is_complex() or r.is_complex():
            p = torch.view_as_real(p.to(torch.complex128))
            r = torch.view_as_real(r.to(torch.complex128))
        scale = max(1.0, float(r.double().abs().max())) \
            if r.is_floating_point() else 1.0
        worst = max(worst, float((p.double() - r.double()).abs().max())
                    / scale)
    return worst


def moved(tree, device):
    """`tree` (tensors in tuples, named tuples, lists and dicts, and
    anything else as it is) with every tensor a copy on `device`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device, copy=True)
    if isinstance(tree, dict):
        return {k: moved(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(moved(v, device) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(moved(v, device) for v in tree)
    return tree
