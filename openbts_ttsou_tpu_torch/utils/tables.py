"""Constant tables on the device.

The FEC chains index static numpy tables (interleave maps, Viterbi
predecessors, TDMA phase geometry) on every call. A host-to-device copy
of a pageable array waits for the device, so each table is copied to a
device once and the tensor is kept for later calls: after the first
call, the FEC legs issue no host sync. The receiver's tables are still
copied on every call (`copy_table`); each such copy is a `sync.table`
span.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from openbts_ttsou_tpu_torch.utils.profiling import span


@functools.lru_cache(maxsize=None)
def device_table(fn, args: tuple, device: torch.device) -> torch.Tensor:
    """`fn(*args)`, a numpy array, as a tensor on `device`. fn must be a
    pure function of its hashable arguments; callers must not write to
    the tensor."""
    return copy_table(np.ascontiguousarray(fn(*args)), device)


def copy_table(array, device, dtype: torch.dtype | None = None
               ) -> torch.Tensor:
    """`array` (numpy, or a Python number or sequence) as a tensor on
    `device`, copied now. From pageable host memory to a card the copy
    waits for the device, so it is recorded as a `sync.table` span. On
    the CPU a numpy array is shared, not copied."""
    with span("sync.table"):
        return torch.as_tensor(array, dtype=dtype, device=device)


def row_at(table: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """table[p] for a 0-d index tensor p on the table's device, without a
    host sync (indexing with a 0-d tensor would read it on the host)."""
    return table.index_select(0, p.reshape(1))[0]
