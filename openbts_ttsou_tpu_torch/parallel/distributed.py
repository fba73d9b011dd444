"""Multi-process initialization for meshes that span processes.

Port of `openbts_ttsou_tpu/parallel/distributed.py`. The reference's
inter-process transport is localhost UDP (SURVEY.md §2.2 P5); here the
split is:

- within a process: the mesh combines its shards with tensor ops;
- between processes: `torch.distributed` (NCCL between cards, gloo
  between CPUs) carries the halos and the state merge, plus the
  `trx.protocol` planes at the framework edge.

`initialize()` joins the process group so the same sharded step spans
every rank's shards; each rank feeds its own rectangle of the global
[chan, time] sample stream (`host_local_shard`).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from openbts_ttsou_tpu_torch.parallel.mesh import Mesh


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None, device="cuda",
               timeout_s: float = 120.0,
               backend: Optional[str] = None) -> bool:
    """Join the process group; True when this call joined it.

    Defaults come from torch's WORLD_SIZE and RANK (the rendezvous then
    from MASTER_ADDR/MASTER_PORT). A single process without an
    `init_method` needs no group and this is a no-op; with one (a
    `tcp://` or `file://` URL) it joins even alone. The backend follows
    the mesh's device unless given: `nccl` for CUDA, `gloo` for the CPU.
    `gloo` with CUDA shards runs ranks that share one card (NCCL refuses
    two ranks on one card): the mesh then stages what crosses ranks
    through the CPU. A backend that fails raises. `timeout_s` bounds
    every collective, so a rank that never arrives fails the others
    instead of hanging them."""
    world_size = world_size or int(os.environ.get("WORLD_SIZE", "1"))
    rank = rank if rank is not None else int(os.environ.get("RANK", "0"))
    if dist.is_initialized() or (world_size <= 1 and init_method is None):
        return False
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def host_local_shard(global_array_shape: tuple[int, ...],
                     mesh: Mesh) -> tuple[slice, slice]:
    """Which slice of the global [chan, time] sample stream this process
    provides: (chan_slice, time_slice), the rectangle its shards cover."""
    c_total, t_total = global_array_shape[:2]
    c_per = c_total // mesh.shape[mesh.axis_names[0]]
    t_per = t_total // mesh.shape[mesh.axis_names[1]]
    rows, cols = mesh.box
    return (slice(rows.start * c_per, rows.stop * c_per),
            slice(cols.start * t_per, cols.stop * t_per))
