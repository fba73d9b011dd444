"""Meshes, sharding and halo collectives.

Port of `openbts_ttsou_tpu/parallel/`. It replaces the reference's
thread/UDP parallelism (SURVEY.md §2.2) with a (chan, time) grid of
shards and its collectives (`mesh.Mesh`):

- P2 (per-timeslot/ARFCN data parallelism) → the `chan` axis;
- P3 (overlap-save streaming across chunk boundaries,
  Transceiver/radioInterface.cpp:123-260) → the `time` axis with halo
  exchange of FIR boundary samples between neighbouring shards;
- P6 (clock distribution, IND CLOCK) → block-index math plus a sum of
  the shards' sample counts.
"""

from openbts_ttsou_tpu_torch.parallel.mesh import make_mesh, mesh_factors  # noqa: F401
from openbts_ttsou_tpu_torch.parallel.halo import exchange_halo, resample_block  # noqa: F401
from openbts_ttsou_tpu_torch.parallel.sharded import (  # noqa: F401
    sharded_duplex_pipeline,
    sharded_uplink_pipeline,
    state_partition_specs,
)
