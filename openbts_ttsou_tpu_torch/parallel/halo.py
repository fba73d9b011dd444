"""Halo exchange and overlap-save block resampling across a time-sharded
stream.

Port of `openbts_ttsou_tpu/parallel/halo.py`. The reference carries
INHISTORY/OUTHISTORY samples between resampler chunks
(Transceiver/radioInterface.h:35-41, radioInterface.cpp:123-260); when
the stream is cut into time shards, those boundary samples live on the
neighbouring shard: each block takes `left` trailing samples of its left
neighbour and `right` leading samples of its right one (`exchange_halo`,
one hop each way over the mesh), and a block handed `halo` samples on
each side resamples to exactly the outputs a full-stream resample gives
there (`resample_block`).
"""

from __future__ import annotations

import numpy as np
import torch

from openbts_ttsou_tpu_torch.ops import fir
from openbts_ttsou_tpu_torch.parallel.mesh import Mesh, Shard


def exchange_halo(mesh: Mesh, x: dict[Shard, torch.Tensor], left: int,
                  right: int, axis_name: str = "time"
                  ) -> dict[Shard, torch.Tensor]:
    """Prepend/append halo samples from the neighbours along `axis_name`.

    x: one [..., T_local] tensor a local shard. Returns one
    [..., left + T_local + right] a local shard. The stream edges (first
    and last shard) receive zeros, as the reference's zero-initialized
    history buffers (radioInterface.cpp:80-86). Across ranks the samples
    travel by `dist.batch_isend_irecv`."""
    parts = {s: [v] for s, v in x.items()}
    if left > 0:  # data moves rightward
        got = mesh.shift({s: v[..., -left:] for s, v in x.items()},
                         axis_name, +1)
        for s, v in x.items():
            parts[s].insert(0, got[s] if got[s] is not None
                            else torch.zeros_like(v[..., :left]))
    if right > 0:  # data moves leftward
        got = mesh.shift({s: v[..., :right] for s, v in x.items()},
                         axis_name, -1)
        for s, v in x.items():
            parts[s].append(got[s] if got[s] is not None
                            else torch.zeros_like(v[..., :right]))
    return {s: torch.cat(p, dim=-1) for s, p in parts.items()}


def resample_halo(p: int, q: int, num_taps: int) -> int:
    """Halo width (input samples, a multiple of q) needed on each side
    for an exact block-wise P/Q polyphase resample: the filter reads
    ±(num_taps−1)/(2p) input samples around each output."""
    need = (num_taps - 1 + 2 * p - 1) // (2 * p)
    return ((need + q - 1) // q) * q


def resample_block(x_halo: torch.Tensor, p: int, q: int, lpf: np.ndarray,
                   halo: int, block_len: int) -> torch.Tensor:
    """Resample one time block given symmetric input halos.

    x_halo: [..., halo + block_len + halo] complex64, contiguous (a CUDA
    tensor goes to K1), with `halo` and `block_len` multiples of q.
    Returns the block's own [..., block_len·p/q] outputs (a view),
    identical to slicing a full-stream `fir.polyphase_resample`."""
    assert halo % q == 0 and block_len % q == 0
    y = fir.polyphase_resample(x_halo, p, q, lpf)
    start = halo * p // q
    return y[..., start: start + block_len * p // q]
