"""Overlap-save block resampling with input halos.

Port of the local half of `openbts_ttsou_tpu/parallel/halo.py`. The
reference carries INHISTORY/OUTHISTORY samples between resampler chunks
(Transceiver/radioInterface.h:35-41, radioInterface.cpp:123-260); a
block that is handed `halo` samples of its neighbours on each side
resamples to exactly the outputs a full-stream resample gives there.
The ring exchange that fetches halos from other devices comes with the
multi-device slice.
"""

from __future__ import annotations

import numpy as np
import torch

from openbts_ttsou_tpu_torch.ops import fir


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
