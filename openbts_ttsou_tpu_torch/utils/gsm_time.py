"""GSM frame-clock arithmetic (GSM 05.02 4.3), the part the uplink uses.

Reference behavior: `GSM/GSMCommon.h:306-420` (`FNDelta`, `gHyperframe`).
`fn_delta` works on Python ints and on int32 tensors: torch's `%` is a
floor-mod like Python's, so negative differences fold the same way.
"""

from __future__ import annotations

import numpy as np
import torch

# The GSM hyperframe: largest time period in GSM, GSM 05.02 4.3.3.
HYPERFRAME = 2048 * 26 * 51  # 2715648

# Samples (at 1 sample/symbol) per timeslot follow a 157/156/156/156
# pattern so 8 slots exactly span 1250 symbol periods
# (Transceiver52M/radioInterface.cpp:270-292).
SLOT_SAMPLE_PATTERN = (157, 156, 156, 156, 157, 156, 156, 156)
FRAME_SYMBOLS = 1250  # sum of the pattern


def fn_delta(v1, v2):
    """Clock difference v1-v2 folded into (-HYPERFRAME/2, HYPERFRAME/2]
    (`FNDelta`, GSM/GSMCommon.cpp). Ints in, int out; tensors in, tensor
    out (dtype kept)."""
    half = HYPERFRAME // 2
    delta = (v1 - v2) % HYPERFRAME
    if isinstance(delta, (int, np.integer)):
        return delta - HYPERFRAME if delta >= half else delta
    return torch.where(delta >= half, delta - HYPERFRAME, delta)
