"""GSM physical-layer constants (GSM 05.02): the benchmark's frozen copy
of the port's `utils/constants.py`.

These are standardized bit patterns from GSM 05.02 clause 5.2; the
reference declares the same sequences at `GSM/GSMCommon.cpp:44-57`.
Stored as numpy uint8 arrays so they can be fed straight into batched
modulators.
"""

from __future__ import annotations

import numpy as np


def _bits(s: str) -> np.ndarray:
    return np.frombuffer(s.encode(), dtype=np.uint8) - ord("0")


# The 8 training-sequence codes (TSC) for normal bursts, GSM 05.02 5.2.3.
TRAINING_SEQUENCE = np.stack(
    [
        _bits("00100101110000100010010111"),
        _bits("00101101110111100010110111"),
        _bits("01000011101110100100001110"),
        _bits("01000111101101000100011110"),
        _bits("00011010111001000001101011"),
        _bits("01001110101100000100111010"),
        _bits("10100111110110001010011111"),
        _bits("11101111000100101110111100"),
    ]
)  # [8, 26]

# RACH synchronization sequence, GSM 05.02 5.2.7.
RACH_SYNCH_SEQUENCE = _bits("01001011011111111001100110101010001111000")  # [41]

# The dummy burst, GSM 05.02 5.2.6.
DUMMY_BURST = _bits(
    "000111110110111011000001010010011100000100100010000000111110001110001011"
    "1000101110001010111010010100011001100111001111010011111000100101111101010000"
)  # [148]

# Transceiver amplitude constants (reference: Transceiver52M/Transceiver.cpp:74,111,398)
TX_FULL_SCALE = 13500.0
RSSI_FULL_SCALE = 9450.0

# Detection thresholds (reference: Transceiver52M/Transceiver.cpp:326,361,91)
TSC_DETECT_THRESHOLD = 3.0
RACH_DETECT_THRESHOLD = 5.0
INITIAL_ENERGY_THRESHOLD = 250.0
