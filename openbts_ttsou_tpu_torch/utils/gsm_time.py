"""GSM frame-clock arithmetic (GSM 05.02 4.3).

Port of `openbts_ttsou_tpu/utils/gsm_time.py`. Reference behavior:
`GSM/GSMCommon.h:306-420` (`GSM::Time`, `FNDelta`, `FNCompare`,
`gHyperframe`). The functions work on Python ints and on integer
tensors: torch's `%` is a floor-mod like Python's, so negative
differences fold the same way. `Time` is a frozen value type for the
host control plane.
"""

from __future__ import annotations

import dataclasses
import time as _time

import numpy as np
import torch

# The GSM hyperframe: largest time period in GSM, GSM 05.02 4.3.3.
HYPERFRAME = 2048 * 26 * 51  # 2715648

# Samples (at 1 sample/symbol) per timeslot follow a 157/156/156/156
# pattern so 8 slots exactly span 1250 symbol periods
# (Transceiver52M/radioInterface.cpp:270-292).
SLOT_SAMPLE_PATTERN = (157, 156, 156, 156, 157, 156, 156, 156)
FRAME_SYMBOLS = 1250  # sum of the pattern
SLOTS_PER_FRAME = 8
SLOT_LEN = 148  # data symbols per burst (reference: GSM/GSMTransfer.h:51)

# Frame period: 1250 symbols at 13e6/48 symbols/s = 60/13 ms.
SYMBOL_RATE = 1625e3 / 6.0  # ≈270.833 ksym/s (Transceiver52M/runTransceiver.cpp:68)
FRAME_SECONDS = FRAME_SYMBOLS / SYMBOL_RATE


def fn_delta(v1, v2):
    """Clock difference v1-v2 folded into (-HYPERFRAME/2, HYPERFRAME/2]
    (`FNDelta`, GSM/GSMCommon.cpp). Ints in, int out; tensors in, tensor
    out (dtype kept)."""
    half = HYPERFRAME // 2
    delta = (v1 - v2) % HYPERFRAME
    if isinstance(delta, (int, np.integer)):
        return delta - HYPERFRAME if delta >= half else delta
    return torch.where(delta >= half, delta - HYPERFRAME, delta)


def fn_compare(v1, v2):
    """1 if v1>v2, -1 if v1<v2, 0 if equal (modular, GSM/GSMCommon.h:313).
    Ints in, int out; tensors in, tensor out."""
    d = fn_delta(v1, v2)
    if isinstance(d, (int, np.integer)):
        return (d > 0) - (d < 0)
    return torch.sign(d)


def fn_tn_to_index(fn, tn):
    """Flatten (FN, TN) into a monotone burst index (mod HYPERFRAME*8)."""
    return fn * SLOTS_PER_FRAME + tn


_SLOT_OFFSETS = np.cumsum((0,) + SLOT_SAMPLE_PATTERN)[:-1]


def slot_sample_offset(tn):
    """Sample offset of timeslot `tn` within a frame (1 sps): an int for
    an int, an int32 tensor for an index tensor."""
    if isinstance(tn, (int, np.integer)):
        return int(_SLOT_OFFSETS[tn])
    offs = torch.as_tensor(_SLOT_OFFSETS, dtype=torch.int32, device=tn.device)
    return offs[tn]


@dataclasses.dataclass(frozen=True, order=False)
class Time:
    """Immutable (FN, TN) timestamp (reference: GSM/GSMCommon.h:327).

    The reference's mutating methods become pure constructors here.
    """

    fn: int = 0
    tn: int = 0

    def __post_init__(self):
        object.__setattr__(self, "fn", int(self.fn) % HYPERFRAME)
        object.__setattr__(self, "tn", int(self.tn))

    # -- accessors mirroring the reference naming ------------------------
    def FN(self) -> int:
        return self.fn

    def TN(self) -> int:
        return self.tn

    # -- arithmetic ------------------------------------------------------
    def add_frames(self, step: int) -> "Time":
        return Time((self.fn + step) % HYPERFRAME, self.tn)

    def __add__(self, other):
        if isinstance(other, Time):
            tn_sum = self.tn + other.tn
            return Time((self.fn + other.fn + tn_sum // 8) % HYPERFRAME,
                        tn_sum % 8)
        return self.add_frames(int(other))

    def __sub__(self, other):
        if isinstance(other, Time):
            return fn_delta(self.fn, other.fn)
        return self.add_frames(-int(other))

    def inc_tn(self, step: int = 1) -> "Time":
        t = self.tn + step
        return Time((self.fn + t // 8) % HYPERFRAME, t % 8)

    def dec_tn(self, step: int = 1) -> "Time":
        return self.inc_tn(-step)

    def roll_forward(self, w_fn: int, modulus: int) -> "Time":
        """Move forward to the next FN with fn % modulus == w_fn
        (reference: GSM/GSMCommon.h:338-343, loop form; here closed
        form)."""
        if modulus >= HYPERFRAME:
            raise ValueError(f"modulus {modulus} >= the hyperframe")
        delta = (w_fn - self.fn) % modulus
        return Time((self.fn + delta) % HYPERFRAME, self.tn)

    # -- comparisons (modular on FN, then TN; GSM/GSMCommon.h:420+) ------
    def __lt__(self, other: "Time"):
        if self.fn == other.fn:
            return self.tn < other.tn
        return fn_compare(self.fn, other.fn) < 0

    def __gt__(self, other: "Time"):
        if self.fn == other.fn:
            return self.tn > other.tn
        return fn_compare(self.fn, other.fn) > 0

    def __le__(self, other: "Time"):
        return not self.__gt__(other)

    def __ge__(self, other: "Time"):
        return not self.__lt__(other)

    def burst_index(self) -> int:
        return self.fn * SLOTS_PER_FRAME + self.tn

    def __repr__(self):
        return f"Time({self.fn}:{self.tn})"


class Z100Timer:
    """Millisecond countdown timer (GSMCommon.h Z100Timer): set(),
    expired(), remaining(); used for T3101/T3113-style supervision."""

    def __init__(self, limit_ms: int = 0):
        self._limit = limit_ms
        self._end: float | None = None

    def set(self, limit_ms: int | None = None) -> None:
        if limit_ms is not None:
            self._limit = limit_ms
        self._end = _time.monotonic() + self._limit / 1000.0

    def reset(self) -> None:
        self._end = None

    def active(self) -> bool:
        return self._end is not None

    def expired(self) -> bool:
        return self._end is not None and _time.monotonic() >= self._end

    def remaining(self) -> int:
        if self._end is None:
            return 0
        return max(0, int((self._end - _time.monotonic()) * 1000))
