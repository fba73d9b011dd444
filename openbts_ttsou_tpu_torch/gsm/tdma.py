"""TDMA channel↔frame mappings, GSM 05.02 clause 7.

Reference behavior: `GSM/GSMTDMA.{h,cpp}` — `TDMAMapping` (GSMTDMA.h:52)
holding one row of the GSM 05.02 Cl.7 tables: the frame positions of a
logical channel within its repeat period, plus a precomputed reverse map.
The frame-position tables themselves are GSM 05.02 constants
(GSMTDMA.cpp:34-270).

NumPy only: the port's own copy of `openbts_ttsou_tpu/gsm/tdma.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


class TypeAndOffset:
    """Channel type and subchannel (GSM 04.08 10.5.2.5;
    GSMCommon.h:244-253)."""

    TDMA_MISC = 0
    TCHF_0 = 1
    TCHH_0 = 2
    TCHH_1 = 3
    SDCCH_4_0, SDCCH_4_1, SDCCH_4_2, SDCCH_4_3 = 4, 5, 6, 7
    (SDCCH_8_0, SDCCH_8_1, SDCCH_8_2, SDCCH_8_3,
     SDCCH_8_4, SDCCH_8_5, SDCCH_8_6, SDCCH_8_7) = range(8, 16)
    TDMA_BEACON = 255


@dataclasses.dataclass(frozen=True)
class TDMAMapping:
    """One mapping row: frame positions within the repeat period
    (GSMTDMA.h:52-116)."""

    type_and_offset: int
    downlink: bool
    uplink: bool
    allowed_slots: int  # bitmask of timeslots
    c0_only: bool
    repeat_length: int
    frame_mapping: Tuple[int, ...]

    def frames_per_repeat(self) -> int:
        return len(self.frame_mapping)

    def frame_no(self, i: int) -> int:
        return self.frame_mapping[i % len(self.frame_mapping)]

    def reverse(self, fn: int) -> Optional[int]:
        """FN → index within the block, or None if unoccupied
        (GSMTDMA.h reverse map)."""
        pos = fn % self.repeat_length
        try:
            return self.frame_mapping.index(pos)
        except ValueError:
            return None

    def reverse_map(self) -> np.ndarray:
        """[repeat_length] int32, −1 where unoccupied — the dense table
        the demux engine gathers from (TRXManager demux analogue)."""
        out = np.full(self.repeat_length, -1, np.int32)
        for i, m in enumerate(self.frame_mapping):
            out[m] = i
        return out

    def allows_slot(self, tn: int) -> bool:
        return bool((self.allowed_slots >> tn) & 1)

    def next_write_time(self, fn: int) -> int:
        """Smallest FN' ≥ fn occupied by this mapping (encoder pacing,
        L1Encoder::rollForward, GSML1FEC.cpp:205)."""
        for d in range(self.repeat_length + 1):
            if ((fn + d) % self.repeat_length) in self.frame_mapping:
                return fn + d
        raise RuntimeError("empty mapping")


def _m(tao, dl, ul, slots, c0, repeat, frames) -> TDMAMapping:
    return TDMAMapping(tao, dl, ul, slots, c0, repeat, tuple(frames))


T = TypeAndOffset

# --- beacon / common control (51-multiframe) — GSMTDMA.cpp:60-85 -------
FCCH = _m(T.TDMA_BEACON, True, False, 0x01, True, 51, [0, 10, 20, 30, 40])
SCH = _m(T.TDMA_BEACON, True, False, 0x01, True, 51, [1, 11, 21, 31, 41])
BCCH = _m(T.TDMA_BEACON, True, False, 0x55, True, 51, [2, 3, 4, 5])
RACH_C5 = _m(T.TDMA_BEACON, False, True, 0x55, True, 51,
             [4, 5] + list(range(14, 37)) + [45, 46])
CCCH = tuple(
    _m(T.TDMA_BEACON, True, False, 0x55, True, 51, frames)
    for frames in ([6, 7, 8, 9], [12, 13, 14, 15], [16, 17, 18, 19],
                   [22, 23, 24, 25])
)

# --- SDCCH/4 + its SACCH (C-V beacon slot) — GSMTDMA.cpp:92-142 --------
_SDCCH4_D = ([22, 23, 24, 25], [26, 27, 28, 29], [32, 33, 34, 35],
             [36, 37, 38, 39])
_SDCCH4_U = ([37, 38, 39, 40], [41, 42, 43, 44], [47, 48, 49, 50],
             [0, 1, 2, 3])
_SACCH4_D = ([42, 43, 44, 45], [46, 47, 48, 49], [93, 94, 95, 96],
             [97, 98, 99, 100])
_SACCH4_U = ([57, 58, 59, 60], [61, 62, 63, 64], [6, 7, 8, 9],
             [10, 11, 12, 13])
SDCCH_4 = tuple(
    (_m(T.SDCCH_4_0 + i, True, False, 0x01, True, 51, _SDCCH4_D[i]),
     _m(T.SDCCH_4_0 + i, False, True, 0x01, True, 51, _SDCCH4_U[i]))
    for i in range(4)
)
SACCH_C4 = tuple(
    (_m(T.SDCCH_4_0 + i, True, False, 0x01, True, 102, _SACCH4_D[i]),
     _m(T.SDCCH_4_0 + i, False, True, 0x01, True, 102, _SACCH4_U[i]))
    for i in range(4)
)

# --- SDCCH/8 + its SACCH (C-VII) — GSMTDMA.cpp:146-238 -----------------
SDCCH_8 = tuple(
    (_m(T.SDCCH_8_0 + i, True, False, 0xFF, True, 51,
        [4 * i, 4 * i + 1, 4 * i + 2, 4 * i + 3]),
     _m(T.SDCCH_8_0 + i, False, True, 0xFF, True, 51,
        [(15 + 4 * i + k) % 51 for k in range(4)]))
    for i in range(8)
)
_SACCH8_D = ([32, 33, 34, 35], [36, 37, 38, 39], [40, 41, 42, 43],
             [44, 45, 46, 47], [83, 84, 85, 86], [87, 88, 89, 90],
             [91, 92, 93, 94], [95, 96, 97, 98])
_SACCH8_U = ([47, 48, 49, 50], [51, 52, 53, 54], [55, 56, 57, 58],
             [59, 60, 61, 62], [98, 99, 100, 101], [0, 1, 2, 3],
             [4, 5, 6, 7], [8, 9, 10, 11])
SACCH_C8 = tuple(
    (_m(T.SDCCH_8_0 + i, True, False, 0xFF, True, 102, _SACCH8_D[i]),
     _m(T.SDCCH_8_0 + i, False, True, 0xFF, True, 102, _SACCH8_U[i]))
    for i in range(8)
)

# --- TCH/F + FACCH + its SACCH (26-/104-multiframe) — GSMTDMA.cpp:245-270
FACCH_TCHF = _m(T.TCHF_0, True, True, 0xFF, True, 26,
                [f for f in range(25) if f != 12])
_SACCH_TF_BASE = [12, 38, 64, 90]
SACCH_TF = tuple(
    _m(T.TCHF_0, True, True, 1 << tn, True, 104,
       [_SACCH_TF_BASE[(k + tn // 2) % 4] + (13 if tn % 2 else 0)
        for k in range(4)])
    for tn in range(8)
)

LOOPBACK_TEST_FULL = _m(T.TDMA_MISC, True, True, 0xFF, False, 51,
                        list(range(48)))
