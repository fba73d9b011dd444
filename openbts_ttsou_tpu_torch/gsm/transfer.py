"""L2/L3 frame objects and burst containers.

Reference behavior: `GSM/GSMTransfer.{h,cpp}` — `L2Address` (:217),
`L2Control` (:253), `L2Length` (:337), `L2Header` (:372), `L2Frame`
(:467, 23 octets = 184 bits with GSM 04.06 2.2 idle fill), `L3Frame`
(:578), `TxBurst`/`RxBurst` (:82,151), and the `Primitive` enum (:65).

Bits are numpy uint8 arrays; fields are written MSB-first exactly as the
reference's writeField. The LSB8MSB octet reversal happens at the L1
boundary (see gsm.l1fec.lsb8msb).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np


class Primitive(enum.Enum):
    """L2↔L3 service primitives (GSMTransfer.h:65-73)."""

    ESTABLISH = 0
    RELEASE = 1
    DATA = 2
    UNIT_DATA = 3
    ERROR = 4
    HARDRELEASE = 5


class ChannelType(enum.Enum):
    SDCCH = 0
    SACCH = 1
    FACCH = 2
    BCCH = 3
    CCCH = 4


class FrameFormat(enum.Enum):
    """LAPDm frame formats, GSM 04.06 2.1 (GSMTransfer.h:377-384)."""

    A = 0
    B = 1
    Bbis = 2
    Bter = 3
    B4 = 4
    C = 5


class ControlFormat(enum.Enum):
    I = 0
    S = 1
    U = 2


class FrameType(enum.Enum):
    """LAPDm frame types, GSM 04.06 3.8.1 (GSMTransfer.h:262-273)."""

    UI = 0
    SABM = 1
    UA = 2
    DM = 3
    DISC = 4
    RR = 5
    RNR = 6
    REJ = 7
    I = 8
    BOGUS = 9


# GSM 04.06 Table 4 U-bit codes (GSMTransfer.cpp:267-283)
U_BITS = {FrameType.SABM: 0x07, FrameType.DM: 0x03, FrameType.UI: 0x00,
          FrameType.DISC: 0x08, FrameType.UA: 0x0C}
S_BITS = {FrameType.RR: 0x0, FrameType.RNR: 0x1, FrameType.REJ: 0x2}

L2_FRAME_BITS = 23 * 8
IDLE_PATTERN = np.array([0, 0, 1, 0, 1, 0, 1, 1], np.uint8)  # 0x2B fill


def n201(fmt: FrameFormat, chan: ChannelType) -> int:
    """Max L3 payload octets per frame format/channel (GSM 04.06 5.8.3;
    GSMTransfer.cpp:70-108)."""
    if fmt in (FrameFormat.A, FrameFormat.B):
        return {ChannelType.SACCH: 18, ChannelType.SDCCH: 20,
                ChannelType.FACCH: 20}[chan]
    if fmt == FrameFormat.Bbis:
        return {ChannelType.BCCH: 23, ChannelType.CCCH: 22,
                ChannelType.SDCCH: 23}[chan]
    if fmt == FrameFormat.B4:
        return {ChannelType.SACCH: 19}[chan]
    raise ValueError(fmt)


def _write_field(bits: np.ndarray, wp: int, value: int, width: int) -> int:
    for i in range(width):
        bits[wp + i] = (value >> (width - 1 - i)) & 1
    return wp + width


def _peek_field(bits: np.ndarray, pos: int, width: int) -> int:
    v = 0
    for i in range(width):
        v = (v << 1) | int(bits[pos + i] & 1)
    return v


@dataclasses.dataclass
class L2Address:
    """GSM 04.06 3.2/3.3 (GSMTransfer.cpp:334-343)."""

    cr: int = 0
    sapi: int = 0
    lpd: int = 0

    def write(self, bits: np.ndarray, wp: int) -> int:
        wp = _write_field(bits, wp, 0, 1)  # spare
        wp = _write_field(bits, wp, self.lpd, 2)
        wp = _write_field(bits, wp, self.sapi, 3)
        wp = _write_field(bits, wp, self.cr, 1)
        return _write_field(bits, wp, 1, 1)  # no extension


@dataclasses.dataclass
class L2Control:
    """GSM 04.06 3.4 Table 3 (GSMTransfer.cpp:166-197)."""

    format: ControlFormat = ControlFormat.U
    nr: int = 0
    ns: int = 0
    pf: int = 0
    bits: int = 0  # S or U function bits

    def write(self, out: np.ndarray, wp: int) -> int:
        if self.format == ControlFormat.I:
            wp = _write_field(out, wp, self.nr, 3)
            wp = _write_field(out, wp, self.pf, 1)
            wp = _write_field(out, wp, self.ns, 3)
            return _write_field(out, wp, 0, 1)
        if self.format == ControlFormat.S:
            wp = _write_field(out, wp, self.nr, 3)
            wp = _write_field(out, wp, self.pf, 1)
            wp = _write_field(out, wp, self.bits, 2)
            return _write_field(out, wp, 1, 2)
        u1, u2 = self.bits >> 2, self.bits & 3
        wp = _write_field(out, wp, u1, 3)
        wp = _write_field(out, wp, self.pf, 1)
        wp = _write_field(out, wp, u2, 2)
        return _write_field(out, wp, 3, 2)


@dataclasses.dataclass
class L2Length:
    """GSM 04.06 3.6 (GSMTransfer.cpp:199-206)."""

    l: int = 0
    m: int = 0

    def write(self, out: np.ndarray, wp: int) -> int:
        wp = _write_field(out, wp, self.l, 6)
        wp = _write_field(out, wp, self.m, 1)
        return _write_field(out, wp, 1, 1)


@dataclasses.dataclass
class L2Header:
    """GSM 04.06 3 (GSMTransfer.h:372; write: GSMTransfer.cpp:134-160)."""

    format: FrameFormat = FrameFormat.B
    address: L2Address = dataclasses.field(default_factory=L2Address)
    control: L2Control = dataclasses.field(default_factory=L2Control)
    length: L2Length = dataclasses.field(default_factory=L2Length)

    def write(self, out: np.ndarray) -> int:
        wp = 0
        if self.format in (FrameFormat.A, FrameFormat.B):
            wp = self.address.write(out, wp)
            wp = self.control.write(out, wp)
            wp = self.length.write(out, wp)
        elif self.format == FrameFormat.Bbis:
            wp = self.length.write(out, wp)
        elif self.format == FrameFormat.B4:
            wp = self.address.write(out, wp)
            wp = self.control.write(out, wp)
        return wp


class L2Frame:
    """23-octet LAPDm frame (GSMTransfer.h:467; ctors
    GSMTransfer.cpp:221-245)."""

    def __init__(self, bits: Optional[np.ndarray] = None,
                 primitive: Primitive = Primitive.DATA):
        if bits is None:
            self.bits = np.tile(IDLE_PATTERN, L2_FRAME_BITS // 8).copy()
        else:
            bits = np.asarray(bits, np.uint8)
            self.bits = np.zeros(L2_FRAME_BITS, np.uint8)
            self.bits[: len(bits)] = bits
        self.primitive = primitive

    @classmethod
    def from_header(cls, header: L2Header,
                    l3: Optional[np.ndarray] = None) -> "L2Frame":
        f = cls()
        wp = header.write(f.bits)
        if l3 is not None:
            l3 = np.asarray(l3, np.uint8)
            f.bits[wp : wp + len(l3)] = l3
        return f

    # -- field accessors (GSMTransfer.h:467-578) -----------------------
    def sapi(self) -> int:
        return _peek_field(self.bits, 3, 3)

    def cr(self) -> int:
        return int(self.bits[6])

    def pf(self) -> int:
        return int(self.bits[8 + 3])

    def nr(self) -> int:
        return _peek_field(self.bits, 8, 3)

    def ns(self) -> int:
        return _peek_field(self.bits, 8 + 4, 3)

    def l(self) -> int:
        return _peek_field(self.bits, 16, 6)

    def m(self) -> int:
        return int(self.bits[16 + 6])

    def l3_part(self) -> np.ndarray:
        return self.bits[24 : 24 + 8 * self.l()].copy()

    def control_format(self) -> ControlFormat:
        if self.bits[8 + 7] == 0:
            return ControlFormat.I
        if self.bits[8 + 6] == 0:
            return ControlFormat.S
        return ControlFormat.U

    def u_frame_type(self) -> FrameType:
        u = (_peek_field(self.bits, 8, 3) << 2) | _peek_field(
            self.bits, 8 + 4, 2)
        for t, v in U_BITS.items():
            if v == u:
                return t
        return FrameType.BOGUS

    def s_frame_type(self) -> FrameType:
        s = _peek_field(self.bits, 8 + 4, 2)
        return [FrameType.RR, FrameType.RNR, FrameType.REJ,
                FrameType.BOGUS][s]

    def frame_type(self) -> FrameType:
        cf = self.control_format()
        if cf == ControlFormat.I:
            return FrameType.I
        if cf == ControlFormat.S:
            return self.s_frame_type()
        return self.u_frame_type()

    def is_idle(self) -> bool:
        """DCCH idle frame check (GSMTransfer.h:85-88)."""
        return _peek_field(self.bits, 0, 32) == 0x0103012B

    def sum(self) -> int:
        return int(self.bits.sum())


class L3Frame:
    """An L3 message or primitive signal (GSMTransfer.h:578)."""

    def __init__(self, bits: Optional[np.ndarray] = None,
                 primitive: Primitive = Primitive.DATA):
        self.bits = (np.zeros(0, np.uint8) if bits is None
                     else np.asarray(bits, np.uint8).copy())
        self.primitive = primitive

    @classmethod
    def from_hex(cls, hex_string: str,
                 primitive: Primitive = Primitive.DATA) -> "L3Frame":
        data = bytes.fromhex(hex_string)
        bits = np.unpackbits(np.frombuffer(data, np.uint8))
        return cls(bits, primitive)

    def __len__(self) -> int:
        return len(self.bits)

    def octets(self) -> bytes:
        padded = np.zeros(-(-len(self.bits) // 8) * 8, np.uint8)
        padded[: len(self.bits)] = self.bits
        return np.packbits(padded).tobytes()


@dataclasses.dataclass
class TxBurst:
    """148 hard bits + time (GSMTransfer.h:82)."""

    bits: np.ndarray
    fn: int = 0
    tn: int = 0


@dataclasses.dataclass
class RxBurst:
    """148 soft bits + time + physical params (GSMTransfer.h:151)."""

    soft: np.ndarray
    fn: int = 0
    tn: int = 0
    rssi: float = 0.0
    timing_error: float = 0.0

    def data1(self) -> np.ndarray:
        return self.soft[3:60]

    def data2(self) -> np.ndarray:
        return self.soft[88:145]

    def hl(self) -> bool:
        return self.soft[60] > 0.5

    def hu(self) -> bool:
        return self.soft[87] > 0.5
