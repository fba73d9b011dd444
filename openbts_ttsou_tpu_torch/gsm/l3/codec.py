"""L3 codec machinery: bit readers/writers, message base, factory.

Reference behavior: `GSM/GSML3Message.{h,cpp}` — the standard L3 header
(skip:4 | PD:4 | MTI:8, GSML3Message.cpp:52-63), the `parseL3` factory
dispatching on PD and MTI, and the V/LV/TV/TLV element write helpers
(GSML3Message.cpp:210-240).
"""

from __future__ import annotations

import enum
from typing import Dict, Optional, Type

import numpy as np


class L3PD(enum.IntEnum):
    """Protocol discriminators (GSM 04.07 11.2.3.1.1;
    GSMCommon.h:267-280)."""

    GroupCallControl = 0x00
    BroadcastCallControl = 0x01
    CallControl = 0x03
    MobilityManagement = 0x05
    RadioResource = 0x06
    SMS = 0x09
    NonCallSS = 0x0B


class BitWriter:
    """MSB-first bit writer (BitVector::writeField semantics)."""

    def __init__(self):
        self.bits: list[int] = []

    def field(self, value: int, width: int) -> "BitWriter":
        for i in range(width - 1, -1, -1):
            self.bits.append((int(value) >> i) & 1)
        return self

    def octet(self, value: int) -> "BitWriter":
        return self.field(value, 8)

    def raw(self, bits: np.ndarray) -> "BitWriter":
        self.bits.extend(int(b) & 1 for b in np.asarray(bits).ravel())
        return self

    def array(self) -> np.ndarray:
        return np.asarray(self.bits, np.uint8)

    def __len__(self):
        return len(self.bits)


class BitReader:
    """MSB-first bit reader (BitVector::peekField/readField)."""

    def __init__(self, bits: np.ndarray):
        self.bits = np.asarray(bits, np.uint8)
        self.rp = 0

    def field(self, width: int) -> int:
        v = 0
        for _ in range(width):
            v = (v << 1) | int(self.bits[self.rp])
            self.rp += 1
        return v

    def octet(self) -> int:
        return self.field(8)

    def raw(self, nbits: int) -> np.ndarray:
        out = self.bits[self.rp : self.rp + nbits].copy()
        self.rp += nbits
        return out

    def remaining(self) -> int:
        return len(self.bits) - self.rp

    def skip(self, nbits: int) -> None:
        self.rp += nbits


class L3Message:
    """Base L3 message: standard header + body
    (GSML3Message.h; write at GSML3Message.cpp:52)."""

    PD: L3PD = L3PD.RadioResource
    MTI: int = 0

    def write_body(self, w: BitWriter) -> None:
        raise NotImplementedError

    def parse_body(self, r: BitReader) -> None:
        raise NotImplementedError

    def encode(self) -> np.ndarray:
        w = BitWriter()
        w.field(0, 4)  # skip indicator
        w.field(int(self.PD), 4)
        w.field(self.MTI, 8)
        self.write_body(w)
        # pad to octet boundary with the 04.08 rest-octet filler "0x2B"
        while len(w) % 8:
            w.field(0, 1)
        return w.array()

    @classmethod
    def decode(cls, bits: np.ndarray) -> "L3Message":
        r = BitReader(bits)
        r.field(4)  # skip
        pd = r.field(4)
        mti = r.field(8)
        if pd != int(cls.PD) or mti != cls.MTI:
            raise ValueError(
                f"{cls.__name__}: wrong PD/MTI {pd:#x}/{mti:#x}")
        msg = cls.__new__(cls)
        msg.__init__()  # default fields
        msg.parse_body(r)
        return msg

    def __repr__(self):
        fields = {k: v for k, v in self.__dict__.items()
                  if not k.startswith("_")}
        return f"{type(self).__name__}({fields})"

    def __eq__(self, other):
        return (type(self) is type(other)
                and repr(self) == repr(other))


_REGISTRY: Dict[tuple[int, int], Type[L3Message]] = {}


def register(cls: Type[L3Message]) -> Type[L3Message]:
    """Class decorator adding the message to the parse factory. A
    (PD, MTI) pair names one message: a second class raises."""
    key = (int(cls.PD), cls.MTI)
    if _REGISTRY.get(key, cls) is not cls:
        raise ValueError(f"{cls.__name__}: PD {key[0]} MTI {key[1]:#04x} "
                         f"is {_REGISTRY[key].__name__}'s")
    _REGISTRY[key] = cls
    return cls


def parse_l3(bits: np.ndarray) -> Optional[L3Message]:
    """Parse any registered message (the parseL3 factory,
    GSML3Message.cpp). Returns None for unknown PD/MTI."""
    r = BitReader(bits)
    skip = r.field(4)
    pd = r.field(4)
    mti = r.field(8)
    cls = _REGISTRY.get((pd, mti))
    if cls is None:
        # MTI high bits can carry send-sequence numbers on some uplink
        # MM messages (GSM 04.08 10.2); retry masked.
        cls = _REGISTRY.get((pd, mti & 0x3F))
        if cls is None:
            return None
    msg = cls.__new__(cls)
    msg.__init__()
    if hasattr(msg, "ti"):
        # CC's skip nibble carries the transaction identifier
        # (GSM 04.07 11.2.3.1.3) — preserve it through parse
        msg.ti = skip
    msg.parse_body(BitReader(bits[16:]))
    return msg
