"""SMS message codecs: CP (GSM 04.11 CM), RP (04.11 relay), TL (03.40).

Reference behavior: `SMS/SMSMessages.{h,cpp}` — `CPData/CPAck/CPError`
(SMSMessages.h:727+), `RPData/RPAck/RPError` (:501-616),
`TLSubmit/TLDeliver` with address/validity/timestamp/7-bit user data
elements (:64-396); `SMS/SMSTransfer.{h,cpp}` primitives.

These layers are octet-aligned, so the codecs work on `bytes`.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Optional

# ---------------------------------------------------------------------------
# GSM 03.38 7-bit default alphabet (the reference's gGSMAlphabet,
# GSMCommon.cpp) + septet packing
# ---------------------------------------------------------------------------

# The basic character set, GSM 03.38 6.2.1 (code points 0..127);
# non-ASCII spelled as escapes to keep the table encoding-proof.
GSM_BASIC_CHARSET = (
    "@£$¥èéùìòÇ\nØø\r"
    "Åå"
    "Δ_ΦΓΛΩΠΨΣΘΞ"
    "\x1bÆæßÉ"
    " !\"#¤%&'()*+,-./"
    "0123456789:;<=>?"
    "¡ABCDEFGHIJKLMNO"
    "PQRSTUVWXYZÄÖÑÜ§"
    "¿abcdefghijklmno"
    "pqrstuvwxyzäöñüà"
)
assert len(GSM_BASIC_CHARSET) == 128
GSM_EXTENSION = {"^": 0x14, "{": 0x28, "}": 0x29, "\\": 0x2F, "[": 0x3C,
                 "~": 0x3D, "]": 0x3E, "|": 0x40, "€": 0x65}
_TO_GSM = {c: i for i, c in enumerate(GSM_BASIC_CHARSET)}
_FROM_EXT = {v: k for k, v in GSM_EXTENSION.items()}


def encode_gsm_chars(text: str) -> list[int]:
    """Unicode → GSM 03.38 septet values (encodeGSMChar equivalent;
    unmappable characters become '?')."""
    out = []
    for ch in text:
        if ch in _TO_GSM:
            out.append(_TO_GSM[ch])
        elif ch in GSM_EXTENSION:
            out.append(0x1B)
            out.append(GSM_EXTENSION[ch])
        else:
            out.append(_TO_GSM["?"])
    return out


def decode_gsm_chars(septets: list[int]) -> str:
    out = []
    esc = False
    for v in septets:
        if esc:
            out.append(_FROM_EXT.get(v, "?"))
            esc = False
        elif v == 0x1B:
            esc = True
        else:
            out.append(GSM_BASIC_CHARSET[v] if v < 128 else "?")
    return "".join(out)


def pack_7bit(text: str) -> bytes:
    """GSM 7-bit septet packing (GSM 03.38 6.1.2.1.1); ASCII subset."""
    acc = 0
    nbits = 0
    out = bytearray()
    for c in text:
        acc |= (ord(c) & 0x7F) << nbits
        nbits += 7
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def unpack_7bit(data: bytes, septet_count: int) -> str:
    bits = 0
    acc = 0
    out = []
    for byte in data:
        acc |= byte << bits
        bits += 8
        while bits >= 7 and len(out) < septet_count:
            out.append(chr(acc & 0x7F))
            acc >>= 7
            bits -= 7
    return "".join(out[:septet_count])


# ---------------------------------------------------------------------------
# Addresses (GSM 04.11 8.2.5.1/2 and 03.40 9.1.2.5)
# ---------------------------------------------------------------------------

def encode_address(digits: str, ton: int = 1, npi: int = 1) -> bytes:
    """RP/TP address: length (digits), type octet, BCD digits."""
    out = bytearray([len(digits), 0x80 | (ton << 4) | npi])
    for i in range(0, len(digits), 2):
        lo = int(digits[i])
        hi = 0xF if i + 1 >= len(digits) else int(digits[i + 1])
        out.append((hi << 4) | lo)
    return bytes(out)


def decode_address(data: bytes, offset: int) -> tuple[str, int]:
    """Returns (digits, next_offset)."""
    n = data[offset]
    octets = (n + 1) // 2
    digits = []
    for b in data[offset + 2 : offset + 2 + octets]:
        digits.append(str(b & 0xF))
        if (b >> 4) != 0xF:
            digits.append(str(b >> 4))
    return "".join(digits[:n]), offset + 2 + octets


# ---------------------------------------------------------------------------
# TL layer (GSM 03.40)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TLSubmit:
    """SMS-SUBMIT, MS→network (SMSMessages.h TLSubmit)."""

    mr: int = 0
    dest: str = ""
    pid: int = 0
    dcs: int = 0  # 7-bit default
    text: str = ""

    def encode(self) -> bytes:
        out = bytearray()
        out.append(0x01)  # MTI=01 SUBMIT, no VP
        out.append(self.mr)
        out += encode_address(self.dest)
        out.append(self.pid)
        out.append(self.dcs)
        out.append(len(self.text))  # UDL in septets
        out += pack_7bit(self.text)
        return bytes(out)

    @classmethod
    def parse(cls, data: bytes) -> "TLSubmit":
        first = data[0]
        assert first & 0x03 == 0x01, "not SMS-SUBMIT"
        vpf = (first >> 3) & 0x03
        mr = data[1]
        dest, off = decode_address(data, 2)
        pid = data[off]
        dcs = data[off + 1]
        off += 2
        if vpf == 2:
            off += 1  # relative VP
        elif vpf in (1, 3):
            off += 7  # absolute/enhanced VP
        udl = data[off]
        text = unpack_7bit(data[off + 1 :], udl)
        return cls(mr, dest, pid, dcs, text)


@dataclasses.dataclass
class TLDeliver:
    """SMS-DELIVER, network→MS (SMSMessages.h TLDeliver)."""

    orig: str = ""
    pid: int = 0
    dcs: int = 0
    text: str = ""
    timestamp: Optional[datetime.datetime] = None

    @staticmethod
    def _scts(dt: datetime.datetime) -> bytes:
        def swap(v):
            return ((v % 10) << 4) | (v // 10)

        return bytes([swap(dt.year % 100), swap(dt.month), swap(dt.day),
                      swap(dt.hour), swap(dt.minute), swap(dt.second), 0])

    def encode(self) -> bytes:
        dt = self.timestamp or datetime.datetime(2009, 1, 1)
        out = bytearray()
        out.append(0x00)  # MTI=00 DELIVER
        out += encode_address(self.orig)
        out.append(self.pid)
        out.append(self.dcs)
        out += self._scts(dt)
        out.append(len(self.text))
        out += pack_7bit(self.text)
        return bytes(out)

    @classmethod
    def parse(cls, data: bytes) -> "TLDeliver":
        assert data[0] & 0x03 == 0x00, "not SMS-DELIVER"
        orig, off = decode_address(data, 1)
        pid = data[off]
        dcs = data[off + 1]
        off += 2 + 7  # skip SCTS
        udl = data[off]
        text = unpack_7bit(data[off + 1 :], udl)
        return cls(orig, pid, dcs, text)


# ---------------------------------------------------------------------------
# RP layer (GSM 04.11 7.3)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RPData:
    """RP-DATA (SMSMessages.h:501)."""

    reference: int = 0
    dest: str = ""  # service-center address (MO) or empty (MT)
    tpdu: bytes = b""
    mo: bool = True  # MS→network direction

    def encode(self) -> bytes:
        out = bytearray()
        out.append(0x00 if self.mo else 0x01)  # MTI
        out.append(self.reference)
        if self.mo:
            out.append(0)  # originator address: zero length
            out += encode_address(self.dest) if self.dest else b"\x00"
        else:
            out += encode_address(self.dest) if self.dest else b"\x00"
            out.append(0)  # destination address: zero length
        out.append(len(self.tpdu))
        out += self.tpdu
        return bytes(out)

    @classmethod
    def parse(cls, data: bytes) -> "RPData":
        mti = data[0] & 0x07
        mo = mti == 0
        ref = data[1]
        off = 2
        addr1_len = data[off]
        if addr1_len == 0:
            addr1, off = "", off + 1
        else:
            addr1, off = decode_address(data, off)
        addr2_len = data[off]
        if addr2_len == 0:
            addr2, off = "", off + 1
        else:
            addr2, off = decode_address(data, off)
        tp_len = data[off]
        tpdu = data[off + 1 : off + 1 + tp_len]
        return cls(ref, addr2 if mo else addr1, tpdu, mo)


@dataclasses.dataclass
class RPAck:
    reference: int = 0
    mo: bool = False  # network→MS ack of an MO RP-DATA

    def encode(self) -> bytes:
        return bytes([0x02 if self.mo else 0x03, self.reference])

    @classmethod
    def parse(cls, data: bytes) -> "RPAck":
        return cls(data[1], (data[0] & 0x07) == 0x02)


@dataclasses.dataclass
class RPError:
    reference: int = 0
    cause: int = 41
    mo: bool = False

    def encode(self) -> bytes:
        return bytes([0x04 if self.mo else 0x05, self.reference, 1,
                      self.cause])

    @classmethod
    def parse(cls, data: bytes) -> "RPError":
        return cls(data[1], data[3] if len(data) > 3 else 0,
                   (data[0] & 0x07) == 0x04)


# ---------------------------------------------------------------------------
# CP layer (GSM 04.11 7.2; PD=9 with TI, carried in an L3 message)
# ---------------------------------------------------------------------------

SMS_PD = 0x09


def _cp_header(ti: int, mti: int) -> bytes:
    return bytes([((ti & 0xF) << 4) | SMS_PD, mti])


@dataclasses.dataclass
class CPData:
    """CP-DATA carrying an RPDU (SMSMessages.h:727)."""

    ti: int = 0
    rpdu: bytes = b""

    def encode(self) -> bytes:
        return _cp_header(self.ti, 0x01) + bytes([len(self.rpdu)]) + \
            self.rpdu

    @classmethod
    def parse(cls, data: bytes) -> "CPData":
        assert data[0] & 0x0F == SMS_PD and data[1] == 0x01
        n = data[2]
        return cls(data[0] >> 4, data[3 : 3 + n])


@dataclasses.dataclass
class CPAck:
    ti: int = 0

    def encode(self) -> bytes:
        return _cp_header(self.ti, 0x04)

    @classmethod
    def parse(cls, data: bytes) -> "CPAck":
        assert data[1] == 0x04
        return cls(data[0] >> 4)


@dataclasses.dataclass
class CPError:
    ti: int = 0
    cause: int = 111

    def encode(self) -> bytes:
        return _cp_header(self.ti, 0x10) + bytes([self.cause])

    @classmethod
    def parse(cls, data: bytes) -> "CPError":
        assert data[1] == 0x10
        return cls(data[0] >> 4, data[2])


def parse_cp(data: bytes):
    """CP-layer factory."""
    mti = data[1]
    return {0x01: CPData, 0x04: CPAck, 0x10: CPError}[mti].parse(data)


def parse_rp(data: bytes):
    """RP-layer factory."""
    mti = data[0] & 0x07
    if mti in (0, 1):
        return RPData.parse(data)
    if mti in (2, 3):
        return RPAck.parse(data)
    if mti in (4, 5):
        return RPError.parse(data)
    raise ValueError(f"RP MTI {mti}")
