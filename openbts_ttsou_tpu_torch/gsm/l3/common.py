"""Common L3 elements: LAI, mobile identity, classmark, cell ID.

Reference behavior: `GSM/GSML3CommonElements.{h,cpp}` — LAI nibble-swap
BCD layout (writeV at GSML3CommonElements.cpp), mobile identity with
IMSI/TMSI BCD digits and odd/even flag (GSM 04.08 10.5.1.4).
"""

from __future__ import annotations

import dataclasses

from openbts_ttsou_tpu_torch.gsm.l3.codec import BitReader, BitWriter


@dataclasses.dataclass
class LAI:
    """Location Area Identification (GSM 04.08 10.5.1.3): MCC 3 digits,
    MNC 2-3 digits, LAC 16 bits. 5 octets in V format."""

    mcc: str = "001"
    mnc: str = "01"
    lac: int = 0

    def write_v(self, w: BitWriter) -> None:
        d = [int(c) for c in self.mcc]
        m = [int(c) for c in self.mnc] + ([0xF] if len(self.mnc) == 2 else [])
        w.field(d[1], 4).field(d[0], 4)
        w.field(m[2], 4).field(d[2], 4)
        w.field(m[1], 4).field(m[0], 4)
        w.field(self.lac, 16)

    @classmethod
    def parse_v(cls, r: BitReader) -> "LAI":
        d1b, d0 = r.field(4), r.field(4)
        m2, d2 = r.field(4), r.field(4)
        m1, m0 = r.field(4), r.field(4)
        lac = r.field(16)
        mcc = f"{d0}{d1b}{d2}"
        mnc = f"{m0}{m1}" + ("" if m2 == 0xF else str(m2))
        return cls(mcc, mnc, lac)


# Mobile identity types (GSM 04.08 10.5.1.4)
MID_NONE, MID_IMSI, MID_IMEI, MID_IMEISV, MID_TMSI = 0, 1, 2, 3, 4


@dataclasses.dataclass
class MobileIdentity:
    """IMSI (BCD digits) or TMSI (32-bit) identity, LV format."""

    kind: int = MID_NONE
    digits: str = ""  # IMSI/IMEI digits
    tmsi: int = 0

    @classmethod
    def imsi(cls, digits: str) -> "MobileIdentity":
        return cls(MID_IMSI, digits, 0)

    @classmethod
    def from_tmsi(cls, tmsi: int) -> "MobileIdentity":
        return cls(MID_TMSI, "", tmsi)

    def write_lv(self, w: BitWriter) -> None:
        if self.kind == MID_TMSI:
            w.octet(5)
            w.field(0xF, 4).field(0, 1).field(MID_TMSI, 3)
            w.field(self.tmsi, 32)
            return
        n = len(self.digits)
        length = n // 2 + 1  # identity octets: type/first-digit + pairs
        w.octet(length)
        odd = n % 2
        first = int(self.digits[0]) if n else 0
        w.field(first, 4).field(odd, 1).field(self.kind, 3)
        i = 1
        while i < n:
            hi = 0xF if i + 1 >= n else int(self.digits[i + 1])
            w.field(hi, 4).field(int(self.digits[i]), 4)
            i += 2

    @classmethod
    def parse_lv(cls, r: BitReader) -> "MobileIdentity":
        length = r.octet()
        first = r.field(4)
        odd = r.field(1)
        kind = r.field(3)
        if kind == MID_TMSI:
            return cls(MID_TMSI, "", r.field(32))
        digits = [first]
        for _ in range(length - 1):
            hi = r.field(4)
            lo = r.field(4)
            digits.append(lo)
            digits.append(hi)
        if not odd:
            digits.pop()  # drop the 0xF filler
        return cls(kind, "".join(str(d) for d in digits))


@dataclasses.dataclass
class MobileStationClassmark2:
    """GSM 04.08 10.5.1.6, LV (3 octets of fields)."""

    revision: int = 1
    es_ind: int = 0
    a51: int = 0
    power_class: int = 0
    ps_cap: int = 0
    ss_screen: int = 0
    sm_cap: int = 1
    a52: int = 0
    a53: int = 0

    def write_lv(self, w: BitWriter) -> None:
        w.octet(3)
        w.field(0, 1).field(self.revision, 2).field(self.es_ind, 1)
        w.field(self.a51, 1).field(self.power_class, 3)
        w.field(0, 1).field(self.ps_cap, 1).field(self.ss_screen, 2)
        w.field(self.sm_cap, 1).field(0, 3)
        w.field(0, 1).field(0, 4).field(self.a53, 1).field(self.a52, 1)
        w.field(0, 1)

    @classmethod
    def parse_lv(cls, r: BitReader) -> "MobileStationClassmark2":
        length = r.octet()
        c = cls()
        r.field(1)
        c.revision = r.field(2)
        c.es_ind = r.field(1)
        c.a51 = r.field(1)
        c.power_class = r.field(3)
        r.field(1)
        c.ps_cap = r.field(1)
        c.ss_screen = r.field(2)
        c.sm_cap = r.field(1)
        r.field(3)
        r.field(1)
        r.field(4)
        c.a53 = r.field(1)
        c.a52 = r.field(1)
        r.field(1)
        for _ in range(length - 3):
            r.octet()
        return c
