"""Mobility Management messages (GSM 04.08 9.2; PD=5).

Reference behavior: `GSM/GSML3MMMessages.{h,cpp}` — the LUR flow,
CM service, identity and detach procedures used by
Control/MobilityManagement.cpp.
"""

from __future__ import annotations

from openbts_ttsou_tpu_torch.gsm.l3.codec import (
    BitReader,
    BitWriter,
    L3Message,
    L3PD,
    register,
)
from openbts_ttsou_tpu_torch.gsm.l3.common import (
    LAI,
    MobileIdentity,
    MobileStationClassmark2,
)


@register
class LocationUpdatingRequest(L3Message):
    """GSM 04.08 9.2.15 (uplink)."""

    PD = L3PD.MobilityManagement
    MTI = 0x08

    def __init__(self, lai: LAI | None = None,
                 identity: MobileIdentity | None = None,
                 lu_type: int = 0, key_seq: int = 7):
        self.lai = lai or LAI()
        self.identity = identity or MobileIdentity()
        self.lu_type = lu_type
        self.key_seq = key_seq

    def write_body(self, w: BitWriter) -> None:
        w.field(self.key_seq, 4)
        w.field(0, 2).field(self.lu_type, 2)
        self.lai.write_v(w)
        w.octet(0x33)  # classmark 1 stub
        self.identity.write_lv(w)

    def parse_body(self, r: BitReader) -> None:
        self.key_seq = r.field(4)
        r.field(2)
        self.lu_type = r.field(2)
        self.lai = LAI.parse_v(r)
        r.octet()  # classmark 1
        self.identity = MobileIdentity.parse_lv(r)


@register
class LocationUpdatingAccept(L3Message):
    """GSM 04.08 9.2.13."""

    PD = L3PD.MobilityManagement
    MTI = 0x02

    def __init__(self, lai: LAI | None = None,
                 identity: MobileIdentity | None = None,
                 follow_on_proceed: bool = False):
        self.lai = lai or LAI()
        self.identity = identity  # optional new TMSI/IMSI (IEI 0x17)
        self.follow_on_proceed = follow_on_proceed

    def write_body(self, w: BitWriter) -> None:
        self.lai.write_v(w)
        if self.identity is not None:
            w.octet(0x17)
            self.identity.write_lv(w)
        if self.follow_on_proceed:
            w.octet(0xA1)

    def parse_body(self, r: BitReader) -> None:
        self.lai = LAI.parse_v(r)
        self.identity = None
        self.follow_on_proceed = False
        while r.remaining() >= 8:
            iei = r.octet()
            if iei == 0x17:
                self.identity = MobileIdentity.parse_lv(r)
            elif iei == 0xA1:
                self.follow_on_proceed = True
            else:
                break


@register
class LocationUpdatingReject(L3Message):
    """GSM 04.08 9.2.14."""

    PD = L3PD.MobilityManagement
    MTI = 0x04

    def __init__(self, cause: int = 0x02):
        self.cause = cause

    def write_body(self, w: BitWriter) -> None:
        w.octet(self.cause)

    def parse_body(self, r: BitReader) -> None:
        self.cause = r.octet()


@register
class CMServiceRequest(L3Message):
    """GSM 04.08 9.2.9 (uplink)."""

    PD = L3PD.MobilityManagement
    MTI = 0x24

    def __init__(self, service_type: int = 1,
                 identity: MobileIdentity | None = None,
                 classmark: MobileStationClassmark2 | None = None):
        self.service_type = service_type  # 1=MO call, 4=SMS, 8=emergency
        self.identity = identity or MobileIdentity()
        self.classmark = classmark or MobileStationClassmark2()

    def write_body(self, w: BitWriter) -> None:
        w.field(7, 4).field(self.service_type, 4)
        self.classmark.write_lv(w)
        self.identity.write_lv(w)

    def parse_body(self, r: BitReader) -> None:
        r.field(4)
        self.service_type = r.field(4)
        self.classmark = MobileStationClassmark2.parse_lv(r)
        self.identity = MobileIdentity.parse_lv(r)


@register
class CMServiceAccept(L3Message):
    PD = L3PD.MobilityManagement
    MTI = 0x21

    def write_body(self, w: BitWriter) -> None:
        pass

    def parse_body(self, r: BitReader) -> None:
        pass


@register
class CMServiceReject(L3Message):
    PD = L3PD.MobilityManagement
    MTI = 0x22

    def __init__(self, cause: int = 0x20):
        self.cause = cause

    def write_body(self, w: BitWriter) -> None:
        w.octet(self.cause)

    def parse_body(self, r: BitReader) -> None:
        self.cause = r.octet()


@register
class IdentityRequest(L3Message):
    """GSM 04.08 9.2.10."""

    PD = L3PD.MobilityManagement
    MTI = 0x18

    def __init__(self, id_type: int = 1):  # 1=IMSI, 2=IMEI, 4=TMSI
        self.id_type = id_type

    def write_body(self, w: BitWriter) -> None:
        w.field(0, 4).field(self.id_type, 4)

    def parse_body(self, r: BitReader) -> None:
        r.field(4)
        self.id_type = r.field(4)


@register
class IdentityResponse(L3Message):
    """GSM 04.08 9.2.11 (uplink)."""

    PD = L3PD.MobilityManagement
    MTI = 0x19

    def __init__(self, identity: MobileIdentity | None = None):
        self.identity = identity or MobileIdentity()

    def write_body(self, w: BitWriter) -> None:
        self.identity.write_lv(w)

    def parse_body(self, r: BitReader) -> None:
        self.identity = MobileIdentity.parse_lv(r)


@register
class IMSIDetachIndication(L3Message):
    """GSM 04.08 9.2.12 (uplink)."""

    PD = L3PD.MobilityManagement
    MTI = 0x01

    def __init__(self, identity: MobileIdentity | None = None):
        self.identity = identity or MobileIdentity()

    def write_body(self, w: BitWriter) -> None:
        w.octet(0x33)  # classmark 1 stub
        self.identity.write_lv(w)

    def parse_body(self, r: BitReader) -> None:
        r.octet()
        self.identity = MobileIdentity.parse_lv(r)


@register
class TMSIReallocationCommand(L3Message):
    """GSM 04.08 9.2.17."""

    PD = L3PD.MobilityManagement
    MTI = 0x1A

    def __init__(self, lai: LAI | None = None,
                 identity: MobileIdentity | None = None):
        self.lai = lai or LAI()
        self.identity = identity or MobileIdentity()

    def write_body(self, w: BitWriter) -> None:
        self.lai.write_v(w)
        self.identity.write_lv(w)

    def parse_body(self, r: BitReader) -> None:
        self.lai = LAI.parse_v(r)
        self.identity = MobileIdentity.parse_lv(r)


@register
class MMInformation(L3Message):
    """GSM 04.08 9.2.15a MM Information: network short name delivered
    after LU accept (L3MMInformation, GSML3MMMessages.h:341, writeBody
    at GSML3MMMessages.cpp:268: short-name TLV 0x45 only when the name
    is non-trivial; sent by LocationUpdatingController,
    MobilityManagement.cpp:203). The name IE is GSM 04.08 10.5.3.5a
    Network Name: header octet (ext|coding|CI|spare-bit count) + GSM
    03.38 7-bit packed characters (L3NetworkName::writeV,
    GSML3MMElements.cpp)."""

    PD = L3PD.MobilityManagement
    MTI = 0x32

    def __init__(self, short_name: str = "", ci: int = 0):
        self.short_name = short_name
        self.ci = ci  # Country Initials bit

    def write_body(self, w: BitWriter) -> None:
        from openbts_ttsou_tpu_torch.sms.messages import pack_7bit

        if len(self.short_name) <= 1:
            return  # lengthV>1 gate, GSML3MMMessages.cpp:270
        packed = pack_7bit(self.short_name)
        n = len(self.short_name)
        spare = (8 - (n * 7) % 8) % 8
        w.octet(0x45)
        w.octet(1 + len(packed))
        # ext=1 | coding=000 (GSM 03.38 default) | CI | spare bits
        w.field(1, 1).field(0, 3).field(self.ci, 1).field(spare, 3)
        for b in packed:
            w.octet(b)

    def parse_body(self, r: BitReader) -> None:
        from openbts_ttsou_tpu_torch.sms.messages import unpack_7bit

        self.short_name, self.ci = "", 0
        while r.remaining() >= 16:
            iei = r.octet()
            length = r.octet()
            if iei != 0x45 or length < 1:
                r.skip(8 * min(length, r.remaining() // 8))
                continue
            r.field(1)
            coding = r.field(3)
            self.ci = r.field(1)
            spare = r.field(3)
            raw = bytes(int(r.octet()) for _ in range(length - 1))
            if coding == 0:
                nsept = ((length - 1) * 8 - spare) // 7
                self.short_name = unpack_7bit(raw, nsept)


@register
class MMStatus(L3Message):
    PD = L3PD.MobilityManagement
    MTI = 0x31

    def __init__(self, cause: int = 0x60):
        self.cause = cause

    def write_body(self, w: BitWriter) -> None:
        w.octet(self.cause)

    def parse_body(self, r: BitReader) -> None:
        self.cause = r.octet()
