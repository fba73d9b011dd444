"""Call Control messages (GSM 04.08 9.3; PD=3, Q.931-style).

Reference behavior: `GSM/GSML3CCMessages.{h,cpp}` and
`GSML3CCElements.{h,cpp}` — the MO/MT call FSM messages of
Control/CallControl.cpp. CC messages carry a transaction identifier in
the header's upper nibble (GSM 04.07 11.2.3.1.3).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from openbts_ttsou_tpu_torch.gsm.l3.codec import (
    BitReader,
    BitWriter,
    L3Message,
    L3PD,
    register,
)


@dataclasses.dataclass
class CalledPartyBCDNumber:
    """GSM 04.08 10.5.4.7 (TLV 0x5E in Setup)."""

    digits: str = ""
    type_of_number: int = 0
    plan: int = 1

    def write_tlv(self, w: BitWriter, iei: int = 0x5E) -> None:
        n = len(self.digits)
        w.octet(iei)
        w.octet(1 + (n + 1) // 2)
        w.field(1, 1).field(self.type_of_number, 3).field(self.plan, 4)
        i = 0
        while i < n:
            hi = 0xF if i + 1 >= n else int(self.digits[i + 1])
            w.field(hi, 4).field(int(self.digits[i]), 4)
            i += 2

    @classmethod
    def parse_lv(cls, r: BitReader) -> "CalledPartyBCDNumber":
        length = r.octet()
        c = cls()
        r.field(1)
        c.type_of_number = r.field(3)
        c.plan = r.field(4)
        digits = []
        for _ in range(length - 1):
            hi = r.field(4)
            lo = r.field(4)
            digits.append(lo)
            if hi != 0xF:
                digits.append(hi)
        c.digits = "".join(str(d) for d in digits)
        return c


@dataclasses.dataclass
class Cause:
    """GSM 04.08 10.5.4.11 (2-octet minimal form)."""

    value: int = 16  # normal call clearing
    location: int = 0

    def write_lv(self, w: BitWriter) -> None:
        w.octet(2)
        w.field(1, 1).field(0, 2).field(0, 1).field(self.location, 4)
        w.field(1, 1).field(self.value, 7)

    @classmethod
    def parse_lv(cls, r: BitReader) -> "Cause":
        length = r.octet()
        c = cls()
        r.field(4)
        c.location = r.field(4)
        r.field(1)
        c.value = r.field(7)
        for _ in range(length - 2):
            r.octet()
        return c


@dataclasses.dataclass
class ProgressIndicator:
    """GSM 04.08 10.5.4.21 (L3ProgressIndicator,
    GSML3CCElements.h:245; writeV at GSML3CCElements.cpp). Defaults
    are the reference's: unspecified progress, private serving
    network local."""

    progress: int = 0  # Unspecified
    location: int = 1  # PrivateServingLocal

    def write_lv(self, w: BitWriter) -> None:
        w.octet(2)
        # octet 3: ext|coding-standard|spare = 0x0e nibble + location
        w.field(0x0E, 4).field(self.location, 4)
        # octet 4: ext + progress description
        w.field(1, 1).field(self.progress, 7)

    @classmethod
    def parse_lv(cls, r: BitReader) -> "ProgressIndicator":
        length = r.octet()
        p = cls()
        r.field(4)
        p.location = r.field(4)
        r.field(1)
        p.progress = r.field(7)
        for _ in range(length - 2):
            r.octet()
        return p


class CCMessage(L3Message):
    """CC base with transaction identifier in the skip nibble."""

    PD = L3PD.CallControl

    def __init__(self):
        self.ti = 0  # TI flag(1) | TI value(3)

    def encode(self) -> np.ndarray:
        w = BitWriter()
        w.field(self.ti, 4)
        w.field(int(self.PD), 4)
        w.field(self.MTI, 8)
        self.write_body(w)
        while len(w) % 8:
            w.field(0, 1)
        return w.array()


@register
class Setup(CCMessage):
    """GSM 04.08 9.3.23."""

    MTI = 0x05

    def __init__(self, called: CalledPartyBCDNumber | None = None):
        super().__init__()
        self.called = called

    def write_body(self, w: BitWriter) -> None:
        if self.called is not None:
            self.called.write_tlv(w)

    def parse_body(self, r: BitReader) -> None:
        self.called = None
        while r.remaining() >= 16:
            iei = r.octet()
            if iei == 0x5E:
                self.called = CalledPartyBCDNumber.parse_lv(r)
            elif iei == 0x04:  # bearer capability: skip TLV
                ln = r.octet()
                r.skip(8 * ln)
            else:
                ln = r.octet()
                r.skip(8 * min(ln, r.remaining() // 8))


@register
class EmergencySetup(CCMessage):
    """GSM 04.08 9.3.8 Emergency Setup (uplink): no mandatory IEs —
    the network supplies the destination (L3EmergencySetup,
    GSML3CCMessages.h:298; EmergencyCall controller pulls only the TI
    and dials PBX.Emergency, CallControl.cpp:1020-1045)."""

    MTI = 0x0E

    def write_body(self, w: BitWriter) -> None:
        pass

    def parse_body(self, r: BitReader) -> None:
        r.skip(r.remaining())  # optional bearer caps ignored


@register
class CallConfirmed(CCMessage):
    """GSM 04.08 9.3.2 Call Confirmed (uplink): the MS acknowledges an
    MT Setup (L3CallConfirmed, GSML3CCMessages.h:464; MTCStarter waits
    on it before the mode-set, CallControl.cpp:859-896). Optional
    bearer-capability IEs are skipped."""

    MTI = 0x08

    def write_body(self, w: BitWriter) -> None:
        pass

    def parse_body(self, r: BitReader) -> None:
        r.skip(r.remaining())


@register
class CallProceeding(CCMessage):
    MTI = 0x02

    def write_body(self, w: BitWriter) -> None:
        pass

    def parse_body(self, r: BitReader) -> None:
        pass


@register
class Alerting(CCMessage):
    MTI = 0x01

    def write_body(self, w: BitWriter) -> None:
        pass

    def parse_body(self, r: BitReader) -> None:
        pass


@register
class Progress(CCMessage):
    """GSM 04.08 9.3.17 Progress (downlink): mandatory progress
    indicator LV (L3Progress, GSML3CCMessages.h:597; the MOC
    controller sends it on SIP Proceeding, CallControl.cpp:739)."""

    MTI = 0x03

    def __init__(self, progress: ProgressIndicator | None = None):
        super().__init__()
        self.progress = progress or ProgressIndicator()

    def write_body(self, w: BitWriter) -> None:
        self.progress.write_lv(w)

    def parse_body(self, r: BitReader) -> None:
        self.progress = ProgressIndicator.parse_lv(r)


@register
class Hold(CCMessage):
    """GSM 04.08 9.3.10 Hold (uplink): empty body (L3Hold,
    GSML3CCMessages.h:621)."""

    MTI = 0x18

    def write_body(self, w: BitWriter) -> None:
        pass

    def parse_body(self, r: BitReader) -> None:
        pass


@register
class HoldReject(CCMessage):
    """GSM 04.08 9.3.12 Hold Reject (downlink): cause LV, default
    0x3f "service or option not available" (L3HoldReject,
    GSML3CCMessages.h:639; the reference rejects all in-call holds,
    CallControl.cpp:356-360). 0x1A: GSM 04.08 Table 10.3; 0x19 is Hold
    Acknowledge (GSML3CCMessages.h)."""

    MTI = 0x1A

    def __init__(self, cause: Cause | None = None):
        super().__init__()
        self.cause = cause or Cause(0x3F)

    def write_body(self, w: BitWriter) -> None:
        self.cause.write_lv(w)

    def parse_body(self, r: BitReader) -> None:
        self.cause = Cause.parse_lv(r)


@register
class CCStatus(CCMessage):
    """GSM 04.08 9.3.27 Status: cause LV + call state V (L3CCStatus,
    GSML3CCMessages.h:164, bodyLength 4). The MS reports CC protocol
    errors with it; the network logs and carries on."""

    MTI = 0x3D

    def __init__(self, cause: Cause | None = None, call_state: int = 0):
        super().__init__()
        self.cause = cause or Cause()
        self.call_state = call_state  # GSM 04.08 10.5.4.6 (low 6 bits)

    def write_body(self, w: BitWriter) -> None:
        self.cause.write_lv(w)
        w.field(0, 2).field(self.call_state, 6)

    def parse_body(self, r: BitReader) -> None:
        self.cause = Cause.parse_lv(r)
        if r.remaining() >= 8:
            r.field(2)
            self.call_state = r.field(6)


@register
class Connect(CCMessage):
    MTI = 0x07

    def write_body(self, w: BitWriter) -> None:
        pass

    def parse_body(self, r: BitReader) -> None:
        pass


@register
class ConnectAcknowledge(CCMessage):
    MTI = 0x0F

    def write_body(self, w: BitWriter) -> None:
        pass

    def parse_body(self, r: BitReader) -> None:
        pass


@register
class Disconnect(CCMessage):
    """GSM 04.08 9.3.7: mandatory cause LV."""

    MTI = 0x25

    def __init__(self, cause: Cause | None = None):
        super().__init__()
        self.cause = cause or Cause()

    def write_body(self, w: BitWriter) -> None:
        self.cause.write_lv(w)

    def parse_body(self, r: BitReader) -> None:
        self.cause = Cause.parse_lv(r)


@register
class Release(CCMessage):
    MTI = 0x2D

    def __init__(self, cause: Cause | None = None):
        super().__init__()
        self.cause = cause

    def write_body(self, w: BitWriter) -> None:
        if self.cause is not None:
            w.octet(0x08)
            self.cause.write_lv(w)

    def parse_body(self, r: BitReader) -> None:
        self.cause = None
        if r.remaining() >= 16 and r.octet() == 0x08:
            self.cause = Cause.parse_lv(r)


@register
class ReleaseComplete(CCMessage):
    MTI = 0x2A

    def __init__(self, cause: Cause | None = None):
        super().__init__()
        self.cause = cause

    def write_body(self, w: BitWriter) -> None:
        if self.cause is not None:
            w.octet(0x08)
            self.cause.write_lv(w)

    def parse_body(self, r: BitReader) -> None:
        self.cause = None
        if r.remaining() >= 16 and r.octet() == 0x08:
            self.cause = Cause.parse_lv(r)


@register
class StartDTMF(CCMessage):
    """GSM 04.08 9.3.24 (uplink): key value in IA5 (TLV 0x2C)."""

    MTI = 0x35

    def __init__(self, key: str = "0"):
        super().__init__()
        self.key = key

    def write_body(self, w: BitWriter) -> None:
        w.octet(0x2C)
        w.octet(ord(self.key))

    def parse_body(self, r: BitReader) -> None:
        if r.remaining() >= 16 and r.octet() == 0x2C:
            self.key = chr(r.octet())


@register
class StopDTMF(CCMessage):
    MTI = 0x31

    def write_body(self, w: BitWriter) -> None:
        pass

    def parse_body(self, r: BitReader) -> None:
        pass


@register
class StartDTMFAck(CCMessage):
    """GSM 04.08 9.3.25. 0x36: GSM 04.08 Table 10.3 (GSML3CCMessages.h);
    0x32 is Stop DTMF Acknowledge."""

    MTI = 0x36

    def __init__(self, key: str = "0"):
        super().__init__()
        self.key = key

    def write_body(self, w: BitWriter) -> None:
        w.octet(0x2C)
        w.octet(ord(self.key))

    def parse_body(self, r: BitReader) -> None:
        if r.remaining() >= 16 and r.octet() == 0x2C:
            self.key = chr(r.octet())


@register
class StartDTMFReject(CCMessage):
    """GSM 04.08 9.3.26 Start DTMF Reject (downlink): cause LV, default
    0x3f "service or option not available" (L3StartDTMFReject; the
    reference sends it when the SIP INFO relay fails,
    CallControl.cpp:332). 0x37: GSM 04.08 Table 10.3
    (GSML3CCMessages.h)."""

    MTI = 0x37

    def __init__(self, cause: Cause | None = None):
        super().__init__()
        self.cause = cause or Cause(0x3F)

    def write_body(self, w: BitWriter) -> None:
        self.cause.write_lv(w)

    def parse_body(self, r: BitReader) -> None:
        self.cause = Cause.parse_lv(r)


@register
class StopDTMFAck(CCMessage):
    """GSM 04.08 9.3.29. 0x32: GSM 04.08 Table 10.3 (GSML3CCMessages.h)."""

    MTI = 0x32

    def write_body(self, w: BitWriter) -> None:
        pass

    def parse_body(self, r: BitReader) -> None:
        pass
