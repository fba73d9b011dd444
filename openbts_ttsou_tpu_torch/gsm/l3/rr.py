"""Radio Resource messages (GSM 04.08 9.1; PD=6).

Reference behavior: `GSM/GSML3RRMessages.{h,cpp}` and
`GSML3RRElements.{h,cpp}` — the beacon SI messages, immediate
assignment, paging, channel release and assignment procedures used by
Control/ (RadioResource.cpp).
"""

from __future__ import annotations

import dataclasses

from openbts_ttsou_tpu_torch.gsm.l3.codec import (
    BitReader,
    BitWriter,
    L3Message,
    L3PD,
    register,
)
from openbts_ttsou_tpu_torch.gsm.l3.common import LAI, MobileIdentity


@dataclasses.dataclass
class ChannelDescription:
    """Channel Description, GSM 04.08 10.5.2.5 (3 octets)."""

    type_and_offset: int = 1  # TCH/F=1, SDCCH/4 base=4, SDCCH/8 base=8
    tn: int = 0
    tsc: int = 0
    arfcn: int = 0  # single-carrier (H=0)

    def write_v(self, w: BitWriter) -> None:
        w.field(self.type_and_offset, 5).field(self.tn, 3)
        w.field(self.tsc, 3).field(0, 1)  # H=0
        w.field(0, 2).field(self.arfcn >> 8, 2)
        w.field(self.arfcn & 0xFF, 8)

    @classmethod
    def parse_v(cls, r: BitReader) -> "ChannelDescription":
        c = cls()
        c.type_and_offset = r.field(5)
        c.tn = r.field(3)
        c.tsc = r.field(3)
        r.field(1)
        r.field(2)
        hi = r.field(2)
        c.arfcn = (hi << 8) | r.field(8)
        return c


@dataclasses.dataclass
class RequestReference:
    """Request Reference, GSM 04.08 10.5.2.30 (3 octets)."""

    ra: int = 0
    t1p: int = 0  # (FN/1326) mod 32
    t2: int = 0  # FN mod 26
    t3: int = 0  # FN mod 51

    @classmethod
    def from_fn(cls, ra: int, fn: int) -> "RequestReference":
        return cls(ra, (fn // 1326) % 32, fn % 26, fn % 51)

    def write_v(self, w: BitWriter) -> None:
        w.octet(self.ra)
        w.field(self.t1p, 5).field(self.t3 >> 3, 3)
        w.field(self.t3 & 7, 3).field(self.t2, 5)

    @classmethod
    def parse_v(cls, r: BitReader) -> "RequestReference":
        c = cls()
        c.ra = r.octet()
        c.t1p = r.field(5)
        hi = r.field(3)
        c.t3 = (hi << 3) | r.field(3)
        c.t2 = r.field(5)
        return c


@dataclasses.dataclass
class RACHControlParameters:
    """GSM 04.08 10.5.2.29 (3 octets)."""

    max_retrans: int = 1
    tx_integer: int = 14
    cell_barred: int = 0
    re: int = 1  # call reestablishment NOT allowed
    ac: int = 0x0400  # access classes barred mask (emergency barred)

    def write_v(self, w: BitWriter) -> None:
        w.field(self.max_retrans, 2).field(self.tx_integer, 4)
        w.field(self.cell_barred, 1).field(self.re, 1)
        w.field(self.ac, 16)

    @classmethod
    def parse_v(cls, r: BitReader) -> "RACHControlParameters":
        c = cls()
        c.max_retrans = r.field(2)
        c.tx_integer = r.field(4)
        c.cell_barred = r.field(1)
        c.re = r.field(1)
        c.ac = r.field(16)
        return c


@register
class ImmediateAssignment(L3Message):
    """GSM 04.08 9.1.18 (L3ImmediateAssignment,
    GSML3RRMessages.cpp)."""

    PD = L3PD.RadioResource
    MTI = 0x3F

    def __init__(self, channel: ChannelDescription | None = None,
                 reference: RequestReference | None = None,
                 timing_advance: int = 0):
        self.channel = channel or ChannelDescription()
        self.reference = reference or RequestReference()
        self.timing_advance = timing_advance

    def write_body(self, w: BitWriter) -> None:
        w.field(0, 4).field(0, 4)  # dedicated mode/TBF + page mode
        self.channel.write_v(w)
        self.reference.write_v(w)
        w.octet(self.timing_advance & 0x3F)
        w.octet(0)  # zero-length mobile allocation LV

    def parse_body(self, r: BitReader) -> None:
        r.field(8)
        self.channel = ChannelDescription.parse_v(r)
        self.reference = RequestReference.parse_v(r)
        self.timing_advance = r.octet()
        alloc_len = r.octet()
        r.skip(8 * alloc_len)


@register
class ImmediateAssignmentReject(L3Message):
    """GSM 04.08 9.1.20: up to 4 request references + T3122 wait."""

    PD = L3PD.RadioResource
    MTI = 0x3A

    def __init__(self, reference: RequestReference | None = None,
                 t3122: int = 0):
        self.reference = reference or RequestReference()
        self.t3122 = t3122

    def write_body(self, w: BitWriter) -> None:
        w.field(0, 4).field(0, 4)
        for _ in range(4):  # spec requires 4 refs; repeat ours
            self.reference.write_v(w)
            w.octet(self.t3122)

    def parse_body(self, r: BitReader) -> None:
        r.field(8)
        self.reference = RequestReference.parse_v(r)
        self.t3122 = r.octet()
        for _ in range(3):
            RequestReference.parse_v(r)
            r.octet()


@register
class ApplicationInformation(L3Message):
    """GSM 04.08 9.1.53 Application Information — carries an RRLP APDU
    (the reference's sendrrlp path, CLI.cpp + RRLP inject)."""

    PD = L3PD.RadioResource
    MTI = 0x38

    def __init__(self, apdu: bytes = b"", protocol_id: int = 0):
        self.apdu = apdu
        self.protocol_id = protocol_id  # 0 = RRLP

    def write_body(self, w: BitWriter) -> None:
        w.field(0, 4).field(self.protocol_id, 4)  # APDU flags + ID
        w.octet(len(self.apdu))
        for b in self.apdu:
            w.octet(b)

    def parse_body(self, r: BitReader) -> None:
        r.field(4)
        self.protocol_id = r.field(4)
        n = r.octet()
        self.apdu = bytes(r.octet() for _ in range(n))


@register
class ChannelRelease(L3Message):
    """GSM 04.08 9.1.7."""

    PD = L3PD.RadioResource
    MTI = 0x0D

    def __init__(self, cause: int = 0):
        self.cause = cause

    def write_body(self, w: BitWriter) -> None:
        w.octet(self.cause)

    def parse_body(self, r: BitReader) -> None:
        self.cause = r.octet()


@register
class PagingRequestType1(L3Message):
    """GSM 04.08 9.1.22 (L3PagingRequestType1)."""

    PD = L3PD.RadioResource
    MTI = 0x21

    def __init__(self, id1: MobileIdentity | None = None,
                 id2: MobileIdentity | None = None):
        self.id1 = id1 or MobileIdentity()
        self.id2 = id2

    def write_body(self, w: BitWriter) -> None:
        w.field(0, 4).field(0, 4)  # channels needed + page mode
        self.id1.write_lv(w)
        if self.id2 is not None:
            w.octet(0x17)  # IEI for second identity
            self.id2.write_lv(w)

    def parse_body(self, r: BitReader) -> None:
        r.field(8)
        self.id1 = MobileIdentity.parse_lv(r)
        self.id2 = None
        if r.remaining() >= 8 and r.field(8) == 0x17:
            self.id2 = MobileIdentity.parse_lv(r)


@register
class PagingResponse(L3Message):
    """GSM 04.08 9.1.25 (uplink)."""

    PD = L3PD.RadioResource
    MTI = 0x27

    def __init__(self, identity: MobileIdentity | None = None):
        self.identity = identity or MobileIdentity()

    def write_body(self, w: BitWriter) -> None:
        w.field(0, 4).field(0, 4)  # ciphering key seq + spare
        w.octet(4)  # classmark 2 LV (stub 4-octet)
        w.field(0, 32)
        self.identity.write_lv(w)

    def parse_body(self, r: BitReader) -> None:
        r.field(8)
        cm_len = r.octet()
        r.skip(8 * cm_len)
        self.identity = MobileIdentity.parse_lv(r)


@register
class AssignmentCommand(L3Message):
    """GSM 04.08 9.1.2."""

    PD = L3PD.RadioResource
    MTI = 0x2E

    def __init__(self, channel: ChannelDescription | None = None,
                 power_command: int = 0):
        self.channel = channel or ChannelDescription()
        self.power_command = power_command

    def write_body(self, w: BitWriter) -> None:
        self.channel.write_v(w)
        w.octet(self.power_command)

    def parse_body(self, r: BitReader) -> None:
        self.channel = ChannelDescription.parse_v(r)
        self.power_command = r.octet()


@register
class AssignmentComplete(L3Message):
    """GSM 04.08 9.1.3 (uplink)."""

    PD = L3PD.RadioResource
    MTI = 0x29

    def __init__(self, cause: int = 0):
        self.cause = cause

    def write_body(self, w: BitWriter) -> None:
        w.octet(self.cause)

    def parse_body(self, r: BitReader) -> None:
        self.cause = r.octet()


@register
class AssignmentFailure(L3Message):
    """GSM 04.08 9.1.3 Assignment Failure (uplink): the MS could not
    move to the assigned channel and returned to the old one
    (L3AssignmentFailure, GSML3RRMessages.h:654, parse
    GSML3RRMessages.cpp:488)."""

    PD = L3PD.RadioResource
    MTI = 0x2F

    def __init__(self, cause: int = 0):
        self.cause = cause

    def write_body(self, w: BitWriter) -> None:
        w.octet(self.cause)

    def parse_body(self, r: BitReader) -> None:
        self.cause = r.octet()


@register
class RRStatus(L3Message):
    """GSM 04.08 9.1.29 RR Status (uplink): the MS reports an RR
    protocol error with an RR cause (L3RRStatus,
    GSML3RRMessages.h:678, parse GSML3RRMessages.cpp:501)."""

    PD = L3PD.RadioResource
    MTI = 0x12

    def __init__(self, cause: int = 0):
        self.cause = cause

    def write_body(self, w: BitWriter) -> None:
        w.octet(self.cause)

    def parse_body(self, r: BitReader) -> None:
        self.cause = r.octet()


class ChannelMode:
    """Channel Mode IE values, GSM 04.08 10.5.2.6 (L3ChannelMode,
    GSML3RRElements.h:561: one octet, writeV/parseV
    GSML3RRElements.cpp:431-439)."""

    SignallingOnly = 0
    SpeechV1 = 1
    SpeechV2 = 2
    SpeechV3 = 3


@register
class ChannelModeModify(L3Message):
    """GSM 04.08 9.1.5 Channel Mode Modify (downlink): switch a
    dedicated channel (the very-early-assignment TCH) from
    signalling-only to speech mode (L3ChannelModeModify,
    GSML3RRMessages.h:703, writeBody GSML3RRMessages.cpp:544)."""

    PD = L3PD.RadioResource
    MTI = 0x10

    def __init__(self, channel: ChannelDescription | None = None,
                 mode: int = ChannelMode.SpeechV1):
        self.channel = channel or ChannelDescription()
        self.mode = mode

    def write_body(self, w: BitWriter) -> None:
        self.channel.write_v(w)
        w.octet(self.mode)

    def parse_body(self, r: BitReader) -> None:
        self.channel = ChannelDescription.parse_v(r)
        self.mode = r.octet()


@register
class ChannelModeModifyAcknowledge(L3Message):
    """GSM 04.08 9.1.6 (uplink): the MS confirms (or refuses, by
    echoing a different mode) the mode change
    (L3ChannelModeModifyAcknowledge, GSML3RRMessages.h:731, parseBody
    GSML3RRMessages.cpp:559)."""

    PD = L3PD.RadioResource
    MTI = 0x17

    def __init__(self, channel: ChannelDescription | None = None,
                 mode: int = ChannelMode.SpeechV1):
        self.channel = channel or ChannelDescription()
        self.mode = mode

    def write_body(self, w: BitWriter) -> None:
        self.channel.write_v(w)
        w.octet(self.mode)

    def parse_body(self, r: BitReader) -> None:
        self.channel = ChannelDescription.parse_v(r)
        self.mode = r.octet()


@dataclasses.dataclass
class CellChannelDescription:
    """Cell Channel Description, GSM 04.08 10.5.2.1b (16 octets,
    bit-map-0 variant): a bit per ARFCN 1..124."""

    arfcns: tuple = (0,)

    def write_v(self, w: BitWriter) -> None:
        w.field(0, 4)  # format "bit map 0" + spare
        for n in range(124, 0, -1):
            w.field(1 if n in self.arfcns else 0, 1)

    @classmethod
    def parse_v(cls, r: BitReader) -> "CellChannelDescription":
        r.field(4)
        arfcns = []
        for n in range(124, 0, -1):
            if r.field(1):
                arfcns.append(n)
        return cls(tuple(sorted(arfcns)))


@register
class SystemInformationType1(L3Message):
    """GSM 04.08 9.1.31: cell channel description + RACH control."""

    PD = L3PD.RadioResource
    MTI = 0x19

    def __init__(self, cell_channels: CellChannelDescription | None = None,
                 rach: RACHControlParameters | None = None):
        self.cell_channels = cell_channels or CellChannelDescription()
        self.rach = rach or RACHControlParameters()

    def write_body(self, w: BitWriter) -> None:
        self.cell_channels.write_v(w)
        self.rach.write_v(w)

    def parse_body(self, r: BitReader) -> None:
        self.cell_channels = CellChannelDescription.parse_v(r)
        self.rach = RACHControlParameters.parse_v(r)


@register
class SystemInformationType2(L3Message):
    """GSM 04.08 9.1.32: BCCH (neighbor) frequency list + NCC permitted
    + RACH control."""

    PD = L3PD.RadioResource
    MTI = 0x1A

    def __init__(self, neighbors: CellChannelDescription | None = None,
                 ncc_permitted: int = 0xFF,
                 rach: RACHControlParameters | None = None):
        self.neighbors = neighbors or CellChannelDescription(())
        self.ncc_permitted = ncc_permitted
        self.rach = rach or RACHControlParameters()

    def write_body(self, w: BitWriter) -> None:
        self.neighbors.write_v(w)
        w.octet(self.ncc_permitted)
        self.rach.write_v(w)

    def parse_body(self, r: BitReader) -> None:
        self.neighbors = CellChannelDescription.parse_v(r)
        self.ncc_permitted = r.octet()
        self.rach = RACHControlParameters.parse_v(r)


@register
class SystemInformationType4(L3Message):
    """GSM 04.08 9.1.36: LAI + cell selection + RACH control."""

    PD = L3PD.RadioResource
    MTI = 0x1C

    def __init__(self, lai: LAI | None = None,
                 ms_txpwr_max_cch: int = 0, rxlev_access_min: int = 0,
                 rach: RACHControlParameters | None = None):
        self.lai = lai or LAI()
        self.ms_txpwr_max_cch = ms_txpwr_max_cch
        self.rxlev_access_min = rxlev_access_min
        self.rach = rach or RACHControlParameters()

    def write_body(self, w: BitWriter) -> None:
        self.lai.write_v(w)
        w.field(0, 3).field(self.ms_txpwr_max_cch, 5)
        w.field(0, 2).field(self.rxlev_access_min, 6)
        self.rach.write_v(w)

    def parse_body(self, r: BitReader) -> None:
        self.lai = LAI.parse_v(r)
        r.field(3)
        self.ms_txpwr_max_cch = r.field(5)
        r.field(2)
        self.rxlev_access_min = r.field(6)
        self.rach = RACHControlParameters.parse_v(r)


@register
class MeasurementReport(L3Message):
    """GSM 04.08 9.1.21 (uplink on SACCH): serving-cell RXLEV/RXQUAL +
    neighbor count (measurement results, 10.5.2.20)."""

    PD = L3PD.RadioResource
    MTI = 0x15

    def __init__(self, rxlev_full: int = 0, rxlev_sub: int = 0,
                 rxqual_full: int = 0, rxqual_sub: int = 0,
                 dtx_used: int = 0, meas_valid: int = 0):
        self.rxlev_full = rxlev_full
        self.rxlev_sub = rxlev_sub
        self.rxqual_full = rxqual_full
        self.rxqual_sub = rxqual_sub
        self.dtx_used = dtx_used
        self.meas_valid = meas_valid  # 0 = valid (!)

    def write_body(self, w: BitWriter) -> None:
        w.field(0, 1).field(self.dtx_used, 1).field(self.rxlev_full, 6)
        w.field(0, 1).field(self.meas_valid, 1).field(self.rxlev_sub, 6)
        w.field(0, 1).field(self.rxqual_full, 3)
        w.field(self.rxqual_sub, 3).field(1, 1)  # NO-NCELL-M hi: 0 cells
        w.field(3, 2).field(0, 6)  # NO-NCELL lo "111" = no neighbors
        for _ in range(12):
            w.octet(0)

    def parse_body(self, r: BitReader) -> None:
        r.field(1)
        self.dtx_used = r.field(1)
        self.rxlev_full = r.field(6)
        r.field(1)
        self.meas_valid = r.field(1)
        self.rxlev_sub = r.field(6)
        r.field(1)
        self.rxqual_full = r.field(3)
        self.rxqual_sub = r.field(3)
        # remaining neighbor fields ignored in this subset


@register
class SystemInformationType5(L3Message):
    """GSM 04.08 9.1.37: BCCH frequency list on the SACCH
    (L3SystemInformationType5, GSML3RRMessages.h:395)."""

    PD = L3PD.RadioResource
    MTI = 0x1D

    def __init__(self, neighbors: CellChannelDescription | None = None):
        self.neighbors = neighbors or CellChannelDescription(())

    def write_body(self, w: BitWriter) -> None:
        self.neighbors.write_v(w)

    def parse_body(self, r: BitReader) -> None:
        self.neighbors = CellChannelDescription.parse_v(r)


@register
class SystemInformationType6(L3Message):
    """GSM 04.08 9.1.40: CI + LAI + SACCH cell options + NCC permitted
    (L3SystemInformationType6, GSML3RRMessages.h:427)."""

    PD = L3PD.RadioResource
    MTI = 0x1E

    def __init__(self, cell_id: int = 0, lai: LAI | None = None,
                 ncc_permitted: int = 0xFF):
        self.cell_id = cell_id
        self.lai = lai or LAI()
        self.ncc_permitted = ncc_permitted

    def write_body(self, w: BitWriter) -> None:
        w.field(self.cell_id, 16)
        self.lai.write_v(w)
        w.octet(0)  # cell options (SACCH), 10.5.2.3
        w.octet(self.ncc_permitted)

    def parse_body(self, r: BitReader) -> None:
        self.cell_id = r.field(16)
        self.lai = LAI.parse_v(r)
        r.octet()
        self.ncc_permitted = r.octet()


@register
class SystemInformationType3(L3Message):
    """GSM 04.08 9.1.35 — the SI3 subset the reference broadcasts
    (cell identity, LAI, control channel description, cell options,
    cell selection parameters, RACH control)."""

    PD = L3PD.RadioResource
    MTI = 0x1B

    def __init__(self, cell_id: int = 0, lai: LAI | None = None,
                 rach: RACHControlParameters | None = None,
                 ccch_conf: int = 1, att: int = 0, t3212: int = 0,
                 ms_txpwr_max_cch: int = 0, rxlev_access_min: int = 0):
        self.cell_id = cell_id
        self.lai = lai or LAI()
        self.rach = rach or RACHControlParameters()
        self.ccch_conf = ccch_conf
        self.att = att
        self.t3212 = t3212
        self.ms_txpwr_max_cch = ms_txpwr_max_cch
        self.rxlev_access_min = rxlev_access_min

    def write_body(self, w: BitWriter) -> None:
        w.field(self.cell_id, 16)
        self.lai.write_v(w)
        # control channel description (10.5.2.11), 3 octets
        w.field(0, 1).field(self.att, 1).field(0, 3)
        w.field(self.ccch_conf, 3)
        w.field(0, 3).field(0, 2).field(0, 3)  # spare+BS_PA_MFRMS etc
        w.octet(self.t3212)
        # cell options (10.5.2.3), 1 octet
        w.octet(0)
        # cell selection parameters (10.5.2.4), 2 octets
        w.field(0, 3).field(self.ms_txpwr_max_cch, 5)
        w.field(0, 1).field(0, 1).field(self.rxlev_access_min, 6)
        self.rach.write_v(w)

    def parse_body(self, r: BitReader) -> None:
        self.cell_id = r.field(16)
        self.lai = LAI.parse_v(r)
        r.field(1)
        self.att = r.field(1)
        r.field(3)
        self.ccch_conf = r.field(3)
        r.field(8)
        self.t3212 = r.octet()
        r.octet()
        r.field(3)
        self.ms_txpwr_max_cch = r.field(5)
        r.field(2)
        self.rxlev_access_min = r.field(6)
        self.rach = RACHControlParameters.parse_v(r)
