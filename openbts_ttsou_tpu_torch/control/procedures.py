"""GSM 04.08 control procedures: access grant, MM, CC, SMS.

Reference behavior: `Control/` — `AccessGrantResponder`
(RadioResource.cpp:118: RACH → immediate assignment with T3122 load
shedding), `PagingResponseHandler` (:221), `DCCHDispatcher`
(DCCHDispatch.cpp:103: first L3 message routes the channel),
`LocationUpdatingController` (MobilityManagement.cpp:131),
`CMServiceResponder` (:52), `IMSIDetachController` (:81), the MOC/MTC
call FSMs (CallControl.cpp:565-1185), and `MOSMSController`/
`deliverSMSToMS` (SMSControl.cpp:301,425).

The reference blocks per-channel threads on `getMessage()`; here each
procedure is an event-driven handler invoked by the BTS loop with
decoded L3 messages, advancing per-transaction state. SIP activity runs
through `sip.SIPEngine` objects attached to transactions.
"""

from __future__ import annotations

import dataclasses
import time as systime
from typing import Callable, Dict, List, Optional

import numpy as np

from openbts_ttsou_tpu_torch.control.common import (
    Q931CallState,
    ServiceType,
    TMSITable,
    TransactionEntry,
    TransactionTable,
)
from openbts_ttsou_tpu_torch.control.hlr import HLR, LocalHLR
from openbts_ttsou_tpu_torch.gsm.btsconfig import BTSConfig
from openbts_ttsou_tpu_torch.gsm.l3 import cc, common, mm, parse_l3, rr
from openbts_ttsou_tpu_torch.gsm.l3.common import MID_IMSI, MID_TMSI, MobileIdentity
from openbts_ttsou_tpu_torch.gsm.transfer import L3Frame, Primitive
from openbts_ttsou_tpu_torch.sip.engine import SIPEngine, SIPState
from openbts_ttsou_tpu_torch.sms import messages as sms
from openbts_ttsou_tpu_torch.utils.gsm_time import Time
from openbts_ttsou_tpu_torch.utils.logger import get_logger

log = get_logger("control")


@dataclasses.dataclass
class DtmfRelay:
    """A Start DTMF whose SIP INFO awaits its answer (dtmf_tick)."""

    t: TransactionEntry
    channel: object
    cseq: int
    key: str
    deadline: float  # time.monotonic()


class ControlLayer:
    """The Control/ subsystem: shared state + procedure handlers."""

    def __init__(self, bts: BTSConfig, hlr: Optional[HLR] = None,
                 sip_send: Optional[Callable[[bytes], None]] = None,
                 sip_host: str = "127.0.0.1", sip_port: int = 5060,
                 local_host: str = "127.0.0.1", local_port: int = 5062,
                 sip_fifos=None):
        self.bts = bts
        self.hlr = hlr or LocalHLR()
        self.transactions = TransactionTable()
        self.tmsis = TMSITable()
        self.sip_send = sip_send or (lambda data: None)
        # the per-call inbound SIP FIFOs (a SIPInterface: add_call, take,
        # fifo_size, remove_call) where the DTMF relay finds its INFO's
        # answer; None: nothing can answer, so every relay fails
        self.sip_fifos = sip_fifos
        self.sip_host = sip_host
        self.sip_port = sip_port
        self.local_host = local_host
        self.local_port = local_port
        # per dedicated channel: the current owning transaction
        self.channel_transactions: Dict[int, int] = {}
        # channels released by a procedure but still draining queued
        # downlink LAPDm frames (see _release_channel)
        self.pending_release: Dict[int, object] = {}
        # Start DTMFs waiting for their INFO's answer, oldest first
        self.pending_dtmf: List[DtmfRelay] = []
        # call IDs whose SIP FIFO a relay opened (closed when idle)
        self._relay_fifos: set = set()

    def _new_engine(self, username: str) -> SIPEngine:
        return SIPEngine(username, self.local_host, self.local_port,
                         self.sip_host, self.sip_port, self.sip_send)

    # ------------------------------------------------------------------
    # Random access (AccessGrantResponder, RadioResource.cpp:118)
    # ------------------------------------------------------------------
    def handle_rach(self, ra: int, when: Time, rssi: float,
                    timing_error: float):
        """RACH → channel allocation → immediate assignment on AGCH.
        Returns the allocated channel or None."""
        # very-early assignment (CLI `assignment veryearly`,
        # RadioResource.cpp AccessGrantResponder's channel-type choice):
        # the MS goes straight to a TCH/F and signals on its FACCH;
        # early assignment (default) gets an SDCCH and moves to a TCH
        # at call setup (assignTCHF). Load shedding: no channel →
        # ImmediateAssignmentReject with T3122.
        very_early = self.bts.config.get_str(
            "GSM.AssignmentType", "early") == "veryearly"
        channel = (self.bts.get_tch() if very_early else None) \
            or self.bts.get_sdcch()
        if channel is None:
            self.bts.grow_t3122()
            msg = rr.ImmediateAssignmentReject(
                rr.RequestReference.from_fn(ra, when.FN()),
                t3122=self.bts.t3122())
            self.bts.send_agch(L3Frame(msg.encode(), Primitive.UNIT_DATA))
            log.warning("congestion: rejecting RA=%d T3122=%d", ra,
                        self.bts.t3122())
            return None
        self.bts.shrink_t3122()
        sub = getattr(channel.l1, "subchannel", 0)
        # GSM 04.08 10.5.2.5 channel type: TCH/F = 1; SDCCH/4 on the
        # C-V beacon slot (TN0) = 4+sub; SDCCH/8 on a C-VII slot = 8+sub
        if getattr(channel, "is_tch", False):
            cbits = 1
        else:
            cbits = (4 + sub) if channel.l1.tn == 0 else (8 + sub)
        desc = rr.ChannelDescription(
            type_and_offset=cbits,
            tn=channel.l1.tn, tsc=self.bts.bcc, arfcn=self.bts.arfcn)
        ta = max(0, min(63, int(round(timing_error))))
        msg = rr.ImmediateAssignment(
            desc, rr.RequestReference.from_fn(ra, when.FN()),
            timing_advance=ta)
        self.bts.send_agch(L3Frame(msg.encode(), Primitive.UNIT_DATA))
        channel.open(when.FN())
        return channel

    # ------------------------------------------------------------------
    # DCCH dispatch (DCCHDispatch.cpp:103)
    # ------------------------------------------------------------------
    def dispatch_l3(self, channel, l3_bits: np.ndarray) -> None:
        """Route a decoded uplink L3 message to its procedure."""
        msg = parse_l3(l3_bits)
        if msg is None:
            log.info("undecodable L3 on channel %s", id(channel))
            return
        handler = {
            mm.LocationUpdatingRequest: self.location_updating,
            mm.CMServiceRequest: self.cm_service,
            mm.IMSIDetachIndication: self.imsi_detach,
            mm.IdentityResponse: self.identity_response,
            rr.PagingResponse: self.paging_response,
            rr.AssignmentComplete: self.assignment_complete,
            rr.AssignmentFailure: self.assignment_failure,
            rr.ChannelModeModifyAcknowledge: self.mode_modify_ack,
            rr.RRStatus: self.rr_status,
            cc.Setup: self.moc_setup,
            cc.EmergencySetup: self.emergency_setup,
            cc.CallConfirmed: self.mtc_call_confirmed,
            cc.Hold: self.cc_hold,
            cc.CCStatus: self.cc_status,
            cc.Alerting: self.cc_forward,
            cc.Connect: self.mtc_connect,
            cc.ConnectAcknowledge: self.cc_forward,
            cc.StartDTMF: self.start_dtmf,
            cc.StopDTMF: self.stop_dtmf,
            cc.Disconnect: self.cc_disconnect,
            cc.Release: self.cc_release,
            cc.ReleaseComplete: self.cc_release_complete,
        }.get(type(msg))
        if handler is None:
            log.info("unhandled L3 %s", type(msg).__name__)
            return
        handler(channel, msg)

    def _transaction_for(self, channel) -> Optional[TransactionEntry]:
        tid = self.channel_transactions.get(id(channel))
        return self.transactions.find(tid) if tid else None

    def _bind(self, channel, t: TransactionEntry) -> None:
        self.channel_transactions[id(channel)] = t.id

    def _imsi_of(self, identity: MobileIdentity) -> Optional[str]:
        if identity.kind == MID_IMSI:
            return identity.digits
        if identity.kind == MID_TMSI:
            return self.tmsis.imsi(identity.tmsi)
        return None

    def _release_channel(self, channel, cause: int = 0) -> None:
        channel.send(L3Frame(rr.ChannelRelease(cause).encode(),
                             Primitive.DATA))
        self.channel_transactions.pop(id(channel), None)
        if hasattr(channel, "tx_drained") and not channel.tx_drained():
            # LAPDm's k=1 window means queued downlink (e.g.
            # MMInformation + LUAccept + this ChannelRelease) is still
            # in flight — an immediate hard reset would wipe it. The
            # reference never hits this because its sends block per
            # frame; here the hard release is deferred to release_tick
            # until the link drains, bounded by a T3111-style deadline
            # (GSM 04.08 11.1.2: the post-release channel-deactivation
            # guard) so a vanished MS cannot pin the channel.
            self.pending_release[id(channel)] = (
                channel, self.bts.clock.fn(), channel.tx_progress())
            return
        self._hard_release(channel)

    def _hard_release(self, channel) -> None:
        if hasattr(channel, "reset"):
            channel.reset()  # hard release the data links for reuse
        self.bts.release(channel)

    def release_tick(self) -> None:
        """Finish deferred releases whose LAPDm queues have drained —
        or whose T3111 drain deadline passed (called from the BTS
        service loop)."""
        from openbts_ttsou_tpu_torch.utils.gsm_time import fn_delta

        t3111_frames = int(
            self.bts.config.get_int("GSM.Timer.T3111", 2000) / 4.615)
        now_fn = self.bts.clock.fn()
        for key, (ch, fn0, acked0) in list(self.pending_release.items()):
            if ch.tx_drained() or not ch.l1.active:
                del self.pending_release[key]
                self._hard_release(ch)
                continue
            # the deadline bounds a VANISHED MS (no acks), not a live
            # one draining at SDCCH pace: an acknowledgement since the
            # last tick restarts T3111; a T200 retransmission does not,
            # so a silent MS is cut at T3111, before LAPDm's own
            # N200·T200 gives up on the link
            acked = ch.tx_progress()
            if acked != acked0:
                self.pending_release[key] = (ch, now_fn, acked)
            elif fn_delta(now_fn, fn0) > t3111_frames:
                del self.pending_release[key]
                self._hard_release(ch)

    # ------------------------------------------------------------------
    # Mobility management
    # ------------------------------------------------------------------
    def location_updating(self, channel, msg: mm.LocationUpdatingRequest):
        """LUR → SIP REGISTER → accept with TMSI, or reject
        (LocationUpdatingController, MobilityManagement.cpp:131)."""
        imsi = self._imsi_of(msg.identity)
        if imsi is None:
            # unknown TMSI: ask for the IMSI (simplified query flow)
            channel.send(L3Frame(mm.IdentityRequest(id_type=1).encode(),
                                 Primitive.DATA))
            t = self.transactions.new(ServiceType.LocationUpdate)
            self._bind(channel, t)
            return
        t = self.transactions.new(ServiceType.LocationUpdate, imsi=imsi)
        self._bind(channel, t)
        engine = self._new_engine(f"IMSI{imsi}")
        t.sip = engine
        engine.register()
        # acceptance is completed by on_sip_response (REGISTER 200)

    def identity_response(self, channel, msg: mm.IdentityResponse):
        t = self._transaction_for(channel)
        imsi = self._imsi_of(msg.identity)
        if t is None or imsi is None:
            self._release_channel(channel)
            return
        t.imsi = imsi
        engine = self._new_engine(f"IMSI{imsi}")
        t.sip = engine
        engine.register()

    def complete_location_update(self, channel, t: TransactionEntry,
                                 accepted: bool):
        if not accepted:
            channel.send(L3Frame(
                mm.LocationUpdatingReject(cause=0x04).encode(),
                Primitive.DATA))
        else:
            # deliver the network short name before the accept
            # (L3MMInformation, MobilityManagement.cpp:203; the name
            # gate is the element's lengthV>1 rule)
            shortname = self.bts.config.get_str("GSM.ShortName", "")
            if len(shortname) > 1:
                channel.send(L3Frame(
                    mm.MMInformation(shortname).encode(),
                    Primitive.DATA))
            tmsi = self.tmsis.assign(t.imsi)
            channel.send(L3Frame(mm.LocationUpdatingAccept(
                self.bts.lai(),
                MobileIdentity.from_tmsi(tmsi)).encode(), Primitive.DATA))
        self.transactions.remove(t.id)
        self._release_channel(channel)

    def imsi_detach(self, channel, msg: mm.IMSIDetachIndication):
        """IMSIDetachController (MobilityManagement.cpp:81)."""
        imsi = self._imsi_of(msg.identity)
        if imsi:
            engine = self._new_engine(f"IMSI{imsi}")
            engine.unregister()
        self._release_channel(channel)

    def cm_service(self, channel, msg: mm.CMServiceRequest):
        """CMServiceResponder (MobilityManagement.cpp:52)."""
        imsi = self._imsi_of(msg.identity)
        if imsi is None:
            channel.send(L3Frame(mm.CMServiceReject(cause=0x04).encode(),
                                 Primitive.DATA))
            self._release_channel(channel)
            return
        service = {1: ServiceType.MobileOriginatedCall,
                   4: ServiceType.MobileOriginatedSMS,
                   8: ServiceType.EmergencyCall}.get(
            msg.service_type, ServiceType.MobileOriginatedCall)
        t = self.transactions.new(service, imsi=imsi)
        self._bind(channel, t)
        channel.send(L3Frame(mm.CMServiceAccept().encode(), Primitive.DATA))

    # ------------------------------------------------------------------
    # Mobile-originated call (MOCStarter/MOCController,
    # CallControl.cpp:565-820)
    # ------------------------------------------------------------------
    def moc_setup(self, channel, msg: cc.Setup):
        t = self._transaction_for(channel)
        if t is None:
            return
        t.ti_flag, t.ti_value = 1, msg.ti & 0x7
        t.called = msg.called.digits if msg.called else ""
        if t.service == ServiceType.EmergencyCall:
            # emergency setups route to the configured dispatch number
            # whatever was dialed (EmergencyCall, CallControl.cpp)
            t.called = self.bts.config.get_str("PBX.Emergency", "911")
        t.set_state(Q931CallState.MOCInitiated)
        proceeding = cc.CallProceeding()
        proceeding.ti = (1 << 3) | t.ti_value  # TI flag flipped downlink
        channel.send(L3Frame(proceeding.encode(), Primitive.DATA))
        engine = self._new_engine(f"IMSI{t.imsi}")
        t.sip = engine
        engine.moc_send_invite(t.called)
        t.set_state(Q931CallState.MOCProceeding)
        if getattr(channel, "is_tch", False):
            # very-early assignment: the call is already on its TCH/F,
            # signalling on the FACCH — switch the channel to speech
            # mode before call control proceeds (MOCStarter veryEarly,
            # CallControl.cpp:666-680)
            self.send_mode_modify(channel, t)
        else:
            self.assign_tch(channel, t)

    def emergency_setup(self, channel, t_msg: cc.EmergencySetup):
        """Emergency Setup MTI → the E-MOC leg (EmergencyCall
        controller, CallControl.cpp:1020-1060): destination comes from
        PBX.Emergency whatever the MS knows; otherwise the normal MO
        setup flow."""
        t = self._transaction_for(channel)
        if t is None:
            return
        t.service = ServiceType.EmergencyCall
        setup = cc.Setup()
        setup.ti = t_msg.ti
        self.moc_setup(channel, setup)

    def cc_hold(self, channel, msg: cc.Hold):
        """Hold is not supported: answer every in-call Hold with
        HoldReject cause 0x3f so the handset doesn't hang
        (CallControl.cpp:356-360)."""
        t = self._transaction_for(channel)
        log.warning("rejecting hold request on channel %s", id(channel))
        rej = cc.HoldReject(cc.Cause(0x3F))
        rej.ti = ((t.ti_flag if t else 1) << 3) | (t.ti_value if t else 0)
        channel.send(L3Frame(rej.encode(), Primitive.DATA))

    def cc_status(self, channel, msg: cc.CCStatus):
        """CC Status: MS-reported CC protocol error — log it; the call
        FSM carries on (the reference's unsupported-message path)."""
        log.warning("CC status from MS: cause=0x%02x state=%d",
                    msg.cause.value, msg.call_state)

    def send_mode_modify(self, channel, t: TransactionEntry,
                         mode: int = rr.ChannelMode.SpeechV1) -> None:
        """L3 Channel Mode Modify on a dedicated channel; the MS must
        answer with ChannelModeModifyAcknowledge echoing the mode
        (CallControl.cpp:668-680,889-896,1075-1110)."""
        t.tch = channel
        t.pending_mode = mode
        desc = rr.ChannelDescription(
            type_and_offset=1, tn=getattr(channel, "tn", 0),
            tsc=self.bts.bcc, arfcn=self.bts.arfcn)
        channel.send(L3Frame(
            rr.ChannelModeModify(desc, mode).encode(), Primitive.DATA))

    def mode_modify_ack(self, channel,
                        msg: rr.ChannelModeModifyAcknowledge):
        """The MS confirmed (or refused) the mode change. A mismatched
        mode aborts the call with cause 0x06 "channel unacceptable"
        (CallControl.cpp:676-680)."""
        t = self._transaction_for(channel)
        if t is None:
            return
        want = getattr(t, "pending_mode", None)
        t.pending_mode = None
        if want is None:
            return
        if msg.mode != want:
            log.warning("mode modify refused: got %d want %d", msg.mode,
                        want)
            self._abort_call(channel, t, cause=0x06)
            return
        # the channel is already open (very-early: allocated at access
        # grant); only the mode state changes here
        if t.sip is not None and t.sip.rtp is not None and \
                getattr(t, "voice", None) is None:
            from openbts_ttsou_tpu_torch.control.voice import VoicePump

            t.voice = VoicePump(channel, t.sip)

    def assignment_failure(self, channel, msg: rr.AssignmentFailure):
        """The MS could not move to the assigned TCH and returned to
        the old channel (L3AssignmentFailure, GSML3RRMessages.h:654):
        reclaim the reserved TCH and abort the call."""
        t = self._transaction_for(channel)
        log.warning("assignment failure cause=0x%02x", msg.cause)
        if t is None:
            self._release_channel(channel)
            return
        tch = getattr(t, "tch", None)
        if tch is not None and tch is not channel:
            self.channel_transactions.pop(id(tch), None)
            self.bts.release(tch)
            t.tch = None
        self._abort_call(channel, t, cause=0x06)

    def rr_status(self, channel, msg: rr.RRStatus):
        """RR Status: MS-reported RR protocol error (L3RRStatus,
        GSML3RRMessages.h:678) — log it; the procedure carries on."""
        log.warning("RR status from MS: cause=0x%02x", msg.cause)

    def _abort_call(self, channel, t: TransactionEntry,
                    cause: int = 0x10) -> None:
        """abortCall (CallControl.cpp:420-439): L3 Disconnect with the
        cause, drop the SIP leg, release resources."""
        disc = cc.Disconnect(cc.Cause(cause))
        disc.ti = (t.ti_flag << 3) | t.ti_value
        channel.send(L3Frame(disc.encode(), Primitive.DATA))
        if t.sip is not None:
            t.sip.mod_send_bye()
            t.set_state(Q931CallState.ReleaseRequest)

    def assign_tch(self, channel, t: TransactionEntry) -> None:
        """Early assignment: move the call to a TCH/F
        (assignTCHF, CallControl.cpp:441-470)."""
        tch = self.bts.get_tch()
        if tch is None:
            return  # stay on the SDCCH (very-early assignment fallback)
        t.tch = tch
        # the MS answers with AssignmentComplete on the NEW channel's
        # FACCH — bind the transaction to it so the FACCH dispatch
        # resolves (AssignmentCompleteHandler, RadioResource.cpp:285)
        self.channel_transactions[id(tch)] = t.id
        cmd = rr.AssignmentCommand(
            rr.ChannelDescription(type_and_offset=1, tn=tch.tn,
                                  tsc=self.bts.bcc, arfcn=self.bts.arfcn))
        channel.send(L3Frame(cmd.encode(), Primitive.DATA))

    def assignment_complete(self, channel, msg: rr.AssignmentComplete):
        """AssignmentCompleteHandler (RadioResource.cpp:285): the MS is
        on the TCH; open it and attach the voice pump when active.
        `channel` is the TCH's FACCH once the MS establishes there, or
        the old SDCCH for MSs that answer before switching."""
        t = self._transaction_for(channel)
        if t is None or getattr(t, "tch", None) is None:
            return
        t.tch.open(self.bts.clock.fn())
        if t.sip is not None and t.sip.rtp is not None:
            from openbts_ttsou_tpu_torch.control.voice import VoicePump

            t.voice = VoicePump(t.tch, t.sip)

    def mtc_call_confirmed(self, channel, msg: cc.CallConfirmed):
        """The MS confirmed the MT Setup (GSM 04.08 9.3.2): enter
        MTCConfirmed, and — in very-early assignment — run the mode-set
        exchange now, the reference's ordering (MTCStarter waits for
        Call Confirmed before L3ChannelModeModify,
        CallControl.cpp:859-896)."""
        t = self._transaction_for(channel)
        if t is None:
            return
        t.set_state(Q931CallState.MTCConfirmed)
        if getattr(channel, "is_tch", False) and \
                getattr(t, "pending_mode", None) is None and \
                t.service == ServiceType.MobileTerminatedCall:
            self.send_mode_modify(channel, t)

    def cc_forward(self, channel, msg):
        """Alerting needs no action; ConnectAcknowledge on a
        very-early-assigned TCH is where the in-call vocoder pump
        attaches (MOCController's callManagementLoop entry,
        CallControl.cpp:756-772 — the early-assignment flow attaches in
        assignment_complete instead)."""
        if not isinstance(msg, cc.ConnectAcknowledge):
            return
        t = self._transaction_for(channel)
        if t is None:
            return
        t.set_state(Q931CallState.Active)
        if getattr(t, "voice", None) is None and \
                getattr(channel, "is_tch", False) and \
                t.sip is not None and t.sip.rtp is not None:
            from openbts_ttsou_tpu_torch.control.voice import VoicePump

            t.voice = VoicePump(channel, t.sip)

    def mtc_connect(self, channel, msg: cc.Connect):
        """MS answered an MT call (MTCController,
        CallControl.cpp:911)."""
        t = self._transaction_for(channel)
        if t is None:
            return
        if t.sip is not None:
            t.sip.mtc_send_ok()
        ack = cc.ConnectAcknowledge()
        ack.ti = (t.ti_flag << 3) | t.ti_value
        channel.send(L3Frame(ack.encode(), Primitive.DATA))
        t.set_state(Q931CallState.Active)
        if getattr(t, "voice", None) is None and \
                getattr(channel, "is_tch", False) and \
                t.sip is not None and t.sip.rtp is not None:
            from openbts_ttsou_tpu_torch.control.voice import VoicePump

            t.voice = VoicePump(channel, t.sip)

    def start_dtmf(self, channel, msg: cc.StartDTMF):
        """DTMF key press → SIP INFO (CallControl.cpp:332). The answer is
        awaited by dtmf_tick, not here: the service loop must not block
        on the proxy. A relay that cannot start is rejected at once."""
        t = self._transaction_for(channel)
        sip = t.sip if t is not None else None
        cseq = None
        if sip is not None and sip.call_id is not None and \
                self.sip_fifos is not None:
            if self.sip_fifos.add_call(sip.call_id):
                self._relay_fifos.add(sip.call_id)
            cseq = sip.send_dtmf_info(msg.key)
            if cseq is None:
                self._close_relay_fifo(sip.call_id)
        if cseq is None:
            self._answer_dtmf(channel, t, None)
            return
        timeout_s = self.bts.config.get_int("SIP.Timer.A", 2000) / 1e3
        self.pending_dtmf.append(DtmfRelay(
            t, channel, cseq, msg.key, systime.monotonic() + timeout_s))

    def dtmf_tick(self) -> None:
        """Settle the pending DTMF relays (called from the BTS service
        loop after the SIP socket is drained): Start DTMF Acknowledge
        when a 200 to the INFO is in the call's FIFO, Start DTMF Reject
        on another final answer or once SIP.Timer.A has passed. The
        call's other messages stay in its FIFO. A relay whose
        transaction has gone is dropped unanswered."""
        now = systime.monotonic()
        for r in list(self.pending_dtmf):
            sip, ok = r.t.sip, None
            if self.transactions.find(r.t.id) is not None:
                answer = self.sip_fifos.take(
                    sip.call_id,
                    lambda m: sip.dtmf_answer(m, r.cseq) is not None)
                if answer is not None:
                    ok = sip.dtmf_answer(answer, r.cseq)
                elif now < r.deadline:
                    continue
                else:
                    ok = False
            self.pending_dtmf.remove(r)
            self._close_relay_fifo(sip.call_id)
            if ok is not None:
                self._answer_dtmf(r.channel, r.t, r.key if ok else None)

    def _close_relay_fifo(self, call_id: str) -> None:
        """Close a call FIFO that a relay opened, once no relay of the
        call is pending and nothing else waits in it."""
        if call_id in self._relay_fifos and \
                self.sip_fifos.fifo_size(call_id) == 0 and not any(
                    r.t.sip.call_id == call_id for r in self.pending_dtmf):
            self._relay_fifos.discard(call_id)
            self.sip_fifos.remove_call(call_id)

    def _answer_dtmf(self, channel, t: Optional[TransactionEntry],
                     key: Optional[str]) -> None:
        """GSM 04.08 9.3.25 Start DTMF Acknowledge (MTI 0x36) with the
        relayed key, or, for key None, 9.3.26 Start DTMF Reject (0x37,
        cause 0x3f). Downlink TI flag: flipped relative to the
        ORIGINATOR of the transaction (GSM 04.07 11.2.3.1.3) — 1 for
        MS-originated, 0 for network-originated; t.ti_flag records
        exactly that."""
        out = cc.StartDTMFAck(key) if key is not None else \
            cc.StartDTMFReject()
        out.ti = ((t.ti_flag if t else 1) << 3) | (t.ti_value if t else 0)
        channel.send(L3Frame(out.encode(), Primitive.DATA))

    def stop_dtmf(self, channel, msg: cc.StopDTMF):
        t = self._transaction_for(channel)
        ack = cc.StopDTMFAck()
        ack.ti = ((t.ti_flag if t else 1) << 3) | (t.ti_value if t else 0)
        channel.send(L3Frame(ack.encode(), Primitive.DATA))

    def cc_disconnect(self, channel, msg: cc.Disconnect):
        t = self._transaction_for(channel)
        rel = cc.Release()
        rel.ti = ((t.ti_flag if t else 1) << 3) | (t.ti_value if t else 0)
        channel.send(L3Frame(rel.encode(), Primitive.DATA))
        if t and t.sip is not None:
            t.sip.mod_send_bye()
            t.set_state(Q931CallState.ReleaseRequest)

    def cc_release(self, channel, msg: cc.Release):
        t = self._transaction_for(channel)
        rc = cc.ReleaseComplete()
        rc.ti = ((t.ti_flag if t else 1) << 3) | (t.ti_value if t else 0)
        channel.send(L3Frame(rc.encode(), Primitive.DATA))
        self._finish_call(channel, t)

    def cc_release_complete(self, channel, msg: cc.ReleaseComplete):
        self._finish_call(channel, self._transaction_for(channel))

    def _finish_call(self, channel, t: Optional[TransactionEntry]):
        if t:
            if t.sip is not None:
                t.sip.close()
            tch = getattr(t, "tch", None)
            if tch is not None:
                tch.close()
                self.bts.release(tch)
            self.transactions.remove(t.id)
        self._release_channel(channel)

    # ------------------------------------------------------------------
    # Mobile-terminated: paging + response (RadioResource.cpp:221)
    # ------------------------------------------------------------------
    def initiate_mtc(self, imsi: str, calling: str = "") -> TransactionEntry:
        """SIP INVITE arrived for `imsi` (initiateMTTransaction)."""
        t = self.transactions.new(ServiceType.MobileTerminatedCall,
                                  imsi=imsi, calling=calling)
        t.set_state(Q931CallState.Paging)
        tmsi = self.tmsis.tmsi(imsi)
        identity = (MobileIdentity.from_tmsi(tmsi) if tmsi is not None
                    else MobileIdentity.imsi(imsi))
        self.bts.pager.add(identity, transaction_id=t.id)
        return t

    def page_tick(self) -> None:
        """Emit pending paging requests on the PCH
        (Pager::serviceLoop)."""
        batch = self.bts.pager.page_batch(2)
        if not batch:
            return
        msg = rr.PagingRequestType1(batch[0],
                                    batch[1] if len(batch) > 1 else None)
        self.bts.send_pch(L3Frame(msg.encode(), Primitive.UNIT_DATA))

    def paging_response(self, channel, msg: rr.PagingResponse):
        """PagingResponseHandler (RadioResource.cpp:221)."""
        imsi = self._imsi_of(msg.identity)
        # only MT transactions answer a page (stale MO entries for the
        # same IMSI must not shadow the paged service)
        t = self.transactions.find_by_imsi(
            imsi, services=(ServiceType.MobileTerminatedCall,
                            ServiceType.MobileTerminatedSMS))             if imsi else None
        if t is None:
            self._release_channel(channel)
            return
        self.bts.pager.remove(msg.identity)
        self._bind(channel, t)
        if t.service == ServiceType.MobileTerminatedCall:
            setup = cc.Setup(cc.CalledPartyBCDNumber(t.calling)
                             if t.calling else None)
            setup.ti = 0 << 3 | t.ti_value  # network-originated TI
            channel.send(L3Frame(setup.encode(), Primitive.DATA))
            t.set_state(Q931CallState.CallPresent)
            if t.sip is not None:
                t.sip.mtc_send_trying()
                t.sip.mtc_send_ringing()
        elif t.service == ServiceType.MobileTerminatedSMS:
            self.deliver_sms(channel, t)

    # ------------------------------------------------------------------
    # SMS (SMSControl.cpp:301,425)
    # ------------------------------------------------------------------
    def handle_sms_cpdata(self, channel, cp_bytes: bytes):
        """MO-SMS: CP-DATA(RP-DATA(TL-SUBMIT)) → SIP MESSAGE
        (MOSMSController)."""
        t = self._transaction_for(channel)
        cp = sms.parse_cp(cp_bytes)
        if not isinstance(cp, sms.CPData):
            return
        ack = np.unpackbits(np.frombuffer(
            sms.CPAck(ti=cp.ti).encode(), np.uint8))
        channel.send(L3Frame(ack, Primitive.DATA), sapi=3)
        rp = sms.parse_rp(cp.rpdu)
        if isinstance(rp, (sms.RPAck, sms.RPError)):
            # MS acknowledged (or refused) an MT delivery: close out
            if t and t.service == ServiceType.MobileTerminatedSMS:
                self.transactions.remove(t.id)
                self._release_channel(channel)
            return
        if not isinstance(rp, sms.RPData):
            return
        tl = sms.TLSubmit.parse(rp.tpdu)
        imsi = t.imsi if t else ""
        engine = self._new_engine(f"IMSI{imsi}")
        if t:
            t.sip = engine
            t.message = tl.text
        engine.mosms_send_message(tl.dest, tl.text)
        # RP-ACK goes back after the SIP 200 (on_sip_response)

    def initiate_mtsms(self, imsi: str, sender: str,
                       text: str) -> TransactionEntry:
        t = self.transactions.new(ServiceType.MobileTerminatedSMS,
                                  imsi=imsi, calling=sender, message=text)
        tmsi = self.tmsis.tmsi(imsi)
        identity = (MobileIdentity.from_tmsi(tmsi) if tmsi is not None
                    else MobileIdentity.imsi(imsi))
        self.bts.pager.add(identity, transaction_id=t.id)
        return t

    def initiate_testcall(self, imsi: str) -> TransactionEntry:
        """CLI `testcall`: page the MS into a dedicated channel held
        open for loopback testing (TestCall, CallControl.cpp)."""
        t = self.transactions.new(ServiceType.TestCall, imsi=imsi)
        tmsi = self.tmsis.tmsi(imsi)
        identity = (MobileIdentity.from_tmsi(tmsi) if tmsi is not None
                    else MobileIdentity.imsi(imsi))
        self.bts.pager.add(identity, transaction_id=t.id)
        return t

    def send_rrlp(self, imsi: str, apdu: bytes) -> bool:
        """CLI `sendrrlp`: push an RRLP APDU to an MS with an active
        dedicated channel (Application Information, GSM 04.08 9.1.53)."""
        for ch_id, tid in self.channel_transactions.items():
            t = self.transactions.find(tid)
            if t is not None and t.imsi == imsi:
                for ch in getattr(self.bts, "sdcch_pool", []):
                    if id(ch) == ch_id:
                        msg = rr.ApplicationInformation(apdu)
                        ch.send(L3Frame(msg.encode(), Primitive.DATA))
                        return True
        return False

    def deliver_sms(self, channel, t: TransactionEntry):
        """MT-SMS delivery over SAPI 3 (deliverSMSToMS,
        SMSControl.cpp:425)."""
        tl = sms.TLDeliver(orig=t.calling, text=t.message)
        rp = sms.RPData(reference=1, tpdu=tl.encode(), mo=False)
        cp = sms.CPData(ti=t.ti_value, rpdu=rp.encode())
        bits = np.unpackbits(np.frombuffer(cp.encode(), np.uint8))
        # network-initiated SABM on SAPI 3 (GSM 04.06 5.4.1.1 allows
        # BTS-originated establishment on SAP3); CP-DATA follows the UA
        channel.send(L3Frame(primitive=Primitive.ESTABLISH), sapi=3)
        channel.send(L3Frame(bits, Primitive.DATA), sapi=3)
        t.set_state(Q931CallState.SMSDelivering)

    # ------------------------------------------------------------------
    # SIP events
    # ------------------------------------------------------------------
    def on_sip_response(self, t: TransactionEntry, channel,
                        sip_msg) -> None:
        """Advance a transaction on an inbound SIP message
        (MOCController / MOSMS wait loops)."""
        if t.sip is None:
            return
        state = t.sip.receive(sip_msg)
        if t.service == ServiceType.LocationUpdate:
            if state == SIPState.Cleared:
                self.complete_location_update(channel, t, True)
            elif state == SIPState.Fail:
                self.complete_location_update(channel, t, False)
        elif t.service in (ServiceType.MobileOriginatedCall,
                           ServiceType.EmergencyCall):
            if state == SIPState.Proceeding and \
                    t.state == Q931CallState.MOCProceeding:
                # early media / call-progress leg (MOC sends
                # L3Progress on SIP Proceeding, CallControl.cpp:739)
                prog = cc.Progress()
                prog.ti = (t.ti_flag << 3) | t.ti_value
                channel.send(L3Frame(prog.encode(), Primitive.DATA))
            elif state == SIPState.Ringing and \
                    t.state != Q931CallState.CallReceived:
                alert = cc.Alerting()
                alert.ti = (t.ti_flag << 3) | t.ti_value
                channel.send(L3Frame(alert.encode(), Primitive.DATA))
                t.set_state(Q931CallState.CallReceived)
            elif state == SIPState.Connecting:
                t.sip.moc_send_ack()
                conn = cc.Connect()
                conn.ti = (t.ti_flag << 3) | t.ti_value
                channel.send(L3Frame(conn.encode(), Primitive.DATA))
                t.set_state(Q931CallState.ConnectIndication)
        elif t.service == ServiceType.MobileOriginatedSMS:
            if state in (SIPState.Cleared, SIPState.Fail):
                # ack the RP layer and close
                ok = state == SIPState.Cleared
                rp = (sms.RPAck(reference=1) if ok
                      else sms.RPError(reference=1))
                cp = sms.CPData(ti=0, rpdu=rp.encode())
                bits = np.unpackbits(np.frombuffer(cp.encode(), np.uint8))
                channel.send(L3Frame(bits, Primitive.DATA), sapi=3)
                self.transactions.remove(t.id)
                self._release_channel(channel)
