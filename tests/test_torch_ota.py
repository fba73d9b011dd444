"""The port's BTS over the air on the CPU: the scenarios of
tests/test_e2e_lur.py that tests/test_torch_bts.py does not run, and the
port's fixes to the DTMF relay and the deferred channel release.

`BTSApp` and the port's per-frame `TrxDaemon` on the CPU over a
`DuplexLoopbackRadio`, with chip_smoke.py's rig and simulated MS
(`BtsRig`, `SimMS`: the port's own GMSK, L1 codecs and LAPDm on the MS
side), every C0 timeslot equipped (chip_smoke.bts_config()). Each
message crosses modulation, FEC and LAPDm both ways. The rig's daemon
binds UDP ports 54000-54002 and its app 54100-54102; the DTMF test's
SIP interface and proxy take 54110-54111.
"""

import random
import socket
import time

import numpy as np
import pytest
import torch

import chip_smoke as cs
from openbts_ttsou_tpu_torch.control.voice import rtp_to_payload
from openbts_ttsou_tpu_torch.gsm import channels, tdma
from openbts_ttsou_tpu_torch.gsm.l3 import cc, mm, parse_l3, rr
from openbts_ttsou_tpu_torch.gsm.l3 import common as l3c
from openbts_ttsou_tpu_torch.gsm.lapdm import L2LAPDm, LAPDState
from openbts_ttsou_tpu_torch.gsm.transfer import (ChannelType, ControlFormat,
                                                  FrameType, L3Frame,
                                                  Primitive, RxBurst)
from openbts_ttsou_tpu_torch.sip.message import (SIPMessage, make_response,
                                                 make_sdp)

torch.set_num_threads(1)

RIG_PORT = 54000
IMSI = cs.BTS_IMSI


@pytest.fixture(scope="module")
def rig():
    random.seed(1)
    r = cs.BtsRig("cpu", RIG_PORT)
    yield r
    r.close()


@pytest.fixture(autouse=True)
def _reclaim(request):
    yield
    if "rig" in request.fixturenames:
        request.getfixturevalue("rig").reclaim()


def invite_of(rig) -> SIPMessage:
    return next(m for m in map(SIPMessage.parse, rig.sip_out)
                if m.method == "INVITE")


def transaction(rig, called=None):
    return max((t for t in rig.app.control.transactions.entries()
                if t.imsi == IMSI and (called is None or t.called == called)),
               key=lambda t: t.id)


def test_ota_mo_call(rig):
    """RACH → SDCCH → CM Service → Setup → (INVITE) → Alerting →
    Connect (ACK to SIP) → Disconnect → Release (BYE to SIP)."""
    ms = cs.SimMS(rig)
    ms.access(0x17, mm.CMServiceRequest(
        service_type=1, identity=l3c.MobileIdentity.imsi(IMSI)))
    assert ms.drive(140, mm.CMServiceAccept) is not None, ms.got
    ms.send_l3(cc.Setup(cc.CalledPartyBCDNumber("2125551212")))
    assert ms.drive(160, cc.CallProceeding) is not None, ms.got
    invite = invite_of(rig)
    assert "2125551212" in invite.uri
    rig.sip_out.clear()
    t = transaction(rig, "2125551212")
    ctl = rig.app.control
    ctl.on_sip_response(t, ms.channel,
                        make_response(invite, 180, "Ringing", to_tag="rr"))
    assert ms.drive(160, cc.Alerting) is not None, ms.got
    ctl.on_sip_response(t, ms.channel, make_response(
        invite, 200, "OK", to_tag="rr", body=make_sdp("127.0.0.1", 40002)))
    assert ms.drive(160, cc.Connect) is not None, ms.got
    assert any(SIPMessage.parse(b).method == "ACK" for b in rig.sip_out)
    rig.sip_out.clear()
    ms.send_l3(cc.Disconnect())
    assert ms.drive(160, cc.Release) is not None, ms.got
    assert any(SIPMessage.parse(b).method == "BYE" for b in rig.sip_out)


def test_ota_start_dtmf_relay(rig):
    """CallControl.cpp:332 over the air, with the app's real SIPInterface
    and a proxy on a UDP socket: a key whose SIP INFO is answered with a
    200 gets Start DTMF Acknowledge (0x36) with the key; a key whose
    proxy stays silent gets Start DTMF Reject (0x37, cause 0x3f) once
    SIP.Timer.A (2 s) has passed. While the relay waits the service loop
    runs on: no app.step comes near the timer."""
    from openbts_ttsou_tpu_torch.sip.interface import SIPInterface

    app, ctl = rig.app, rig.app.control
    proxy = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    proxy.bind(("127.0.0.1", 54111))
    proxy.setblocking(False)
    iface = SIPInterface(local_port=54110, proxy_port=54111)
    app.sip = ctl.sip_fifos = iface
    ctl.sip_send = iface.send
    infos = []

    def answer_key_1():  # the proxy: a 200 to INFOs that carry key 1
        while True:
            try:
                m = SIPMessage.parse(proxy.recv(65536))
            except BlockingIOError:
                return False
            if m.method == "INFO":
                infos.append(m)
                if "Signal=1" in m.body:
                    proxy.sendto(make_response(m, 200, "OK").render(),
                                 ("127.0.0.1", 54110))

    try:
        ms = cs.SimMS(rig)
        ms.access(0x19, mm.CMServiceRequest(
            service_type=1, identity=l3c.MobileIdentity.imsi(IMSI)))
        assert ms.drive(140, mm.CMServiceAccept) is not None, ms.got
        ms.send_l3(cc.Setup(cc.CalledPartyBCDNumber("3105550000")))
        assert ms.drive(160, cc.CallProceeding) is not None, ms.got
        ms.send_l3(cc.StartDTMF("1"))
        ack = ms.drive(160, cc.StartDTMFAck, until=answer_key_1)
        assert ack is not None and ack.key == "1", ms.got
        n0, t0 = len(rig.app_ms), time.monotonic()
        ms.send_l3(cc.StartDTMF("9"))
        rej = ms.drive(1000, cc.StartDTMFReject, until=answer_key_1)
        assert rej is not None, ms.got
        assert time.monotonic() - t0 >= 2.0  # SIP.Timer.A's default
        assert rej.MTI == 0x37 and rej.cause.value == 0x3F
        assert rej.ti == ack.ti == (1 << 3) | (ack.ti & 7)
        # the wait never held the loop: each step far under the timer
        assert max(rig.app_ms[n0:]) < 250.0
        assert ["Signal=1" in m.body for m in infos] == [True, False]
        assert not ctl.pending_dtmf
        ms.send_l3(cc.StopDTMF())
        assert ms.drive(160, cc.StopDTMFAck) is not None, ms.got
    finally:
        app.sip = ctl.sip_fifos = None
        ctl.sip_send = rig.sip_out.append
        iface.sock.close()
        proxy.close()


def test_ota_sms_via_smqueue(rig):
    out = cs.ota_sms_via_smqueue(rig)
    assert out["text"] == "ping via smqueue" and out["orig"] == "5553000"


def test_ota_lur_delivers_shortname(rig):
    """With GSM.ShortName set the MS decodes an MMInformation carrying
    the name before the LocationUpdatingAccept
    (MobilityManagement.cpp:203-207)."""
    rig.app.bts.config.set("GSM.ShortName", "TPUNet")
    try:
        ms = cs.SimMS(rig)
        ms.access(0x31, mm.LocationUpdatingRequest(
            rig.app.bts.lai(), l3c.MobileIdentity.imsi(IMSI)))
        assert ms.drive(140, until=lambda: bool(rig.sip_out))
        reg = SIPMessage.parse(rig.sip_out.pop())
        rig.app.control.on_sip_response(
            rig.app.control.transactions.entries()[0], ms.channel,
            make_response(reg, 200, "OK"))
        assert ms.drive(500, mm.LocationUpdatingAccept) is not None, ms.got
    finally:
        rig.app.bts.config.set("GSM.ShortName", "")
    kinds = [type(m).__name__ for m in ms.got]
    infos = [m for m in ms.got if isinstance(m, mm.MMInformation)]
    assert infos and infos[0].short_name == "TPUNet", kinds
    assert kinds.index("MMInformation") < \
        kinds.index("LocationUpdatingAccept")


def test_ota_emergency_call_progress_and_hold(rig):
    """EmergencySetup routes to PBX.Emergency (CallControl.cpp:1020-1060);
    SIP 100 Trying gives L3 Progress (:739); an in-call Hold gets
    HoldReject, cause 0x3f (:356-360); Disconnect gets Release."""
    rig.app.bts.config.set("PBX.Emergency", "112")
    ms = cs.SimMS(rig)
    ms.access(0x2A, mm.CMServiceRequest(
        service_type=8, identity=l3c.MobileIdentity.imsi(IMSI)))
    assert ms.drive(140, mm.CMServiceAccept) is not None, ms.got

    def send(msg):
        msg.ti = 0x05
        ms.send_l3(msg)

    send(cc.EmergencySetup())
    proc = ms.drive(160, cc.CallProceeding)
    assert proc is not None and proc.ti == (1 << 3) | 5, ms.got
    invite = invite_of(rig)
    assert "112" in invite.uri
    t = transaction(rig)
    rig.app.control.on_sip_response(t, ms.channel,
                                    make_response(invite, 100, "Trying"))
    prog = ms.drive(160, cc.Progress)
    assert prog is not None and prog.ti == (1 << 3) | 5, ms.got
    send(cc.Hold())
    rej = ms.drive(160, cc.HoldReject)
    assert rej is not None and rej.cause.value == 0x3F, ms.got
    assert rej.ti == (1 << 3) | 5
    send(cc.Disconnect())
    rel = ms.drive(160, cc.Release)
    assert rel is not None and rel.ti == (1 << 3) | 5, ms.got


class FacchModem:
    """The MS side of a TCH/F's FACCH: TCH/FACCH L1 transmitter and
    receiver on the CPU and a FACCH LAPDm (chip_smoke.facch_hold's)."""

    def __init__(self, rig, ms, tn):
        self.rig, self.ms, self.tn = rig, ms, tn
        self.l2 = L2LAPDm(c=0, sapi=0, chan_type=ChannelType.FACCH)
        self.tx, self.rx = (channels.TCHFACCHL1(
            tn, tdma.FACCH_TCHF, tdma.FACCH_TCHF, tsc=ms.bcc, device="cpu")
            for _ in range(2))
        self.tx.open(0)
        self.rx.open(0)
        self.rx.upstream = self.l2
        self.fn_scan = rig.daemon.fn - 2
        self.got = []

    def drive(self, rounds, want=None, until=None):
        daemon = self.rig.daemon
        for _ in range(rounds):
            self.rig.pump()
            while self.fn_scan < daemon.fn - 5:
                if tdma.FACCH_TCHF.reverse(self.fn_scan) is not None:
                    soft = self.ms.rx_soft(self.fn_scan, tn=self.tn)
                    if soft is not None:
                        self.rx.write_low_side(RxBurst(soft, fn=self.fn_scan,
                                                       tn=self.tn))
                self.fn_scan += 1
            outs = self.l2.take_l1_out()
            if outs:  # FACCH steals whole blocks on a fresh diagonal
                self.tx.resync(daemon.fn, lead=5)
                for out in outs:
                    self.tx.send_l2(out)
                while self.tx._facch_q or (self.tx._offset != 0
                                           and self.tx.tx_queue):
                    self.tx.dispatch_block()
                self.tx.dispatch_block()  # the diagonal's second half
            while self.tx.tx_queue and \
                    self.tx.tx_queue[0].fn <= daemon.fn + 30:
                b = self.tx.tx_queue.popleft()
                if b.fn > daemon.fn - 2:
                    self.ms.tx_burst(b.bits, b.fn, tn=self.tn)
            while (l3 := self.l2.read_high_side()) is not None:
                if len(l3.bits) >= 16 and (m := parse_l3(l3.bits)):
                    self.got.append(m)
                    if want is not None and isinstance(m, want):
                        return m
            if until is not None and until():
                return True
        return None

    def send_l3(self, msg):
        self.l2.write_high_side(L3Frame(msg.encode(), Primitive.DATA))


def test_ota_veryearly_call(rig):
    """Very-early assignment: the RACH is granted a TCH/F directly, all
    signalling rides its FACCH, ChannelModeModify switches it to speech
    and waits for the MS's acknowledge (CallControl.cpp:666-680), and
    uplink speech on the same channel reaches RTP."""
    app, daemon = rig.app, rig.daemon
    app.bts.config.set("GSM.AssignmentType", "veryearly")
    rtp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        ms = cs.SimMS(rig)
        free = app.bts.tch_available()
        fn_r = daemon.fn + 8
        while fn_r % 51 not in range(14, 37):
            fn_r += 1
        ms.tx_rach(0x2B, fn_r)
        ia = ms.ccch_message(fn_r, 240, 6, lambda m: isinstance(
            m, rr.ImmediateAssignment) and m.reference.ra == 0x2B)
        assert ia is not None and app.bts.tch_available() < free
        assert ia.channel.type_and_offset == 1, "IA must assign a TCH/F"
        tn = ia.channel.tn
        bts_tch = next(c for c in app.bts.tch_pool if c.tn == tn)
        modem = FacchModem(rig, ms, tn)
        req = mm.CMServiceRequest(service_type=1,
                                  identity=l3c.MobileIdentity.imsi(IMSI))
        modem.l2._send_u(FrameType.SABM, True, modem.l2.c, req.encode())
        modem.l2.state = LAPDState.AwaitingEstablish
        assert modem.drive(200, mm.CMServiceAccept) is not None, modem.got
        modem.send_l3(cc.Setup(cc.CalledPartyBCDNumber("7005551111")))
        cmm = modem.drive(300, rr.ChannelModeModify)
        assert cmm is not None, modem.got
        assert cmm.mode == rr.ChannelMode.SpeechV1
        assert (cmm.channel.type_and_offset, cmm.channel.tn) == (1, tn)
        assert any(isinstance(m, cc.CallProceeding) for m in modem.got)
        invite = invite_of(rig)
        rig.sip_out.clear()
        modem.send_l3(rr.ChannelModeModifyAcknowledge(cmm.channel, cmm.mode))
        t = transaction(rig, "7005551111")
        assert modem.drive(360, until=lambda: getattr(
            t, "pending_mode", "unset") is None), modem.got
        assert t.tch is bts_tch
        rtp.bind(("127.0.0.1", 0))
        rtp.setblocking(False)
        app.control.on_sip_response(t, bts_tch, make_response(
            invite, 200, "OK", to_tag="ve",
            body=make_sdp("127.0.0.1", rtp.getsockname()[1])))
        conn = modem.drive(200, cc.Connect)
        assert conn is not None, modem.got
        ack = cc.ConnectAcknowledge()
        ack.ti = conn.ti & 0x7
        modem.send_l3(ack)
        assert modem.drive(200, until=lambda: getattr(
            t, "voice", None) is not None), "voice pump not attached"

        # uplink speech on the same channel, on a diagonal boundary
        fn0 = daemon.fn + 6
        while (tdma.FACCH_TCHF.reverse(fn0) is None
               or tdma.FACCH_TCHF.reverse(fn0) % 8):
            fn0 += 1
        tx = modem.tx
        tx.next_write_fn, tx._offset = fn0, 0
        tx._itx[:] = 0
        tx.tx_queue.clear()
        speech = [np.random.default_rng(11 + k).integers(
            0, 2, 260).astype(np.uint8) for k in range(3)]
        for fr in speech:
            tx.send_tch(fr)
        for _ in range(4):
            tx.dispatch_block()
        bursts = list(tx.tx_queue)
        tx.tx_queue.clear()
        ups, bi = [], 0
        for _ in range(300):
            while bi < len(bursts) and bursts[bi].fn <= daemon.fn + 6:
                ms.tx_burst(bursts[bi].bits, bursts[bi].fn, tn=tn)
                bi += 1
            rig.pump()
            while True:
                try:
                    data, _ = rtp.recvfrom(2048)
                except BlockingIOError:
                    break
                if len(data) >= 12 + 33:
                    ups.append(rtp_to_payload(data[12:]))
            if len(ups) >= 2 and bi >= len(bursts):
                break
        matches = sum(any(np.array_equal(u, s) for s in speech)
                      for u in ups if u is not None)
        assert matches >= 2, f"uplink speech not bridged ({len(ups)})"
    finally:
        rtp.close()
        app.bts.config.set("GSM.AssignmentType", "early")


# ---- the deferred release: T3111 bounds a vanished MS, not a slow one ---------

T3111_MS = 2000


def released_after_lu(rig, ms_step):
    """A location update whose downlink (MMInformation, the accept and
    the Channel Release: three I-frames on the SDCCH) drains while
    `ms_step()` runs each frame; returns (frames from the deferred
    release to the hard release, the SDCCH's LAPDm retransmissions)."""
    app = rig.app
    app.bts.config.set("GSM.Timer.T3111", str(T3111_MS))
    app.bts.config.set("GSM.ShortName", "TPUNet")
    try:
        ms = cs.SimMS(rig)
        free = app.bts.sdcch_available()
        ms.access(0x35, mm.LocationUpdatingRequest(
            app.bts.lai(), l3c.MobileIdentity.imsi(IMSI)))
        assert ms.drive(140, until=lambda: bool(rig.sip_out))
        reg = SIPMessage.parse(rig.sip_out.pop())
        app.control.on_sip_response(app.control.transactions.entries()[0],
                                    ms.channel, make_response(reg, 200, "OK"))
        assert app.control.pending_release, "the release was not deferred"
        lapdm = ms.channel.l2[0]
        fn0, rc_max = rig.daemon.fn, 0
        while app.bts.sdcch_available() < free:
            ms_step(ms)
            rc_max = max(rc_max, lapdm.rc)
            assert rig.daemon.fn - fn0 < 2000, "the channel was never freed"
        return rig.daemon.fn - fn0, rc_max, ms
    finally:
        app.bts.config.set("GSM.Timer.T3111",
                           dict(cs.BTS_SETTINGS)["GSM.Timer.T3111"])
        app.bts.config.set("GSM.ShortName", "")


def test_vanished_ms_is_released_at_t3111(rig):
    """The MS goes silent once its REGISTER is out: LAPDm retransmits the
    accept every T200 (900 ms), and none of that restarts T3111, so the
    channel is freed at T3111 (2 s), not at N200·T200 (5.4 s)."""
    frames, rc_max, _ = released_after_lu(rig, lambda ms: rig.pump())
    t3111 = int(T3111_MS / 4.615)
    assert rc_max >= 2  # it retransmitted
    assert t3111 <= frames <= t3111 + 60, frames
    assert frames * 4.615 < 6 * 900


def test_slow_live_ms_is_not_cut(rig):
    """A live MS that acknowledges each I-frame only on its first
    retransmission drains the three I-frames in more than T3111, with
    each acknowledgement inside T3111 of the last: every one restarts
    it, and the channel is freed after the Channel Release is
    acknowledged, not cut at the deadline."""
    seen = set()

    def ms_step(ms):
        if not hasattr(ms, "_lossy"):
            deliver = ms.l2.write_low_side

            def lossy(frame):  # drop the first copy of each I-frame
                if frame.control_format() == ControlFormat.I:
                    key = (frame.ns(), frame.l3_part().tobytes())
                    if key not in seen:
                        seen.add(key)
                        return
                deliver(frame)

            ms.l2.write_low_side = ms._lossy = lossy
        ms.drive(1)

    frames, rc_max, ms = released_after_lu(rig, ms_step)
    assert rc_max >= 1 and len(seen) == 3
    assert frames > int(T3111_MS / 4.615), frames
    kinds = [type(m).__name__ for m in ms.got]
    assert kinds[-3:] == ["MMInformation", "LocationUpdatingAccept",
                          "ChannelRelease"], kinds
