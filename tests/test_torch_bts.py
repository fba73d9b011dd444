"""The BTS as a whole on the CPU: the port's BTSApp against the JAX
package's, and the port's over-the-air scenarios.

(a) An uplink is recorded from the port's over-the-air rig (an MS's
    location update, then an MO call set up to Connect): for every step
    of the app, the BTS clock's frame number, the uplink bursts the app
    received (`ARFCNManager.receive_burst`) and the SIP responses the
    test injected before it. The same sequence then drives a fresh JAX
    `BTSApp` and a fresh port `BTSApp(device="cpu")` with the clock
    stepped alike; both must hand the transceiver the same downlink
    bursts (fn, tn, bits), send the same SIP messages (`random` seeded
    alike; the RTP port the OS picks is masked) and route the same L3
    messages to Control. The JAX side runs its FEC only, no DSP.
(b) The location update, a voice call with speech both ways and an MT
    SMS over the air through the port's own `TrxDaemon(device="cpu")`,
    asserting what tests/test_e2e_lur.py asserts.

The rig and the simulated MS are chip_smoke.py's (phase 13 runs the
same scenarios on the card). UDP ports in 53000-53399: each rig's
daemon at its base (53000, 53010, ...), its app's TransceiverManager at
base + 100.
"""

import random
import re

import numpy as np
import pytest

import chip_smoke as cs
from openbts_ttsou_tpu.apps import openbts as japp
from openbts_ttsou_tpu.gsm import transfer as jtr
from openbts_ttsou_tpu.sip import message as jsip
from openbts_ttsou_tpu.utils import config as jconfig
from openbts_ttsou_tpu_torch.apps import openbts as papp
from openbts_ttsou_tpu_torch.control.common import ServiceType
from openbts_ttsou_tpu_torch.gsm import transfer as ptr
from openbts_ttsou_tpu_torch.gsm.l3 import cc, mm
from openbts_ttsou_tpu_torch.gsm.l3 import common as l3c
from openbts_ttsou_tpu_torch.sip import message as psip
from openbts_ttsou_tpu_torch.utils import config as pconfig

RECORD_PORT = 53000
REPLAY_PORTS = {"port": 53010, "jax": 53020}
OTA_PORT = 53030


def config(module):
    """chip_smoke.bts_config() in the given package's ConfigurationTable:
    every C0 timeslot equipped, the recycling timers out of the way."""
    cfg = module.ConfigurationTable(str(cs.ROOT / "examples" /
                                        "openbts_tpu.config"))
    for key, value in cs.BTS_SETTINGS:
        cfg.set(key, value)
    return cfg


def to_tag(msg) -> str | None:
    m = re.search(r"tag=([^;>]+)", msg.get("to") or "")
    return m.group(1) if m else None


def mo_call_setup(rig) -> None:
    """tests/test_e2e_lur.py::test_over_the_air_mo_call up to Connect:
    RACH → CM Service Request → Setup → (INVITE) → 180 → Alerting →
    200 OK → Connect, every message over the air."""
    app = rig.app
    ms = cs.SimMS(rig)
    ms.access(0x17, mm.CMServiceRequest(
        service_type=1, identity=l3c.MobileIdentity.imsi(cs.BTS_IMSI)))
    assert ms.drive(140, mm.CMServiceAccept) is not None, ms.got
    ms.send_l3(cc.Setup(cc.CalledPartyBCDNumber("2125551212")))
    assert ms.drive(160, cc.CallProceeding) is not None or any(
        isinstance(m, cc.CallProceeding) for m in ms.got), ms.got
    invite = next(m for m in map(psip.SIPMessage.parse, rig.sip_out)
                  if m.method == "INVITE")
    assert "2125551212" in invite.uri
    t = app.control.transactions.find_by_imsi(
        cs.BTS_IMSI, services=(ServiceType.MobileOriginatedCall,))
    app.control.on_sip_response(t, ms.channel, psip.make_response(
        invite, 180, "Ringing", to_tag="rr"))
    assert ms.drive(160, cc.Alerting) is not None, ms.got
    app.control.on_sip_response(t, ms.channel, psip.make_response(
        invite, 200, "OK", to_tag="rr",
        body=psip.make_sdp("127.0.0.1", 40002)))
    assert ms.drive(160, cc.Connect) is not None, ms.got


@pytest.fixture(scope="module")
def session():
    """The recorded uplink, and what the port's rig sent while recording
    it (downlink bursts, SIP messages)."""
    random.seed(5)
    rig = cs.BtsRig("cpu", RECORD_PORT, config(pconfig))
    app = rig.app
    steps, pending, cur = [], [], []
    arfcn = app.trx.arfcn(0)
    receive, step = arfcn.receive_burst, app.step
    respond, send = app.control.on_sip_response, app.control.sip_send
    channels = list(app.dcch) + list(app.bts.tch_pool)
    sip = []

    def receive_logged(b):
        cur.append((np.asarray(b.soft, np.float32).copy(), b.fn, b.tn,
                    b.rssi, b.timing_error))
        receive(b)

    def step_logged():
        cur.clear()
        fn = app.bts.clock.fn()
        step()
        steps.append((fn, list(cur), list(pending)))
        pending.clear()

    def respond_logged(t, ch, msg):
        pending.append((app.control.transactions.entries().index(t),
                        channels.index(ch), msg.status, msg.reason,
                        to_tag(msg), msg.body, msg.get("cseq").split()[1]))
        respond(t, ch, msg)

    def send_logged(data):
        sip.append(data)
        send(data)

    arfcn.receive_burst = receive_logged
    app.step = step_logged
    app.control.on_sip_response = respond_logged
    app.control.sip_send = send_logged
    rig.record()
    try:
        cs.ota_location_update(rig)
        mo_call_setup(rig)
    finally:
        rig.close()
    return {"steps": steps, "bursts": rig.bursts, "l3": [
        x[1:] for x in rig.l3 if x[0] == "bts"], "sip": sip}


def replay(package: str, session) -> dict:
    """Drive a fresh BTSApp of `package` with the recorded uplink."""
    app_mod, tr, sip_mod, cfg_mod = {
        "jax": (japp, jtr, jsip, jconfig),
        "port": (papp, ptr, psip, pconfig)}[package]
    kw = {"device": "cpu"} if package == "port" else {}
    app = app_mod.BTSApp(config(cfg_mod), trx_base_port=REPLAY_PORTS[package],
                         **kw)
    clock = cs.DaemonClock(None)
    now = [0]
    clock.fn = lambda: now[0]
    app.bts.clock = clock
    for ch in app.dcch:
        ch.l1.clock = ch.sacch.clock = clock.fn
    for tch in app.bts.tch_pool:
        tch.l1.clock = clock.fn
    sip, bursts, l3 = [], [], []
    app.control.sip_send = sip.append
    arfcn = app.trx.arfcn(0)
    arfcn.write_high_side = lambda b, gain_db=0: bursts.append(
        (b.fn, b.tn, np.asarray(b.bits, np.uint8).tobytes()))
    dispatch = app.control.dispatch_l3

    def dispatch_logged(ch, bits):
        l3.append((now[0], np.asarray(bits, np.uint8).tobytes()))
        dispatch(ch, bits)

    app.control.dispatch_l3 = dispatch_logged
    channels = list(app.dcch) + list(app.bts.tch_pool)
    random.seed(9)
    try:
        for fn, rx, actions in session["steps"]:
            now[0] = fn
            for ti, ci, status, reason, tag, body, method in actions:
                req = [m for m in map(sip_mod.SIPMessage.parse, sip)
                       if m.method == method][-1]
                app.control.on_sip_response(
                    app.control.transactions.entries()[ti], channels[ci],
                    sip_mod.make_response(req, status, reason, to_tag=tag,
                                          body=body))
            for soft, bfn, tn, rssi, te in rx:
                arfcn.receive_burst(tr.RxBurst(soft, fn=bfn, tn=tn, rssi=rssi,
                                               timing_error=te))
            app.step()
    finally:
        app.shutdown()
    return {"bursts": bursts, "l3": l3, "sip": [
        re.sub(rb"m=audio \d+", b"m=audio *", m) for m in sip]}


@pytest.fixture(scope="module")
def replays(session):
    return {p: replay(p, session) for p in ("port", "jax")}


def test_recorded_session_covers_lur_and_call_setup(session):
    names = [psip.SIPMessage.parse(m).method for m in session["sip"]]
    assert names[:1] == ["REGISTER"] and "INVITE" in names
    assert len(session["steps"]) > 400
    assert sum(len(rx) for _, rx, _ in session["steps"]) > 20
    assert len(session["l3"]) >= 3  # LUR, CM Service Request, Setup


def test_port_replay_reproduces_the_recording(session, replays):
    """The replay harness is faithful: the port's app, fed the recorded
    uplink, sends what it sent over the air."""
    assert replays["port"]["bursts"] == session["bursts"]
    assert replays["port"]["l3"] == session["l3"]


def test_downlink_bursts_equal_jax(replays):
    got, want = replays["port"]["bursts"], replays["jax"]["bursts"]
    assert len(want) > 300
    assert got == want


def test_l3_to_control_equal_jax(replays):
    assert replays["port"]["l3"] == replays["jax"]["l3"]


def test_sip_messages_equal_jax(replays):
    got, want = replays["port"]["sip"], replays["jax"]["sip"]
    assert [psip.SIPMessage.parse(m).method for m in want][:1] == \
        ["REGISTER"]
    assert got == want


# ---- (b) over the air through the port's daemon -----------------------------

@pytest.fixture(scope="module")
def rig():
    random.seed(1)
    r = cs.BtsRig("cpu", OTA_PORT, config(pconfig))
    yield r
    r.close()


@pytest.fixture(autouse=True)
def _reclaim(request):
    yield
    if "rig" in request.fixturenames:
        request.getfixturevalue("rig").reclaim()


def test_ota_location_update(rig):
    out = cs.ota_location_update(rig)
    assert rig.app.control.tmsis.imsi(out["tmsi"]) == cs.BTS_IMSI


def test_ota_voice_call_with_speech(rig):
    out = cs.ota_voice_call(rig, 6)
    assert out["speech_up"] >= 5 and out["speech_down"] >= 5
    assert any(t.tn == out["tch_tn"] for t in rig.app.bts.tch_pool)


def test_ota_mt_sms(rig):
    out = cs.ota_mt_sms(rig)
    assert out["text"] == "wake up neo"
