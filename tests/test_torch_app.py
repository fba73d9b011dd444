"""The port's BTS application on the CPU (openbts_ttsou_tpu_torch/apps/
openbts.py and the stack under it): bring-up over the real control
sockets at one and two carriers, the CLI, the config-file-driven app,
SDCCH/8 slots, the spawned transceiver and the command-line entry point,
the device default, the import rule, and the L3 codecs against the JAX
package's (the CC message types as GSM 04.08 has them).

The cases of tests/test_app.py and tests/test_multiarfcn.py run here
against the port, each app with `device="cpu"`. UDP ports in
53400-53999: each rig's daemon at its base (53400, 53410, ...), its
app's TransceiverManager at base + 100.
"""

import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from openbts_ttsou_tpu.gsm.l3 import codec as jcodec
from openbts_ttsou_tpu_torch.apps.openbts import BTSApp
from openbts_ttsou_tpu_torch.gsm import channels, l1fec, tdma
from openbts_ttsou_tpu_torch.gsm.l3 import cc
from openbts_ttsou_tpu_torch.gsm.l3 import codec as pcodec
from openbts_ttsou_tpu_torch.gsm.l3 import parse_l3
from openbts_ttsou_tpu_torch.ops import gmsk
from openbts_ttsou_tpu_torch.trx.daemon import (SLOT_OFFSETS, TrxDaemon,
                                                TrxDaemonConfig)
from openbts_ttsou_tpu_torch.trx.radio import (DuplexLoopbackRadio,
                                               LoopbackRadio)
from openbts_ttsou_tpu_torch.utils import constants as C
from openbts_ttsou_tpu_torch.utils.config import ConfigurationTable

ROOT = Path(__file__).resolve().parents[1]
MULTI_PORT, RIG_PORT, C7_PORT, SPAWN_PORT, MAIN_PORT = (
    53400, 53410, 53420, 53430, 53440)
MAIN_SIP_PORT = 53600
AMPL = 9000.0


def serve(daemon):
    """Step `daemon` in a thread until the returned event is set."""
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            daemon.step()
            time.sleep(0.001)

    t = threading.Thread(target=loop, daemon=True)
    t.start()
    return stop, t


@pytest.fixture(scope="module")
def rig():
    daemon = TrxDaemon(LoopbackRadio(), TrxDaemonConfig(base_port=RIG_PORT,
                                                        device="cpu"))
    stop, t = serve(daemon)
    app = BTSApp(trx_base_port=RIG_PORT, device="cpu")
    yield app, daemon
    stop.set()
    t.join(timeout=2)
    app.shutdown()
    daemon.close()


def test_bringup_and_beacon(rig):
    app, daemon = rig
    assert app.bringup()
    assert daemon.on
    deadline = time.time() + 5
    while time.time() < deadline and app.bts.clock.fn() == 0:
        app.trx.poll_clock(timeout_ms=100)
    assert app.bts.clock.fn() > 0
    deadline = time.time() + 60
    while time.time() < deadline and daemon.fn == 0 and \
            len(daemon.pending_tx) == 0:
        app.step()
        time.sleep(0.005)
    assert len(daemon.pending_tx) > 0 or daemon.fn > 0


def test_cli_commands(rig):
    app, _ = rig
    p = app.parser
    assert "uptime" in p.process("help")
    assert "openbts-ttsou-tpu" in p.process("version")
    assert "frame number" in p.process("uptime")
    assert "SDCCH" in p.process("load")
    out = p.process("cellid 310 260 777 42")
    assert "LAC=777" in out and "CI=42" in out
    assert p.process("config GSM.Foo bar") == "set"
    assert "GSM.Foo bar" in p.process("config GSM.Foo")
    assert "paging" in p.process("page 001010123456789 5")
    assert "unknown command" in p.process("bogus")
    assert "usage" in p.process("page")
    assert "TN0" in p.process("chans")
    assert p.process("assignment") == "early"
    assert p.process("assignment veryearly") == "veryearly"
    assert "usage" in p.process("assignment sometimes")
    assert p.process("assignment early") == "early"
    assert p.process("shortname OpenBTS-TPU") == "OpenBTS-TPU"
    lac0 = app.bts.lac
    assert f"LAC={lac0 + 1}" in p.process("rolllac")
    assert "LAC=555" in p.process("rolllac 555")
    assert "(no matches)" in p.process("findimsi 99999")


def test_cli_sendsms_and_calls(rig):
    app, _ = rig
    out = app.parser.process("sendsms 001010123456789 100 hello there")
    assert "queued" in out
    assert "MobileTerminatedSMS" in app.parser.process("calls")
    tid = app.control.transactions.entries()[0].id
    assert "removed" in app.parser.process(f"endcall {tid}")


def test_config_file_driven_app():
    from openbts_ttsou_tpu_torch.gsm.btsconfig import BTSConfig

    cfg = ConfigurationTable(str(ROOT / "examples" / "openbts_tpu.config"))
    assert cfg.get_int("GSM.ARFCN") == 207
    assert cfg.is_static("GSM.ARFCN")
    bts = BTSConfig(cfg)
    assert bts.arfcn == 207 and bts.lac == 1000
    assert bts.bsic() == 2


def test_sdcch8_slots_from_config():
    """GSM.NumC7s builds SDCCH/8 sets on their own slots (combination
    VII), brought up over the control sockets."""
    daemon = TrxDaemon(LoopbackRadio(), TrxDaemonConfig(base_port=C7_PORT,
                                                        device="cpu"))
    cfg = ConfigurationTable()
    cfg.set("GSM.NumC7s", "1")
    cfg.set("GSM.NumTCH", "1")
    app = BTSApp(cfg, trx_base_port=C7_PORT, device="cpu")
    try:
        assert app.bts.sdcch_total() == 12  # 4 SDCCH/4 + 8 SDCCH/8
        assert sum(1 for ch in app.bts.sdcch_pool if ch.l1.tn == 1) == 8
        assert [t.tn for t in app.bts.tch_pool] == [2]
        stop, t = serve(daemon)
        try:
            assert app.bringup()
        finally:
            stop.set()
            t.join(timeout=2)
        assert int(daemon.state.chan_type[0, 1]) == 7
        assert int(daemon.state.chan_type[0, 2]) == 1
    finally:
        app.shutdown()
        daemon.close()


def test_sacch_si56_fill(rig):
    app, _ = rig
    ch = app.bts.get_sdcch()
    try:
        ch.open(app.bts.clock.fn())
        for _ in range(10):
            app.step()
            time.sleep(0.002)
        assert app._si56_flip >= 1
    finally:
        ch.l1.close()
        ch.sacch.close()
        app.bts.release(ch)


def test_ms_link_release_reclaims_channel(rig):
    from openbts_ttsou_tpu_torch.gsm.lapdm import LAPDState

    app, _ = rig
    free0 = app.bts.sdcch_available()
    ch = app.bts.get_sdcch()
    ch.open(app.bts.clock.fn())
    ch.l2[0].state = LAPDState.LinkEstablished
    app.step()
    ch.l2[0].state = LAPDState.LinkReleased
    app.step()
    assert app.bts.sdcch_available() == free0
    assert not ch.l1.active


def test_inbound_sip_message_and_invite_hooks(rig):
    from openbts_ttsou_tpu_torch.control.common import ServiceType
    from openbts_ttsou_tpu_torch.sip.message import make_request

    app, _ = rig
    imsi = "001019999999999"
    msg = make_request("MESSAGE", f"IMSI{imsi}", "411", "127.0.0.1",
                       5062, "127.0.0.1", 5060, body="mt text")
    app._on_message(msg)
    t = app.control.transactions.find_by_imsi(
        imsi, services=(ServiceType.MobileTerminatedSMS,))
    assert t is not None and t.message == "mt text"
    assert app.bts.pager.size() >= 1
    app.control.transactions.remove(t.id)
    inv = make_request("INVITE", f"IMSI{imsi}", "2125550000",
                       "127.0.0.1", 5062, "127.0.0.1", 5060)
    app._on_invite(inv)
    t = app.control.transactions.find_by_imsi(
        imsi, services=(ServiceType.MobileTerminatedCall,))
    assert t is not None and t.calling == "2125550000"
    assert t.sip is not None
    t.sip.close()
    app.control.transactions.remove(t.id)


def test_very_early_assignment(rig):
    from openbts_ttsou_tpu_torch.gsm.l3 import rr
    from openbts_ttsou_tpu_torch.utils.gsm_time import Time

    app, _ = rig
    app.parser.process("assignment veryearly")
    ch = None
    try:
        ch = app.control.handle_rach(0x05, Time(1000, 0), -50.0, 1.0)
        assert ch is not None and ch.is_tch and ch.l1.active
        msg = parse_l3(np.asarray(app.bts.agch_q[-1].bits))
        assert isinstance(msg, rr.ImmediateAssignment)
        assert msg.channel.type_and_offset == 1
        assert msg.channel.tn == ch.l1.tn
    finally:
        if ch is not None:
            ch.l1.close()
            app.bts.release(ch)
        app.parser.process("assignment early")


def test_facch_transaction_binding(rig):
    from openbts_ttsou_tpu_torch.control.common import ServiceType
    from openbts_ttsou_tpu_torch.gsm.l3 import rr

    app, _ = rig
    ctl = app.control
    sd = app.bts.get_sdcch()
    t = ctl.transactions.new(ServiceType.MobileOriginatedCall,
                             imsi="001010000000099")
    ctl.channel_transactions[id(sd)] = t.id
    ctl.assign_tch(sd, t)
    assert ctl.channel_transactions[id(t.tch)] == t.id
    ctl.assignment_complete(t.tch, rr.AssignmentComplete())
    assert t.tch.l1.active
    t.tch.l1.close()
    app.bts.release(t.tch)
    app.bts.release(sd)


class DaemonClock:
    def __init__(self, daemon):
        self.daemon = daemon

    def fn(self):
        return self.daemon.tx_fn

    def set_fn(self, fn):
        pass


def test_two_carrier_bts_over_the_air():
    """tests/test_multiarfcn.py on the port: a 2-carrier BTSApp brought up
    over the per-carrier control sockets of the port's N-carrier daemon,
    an over-the-air RACH granted on carrier 0 and TCH/FS speech decoded
    on carrier 1."""
    from openbts_ttsou_tpu_torch.trx import engine as eng

    radios = [DuplexLoopbackRadio(), DuplexLoopbackRadio()]
    daemon = TrxDaemon(radios, TrxDaemonConfig(base_port=MULTI_PORT,
                                               n_arfcn=2, device="cpu"))
    cfg = ConfigurationTable()
    cfg.set("GSM.NumARFCNs", "2")
    cfg.set("GSM.NumTCH", "9")  # C0 TN1-7, then carrier 1 TN0-1
    cfg.set("GSM.Timer.T3101", "600000")
    cfg.set("GSM.Timer.T3109", "600000")
    app = BTSApp(cfg, trx_base_port=MULTI_PORT, device="cpu")
    try:
        app.bts.clock = DaemonClock(daemon)
        for ch in app.dcch:
            ch.l1.clock = ch.sacch.clock = app.bts.clock.fn
        assert app.n_arfcn == 2
        assert sorted({app._carrier_of(t) for t in app.bts.tch_pool}) == \
            [0, 1]
        # one frame first: the engine's first step is its slowest
        daemon.carrier_on = [True, True]
        daemon.step_frame()
        daemon.carrier_on = [False, False]
        daemon.state = eng.init_state(daemon.engine_cfg, daemon.device)
        daemon.fn = daemon.cfg.start_fn
        daemon.tx_fn = daemon.cfg.start_fn + daemon.cfg.tx_latency_frames
        stop, t = serve(daemon)
        try:
            assert app.bringup(), "multi-carrier bring-up failed"
        finally:
            stop.set()
            t.join(timeout=2.0)
        assert daemon.carrier_on == [True, True]
        assert daemon.rx_freq == [890000e3, 890200e3]
        ct = daemon.state.chan_type.numpy()
        assert ct[0, 0] == 5 and ct[1, 0] == 1

        def pump(n=1):
            for _ in range(n):
                daemon.step()
                app.step()

        pump(5)
        fn_r = daemon.fn + 8
        while fn_r % 51 not in range(14, 37):
            fn_r += 1
        coded = l1fec.rach_encode(torch.tensor([0x2A]),
                                  torch.tensor(app.bts.bcc)).numpy()[0]
        bits = np.zeros(148, np.uint8)
        bits[:8] = [0, 1, 0, 1, 0, 1, 0, 1]
        bits[8:49] = C.RACH_SYNCH_SEQUENCE
        bits[49:85] = coded
        radios[0].ms_write(AMPL * gmsk.modulate_burst_np(
            bits[None], 1, guard_len=9)[0], daemon._frame_ts(fn_r))
        for _ in range(60):
            pump()
            if app.bts.sdcch_available() < app.bts.sdcch_total():
                break
        assert app.bts.sdcch_available() < app.bts.sdcch_total(), \
            "carrier-0 RACH not granted"

        tch = next(t for t in app.bts.tch_pool if app._carrier_of(t) == 1)
        tn = tch.l1.tn
        tch.l1.open(daemon.tx_fn)
        tch.l1.resync(daemon.tx_fn)
        ms = channels.TCHFACCHL1(tn, tdma.FACCH_TCHF, tdma.FACCH_TCHF,
                                 tsc=app.bts.bcc, device="cpu")
        ms.open(0)
        ms.next_write_fn = ms._align_block_start(daemon.fn + 6, modulus=8)
        rng = np.random.default_rng(5)
        payloads = [rng.integers(0, 2, 260).astype(np.uint8)
                    for _ in range(4)]
        for pl in payloads:
            ms.send_tch(pl)
        for _ in range(4):
            ms.dispatch_block()
        for b in ms.tx_queue:
            radios[1].ms_write(AMPL * gmsk.modulate_burst_np(
                b.bits[None], 1, guard_len=9)[0],
                daemon._frame_ts(b.fn) + int(SLOT_OFFSETS[tn]))
        last_fn = max(b.fn for b in ms.tx_queue)
        while daemon.fn <= last_fn + 2:
            pump()
        assert len(tch.l1.speech_out) >= 2, "no voice decoded on carrier 1"
        np.testing.assert_array_equal(tch.l1.speech_out[0], payloads[0])
    finally:
        app.shutdown()
        daemon.close()


def test_restart_transceiver_spawns_the_port_daemon():
    """BTSApp(spawn_transceiver=True) starts `python -m
    openbts_ttsou_tpu_torch.trx.daemon --device cpu` as a child that
    answers bring-up; shutdown reaps it."""
    app = BTSApp(trx_base_port=SPAWN_PORT, spawn_transceiver=True,
                 device="cpu")
    child = app.trx_child
    try:
        assert child.args[1:3] == ["-m", "openbts_ttsou_tpu_torch.trx.daemon"]
        assert child.args[child.args.index("--device") + 1] == "cpu"
        deadline = time.monotonic() + 90
        while app.trx.arfcn(0).send_command("POWEROFF", retries=1) is None:
            assert child.poll() is None, "the daemon child exited"
            assert time.monotonic() < deadline, "the child never answered"
        assert app.bringup()
        assert app.trx.poll_clock(timeout_ms=2000)
        assert app.bts.clock.fn() > 0
    finally:
        app.shutdown()
    assert child.poll() is not None


def test_command_line_entry_point(tmp_path):
    """`python -m openbts_ttsou_tpu_torch.apps.openbts --device cpu
    --spawn-trx`: the app spawns the port's daemon, brings it up, serves
    its CLI until stdin closes, and reaps the child."""
    cfg = tmp_path / "bts.config"
    cfg.write_text((ROOT / "examples" / "openbts_tpu.config").read_text()
                   + f"\nSIP.Port {MAIN_SIP_PORT}\n")
    out = subprocess.run(
        [sys.executable, "-m", "openbts_ttsou_tpu_torch.apps.openbts",
         "--device", "cpu", "--spawn-trx", "--trx-port", str(MAIN_PORT),
         "--config", str(cfg)], cwd=ROOT, stdin=subprocess.DEVNULL,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "ready" in out.stdout


def test_entry_points_default_to_cuda(monkeypatch):
    """Without CUDA, BTSApp and every L1 channel raise unless given the
    CPU; nothing falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BTSApp(trx_base_port=53450)
    dl, ul = tdma.SDCCH_4[0]
    for make in (lambda: channels.XCCHL1(0, dl, ul),
                 lambda: channels.SACCHL1(0, dl, ul),
                 lambda: channels.CCCHL1(0, dl, ul),
                 lambda: channels.TCHFACCHL1(2, tdma.FACCH_TCHF,
                                             tdma.FACCH_TCHF),
                 lambda: channels.RACHL1(0, 2, lambda *a: None),
                 lambda: channels.SCHL1(2), channels.FCCHL1):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert channels.SCHL1(2, device="cpu").device.type == "cpu"


def test_command_line_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without CUDA")
    out = subprocess.run(
        [sys.executable, "-m", "openbts_ttsou_tpu_torch.apps.openbts",
         "--trx-port", "53460"], cwd=ROOT, stdin=subprocess.DEVNULL,
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr


def test_bts_stack_imports_no_jax():
    """The new subpackages import torch and numpy, never jax or the JAX
    package."""
    mods = ["openbts_ttsou_tpu_torch.apps.openbts",
            "openbts_ttsou_tpu_torch.cli",
            "openbts_ttsou_tpu_torch.control.procedures",
            "openbts_ttsou_tpu_torch.control.voice",
            "openbts_ttsou_tpu_torch.sip.interface",
            "openbts_ttsou_tpu_torch.sms.messages",
            "openbts_ttsou_tpu_torch.gsm.channels",
            "openbts_ttsou_tpu_torch.gsm.trxmanager",
            "openbts_ttsou_tpu_torch.gsm.btsconfig",
            "openbts_ttsou_tpu_torch.gsm.lapdm",
            "openbts_ttsou_tpu_torch.gsm.l3",
            "openbts_ttsou_tpu_torch.gsm.gsm610",
            "openbts_ttsou_tpu_torch.utils.gsmtap",
            "openbts_ttsou_tpu_torch.utils.logger"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith(('jax.', 'jaxlib', 'openbts_ttsou_tpu.')) or "
            "k == 'openbts_ttsou_tpu')\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr


# ---- L3: the CC message types, and parity with the JAX codecs ---------------

# GSM 04.08 Table 10.3 (the reference's GSML3CCMessages.h): the message
# types of the CC messages both packages implement
CC_TYPES = {"Alerting": 0x01, "CallProceeding": 0x02, "Progress": 0x03,
            "Setup": 0x05, "Connect": 0x07, "CallConfirmed": 0x08,
            "EmergencySetup": 0x0E, "ConnectAcknowledge": 0x0F,
            "Hold": 0x18, "HoldReject": 0x1A, "Disconnect": 0x25,
            "ReleaseComplete": 0x2A, "Release": 0x2D, "StopDTMF": 0x31,
            "StopDTMFAck": 0x32, "StartDTMF": 0x35, "StartDTMFAck": 0x36,
            "CCStatus": 0x3D}
# the three the JAX package gets wrong and keeps (ROADMAP Queue 3)
JAX_CC_FAULTS = {"HoldReject": 0x19, "StartDTMFAck": 0x32,
                 "StopDTMFAck": 0x33}


def cc_classes(codec_module):
    return {cls.__name__: cls for (pd, _), cls in
            codec_module._REGISTRY.items() if pd == int(cc.CCMessage.PD)}


@pytest.mark.parametrize("name,mti", sorted(CC_TYPES.items()))
def test_cc_message_types_follow_gsm_0408(name, mti):
    cls = cc_classes(pcodec)[name]
    assert cls.MTI == mti
    msg = cls()
    msg.ti = 0x3
    bits = msg.encode()
    assert int("".join(map(str, bits[8:16])), 2) == mti
    back = parse_l3(bits)
    assert type(back) is cls and back.ti == 0x3


def test_each_cc_code_names_one_class():
    classes = cc_classes(pcodec)
    assert set(classes) == set(CC_TYPES)  # StartDTMFReject (0x37) not yet
    codes = [cls.MTI for cls in classes.values()]
    assert len(codes) == len(set(codes))
    with pytest.raises(ValueError, match="HoldReject"):
        pcodec.register(type("Bogus", (cc.CCMessage,), {"MTI": 0x1A}))


def test_jax_package_keeps_its_cc_types():
    """The JAX package is the reference and stays as it is; its three
    faulty types are recorded in ROADMAP Queue 3."""
    classes = cc_classes(jcodec)
    for name, mti in JAX_CC_FAULTS.items():
        assert classes[name].MTI == mti
    for name, mti in CC_TYPES.items():
        if name not in JAX_CC_FAULTS:
            assert classes[name].MTI == mti


def default_messages():
    """Every L3 message class registered in both packages that builds
    without arguments, except the CC hold and DTMF ones whose types the
    port corrects."""
    out = []
    for key, jcls in sorted(jcodec._REGISTRY.items(),
                            key=lambda kv: (kv[0][0], kv[0][1])):
        if jcls.__name__ in JAX_CC_FAULTS:
            continue
        try:
            jcls()
        except TypeError:
            continue
        out.append((jcls.__name__, key))
    return out


@pytest.mark.parametrize("name,key", default_messages())
def test_l3_encodes_as_jax(name, key):
    pcls = {c.__name__: c for c in pcodec._REGISTRY.values()}[name]
    jmsg = jcodec._REGISTRY[key]()
    pmsg = pcls()
    np.testing.assert_array_equal(pmsg.encode(), jmsg.encode())
    assert type(parse_l3(pmsg.encode())) is pcls
