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
    """Every module of the port (walked with pkgutil, so later modules are
    covered too: the BTS stack, the sharded pipelines and their entry
    points, smqueue, the utilities and the tools) imports torch and
    numpy, never jax or the JAX package; and the native runtime it loads
    is its own build, no library under the JAX package's `native/`."""
    code = ("import importlib, pkgutil, sys\n"
            "import openbts_ttsou_tpu_torch as pkg\n"
            "mods = [m.name for m in pkgutil.walk_packages(\n"
            "    pkg.__path__, pkg.__name__ + '.')]\n"
            "for m in mods:\n"
            "    importlib.import_module(m)\n"
            "need = {'openbts_ttsou_tpu_torch.tools.daemon_soak',\n"
            "        'openbts_ttsou_tpu_torch.bench',\n"
            "        'openbts_ttsou_tpu_torch.entry',\n"
            "        'openbts_ttsou_tpu_torch.tools.bench_sweep',\n"
            "        'openbts_ttsou_tpu_torch.tools.roofline',\n"
            "        'openbts_ttsou_tpu_torch.tools.collective_inventory',\n"
            "        'openbts_ttsou_tpu_torch.tools.scaling_2proc',\n"
            "        'openbts_ttsou_tpu_torch.runtime.native',\n"
            "        'openbts_ttsou_tpu_torch.smqueue.__main__',\n"
            "        'openbts_ttsou_tpu_torch.parallel.worker'}\n"
            "assert need <= set(mods), need - set(mods)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith(('jax.', 'jaxlib', 'openbts_ttsou_tpu.')) or "
            "k == 'openbts_ttsou_tpu')\n"
            "assert not bad, bad\n"
            "from openbts_ttsou_tpu_torch.runtime import UdpTransport\n"
            "UdpTransport(0).close()\n"
            f"jax_native = {str(ROOT / 'native')!r} + '/'\n"
            "maps = open('/proc/self/maps').read()\n"
            "assert 'build/native/libtrx_runtime.so' in maps\n"
            "assert jax_native not in maps, jax_native\n"
            "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 83


# ---- L3: the CC message types, and parity with the JAX codecs ---------------

# GSM 04.08 Table 10.3 (the reference's GSML3CCMessages.h): the message
# types of the CC messages both packages implement
CC_TYPES = {"Alerting": 0x01, "CallProceeding": 0x02, "Progress": 0x03,
            "Setup": 0x05, "Connect": 0x07, "CallConfirmed": 0x08,
            "EmergencySetup": 0x0E, "ConnectAcknowledge": 0x0F,
            "Hold": 0x18, "HoldReject": 0x1A, "Disconnect": 0x25,
            "ReleaseComplete": 0x2A, "Release": 0x2D, "StopDTMF": 0x31,
            "StopDTMFAck": 0x32, "StartDTMF": 0x35, "StartDTMFAck": 0x36,
            "StartDTMFReject": 0x37, "CCStatus": 0x3D}
# the three the JAX package gets wrong and keeps, and the one it lacks
# (ROADMAP Queue 3)
JAX_CC_FAULTS = {"HoldReject": 0x19, "StartDTMFAck": 0x32,
                 "StopDTMFAck": 0x33}
JAX_CC_MISSING = {"StartDTMFReject"}


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
    assert set(classes) == set(CC_TYPES)
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
        if name in JAX_CC_MISSING:
            assert name not in classes
        elif name not in JAX_CC_FAULTS:
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


# ---- the DTMF relay: Start DTMF Acknowledge only when the INFO is answered

class _Channel:
    """A dedicated channel that records what Control sends down it."""

    def __init__(self):
        self.l1 = type("L1", (), {"tn": 1, "subchannel": 0})()
        self.sent = []

    def send(self, l3, sapi=0):
        self.sent.append((l3, sapi))

    def open(self, fn=0):
        pass


class _Proxy:
    """A SIP proxy on a UDP socket beside a real SIPInterface: it reads
    what the BTS sends and answers only when told to."""

    def __init__(self, port):
        import socket

        from openbts_ttsou_tpu_torch.sip.interface import SIPInterface

        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", port))
        self.sock.settimeout(2.0)
        self.iface = SIPInterface(local_port=port + 1, proxy_port=port)

    def recv(self):
        from openbts_ttsou_tpu_torch.sip.message import SIPMessage

        return SIPMessage.parse(self.sock.recvfrom(65536)[0])

    def send(self, msg):
        self.sock.sendto(msg.render(), ("127.0.0.1", self.iface.local_port))

    def close(self):
        self.iface.sock.close()
        self.sock.close()


@pytest.mark.parametrize("answer", [200, 486, "silence", "no reader"])
def test_start_dtmf_acks_only_a_relayed_key(answer):
    """CallControl.cpp:332: the key goes out as SIP INFO; a 200 to it
    gets Start DTMF Acknowledge (0x36) with the key, anything else (an
    error, silence past SIP.Timer.A, no way to hear an answer) Start
    DTMF Reject (0x37, cause 0x3f). Control does not wait in start_dtmf:
    dtmf_tick settles the relay from the call's SIP FIFO, and leaves
    the call's other messages there."""
    from openbts_ttsou_tpu_torch.control.procedures import ControlLayer
    from openbts_ttsou_tpu_torch.gsm.btsconfig import BTSConfig
    from openbts_ttsou_tpu_torch.gsm.l3 import common, mm
    from openbts_ttsou_tpu_torch.sip.message import (make_request,
                                                     make_response)

    proxy = _Proxy(54010)
    try:
        iface = proxy.iface
        ctl = ControlLayer(BTSConfig(), sip_send=iface.send,
                           sip_fifos=None if answer == "no reader" else iface)
        if answer == "silence":
            ctl.bts.config.set("SIP.Timer.A", 300)
        ch = _Channel()
        ctl.bts.add_sdcch(ch)
        ctl.bts.get_sdcch()
        ctl.dispatch_l3(ch, mm.CMServiceRequest(
            service_type=1,
            identity=common.MobileIdentity.imsi("001010123456789")).encode())
        ctl.dispatch_l3(ch, cc.Setup(cc.CalledPartyBCDNumber("100"))
                        .encode())
        assert proxy.recv().method == "INVITE"
        ch.sent.clear()
        t0 = time.monotonic()
        ctl.dispatch_l3(ch, cc.StartDTMF("7").encode())
        assert time.monotonic() - t0 < 0.1  # no wait for the proxy
        if answer == "no reader":  # no INFO goes out, the key is refused
            import socket

            proxy.sock.settimeout(0.2)
            with pytest.raises(socket.timeout):
                proxy.recv()
        else:
            info = proxy.recv()
            assert info.method == "INFO" and "Signal=7" in info.body
            assert not ch.sent
            relay, = ctl.pending_dtmf
            timer_s = 0.3 if answer == "silence" else 2.0  # Timer A default
            assert timer_s <= relay.deadline - t0 < timer_s + 0.1
            assert iface.fifo_size(info.call_id()) == 0
        if isinstance(answer, int):  # the proxy's BYE first: it stays queued
            bye = make_request("BYE", "IMSI001010123456789", "100",
                               "127.0.0.1", iface.local_port, "127.0.0.1",
                               proxy.sock.getsockname()[1],
                               call_id=info.call_id(), cseq=1, from_tag="p")
            proxy.send(bye)
            proxy.send(make_response(info, answer, "Reason"))
        while not ch.sent and time.monotonic() - t0 < 3.0:
            iface.drive(timeout_ms=10)
            ctl.dtmf_tick()
        (l3, sapi), = ch.sent
        assert not ctl.pending_dtmf
        out = parse_l3(l3.bits)
        if answer == 200:
            assert type(out) is cc.StartDTMFAck and out.key == "7"
        else:
            assert type(out) is cc.StartDTMFReject and out.cause.value == 0x3F
            assert int("".join(map(str, l3.bits[8:16])), 2) == 0x37
        assert out.ti >> 3 == 1 and sapi == 0  # toward the originating MS
        if answer == "silence":
            assert time.monotonic() - t0 >= 0.3
        if isinstance(answer, int):
            left = iface.read(info.call_id())
            assert left is not None and left.method == "BYE"
    finally:
        proxy.close()


def test_sip_interface_take_leaves_other_messages():
    """SIPInterface.take, where the DTMF relay finds its answer: the
    first message of the call that matches, the others left in order,
    other calls untouched; add_call says whether it opened the FIFO."""
    from openbts_ttsou_tpu_torch.sip.engine import SIPEngine
    from openbts_ttsou_tpu_torch.sip.message import make_request, make_response

    proxy = _Proxy(54012)
    try:
        iface = proxy.iface
        assert iface.add_call("call-a") and not iface.add_call("call-a")
        iface.add_call("call-b")
        req = make_request("INFO", "100", "IMSI1", "127.0.0.1", 54012,
                           "127.0.0.1", 54013, call_id="call-a", cseq=7,
                           from_tag="x", body="Signal=1\r\n")
        other = make_request("INFO", "100", "IMSI1", "127.0.0.1", 54012,
                             "127.0.0.1", 54013, call_id="call-b", cseq=7,
                             from_tag="y")
        for m in (make_response(req, 100, "Trying"),
                  make_response(other, 200, "OK"),
                  make_response(req, 200, "OK")):
            proxy.send(m)
        deadline = time.monotonic() + 2.0
        while iface.fifo_size("call-a") < 2 and time.monotonic() < deadline:
            iface.drive(timeout_ms=10)

        def answer(m):
            return SIPEngine.dtmf_answer(m, 7) is not None

        got = iface.take("call-a", answer)
        assert got.status == 200 and got.cseq() == (7, "INFO")
        assert SIPEngine.dtmf_answer(got, 7) is True
        assert iface.take("call-a", answer) is None
        left = iface.read("call-a")
        assert left.status == 100 and SIPEngine.dtmf_answer(left, 7) is None
        assert iface.fifo_size("call-b") == 1
        assert SIPEngine.dtmf_answer(make_response(req, 486, "Busy"), 7) \
            is False
        assert SIPEngine.dtmf_answer(make_response(req, 200, "OK"), 8) is None
    finally:
        proxy.close()


# ---- the deferred release counts acknowledged LAPDm progress only -----------

class _LapdmChannel:
    """An SDCCH reduced to its SAPI-0 LAPDm entity and an L1 that takes
    downlink frames only when `take()` is called (the SDCCH sends one
    block a multiframe), so a retransmission can wait in the L2 queue
    when Control looks."""

    def __init__(self):
        from openbts_ttsou_tpu_torch.gsm.lapdm import L2LAPDm

        self.l1 = type("L1", (), {"tn": 1, "subchannel": 0,
                                  "active": True})()
        self.l2 = {0: L2LAPDm(c=1, sapi=0)}
        self.released = False

    def send(self, l3, sapi=0):
        self.l2[sapi].write_high_side(l3)

    def take(self):
        return self.l2[0].take_l1_out()

    def tx_drained(self):
        return self.l2[0].tx_drained()

    def tx_depth(self):
        return self.l2[0].tx_depth()

    def tx_progress(self):
        return self.l2[0].tx_progress()

    def reset(self):
        self.released = True


def _released_channel():
    from openbts_ttsou_tpu_torch.control.procedures import ControlLayer
    from openbts_ttsou_tpu_torch.gsm.btsconfig import BTSConfig
    from openbts_ttsou_tpu_torch.gsm.lapdm import LAPDState
    from openbts_ttsou_tpu_torch.gsm.l3 import mm
    from openbts_ttsou_tpu_torch.gsm.transfer import L3Frame, Primitive

    fn = [1000]
    bts = BTSConfig()
    bts.clock = type("Clock", (), {"fn": lambda self: fn[0]})()
    ctl = ControlLayer(bts)
    ch = _LapdmChannel()
    bts.add_sdcch(ch)
    bts.get_sdcch()
    l2 = ch.l2[0]
    l2.state = LAPDState.LinkEstablished  # the MS's SABM was answered
    ch.send(L3Frame(mm.LocationUpdatingAccept(bts.lai()).encode(),
                    Primitive.DATA))
    ctl._release_channel(ch)  # queues Channel Release behind the accept
    assert ctl.pending_release and not ch.tx_drained()
    return ctl, ch, l2, fn


def test_retransmission_does_not_restart_t3111():
    """A vanished MS: LAPDm re-enqueues the outstanding I-frame every
    T200 and L1 takes it only at the next block, so Control sees the
    queue's depth move; that is no acknowledgement, and the channel is
    hard-released at T3111 (GSM.Timer.T3111, 2 s by default)."""
    ctl, ch, l2, fn = _released_channel()
    progress, depths = l2.tx_progress(), set()
    t3111 = int(2000 / 4.615)
    for k in range(1, 2 * t3111):
        fn[0] += 1
        l2.tick(int(k * 4.615))  # T200 runs on the frame clock
        depths.add(ch.tx_depth())
        ctl.release_tick()
        if ch.released:
            break
        if k % 51 == 0:
            ch.take()  # the SDCCH's downlink block
    assert l2.rc >= 2 and len(depths) > 1  # retransmitted, depth moved
    assert l2.tx_progress() == progress
    assert ch.released and k == t3111 + 1


def test_acknowledgement_restarts_t3111():
    """A live MS whose acknowledgements come slower than the whole T3111
    window but each within it keeps the channel until the queue drains:
    an advance of V(A) restarts T3111."""
    from openbts_ttsou_tpu_torch.gsm.transfer import (L2Control, L2Frame,
                                                      L2Header, L2Length)
    from openbts_ttsou_tpu_torch.gsm.lapdm import S_BITS, L2Address
    from openbts_ttsou_tpu_torch.gsm.transfer import (ControlFormat,
                                                      FrameFormat, FrameType)

    ctl, ch, l2, fn = _released_channel()
    t3111 = int(2000 / 4.615)
    acks = 0
    for k in range(1, 4 * t3111):
        fn[0] += 1
        l2.tick(int(k * 4.615))
        ctl.release_tick()
        if ch.released:
            break
        if k % (t3111 - 50) == 0:  # the MS's RR, inside each window
            ch.take()
            rr_frame = L2Frame.from_header(L2Header(
                FrameFormat.B, L2Address(0, 0),
                L2Control(ControlFormat.S, nr=l2.vs, pf=0,
                          bits=S_BITS[FrameType.RR]), L2Length()))
            before = l2.tx_progress()
            l2.write_low_side(rr_frame)
            acks += l2.tx_progress() > before
    assert acks == 2 and ch.tx_drained() and ch.released
    assert k > t3111 + 1  # it outlived one T3111 window
