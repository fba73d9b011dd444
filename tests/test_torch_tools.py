"""The port's tools (`openbts_ttsou_tpu_torch/tools/`) on the CPU: the wire
soak and its clock-resync rule, the host tools over UDP, the refusal
without a card, and where the tools write. UDP ports 55000–55999 (the
soaks at 55000–55499, the host tools at 55500–55999).
"""

import json
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from openbts_ttsou_tpu_torch.tools import (common, daemon_soak, iq_tool,
                                           send_simple, soak_sweep,
                                           sweep_generator, trx_ping)
from openbts_ttsou_tpu_torch.utils.gsm_time import HYPERFRAME

ROOT = Path(__file__).resolve().parents[1]
BF = 26
SOAK = ["--device", "cpu", "--carriers", "2", "--blocks", "4",
        "--warmup", "6", "--block-frames", str(BF)]


class LatchedStub(daemon_soak.BtsStub):
    """The JAX soak's stub (tools/daemon_soak.py:209-211): the feed
    cursor latches the first IND CLOCK and ignores every later beacon."""

    def on_beacon(self, fn: int) -> None:
        if self.cursor is None:
            self.cursor = fn


def test_soak_follows_every_beacon(capsys):
    """6 warm-up blocks cover the daemon's lead growing from 20 to 26
    frames; the timed window then holds no late burst and no dumped one,
    and every uplink burst arrives."""
    rec = daemon_soak.main(SOAK + ["--base-port", "55000"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == rec
    assert rec["stale_dumped"] == 0 and rec["underruns"] == 0
    assert rec["stale_fraction"] == 0.0
    assert rec["uplink_datagrams"] >= BF * 2 * 7 * (4 - 2)
    assert rec["downlink_fed"] == 4 * BF * 8 * 2
    assert rec["clock_lead"] == BF  # grown to the block, no further
    assert rec["realtime"] == (rec["ms_per_frame"] < common.FRAME_MS)
    assert rec["blocks_run"] == 1 + 6 + 4
    assert rec["k1_launches"] == 0  # the CPU runs K1's plain form
    assert rec["device"] == "cpu" and rec["card"] is None


def test_latched_stub_dumps_every_block():
    """The latched rule feeds bf − 20 frames late every block for ever:
    (26 − 20)·8 stale bursts a block a carrier in the timed window, and
    `realtime` false whatever the frame time."""
    args = daemon_soak.parse_args(SOAK + ["--base-port", "55050"])
    rec = daemon_soak.run(args, stub_cls=LatchedStub)
    late = (BF - 20) * 8 * 2 * 4
    assert rec["stale_dumped"] == late and rec["underruns"] == late
    assert rec["realtime"] is False
    assert rec["stale_fraction"] == pytest.approx(late / rec["downlink_fed"])


@pytest.mark.parametrize("cursor,beacon,after", [
    (None, 22, 22),  # the first beacon starts the feed
    (100, 130, 130),  # ahead: jump
    (100, 90, 100),  # behind: never back
    (100, 100, 100),  # equal: stay
    (HYPERFRAME - 3, 5, 5),  # ahead across the hyperframe's wrap
    (5, HYPERFRAME - 3, 5),  # behind across the wrap
])
def test_stub_cursor_moves_forward_only(cursor, beacon, after):
    stub = daemon_soak.BtsStub.__new__(daemon_soak.BtsStub)
    stub.cursor = cursor
    stub.on_beacon(beacon)
    assert stub.cursor == after


def test_soak_refuses_carriers_past_fd_setsize(monkeypatch):
    """FD_SETSIZE no longer caps the soak (the port's transport waits with
    poll()): 300 carriers, 1202 sockets, pass. A count that the
    transport's handle table cannot hold is refused, and so is one past
    the hard RLIMIT_NOFILE; each refusal says which."""
    assert daemon_soak._check_descriptors(300, socket_bus=False) == 1202
    assert daemon_soak._check_descriptors(128, socket_bus=True) == 642
    with pytest.raises(ValueError, match="handle table"):
        daemon_soak._check_descriptors(2100, socket_bus=False)
    monkeypatch.setattr(daemon_soak.resource, "getrlimit",
                        lambda what: (1024, 1024))
    with pytest.raises(ValueError, match="hard RLIMIT_NOFILE"):
        daemon_soak._check_descriptors(300, socket_bus=False)


def test_soak_sweep_runs_rows_as_processes(tmp_path, monkeypatch):
    """One frontier row through `python -m ...daemon_soak`; the artifact
    goes where --out says, with its config, why and the soak's record."""
    monkeypatch.setattr(soak_sweep, "FRONTIER", [
        (1, 1, 7, -1, BF, 2, "replay", "one carrier")])
    out = tmp_path / "sweep.json"
    art = soak_sweep.main(["--device", "cpu", "--quick", "--out", str(out),
                           "--base-port", "55100", "--timeout", "120"])
    assert json.loads(out.read_text())["rows"] == art["rows"]
    (row,) = art["rows"]
    assert "error" not in row, row
    assert art["transfer_probe"] is None  # no card, no attachment
    assert row["config"]["carriers"] == 1 and row["why"] == "one carrier"
    assert row["stale_dumped"] == 0 and row["underruns"] == 0
    assert row["uplink_datagrams"] >= BF * 7 * (25 - 2)


def test_trx_ping_answers_against_port_daemon():
    from openbts_ttsou_tpu_torch.trx.daemon import TrxDaemon, TrxDaemonConfig
    from openbts_ttsou_tpu_torch.trx.radio import LoopbackRadio

    base = 55500
    daemon = TrxDaemon([LoopbackRadio()], TrxDaemonConfig(
        base_port=base, device="cpu"))
    stop = threading.Event()

    def serve():
        while not stop.is_set():
            daemon.step()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    try:
        rec = trx_ping.main(["--device", "cpu", "--base-port", str(base),
                             "--local-port", str(base + 101)])
    finally:
        stop.set()
        t.join(timeout=10)
        daemon.close()
    assert not t.is_alive()
    assert rec["answered"] == len(trx_ping.VERBS)
    for verb, args in trx_ping.VERBS:
        v = rec["verbs"][verb]
        assert (v["kind"], v["verb"], v["args"][0]) == ("RSP", verb, "0")
    assert rec["verbs"]["RXTUNE"]["args"][1:] == ["890000"]


def test_send_simple_reaches_a_sip_endpoint():
    """The MESSAGE arrives at a UDP socket of the test, parses, and the
    test's 200 OK comes back as the tool's status."""
    from openbts_ttsou_tpu_torch.sip.message import SIPMessage, make_response

    port, local = 55600, 55601
    got = {}
    srv = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    srv.bind(("127.0.0.1", port))
    srv.settimeout(10)

    def answer():
        data, addr = srv.recvfrom(4096)
        msg = SIPMessage.parse(data)
        got["msg"] = msg
        srv.sendto(make_response(msg, 200, "OK").render(), addr)

    t = threading.Thread(target=answer, daemon=True)
    t.start()
    try:
        rec = send_simple.main(["--device", "cpu", "2222", "hello", "there",
                                "--port", str(port), "--local-port",
                                str(local)])
    finally:
        t.join(timeout=10)
        srv.close()
    msg = got["msg"]
    assert msg.method == "MESSAGE" and msg.body == "hello there"
    assert "2222" in msg.get("to")
    assert (rec["status"], rec["reason"]) == (200, "OK")


def test_transfer_probe_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without CUDA")
    from openbts_ttsou_tpu_torch.tools import transfer_probe

    for dev in ("cuda", "cpu"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            transfer_probe.main(["--device", dev])


# every tool with its least arguments; each must refuse to run without a
# card when asked for cuda (the default)
ALL_TOOLS = {
    "daemon_soak": [], "soak_sweep": ["--quick"], "transfer_probe": [],
    "kernel_bakeoff": [], "kernel_probe": [], "stage_bench": [],
    "exact_bakeoff": [], "dfe_cost_probe": [], "encode_stage_probe": [],
    "scaling_bench": [], "iq_tool": ["replay"], "trx_ping": [],
    "send_simple": ["2222", "hi"], "sweep_generator": [], "roofline": [],
    "collective_inventory": [], "scaling_2proc": [],
    "bench_sweep": ["--quick"]}


@pytest.mark.parametrize("name", sorted(ALL_TOOLS))
def test_every_tool_refuses_cuda_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without CUDA")
    import importlib

    tool = importlib.import_module(f"openbts_ttsou_tpu_torch.tools.{name}")
    argv = ALL_TOOLS[name][:1] + ["--device", "cuda"] + ALL_TOOLS[name][1:]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main(argv)


def test_tools_package_lists_every_tool():
    import pkgutil

    from openbts_ttsou_tpu_torch import tools

    names = {m.name for m in pkgutil.iter_modules(tools.__path__)}
    assert names == set(ALL_TOOLS) | {"common"}


def test_tools_run_as_modules():
    """The entry point: `python -m` runs a tool and its last stdout line
    is its record."""
    out = subprocess.run(
        [sys.executable, "-m", "openbts_ttsou_tpu_torch.tools.kernel_probe",
         "--device", "cpu", "--rows", "1", "--shapes", "downlink"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["tool"] == "kernel_probe" and rec["ok"]
    assert rec["rows"][0]["plain"]["max_rel_err"] < 1e-6


def test_tools_write_only_under_build_tools(tmp_path, monkeypatch):
    """Without --out the writers put their files under build/tools/ (here
    redirected to tmp_path); no tracked artifact of the repo changes."""
    tracked = {p: p.stat().st_mtime_ns for p in ROOT.glob("*.json")}
    monkeypatch.setattr(common, "OUT_DIR", tmp_path / "build" / "tools")
    rec = iq_tool.main(["record", "--device", "cpu", "--frames", "3"])
    assert Path(rec["path"]) == tmp_path / "build/tools/iq_capture.npz"
    assert iq_tool.main(["replay", "--device", "cpu"])["planted"] == 2
    rec = sweep_generator.main(["--device", "cpu", "--steps", "2"])
    assert Path(rec["path"]) == tmp_path / "build/tools/sweep.npz"
    assert sorted(p.name for p in (tmp_path / "build/tools").iterdir()) \
        == ["iq_capture.npz", "sweep.npz"]
    assert {p: p.stat().st_mtime_ns for p in ROOT.glob("*.json")} == tracked
    # the soak sweep's default artifact is under build/tools/, never the
    # JAX sweep's tracked SOAK_r05.json
    assert common.out_path(None, "soak_sweep.json") \
        == tmp_path / "build/tools/soak_sweep.json"


def test_sweep_file_format(tmp_path):
    rec = sweep_generator.main(["--device", "cpu", "--out",
                                str(tmp_path / "s.npz"), "--steps", "3",
                                "--samples-per-step", "10"])
    data = np.load(rec["path"])
    assert data["iq"].shape == (1, 30) and data["iq"].dtype == np.complex64
    assert float(data["rate"]) == pytest.approx(1625e3 / 6.0)
