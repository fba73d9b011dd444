"""The served path on the CPU: the cell `trxd128.wire`'s entry
(`BlockTrxDaemon` and a BTS stub over loopback UDP, 26-frame blocks,
depth 2) at 4 carriers against the benchmark's plain reference of the
wire's bytes, byte for byte; its carried state paired with the block it
retires; the planted faults; the configuration's and the traffic's
sources; the daemon's spans; and the readers `wire_ms` and `marshal_ms`.
Each rig binds its ports where a bind probe finds them free
(`trxbench/entries/wire.py` `free_base`, 12000-23999), so xdist workers
do not collide. One test, marked `cuda`, checks the daemon's host syncs
on the card."""

import collections
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from openbts_ttsou_tpu_torch.trx.radio import ReplayBankRadio
from openbts_ttsou_tpu_torch.utils import profiling
from trxbench import gaps, spec
from trxbench.reference import rx as ref

ROOT = Path(__file__).resolve().parents[1]
CELL = "trxd128.wire"
C = 4
SEED = 2 ** 31 + 2020
BENCH = spec.benchmark()


def small_cell(carriers: int = C) -> spec.Cell:
    cell = spec.Cell(BENCH, CELL)
    cell.config = dict(cell.config, carriers=carriers)
    return cell


def _reader(metric: str):
    path = ROOT / "trxbench" / "metrics" / f"{metric}.py"
    s = importlib.util.spec_from_file_location(
        "test_wire_reader_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read


@pytest.fixture(scope="module")
def rig():
    """The entry at 4 carriers on the CPU, set up (bring-up and warm
    blocks), with its pool of inputs."""
    cell = small_cell()
    entry = cell.entry.Entry(cell.config, torch.device("cpu"))
    pool = entry.make_inputs(cell.generator, cell.traffic["params"], SEED)
    entry.test_pool = pool
    entry.test_cell = cell
    entry.test_next = 0  # the pool item the next call retires
    yield entry
    entry.release()


def _call(rig) -> tuple:
    """One call, as the harness makes it: (state before, host outputs,
    state after), copied to the host."""
    item = rig.test_next
    before = gaps.moved(rig.state(), "cpu")
    host = rig.to_host(rig.call(rig.test_pool[item]))
    after = gaps.moved(rig.state(), "cpu")
    rig.test_next = (item + 1) % len(rig.test_pool)
    return item, before, host, after


def _gaps(rig, item, before, host, after) -> tuple[dict, dict]:
    ref_after, ref_out = rig.reference(before, rig.test_pool[item], False)
    return rig.gaps_of(host, after, ref_after, ref_out), ref_out


# ---- the configuration and the traffic -------------------------------------

def test_config_holds_its_stated_deployment():
    cfg = json.loads((ROOT / "trxbench" / "configs" / "trxd128.json")
                     .read_text())
    assert (cfg["carriers"], cfg["frames"], cfg["depth"]) == (128, 26, 2)
    assert cfg["compact"] is True and cfg["tx_latency_frames"] == 2
    assert cfg["max_toa"] is None and cfg["rach_slots"] is None
    assert cfg["reduced"] == [] and cfg["entry"] == "wire"
    assert len(cfg["source"]) <= 200
    assert cfg["precision"] == json.loads(
        (ROOT / "trxbench" / "configs" / "rxbank512.json").read_text()
    )["precision"]
    # the slot plan, the TSC and the max delay are what the verbs set
    verbs = [tuple(v) for v in cfg["bring_up"]]
    slots = {a[0]: a[1] for v, *a in verbs if v == "SETSLOT"}
    assert [slots[tn] for tn in range(8)] == cfg["slots"] == [4] + [1] * 7
    assert [a for v, *a in verbs if v == "SETTSC"] == [[cfg["tsc"]]]
    assert "SETMAXDELAY" not in {v for v, *_ in verbs}
    assert cfg["max_delay"] == 0
    conf = {c["name"]: c for c in BENCH["configs"]}["trxd128"]
    assert conf["file"] == "trxbench/configs/trxd128.json"
    assert conf["source"] == cfg["source"] and conf["reduced"] == []


def test_bring_up_is_the_soaks():
    """The configuration's verbs, then POWERON, are what
    `tools/daemon_soak` sends each carrier."""
    from openbts_ttsou_tpu_torch.tools import daemon_soak

    class Sent:
        def __init__(self):
            self.msgs = []

        def send(self, data):
            self.msgs.append(data.rstrip(b"\x00").decode().split()[1:])

    class Stop(Exception):
        pass

    class Daemon:
        steps = 0

        def step(self):
            self.steps += 1
            if self.steps == 2:
                raise Stop

    n = 3
    stub = collections.namedtuple("Stub", "ctrl")([Sent() for _ in range(n)])
    args = collections.namedtuple("Args", "carriers block_frames "
                                  "dl_carriers")(n, 26, -1)
    with pytest.raises(Stop):
        daemon_soak._soak(args, Daemon(), stub)
    cfg = small_cell().config
    want = [[v, *map(str, a)] for v, *a in cfg["bring_up"]] + [["POWERON"]]
    assert all(s.msgs == want for s in stub.ctrl)


def test_traffic_is_periodic_and_keyed_by_frame_number():
    cell = small_cell()
    par = cell.traffic["params"]
    assert cell.traffic["generator"] == "wire"
    assert (par["pool"], par["frames"], par["dl_frames"]) == (4, 26, 104)
    assert par["ul_slots"] == list(range(1, 8)) and par["tsc"] == 0
    assert ref.HYPERFRAME % par["dl_frames"] == 0
    pool = cell.generator.make(par, cell.config, SEED, "cpu")
    ex = pool["expect"]
    assert ex["per_block"] == 26 * C * 7
    assert tuple(ex["dl_bits"].shape) == (104, C, 8, 148)
    # each item is the window the radio reads for a block of its index,
    # its halos from the neighbouring blocks of the period
    radio = ReplayBankRadio(ex["stream"])
    n = 26 * 1250 * 96 // 65
    for block in (1, 2, 3, 4, 5, 11):
        got = radio.read_bank(n + 192, block * n - 96)
        item = pool["items"][block % 4]
        assert item["index"] == block % 4
        assert np.array_equal(got, item["ul"].numpy())
    # the seed makes the same traffic
    again = cell.generator.make(par, cell.config, SEED, "cpu")
    assert np.array_equal(again["expect"]["stream"], ex["stream"])
    assert torch.equal(again["expect"]["dl_bits"], ex["dl_bits"])


def test_benchmark_lists_the_cell_and_its_metrics():
    cells = {w["name"]: w for w in BENCH["workloads"]}
    assert cells[CELL]["chips"] == 1 and len(cells[CELL]["why"]) <= 200
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert CELL in e2e["ul_Msps"]["workloads"]
    assert CELL not in e2e["block_ms_p90"]["workloads"]
    layer = {m["name"]: m for m in BENCH["per_layer"]}
    for name in ("dispatch_ms", "launches_per_block", "k1_roofline",
                 "dev_idle", "dev_peak_GiB", "rx_host_ms", "walk_ms",
                 "sync_wait_ms", "prog_syncs_per_block"):
        assert CELL in layer[name]["workloads"], name
    for name in ("wire_ms", "marshal_ms"):
        m = layer[name]
        assert m["workloads"] == [CELL] and m["moves"] == "ul_Msps"
        assert m["layer"] == "wire (UDP planes)"
        assert m["source"] == "program_span"


# ---- the entry against the reference ----------------------------------------

def test_wire_bytes_are_the_reference_byte_for_byte(rig):
    for _ in range(3):
        item, before, host, after = _call(rig)
        assert rig.known_misses(host, item) == 0
        assert len(host["datagrams"]) == 26 * C * 7
        g, ref_out = _gaps(rig, item, before, host, after)
        assert g == {"datagram_diffs": 0, "soft_byte_gap": 0, "tx_gap": 0,
                     "state_gap": 0.0}
        assert np.array_equal(host["tx"], ref_out["tx"])
        order = np.lexsort((host["datagrams"][:, 0], host["carrier"]))
        ref_order = np.lexsort((ref_out["datagrams"][:, 0],
                                ref_out["carrier"]))
        # frame-major within a carrier on both sides
        assert np.array_equal(host["datagrams"][order],
                              ref_out["datagrams"][ref_order])


def test_state_pairs_with_the_retired_block(rig):
    item, before, host, after = _call(rig)
    assert host["item"] == item
    assert int(before["state"].fn) == host["fn0"]
    assert int(after["state"].fn) == (host["fn0"] + 26) % ref.HYPERFRAME
    assert host["tx_fn0"] == (host["fn0"] + 2) % ref.HYPERFRAME
    # by reference, no copy: the state the daemon holds now is the one
    # the call `depth` calls on will pair with its block
    newest = rig.daemon.state
    assert rig.state()["state"] is not newest
    for _ in range(rig.depth):
        _call(rig)
    assert rig.state()["state"] is newest


@pytest.mark.parametrize("fault,number", [
    ("stale_state", "state_gap"), ("half_batch", "datagram_diffs"),
    ("altered_answer", "soft_byte_gap"), ("dropped_carrier",
                                          "datagram_diffs")])
def test_planted_fault_moves_its_number(rig, fault, number):
    cell = rig.test_cell
    assert fault in cell.entry.FAULTS
    with cell.entry.fault(fault):
        # a block dispatched under the fault retires `depth` calls on
        for _ in range(rig.depth + 1):
            item, before, host, after = _call(rig)
    g, _ = _gaps(rig, item, before, host, after)
    misses = rig.known_misses(host, item)
    for _ in range(rig.depth):  # the faulty blocks out of the pipeline
        _call(rig)
    assert g[number] > cell.limits[number], g
    if fault == "stale_state":
        assert g["state_gap"] >= 26  # the frame number did not move
    elif fault == "half_batch":
        assert g["datagram_diffs"] == misses == (C - C // 2) * 26 * 7
    elif fault == "altered_answer":
        assert g["datagram_diffs"] == 1 and misses == 0
    else:
        assert g["datagram_diffs"] == misses == 26 * 7


WHOLE_RUN = """
import json, sys, time, torch
from trxbench import run, spec
cell = spec.Cell(spec.benchmark(), "trxd128.wire")
cell.config = dict(cell.config, carriers=int(sys.argv[1]))
out = run.run_cell(cell, int(sys.argv[2]), 0.5, True, torch.device("cpu"),
                   t_start=time.perf_counter())
print(json.dumps({"result": out["result"], "info": out["info"]}))
"""


def test_a_whole_run_is_correct_and_reads_the_wire_layer():
    """The harness's own run at 4 carriers, traced, in a process of its
    own (it refuses to finish where JAX is loaded, as this suite's
    conftest loads it)."""
    p = subprocess.run([sys.executable, "-c", WHOLE_RUN, str(C),
                        str(SEED + 1)], capture_output=True, text=True,
                       timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    r = out["result"]
    assert r["correct"] and r["failed"] == 0, r["compared"]
    assert all(c["value"] == 0 for c in r["compared"].values())
    for name in ("wire_ms", "marshal_ms", "dispatch_ms", "rx_host_ms",
                 "walk_ms", "sync_wait_ms", "prog_syncs_per_block"):
        assert r["metrics"][name]["value"] > 0, name
    assert out["info"]["uplink_datagrams_per_call"] == 26 * C * 7
    assert out["info"]["underruns_per_call"] == 0


# ---- the daemon's spans ---------------------------------------------------

def test_spans_nest_under_one_step(rig):
    t0 = time.perf_counter_ns()
    _call(rig)
    spans = profiling.spans_between(t0, time.perf_counter_ns())
    n = collections.Counter(s[0] for s in spans)
    parent = collections.defaultdict(set)
    for s in spans:
        parent[s[0]].add(s[3])
    assert n["trxd.step"] == 1 and parent["trxd.step"] == {None}
    assert len({s[4] for s in spans}) == 1  # one root, the step
    for name in ("trxd.control", "trxd.ingest", "trxd.marshal",
                 "trxd.retire", "rx.exact"):
        assert n[name] == 1 and parent[name] == {"trxd.step"}, name
    assert n["rx.walk"] == 1 and parent["rx.walk"] == {"rx.exact"}
    assert n["k1.resample"] == 2  # downlink and uplink
    assert n["sync.upload"] == 1 and parent["sync.upload"] == {
        "trxd.marshal"}
    # the header, the DAC rows and the datagram rows
    assert n["sync.retire"] == 3 and parent["sync.retire"] == {
        "trxd.retire"}
    # a sync span holds its one statement, no other span
    assert not {s[3] for s in spans} & {s[0] for s in spans
                                        if s[0].startswith("sync.")}


def test_no_host_sync_outside_a_sync_span(rig, monkeypatch):
    """On the CPU, the statements that wait for a card there: a copy to
    the host (`cpu`), a value read on the host (`item`, `tolist`, `bool`,
    `int`, `float`) and the daemon's own copies to the device (`to` with
    a device, called from `trx/daemon.py`; the engine's device-to-device
    moves look alike on the CPU), each recorded with the innermost span
    open around it. The card's own check is
    `test_daemon_step_syncs_inside_sync_spans`."""
    seen = []

    def innermost():
        frames = profiling.RECORDER._stack.frames
        return frames[-1][0] if frames and frames[-1] is not None else None

    def watch(name, is_sync=lambda *a, **k: True):
        inner = getattr(torch.Tensor, name)

        def watched(self, *args, **kwargs):
            if is_sync(*args, **kwargs):
                seen.append((name, innermost()))
            return inner(self, *args, **kwargs)

        monkeypatch.setattr(torch.Tensor, name, watched)

    def to_device(*args, **kwargs):
        caller = sys._getframe(2).f_code.co_filename
        return caller.endswith(str(Path("trx", "daemon.py"))) and (
            "device" in kwargs or any(isinstance(a, (str, torch.device))
                                      for a in args))

    step = rig.daemon.step
    for name in ("cpu", "item", "tolist", "__bool__", "__int__",
                 "__float__"):
        watch(name)
    watch("to", to_device)
    step_seen = []

    def watched_step():
        seen.clear()
        step()
        step_seen.extend(seen)

    monkeypatch.setattr(rig.daemon, "step", watched_step)
    _call(rig)
    monkeypatch.undo()
    outside = [s for s in step_seen if not (s[1] or "").startswith("sync.")]
    assert step_seen and not outside, outside
    assert {s[1] for s in step_seen if s[0] == "cpu"} == {"sync.retire"}
    assert ("to", "sync.upload") in step_seen


def test_wire_readers_read_the_programs_own_record(rig):
    calls = []
    for _ in range(2):
        t_issue = time.perf_counter()
        _call(rig)
        t_done = time.perf_counter()
        calls.append({"issue": t_issue, "ret": t_done, "done": t_done})
    rec = {"calls": calls}
    wire, marshal = _reader("wire_ms")(rec), _reader("marshal_ms")(rec)
    waits = _reader("sync_wait_ms")(rec)
    assert wire > 0 and marshal > 0 and waits >= 0
    assert _reader("prog_syncs_per_block")(rec) >= 4  # upload, 3 retire
    longest = 1e3 * max(c["done"] - c["issue"] for c in calls)
    assert wire + marshal + waits <= longest


MS = 1_000_000  # ns


def _span(name, a_ms, b_ms, parent, root):
    return (name, int(a_ms * MS), int(b_ms * MS), parent, root)


@pytest.fixture
def program(monkeypatch):
    """The program's `spans_between` over two synthetic daemon steps,
    [1000, 1100] and [1200, 1300] ms."""
    out = []
    for k, base in enumerate((1000.0, 1200.0)):
        r = k + 3
        out += [
            _span("trxd.control", base + 1, base + 2, "trxd.step", r),
            _span("trxd.ingest", base + 2, base + 6 + k, "trxd.step", r),
            _span("sync.upload", base + 10, base + 13, "trxd.marshal", r),
            _span("trxd.marshal", base + 7, base + 15, "trxd.step", r),
            _span("rx.exact", base + 16, base + 60, "trxd.step", r),
            _span("sync.retire", base + 61, base + 70, "trxd.retire", r),
            _span("sync.retire", base + 71, base + 72, "trxd.retire", r),
            _span("trxd.retire", base + 60.5, base + 80, "trxd.step", r),
            _span("trxd.step", base + 0.5, base + 99, None, r),
        ]

    def between(t0, t1):
        roots = {s[4] for s in out
                 if s[3] is None and s[1] >= t0 and s[2] <= t1}
        return [s for s in out if s[4] in roots]

    monkeypatch.setattr(profiling, "spans_between", between)
    return out


def test_wire_readers_on_a_synthetic_window(program):
    rec = {"calls": [{"issue": 1.0, "ret": 1.1, "done": 1.1},
                     {"issue": 1.2, "ret": 1.3, "done": 1.3}]}
    # ingest 4 and 5 ms; retire 19.5 ms less 10 ms of syncs, each call
    assert _reader("wire_ms")(rec) == pytest.approx(4.5 + 9.5)
    # marshal 8 ms less its 3 ms upload
    assert _reader("marshal_ms")(rec) == pytest.approx(5.0)
    assert _reader("prog_syncs_per_block")(rec) == pytest.approx(3.0)
    # a call without the daemon's ingest span reads nothing
    program[:] = [s for s in program
                  if not (s[0] == "trxd.ingest" and s[4] == 4)]
    assert _reader("wire_ms")(rec) is None
    assert _reader("marshal_ms")(rec) == pytest.approx(5.0)


# ---- on the card ------------------------------------------------------------

@pytest.mark.cuda
def test_daemon_step_syncs_inside_sync_spans():
    """One warm call of the entry at 4 carriers on the card under
    `set_sync_debug_mode("warn")`: every host sync of the daemon's step
    happens inside a `sync.*` span, one a span."""
    import warnings

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = small_cell()
    entry = cell.entry.Entry(cell.config, torch.device("cuda"))
    try:
        pool = entry.make_inputs(cell.generator, cell.traffic["params"],
                                 SEED)
        entry.to_host(entry.call(pool[0]))
        torch.cuda.synchronize()
        seen, in_step = [], [False]
        step = entry.daemon.step

        def watched_step():
            in_step[0] = True
            try:
                step()
            finally:
                in_step[0] = False

        def hook(message, *args, **kwargs):
            if in_step[0] and "synchroniz" in str(message):
                frames = profiling.RECORDER._stack.frames
                seen.append(frames[-1][0] if frames and frames[-1]
                            is not None else None)

        entry.daemon.step = watched_step
        t0 = time.perf_counter_ns()
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            torch.cuda.set_sync_debug_mode("warn")
            try:
                entry.to_host(entry.call(pool[1]))
            finally:
                torch.cuda.set_sync_debug_mode(0)
        spans = profiling.spans_between(t0, time.perf_counter_ns())
    finally:
        entry.release()
    outside = [s for s in seen if not (s or "").startswith("sync.")]
    assert seen and not outside, outside
    assert len(seen) == sum(s[0].startswith("sync.") for s in spans)
