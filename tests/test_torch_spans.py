"""The port's span recorder (`utils/profiling.py`): nesting, the ring and
what it drops, switching it off, selection by root, the spans under
`torch.profiler` on its clock; the spans of the receive and resident
paths on the CPU; and the benchmark's readers of the spans
(`trxbench/spans.py`, `trxbench/metrics/`) on synthetic records."""

import collections
import importlib.util
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from openbts_ttsou_tpu_torch.models import transceiver as T
from openbts_ttsou_tpu_torch.models.resident import ResidentL1
from openbts_ttsou_tpu_torch.trx import engine as eng
from openbts_ttsou_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]


def names(spans):
    return collections.Counter(s[0] for s in spans)


# ---- the recorder ----------------------------------------------------------

def test_spans_nest_with_parent_and_root_seq():
    rec = profiling.Recorder(16)
    with rec.span("a"):
        with rec.span("b"):
            with rec.span("c"):
                pass
        with rec.span("b"):
            pass
    with rec.span("d"):
        pass
    got = list(rec._ring)
    # a span is kept as it closes: innermost first
    assert [s[0] for s in got] == ["c", "b", "b", "a", "d"]
    assert [s[3] for s in got] == ["b", "a", "a", None, None]
    roots = {s[4] for s in got[:4]}
    assert len(roots) == 1 and got[4][4] not in roots
    for s in got:
        assert s[1] <= s[2]
    c, b, _, a, _ = got
    assert a[1] <= b[1] <= c[1] <= c[2] <= b[2] <= a[2]
    assert rec.clock_offset_ns(a[4]) is not None
    assert rec.dropped() == 0


def test_span_as_decorator_records_each_call():
    rec = profiling.Recorder(16)

    @rec.span("work")
    def work(x):
        """Doubles."""
        return 2 * x

    assert work(3) == 6 and work(4) == 8
    assert work.__name__ == "work" and work.__doc__ == "Doubles."
    assert [s[0] for s in rec._ring] == ["work", "work"]


def test_span_closes_when_its_body_raises():
    rec = profiling.Recorder(16)
    with pytest.raises(ValueError):
        with rec.span("outer"):
            with rec.span("inner"):
                raise ValueError
    assert [s[0] for s in rec._ring] == ["inner", "outer"]
    with rec.span("next"):
        pass
    assert rec._ring[-1][3] is None  # the stack was left empty


def test_ring_counts_the_spans_it_drops():
    rec = profiling.Recorder(4)
    marks = []
    for i in range(6):
        marks.append(time.perf_counter_ns())
        with rec.span(f"r{i}"):
            pass
    end = time.perf_counter_ns()
    assert rec.dropped() == 2
    assert [s[0] for s in rec._ring] == ["r2", "r3", "r4", "r5"]
    # the first roots' offsets leave with them
    assert rec.clock_offset_ns(rec._ring[0][4] - 1) is None
    # a stretch whose spans were partly dropped is not given as complete
    assert rec.spans_between(marks[0], end) is None
    assert rec.spans_between(marks[1], end) is None
    assert [s[0] for s in rec.spans_between(marks[2], end)] == [
        "r2", "r3", "r4", "r5"]


def test_recording_off_records_nothing():
    dropped = profiling.dropped()
    t0 = time.perf_counter_ns()
    profiling.recording(False)
    try:
        with profiling.span("off.outer"):
            with profiling.span("off.inner"):
                torch.ones(4).sum()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with profiling.span("off.profiled"):
                torch.ones(4).sum()
    finally:
        profiling.recording(True)
    assert profiling.spans_between(t0, time.perf_counter_ns()) == []
    assert profiling.dropped() == dropped
    assert not [e for e in prof.profiler.kineto_results.events()
                if e.name().startswith("off.")]
    # on again: recorded
    t0 = time.perf_counter_ns()
    with profiling.span("on.again"):
        pass
    assert names(profiling.spans_between(t0, time.perf_counter_ns())) == {
        "on.again": 1}


def test_spans_between_selects_by_root():
    rec = profiling.Recorder(64)
    with rec.span("before"):
        pass
    t0 = time.perf_counter_ns()
    with rec.span("inside"):
        with rec.span("child"):
            pass
    with rec.span("inside2"):
        pass
    t1 = time.perf_counter_ns()
    with rec.span("straddles"):
        with rec.span("early_child"):
            pass
        t_mid = time.perf_counter_ns()
    got = rec.spans_between(t0, t1)
    assert [s[0] for s in got] == ["child", "inside", "inside2"]
    # a root that ends after the stretch takes its children with it, even
    # those inside the stretch
    assert "early_child" not in names(rec.spans_between(t0, t_mid))
    assert names(rec.spans_between(t0, time.perf_counter_ns()))[
        "early_child"] == 1


def test_spans_reach_the_profiler_once_on_its_clock():
    """Under a profiler each span is one host operation, with no image
    on the device's timeline, and the root's clock offset puts the span
    around it (within 1 ms)."""
    tol = 1_000_000
    t0 = time.perf_counter_ns()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("clock.outer"):
            torch.ones(64).cumsum(0)
            with profiling.span("clock.inner"):
                torch.ones(64).cumsum(0)
    spans = profiling.spans_between(t0, time.perf_counter_ns())
    assert names(spans) == {"clock.outer": 1, "clock.inner": 1}
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("clock.")]
    assert names((e.name(),) for e in events) == {"clock.outer": 1,
                                                  "clock.inner": 1}
    assert {str(e.activity_type()) for e in events} == {"cpu_op"}
    for name, start, end, _parent, root in spans:
        off = profiling.clock_offset_ns(root)
        ev = next(e for e in events if e.name() == name)
        ev_start = ev.start_ns()
        ev_end = ev_start + ev.duration_ns()
        assert start + off - tol <= ev_start <= ev_end <= end + off + tol


# ---- the spans of the port's paths, on the CPU ----------------------------

def test_uplink_block_records_its_spans_on_the_frame_schedule(monkeypatch):
    monkeypatch.setattr(T, "EXACT_BATCH_MAX_CHAN", 0)
    trx = T.Transceiver(eng.TrxConfig(n_chan=2), T.UplinkSpec(), "cpu")
    for tn in range(8):
        trx.set_slot(0, tn, 4 if tn == 0 else 1)
        trx.set_slot(1, tn, 1)
    x = (torch.randn(2, trx.spec.block_in, dtype=torch.complex64,
                     generator=torch.Generator().manual_seed(0)) * 10)
    frames = trx.spec.frames
    t0 = time.perf_counter_ns()
    trx.process_uplink(x)
    spans = profiling.spans_between(t0, time.perf_counter_ns())
    n = names(spans)
    assert n["trx.uplink"] == 1 and n["rx.exact"] == 1
    assert n["k1.resample"] == 1
    assert n["rx.frame"] == frames
    assert n["sync.est_gate"] == n["sync.dfe_gate"] == frames
    by = {s[0]: s for s in spans}
    assert by["trx.uplink"][3] is None
    assert by["rx.exact"][3] == by["k1.resample"][3] == "trx.uplink"
    assert {s[3] for s in spans if s[0] == "rx.frame"} == {"rx.exact"}
    assert {s[3] for s in spans if s[0].endswith("_gate")} == {"rx.frame"}
    # every sync span holds its one statement, no other span
    assert not {s[3] for s in spans} & {s[0] for s in spans
                                        if s[0].startswith("sync.")}
    assert len({s[4] for s in spans}) == 1


def test_resident_step_records_both_fec_legs():
    c = 2
    layer = ResidentL1(eng.TrxConfig(n_chan=c), xcch_tns=(0, 1, 6, 7),
                       tch_tns=(2, 3, 4, 5), device="cpu")
    ul = np.zeros((c, layer.spec.block_in + 2 * T.RX_HALO_DEV),
                  np.complex64)
    content = layer.empty_content(np.zeros((c, 8), bool))
    t0 = time.perf_counter_ns()
    layer.step(ul, content)
    spans = profiling.spans_between(t0, time.perf_counter_ns())
    n = names(spans)
    assert n["l1.step"] == 1
    for name in ("fec.encode", "tx.modulate", "rx.exact", "fec.decode"):
        assert n[name] == 1, name
    assert n["k1.resample"] == 2  # downlink and uplink
    assert {s[3] for s in spans if s[0] in ("fec.encode", "tx.modulate",
                                            "rx.exact", "fec.decode")
            } == {"l1.step"}


# ---- the benchmark's readers, on synthetic records -------------------------

def _reader(metric: str):
    path = ROOT / "trxbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "test_reader_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


MS = 1_000_000  # ns


def _call(t0_ms: float, t1_ms: float) -> dict:
    return {"issue": t0_ms / 1e3, "ret": t1_ms / 1e3, "done": t1_ms / 1e3}


def _span(name, a_ms, b_ms, parent, root):
    return (name, int(a_ms * MS), int(b_ms * MS), parent, root)


def _bank_spans():
    """Two calls, [1000, 1100] and [1200, 1300] ms."""
    out = []
    for k, base in enumerate((1000.0, 1200.0)):
        r = k + 7
        out += [
            _span("k1.resample", base + 1, base + 2, "trx.uplink", r),
            _span("sync.table", base + 3, base + 4, "rx.exact", r),
            _span("sync.est_gate", base + 10, base + 12, "rx.frame", r),
            _span("sync.dfe_gate", base + 20, base + 21 + k, "rx.frame", r),
            _span("rx.frame", base + 5, base + 40, "rx.exact", r),
            _span("rx.walk", base + 41, base + 44 + k, "rx.exact", r),
            _span("rx.exact", base + 2, base + 80, "trx.uplink", r),
            _span("fec.decode", base + 81, base + 90, "l1.step", r),
            _span("sync.table", base + 91, base + 92, "fec.encode", r),
            _span("fec.encode", base + 90, base + 95, "l1.step", r),
            _span("trx.uplink", base + 0.5, base + 99, None, r),
        ]
    return out


@pytest.fixture
def program(monkeypatch):
    """The program's `spans_between` replaced by one over a list."""
    state = {"spans": _bank_spans()}

    def between(t0, t1):
        if state["spans"] is None:
            return None
        roots = {s[4] for s in state["spans"]
                 if s[3] is None and s[1] >= t0 and s[2] <= t1}
        return [s for s in state["spans"] if s[4] in roots]

    monkeypatch.setattr(profiling, "spans_between", between)
    return state


REC = {"calls": [_call(1000, 1100), _call(1200, 1300)]}


@pytest.mark.parametrize("metric,want", [
    # rx.exact 78 ms less its syncs: 1 + 2 + 1 (call 1), 1 + 2 + 2 (call 2)
    ("rx_host_ms", (78 - 4 + 78 - 5) / 2),
    # every sync span: 5 ms and 6 ms
    ("sync_wait_ms", 5.5), ("sync_wait_ms.l1res", 5.5),
    ("prog_syncs_per_block", 4.0), ("prog_syncs_per_block.l1res", 4.0),
    ("fec_decode_ms.l1res", 9.0),
    ("fec_encode_ms.l1res", 4.0),
    # rx.walk: 3 ms and 4 ms, no syncs inside
    ("walk_ms", 3.5),
])
def test_span_readers_on_a_synthetic_window(program, metric, want):
    assert _reader(metric)(REC) == pytest.approx(want)


READERS = ("rx_host_ms", "sync_wait_ms", "prog_syncs_per_block",
           "fec_decode_ms.l1res", "fec_encode_ms.l1res",
           "sync_wait_ms.l1res", "prog_syncs_per_block.l1res", "walk_ms")


@pytest.mark.parametrize("case", ["dropped", "extra_root", "missing_root",
                                  "root_outside_its_call", "no_calls",
                                  "no_recorder"])
def test_span_readers_give_none_where_the_record_is_unsound(
        program, monkeypatch, case):
    rec = REC
    if case == "dropped":
        program["spans"] = None
    elif case == "extra_root":
        program["spans"] = program["spans"] + [
            _span("trx.uplink", 1250, 1260, None, 99)]
    elif case == "missing_root":
        program["spans"] = [s for s in program["spans"] if s[4] != 8]
    elif case == "root_outside_its_call":
        rec = {"calls": [_call(1000, 1050), _call(1060, 1300)]}
    elif case == "no_calls":
        rec = {"calls": []}
    else:  # a program without the recorder, as before it had one
        monkeypatch.delattr(profiling, "spans_between")
    for metric in READERS:
        assert _reader(metric)(rec) is None, metric


def test_span_readers_read_the_programs_own_record():
    """The readers find the spans a real call recorded, on the clock the
    harness stamps its calls with."""
    trx = T.Transceiver(eng.TrxConfig(n_chan=1), T.UplinkSpec(), "cpu")
    x = torch.zeros(1, trx.spec.block_in, dtype=torch.complex64)
    calls = []
    for _ in range(2):
        t_issue = time.perf_counter()
        trx.process_uplink(x)
        t_done = time.perf_counter()
        calls.append({"issue": t_issue, "ret": t_done, "done": t_done})
    rec = {"calls": calls}
    host = _reader("rx_host_ms")(rec)
    waits = _reader("sync_wait_ms")(rec)
    syncs = _reader("prog_syncs_per_block")(rec)
    walk = _reader("walk_ms")(rec)
    assert host > 0 and waits >= 0 and syncs >= 2
    assert 0 < walk < host  # rx.walk lies inside rx.exact
    assert host + waits <= 1e3 * max(c["done"] - c["issue"] for c in calls)
