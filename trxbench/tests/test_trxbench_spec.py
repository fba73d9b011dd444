"""BENCHMARK.json against the limits of its format, and cells found by
name from files alone."""

from __future__ import annotations

import json
import re

import pytest

from trxbench import run, spec
from trxbench.tests.conftest import ROOT, cpu_run, read_json, small_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = read_json(ROOT / "BENCHMARK.json")


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
        assert (ROOT / p).is_dir()
    assert 1 <= len(BENCH["command"]) <= 32
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        data = read_json(ROOT / c["file"])
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200


def test_workloads():
    names = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        names.add(w["name"])
    assert len(names) == len(BENCH["workloads"])


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in SOURCES
        assert 1 <= len(m["layer"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert (ROOT / "trxbench" / "metrics" / f"{m['name']}.py").is_file()
    for cell in cells:  # setup_s, another end-to-end metric, a per-layer one
        mine = [m["name"] for m in BENCH["end_to_end"]
                if cell in m.get("workloads", cells)]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(cell in m.get("workloads", cells)
                   for m in BENCH["per_layer"])


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cells_found_by_name(name):
    cell = spec.Cell(BENCH, name)
    assert cell.config["name"] == name.split(".")[0]
    assert hasattr(cell.entry, "Entry") and callable(cell.generator.make)
    assert cell.limits and "known_misses" in cell.limits
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.reader(m["name"]))


def test_new_traffic_and_metric_are_files_alone(bench_copy):
    """A cell with a traffic mix, its generator and a per-layer metric
    that exist only as new files and new BENCHMARK.json entries runs."""
    tb = bench_copy / "trxbench"
    (tb / "generators" / "late.py").write_text(
        "from trxbench.generators import bursts\n\n\n"
        "def make(params, config, seed, device):\n"
        "    par = dict(params, bursts=[dict(b, toa_symbols=2)\n"
        "                               for b in params['bursts']])\n"
        "    return bursts.make(par, config, seed, device)\n")
    (tb / "traffic" / "dummy.json").write_text(json.dumps({
        "generator": "late",
        "params": {"pool": 2, "frames": 13, "noise_sigma": 10.0,
                   "bursts": [{"slots": [3], "tsc": 0, "amplitude": 5000.0}]
                   }}))
    (tb / "limits" / "rxbank512.dummy.json").write_text(
        (tb / "limits" / "rxbank512.tsc1.json").read_text())
    (tb / "metrics" / "calls_in_window.py").write_text(
        "def read(rec):\n    return len(rec['calls'])\n")
    bench = read_json(bench_copy / "BENCHMARK.json")
    bench["workloads"].append({"name": "rxbank512.dummy", "config":
                               "rxbank512", "traffic": "dummy", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:  # the new cell reports the bank's metrics
        if "rxbank512.tsc1" in m.get("workloads", ()):
            m["workloads"].append("rxbank512.dummy")
    bench["per_layer"].append({"name": "calls_in_window", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "block entry", "moves": "ul_Msps",
                               "workloads": ["rxbank512.dummy"]})
    before = {p: p.read_bytes() for p in tb.rglob("*") if p.is_file()}
    cell = small_cell("rxbank512.dummy", here=tb, bench=bench)
    out = cpu_run(cell, traced=True)["result"]
    assert out["correct"]
    window_calls = out["attempted"] - run.Stretches(True).calls
    assert out["metrics"]["calls_in_window"]["value"] == window_calls >= 1
    assert all(p.read_bytes() == b for p, b in before.items())
