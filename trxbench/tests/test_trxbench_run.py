"""Whole runs on the CPU: correct where the port is sound, not correct
where a fault is planted in its timed path; the look for JAX; and the
runs that must print no result."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import pytest

from trxbench import run
from trxbench.tests.conftest import ROOT, cpu_run, small_cell

CELLS = ["rxbank512.tsc1", "l1res512.coded"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = cpu_run(small_cell(name), seconds=1.0)
    r = out["result"]
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "compared"
    assert all(c["value"] == 0 for c in r["compared"].values())
    # every end-to-end metric of the cell, but the card's busy time, which
    # a run without a card has nothing to read for
    want = {m["name"] for m in small_cell(name).end_to_end} - {"card_ms"}
    assert set(r["metrics"]) == want and "setup_s" in want


@pytest.mark.parametrize("name,fault", [
    (name, fault) for name in CELLS
    for fault in small_cell(name).entry.FAULTS])
def test_planted_fault_is_not_correct(name, fault):
    cell = small_cell(name)
    with cell.entry.fault(fault):
        r = cpu_run(cell, seconds=0.5)["result"]
    assert not r["correct"], r["compared"]


@pytest.mark.parametrize("name,suffix", [("rxbank512.tsc1", ""),
                                         ("l1res512.coded", ".l1res")])
def test_traced_run_reports_per_layer_metrics(name, suffix):
    out = cpu_run(small_cell(name), traced=True)
    r = out["result"]
    assert r["correct"]
    assert {m + suffix for m in ("dispatch_ms", "launches_per_block",
                                 "dev_idle")} <= set(r["metrics"])
    assert set(r["metrics"]) <= {m["name"] for m in small_cell(name).per_layer}
    assert "busy_s" in r["device"] and "window_s" in r["device"]
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    # the stretches run after the window, which runs as untraced
    assert r["attempted"] == out["info"]["calls"] + run.Stretches(True).calls


def test_device_trace_metric_profiles_every_window_call():
    """l1res512.coded's card_ms is read from the device trace: its untraced
    run profiles each call of the window by itself and ends the window on
    a whole period of the traffic; the traced run's window stays
    untraced."""
    cell = small_cell("l1res512.coded")
    assert run.Stretches(False, True).window
    assert not run.Stretches(True, True).window
    info = cpu_run(cell, seconds=0.5)["info"]
    assert info["calls"] % cell.traffic["params"]["windows"] == 0
    assert len(info["window_busy_ms_quartiles"]) == 3
    out = cpu_run(small_cell("rxbank512.tsc1"), seconds=0.5)["info"]
    assert out["window_busy_ms_quartiles"] == []


def test_compared_calls_are_copied_to_the_host():
    out = cpu_run(small_cell("l1res512.coded"), seconds=2.0)
    kept = out["check"]["kept"]
    assert kept[0]["first"] and len(kept) >= 2

    def tensors(x):
        if hasattr(x, "device"):
            yield x
        elif isinstance(x, dict):
            for v in x.values():
                yield from tensors(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                yield from tensors(v)

    held = [t for k in kept for t in tensors(k)]
    assert held and all(t.device.type == "cpu" for t in held)


def test_forbidden_modules_compare_whole_top_level_names():
    assert run.forbidden_modules(["openbts_ttsou_tpu_torch",
                                  "openbts_ttsou_tpu_torch.ops.fir",
                                  "jaxtyping", "flaxen", "torch"]) == []
    assert run.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen",
                                  "openbts_ttsou_tpu.ops"]) == [
        "flax", "jax", "jaxlib", "openbts_ttsou_tpu"]


def test_a_run_loads_no_jax():
    code = ("import sys, torch, trxbench.tests.conftest as c; "
            "c.cpu_run(c.small_cell('l1res512.coded'), seconds=0.2); "
            "from trxbench import run; print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _cli(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "trxbench.run", "--workload", "rxbank512.tsc1",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=600,
        env={**os.environ, **(env or {})})


def test_no_card_exits_nonzero_without_a_result():
    out = _cli(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_files_alone_exit_nonzero_without_a_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "trxbench", tmp_path / "trxbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {"PYTHONPATH": "", "CUDA_VISIBLE_DEVICES": ""}
    out = _cli(tmp_path, env)
    assert out.returncode != 0 and out.stdout.strip() == ""
