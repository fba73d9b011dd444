"""The port's benchmark program run end to end on the CPU, its failure
paths, its sweep (`tools/bench_sweep.py`) and `entry()`.

`main()` with `--device cpu` in every mode (the JSON line's keys, metric
names and count names, the known answers of the recipe), the noise
guard on injected times, the retry rule (only the guard's miss is
retried; after the last failed attempt the error line and a non-zero
exit), the CPU baseline read from the tracked caches under `bench/`,
the sweep's grid and iters rule against the JAX tool's (loaded by path; it imports
no JAX at module level) and its failed rows, and `entry()` against
`__graft_entry__.entry()` run through JAX (detections, timing, RACH
flags and RSSI exact, soft bits within 2e-4 as in
tests/test_torch_engine.py). The parity of the modes with the JAX
package is tests/test_torch_bench.py's.
"""

import hashlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from openbts_ttsou_tpu_torch import bench, entry
from openbts_ttsou_tpu_torch.tools import bench_sweep

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
F = 13


def bench_files():
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((ROOT / "bench").iterdir()) if p.is_file()}


# iters a mode: dt of ~0.2 s on one CPU thread (a block at 2 carriers
# takes 6 ms in downlink, 40-110 ms in the others), 10× the guard's
# 0.02 s
MAIN_ITERS = {"exact": 5, "decoded": 2, "downlink": 32, "duplex": 5,
              "duplex_decoded": 3}


@pytest.mark.parametrize("mode", bench.MODES)
def test_main_on_the_cpu(monkeypatch, capsys, mode):
    before = bench_files()
    iters = MAIN_ITERS[mode]
    for k, v in {"BENCH_MODE": mode, "BENCH_CHANNELS": "2",
                 "BENCH_ITERS": str(iters), "BENCH_REPS": "2"}.items():
        monkeypatch.setenv(k, v)
    rec = bench.main(["--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == rec
    assert rec["metric"] == bench.metric(mode) == {
        "exact": "uplink_chain_throughput",
        "decoded": "uplink_chain_throughput",
        "downlink": "downlink_chain_throughput",
        "duplex": "duplex_chain_throughput",
        "duplex_decoded": "duplex_decoded_chain_throughput"}[mode]
    assert rec["unit"] == "Msamples/s/chip" and rec["value"] > 0
    d = rec["detail"]
    count = {"exact": "detections", "decoded": "detections",
             "downlink": "bursts", "duplex": "detections",
             "duplex_decoded": "fec_ok"}[mode] + "_run"
    assert {"n_chan", "iters", "frame_latency_ms", "mode", "seconds",
            "fetch_rtt_s", count, "max_toa", "rach_slots",
            "cpu_baseline_Msps", "cpu_baseline_harness",
            "mirror_baseline_Msps", "device", "card", "k1_launches",
            "exact_schedule"} <= set(d)
    assert "detections_last_block" not in d
    assert ("fec_ok_last_block" in d) == (mode == "duplex_decoded")
    assert ("duplex_exact" in d) == mode.startswith("duplex")
    assert d["mode"] == mode and d["n_chan"] == 2 and d["iters"] == iters
    assert d["blocks_run"] == 2 * iters
    assert d["blocks_total"] == iters * (1 + 3 * 2)
    assert d["device"] == "cpu" and d["card"] is None
    assert d["k1_launches"] == 0 and d["k1_shapes"] == {}  # plain on the CPU
    assert d["exact_schedule"] == (None if mode == "downlink" else "batched")
    assert d["cpu_baseline_harness"] == "hand-written mirror"
    assert rec["vs_baseline"] == pytest.approx(
        rec["value"] / d["cpu_baseline_Msps"])
    assert d["seconds"] == pytest.approx(d["t2_s"] - d["t1_s"])
    if mode in ("exact", "duplex"):  # 13 bursts a carrier a block
        assert d[count] == F * 2 * 2 * iters
    if mode == "downlink":
        assert d[count] == F * 2 * 8 * 2 * iters
    assert bench_files() == before


def test_noise_guard():
    assert bench.k_difference(1.0, 2.0) == 1.0
    for t1, t2 in ((1.0, 1.05), (0.001, 0.015), (0.5, 0.4)):
        with pytest.raises(bench.NoisyTiming):
            bench.k_difference(t1, t2)


def test_noisy_attempts_end_in_an_error_line(monkeypatch, capsys):
    """A clock that makes t(2k) = t(k) fails the guard on every attempt:
    three attempts, then the error line and the exception."""
    calls = []
    real = bench.measure

    def fake_clock():  # every run takes 1 s, whatever its length
        fake_clock.t += 0.5
        return fake_clock.t
    fake_clock.t = 0.0

    def measure(*a, **k):
        calls.append(1)
        return real(*a, clock=fake_clock, **k)

    monkeypatch.setattr(bench, "measure", measure)
    for k, v in {"BENCH_MODE": "downlink", "BENCH_CHANNELS": "1",
                 "BENCH_ITERS": "1", "BENCH_REPS": "1"}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(bench.NoisyTiming):
        bench.main(["--device", "cpu"])
    assert len(calls) == bench.ATTEMPTS
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "downlink_chain_throughput"
    assert line["value"] == 0.0 and "NoisyTiming" in line["error"]


def test_other_failures_are_not_retried(monkeypatch, capsys):
    calls = []

    def broken(*a, **k):
        calls.append(1)
        raise torch.cuda.OutOfMemoryError("out of memory")

    monkeypatch.setattr(bench, "measure", broken)
    monkeypatch.setenv("BENCH_CHANNELS", "1")
    with pytest.raises(torch.cuda.OutOfMemoryError):
        bench.main(["--device", "cpu"])
    assert len(calls) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "uplink_chain_throughput"
    assert "OutOfMemoryError" in line["error"]


def test_without_cuda_the_bench_exits_non_zero():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without CUDA")
    out = subprocess.run(
        [sys.executable, "-m", "openbts_ttsou_tpu_torch.bench"], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "BENCH_CHANNELS": "1"})
    assert out.returncode != 0
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["value"] == 0.0 and "CUDA is not available" in line["error"]


def test_cpu_baseline_reads_the_tracked_caches(tmp_path):
    """The mirror's rate comes from the tracked `bench/baseline_cpu.json`
    (a checkout without it is an error, not a build), the reference
    harness's from `bench/baseline_ref.json` where that holds the
    mode's rate, and nothing is written."""
    before = bench_files()
    tracked = json.loads((ROOT / "bench" / "baseline_cpu.json").read_text())
    sps = tracked["samples_per_s"]
    assert sps > 0 and bench.measure_mirror_baseline() == sps
    assert bench.measure_cpu_baseline("exact") == (
        sps, "hand-written mirror", sps)
    src = tmp_path / "bench"
    src.mkdir()
    with pytest.raises(FileNotFoundError):
        bench.measure_cpu_baseline("exact", src)
    (src / "baseline_cpu.json").write_text(json.dumps(tracked))
    (src / "baseline_ref.json").write_text(json.dumps(
        {"samples_per_s": 1.0, "samples_per_s_duplex": 2.0}))
    assert bench.measure_cpu_baseline("duplex_decoded", src) == (
        2.0, "reference sigProcLib", sps)
    assert bench.measure_cpu_baseline("exact", src) == (
        1.0, "reference sigProcLib", sps)
    assert bench.measure_cpu_baseline("downlink", src) == (
        sps, "hand-written mirror", sps)
    assert sorted(p.name for p in src.iterdir()) == [
        "baseline_cpu.json", "baseline_ref.json"]
    assert bench_files() == before


def test_k1_shapes_counts_cuda_calls_by_shape(monkeypatch):
    """`common.k1_shapes` counts the resampler's calls on CUDA tensors by
    (rows, T, p, q, taps), passes every call through, records none on the
    CPU, and puts the entry back."""
    from openbts_ttsou_tpu_torch.ops import fir
    from openbts_ttsou_tpu_torch.tools import common

    class OnCard:  # what the wrapper reads of a CUDA tensor
        is_cuda = True

        def __init__(self, *shape):
            self.shape = shape

        def numel(self):
            return int(np.prod(self.shape))

    calls = []
    monkeypatch.setattr(fir, "polyphase_resample",
                        lambda x, p, q, lpf: calls.append((x, p, q)) or x)
    inner = fir.polyphase_resample
    lpf = np.zeros(651, np.float32)
    x = torch.zeros((2, 130), dtype=torch.complex64)
    with common.k1_shapes() as shapes:
        assert fir.polyphase_resample is not inner
        for t in (OnCard(4, 16250), OnCard(4, 16250), OnCard(2, 3, 24000)):
            assert fir.polyphase_resample(t, 96, 65, lpf) is t
        fir.polyphase_resample(x, 96, 65, lpf)
    assert fir.polyphase_resample is inner and len(calls) == 4
    assert shapes == {(4, 16250, 96, 65, 651): 2, (6, 24000, 96, 65, 651): 1}


# ---- the sweep ------------------------------------------------------------

def jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("quick", [False, True])
def test_sweep_grid_and_iters_equal_the_jax_tool(monkeypatch, tmp_path,
                                                 capsys, quick):
    rows = {"jax": [], "port": []}

    def fake(key):
        def run_one(mode, carriers, iters, max_toa=0, **kw):
            rows[key].append((mode, carriers, iters, max_toa))
            return {"value": 1.0}
        return run_one

    jax_sweep = jax_tool("bench_sweep")
    monkeypatch.setattr(jax_sweep, "run_one", fake("jax"))
    monkeypatch.setattr(sys, "argv", ["bench_sweep", "--out",
                                      str(tmp_path / "jax.json")]
                        + (["--quick"] if quick else []))
    jax_sweep.main()
    monkeypatch.setattr(bench_sweep, "run_one", fake("port"))
    rec = bench_sweep.main(["--device", "cpu", "--out",
                            str(tmp_path / "port.json")]
                           + (["--quick"] if quick else []))
    # the JAX rows, downlink raised to its card floor of 32 blocks
    assert rows["port"] == [
        (m, c, max(k, 32) if m == "downlink" else k, t)
        for m, c, k, t in rows["jax"]] and len(rows["jax"]) == (
        5 if quick else 18)
    assert [k for m, c, k, t in rows["port"] if m == "downlink"] == (
        [32] if quick else [32, 32, 32])
    assert [bench_sweep.jax_iters(m, c) for m, c, k, t in rows["port"]] \
        == [k for m, c, k, t in rows["jax"]]
    assert rec["ok"] and len(rec["rows"]) == len(rows["jax"])
    assert json.loads((tmp_path / "port.json").read_text()) == rec
    assert ("exact", 1024, 4, 4) in rows["port"] or quick


def test_sweep_writes_under_build_by_default(monkeypatch, tmp_path):
    """Without --out the record goes to the tools' output directory,
    `build/tools/` (moved to tmp_path here, so that a card sweep's record
    there survives the test); --min-iters raises every row's blocks."""
    from openbts_ttsou_tpu_torch.tools import common

    assert common.OUT_DIR == ROOT / "build" / "tools"
    monkeypatch.setattr(common, "OUT_DIR", tmp_path / "tools")
    monkeypatch.setattr(bench_sweep, "run_one",
                        lambda mode, carriers, iters, max_toa=0, **kw:
                        {"value": 2.0})
    rec = bench_sweep.main(["--device", "cpu", "--quick"])
    assert Path(rec["out"]) == tmp_path / "tools" / "bench_sweep.json"
    assert json.loads(Path(rec["out"]).read_text())["rows"] == rec["rows"]
    assert [r["iters"] for r in rec["rows"]] == [32, 32, 32, 24, 24]
    rec = bench_sweep.main(["--device", "cpu", "--quick", "--min-iters",
                            "28"])
    assert [r["iters"] for r in rec["rows"]] == [32, 32, 32, 28, 28]


def test_sweep_row_failures_are_recorded(monkeypatch, tmp_path):
    """A bench that fails gives a row with its error and a sweep that is
    not ok; a bench past the row's deadline too; the sweep as a process
    then exits non-zero."""
    monkeypatch.setenv("BENCH_RACH_SLOTS", "nine")  # not a TN: ValueError
    r = bench_sweep.run_one("exact", 1, 1, 0, device="cpu", timeout=120)
    assert "ValueError" in r["error"] and r["value"] == 0.0
    monkeypatch.delenv("BENCH_RACH_SLOTS")
    r = bench_sweep.run_one("exact", 1, 1, 0, device="cpu", timeout=0.5)
    assert "past 0.5 s" in r["error"]
    out = subprocess.run(
        [sys.executable, "-m", "openbts_ttsou_tpu_torch.tools.bench_sweep",
         "--device", "cpu", "--quick", "--timeout", "0.5", "--out",
         str(tmp_path / "s.json")], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert not rec["ok"] and len(rec["rows"]) == 5
    assert all("error" in r for r in rec["rows"])


# ---- entry() --------------------------------------------------------------

def test_entry_matches_graft_entry():
    spec = importlib.util.spec_from_file_location(
        "graft", ROOT / "__graft_entry__.py")
    graft = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(graft)
    jfn, (jst, jframe) = graft.entry()
    jst2, jres = jfn(jst, jframe)
    fn, (st, frame) = entry.entry(device="cpu")
    assert frame.device.type == "cpu"
    np.testing.assert_array_equal(frame.numpy(), np.asarray(jframe))
    st2, res = fn(st, frame)
    for name in ("detected", "timing", "is_rach", "rssi"):
        np.testing.assert_array_equal(getattr(res, name).numpy(),
                                      np.asarray(getattr(jres, name)), name)
    np.testing.assert_allclose(res.soft_bits.numpy(),
                               np.asarray(jres.soft_bits), atol=2e-4)
    assert int(st2.fn) == int(jst2.fn) == 1


def test_entry_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.stimulus(1, "cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_sweep.main([])
