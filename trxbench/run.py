"""The port's benchmark: one cell of `BENCHMARK.json`, one run.

    python -m trxbench.run --workload rxbank512.tsc1 --seed 7 \\
        --seconds 45 --trace 0

A cell is found by name from files (`trxbench/spec.py`). The run makes
the cell's inputs on the card from `--seed`, warms the entry point on
each of them, then drives it in a closed loop for `--seconds`: one
caller, one call in flight, the next call issued once the last one's
outputs are on the host. Where one of the cell's end-to-end metrics is
read from the device trace, each call of the window runs under a
profiler session of its own, with the card's activity alone. With
`--trace 1` the window runs untraced, then a few more calls under
`torch.profiler` and a few under `torch.cuda.set_sync_debug_mode`, and
the result gives the per-layer metrics instead of the end-to-end ones.
After the window the program's outputs of its first call and of calls
drawn from the seed, copied to the host as they come, are compared with
the plain reference under `trxbench/reference/`.

Standard output ends with one JSON line: `correct`, `attempted`,
`failed`, `metrics`, `device` (and `breakdown` with `--trace 1`) and,
last, `compared`: each number compared with its limit, which are also
the last lines of standard error. The run exits non-zero and prints no
result without enough CUDA devices, or when `jax`, `jaxlib`, `flax` or
the JAX package is loaded once the window has closed.

Every cache stays inside the checkout: the port's kernels in
`build/kernels/`, Triton's in `build/triton/`, PyTorch's extensions in
`build/torch_extensions/`, CUDA's JIT cache in `build/cuda_cache/`.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import warnings  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _var, _dir in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = str(ROOT / "build" / _dir)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from trxbench import gaps, spec, trace  # noqa: E402
from trxbench.roofline import PEAKS  # noqa: E402

T_IMPORTS = time.perf_counter()

#: top-level module names the run must not load
FORBIDDEN = ("jax", "jaxlib", "flax", "openbts_ttsou_tpu")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def log(msg: str) -> None:
    print(f"[trxbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name, compared whole, is one of
    FORBIDDEN."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None
                                          else modules)}
    return sorted(names & set(FORBIDDEN))


# ---- the port's K1: its own launch counter and the shapes it was called at

class K1Shapes:
    """Records (rows, T, p, q, taps) of every call of the port's
    `ops.fir.polyphase_resample` on a CUDA tensor, in order, while
    installed."""

    def __init__(self):
        from openbts_ttsou_tpu_torch.ops import fir

        self.fir = fir
        self.inner = fir.polyphase_resample
        self.shapes: list[tuple] = []

    def __enter__(self):
        inner, shapes = self.inner, self.shapes

        def recorded(x, p, q, lpf):
            if x.is_cuda:
                shapes.append((x.numel() // x.shape[-1], x.shape[-1], p, q,
                               len(lpf)))
            return inner(x, p, q, lpf)

        self.fir.polyphase_resample = recorded
        return self

    def __exit__(self, *exc):
        self.fir.polyphase_resample = self.inner
        return False


def k1_launches() -> int:
    from openbts_ttsou_tpu_torch.ops import cuda_fir

    return cuda_fir.polyphase_resample_cuda.launches


def card_line(device: torch.device) -> dict:
    """The card's name, power limit and clocks (`nvidia-smi`), and the
    versions."""
    info = {"torch": torch.__version__, "cuda": torch.version.cuda}
    if device.type != "cuda":
        return {"card": "cpu", **info}
    info["card"] = torch.cuda.get_device_name(device)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        info["nvidia_smi"] = smi.stdout.strip().splitlines()[
            device.index or 0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        info["nvidia_smi"] = f"unavailable ({type(e).__name__})"
    return info


def _mean_ms(calls: list) -> float | None:
    """Mean latency of `calls`, ms."""
    return statistics.fmean((c["done"] - c["issue"]) * 1e3 for c in calls) \
        if calls else None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---- one run -------------------------------------------------------------

#: window calls compared with the reference, besides the run's first call
SAMPLE = 4


class Stretches:
    """Where a traced run looks once its window has closed, by the count
    of calls after the window: the device stretch under the profiler with
    CUDA activity alone, the host stretch with the host's operators too,
    the sync stretch under `set_sync_debug_mode("warn")`, each after an
    untraced call. The window itself runs untraced. An untraced run looks
    after its window nowhere; where `window` (the cell has an end-to-end
    metric from the device trace), it profiles each call of its window."""

    def __init__(self, traced: bool, window: bool = False):
        #: every call of the window profiled by itself, CUDA activity alone
        self.window = window and not traced
        self.device = range(1, 4) if traced else range(0)
        self.host = range(5, 6) if traced else range(0)
        self.sync = range(7, 9) if traced else range(0)
        self.calls = self.sync.stop if traced else 0


def _kept(first: bool, item: int, before, entry, host) -> dict:
    """A call for the comparison, its state and outputs copied to the
    host, so that they hold no device memory while the window runs."""
    return {"first": first, "item": item, "state_before": before,
            "state_after": gaps.moved(entry.state(), "cpu"),
            "out": gaps.moved(host, "cpu")}


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device: torch.device, t_start: float = T_START) -> dict:
    """Set up, warm, drive the window, look at the traced stretches,
    compare. Returns the result line (`result`), what the card line
    prints (`info`) and what the control needs (`check`); raises on any
    failure of the program."""
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 as configured
    torch.set_num_threads(2)
    on_card = device.type == "cuda"
    look = Stretches(traced, any(m["source"] == "device_trace"
                                 for m in cell.end_to_end))

    k1_0 = k1_launches() if on_card else 0
    marks = {"imports": T_IMPORTS - t_start,
             "start": time.perf_counter() - t_start}
    with K1Shapes() as shapes:
        entry = cell.entry.Entry(cell.config, device)
        _sync(device)
        marks["entry"] = time.perf_counter() - t_start
        pool = entry.make_inputs(cell.generator, cell.traffic["params"],
                                 seed)
        _sync(device)
        marks["inputs"] = time.perf_counter() - t_start
        kept, misses = [], 0
        # warm: every input once, the first from the initial state, the
        # last under the profiler where the window is profiled
        for item, x in enumerate(pool):
            before = gaps.moved(entry.state(), "cpu") if item == 0 else None
            warm_prof = trace.profiler(host=False) \
                if look.window and item == len(pool) - 1 else None
            if warm_prof is not None:
                warm_prof.__enter__()
            host = entry.to_host(entry.call(x))
            if warm_prof is not None:
                warm_prof.__exit__(None, None, None)
                trace.busy_s(warm_prof)
                del warm_prof
            misses += entry.known_misses(host, item)
            if item == 0:
                kept.append(_kept(True, 0, before, entry, host))
                marks["warm_first"] = time.perf_counter() - t_start
        _sync(device)
        setup_s = time.perf_counter() - t_start
        setup_peak = torch.cuda.max_memory_allocated(device) if on_card \
            else None
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)

        # the window: the calls compared are those running at SAMPLE
        # times drawn from the seed
        rng = np.random.default_rng(int(seed) % 2 ** 64)
        due = sorted(rng.uniform(0.0, 0.9 * seconds, SAMPLE))
        calls: list[dict] = []
        failed = 0
        # an entry whose known answer needs whole periods of calls asks
        # for one at the least; the window ends on a whole period
        min_calls = getattr(entry, "min_calls", 1)
        period = getattr(entry, "period", 1)
        busy: list[float] = []
        t0 = time.perf_counter()
        i = 0
        while True:
            item = i % len(pool)
            take = bool(due) and time.perf_counter() - t0 >= due[0]
            while due and time.perf_counter() - t0 >= due[0]:
                due.pop(0)
            before = gaps.moved(entry.state(), "cpu") if take else None
            if look.window:
                prof = trace.profiler(host=False)
                prof.__enter__()
            t_issue = time.perf_counter()
            out = entry.call(pool[item])
            t_ret = time.perf_counter()
            host = entry.to_host(out)
            t_done = time.perf_counter()
            if look.window:
                prof.__exit__(None, None, None)
                busy.append(trace.busy_s(prof))
                del prof
            calls.append({"issue": t_issue, "ret": t_ret, "done": t_done})
            miss = entry.known_misses(host, item)
            misses += miss
            failed += miss > 0
            if take:
                kept.append(_kept(False, item, before, entry, host))
            del out
            i += 1
            if t_done - t0 >= seconds and i >= min_calls and \
                    i % period == 0:
                break
        window_s = calls[-1]["done"] - t0
        window_peak = torch.cuda.max_memory_allocated(device) if on_card \
            else None

        # the traced stretches, after the window
        prof = dev_prof = host_prof = None
        k1_span = [0, 0]
        stretch: list[dict] = []
        syncs = 0
        for j in range(look.calls):
            item = i % len(pool)
            if j in (look.device.start, look.host.start):
                prof = trace.profiler(host=j == look.host.start)
                prof.__enter__()
                if j == look.device.start:
                    k1_span[0] = len(shapes.shapes)
            with torch.profiler.record_function(trace.CALL_SPAN):
                t_issue = time.perf_counter()
                if j in look.sync and on_card:
                    with warnings.catch_warnings(record=True) as seen:
                        warnings.simplefilter("always")
                        torch.cuda.set_sync_debug_mode("warn")
                        try:
                            out = entry.call(pool[item])
                        finally:
                            torch.cuda.set_sync_debug_mode(0)
                    syncs += sum("synchroniz" in str(w.message)
                                 for w in seen)
                else:
                    out = entry.call(pool[item])
            with torch.profiler.record_function(trace.HOST_SPAN):
                host = entry.to_host(out)
            stretch.append({"issue": t_issue, "done": time.perf_counter()})
            if prof is not None and j in (look.device.stop - 1,
                                          look.host.stop - 1):
                prof.__exit__(None, None, None)
                if j == look.device.stop - 1:
                    dev_prof, k1_span[1] = prof, len(shapes.shapes)
                else:
                    host_prof = prof
                prof = None
            miss = entry.known_misses(host, item)
            misses += miss
            failed += miss > 0
            del out
            i += 1
        if hasattr(entry, "finish"):
            misses += entry.finish()
    k1_count = (k1_launches() - k1_0) if on_card else 0

    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)

    # the comparison, once the window has closed and the peak is read
    describe = entry.describe()
    entry.release()
    del host, before
    if on_card:
        torch.cuda.empty_cache()
    worst = entry.compare(kept, pool)
    worst["known_misses"] = misses
    unknown = set(worst) ^ set(cell.limits)
    if unknown:
        raise KeyError(f"numbers and limits do not match: {sorted(unknown)}")
    compared = {n: {"value": v, "limit": cell.limits[n]}
                for n, v in worst.items()}
    correct = all(c["value"] <= c["limit"] for c in compared.values())

    card = card_line(device)
    rec = {"setup_s": setup_s, "calls": calls, "window_s": window_s,
           "samples_per_call": entry.samples_per_call,
           "window_peak_bytes": window_peak, "window_busy_s": busy,
           "synced": list(look.sync), "syncs": syncs,
           "peaks": PEAKS.get(card["card"]),
           "k1_stretch_shapes": shapes.shapes[k1_span[0]: k1_span[1]]}
    if traced:
        first = stretch[look.device.start]
        last = stretch[look.device.stop - 1]
        rec["stretch"] = trace.reduce_device(
            dev_prof, last["done"] - first["issue"])
        rec["stretch"]["calls"] = len(look.device)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = cell.reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    lat = sorted((c["done"] - c["issue"]) * 1e3 for c in calls)
    hist: dict = {}
    for sh in shapes.shapes:
        key = json.dumps(list(sh))
        hist[key] = hist.get(key, 0) + 1
    info = {**card, **describe,
            "calls": len(calls), "latency_p50_ms": lat[len(lat) // 2],
            "latency_quartiles_ms": statistics.quantiles(lat, n=4)
            if len(lat) > 1 else lat,
            "halves_mean_ms": [_mean_ms(calls[: len(calls) // 2]),
                               _mean_ms(calls[len(calls) // 2:])],
            "window_busy_ms_quartiles": statistics.quantiles(
                [b * 1e3 for b in busy], n=4) if len(busy) > 1 else busy,
            "compared_calls": len(kept),
            "k1_launches": k1_count, "k1_shapes": hist,
            "k1_shapes_total": len(shapes.shapes),
            "setup_peak_bytes": setup_peak, "setup_marks_s": marks}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": card["card"], "count": 1,
           "memory_peak_bytes": max(setup_peak or 0, window_peak or 0)}
    result = {"correct": correct, "attempted": len(calls) + len(stretch),
              "failed": failed, "metrics": metrics, "device": dev}
    if traced:
        st = rec["stretch"]
        dev["busy_s"] = st["busy_s"]
        dev["window_s"] = st["window_s"]
        result["breakdown"] = {"device_ops": st["device_ops"],
                               "idle_gaps": trace.idle_gaps(host_prof)}
    result["compared"] = compared
    return {"result": result, "info": info,
            "check": {"entry": entry, "kept": kept, "pool": pool}}


class ForbiddenModules(RuntimeError):
    def __init__(self, found):
        super().__init__(f"loaded after the window: {', '.join(found)}")
        self.found = found


def main(argv=None) -> int:
    args = parse_args(argv)
    bench = spec.benchmark()
    cell = spec.Cell(bench, args.workload)
    if not torch.cuda.is_available():
        log("no CUDA device: torch.cuda.is_available() is false")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"the cell asks for {cell.chips} devices, "
            f"{torch.cuda.device_count()} present")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    log(json.dumps({"workload": args.workload, "seed": args.seed,
                    "seconds": args.seconds, "trace": args.trace}))
    try:
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       device)
    except ForbiddenModules as e:
        log(str(e))
        return 3
    log("card " + json.dumps(out["info"]))
    print(json.dumps(out["result"]), flush=True)
    for name, c in out["result"]["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
