"""What the port's tools share: the `--device` option, where outputs go,
the card's name and power limit, timing on the card, and K1's launch
count.

Timing (`measure`) reports, for one callable:

* wall ms: `perf_counter` around the call, the device synchronized
  before the stop; median and min over the reps;
* device ms: CUDA events recorded around the call; on a host-bound
  path the device waits for the host, so this spans the host's
  dispatch as well;
* busy ms, launches and idle share: one more rep under
  `torch.profiler` (where the caller asks for it; a profile of a
  per-frame loop takes seconds to read); busy is the sum of the
  device-side events, the launches are its kernels (copies and memsets
  apart), the idle share is 1 − busy / the median wall time. Whether
  the profiler sees K1, which its ctypes-loaded library launches
  through its own static CUDA runtime, has varied between card
  machines: `k1_profiled` counts the K1 launches it saw. Where it sees
  no device event at all, busy and idle share are None.

On the CPU only the wall times are reported.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Iterator

import torch

from openbts_ttsou_tpu_torch.trx.engine import resolve_device

ROOT = Path(__file__).resolve().parents[2]
#: default home of whatever a tool writes (gitignored with `build/`)
OUT_DIR = ROOT / "build" / "tools"
FRAME_MS = 60.0 / 13.0  # one TDMA frame on the air, 4.615 ms
#: H100 SXM data sheet: HBM rate and float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
SLEEP_CYCLES = 100_000_000  # torch.cuda._sleep ahead of timed calls, ~50 ms


def add_device(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; raises without a "
                         "card unless given cpu)")
    return ap


def parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with the tools' `--device` option."""
    return add_device(argparse.ArgumentParser(
        description=doc.strip().split("\n\n")[0]))


def device_of(args) -> torch.device:
    return resolve_device(args.device)


def out_path(path: str | None, name: str) -> Path:
    """`path`, or `build/tools/<name>` when it is None; its parent
    directory is created."""
    p = Path(path) if path else OUT_DIR / name
    p.parent.mkdir(parents=True, exist_ok=True)
    return p


def card(device: torch.device) -> dict:
    """The card's name and its power limit as `nvidia-smi` prints them,
    or the CPU."""
    if device.type != "cuda":
        return {"device": "cpu", "card": None}
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return {"device": torch.cuda.get_device_name(device), "card": line}


def emit(record: dict) -> dict:
    """Print the tool's record as its last JSON line and return it."""
    print(json.dumps(record), flush=True)
    return record


def log(tool: str, msg: str) -> None:
    print(f"[{tool}] {msg}", file=sys.stderr, flush=True)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def k1_launches() -> int:
    """K1's launch counter (`ops/cuda_fir.py`); tools report deltas."""
    from openbts_ttsou_tpu_torch.ops import cuda_fir

    return cuda_fir.polyphase_resample_cuda.launches


@contextlib.contextmanager
def k1_shapes() -> Iterator[dict]:
    """K1's launch shapes while the block runs: {(rows, T, p, q, taps):
    calls} of `ops.fir.polyphase_resample` on CUDA tensors (the entry
    the transceiver calls; on the CPU it runs the plain form). Their sum
    falls short of the launch count's delta where a launch bypasses that
    entry."""
    from openbts_ttsou_tpu_torch.ops import fir

    seen: dict = {}
    resample = fir.polyphase_resample

    def resample_seen(x, p, q, lpf):
        if x.is_cuda:
            key = (x.numel() // x.shape[-1], x.shape[-1], p, q, len(lpf))
            seen[key] = seen.get(key, 0) + 1
        return resample(x, p, q, lpf)

    fir.polyphase_resample = resample_seen
    try:
        yield seen
    finally:
        fir.polyphase_resample = resample


@contextlib.contextmanager
def deadline(seconds: float, what: str) -> Iterator[None]:
    """Raise TimeoutError in the main thread if the block runs past
    `seconds` (no limit when 0)."""
    if not seconds:
        yield
        return

    def fire(signum, frame):
        raise TimeoutError(f"{what} ran past {seconds} s")

    old = signal.signal(signal.SIGALRM, fire)
    signal.alarm(max(1, int(round(seconds))))
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def profile_once(fn: Callable[[], object]) -> dict:
    """fn() once under torch.profiler on the card: device busy ms (the
    sum of the device-side events, kernels and copies), their number and
    the number of kernel launches among them, the device events that
    take the most time and the host ops that take the most host self
    time. `key_averages` takes seconds on a profile of tens of thousands
    of ops. A small stage's counts varied between card runs (~26 device
    events fewer a profile in one process than in another), so its wall
    and CUDA-event times are the numbers to trust."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    top = sorted(dev, key=lambda e: e.self_device_time_total,
                 reverse=True)[:10]
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)[:10]
    return {"busy_ms": sum(e.self_device_time_total for e in dev) / 1e3,
            "device_events": sum(e.count for e in dev),
            "launches": sum(e.count for e in dev
                            if not e.key.startswith(("Memcpy", "Memset"))),
            "k1_profiled": sum(e.count for e in dev
                               if "resample_kernel" in e.key),
            "top": [{"name": e.key[:70], "count": e.count,
                     "ms": e.self_device_time_total / 1e3} for e in top],
            "host_top": [{"name": e.key[:70], "count": e.count,
                          "ms": e.self_cpu_time_total / 1e3} for e in host]}


def measure(fn: Callable[[], object], device: torch.device, reps: int = 5,
            warmup: int = 1, profile: bool = True) -> dict:
    """Time fn() on `device` (see the module's docstring); without
    `profile`, wall and device ms only. fn must do the same work on
    every call."""
    for _ in range(warmup):
        fn()
    sync(device)
    cuda = device.type == "cuda"
    wall, dev_ms = [], []
    for _ in range(reps):
        if cuda:
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
        t0 = time.perf_counter()
        fn()
        if cuda:
            e1.record()
        sync(device)
        wall.append((time.perf_counter() - t0) * 1e3)
        if cuda:
            dev_ms.append(e0.elapsed_time(e1))
    out = {"wall_ms": statistics.median(wall), "wall_ms_min": min(wall),
           "reps": reps}
    if cuda:
        out["device_ms"] = statistics.median(dev_ms)
    if cuda and profile:
        prof = profile_once(fn)
        busy = prof["busy_ms"] if prof["device_events"] else None
        out.update(busy_ms=busy, launches=prof["launches"],
                   k1_profiled=prof["k1_profiled"],
                   device_events=prof["device_events"],
                   idle_share=None if busy is None
                   else 1 - busy / out["wall_ms"])
    return out


def cuda_ms(fn: Callable[[], object], reps: int = 25) -> tuple[float, float]:
    """Device time of fn(): the median of `reps` CUDA-event intervals,
    each around one call, after 3 warm calls. The calls are queued behind
    a ~50 ms device sleep, so the device runs them back to back and the
    host's dispatch time stays out of the intervals; the second number is
    the share of the sleep the host used to queue them (< 1: it kept
    ahead)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    s0, s1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    s0.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    s1.record()
    t0 = time.perf_counter()
    for a, b in ev:
        a.record()
        fn()
        b.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return (statistics.median(a.elapsed_time(b) for a, b in ev),
            host_ms / s0.elapsed_time(s1))


def largest_fd() -> int:
    """The largest file descriptor this process holds open."""
    return max(int(fd) for fd in os.listdir("/proc/self/fd"))
