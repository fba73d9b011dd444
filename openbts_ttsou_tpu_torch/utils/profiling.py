"""Profiling hooks over `torch.profiler` (the counterpart of the JAX
package's `utils/profiling.py`; the reference has none beyond logging).

Usage:
    with profiling.trace("traces/run"):   # a Chrome trace of the CPU and
        run_hot_path()                     # the CUDA activity

or set OPENBTS_TORCH_TRACE=<dir> and call `maybe_trace()` around a
region. `annotate(name)` labels a host-side region in the trace.

A profiler that fails raises: a trace asked for and not written is an
error, not an untraced run.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block's CPU ops and, when a card is present, its CUDA
    kernels; on exit write `trace.json` (Chrome trace format) under
    `log_dir`. Yields the profiler, whose `key_averages()` the caller
    may read after the block."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def maybe_trace(env: str = "OPENBTS_TORCH_TRACE") -> Iterator[None]:
    """`trace` into the directory named by the environment variable
    `env`; untraced when it is unset or empty."""
    log_dir = os.environ.get(env)
    if not log_dir:
        yield
        return
    with trace(log_dir):
        yield


def annotate(name: str) -> torch.profiler.record_function:
    """A labelled host-side region in the trace (a no-op cost when no
    profiler runs)."""
    return torch.profiler.record_function(name)
