"""The port's spans and profiler hooks (the counterpart of the JAX
package's `utils/profiling.py`; the reference has none beyond logging).

Spans: `span(name)` times a region on the host with
`time.perf_counter_ns()` and keeps `(name, start_ns, end_ns, parent,
root_seq)` in an in-memory ring:

    with profiling.span("rx.exact"):
        ...

or as a decorator, `@profiling.span("fec.decode")`. `parent` is the name
of the span open around it on the same thread (None for a root); a span
opened with none open is a root, and every span inside it carries the
root's sequence number. Each root also keeps the offset from the
`perf_counter_ns` clock to the epoch clock that `torch.profiler` stamps
its events with (`clock_offset_ns`). While a profiler runs, each span is
also a host operation in its record, so a trace names it; otherwise a
span costs about a microsecond. (A span is recorded as a function
scope, a `cpu_op`, not as `torch.profiler.record_function`'s user
annotation: on a card the profiler lays an image of each annotation
over the device's timeline, which a reading of the device's busy time
would take for device work.) Spans named `sync.<site>` hold exactly
one statement that waits for the device (a host sync). Recording is on
from import; `recording(False)` turns it off.
`spans_between(t0, t1)` returns the spans of the roots inside a stretch
of the `perf_counter_ns` clock; `dropped()` counts the spans the ring
has lost.

Traces: `trace(dir)` writes a Chrome trace of the CPU and CUDA activity
of a block (the spans included); `maybe_trace()` does so into the
directory that OPENBTS_TORCH_TRACE names. A profiler that fails raises:
a trace asked for and not written is an error, not an untraced run.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import os
import threading
import time
from typing import Iterator

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

#: spans the ring holds: a 51 s window of the 512-carrier uplink bank
#: (~150 spans a block, ~250 blocks) about three times over
RING_SPANS = 1 << 17


class _Stack(threading.local):
    def __init__(self):
        # open spans, innermost last: (name, root_seq, parent, the
        # profiler's record or None, start_ns), or None where recording
        # was off as the span opened
        self.frames: list = []


class Recorder:
    """The ring of finished spans and each thread's stack of open ones."""

    def __init__(self, maxlen: int = RING_SPANS):
        self.maxlen = maxlen
        self.on = True
        self._ring: collections.deque = collections.deque(maxlen=maxlen)
        self._offsets: dict[int, int] = {}
        self._stack = _Stack()
        self._seq = itertools.count()
        self._dropped = 0
        self._lost_end_ns = -1  # end of the newest span the ring dropped

    def span(self, name: str) -> "Span":
        return Span(self, name)

    def dropped(self) -> int:
        return self._dropped

    def clock_offset_ns(self, root_seq: int) -> int | None:
        return self._offsets.get(root_seq)

    def spans_between(self, t0_ns: int, t1_ns: int) -> list | None:
        """The kept spans, oldest first, of every root that started at or
        after `t0_ns` and ended at or before `t1_ns`; None where the ring
        dropped a span that ended at or after `t0_ns` (the stretch may be
        incomplete)."""
        ring = tuple(self._ring)
        if self._lost_end_ns >= t0_ns:
            return None
        roots = {s[4] for s in ring
                 if s[3] is None and s[1] >= t0_ns and s[2] <= t1_ns}
        return [s for s in ring if s[4] in roots]

    def _evict(self, old: tuple) -> None:
        """Count the span the full ring is about to drop."""
        self._dropped += 1
        self._lost_end_ns = old[2]
        if old[3] is None:
            self._offsets.pop(old[4], None)


class Span:
    """A named region: a context manager, or a decorator whose function
    runs inside it. It holds no state of its own, so one object serves
    any number of nested, repeated or concurrent uses."""

    __slots__ = ("_rec", "name")

    def __init__(self, rec: Recorder, name: str):
        self._rec = rec
        self.name = name

    def __enter__(self) -> "Span":
        rec = self._rec
        frames = rec._stack.frames
        if not rec.on:
            frames.append(None)
            return self
        top = frames[-1] if frames else None
        if top is None:
            root, parent = next(rec._seq), None
            rec._offsets[root] = time.time_ns() - time.perf_counter_ns()
        else:
            root, parent = top[1], top[0]
        start = time.perf_counter_ns()
        rf = None
        if _autograd_profiler._is_profiler_enabled:
            # inside the span's times: the span encloses the event
            rf = _RecordFunctionFast(self.name)
            rf.__enter__()
        frames.append((self.name, root, parent, rf, start))
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        rec = self._rec
        f = rec._stack.frames.pop()
        if f is not None:
            name, root, parent, rf, start = f
            if rf is not None:
                rf.__exit__(None, None, None)
            end = time.perf_counter_ns()
            ring = rec._ring
            if len(ring) == rec.maxlen:
                rec._evict(ring[0])
            ring.append((name, start, end, parent, root))
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)
        return spanned


#: the process's recorder, which the module functions below use
RECORDER = Recorder()


@functools.lru_cache(maxsize=None)
def span(name: str) -> Span:
    """The span named `name` in the process's recorder (one object a
    name)."""
    return RECORDER.span(name)


def recording(on: bool) -> None:
    """Turn the recording of spans on or off (on from import). Off, a
    span records nothing and shows nothing to a profiler."""
    RECORDER.on = bool(on)


def dropped() -> int:
    """Spans the ring has dropped to make room, since import."""
    return RECORDER.dropped()


def spans_between(t0_ns: int, t1_ns: int) -> list | None:
    """`Recorder.spans_between` of the process's recorder: the spans,
    as (name, start_ns, end_ns, parent, root_seq) on the
    `time.perf_counter_ns()` clock, of the roots inside [t0_ns, t1_ns];
    None where the ring dropped some of them."""
    return RECORDER.spans_between(t0_ns, t1_ns)


def clock_offset_ns(root_seq: int) -> int | None:
    """`time.time_ns() − time.perf_counter_ns()` as root `root_seq`
    opened: add it to a span's times to put them on the clock of
    `torch.profiler`'s events. None once the root has left the ring."""
    return RECORDER.clock_offset_ns(root_seq)


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
