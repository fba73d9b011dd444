"""The profiler's record of a traced stretch, reduced to what the metric
readers take.

A traced run profiles two stretches of calls after its window has
closed (the window itself runs untraced). The device stretch records
the card's activity alone, which adds the least to the host's time: its
busy time, launches and kernel times. The host
stretch records the host's operators too, to name what the host was
doing while the card sat idle; the benchmark marks each call there with
its own spans (`trxbench.call` around the entry call, `trxbench.host`
around the copy of its outputs), which bound the stretch on the
profiler's clock. The events are read from the profiler's kineto
results directly: `key_averages` takes seconds per tens of thousands of
events.
"""

from __future__ import annotations

import torch

CALL_SPAN = "trxbench.call"
HOST_SPAN = "trxbench.host"
TOP = 10


def _kind(ev) -> str:
    """'device' (a kernel, copy or set on the card), 'op' (a host
    operator or a benchmark span) or '' (anything else: the device-side
    image of a span, runtime and driver calls, the profiler's own)."""
    try:
        act = str(ev.activity_type()).lower()
    except (AttributeError, RuntimeError):
        act = ""
    if ev.device_type() == torch.autograd.DeviceType.CUDA:
        if "annotation" in act or ev.name() in (CALL_SPAN, HOST_SPAN):
            return ""
        return "device"
    if any(w in act for w in ("runtime", "driver", "python", "overhead")):
        return ""
    return "op"


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _events(prof) -> tuple[list, list, list]:
    """(device events, host ops, benchmark spans) as (start_ns, end_ns,
    name)."""
    dev, ops, spans = [], [], []
    for ev in prof.profiler.kineto_results.events():
        kind = _kind(ev)
        if not kind:
            continue
        s = ev.start_ns()
        item = (s, s + ev.duration_ns(), ev.name())
        if kind == "device":
            dev.append(item)
        elif item[2] in (CALL_SPAN, HOST_SPAN):
            spans.append(item)
        else:
            ops.append(item)
    return dev, ops, spans


def _top(d: dict) -> list:
    return sorted(([n[:120], v] for n, v in d.items()),
                  key=lambda x: -x[1])[:TOP]


def reduce_device(prof, window_s: float) -> dict:
    """The device stretch, profiled with CUDA activity alone (the least
    the profiler adds to the host): every device operation it recorded
    belongs to the stretch's calls, whose host-clock length is
    `window_s`. Returns, in seconds: `window_s`, `busy_s` (the union of
    device operations, kernels and copies), `kernels` (launches),
    `k1` [(start_ns, seconds)] of the resampler's kernel in start order,
    and `device_ops` (at most TOP [name, seconds], most time first)."""
    dev, _, _ = _events(prof)
    busy = _union([(s, e) for s, e, _ in dev])
    dev_s: dict[str, float] = {}
    launches, k1 = 0, []
    for s, e, n in dev:
        dev_s[n] = dev_s.get(n, 0.0) + (e - s) / 1e9
        if n.startswith(("Memcpy", "Memset")):
            continue
        launches += 1
        if "resample_kernel" in n:
            k1.append((s, (e - s) / 1e9))
    return {"window_s": window_s,
            "busy_s": sum(e - s for s, e in busy) / 1e9,
            "kernels": launches, "k1": sorted(k1),
            "device_ops": _top(dev_s)}


def busy_s(prof) -> float:
    """Seconds in which an operation (a kernel, copy or set) ran on the
    card in a session profiled with CUDA activity alone: the union of
    the device operations it recorded."""
    dev, _, _ = _events(prof)
    return sum(e - s for s, e in _union([(s, e) for s, e, _ in dev])) / 1e9


def idle_gaps(prof) -> list:
    """The host stretch, profiled with CPU and CUDA activity: the device's
    idle time between the first call's start and the last host copy's
    end, summed by the host operation running at each gap's middle (the
    innermost one; "(no host op)" where only Python ran). At most TOP
    [name, seconds], most time first."""
    dev, ops, spans = _events(prof)
    if not spans:
        raise RuntimeError("the traced stretch holds no benchmark spans")
    t0, t1 = min(s for s, _, _ in spans), max(e for _, e, _ in spans)
    busy = _union([(max(s, t0), min(e, t1)) for s, e, _ in dev
                   if e > t0 and s < t1])
    gaps: dict[str, float] = {}
    ops.sort(key=lambda o: (o[0], -o[1]))
    stack: list = []  # host ops open at the sweep's time, innermost last
    i, prev = 0, t0
    for s, e in busy + [(t1, t1)]:
        if s > prev:
            mid = (prev + s) // 2
            while i < len(ops) and ops[i][0] <= mid:
                while stack and stack[-1][1] < ops[i][0]:
                    stack.pop()
                stack.append(ops[i])
                i += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            name = stack[-1][2] if stack else "(no host op)"
            gaps[name] = gaps.get(name, 0.0) + (s - prev) / 1e9
        prev = max(prev, e)
    return _top(gaps)


def profiler(host: bool):
    """A torch.profiler session over the card's activity, and the host's
    operators too where `host`."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
    if host or not acts:
        acts.append(ProfilerActivity.CPU)
    return profile(activities=acts)
