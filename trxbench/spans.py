"""The program's own spans over a run's window, for the span readers.

The port records a span around each entry call (a root: `trx.uplink`,
`l1.step`) and around its parts, on the `time.perf_counter_ns()` clock
that the harness stamps each window call with
(`openbts_ttsou_tpu_torch.utils.profiling`). Spans named `sync.<site>`
each hold one statement that waits for the device. A program without
the recorder, or whose record of the window is incomplete, gives None.
"""

from __future__ import annotations

#: slack, ns, around the window's ends: a float second on the
#: perf_counter clock carries well under a nanosecond of rounding
SLACK_NS = 1000


def _between():
    """The program's `spans_between`, or None where it has none."""
    try:
        from openbts_ttsou_tpu_torch.utils import profiling
    except ImportError:
        return None
    return getattr(profiling, "spans_between", None)


def window(rec: dict) -> list[list[tuple]] | None:
    """The spans of each window call, one list a call in call order: the
    spans whose root lies inside the window, each root inside its own
    call. None where the program records no spans, the record dropped
    spans inside the window, or the roots and the calls do not pair up
    one for one."""
    calls = rec.get("calls") or []
    between = _between()
    if not calls or between is None:
        return None
    spans = between(int(calls[0]["issue"] * 1e9) - SLACK_NS,
                    int(calls[-1]["done"] * 1e9) + SLACK_NS)
    if spans is None:
        return None
    roots = sorted((s for s in spans if s[3] is None), key=lambda s: s[1])
    if len(roots) != len(calls):
        return None
    by_root: dict[int, list] = {r[4]: [] for r in roots}
    for c, r in zip(calls, roots):
        if not (c["issue"] * 1e9 - SLACK_NS <= r[1]
                and r[2] <= c["done"] * 1e9 + SLACK_NS):
            return None
    for s in spans:
        by_root[s[4]].append(s)
    return [by_root[r[4]] for r in roots]


def is_sync(s: tuple) -> bool:
    return s[0].startswith("sync.")


def ms(s: tuple) -> float:
    return (s[2] - s[1]) / 1e6


def waits_ms(spans: list[tuple], outer: tuple | None = None) -> float:
    """Host ms blocked in the sync spans of `spans` (those inside
    `outer`'s interval where it is given); a sync span inside another
    counts once."""
    return sum(ms(s) for s in spans
               if is_sync(s) and not (s[3] or "").startswith("sync.")
               and (outer is None or outer[1] <= s[1] and s[2] <= outer[2]))


def host_ms_less_waits(rec: dict, name: str) -> float | None:
    """The mean a call of the host ms inside the spans named `name`, less
    the sync spans inside them; None where a call holds no such span."""
    calls = window(rec)
    if calls is None:
        return None
    total = 0.0
    for spans in calls:
        own = [s for s in spans if s[0] == name]
        if not own:
            return None
        total += sum(ms(s) - waits_ms(spans, s) for s in own)
    return total / len(calls)


def mean_waits_ms(rec: dict) -> float | None:
    calls = window(rec)
    if calls is None:
        return None
    return sum(waits_ms(spans) for spans in calls) / len(calls)


def mean_syncs(rec: dict) -> float | None:
    calls = window(rec)
    if calls is None:
        return None
    return sum(sum(map(is_sync, spans)) for spans in calls) / len(calls)
