"""Host ms a call in the exact receiver: the program's `rx.exact` span
(`_exact_rx`: the 13 frames of the frame loop, or the batched schedule)
less the `sync.*` spans inside it, the mean over the window's calls
(program spans, host clock, untraced). None where the program records
no spans or its record of the window is incomplete."""

from trxbench import spans


def read(rec: dict):
    return spans.host_ms_less_waits(rec, "rx.exact")
