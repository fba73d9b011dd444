"""Host ms a call in the equalizer (K5): the program's `rx.equalize`
span (`equalize_burst`, its feedback recursion over the burst's
symbols, inside the equalizer's gate) less the `sync.*` spans inside it
(its rotation table's copy), the mean over the window's calls (program
spans, host clock, untraced). None where the program records no such
span in some call, or its record of the window is incomplete."""

from trxbench import spans


def read(rec: dict):
    return spans.host_ms_less_waits(rec, "rx.equalize")
