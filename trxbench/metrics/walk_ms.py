"""Host ms a call in the exact receiver's threshold walk (K7): the
program's `rx.walk` span (`exact_walk` in `process_block_exact`: one
kernel launch on the card, the frame-by-frame eager walk before it had
one) less the `sync.*` spans inside it, the mean over the window's calls
(program spans, host clock, untraced). None where the program records no
such span in some call, or its record of the window is incomplete."""

from trxbench import spans


def read(rec: dict):
    return spans.host_ms_less_waits(rec, "rx.walk")
