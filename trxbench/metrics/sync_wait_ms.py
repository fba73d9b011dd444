"""Host ms a call blocked on the card: the program's `sync.*` spans,
each around one statement that waits for the device (the receiver's
gates, its pageable table copies), summed a call, the mean over the
window's calls (program spans, host clock, untraced). None where the
program records no spans or its record of the window is incomplete."""

from trxbench import spans


def read(rec: dict):
    return spans.mean_waits_ms(rec)
