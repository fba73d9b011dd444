"""Host ms a call marshalling the daemon's block: the program's
`trxd.marshal` span (the stale-burst dump, the dense pop of the downlink
window, the uplink window's read from the radio and the one buffer they
are packed into) less the `sync.*` span inside it (the buffer's upload
from pageable memory, which waits for the device), the mean over the
window's calls (program spans, host clock, untraced). None where the
program records no such span in some call, or its record of the window
is incomplete."""

from trxbench import spans


def read(rec: dict):
    return spans.host_ms_less_waits(rec, "trxd.marshal")
