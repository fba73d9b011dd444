"""Host ms a call on the daemon's UDP planes: the program's `trxd.ingest`
(the downlink data planes drained into the burst queue) and
`trxd.retire` (the oldest block's fetch, DAC write and uplink datagram
batches) spans, less the `sync.*` spans inside them, the mean over the
window's calls (program spans, host clock, untraced). None where the
program records no such spans in some call, or its record of the window
is incomplete."""

from trxbench import spans


def read(rec: dict):
    ingest = spans.host_ms_less_waits(rec, "trxd.ingest")
    retire = spans.host_ms_less_waits(rec, "trxd.retire")
    if ingest is None or retire is None:
        return None
    return ingest + retire
