"""Host ms a window in the FEC decode leg: the program's `fec.decode`
span (`decode_block`: XCCH, RACH and TCH/FACCH decoding) less the
`sync.*` spans inside it, the mean over the window's calls (program
spans, host clock, untraced). None where the program records no spans or
its record of the window is incomplete."""

from trxbench import spans


def read(rec: dict):
    return spans.host_ms_less_waits(rec, "fec.decode")
