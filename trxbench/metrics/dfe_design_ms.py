"""Host ms a call in the DFE design (K4): the program's `rx.dfe_design`
span (`design_dfe` over the block's bursts, inside the estimation gate)
less the `sync.*` spans inside it, the mean over the window's calls
(program spans, host clock, untraced). None where the program records
no such span in some call, or its record of the window is
incomplete."""

from trxbench import spans


def read(rec: dict):
    return spans.host_ms_less_waits(rec, "rx.dfe_design")
