"""Host syncs a call as the program counts them: its `sync.*` spans, the
mean over the window's calls (program spans, untraced). The same
quantity as `host_syncs_per_block`, counted by the program over every
window call instead of by `torch.cuda.set_sync_debug_mode` over two
calls after it. None where the program records no spans or its record
of the window is incomplete."""

from trxbench import spans


def read(rec: dict):
    return spans.mean_syncs(rec)
