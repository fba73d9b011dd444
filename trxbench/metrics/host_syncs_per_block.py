"""Synchronising calls a call: what `torch.cuda.set_sync_debug_mode`
reports while the sync-counted stretch runs, over the calls in it. The
benchmark's own copy of the outputs to the host runs with the mode off
and is not counted."""


def read(rec: dict):
    n = len(rec.get("synced", ()))
    if not n:
        return None
    return rec["syncs"] / n
