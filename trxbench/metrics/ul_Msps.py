"""Uplink device-rate samples served a second, in millions: every call
completed in the window × its samples (carriers × 24000 a 13-frame
block), over the time from the window's start to the last call's
outputs on the host."""


def read(rec: dict):
    if not rec["calls"]:
        return None
    return len(rec["calls"]) * rec["samples_per_call"] / rec["window_s"] / 1e6
