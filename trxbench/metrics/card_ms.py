"""The card's busy time a call, ms: every call of the window profiled by
itself with the card's activity alone, the union of its device
operations (kernels and copies, device clock), summed over the window's
calls and divided by their number. The card time a window of the cell's
carriers costs. None where no call was profiled, or where the profiler
saw nothing on the device (no card)."""


def read(rec: dict):
    busy = rec.get("window_busy_s") or []
    if not busy or not sum(busy):
        return None
    return 1e3 * sum(busy) / len(busy)
