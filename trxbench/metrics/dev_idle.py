"""The device's idle share of a call, %: 1 − the device's busy time a
call (the union of its operations, kernels and copies, in the traced
stretch: device clock) over the time a call takes in the window
(untraced: host clock). The stretch's own host-clock length includes the
profiler's overhead, so it is not the denominator."""


def read(rec: dict):
    st = rec.get("stretch")
    if not st or not st["calls"] or not rec["calls"]:
        return None
    busy = st["busy_s"] / st["calls"]
    period = rec["window_s"] / len(rec["calls"])
    return 100.0 * (1.0 - busy / period)
