"""Kernel launches a call: the kernels the profiler saw on the device in
the traced stretch, over the calls in it."""


def read(rec: dict):
    st = rec.get("stretch")
    if not st or not st["calls"]:
        return None
    return st["kernels"] / st["calls"]
