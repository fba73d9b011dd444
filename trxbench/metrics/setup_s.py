"""Seconds from the process's start to the first timed call: the imports,
CUDA's start, the kernels from the cache (built on a checkout's first
run), the inputs made on the device and the warm calls."""


def read(rec: dict):
    return rec["setup_s"]
