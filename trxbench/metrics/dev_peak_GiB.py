"""The most device memory held in the window, GiB:
`torch.cuda.max_memory_allocated()` after `reset_peak_memory_stats()` at
the window's start. The program's memory and the cell's pool of inputs,
made at set-up and resident on the card; the harness keeps the calls it
compares on the host."""


def read(rec: dict):
    b = rec.get("window_peak_bytes")
    return None if b is None else b / 2 ** 30
