"""Host ms from the entry call to its return, the mean over the window's
calls. Read from the benchmark's own clock; the window runs untraced in
every run, so a traced run reads it at untraced speed."""


def read(rec: dict):
    d = [(c["ret"] - c["issue"]) * 1e3 for c in rec["calls"]]
    return sum(d) / len(d) if d else None
