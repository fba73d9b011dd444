"""The 90th percentile of every call's latency in the window, in ms: from
the entry call to its outputs on the host (inclusive quantiles)."""

import statistics


def read(rec: dict):
    lat = [(c["done"] - c["issue"]) * 1e3 for c in rec["calls"]]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=10, method="inclusive")[8]
