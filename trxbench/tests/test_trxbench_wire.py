"""The cell `trxd128.wire` on the CPU at a few carriers: a sound run is
correct and, traced, reads the daemon's spans; each of the entry's
planted faults makes it not correct."""

from __future__ import annotations

import pytest

from trxbench.tests.conftest import cpu_run, small_cell

CELL = "trxd128.wire"
SEED = 2 ** 31 + 2020


def test_sound_run_is_correct():
    cell = small_cell(CELL)
    r = cpu_run(cell, seed=SEED, seconds=1.0)["result"]
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert all(c["value"] == 0 for c in r["compared"].values())
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end} == {
        "ul_Msps", "setup_s"}


def test_traced_run_reads_the_daemon_spans():
    cell = small_cell(CELL)
    r = cpu_run(cell, seed=SEED, traced=True)["result"]
    assert r["correct"]
    got = set(r["metrics"])
    assert {"wire_ms", "marshal_ms", "rx_host_ms", "walk_ms",
            "prog_syncs_per_block", "sync_wait_ms", "dispatch_ms"} <= got
    assert got <= {m["name"] for m in cell.per_layer}
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert m["wire_ms"] + m["marshal_ms"] + m["rx_host_ms"] \
        < m["dispatch_ms"]


@pytest.mark.parametrize("fault", small_cell(CELL).entry.FAULTS)
def test_planted_fault_is_not_correct(fault):
    cell = small_cell(CELL)
    with cell.entry.fault(fault):
        r = cpu_run(cell, seed=SEED, seconds=0.5)["result"]
    assert not r["correct"], r["compared"]
