"""The cell `rxbank512dfe.tu_rach` on the CPU at a few carriers: a sound
run is correct and, traced, reads the equalizer's spans; each of the
entry's planted faults, and the equalizer's feedback taps zeroed, makes
it not correct."""

from __future__ import annotations

import pytest

from trxbench import dfe_fault
from trxbench.tests.conftest import cpu_run, small_cell

CELL = "rxbank512dfe.tu_rach"
SEED = 2 ** 31 + 1616


def test_sound_run_is_correct():
    cell = small_cell(CELL)
    r = cpu_run(cell, seed=SEED, seconds=1.0)["result"]
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert all(c["value"] == 0 for c in r["compared"].values())
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end} == {
        "ul_Msps", "block_ms_p90", "setup_s"}


def test_traced_run_reads_the_equalizer_spans():
    cell = small_cell(CELL)
    r = cpu_run(cell, seed=SEED, traced=True)["result"]
    assert r["correct"]
    got = set(r["metrics"])
    assert {"dfe_design_ms", "equalize_ms", "rx_host_ms",
            "prog_syncs_per_block", "dispatch_ms"} <= got
    assert got <= {m["name"] for m in cell.per_layer}
    assert 0 < r["metrics"]["equalize_ms"]["value"] \
        < r["metrics"]["rx_host_ms"]["value"]


@pytest.mark.parametrize("fault", small_cell(CELL).entry.FAULTS)
def test_planted_fault_is_not_correct(fault):
    cell = small_cell(CELL)
    with cell.entry.fault(fault):
        r = cpu_run(cell, seed=SEED, seconds=0.5)["result"]
    assert not r["correct"], r["compared"]


def test_zeroed_feedback_is_not_correct():
    """The equalizer filtering forward alone changes soft bits that the
    comparison catches, and nothing the known answer sees."""
    cell = small_cell(CELL)
    with dfe_fault.zeroed_feedback():
        r = cpu_run(cell, seed=SEED, seconds=0.5)["result"]
    assert not r["correct"], r["compared"]
    assert r["compared"]["soft_gap"]["value"] > \
        r["compared"]["soft_gap"]["limit"]
    assert r["compared"]["known_misses"]["value"] == 0
