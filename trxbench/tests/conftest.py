"""Shared pieces of the benchmark's own tests (run with
`python -m pytest trxbench/tests` from the repository's root)."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import pytest
import torch

from trxbench import run, spec

ROOT = Path(__file__).resolve().parents[2]
SMALL = 4  # carriers of a CPU run


def small_cell(name: str, carriers: int = SMALL, here: Path | None = None,
               bench: dict | None = None) -> spec.Cell:
    """The cell `name` as BENCHMARK.json defines it, at `carriers`."""
    cell = spec.Cell(bench or spec.benchmark(), name,
                     **({"here": here} if here else {}))
    cell.config = dict(cell.config, carriers=carriers)
    return cell


def cpu_run(cell: spec.Cell, seed: int = 7, seconds: float = 0.5,
            traced: bool = False) -> dict:
    return run.run_cell(cell, seed, seconds, traced, torch.device("cpu"),
                        t_start=time.perf_counter())


@pytest.fixture
def bench_copy(tmp_path: Path) -> Path:
    """A copy of BENCHMARK.json and trxbench/ to add files to."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "trxbench", tmp_path / "trxbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def read_json(path: Path) -> dict:
    return json.loads(path.read_text())
