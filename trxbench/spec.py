"""Finding a cell's parts by name, from files alone.

A cell `<config>.<traffic>` of `BENCHMARK.json` is made of:

* `trxbench/configs/<config>.json`: the deployment; its `entry` names
* `trxbench/entries/<entry>.py`: the adapter that builds the program,
  calls the entry point and compares with the reference. Its class
  `Entry(config, device)` has `samples_per_call` (device-rate uplink
  samples a call), `make_inputs(generator, params, seed)` (the pool of
  call inputs, cycled), `state()` (the program's carried state, by
  reference), `call(item)`, `to_host(out)`, `known_misses(host, item)`
  (what the call's outputs show wrong against what the generator
  expects of pool item `item`), `describe()`, `compare(kept, pool)` (the
  worst of each compared number), `reference(state_before, item, first)`
  (for the control) and `release()`; optionally `min_calls` and
  `finish()`. Its module's `FAULTS` and `fault(name)` plant faults for
  the check of the comparison;
* `trxbench/traffic/<traffic>.json`: the mix: its `generator`, the name
  of a module `trxbench/generators/<generator>.py` whose `make(params,
  config, seed, device)` makes the pool (`trxbench/generate.py`), and
  its `params`;
* `trxbench/limits/<config>.<traffic>.json`: the limit of each number
  the comparison gives, and the readings it was set from;
* `trxbench/metrics/<metric>.py`, one for each metric the cell reports:
  a function `read(rec)` that returns the metric's value from the run's
  record, or None where it finds nothing to read.

The harness holds no list of cells, configurations, entries or metrics;
a new one is a new file and a new entry in `BENCHMARK.json`.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _load_json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    return json.loads(path.read_text())


def _load_module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """Everything one workload of `BENCHMARK.json` needs, found by name."""

    def __init__(self, bench: dict, name: str, here: Path = HERE):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"there are {sorted(cells)}")
        self.workload = cells[name]
        self.name = name
        self.chips = int(self.workload["chips"])
        self.config = _load_json(
            here / "configs" / f"{self.workload['config']}.json")
        self.traffic = _load_json(
            here / "traffic" / f"{self.workload['traffic']}.json")
        self.generator = _load_module(
            here / "generators" / f"{self.traffic['generator']}.py",
            f"trxbench_generator_{self.traffic['generator']}")
        self.limits = _load_json(here / "limits" / f"{name}.json")["limits"]
        self.entry = _load_module(here / "entries"
                                  / f"{self.config['entry']}.py",
                                  f"trxbench_entry_{self.config['entry']}")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]
        self._here = here

    def reader(self, metric: str):
        """The `read` function of `metrics/<metric>.py`."""
        return _load_module(self._here / "metrics" / f"{metric}.py",
                            f"trxbench_metric_{metric.replace('.', '_')}"
                            ).read
