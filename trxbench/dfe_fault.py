"""A fault planted in the port's equalizer, for the check of a cell's
comparison where the equalizer runs: its feedback taps zeroed, so that
it filters forward alone. On the card, as `trxbench/control.py` runs the
entry's own faults:

    python -m trxbench.dfe_fault --workload rxbank512dfe.tu_rach \\
        --seeds 101-103 --seconds 2

One JSON line a seed, as the control's; the benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from typing import Iterator

import torch

from trxbench import control, run, spec


@contextlib.contextmanager
def zeroed_feedback() -> Iterator[None]:
    """The port's `equalize_burst` given zero feedback taps while the
    context lasts."""
    from openbts_ttsou_tpu_torch.ops import dfe

    inner = dfe.equalize_burst

    def broken(burst, toa, sps, feedforward, feedback):
        return inner(burst, toa, sps, feedforward, torch.zeros_like(feedback))

    dfe.equalize_burst = broken
    try:
        yield
    finally:
        dfe.equalize_burst = inner


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="101-103")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.Cell(spec.benchmark(), args.workload)
    for seed in control.seeds_of(args.seeds):
        with zeroed_feedback():
            out = run.run_cell(cell, seed, args.seconds, False, device)
        print(json.dumps({"kind": "fault:zeroed_feedback", "seed": seed,
                          "numbers": control.values(
                              out["result"]["compared"]),
                          "correct": out["result"]["correct"]}), flush=True)
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
