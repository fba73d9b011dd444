"""Readings for the limits of a cell's comparison, on the card at the
cell's own size: the program's on many seeds, the control's and each
planted fault's on a few.

    python -m trxbench.control --workload rxbank512.tsc1 \\
        --seeds 101-112 --control-seeds 3 --fault-seeds 3 --seconds 2

The program's readings come from whole runs (`run.run_cell`, short
windows at the cell's load). The control is the reference put in the
program's place and computed one precision below the configuration's:
TF32 (`allow_tf32`) where the configuration states float32 with TF32
off, from the same states and inputs as the program's sampled calls.
A fault is one of the entry's `FAULTS`, planted in the port while a
whole run goes. One JSON line each; the benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from trxbench import run, spec


def seeds_of(text: str) -> list[int]:
    """'101-112' or '5,9,13'."""
    if "-" in text.strip("-"):
        lo, hi = text.split("-")
        return list(range(int(lo), int(hi) + 1))
    return [int(s) for s in text.split(",")]


def values(worst: dict) -> dict:
    return {k: v["value"] if isinstance(v, dict) else v
            for k, v in worst.items()}


def control_numbers(check: dict) -> dict:
    """The control's numbers: the reference in TF32 in the program's
    place, compared as the program is."""
    entry, pool = check["entry"], check["pool"]
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        kept = []
        for k in check["kept"]:
            st, out = entry.reference(k["state_before"], pool[k["item"]],
                                      k["first"])
            kept.append(dict(k, out=out, state_after=st))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    return entry.compare(kept, pool)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="101-112")
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.Cell(spec.benchmark(), args.workload)
    seeds = seeds_of(args.seeds)

    def emit(kind, seed, numbers, **extra):
        print(json.dumps({"kind": kind, "seed": seed,
                          "numbers": values(numbers), **extra}), flush=True)

    for n, seed in enumerate(seeds):
        out = run.run_cell(cell, seed, args.seconds, False, device)
        emit("program", seed, out["result"]["compared"],
             correct=out["result"]["correct"],
             calls=out["result"]["attempted"])
        if n < args.control_seeds:
            emit("control", seed, control_numbers(out["check"]))
        del out
        torch.cuda.empty_cache()
    for name in getattr(cell.entry, "FAULTS", ()):
        for seed in seeds[: args.fault_seeds]:
            with cell.entry.fault(name):
                out = run.run_cell(cell, seed, args.seconds, False, device)
            emit(f"fault:{name}", seed, out["result"]["compared"],
                 correct=out["result"]["correct"])
            del out
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
