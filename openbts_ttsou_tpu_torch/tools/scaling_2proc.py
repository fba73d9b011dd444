"""Two-process scaling of one sharded program on one card: the same
global sharded-duplex program run by one process that owns every shard,
then by two processes that own half the shards each.

The port of `tools/scaling_2proc.py`. Both runs are `python -m
openbts_ttsou_tpu_torch.parallel.worker` ranks on the same device
(`cuda:0` by default). NCCL refuses two ranks on one card, so the group
is gloo: the halos and the state merge that cross ranks stage through
the CPU (`parallel/mesh.py`). The efficiency is per_step(1 process) /
per_step(2 processes), the slower rank's; each worker times the steps
after its first. Both runs check their shards against the serial chain
(`verified`, `mismatches_all_ranks`), and the two-process run's soft
bits (frame by frame) and tx (shard by shard) must equal the
one-process run's bit for bit (the workers' digests). Two CUDA contexts
on one card time-slice, so the ratio may fall either side of 1.

Writes `build/tools/scaling_2proc.json` unless `--out` says otherwise
(the root `SCALING_2PROC.json` is the JAX package's record).

    python -m openbts_ttsou_tpu_torch.tools.scaling_2proc \\
        [--carriers 96] [--shards 2] [--steps 4] [--duplex 1]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

from openbts_ttsou_tpu_torch.tools import common

TOOL = "scaling_2proc"
WORKER = "openbts_ttsou_tpu_torch.parallel.worker"


def run_workers(nproc: int, shards: int, carriers: int, steps: int,
                duplex: bool, device: str, timeout: float) -> list[dict]:
    """nproc worker ranks over gloo (a `file://` rendezvous in a fresh
    directory), each owning shards // nproc of the mesh's time shards;
    their JSON records in rank order. Every rank is killed past
    `timeout` seconds or when one fails."""
    with tempfile.TemporaryDirectory(prefix="scaling_2proc_") as tmp:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        procs = [subprocess.Popen(
            [sys.executable, "-m", WORKER, "--world-size", str(nproc),
             "--rank", str(r), "--init-method", init, "--backend", "gloo",
             "--shards-per-rank", str(shards // nproc),
             "--steps", str(steps), "--carriers", str(carriers),
             "--device", device, "--timeout", str(timeout),
             *(["--duplex"] if duplex else [])],
            cwd=common.ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(nproc)]
        outs = []
        try:
            end = time.monotonic() + timeout
            for r, p in enumerate(procs):
                out, err = p.communicate(
                    timeout=max(end - time.monotonic(), 1))
                lines = out.strip().splitlines()
                if p.returncode != 0 or not lines:
                    raise RuntimeError(f"rank {r} of {nproc} exited "
                                       f"{p.returncode}: {err[-3000:]}")
                outs.append(json.loads(lines[-1]))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    return outs


def _by_step(workers: list[dict], key: str, steps: int) -> list:
    """The workers' per-step digest lists joined in the mesh's order:
    step by step, rank by rank."""
    joined = []
    for s in range(steps):
        for w in workers:
            per = len(w[key]) // steps
            joined += w[key][s * per: (s + 1) * per]
    return joined


def compare(single: list[dict], two: list[dict], steps: int) -> dict:
    """Where the two-process run's soft bits and tx differ from the
    one-process run's: counts of differing frames and shard blocks."""
    out = {}
    for key in ("soft_digests", "tx_digests"):
        a, b = _by_step(single, key, steps), _by_step(two, key, steps)
        out[key.replace("digests", "differ")] = (
            sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b)))
        out[key.replace("digests", "compared")] = len(a)
    return out


def main(argv=None) -> dict:
    ap = common.parser(__doc__)
    ap.add_argument("--carriers", type=int, default=96)
    ap.add_argument("--shards", type=int, default=2,
                    help="time shards of the mesh in all (even)")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--duplex", type=int, default=1)
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds a run of the workers may take")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = common.device_of(args)
    if args.shards % 2:
        raise ValueError("--shards must split evenly over two processes")
    duplex = bool(args.duplex)
    runs = {}
    for nproc in (1, 2):
        t0 = time.perf_counter()
        runs[nproc] = run_workers(nproc, args.shards, args.carriers,
                                  args.steps, duplex, str(dev), args.timeout)
        common.log(TOOL, f"{nproc} process(es): "
                         f"{max(w['per_step_s'] for w in runs[nproc]):.4f} "
                         f"s a step ({time.perf_counter() - t0:.1f} s)")
    t1 = runs[1][0]["per_step_s"]
    t2 = max(w["per_step_s"] for w in runs[2])
    diff = compare(runs[1], runs[2], args.steps)
    equal = (diff["soft_differ"] == 0 and diff["tx_differ"] == 0
             and all(w["ok"] and w["mismatches_all_ranks"] == 0
                     for w in runs[1] + runs[2]))
    strip = ("soft_digests", "tx_digests", "traffic")
    result = {
        "metric": "two_process_scaling_efficiency",
        "value": t1 / t2 if t2 else 0.0,
        "unit": "per-step time ratio (1 proc / 2 proc), same program",
        "detail": {
            "carriers": args.carriers, "devices_total": args.shards,
            "steps": args.steps, "duplex": duplex, "device": str(dev),
            "backend": "gloo", "per_step_s_1proc": t1,
            "per_step_s_2proc": t2, "results_equal": equal, **diff,
            "workers_1proc": [{k: v for k, v in w.items() if k not in strip}
                              for w in runs[1]],
            "workers_2proc": [{k: v for k, v in w.items() if k not in strip}
                              for w in runs[2]]},
        **common.card(dev)}
    path = common.out_path(args.out, "scaling_2proc.json")
    path.write_text(json.dumps(result, indent=1))
    result["path"] = str(path)
    return common.emit(result)


if __name__ == "__main__":
    main()
