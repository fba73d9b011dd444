"""Mode × carriers sweep of the port's bench.

Runs `python -m openbts_ttsou_tpu_torch.bench` as its own process for
every row of the JAX package's sweep grid (`tools/bench_sweep.py`:
exact at 8, 128, 512 and 1024 carriers, decoded and downlink at 128, 512
and 1024, duplex at 8, 128, 512 and 1024, duplex_decoded at 128, 512 and
1024, and exact at 1024 with the windowed TSC correlation, max_toa 4),
with the same iters rule but for a floor of 32 blocks in downlink, each
row under its own deadline. A row whose
bench fails or runs past the deadline is recorded with its error, and
the sweep then exits non-zero. The record goes to
`build/tools/bench_sweep.json` (rewritten after every row) unless given
`--out`.

    python -m openbts_ttsou_tpu_torch.tools.bench_sweep           # 18 rows
    python -m openbts_ttsou_tpu_torch.tools.bench_sweep --quick   # 5 @128
    python -m openbts_ttsou_tpu_torch.tools.bench_sweep --min-iters 16
    python -m openbts_ttsou_tpu_torch.tools.bench_sweep --device cpu --quick
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

from openbts_ttsou_tpu_torch.tools import common

TOOL = "bench_sweep"
MODES = ("exact", "decoded", "downlink", "duplex", "duplex_decoded")

#: (mode, carriers, max_toa), the JAX sweep's grid (:48-66)
GRID = ([("exact", c, 0) for c in (8, 128, 512, 1024)]
        + [("decoded", c, 0) for c in (128, 512, 1024)]
        + [("downlink", c, 0) for c in (128, 512, 1024)]
        + [("duplex", c, 0) for c in (8, 128, 512, 1024)]
        + [("duplex_decoded", c, 0) for c in (128, 512, 1024)]
        + [("exact", 1024, 4)])
QUICK = [(m, 128, 0) for m in MODES]


#: blocks a row runs at least where the JAX rule misses the guard on an
#: H100: a downlink block takes 1.1–2.8 ms at 128–1024 carriers, so the
#: rule's 4 blocks leave dt at 6–11 ms against the bench's 0.02 s
MIN_ITERS = {"downlink": 32}


def jax_iters(mode: str, carriers: int) -> int:
    """The JAX sweep's rule (:72-74): blocks enough that the timed span
    stays well above the bench's noise guard on the TPU."""
    if carriers <= 128:
        return 32 if mode in ("exact", "decoded", "downlink") else 24
    return 8 if carriers <= 256 else 4


def iters_for(mode: str, carriers: int, floor: int = 0) -> int:
    """A row's blocks: the JAX rule, raised to the mode's card floor and
    to `floor` (`--min-iters`)."""
    return max(jax_iters(mode, carriers), MIN_ITERS.get(mode, 0), floor)


def run_one(mode: str, carriers: int, iters: int, max_toa: int = 0,
            device: str = "cuda", timeout: float = 1500) -> dict:
    """One bench row as its own process: its JSON line, or {"error"}."""
    env = dict(os.environ, BENCH_MODE=mode, BENCH_CHANNELS=str(carriers),
               BENCH_ITERS=str(iters), BENCH_MAX_TOA=str(max_toa))
    try:
        p = subprocess.run(
            [sys.executable, "-m", "openbts_ttsou_tpu_torch.bench",
             "--device", device], cwd=common.ROOT, env=env,
            capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"value": 0.0, "error": f"bench ran past {timeout} s"}
    lines = p.stdout.strip().splitlines()
    try:
        rec = json.loads(lines[-1]) if lines else {}
    except json.JSONDecodeError:
        rec = {}
    if p.returncode != 0 or "error" in rec or not rec.get("value"):
        rec.setdefault("value", 0.0)
        rec["error"] = (f"exit {p.returncode}: {rec.get('error', '')} "
                        f"{p.stderr[-400:]}")
    return rec


def main(argv=None) -> dict:
    ap = common.parser(__doc__)
    ap.add_argument("--quick", action="store_true",
                    help="the five modes at 128 carriers")
    ap.add_argument("--timeout", type=float, default=1500,
                    help="seconds a row's process may take")
    ap.add_argument("--min-iters", type=int, default=0,
                    help="blocks a row runs at least (k of the k/2k "
                         "difference)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = common.device_of(args)
    out = common.out_path(args.out, "bench_sweep.json")
    rec = {"tool": TOOL, "rows": [], "ok": True, "out": str(out),
           **common.card(dev)}
    for mode, carriers, max_toa in QUICK if args.quick else GRID:
        iters = iters_for(mode, carriers, args.min_iters)
        common.log(TOOL, f"{mode} @ {carriers} max_toa={max_toa} "
                         f"iters={iters}")
        r = run_one(mode, carriers, iters, max_toa, device=str(dev),
                    timeout=args.timeout)
        r.update(mode=mode, carriers=carriers, iters=iters)
        if max_toa:
            r["max_toa"] = max_toa
        rec["ok"] = rec["ok"] and "error" not in r
        rec["rows"].append(r)
        common.log(TOOL, f"  -> {r.get('value')} {r.get('unit', '')} "
                         f"{r.get('error', '')}")
        out.write_text(json.dumps(rec, indent=1))
    return common.emit(rec)


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
