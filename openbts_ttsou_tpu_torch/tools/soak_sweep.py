"""The wire soak across carriers × load × block geometry.

Runs `daemon_soak` once a row, each as its own `python -m` process with
a timeout, and writes one JSON artifact: a header with the attachment's
`transfer_probe` record (null on the CPU, which has none) and the rows,
each with its `config` (the knobs), its `why` (what the row shows) and
the soak's record, or the error that ended it. A row that fails fails
the sweep (non-zero exit) after the artifact is written.

    python -m openbts_ttsou_tpu_torch.tools.soak_sweep            # full grid
    python -m openbts_ttsou_tpu_torch.tools.soak_sweep --quick    # frontier

The artifact goes to build/tools/soak_sweep.json unless `--out` names
another path.
"""

from __future__ import annotations

import json
import subprocess
import sys

from openbts_ttsou_tpu_torch.tools import common, transfer_probe

TOOL = "soak_sweep"
#: warm-up blocks a row: the daemon's clock lead grows a frame a late
#: block from 20 to a 26-frame block's 26
WARMUP = 6

#: (carriers, compact, ul_slots, dl_carriers, block_frames, depth, bus, why)
FRONTIER = [
    (1, 1, 7, -1, 26, 2, "replay",
     "1 carrier at full load: the smallest deployment, where the air's "
     "4.615 ms a frame must be met if anywhere"),
    (2, 1, 7, -1, 26, 2, "replay", "2 carriers at full load"),
    (4, 1, 7, -1, 26, 2, "replay", "4 carriers at full load"),
    (8, 1, 7, -1, 26, 2, "replay", "8 carriers at full load"),
]
MORE = [
    (2, 1, 7, -1, 52, 3, "replay",
     "52-frame blocks and depth 3: fewer, larger steps; the block is "
     "longer than the daemon's largest clock lead (40 frames)"),
    (4, 1, 7, -1, 52, 3, "replay", "52-frame blocks at 4 carriers"),
    (8, 1, 7, -1, 52, 3, "replay", "52-frame blocks at 8 carriers"),
    (16, 1, 7, -1, 26, 2, "replay", "16 carriers at full load"),
    (32, 1, 7, -1, 26, 2, "replay", "32 carriers at full load"),
    (8, 0, 7, -1, 26, 2, "replay",
     "dense result fetch at the frontier point (bytes before compaction)"),
    (16, 1, 2, 4, 26, 2, "replay", "sparse load at 16 carriers"),
    (32, 1, 2, 8, 26, 2, "replay", "sparse load at 32 carriers"),
    (64, 1, 2, 16, 26, 2, "replay", "sparse load at 64 carriers"),
    (128, 1, 2, 32, 26, 2, "replay",
     "sparse load at 128 carriers, the JAX sweep's largest row"),
    (8, 1, 3, -1, 26, 2, "socket",
     "radios behind a bus-server process (SocketBus across a process "
     "boundary, where libusb would sit); ms a frame and bus MB/s"),
]


def run_row(row: tuple, device: str, base_port: int, timeout: float
            ) -> dict:
    carriers, compact, ul_slots, dl_c, bf, depth, bus, _ = row
    blocks = 25 if carriers <= 32 else 15
    if bf >= 52:
        blocks = max(blocks // 2, 8)
    cmd = [sys.executable, "-m", "openbts_ttsou_tpu_torch.tools.daemon_soak",
           "--device", device, "--carriers", str(carriers),
           "--blocks", str(blocks), "--warmup", str(WARMUP),
           "--compact", str(compact), "--ul-slots", str(ul_slots),
           "--dl-carriers", str(dl_c), "--depth", str(depth),
           "--block-frames", str(bf), "--bus", bus,
           "--base-port", str(base_port), "--timeout", str(timeout)]
    try:
        p = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout + 60, cwd=common.ROOT)
    except subprocess.TimeoutExpired:
        return {"error": f"daemon_soak ran past {timeout + 60} s"}
    lines = p.stdout.strip().splitlines()
    if p.returncode != 0 or not lines:
        return {"error": f"exit {p.returncode}: {p.stderr[-800:]}"}
    return json.loads(lines[-1])


def main(argv=None) -> dict:
    ap = common.parser(__doc__)
    ap.add_argument("--quick", action="store_true",
                    help="the frontier rows only (1-8 carriers, bf 26)")
    ap.add_argument("--out", default=None,
                    help="artifact path (default: "
                         "build/tools/soak_sweep.json)")
    ap.add_argument("--base-port", type=int, default=36700)
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds a row may take")
    args = ap.parse_args(argv)
    dev = common.device_of(args)
    out = common.out_path(args.out, "soak_sweep.json")
    header = (transfer_probe.main(["--device", str(dev)])
              if dev.type == "cuda" else None)
    artifact = {"tool": TOOL, "transfer_probe": header, "rows": [],
                **common.card(dev)}
    for row in FRONTIER if args.quick else FRONTIER + MORE:
        carriers, compact, ul_slots, dl_c, bf, depth, bus, why = row
        common.log(TOOL, f"c={carriers} compact={compact} ul={ul_slots} "
                         f"dl={dl_c} bf={bf} depth={depth} bus={bus}")
        r = run_row(row, str(dev), args.base_port, args.timeout)
        r["config"] = {"carriers": carriers, "compact": bool(compact),
                       "ul_slots": ul_slots, "dl_carriers": dl_c,
                       "block_frames": bf, "depth": depth, "bus": bus}
        r["why"] = why
        artifact["rows"].append(r)
        common.log(TOOL, f"  -> {r.get('ms_per_frame')} ms/frame "
                         f"realtime={r.get('realtime')} {r.get('error', '')}")
        out.write_text(json.dumps(artifact, indent=1))
    artifact["out"] = str(out)
    common.emit(artifact)
    failed = [r["config"] for r in artifact["rows"] if "error" in r]
    if failed:
        raise RuntimeError(f"soak rows failed: {failed}")
    return artifact


if __name__ == "__main__":
    main()
