"""The host↔card transfer path: small-transfer round trip, and host to
device and device to host rates from pageable and from pinned memory.

The block daemon moves int16 sample windows to the card and packed
results back every block, so the soak's rows are read against what
this attachment delivers (`soak_sweep` puts this record in its header).
The probe has no meaning on the CPU and raises without a card.

    python -m openbts_ttsou_tpu_torch.tools.transfer_probe [--mb 4] [--reps 5]
"""

from __future__ import annotations

import time

import torch

from openbts_ttsou_tpu_torch.tools import common

TOOL = "transfer_probe"


def main(argv=None) -> dict:
    ap = common.parser(__doc__)
    ap.add_argument("--mb", type=float, default=4.0,
                    help="MiB a large transfer")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    dev = common.device_of(args)
    if dev.type != "cuda":
        raise RuntimeError("CUDA is not available; the transfer probe "
                           "measures a card and has no CPU mode")
    nbytes = int(args.mb * (1 << 20)) // 4 * 4
    src = {"pageable": torch.arange(nbytes // 4, dtype=torch.float32)}
    src["pinned"] = src["pageable"].pin_memory()
    on_dev = torch.empty(nbytes // 4, dtype=torch.float32, device=dev)
    back = {"pageable": torch.empty_like(src["pageable"]),
            "pinned": torch.empty_like(src["pinned"]).pin_memory()}
    tiny = torch.zeros(16, dtype=torch.float32)

    def seconds(fn) -> list:
        fn()  # warm
        torch.cuda.synchronize(dev)
        out = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(dev)
            out.append(time.perf_counter() - t0)
        return out

    rtt = seconds(lambda: tiny.to(dev).cpu())
    rec = {"tool": TOOL, "probe_mb": args.mb, "reps": args.reps,
           "rtt_ms": min(rtt) * 1e3, "rtt_ms_median": sorted(rtt)[
               len(rtt) // 2] * 1e3}
    for kind in ("pageable", "pinned"):
        h2d = seconds(lambda: on_dev.copy_(src[kind], non_blocking=True))
        d2h = seconds(lambda: back[kind].copy_(on_dev, non_blocking=True))
        rec[f"h2d_{kind}_s_min"] = min(h2d)
        rec[f"d2h_{kind}_s_min"] = min(d2h)
        rec[f"h2d_{kind}_MBps"] = nbytes / min(h2d) / 1e6
        rec[f"d2h_{kind}_MBps"] = nbytes / min(d2h) / 1e6
    if not torch.equal(back["pinned"], src["pageable"]):
        raise RuntimeError("the round trip changed the data")
    rec.update(common.card(dev))
    return common.emit(rec)


if __name__ == "__main__":
    main()
