"""Roofline of the uplink's hot regions on the card: the work of each
region counted from its shapes, against the card's ceilings.

The port of `tools/roofline.py`. PyTorch has no compiled cost model, so
the tool counts each region's work from the shapes of its call; the
count does not depend on what implements the region (a kernel for K5
changes K5's time, never its count). Per burst of T = 157 symbols
(sps 1), with a complex multiply-add (CMAC) 8 flops, a real tap on a
complex sample 4, |z|² 3, a sinc tap 1:

* peak(L), the peak search on L correlation lags: 5L (power, argmax,
  sum) + 19 interpolations × 21 taps × 5 + 19·3 + 22 (the 9-step
  early-late descent and the final point);
* K1 `polyphase_resample` [rows, T_in] at p/q: 4 flops (an FMA on each
  plane) for every nonzero tap each of the T_out = ⌈T_in·p/q⌉ outputs
  uses; bytes: the input and the output (the taps' few KB left out, as
  PERF.md's bound leaves them); `kernel_bakeoff` bounds K1 with this
  count;
* K2 `detect_rach` (41-symbol template): 8·T·41 + peak(T) + 3T + 61
  (the valley over symbols 57–107); bytes T·8 in, 17 out (the
  Detection);
* K3 `analyze_traffic_burst` with `_estimate_channel` (16-symbol
  midamble on the 36-sample segment): 8·36·16 + peak(36) + 3·36 + 18,
  then 21 + 36·21·4 (the un-delay) + 7·6·4 + 21 + 6·8 (the 7 windows,
  the walk, the gain); bytes T·8 + 4 in, 17 + 6·8 + 4 out;
* K4 `design_dfe` (Nf 7, ν 5): Σ over its 7 rows of 7 + 16·Nf + 11 and,
  but for the last, 5 + 20·Nf; the back substitution 8·Nf(Nf−1)/2; the
  feedforward 8·Σ(min(ν, Nf−1−i) + 1) + 2·Nf; the feedback 2ν; bytes
  6·8 + 4 in, (7 + 5)·8 out;
* K5 `equalize_burst`: 21 + 21·4·T (un-delay) + 8·Nf·T (feedforward)
  + T·(8ν + 11) (the decision-feedback recursion) + 3T (slicer); bytes
  T·8 + 4 + (7 + 5)·8 in, T·4 out;
* K6 `demodulate_burst`: 7 + 6T (1/amplitude) + 21 + 21·4·T (delay)
  + 6T (rotation) + 3T (slicer); bytes T·8 + 8 + 4 in, T·4 out;
* K7 the threshold walk (`trx/engine.py` `exact_walk`) over
  [F, C, 8]: 8 a burst (the energy gate, the quiet, hit and miss
  updates with exp(−Δ)) + 1 a carrier a frame (thr²); bytes 8 a burst
  in (energy, four flags), 6 out (success, validity, last adoption),
  4 a carrier a frame (the entry threshold), the state in and out;
* K8 `viterbi_decode` on rows × 2K soft bits: rows · (K + 24) steps ·
  16 states · 2 branches · 3 (an add-compare-select: 2 adds and a
  compare a branch; the cost tables and the traceback are not
  counted); bytes rows·2K·4 in, rows·K out. A resident window decodes
  per carrier 20 XCCH (K 228), 104 RACH (K 18), 16 TCH (K 189) and 16
  FACCH (K 228) codewords.

The bound of a region is max(bytes / HBM rate, flops / float32 rate),
float32 because the port keeps TF32 off; the rates come from `PEAKS`,
keyed by the card's name as `nvidia-smi` prints it (an unknown card
raises unless `--hbm-bytes-per-s` and `--fp32-flops` are given).

The regions are counted and timed at `--carriers` (53,248 bursts a call
at 512, as `stage_bench` calls them). The exact uplink block is counted
as the sum of its regions, K1 65/96 and K2–K7 once each, at each of
`--block-carriers`, and timed as `uplink_block` on a block whose every
burst runs every region (`dfe_cost_probe`'s DFE-on leg: every slot a
TCH with the equalizer on; RACH correlation runs on every slot, as
the receiver does without `rach_slots`). K1 96/65 and K8 belong to the
duplex and resident windows, not to this block. Each time is wall,
CUDA-event and profiled busy ms (`common.measure`); share = bound / ms,
on CUDA-event and on busy time. On the CPU only wall times are given.
Writes `build/tools/roofline.json` unless `--out` says otherwise.

    python -m openbts_ttsou_tpu_torch.tools.roofline [--carriers 512] \\
        [--block-carriers 128,512,1024]
"""

from __future__ import annotations

import json
from typing import NamedTuple

import numpy as np
import torch

from openbts_ttsou_tpu_torch.tools import common

TOOL = "roofline"
FRAMES = 13  # a block
REPS = 3  # timed calls a region, after one warm call
T = 157  # samples a burst window (sps 1)
RACH_TAPS = 41  # RACH synch template, symbols
MID_TAPS = 16  # TSC midamble template
SEGMENT = 36  # the midamble correlation segment (16 + 2·10)
SINC = 21  # sinc interpolator taps
NF, NU = 7, 5  # DFE feedforward taps, feedback taps
CMAC = 8  # flops of a complex multiply-add
RMAC = 4  # a real tap on a complex sample
C64, F32 = 8, 4  # bytes
VITERBI_STATES, VITERBI_DEFERRAL = 16, 24
#: codeword kind → (codewords a carrier a resident window, info bits K)
VITERBI_KINDS = {"xcch": (20, 228), "rach": (104, 18), "tch": (16, 189),
                 "facch": (16, 228)}
#: card name as nvidia-smi prints it → (HBM bytes/s, float32 flop/s
#: outside the tensor cores): the H100 SXM data sheet
PEAKS = {"NVIDIA H100 80GB HBM3": (common.HBM_BYTES_PER_S,
                                   common.FP32_FLOPS)}


class Work(NamedTuple):
    flops: float
    bytes: float

    def __add__(self, other):
        return Work(self.flops + other.flops, self.bytes + other.bytes)

    def scale(self, k: float) -> "Work":
        return Work(self.flops * k, self.bytes * k)


def peaks(card_name: str | None, hbm: float | None = None,
          fp32: float | None = None) -> tuple[float, float]:
    """(HBM bytes/s, float32 flop/s) of the card: the caller's, or the
    table's for `card_name`."""
    if hbm is not None and fp32 is not None:
        return hbm, fp32
    if card_name not in PEAKS:
        raise ValueError(f"no peaks known for card {card_name!r}; pass "
                         f"--hbm-bytes-per-s and --fp32-flops")
    return PEAKS[card_name]


def bound_ms(w: Work, hbm: float, fp32: float) -> tuple[float, str]:
    """The least time the card could take for `w`, and what bounds it."""
    t_bytes, t_ops = w.bytes / hbm, w.flops / fp32
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---- the counts ------------------------------------------------------------

def k1_work(rows: int, t_in: int, p: int, q: int, lpf: np.ndarray) -> Work:
    from openbts_ttsou_tpu_torch.ops import cuda_fir, fir

    t_out = fir.polyphase_output_len(t_in, p, q)
    taps, _ = cuda_fir.branch_table(p, q, lpf.tobytes())
    nnz = (taps != 0).sum(1)  # a branch's nonzero taps
    per_row = int(nnz[np.arange(t_out) % p].sum())
    return Work(RMAC * rows * per_row, rows * (t_in + t_out) * C64)


def peak_flops(lags: int) -> int:
    return 5 * lags + 19 * (SINC * 5 + 3) + 22


def k2_work(bursts: int) -> Work:
    flops = CMAC * T * RACH_TAPS + peak_flops(T) + 3 * T + 61
    return Work(bursts * flops, bursts * (T * C64 + 17))


def k3_work(bursts: int) -> Work:
    detect = CMAC * SEGMENT * MID_TAPS + peak_flops(SEGMENT) + 3 * SEGMENT + 18
    estimate = SINC + SEGMENT * SINC * RMAC + 7 * 6 * 4 + 21 + 6 * CMAC
    return Work(bursts * (detect + estimate),
                bursts * (T * C64 + 4 + 17 + 6 * C64 + 4))


def k4_work(bursts: int) -> Work:
    rows = sum(7 + 16 * NF + 11 + (5 + 20 * NF if i < NF - 1 else 0)
               for i in range(NF))
    back = CMAC * NF * (NF - 1) // 2
    ff = CMAC * sum(min(NU, NF - 1 - i) + 1 for i in range(NF)) + 2 * NF
    return Work(bursts * (rows + back + ff + 2 * NU),
                bursts * ((NU + 1) * C64 + F32 + (NF + NU) * C64))


def k5_work(bursts: int) -> Work:
    flops = (SINC + SINC * RMAC * T + CMAC * NF * T + T * (CMAC * NU + 11)
             + 3 * T)
    return Work(bursts * flops,
                bursts * (T * C64 + F32 + (NF + NU) * C64 + T * F32))


def k5_recursion_work(bursts: int, t: int = T, nu: int = NU) -> Work:
    """The part of `k5_work` that K5's kernel runs: the recursion and the
    slicer over the feedforward output; bytes pf and the taps in, the
    rotation once, the soft bits out."""
    return Work(bursts * t * (CMAC * nu + 11 + 3),
                bursts * (t * C64 + nu * C64 + t * F32) + t * C64)


def k6_work(bursts: int) -> Work:
    flops = 7 + 6 * T + SINC + SINC * RMAC * T + 6 * T + 3 * T
    return Work(bursts * flops, bursts * (T * C64 + C64 + F32 + T * F32))


def k7_work(frames: int, carriers: int) -> Work:
    bursts = frames * carriers * 8
    state = carriers * (4 + 4 + 1) + carriers * 8 * (1 + 4)  # in
    state_out = carriers * (4 + 4) + carriers * 8 * (1 + 4 + 4)
    return Work(8 * bursts + frames * carriers,
                bursts * (8 + 6) + frames * carriers * 4 + frames * 4
                + state + state_out)


def k8_work(rows: int, k: int) -> Work:
    steps = k + VITERBI_DEFERRAL
    return Work(rows * steps * VITERBI_STATES * 2 * 3,
                rows * 2 * k * F32 + rows * k)


def regions(n_chan: int) -> list[dict]:
    """Every region at n_chan carriers: its name, the function it times,
    its work a call and its calls in one exact uplink block."""
    from openbts_ttsou_tpu_torch.models.transceiver import UplinkSpec
    from openbts_ttsou_tpu_torch.ops import fir

    spec = UplinkSpec(frames=FRAMES)
    bursts = n_chan * FRAMES * 8
    dl_in = spec.block_symbols + 130  # the duplex downlink with its tail
    out = [
        ("K1 65/96", "polyphase_resample", (n_chan, spec.block_in),
         k1_work(n_chan, spec.block_in, spec.p, spec.q,
                 fir.resampler_lpf(spec.p, spec.q, spec.taps)), 1),
        ("K1 96/65", "polyphase_resample", (n_chan, dl_in),
         k1_work(n_chan, dl_in, spec.q, spec.p,
                 fir.resampler_lpf(spec.q, spec.p, 651)), 0),
        ("K2", "detect_rach", (bursts, T), k2_work(bursts), 1),
        ("K3", "analyze_traffic_burst", (bursts, T), k3_work(bursts), 1),
        ("K4", "design_dfe", (bursts, NU + 1), k4_work(bursts), 1),
        ("K5", "equalize_burst", (bursts, T), k5_work(bursts), 1),
        ("K6", "demodulate_burst", (bursts, T), k6_work(bursts), 1),
        ("K7", "exact_walk", (FRAMES, n_chan, 8),
         k7_work(FRAMES, n_chan), 1),
    ]
    for kind, (per_chan, k) in VITERBI_KINDS.items():
        rows = per_chan * n_chan
        out.append((f"K8 {kind}", "viterbi_decode", (rows, 2 * k),
                    k8_work(rows, k), 0))
    return [{"name": n, "function": fn, "shape": list(shape), "work": w,
             "calls_per_block": calls} for n, fn, shape, w, calls in out]


def block_work(n_chan: int) -> Work:
    """The exact uplink block at n_chan carriers: its regions' sum."""
    total = Work(0.0, 0.0)
    for r in regions(n_chan):
        total = total + r["work"].scale(r["calls_per_block"])
    return total


# ---- the calls -------------------------------------------------------------

def region_calls(n_chan: int, dev: torch.device) -> dict:
    """name → a callable running that region once at n_chan carriers on
    random inputs of its shapes (K1 65/96 and K2–K6 are `stage_bench`'s
    stages)."""
    from openbts_ttsou_tpu_torch.gsm import fec
    from openbts_ttsou_tpu_torch.models import transceiver
    from openbts_ttsou_tpu_torch.ops import fir
    from openbts_ttsou_tpu_torch.tools import stage_bench
    from openbts_ttsou_tpu_torch.trx import engine as eng

    st = stage_bench.stages(n_chan, FRAMES, dev)
    rng = np.random.default_rng(1)
    spec = transceiver.UplinkSpec(frames=FRAMES)
    dl_in = spec.block_symbols + 130
    dl = torch.from_numpy(
        ((rng.standard_normal((n_chan, dl_in))
          + 1j * rng.standard_normal((n_chan, dl_in))) * 50
         ).astype(np.complex64)).to(dev)
    lpf_dl = fir.resampler_lpf(spec.q, spec.p, 651)

    cfg = eng.TrxConfig(n_chan=n_chan)
    state = eng.init_state(cfg, dev)
    shape = (FRAMES, n_chan, 8)

    def flags(p):
        return torch.from_numpy(rng.random(shape) < p).to(dev)

    fns = torch.arange(FRAMES, dtype=torch.int32, device=dev)
    energy = torch.from_numpy(
        (rng.random(shape) * 2e4).astype(np.float32)).to(dev)
    walk_in = (fns, flags(0.9), flags(0.8), energy, flags(0.5), flags(0.5),
               torch.ones(n_chan, dtype=torch.bool, device=dev), state)
    calls = {
        "K1 65/96": st["resample"],
        "K1 96/65": lambda: fir.polyphase_resample(dl, spec.q, spec.p,
                                                   lpf_dl),
        "K2": st["detect_rach"], "K3": st["analyze_traffic"],
        "K4": st["design_dfe"], "K5": st["equalize"],
        "K6": st["demodulate"],
        "K7": lambda: eng.exact_walk(*walk_in),
    }
    for kind, (per_chan, k) in VITERBI_KINDS.items():
        soft = torch.from_numpy(rng.random((per_chan * n_chan, 2 * k))
                                .astype(np.float32)).to(dev)
        calls[f"K8 {kind}"] = (lambda s=soft: fec.viterbi_decode(s))
    return calls


def _k1_a_call(fn) -> int:
    k0 = common.k1_launches()
    fn()
    return common.k1_launches() - k0


def _timed(fn, dev) -> dict:
    """common.measure's times of fn; its launches a call are the
    profiler's plus the K1 launches the profiler did not see."""
    m = common.measure(fn, dev, reps=REPS)
    k1 = _k1_a_call(fn)
    return {"wall_ms": m["wall_ms"], "ms": m.get("device_ms"),
            "busy_ms": m.get("busy_ms"), "idle_share": m.get("idle_share"),
            "k1_launches": k1,
            "launches": (m["launches"] + k1 - m["k1_profiled"]
                         if "launches" in m else None)}


def _share(bound: float, ms: float | None) -> float | None:
    return bound / ms if ms else None


def region_rows(n_chan: int, dev: torch.device, hbm: float,
                fp32: float) -> list[dict]:
    calls = region_calls(n_chan, dev)
    rows = []
    for r in regions(n_chan):
        b, by = bound_ms(r["work"], hbm, fp32)
        t = _timed(calls[r["name"]], dev)
        rows.append({
            "name": r["name"], "function": r["function"],
            "shape": r["shape"], "calls_per_block": r["calls_per_block"],
            "flops": r["work"].flops, "bytes": r["work"].bytes,
            "bound_ms": b, "bound_by": by, **t,
            "share": _share(b, t["ms"]),
            "share_busy": _share(b, t["busy_ms"])})
        common.log(TOOL, f"{r['name']:10s} bound {b:.4f} ms, "
                         f"wall {t['wall_ms']:.3f} ms")
    return rows


def block_row(n_chan: int, dev: torch.device, hbm: float,
              fp32: float) -> dict:
    """The JAX tool's row for the exact uplink block at n_chan carriers,
    timed on `dfe_cost_probe`'s DFE-on block."""
    from openbts_ttsou_tpu_torch.models import transceiver
    from openbts_ttsou_tpu_torch.tools import dfe_cost_probe

    cfg, spec, x, states = dfe_cost_probe.legs(n_chan, FRAMES, dev)
    w = block_work(n_chan)
    b, by = bound_ms(w, hbm, fp32)
    t = _timed(lambda: transceiver.uplink_block(cfg, spec, states["on"], x),
               dev)
    row = {"carriers": n_chan, "mode": "exact", "max_toa": cfg.max_toa,
           "schedule": transceiver.exact_schedule(n_chan),
           "gflop_per_block": w.flops / 1e9, "mb_per_block": w.bytes / 1e6,
           "arith_intensity_flop_per_byte": w.flops / w.bytes,
           "bound_ms": b, "bound_by": by,
           "wall_ms_per_block": t["wall_ms"]}
    on_card = dev.type == "cuda"
    s = t["wall_ms"] / 1e3 if on_card else None
    row.update({
        "measured_ms_per_block": t["wall_ms"] if on_card else None,
        "Msps": n_chan * spec.block_in / s / 1e6 if s else None,
        "achieved_tflops": w.flops / s / 1e12 if s else None,
        "achieved_GBps": w.bytes / s / 1e9 if s else None,
        "pct_hbm_peak": 100 * w.bytes / s / hbm if s else None,
        "pct_f32_peak": 100 * w.flops / s / fp32 if s else None,
        "device_ms_per_block": t["ms"], "busy_ms": t["busy_ms"],
        "idle_share": t["idle_share"], "launches": t["launches"],
        "k1_launches": t["k1_launches"],
        "share": _share(b, t["ms"]), "share_busy": _share(b, t["busy_ms"])})
    common.log(TOOL, f"block @{n_chan}: {w.flops / 1e9:.3f} GFLOP, "
                     f"{w.bytes / 1e6:.1f} MB, wall {t['wall_ms']:.1f} ms")
    return row


def main(argv=None) -> dict:
    ap = common.parser(__doc__)
    ap.add_argument("--carriers", type=int, default=512,
                    help="carriers of the region rows")
    ap.add_argument("--block-carriers", default="128,512,1024")
    ap.add_argument("--hbm-bytes-per-s", type=float, default=None,
                    help="the card's peaks, where `PEAKS` lacks the card "
                         "(or on the CPU)")
    ap.add_argument("--fp32-flops", type=float, default=None)
    ap.add_argument("--out", default=None,
                    help="the JSON's path (default build/tools/roofline.json)")
    args = ap.parse_args(argv)
    dev = common.device_of(args)
    card = common.card(dev)
    name = card["card"].split(",")[0].strip() if card["card"] else None
    hbm, fp32 = peaks(name, args.hbm_bytes_per_s, args.fp32_flops)
    record = {"tool": TOOL, "frames": FRAMES, "reps": REPS,
              "hbm_bytes_per_s": hbm, "fp32_flops": fp32,
              "region_carriers": args.carriers,
              "regions": region_rows(args.carriers, dev, hbm, fp32),
              "rows": [block_row(int(n), dev, hbm, fp32)
                       for n in args.block_carriers.split(",")],
              **card}
    path = common.out_path(args.out, "roofline.json")
    path.write_text(json.dumps(record, indent=1))
    record["path"] = str(path)
    return common.emit(record)


if __name__ == "__main__":
    main()
