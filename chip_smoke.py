#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-only   # phases 1-2 only, no result line

Phases (each one raises on failure; the script then exits non-zero and
prints no result):

1. card: name, power limit, torch/CUDA/nvcc versions; build every CUDA
   kernel of the uplink path from `openbts_ttsou_tpu_torch/csrc/`;
2. kernels: each kernel against its plain PyTorch version on the card,
   at the shapes the main path gives it (K1 at 65/96 · 961 taps on
   [512, 24000] and 96/65 · 651 taps on [512, 16250]), with device times
   (CUDA events, calls queued behind a device sleep) for the kernel, the
   plain version and one PyTorch library call, the kernel's share of its
   bound and its achieved bytes a second;
3. main path: `Transceiver.process_uplink` on 512 carriers over 3
   consecutive 13-frame blocks of the bench recipe (bench.py:162-195),
   checked block by block, timed, with the kernels' launch counts;
4. profile: one more block under torch.profiler (device busy and idle
   share, device events, the kernels that take the time), and both exact
   schedules timed on one block from one entry state, results compared;
5. card against CPU: the batched exact schedule on adversarial streams
   (RACH frames, energy without detection, DFE carriers) on the card and
   on the CPU, results and final state compared.

Earlier lines are JSON records; the line before the last is the card's
name and power limit; the last line is the result object.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_CHAN = 512
BLOCKS = 3
TIMED_REPS = 25
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM data sheet, float32 outside the tensor cores
SLEEP_CYCLES = 100_000_000  # torch.cuda._sleep ahead of timed calls, ~50 ms


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def record(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps: int = TIMED_REPS) -> tuple[float, float]:
    """Device time of fn(): the median of `reps` CUDA-event intervals,
    each around one call, after 3 warm calls. The calls are queued behind
    a ~50 ms device sleep, so the device runs them back to back and the
    host's dispatch time stays out of the intervals; the second number is
    the share of the sleep the host used to queue them (< 1: it kept
    ahead)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    s0, s1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    s0.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    s1.record()
    t0 = time.perf_counter()
    for a, b in ev:
        a.record()
        fn()
        b.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return (statistics.median(a.elapsed_time(b) for a, b in ev),
            host_ms / s0.elapsed_time(s1))


# ---- phase 1 ---------------------------------------------------------------

def phase_card() -> str:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    from openbts_ttsou_tpu_torch import build

    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    t0 = time.perf_counter()
    out = build.build_all()
    build_s = time.perf_counter() - t0
    for name, text in out.items():
        log(f"nvcc {name}:\n{text}")
    record({"phase": "card", "card": card,
            "device": torch.cuda.get_device_name(0),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "nvcc": nvcc[-1], "python": sys.version.split()[0],
            "kernels_built": sorted(out), "build_s": build_s})
    return card


# ---- phase 2 ---------------------------------------------------------------

def resample_bound_ms(rows: int, t_in: int, p: int, q: int,
                      lpf: np.ndarray) -> tuple[float, str]:
    """Least time for K1's work on this card: each input read once and
    each output written once at the data-sheet HBM rate, against the
    float32 FMAs of the nonzero taps each output uses (2 FMAs a tap,
    real and imaginary) at the data-sheet float32 rate."""
    from openbts_ttsou_tpu_torch.ops import cuda_fir, fir

    n_out = fir.polyphase_output_len(t_in, p, q)
    taps, _ = cuda_fir.branch_table(p, q, lpf.tobytes())
    nnz = (taps != 0).sum(1)  # per branch
    per_out = nnz[np.arange(n_out) % p].sum()
    flops = rows * per_out * 4.0
    nbytes = rows * (t_in + n_out) * 8.0
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_kernels() -> dict:
    import torch.nn.functional as F

    from openbts_ttsou_tpu_torch.ops import cuda_fir, fir

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for p, q, taps, t_in in ((65, 96, 961, 24000), (96, 65, 651, 16250)):
        x = torch.randn((N_CHAN, t_in), dtype=torch.complex64, device="cuda",
                        generator=gen)
        lpf = fir.resampler_lpf(p, q, taps)
        got = cuda_fir.polyphase_resample_cuda(x, p, q, lpf)
        want = cuda_fir.polyphase_resample_plain(x, p, q, lpf)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"K1 {p}/{q}: shape or non-finite output")
        check(err <= 2e-4 * scale,
              f"K1 {p}/{q}: max|kernel - plain| {err} > 2e-4 * {scale}")

        # one strided float32 convolution of the same bank (cuDNN, TF32
        # off): a yardstick only, the port never calls it
        _, _, _, _, k_prime, pad_left = fir._polyphase_plan(p, q, taps)
        n_out = fir.polyphase_output_len(t_in, p, q)
        m_cycles = -(-n_out // p)
        pad_right = max(0, (m_cycles - 1) * q + k_prime - pad_left - t_in)
        bank = torch.from_numpy(
            fir._polyphase_filter_bank(p, q, lpf)).cuda()  # [p, 1, K']
        planes = torch.cat([x.real, x.imag])[:, None, :]

        def library():
            return F.conv1d(F.pad(planes, (pad_left, pad_right)), bank,
                            stride=q)

        bound, bound_by = resample_bound_ms(N_CHAN, t_in, p, q, lpf)
        nbytes = N_CHAN * (t_in + fir.polyphase_output_len(t_in, p, q)) * 8

        def kernel():
            return cuda_fir.polyphase_resample_cuda(x, p, q, lpf)

        def plain():
            return cuda_fir.polyphase_resample_plain(x, p, q, lpf)

        ms, ahead = cuda_ms(kernel)
        plain_ms, _ = cuda_ms(plain)
        library_ms, library_ahead = cuda_ms(library)
        # the plain version copies its bank to the card on every call,
        # which waits for the queue, so only the kernel and the library
        # call are held to a queue that stays ahead
        check(max(ahead, library_ahead) < 1,
              f"K1 {p}/{q}: the host fell behind the device while timing "
              f"(queue shares {ahead:.3f}, {library_ahead:.3f})")
        rows[(p, q)] = {
            "geometry": f"{p}/{q} {taps} taps [{N_CHAN}, {t_in}]",
            "max_abs_err": err, "max_abs_plain": scale,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound, "bound_by": bound_by,
            "bound_share": bound / ms, "gbytes_per_s": nbytes / ms / 1e6,
            "host_queue_share": {"kernel": ahead, "library": library_ahead},
        }
        record({"phase": "kernels", "kernel": "polyphase_resample",
                **rows[(p, q)]})
    return rows


# ---- phase 3 ---------------------------------------------------------------

def bench_samples(spec) -> torch.Tensor:
    """The bench recipe (bench.py:162-195): noise σ 10 with a TSC-0 burst
    of amplitude 9000 at symbol f·1250+157 of every frame, brought to
    the device rate by K1 at 96/65 · 651 taps."""
    from openbts_ttsou_tpu_torch.ops import fir, gmsk
    from openbts_ttsou_tpu_torch.utils import constants as C

    rng = np.random.default_rng(0)
    sym = (rng.standard_normal((N_CHAN, spec.block_symbols))
           + 1j * rng.standard_normal((N_CHAN, spec.block_symbols))
           ).astype(np.complex64) * 10.0
    bits = np.concatenate(
        [[0, 0, 0], rng.integers(0, 2, 57), [1], C.TRAINING_SEQUENCE[0], [1],
         rng.integers(0, 2, 57), [0, 0, 0]]).astype(np.uint8)
    wave = 9000.0 * gmsk.modulate_burst_np(bits[None], 1)[0]
    for f in range(spec.frames):
        off = f * 1250 + 157
        sym[:, off: off + 148] += wave
    dev = fir.polyphase_resample(torch.from_numpy(sym).cuda(), 96, 65,
                                 fir.resampler_lpf(96, 65, 651))
    return dev[:, : spec.block_in].contiguous()


def new_transceiver(cfg, spec):
    from openbts_ttsou_tpu_torch.models.transceiver import Transceiver
    from openbts_ttsou_tpu_torch.trx.engine import ChanType

    trx = Transceiver(cfg, spec, device="cuda")
    ct = torch.full((N_CHAN, 8), ChanType.I, dtype=torch.int32,
                    device="cuda")
    ct[:, 0] = ChanType.IV
    trx.state = trx.state._replace(chan_type=ct)
    return trx


def phase_main_path():
    from openbts_ttsou_tpu_torch.models.transceiver import UplinkSpec
    from openbts_ttsou_tpu_torch.ops import cuda_fir
    from openbts_ttsou_tpu_torch.trx.engine import TrxConfig

    cfg = TrxConfig(n_chan=N_CHAN)
    spec = UplinkSpec(frames=13)
    x = bench_samples(spec)
    new_transceiver(cfg, spec).process_uplink(x)  # warm block
    torch.cuda.synchronize()

    trx = new_transceiver(cfg, spec)
    cuda_fir.polyphase_resample_cuda.launches = 0
    results, thresholds = [], []
    t0 = time.perf_counter()
    for _ in range(BLOCKS):
        results.append(trx.process_uplink(x))
        thresholds.append(trx.state.energy_threshold.clone())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"polyphase_resample": cuda_fir.polyphase_resample_cuda.launches}

    check(launches["polyphase_resample"] == BLOCKS,
          f"K1 launched {launches['polyphase_resample']} times in "
          f"{BLOCKS} blocks, expected 1 a block")
    for k, (res, thr) in enumerate(zip(results, thresholds)):
        det = res.detected
        check(int(det.sum()) == N_CHAN * spec.frames,
              f"block {k}: {int(det.sum())} detections")
        check(bool(det[:, :, 1].all()), f"block {k}: slot-1 burst missed")
        check(not bool(res.is_rach.any()), f"block {k}: RACH detected")
        check(bool((res.timing[det] == 6).all()), f"block {k}: timing != 6")
        soft = res.soft_bits
        check(bool(torch.isfinite(soft).all()) and float(soft.min()) >= 0
              and float(soft.max()) <= 1, f"block {k}: soft bits")
        check(bool((thr == 250.0 - 13 * (k + 1)).all()),
              f"block {k}: threshold {thr.unique().tolist()}")
    ms_block = dt / BLOCKS * 1e3
    out = {"phase": "main_path", "carriers": N_CHAN, "blocks": BLOCKS,
           "ms_per_block": ms_block,
           "msamples_per_s": N_CHAN * spec.block_in / (dt / BLOCKS) / 1e6,
           "detections_per_block": N_CHAN * spec.frames,
           "launches": launches,
           "launches_per_block": {k: v / BLOCKS for k, v in launches.items()},
           "device": torch.cuda.get_device_name(0)}
    record(out)
    return out, trx, x


# ---- phase 4 ---------------------------------------------------------------

def phase_profile(cfg, spec, trx, x, ms_block: float) -> dict:
    """Where a 512-carrier block's time goes.

    One more block under torch.profiler: device busy time (the sum of
    device-side events, kernels and copies, on one stream) against the
    block's unprofiled wall time from phase 3, the number of device-side
    events, and the ones that take the most time. Then both exact
    schedules on one block from one entry state, timed and compared: the
    frame-by-frame `rx_step` loop (the main path above 128 carriers) and
    the batched `process_block_exact`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from openbts_ttsou_tpu_torch.models import transceiver as T
    from openbts_ttsou_tpu_torch.ops import fir

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trx.process_uplink(x)
        torch.cuda.synchronize()
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    top = sorted(dev_events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:10]
    check(busy_ms > 0, "the profiler saw no device time")

    sym = fir.polyphase_resample(
        x, spec.p, spec.q, fir.resampler_lpf(spec.p, spec.q, spec.taps)
    )[..., : spec.block_symbols]
    st0 = trx.state
    sched_ms, outs = {}, {}
    for name, fn in (("frames", T.process_block_frames),
                     ("batched", T.process_block_exact)):
        fn(cfg, spec.frames, st0, sym)  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        outs[name] = fn(cfg, spec.frames, st0, sym)
        torch.cuda.synchronize()
        sched_ms[name] = (time.perf_counter() - t0) * 1e3
        sched_ms[name + "_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    (sa, ra), (sb, rb) = outs["frames"], outs["batched"]
    for name in ("detected", "is_rach", "rssi", "timing"):
        check(torch.equal(getattr(ra, name), getattr(rb, name)),
              f"schedules differ in {name}")
    check(float((ra.soft_bits - rb.soft_bits).abs().max()) <= 2e-4,
          "schedules differ in soft bits")
    check(torch.equal(sa.energy_threshold, sb.energy_threshold),
          "schedules differ in the threshold walk")
    out = {"phase": "profile", "device_busy_ms": busy_ms,
           "ms_per_block_unprofiled": ms_block,
           "device_idle_share": 1 - busy_ms / ms_block,
           "device_events": sum(e.count for e in dev_events),
           "top": [{"name": e.key[:70], "count": e.count,
                    "ms": e.self_device_time_total / 1e3} for e in top],
           "schedule_ms": sched_ms}
    record(out)
    return out


# ---- phase 5 ---------------------------------------------------------------

def adversarial_streams(rng, c, frames, blocks):
    """Symbol streams with TSC bursts at random delays, RACH bursts on
    slot 0 of some frames and high-energy noise without a burst."""
    from openbts_ttsou_tpu_torch.ops import gmsk
    from openbts_ttsou_tpu_torch.utils import constants as C

    offs = np.concatenate([[0], np.cumsum([157, 156, 156, 156] * 2)])[:8]
    streams = []
    for b in range(blocks):
        sym = (rng.standard_normal((c, frames * 1250, 2)) * 20.0
               ).astype(np.float32).view(np.complex64)[..., 0]
        for f in range(frames):
            for ch in range(c):
                for tn in range(8):
                    start = f * 1250 + offs[tn]
                    if tn == 0 and f in (1, 5, 9):
                        bits = np.zeros(148, np.uint8)
                        bits[:8] = [0, 1, 0, 1, 0, 1, 0, 1]
                        bits[8:49] = C.RACH_SYNCH_SEQUENCE
                        bits[49:85] = rng.integers(0, 2, 36)
                    elif f in (2 + b, 7) and tn in (3, 4):
                        sym[ch, start: start + 157] += (
                            rng.standard_normal((157, 2)) * 4500.0
                        ).astype(np.float32).view(np.complex64)[..., 0]
                        continue
                    elif rng.random() < 0.7:
                        bits = rng.integers(0, 2, 148).astype(np.uint8)
                        bits[61:87] = C.TRAINING_SEQUENCE[2]
                    else:
                        continue
                    w = 9000.0 * gmsk.modulate_burst_np(bits[None], 1,
                                                        guard_len=9)[0]
                    start += int(rng.integers(0, 3))
                    end = min(start + len(w), sym.shape[1])
                    sym[ch, start:end] += w[: end - start]
        streams.append(sym)
    return streams


def phase_card_vs_cpu() -> dict:
    from openbts_ttsou_tpu_torch.convert import state_to_numpy
    from openbts_ttsou_tpu_torch.models.transceiver import process_block_exact
    from openbts_ttsou_tpu_torch.trx.engine import ChanType, TrxConfig, init_state

    c, frames = 4, 13
    cfg = TrxConfig(n_chan=c, max_toa=8)
    streams = adversarial_streams(np.random.default_rng(5), c, frames, 3)
    states = {}
    for dev in ("cuda", "cpu"):
        ct = torch.full((c, 8), ChanType.I, dtype=torch.int32)
        ct[:2, 0] = ChanType.V
        ct[2:, 0] = ChanType.IV
        states[dev] = init_state(cfg, dev)._replace(
            chan_type=ct.to(dev),
            tsc=torch.full((c,), 2, dtype=torch.int32, device=dev),
            max_expected_delay=torch.tensor([2, 2, 0, 4], dtype=torch.int32,
                                            device=dev))
    n_det = n_rach = n_dfe = 0
    for k, sym in enumerate(streams):
        res = {}
        for dev in ("cuda", "cpu"):
            states[dev], res[dev] = process_block_exact(
                cfg, frames, states[dev], torch.from_numpy(sym).to(dev))
        g, h = res["cuda"], res["cpu"]
        for name in ("detected", "is_rach", "rssi", "timing"):
            check(torch.equal(getattr(g, name).cpu(), getattr(h, name)),
                  f"block {k}: {name} differs between card and CPU")
        err = float((g.soft_bits.cpu() - h.soft_bits).abs().max())
        check(err <= 2e-4, f"block {k}: soft bits differ by {err}")
        sg, sh = state_to_numpy(states["cuda"]), state_to_numpy(states["cpu"])
        for name, a in sg.items():
            b = sh[name]
            if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
                check(np.array_equal(a, b), f"block {k}: state {name}")
            else:
                check(np.allclose(a, b, atol=2e-4, rtol=5e-6),
                      f"block {k}: state {name} differs by "
                      f"{np.abs(a - b).max()}")
        n_det += int(h.detected.sum())
        n_rach += int(h.is_rach.sum())
        n_dfe += int(states["cpu"].chan_valid.sum())
    check(n_det > 0 and n_rach > 0 and n_dfe > 0,
          "adversarial streams left detection, RACH or the DFE unexercised")
    out = {"phase": "card_vs_cpu", "carriers": c, "blocks": len(streams),
           "detections": n_det, "rach_detections": n_rach,
           "valid_dfe_slots_summed": n_dfe,
           "soft_bits_tolerance": 2e-4}
    record(out)
    return out


def kernels_line(kern: dict, launches: dict) -> dict:
    """The `kernels` record: K1 at the uplink shape, and every shape's
    times beside its bound."""
    up = kern[(65, 96)]
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_share",
            "gbytes_per_s")
    return {"kernels": [{
        "name": "polyphase_resample", "route": "cuda",
        "source": "openbts_ttsou_tpu_torch/csrc/polyphase_resample.cu",
        "replaces": "openbts_ttsou_tpu/ops/pallas_fir.py:121",
        "launches": launches["polyphase_resample"],
        "max_abs_err": max(r["max_abs_err"] for r in kern.values()),
        "ms": up["ms"], "plain_ms": up["plain_ms"],
        "bound_ms": up["bound_ms"], "bound_by": up["bound_by"],
        "library_ms": up["library_ms"], "bound_share": up["bound_share"],
        "gbytes_per_s": up["gbytes_per_s"],
        "shapes": [{"geometry": r["geometry"], **{k: r[k] for k in keys}}
                   for r in kern.values()]}]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 2
    torch.manual_seed(0)
    card = phase_card()
    kern = phase_kernels()
    if "--kernels-only" in sys.argv[1:]:  # phases 1-2: build and time
        print(card, flush=True)
        return 0
    main_path, trx, x = phase_main_path()
    phase_profile(trx.cfg, trx.spec, trx, x, main_path["ms_per_block"])
    del trx, x
    phase_card_vs_cpu()

    print(json.dumps(kernels_line(kern, main_path["launches"])), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
