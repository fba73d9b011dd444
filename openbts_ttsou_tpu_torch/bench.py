"""The port's benchmark: the transceiver's block chains over many carriers.

The counterpart of the repository's `bench.py` (which drives the JAX
package): one 13-frame block of device-rate IQ a carrier, chained over
`iters` blocks, timed by the k/2k difference, one JSON line out.

    python -m openbts_ttsou_tpu_torch.bench               # exact @512
    BENCH_MODE=duplex BENCH_CHANNELS=128 \
        python -m openbts_ttsou_tpu_torch.bench
    python -m openbts_ttsou_tpu_torch.bench --device cpu  # on the CPU

Environment (as `bench.py` reads it): `BENCH_CHANNELS` (512),
`BENCH_ITERS` (8), `BENCH_MODE` (exact | decoded | downlink | duplex |
duplex_decoded), `BENCH_MAX_TOA` (0: the full TSC segment; n: the
windowed correlation over 2n+1 lags), `BENCH_RACH_SLOTS` ("all", or
comma-separated TNs), `BENCH_REPS` (3), `BENCH_ATTEMPT_TIMEOUT` (420 s).
`OPENBTS_TORCH_TRACE=<dir>` profiles the timed section.

Modes, each one block a step with the per-block inputs of `bench.py`'s
scan bodies (the carrier roll by the frame counter and the gain
perturbation are kept, so both packages see the same data block for
block):

* `exact`, `decoded`: `uplink_block` (`uplink_block_decoded`) on the
  stimulus rolled along the carriers by fn % 3; counts detections;
* `downlink`: `downlink_block` with gains `(fn % 977)·1e-6` dB; counts
  the valid bursts sent;
* `duplex`: `duplex_block_wire` on the int16 uplink with its halos,
  rolled by fn % 3, the tx tail carried; counts detections;
* `duplex_decoded`: `duplex_block_decoded` (FEC both ways) with the
  slot split (0, 1, 6, 7) XCCH / (2, 3, 4, 5) TCH, its carries from
  zero; counts FEC successes (XCCH blocks and good TCH frames).

K1 runs once for the stimulus, then once a block (exact, decoded,
downlink) or twice (duplex, duplex_decoded); `k1_launches` counts the
launches and `k1_shapes` gives each one's shape.

Timing: `reps` runs of k and of 2k blocks, each from the same initial
state, after one warm run of k blocks (an eager program has nothing to
compile, so `bench.py`'s second warm run buys nothing here); the minimum
of each; dt = t(2k) − t(k) cancels the fixed cost of a run. The clock
stops after `torch.cuda.synchronize()`. A run whose dt fails the noise
guard (dt > 0.02 s and dt > 0.1·t(k)) is retried, up to 3 attempts; any
other failure ends the run. A failed run prints an error line and exits
non-zero.

Counts are named for what they count: `detections_run`, `bursts_run` or
`fec_ok_run` over the best 2k-block run (`bench.py` reports each as
`detections_last_block`), and `fec_ok_last_block` for duplex_decoded.

Writes nothing: the CPU baseline is read from the tracked
`bench/baseline_cpu.json` (and `bench/baseline_ref.json` where present).
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

from openbts_ttsou_tpu_torch.tools import common

ROOT = Path(__file__).resolve().parents[1]
BENCH_DIR = ROOT / "bench"

MODES = ("exact", "decoded", "downlink", "duplex", "duplex_decoded")
METRICS = {"downlink": "downlink_chain_throughput",
           "duplex": "duplex_chain_throughput",
           "duplex_decoded": "duplex_decoded_chain_throughput"}
UNIT = "Msamples/s/chip"
#: what each mode's per-block count counts
COUNTS = {"exact": "detections", "decoded": "detections",
          "downlink": "bursts", "duplex": "detections",
          "duplex_decoded": "fec_ok"}
#: K1 launches a block
K1_PER_BLOCK = {"exact": 1, "decoded": 1, "downlink": 1, "duplex": 2,
                "duplex_decoded": 2}
#: the duplex_decoded slot split (XCCH TNs, TCH TNs)
XCCH_TNS, TCH_TNS = (0, 1, 6, 7), (2, 3, 4, 5)
ATTEMPTS = 3


class NoisyTiming(RuntimeError):
    """dt = t(2k) − t(k) was too small against the fixed cost: retried."""


def metric(mode: str) -> str:
    return METRICS.get(mode, "uplink_chain_throughput")


# ---- the CPU baseline (bench.py:29-101) -------------------------------------

def measure_mirror_baseline(bench_dir: Path = BENCH_DIR) -> float:
    """The hand-written single-core mirror of the hot path
    (`bench/cpu_baseline.cpp`), samples/s, from its tracked cache
    `bench_dir/baseline_cpu.json`; FileNotFoundError without it."""
    return json.loads((bench_dir / "baseline_cpu.json").read_text()
                      )["samples_per_s"]


def measure_cpu_baseline(mode: str, bench_dir: Path = BENCH_DIR) -> tuple:
    """(baseline samples/s, harness name, mirror samples/s) for the
    mode's chain: the reference sigProcLib harness where its cache
    `bench_dir/baseline_ref.json` holds the mode's rate, else the
    mirror."""
    mirror = measure_mirror_baseline(bench_dir)
    ref_path = bench_dir / "baseline_ref.json"
    ref = json.loads(ref_path.read_text()) if ref_path.exists() else {}
    key = {"downlink": "samples_per_s_downlink",
           "duplex": "samples_per_s_duplex",
           "duplex_decoded": "samples_per_s_duplex"}.get(mode,
                                                          "samples_per_s")
    if ref.get(key, 0.0) > 0.0:
        return ref[key], "reference sigProcLib", mirror
    return mirror, "hand-written mirror", mirror


# ---- the stimulus (bench.py:162-195, 214-219, 288-299) ----------------------

def bench_symbols(n_chan: int, frames: int) -> np.ndarray:
    """The bench recipe at the symbol rate: noise σ 10 from
    `default_rng(0)` with a TSC-0 burst of amplitude 9000 at symbol
    f·1250+157 of every frame, [n_chan, frames·1250] complex64."""
    from openbts_ttsou_tpu_torch.ops import gmsk
    from openbts_ttsou_tpu_torch.utils import constants as C

    rng = np.random.default_rng(0)
    n = frames * 1250
    sym = (rng.standard_normal((n_chan, n))
           + 1j * rng.standard_normal((n_chan, n))
           ).astype(np.complex64) * 10.0
    bits = np.concatenate(
        [[0, 0, 0], rng.integers(0, 2, 57), [1], C.TRAINING_SEQUENCE[0], [1],
         rng.integers(0, 2, 57), [0, 0, 0]]).astype(np.uint8)
    wave = 9000.0 * gmsk.modulate_burst_np(bits[None], 1)[0]
    for f in range(frames):
        off = f * 1250 + 157
        sym[:, off: off + 148] += wave
    return sym


def to_i16(x: torch.Tensor) -> torch.Tensor:
    """complex64 [..., T] → int16 I/Q [..., T, 2], the radio's ADC
    format (rounded half to even, clipped like USRPifyVector)."""
    iq = torch.stack([x.real, x.imag], -1)
    return torch.clamp(torch.round(iq), -32767.0, 32767.0).to(torch.int16)


class Stimulus(NamedTuple):
    """One block of every mode's input, on one device."""

    samples: torch.Tensor  # [C, block_in] complex64, device rate
    dl_bits: torch.Tensor  # [F, C, 8, 148] uint8, default_rng(1)
    dl_valid: torch.Tensor  # [F, C, 8] bool, all set
    dl_atten: torch.Tensor  # [F, C, 8] float32, zeros
    content: tuple  # duplex_decoded's dl_content, default_rng(2)


def stimulus(n_chan: int, device, spec=None) -> Stimulus:
    """The bench's inputs on `device`: the symbol recipe brought to the
    device rate by K1 at 96/65 · 651 taps (one launch on a card) and
    cut to `block_in`; the downlink bits; and the decoded duplex's
    content (L2 frames on every slot, speech on the TCH slots 2-5)."""
    from openbts_ttsou_tpu_torch.models.transceiver import UplinkSpec
    from openbts_ttsou_tpu_torch.ops import fir
    from openbts_ttsou_tpu_torch.trx.engine import resolve_device

    dev = resolve_device(device)
    spec = spec or UplinkSpec()
    sym = torch.from_numpy(bench_symbols(n_chan, spec.frames)).to(dev)
    samples = fir.polyphase_resample(sym, 96, 65,
                                     fir.resampler_lpf(96, 65, 651))
    samples = samples[:, : spec.block_in].contiguous()

    rng = np.random.default_rng(1)
    dl_bits = rng.integers(0, 2, (spec.frames, n_chan, 8, 148)
                           ).astype(np.uint8)
    rng = np.random.default_rng(2)
    tch_mask = np.zeros((n_chan, 8), bool)
    tch_mask[:, list(TCH_TNS)] = True
    frames184 = rng.integers(0, 2, (4, n_chan, 8, 184)).astype(np.uint8)
    speech = rng.integers(0, 2, (3, n_chan, 8, 260)).astype(np.uint8)

    def on(x):
        return torch.from_numpy(x).to(dev)

    content = (on(frames184), on(np.ones((4, n_chan, 8), bool)),
               on(speech), on(np.ones((3, n_chan, 8), bool)),
               on(np.zeros((3, n_chan, 8, 184), np.uint8)),
               on(np.zeros((3, n_chan, 8), bool)), on(tch_mask))
    return Stimulus(samples, on(dl_bits),
                    on(np.ones((spec.frames, n_chan, 8), bool)),
                    on(np.zeros((spec.frames, n_chan, 8), np.float32)),
                    content)


def bench_state(cfg, device):
    """The bench's initial TrxState: slot 0 combination IV, 1-7
    combination I."""
    from openbts_ttsou_tpu_torch.trx.engine import ChanType, init_state

    ct = torch.full((cfg.n_chan, 8), ChanType.I, dtype=torch.int32)
    ct[:, 0] = ChanType.IV
    state = init_state(cfg, device)
    return state._replace(chan_type=ct.to(state.fn.device))


# ---- one block a step -------------------------------------------------------

def atten_step(fn: int) -> float:
    """The gain perturbation `(fn % 977)·1e-6` in float32, as the JAX
    scan body computes it."""
    return float(np.float32(fn % 977) * np.float32(1e-6))


#: step(carry) -> (carry', probe, count): one block
Step = Callable[[tuple], tuple]


def make_step(mode: str, cfg, spec, state, stim: Stimulus
              ) -> tuple[Step, tuple]:
    """One block's step for `mode` and its initial carry, built from the
    initial TrxState `state`. The frame counter rides in the carry as a
    host int (the JAX scan's `fn`; in the uplink modes it equals
    `state.fn`, read here once), so a step never waits for the
    device. The probe is `bench.py`'s: a sum over the block's
    outputs that keeps every output live."""
    from openbts_ttsou_tpu_torch.gsm import l1fec
    from openbts_ttsou_tpu_torch.models import transceiver as T
    from openbts_ttsou_tpu_torch.utils.gsm_time import HYPERFRAME

    if mode not in MODES:
        raise ValueError(f"unknown bench mode {mode!r}; one of {MODES}")
    dev = state.fn.device
    frames, c = spec.frames, cfg.n_chan
    x = stim.samples

    if mode in ("exact", "decoded"):
        def step(carry):
            st, fn = carry
            out = (T.uplink_block_decoded if mode == "decoded"
                   else T.uplink_block)(cfg, spec, st,
                                        torch.roll(x, fn % 3, 0))
            st2, res = out[0], out[1]
            probe = res.soft_bits[..., 0].sum()
            if mode == "decoded":
                probe = probe + out[2].bits[..., 0].sum()
            return ((st2, (fn + frames) % HYPERFRAME), probe,
                    res.detected.sum())
        return step, (state, int(state.fn))

    if mode == "downlink":
        def step(carry):
            (fn,) = carry
            tx = T.downlink_block(cfg, spec, state, stim.dl_bits,
                                  stim.dl_valid,
                                  stim.dl_atten + atten_step(fn), fn)
            return ((fn + frames,), tx[..., 0].real.sum(),
                    stim.dl_valid.sum())
        return step, (0,)

    tail0 = torch.zeros((c, T.TX_TAIL_SYM), dtype=torch.complex64,
                        device=dev)
    halo = torch.zeros((c, T.RX_HALO_DEV), dtype=torch.complex64, device=dev)
    ul_halo = torch.cat([halo, x, halo], -1)

    if mode == "duplex":
        ul_i16 = to_i16(ul_halo)

        def step(carry):
            st, tail, fn = carry
            st2, tx, tail2, wire = T.duplex_block_wire(
                cfg, spec, st, torch.roll(ul_i16, fn % 3, 0), tail,
                stim.dl_bits, stim.dl_valid, stim.dl_atten + atten_step(fn),
                fn, True)
            probe = (wire.soft_u8[..., 0].to(torch.int32).sum()
                     + tx[:, 0, :].to(torch.int32).sum())
            return (st2, tail2, fn + frames), probe, wire.detected.sum()
        return step, (state, tail0, 0)

    def fill(v):  # a 0-d device int32 without a host-to-device copy
        return torch.full((), v, dtype=torch.int32, device=dev)

    def step(carry):  # duplex_decoded
        st, tail, tc, prev, pv, fn = carry
        st2, tx, tail2, blocks, tc2, prev2, pv2 = T.duplex_block_decoded(
            cfg, spec, st._replace(fn=fill(fn % HYPERFRAME)),
            torch.roll(ul_halo, fn % 3, 0), tail, stim.content,
            stim.dl_atten + atten_step(fn), tc, fill(fn), prev, pv, 0, 0,
            XCCH_TNS, TCH_TNS)
        probe = (blocks.bits[..., 0].to(torch.int32).sum()
                 + tx[:, 0].real.sum()
                 + blocks.tch_speech[..., 0].to(torch.int32).sum())
        count = blocks.ok.sum() + blocks.tch_good.sum()
        return (st2, tail2, tc2, prev2, pv2, fn + frames), probe, count
    carry0 = (state, tail0,
              (l1fec.TchTxCarry.zeros(c * 8, device=dev),
               T.XcchTxCarry.zeros(c, device=dev)),
              torch.zeros((T.DECODE_PRELUDE, c, 8, 148), dtype=torch.float32,
                          device=dev),
              torch.zeros((), dtype=torch.bool, device=dev), 0)
    return step, carry0


def run_blocks(step: Step, carry: tuple, n: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """n chained blocks from `carry`: (probes [n], counts [n]), left on
    the device (nothing here waits for it)."""
    probes, counts = [], []
    for _ in range(n):
        carry, probe, count = step(carry)
        probes.append(probe)
        counts.append(count)
    return torch.stack(probes), torch.stack(counts)


def clone_carry(carry):
    """A copy of a carry whose tensors share no storage with it."""
    if isinstance(carry, torch.Tensor):
        return carry.clone()
    if isinstance(carry, tuple):
        items = [clone_carry(v) for v in carry]
        return type(carry)(*items) if hasattr(carry, "_fields") \
            else tuple(items)
    return carry


# ---- timing (bench.py:366-415) ----------------------------------------------

def k_difference(t1: float, t2: float) -> float:
    """dt = t(2k) − t(k), the time of k blocks with the fixed cost of a
    run cancelled; NoisyTiming where the noise guard fails."""
    dt = t2 - t1
    if not (dt > 0.02 and dt > 0.1 * t1):
        raise NoisyTiming(f"timing too noisy: t1={t1:.4f}s t2={t2:.4f}s")
    return dt


def measure(step: Step, carry: tuple, iters: int, device, reps: int = 3,
            clock: Callable[[], float] = time.perf_counter) -> dict:
    """Time `iters` and 2·`iters` chained blocks, `reps` runs each, every
    run from a fresh copy of `carry` (the copy made before the clock
    starts), after one warm run. Returns t1, t2, dt and the best 2k
    run's per-block counts (a host array) and probe."""
    from openbts_ttsou_tpu_torch.utils.profiling import maybe_trace

    dev = torch.device(device)

    def timed(n):
        c = clone_carry(carry)
        common.sync(dev)
        t0 = clock()
        probes, counts = run_blocks(step, c, n)
        common.sync(dev)
        return clock() - t0, probes, counts

    timed(iters)  # warm: first-call builds, tables, allocator
    with maybe_trace():  # OPENBTS_TORCH_TRACE=<dir>
        t1 = min(timed(iters)[0] for _ in range(reps))
        t2, best = float("inf"), None
        for _ in range(reps):
            t, probes, counts = timed(2 * iters)
            if t < t2:
                t2, best = t, (probes, counts)
    dt = k_difference(t1, t2)
    probes, counts = best
    return {"t1": t1, "t2": t2, "dt": dt,
            "counts": counts.cpu().numpy(),
            "probe": float(probes.double().sum())}


# ---- the run ----------------------------------------------------------------

def settings() -> dict:
    """The bench's settings from the environment (bench.py's names and
    defaults)."""
    env = os.environ
    mode = env.get("BENCH_MODE", "exact")
    if mode not in MODES:
        raise ValueError(f"BENCH_MODE={mode!r}; one of {MODES}")
    rs = env.get("BENCH_RACH_SLOTS", "all")
    return {"mode": mode,
            "n_chan": int(env.get("BENCH_CHANNELS", "512")),
            "iters": int(env.get("BENCH_ITERS", "8")),
            "max_toa": int(env.get("BENCH_MAX_TOA", "0")) or None,
            "rach_slots": rs,
            "reps": int(env.get("BENCH_REPS", "3")),
            "attempt_timeout": float(env.get("BENCH_ATTEMPT_TIMEOUT",
                                             "420"))}


def run(s: dict, device) -> dict:
    """One attempt at the settings `s` on `device`: the record (without
    the baseline fields)."""
    from openbts_ttsou_tpu_torch.models import transceiver as T
    from openbts_ttsou_tpu_torch.trx.engine import TrxConfig

    mode, n_chan, iters = s["mode"], s["n_chan"], s["iters"]
    rach_slots = None if s["rach_slots"] == "all" else tuple(
        int(t) for t in s["rach_slots"].split(","))
    cfg = TrxConfig(n_chan=n_chan, max_toa=s["max_toa"],
                    rach_slots=rach_slots)
    spec = T.UplinkSpec(frames=13)
    common.log("bench", f"device={device} mode={mode} chan={n_chan} "
                        f"iters={iters} max_toa={s['max_toa']} "
                        f"rach_slots={rach_slots}")
    k1_0 = common.k1_launches()
    with common.k1_shapes() as shapes:
        stim = stimulus(n_chan, device, spec)
        step, carry = make_step(mode, cfg, spec, bench_state(cfg, device),
                                stim)
        m = measure(step, carry, iters, device, s["reps"])
    k1 = common.k1_launches() - k1_0
    dt, counts = m["dt"], m["counts"]
    sps = iters * n_chan * spec.block_in / dt
    name = COUNTS[mode]
    return {
        "metric": metric(mode),
        "value": sps / 1e6,
        "unit": UNIT,
        "detail": {
            "n_chan": n_chan,
            "iters": iters,
            "frame_latency_ms": dt / (iters * spec.frames) * 1e3,
            "mode": mode,
            **({"duplex_exact": True} if mode.startswith("duplex") else {}),
            "seconds": dt,
            "t1_s": m["t1"],
            "t2_s": m["t2"],
            "fetch_rtt_s": max(2 * m["t1"] - m["t2"], 0.0),
            f"{name}_run": int(counts.sum()),
            **({"fec_ok_last_block": int(counts[-1])}
               if mode == "duplex_decoded" else {}),
            "blocks_run": len(counts),
            "probe": m["probe"],
            "max_toa": s["max_toa"],
            "rach_slots": s["rach_slots"],
            "exact_schedule": (None if mode == "downlink"
                               else T.exact_schedule(n_chan)),
            "k1_launches": k1,
            # {"[rows, T, p, q, taps]": launches}, summing to k1_launches
            "k1_shapes": {json.dumps(list(k)): n for k, n in shapes.items()},
            # every block run: one warm run of k, reps runs of k and 2k
            "blocks_total": iters * (1 + 3 * s["reps"]),
            "reps": s["reps"],
            **common.card(torch.device(device)),
        },
    }


def main(argv=None) -> dict:
    """Run the bench from the environment's settings and print its JSON
    line; after a failure, print the error line and raise. Only the noise
    guard's NoisyTiming is retried."""
    args = common.parser(__doc__).parse_args(argv)
    mode = os.environ.get("BENCH_MODE", "exact")
    try:
        s = settings()
        mode = s["mode"]
        dev = common.device_of(args)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        baseline, harness, mirror = measure_cpu_baseline(mode)
        for attempt in range(ATTEMPTS):
            try:
                with common.deadline(s["attempt_timeout"], "bench attempt"):
                    rec = run(s, dev)
                break
            except NoisyTiming as e:
                common.log("bench", f"attempt {attempt} failed: {e}")
                if attempt == ATTEMPTS - 1:
                    raise
    except Exception as e:
        print(json.dumps({"metric": metric(mode), "value": 0.0, "unit": UNIT,
                          "vs_baseline": 0.0,
                          "error": f"{type(e).__name__}: {str(e)[:200]}"}),
              flush=True)
        raise
    sps = rec["value"] * 1e6
    rec["vs_baseline"] = sps / baseline
    rec["detail"].update(cpu_baseline_Msps=baseline / 1e6,
                         cpu_baseline_harness=harness,
                         mirror_baseline_Msps=mirror / 1e6)
    return common.emit(rec)


if __name__ == "__main__":
    main()
