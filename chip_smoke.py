#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-only   # phases 1-2 only, no result line

Phases (each one raises on failure; the script then exits non-zero and
prints no result):

1. card: name, power limit, torch/CUDA/nvcc versions; build every CUDA
   kernel from `openbts_ttsou_tpu_torch/csrc/` and the port's native
   runtime (`csrc/runtime/` with g++, the daemon's sockets and queues);
2. kernels: each kernel against its plain PyTorch version on the card,
   at the shapes the main paths give it (K1 at 65/96 · 961 taps on
   [512, 24000] (uplink) and [512, 24192] (duplex uplink with its two
   96-sample halos), and at 96/65 · 651 taps on [512, 16250] and
   [512, 16380] (duplex downlink with its 130-symbol carried tail)),
   with the kernel instantiation each shape runs and device times (CUDA
   events, calls queued behind a device sleep) for the kernel, the plain
   version and one PyTorch library call, the kernel's share of its bound
   and its achieved bytes a second;
3. uplink: `Transceiver.process_uplink` on 512 carriers over 3
   consecutive 13-frame blocks of the bench recipe (bench.py:162-195),
   checked block by block, timed, with the kernels' launch counts;
4. profile: one more uplink block under torch.profiler (device busy and
   idle share, device events, the kernels that take the time), and both
   exact schedules timed on one block from one entry state, results
   compared;
5. card against CPU: the batched exact schedule on adversarial streams
   (RACH frames, energy without detection, DFE carriers) on the card and
   on the CPU, results and final state compared;
6. duplex: `duplex_block_compact` on 512 carriers over 3 consecutive
   blocks of one continuous stream (the bench recipe's uplink with its
   halos, a downlink of known bits on slot 1 of every frame and filler
   elsewhere), checked against `uplink_block` on the same blocks and by
   demodulating the transmitted samples, timed, launches counted, one
   block profiled;
7. wire daemon: `BlockTrxDaemon` on the card over loopback UDP at 4
   carriers (control-verb bring-up, downlink datagrams in, uplink
   datagrams and the tx capture checked), its compact retire against its
   dense retire; then `python -m openbts_ttsou_tpu_torch.trx.daemon` as
   its own process, brought up and looped back over UDP, and stopped;
8. card against CPU, duplex: `duplex_block_compact` on 2 blocks of the
   adversarial streams at 4 carriers, on the card and on the CPU;
9. resident: `ResidentL1` (the resident layer 1, FEC both ways) at 512
   carriers with the bench split, two passes of 5 windows: random
   speech, FACCH and L2 frames transmitted with a silent uplink, then
   that stream looped back; every frame sent decoded exactly once,
   bit-exact; K1 twice a window; one window profiled, the decode leg
   profiled and its Viterbi calls timed, both FEC legs run under
   sync-debug "error", a window timed in turns with the FEC-less duplex
   block;
10. uplink decoded: `uplink_block_decoded_stream` at 512 carriers on the
    same stream, decoding what phase 9 decoded, window by window;
11. resident card against CPU at 4 carriers (content and noise): every
    DecodedBlocks field exact, DAC samples ±1, and a carry taken on the
    card restored on the CPU through `convert.py`;
12. USRP bus: `BlockTrxDaemon` on the card over USRPBankRadio →
    SocketBus → a `python -m openbts_ttsou_tpu_torch.trx.bus_server`
    process at 2 carriers with planted bursts;
13. the BTS over the air at full C0 width: `BTSApp(device="cuda")` and
    the port's per-frame `TrxDaemon(device="cuda")` in one process over a
    `DuplexLoopbackRadio`, every C0 timeslot equipped (TN0 C-V, TN1
    C-VII, TN2-7 TCH/F); a simulated MS (the port's ops on the CPU)
    makes a location update, an MO call with 50 GSM 06.10 frames each way
    over a TCH/F, takes an MT SMS, and sends itself an SMS through the
    port's smqueue; step times, FEC call times, one
    profiled stretch of the call; then the location update again with
    daemon and app on the CPU: the same downlink bursts and L3 messages
    frame by frame;
14. the BTS entry point as processes: `BTSApp(spawn_transceiver=True,
    device="cuda")` starts `python -m openbts_ttsou_tpu_torch.trx.daemon
    --device cuda`, brings it up over the control sockets, follows its
    clock through two 51-multiframes of beacon, and reaps it;
15. sharded: `make_mesh(4, "cuda")`, a (chan 2, time 2) mesh of four
    shards on cuda:0, at 512 carriers and 13 frames a shard on the
    uplink main path's stream: 3 steps of `sharded_uplink_pipeline` with
    the state carry, 3 of `sharded_duplex_pipeline` and 2 of its decoded
    mode with the bench's slot split, held against the serial
    `uplink_block`/`downlink_block` over the same 26-frame windows
    (detections, RACH flags, RSSI and timing exactly and soft bits to
    5e-3 on interior frames, the threshold at every step boundary, the
    tx bit-identical); ms a step, K1's launches (4 a step, 8 a duplex
    step, counted over the sharded steps alone), the mesh's bytes a step
    and one profiled step;
16. sharded card against CPU: the same mesh at 8 carriers on the card
    and on the CPU over 2 steps of the adversarial streams: detections
    and the integer state equal;
17. the distributed runtime as processes: `python -m
    openbts_ttsou_tpu_torch.parallel.worker` at world size 1 over NCCL
    and `python -m openbts_ttsou_tpu_torch.parallel.dryrun --shards 4`
    on the card, side by side; both exit 0 with their JSON `ok`. At
    world size 1 no mesh collective crosses ranks, so NCCL carries only
    the process group's start and one all-reduce; the mesh's NCCL
    send/recv and all-gather wait for a machine with two cards;
18. the tools (`openbts_ttsou_tpu_torch/tools/`) on the card, each
    through its `main([...])`: the wire soak (`daemon_soak`) at 1
    carrier as `python -m`, at 8 and 128 in-process (replay bus, 26-frame
    blocks, depth 2, full load, 10 timed blocks after 6 warm-up blocks,
    no stale burst or underrun and no uplink datagram lost in the timed
    window), at 512 in-process with 4 timed blocks (its sockets past
    descriptor 1024, which the port's `poll()` transport takes) and at 8
    over the socket bus; `kernel_probe` (K1 against float64, no worse
    than its plain form); `exact_bakeoff` at 128, 256 and 512 carriers
    (equal results, the recommended boundary); `stage_bench`,
    `dfe_cost_probe` and `encode_stage_probe` at 512; `scaling_bench` at
    1, 2 and 4 shards of 64 carriers; `roofline` at 512 (K1–K8 and the
    DFE-on uplink block: the work counted from shapes, its bound, time
    and share); `collective_inventory` at 8 shards of 256 carriers a chan
    shard (equal to phase 15's traffic a step); `scaling_2proc` at 96
    carriers, 2 shards, 4 duplex steps (one worker process against two
    on the card over gloo, results bit-equal); `iq_tool` record and
    replay at 4 carriers × 26 frames (every planted burst detected);
    `trx_ping` against `python -m openbts_ttsou_tpu_torch.trx.daemon
    --device cuda` (every verb answered); `transfer_probe`. Phase 2
    times K1 through `tools/kernel_bakeoff.py`, phase 18 also at the
    128-carrier soak's two shapes;
19. the bench (`python -m openbts_ttsou_tpu_torch.bench`, each run its own
    process): `tools.bench_sweep --quick` (the five modes at 128
    carriers, the sweep's iters, one rep) and the default run (exact @512,
    BENCH_ITERS=4: 8 blocks counting 6,656 detections each), every row
    a positive rate with K1 launched 1 + 1 or 2 a block over the blocks
    it ran; then `entry()` (one `rx_step` at 4 carriers) on the card
    against the CPU.

Earlier lines are JSON records (the last of them each phase's wall time,
then the kernels line); the line before the last is the card's name and
power limit; the last line is the result object.
"""

from __future__ import annotations

import collections
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# the bench recipe (bench.py:162-195) at the symbol rate, and the radio's
# int16 I/Q format
from openbts_ttsou_tpu_torch.bench import bench_symbols, to_i16

N_CHAN = 512
BLOCKS = 3
DAEMON_CHAN = 4  # carriers of the wire daemon (each binds 2 UDP ports)
DAEMON_PORT = 52000  # its base port; the BTS side listens 50 above
ROOT = Path(__file__).resolve().parent


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def record(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---- phase 1 ---------------------------------------------------------------

def phase_card() -> str:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    from openbts_ttsou_tpu_torch import build

    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    from openbts_ttsou_tpu_torch.runtime import native

    t0 = time.perf_counter()
    out = build.build_all()
    build_s = time.perf_counter() - t0
    for name, text in out.items():
        log(f"nvcc {name}:\n{text}")
    t0 = time.perf_counter()
    native.load_runtime()
    native_s = time.perf_counter() - t0
    record({"phase": "card", "card": card,
            "device": torch.cuda.get_device_name(0),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "nvcc": nvcc[-1], "python": sys.version.split()[0],
            "kernels_built": sorted(out), "build_s": build_s,
            "native_runtime_s": native_s})
    return card


# ---- phase 2 ---------------------------------------------------------------

def phase_kernels() -> dict:
    """Each K1 shape through `tools/kernel_bakeoff.py` (the kernel, its
    plain form and one `F.conv1d`, device-timed), held to a compile-time
    instantiation, the plain form's output within 2e-4 of its scale, and
    a host that kept ahead of the device while timing."""
    from openbts_ttsou_tpu_torch.tools.kernel_bakeoff import K1_SHAPES, bake

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for n_rows, p, q, taps, t_in in K1_SHAPES:
        r = bake(n_rows, p, q, taps, t_in, gen)
        what = f"K1 {p}/{q} [{n_rows}, {t_in}]"
        # every shape of the system runs a compile-time instantiation;
        # the runtime-width one must not take them quietly
        check(r["instantiation"] != "runtime",
              f"{what}: runtime-width instantiation")
        check(r["shape_ok"] and r["finite"],
              f"{what}: shape or non-finite output")
        check(r["max_abs_err"] <= 2e-4 * r["max_abs_plain"],
              f"{what}: max|kernel - plain| {r['max_abs_err']} > "
              f"2e-4 * {r['max_abs_plain']}")
        # the plain version copies its bank to the card on every call,
        # which waits for the queue, so only the kernel and the library
        # call are held to a queue that stays ahead
        ahead = r["host_queue_share"]
        check(max(ahead["kernel"], ahead["library"]) < 1,
              f"{what}: the host fell behind the device while timing "
              f"(queue shares {ahead['kernel']:.3f}, "
              f"{ahead['library']:.3f})")
        del r["shape_ok"], r["finite"]
        rows[(n_rows, p, q, t_in)] = r
        record({"phase": "kernels", "kernel": "polyphase_resample", **r})
    return rows


# ---- phase 3 ---------------------------------------------------------------

def to_device_rate(sym: np.ndarray) -> torch.Tensor:
    """Symbol-rate stream → device rate on the card, by K1 at 96/65 ·
    651 taps."""
    from openbts_ttsou_tpu_torch.ops import fir

    return fir.polyphase_resample(torch.from_numpy(sym).cuda(), 96, 65,
                                  fir.resampler_lpf(96, 65, 651))


def bench_samples(spec) -> torch.Tensor:
    """One block of the bench recipe at the device rate."""
    dev = to_device_rate(bench_symbols(N_CHAN, spec.frames))
    return dev[:, : spec.block_in].contiguous()


def from_i16(x: torch.Tensor) -> torch.Tensor:
    return torch.complex(x[..., 0].to(torch.float32),
                         x[..., 1].to(torch.float32))


def new_transceiver(cfg, spec):
    from openbts_ttsou_tpu_torch.models.transceiver import Transceiver
    from openbts_ttsou_tpu_torch.trx.engine import ChanType

    trx = Transceiver(cfg, spec, device="cuda")
    ct = torch.full((cfg.n_chan, 8), ChanType.I, dtype=torch.int32,
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

    One more block under torch.profiler (`device_profile`, against the
    block's unprofiled wall time from phase 3). Then both exact schedules
    on one block from one entry state, timed and compared: the
    frame-by-frame `rx_step` loop (the main path above
    `EXACT_BATCH_MAX_CHAN` carriers) and the batched
    `process_block_exact` (the main path at 512)."""
    from openbts_ttsou_tpu_torch.models import transceiver as T
    from openbts_ttsou_tpu_torch.ops import fir

    prof = device_profile(lambda: trx.process_uplink(x), ms_block)

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
    out = {"phase": "profile", **prof, "schedule_ms": sched_ms}
    record(out)
    return out


def device_profile(fn, ms_block: float) -> dict:
    """fn() once under torch.profiler (`tools/common.py` `profile_once`):
    device busy time (the sum of device-side events, kernels and copies,
    on one stream) against the unprofiled wall time `ms_block`, the
    number of device-side events, the ones that take the most time, and
    the host-side ops that take the most host time (their self time,
    profiled)."""
    from openbts_ttsou_tpu_torch.tools.common import profile_once

    prof = profile_once(fn)
    check(prof["busy_ms"] > 0, "the profiler saw no device time")
    return {"device_busy_ms": prof["busy_ms"],
            "ms_per_block_unprofiled": ms_block,
            "device_idle_share": 1 - prof["busy_ms"] / ms_block,
            "device_events": prof["device_events"],
            "top": prof["top"], "host_top": prof["host_top"]}


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


def adversarial_state(cfg, dev):
    """Entry state of the adversarial streams: slot 0 combination V on
    carriers 0-1 and IV on 2-3, TSC 2, SETMAXDELAY 2, 2, 0, 4 (the DFE
    runs on carriers 0, 1 and 3)."""
    from openbts_ttsou_tpu_torch.trx.engine import ChanType, init_state

    c = cfg.n_chan
    ct = torch.full((c, 8), ChanType.I, dtype=torch.int32)
    ct[:2, 0] = ChanType.V
    ct[2:, 0] = ChanType.IV
    return init_state(cfg, dev)._replace(
        chan_type=ct.to(dev),
        tsc=torch.full((c,), 2, dtype=torch.int32, device=dev),
        max_expected_delay=torch.tensor([2, 2, 0, 4], dtype=torch.int32,
                                        device=dev))


def check_states(card_state, cpu_state, what: str) -> None:
    """Integer and bool fields exact; float fields (the DFE adoption's
    channel and equalizer, float32 sums in another order on the card)
    within atol 2e-4, rtol 5e-6."""
    from openbts_ttsou_tpu_torch.convert import state_to_numpy

    sh = state_to_numpy(cpu_state)
    for name, a in state_to_numpy(card_state).items():
        b = sh[name]
        if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
            check(np.array_equal(a, b), f"{what}: state {name}")
        else:
            check(np.allclose(a, b, atol=2e-4, rtol=5e-6),
                  f"{what}: state {name} differs by {np.abs(a - b).max()}")


def phase_card_vs_cpu() -> dict:
    from openbts_ttsou_tpu_torch.models.transceiver import process_block_exact
    from openbts_ttsou_tpu_torch.trx.engine import TrxConfig

    c, frames = 4, 13
    cfg = TrxConfig(n_chan=c, max_toa=8)
    streams = adversarial_streams(np.random.default_rng(5), c, frames, 3)
    states = {dev: adversarial_state(cfg, dev) for dev in ("cuda", "cpu")}
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
        check_states(states["cuda"], states["cpu"], f"block {k}")
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


# ---- phase 6 ---------------------------------------------------------------

def close_int(a, b, what: str) -> int:
    """Integers within ±1, at most 0.1% of them off by 1 (float32 sums in
    another order move a value across a rounding edge). Returns how many
    are off by 1."""
    d = np.abs(np.asarray(a, np.int64) - np.asarray(b, np.int64))
    check(d.shape == np.shape(a) == np.shape(b), f"{what}: shapes differ")
    off = int((d > 0).sum())
    check(d.max(initial=0) <= 1, f"{what}: max difference {d.max()}")
    check(off <= 1e-3 * d.size, f"{what}: {off} of {d.size} off by 1")
    return off


def be32(b: np.ndarray) -> np.ndarray:
    """Big-endian uint8 [..., 4] → int64 [...]."""
    return b.astype(np.int64) @ np.array([1 << 24, 1 << 16, 1 << 8, 1])


def demod_slot1(tx_i16: torch.Tensor, full_scale: float,
                frames: int) -> torch.Tensor:
    """Hard bits of slot 1 of every frame of one block's transmitted
    samples: int16 [C, block_in, 2] → K1 at 65/96 · 961 taps back to
    symbols (the block's stream starts 65 symbols early, the carried
    tail) → GMSK demodulation at the transmit amplitude. Returns
    [C, frames, 148] uint8 (tests/test_block_daemon.py:209-230)."""
    from openbts_ttsou_tpu_torch.ops import fir, gmsk

    sym = fir.polyphase_resample(from_i16(tx_i16).contiguous(), 65, 96,
                                 fir.resampler_lpf(65, 96, 961))
    idx = 65 + 157 + np.arange(frames)[:, None] * 1250 + np.arange(157)
    win = sym[:, torch.from_numpy(idx).to(sym.device)]  # [C, F, 157]
    lead = win.shape[:2]
    soft = gmsk.demodulate_burst(
        win, 1, torch.full(lead, full_scale, dtype=torch.complex64,
                           device=win.device),
        torch.zeros(lead, device=win.device))
    return (soft[..., :148] > 0.5).to(torch.uint8)


def phase_duplex() -> dict:
    """`duplex_block_compact` at 512 carriers on BLOCKS consecutive blocks
    of one continuous stream, with the known answers of both directions.

    Uplink: the bench recipe's block repeated as one stream, cut into
    windows with their 96-sample halos (a cold left halo on the first),
    as int16 I/Q; each block must give what `uplink_block` gives on the
    same samples (detections, RSSI, timing, soft bytes ±1, thresholds,
    final state) and the bench recipe's known answer. Downlink: known
    bits on slot 1 of every frame of every carrier, filler elsewhere;
    each block's DAC rows, resampled back and demodulated, must give
    those bits."""
    from openbts_ttsou_tpu_torch.models import transceiver as T
    from openbts_ttsou_tpu_torch.ops import cuda_fir
    from openbts_ttsou_tpu_torch.trx.engine import TrxConfig

    cfg = TrxConfig(n_chan=N_CHAN)
    spec = T.UplinkSpec(frames=13)
    f, halo, t_in = spec.frames, T.RX_HALO_DEV, spec.block_in
    # phase 3's block repeated as one periodic stream (its known answer
    # holds for that noise draw), BLOCKS blocks and one more frame for
    # the last block's right halo
    sym = np.tile(bench_symbols(N_CHAN, f), (1, BLOCKS + 1))
    dev = to_device_rate(sym[:, : (BLOCKS * f + 1) * 1250])
    del sym
    ul = to_i16(dev[:, : BLOCKS * t_in + halo])
    del dev
    ul = torch.cat([torch.zeros((N_CHAN, halo, 2), dtype=torch.int16,
                                device="cuda"), ul], 1)
    windows = [ul[:, k * t_in: (k + 1) * t_in + 2 * halo].cpu().numpy()
               for k in range(BLOCKS)]
    del ul
    rng = np.random.default_rng(1)
    dl_bits = np.zeros((BLOCKS, f, N_CHAN, 8, 148), np.uint8)
    dl_bits[:, :, :, 1] = rng.integers(0, 2, (BLOCKS, f, N_CHAN, 148))
    valid = np.zeros((f, N_CHAN, 8), bool)
    valid[:, :, 1] = True
    gain = np.zeros((f, N_CHAN, 8), np.int64)
    live = np.ones(N_CHAN, bool)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bufs = [torch.from_numpy(T.pack_dl_buffer_live(
        dl_bits[k], valid, gain, k * f, k * f + 2, windows[k], live)).cuda()
        for k in range(BLOCKS)]
    torch.cuda.synchronize()
    pack_ms = (time.perf_counter() - t0) / BLOCKS * 1e3

    st0 = new_transceiver(cfg, spec).state
    tail0 = torch.zeros((N_CHAN, T.TX_TAIL_SYM), dtype=torch.complex64,
                        device="cuda")
    T.duplex_block_compact(cfg, spec, st0, bufs[0], tail0)  # warm block
    torch.cuda.synchronize()

    st, tail, outs, thresholds = st0, tail0, [], []
    cuda_fir.polyphase_resample_cuda.launches = 0
    t0 = time.perf_counter()
    for k in range(BLOCKS):
        st, tail, hdr, tx_buf, pkt_buf = T.duplex_block_compact(
            cfg, spec, st, bufs[k], tail)
        outs.append((hdr, tx_buf, pkt_buf))
        thresholds.append(st.energy_threshold)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"polyphase_resample": cuda_fir.polyphase_resample_cuda.launches}
    check(launches["polyphase_resample"] == 2 * BLOCKS,
          f"K1 launched {launches['polyphase_resample']} times in {BLOCKS} "
          f"duplex blocks, expected 2 a block")
    ms_block = dt / BLOCKS * 1e3
    prof = device_profile(lambda: T.duplex_block_compact(
        cfg, spec, st, bufs[0], tail), ms_block)

    # uplink_block on the same samples, timed in turns with a second
    # duplex chain from the entry state (the host's speed drifts within a
    # call, so the two are compared block by block); the second chain
    # must repeat the first one's bytes
    ref_st, st2, tail2, refs, dup_ms, up_ms = st0, st0, tail0, [], [], []
    for k in range(BLOCKS):
        x = from_i16(torch.from_numpy(windows[k]).cuda()
                     )[:, halo: halo + t_in].contiguous()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st2, tail2, *again = T.duplex_block_compact(cfg, spec, st2, bufs[k],
                                                    tail2)
        torch.cuda.synchronize()
        dup_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        ref_st, res = T.uplink_block(cfg, spec, ref_st, x)
        torch.cuda.synchronize()
        up_ms.append((time.perf_counter() - t0) * 1e3)
        refs.append((res, ref_st.energy_threshold))
        hdr, tx_buf, pkt_buf = outs[k]
        n_det, n_live = int(be32(hdr.cpu().numpy()[:4])), N_CHAN
        check(torch.equal(again[0], hdr)
              and torch.equal(again[1][:n_live], tx_buf[:n_live])
              and torch.equal(again[2][:n_det], pkt_buf[:n_det]),
              f"duplex block {k}: a second run gave other bytes")

    # the known answers
    soft_off = 0
    fr = np.repeat(np.arange(f), N_CHAN)
    ch = np.tile(np.arange(N_CHAN), f)
    for k, ((hdr, tx_buf, pkt_buf), (res, ref_thr)) in enumerate(
            zip(outs, refs)):
        det = res.detected
        check(int(det.sum()) == N_CHAN * f and bool(det[:, :, 1].all()),
              f"duplex block {k}: uplink_block found {int(det.sum())}")
        check(not bool(res.is_rach.any()), f"duplex block {k}: RACH")
        check(bool((res.timing[det] == 6).all()), f"duplex block {k}: timing")
        h = hdr.cpu().numpy()
        n_det, n_live = int(be32(h[:4])), int(be32(h[4:]))
        check(n_det == N_CHAN * f, f"duplex block {k}: n_det {n_det}")
        check(n_live == N_CHAN, f"duplex block {k}: n_live {n_live}")
        # rows in (frame, carrier) order, all slot 1: tn, fn (BE32), rssi,
        # toa (BE16), 148 soft bytes, 2 zero bytes, carrier (BE16)
        rows = pkt_buf[:n_det].cpu().numpy()
        check(bool((rows[:, 0] == 1).all()), f"duplex block {k}: tn bytes")
        check(np.array_equal(be32(rows[:, 1:5]), k * f + fr),
              f"duplex block {k}: fn bytes")
        check(np.array_equal(rows[:, 5], (res.rssi[:, :, 1].reshape(-1)
                                          & 0xFF).cpu().numpy()),
              f"duplex block {k}: rssi bytes")
        check(bool((rows[:, 6] == 0).all() and (rows[:, 7] == 6).all()),
              f"duplex block {k}: toa bytes")
        check(bool((rows[:, 156:158] == 0).all()), f"duplex block {k}: pad")
        check(np.array_equal(rows[:, 158].astype(np.int64) * 256
                             + rows[:, 159], ch),
              f"duplex block {k}: carrier indices")
        soft_ref = torch.clamp(torch.round(res.soft_bits[:, :, 1] * 255.0),
                               0.0, 255.0).reshape(-1, 148)
        soft_off += close_int(rows[:, 8:156], soft_ref.cpu().numpy(),
                              f"duplex block {k}: soft bytes")
        check(torch.equal(thresholds[k], ref_thr)
              and bool((thresholds[k] == 250.0 - 13 * (k + 1)).all()),
              f"duplex block {k}: threshold {thresholds[k].unique().tolist()}")
        tx = tx_buf[:n_live].view(torch.int16).reshape(n_live, t_in, 2)
        hard = demod_slot1(tx, cfg.tx_full_scale, f)
        want = torch.from_numpy(dl_bits[k][:, :, 1]).cuda().transpose(0, 1)
        check(torch.equal(hard, want),
              f"duplex block {k}: {int((hard != want).sum())} tx bits wrong")
    for name in st._fields:
        check(torch.equal(getattr(st, name), getattr(ref_st, name)),
              f"duplex: final state {name} differs from uplink_block's")
    out = {"phase": "duplex", "carriers": N_CHAN, "blocks": BLOCKS,
           "ms_per_block": ms_block,
           "uplink_msamples_per_s": N_CHAN * t_in / (dt / BLOCKS) / 1e6,
           "downlink_msamples_per_s": N_CHAN * t_in / (dt / BLOCKS) / 1e6,
           "host_pack_and_upload_ms_per_block": pack_ms,
           "in_turns_ms": {"duplex_block_compact": dup_ms,
                           "uplink_block": up_ms},
           "detections_per_block": N_CHAN * f, "live_carriers": N_CHAN,
           "soft_bytes_off_by_1": soft_off,
           "launches": launches,
           "launches_per_block": {k: v / BLOCKS for k, v in launches.items()},
           "profile": prof, "device": torch.cuda.get_device_name(0)}
    record(out)
    return out


# ---- phase 7 ---------------------------------------------------------------

def norm_burst(seed: int) -> np.ndarray:
    """A TSC-0 normal burst with random data bits."""
    from openbts_ttsou_tpu_torch.utils import constants as C

    rng = np.random.default_rng(seed)
    return np.concatenate(
        [[0, 0, 0], rng.integers(0, 2, 57), [1], C.TRAINING_SEQUENCE[0], [1],
         rng.integers(0, 2, 57), [0, 0, 0]]).astype(np.uint8)


def daemon_uplink(c: int, blocks: int) -> tuple[np.ndarray, np.ndarray]:
    """The replay radio's uplink: a normal burst of amplitude 5000 on
    slots 1-7 of every frame (its own bits a slot and carrier), `blocks`
    blocks and a right halo at the device rate. Returns (bits [C, 8,
    148], complex64 [C, N])."""
    from openbts_ttsou_tpu_torch.models.transceiver import RX_HALO_DEV
    from openbts_ttsou_tpu_torch.ops import gmsk

    frames = 13 * blocks
    offs = np.concatenate([[0], np.cumsum([157, 156, 156, 156] * 2)])[:8]
    bits = np.zeros((c, 8, 148), np.uint8)
    sym = np.zeros((c, frames * 1250), np.complex64)
    for ch in range(c):
        for tn in range(1, 8):
            bits[ch, tn] = norm_burst(10 * ch + tn)
            w = 5000.0 * gmsk.modulate_burst_np(bits[ch, tn][None], 1)[0]
            for fr in range(frames):
                o = fr * 1250 + offs[tn]
                sym[ch, o: o + len(w)] += w
    dev = to_device_rate(sym)[:, : frames * 1250 * 96 // 65].cpu().numpy()
    return bits, np.pad(dev, ((0, 0), (0, 2 * RX_HALO_DEV)))


def wire_session(daemon, steps: int, dl_bits: np.ndarray):
    """Drive a block daemon as a BTS would, over loopback UDP: tune, TSC
    and slots on every carrier, POWERON last (apps/OpenBTS.cpp:200-214),
    then two windows of downlink bursts on every slot of every carrier,
    `steps` blocks and a flush. The uplink datagrams are drained after
    every step. Returns ({carrier: [datagram bytes]}, clock beacons, q0,
    the first queued frame)."""
    from openbts_ttsou_tpu_torch.runtime import UdpTransport
    from openbts_ttsou_tpu_torch.trx import protocol as proto

    n, base = daemon.cfg.n_arfcn, daemon.cfg.base_port
    peer = base + daemon.cfg.peer_port_offset
    clock = UdpTransport(peer, "127.0.0.1", base)
    ctrl = [UdpTransport(peer + 3 * i + 1, "127.0.0.1", base + 3 * i + 1)
            for i in range(n)]
    data = [UdpTransport(peer + 3 * i + 2, "127.0.0.1", base + 3 * i + 2)
            for i in range(n)]
    got = {i: [] for i in range(n)}

    def step():
        daemon.step()
        for i in range(n):
            while (d := data[i].recv(256, timeout_ms=0)) is not None:
                got[i].append(d)

    def cmd(i, verb, *args):
        ctrl[i].send(proto.pack_command(verb, *args))
        step()
        rsp = ctrl[i].recv(128, timeout_ms=2000)
        check(rsp is not None, f"no response to {verb}")
        kind, rverb, rargs = proto.parse_message(rsp)
        check(kind == "RSP" and rverb == verb and rargs[:1] == ["0"],
              f"{verb}: {rsp!r}")

    try:
        for i in range(n):
            cmd(i, "RXTUNE", 890000)
            cmd(i, "TXTUNE", 935000)
            cmd(i, "SETTSC", 0)
            for tn in range(1, 8):
                cmd(i, "SETSLOT", tn, 1)
        for i in range(n):
            cmd(i, "POWERON")
        check(daemon.on, "daemon not on after POWERON")
        q0 = daemon.tx_fn
        for fn in range(q0, q0 + 26):
            for i in range(n):
                for tn in range(8):
                    data[i].send(proto.pack_downlink(proto.DownlinkBurst(
                        tn, fn, 0, dl_bits)))
        for _ in range(steps):
            step()
        daemon.flush()
        for i in range(n):
            while (d := data[i].recv(256, timeout_ms=50)) is not None:
                got[i].append(d)
        beacons = []
        while (d := clock.recv(64, timeout_ms=50)) is not None:
            beacons.append(d)
        return got, beacons, q0
    finally:
        for s in [clock, *ctrl, *data]:
            s.close()
        daemon.close()


def phase_daemon() -> dict:
    """`BlockTrxDaemon` on the card at DAEMON_CHAN carriers, twice through
    the same wire session on the same replayed uplink: with the compact
    retire (the default) and with the dense one. The compact run's uplink
    datagrams must decode to the planted bursts and its tx capture
    demodulate to the queued bits; both runs must emit the same datagrams
    and tx blocks, byte for byte. Then the per-frame daemon through its
    command line (`daemon_entry_point`)."""
    from openbts_ttsou_tpu_torch.models.transceiver import TX_DELAY_DEV
    from openbts_ttsou_tpu_torch.ops import cuda_fir
    from openbts_ttsou_tpu_torch.trx import protocol as proto
    from openbts_ttsou_tpu_torch.trx.daemon import (BlockTrxDaemon,
                                                    TrxDaemonConfig)
    from openbts_ttsou_tpu_torch.trx.radio import ReplayBankRadio

    c, steps = DAEMON_CHAN, 6
    ul_bits, ul = daemon_uplink(c, 12)
    dl_bits = norm_burst(99)
    runs = {}
    for compact, base in (("compact", DAEMON_PORT),
                          ("dense", DAEMON_PORT + 100)):
        radio = ReplayBankRadio(ul, capture_tx_blocks=16)
        daemon = BlockTrxDaemon(radio, TrxDaemonConfig(
            base_port=base, peer_port_offset=50, n_arfcn=c, device="cuda"),
            compact=compact == "compact")
        cuda_fir.polyphase_resample_cuda.launches = 0
        t0 = time.perf_counter()
        got, beacons, q0 = wire_session(daemon, steps, dl_bits)
        wall = time.perf_counter() - t0
        runs[compact] = {"daemon": daemon, "radio": radio, "got": got,
                         "beacons": beacons, "q0": q0, "wall_s": wall,
                         "launches": cuda_fir.polyphase_resample_cuda.launches}
    comp, dense = runs["compact"], runs["dense"]
    d, radio = comp["daemon"], comp["radio"]
    blocks = d._rx_block
    check(comp["launches"] == 2 * blocks,
          f"daemon: K1 launched {comp['launches']} times in {blocks} blocks")

    for i in range(c):
        bursts = [proto.unpack_uplink(x) for x in comp["got"][i]]
        check(len(bursts) >= 7 * 13 * 2,
              f"daemon carrier {i}: {len(bursts)} uplink datagrams")
        check({u.tn for u in bursts} == set(range(1, 8)),
              f"daemon carrier {i}: slots {sorted({u.tn for u in bursts})}")
        for u in bursts:
            check(np.array_equal((u.soft > 0.5).astype(np.uint8),
                                 ul_bits[i, u.tn]) and abs(u.toa) <= 256,
                  f"daemon carrier {i}: burst fn {u.fn} tn {u.tn} wrong")
    check(bool(comp["beacons"]) and all(
        proto.parse_message(m)[:2] == ("IND", "CLOCK")
        for m in comp["beacons"]), "daemon: clock beacons")

    check(radio.tx_log[0][0] == -TX_DELAY_DEV, "daemon: first tx timestamp")
    start = d.cfg.start_fn + d.cfg.tx_latency_frames
    qblock = (comp["q0"] - start) // 13
    check((comp["q0"] - start) % 13 == 0, "daemon: queue not block-aligned")
    for b in (qblock, qblock + 1):  # the two queued windows
        tx = torch.from_numpy(radio.tx_log[b][1]).cuda()
        hard = demod_slot1(tx, d.engine_cfg.tx_full_scale, 13)
        check(bool((hard == torch.from_numpy(dl_bits).cuda()).all()),
              f"daemon: tx block {b} does not demodulate to the queued bits")

    check(comp["got"] == dense["got"],
          "daemon: compact and dense retire sent different datagrams")
    check(len(radio.tx_log) == len(dense["radio"].tx_log) and all(
        ta == tb and np.array_equal(xa, xb) for (ta, xa), (tb, xb)
        in zip(radio.tx_log, dense["radio"].tx_log)),
        "daemon: compact and dense retire wrote different tx blocks")
    check(d._filler_tx is not None, "daemon: filler cache never captured")
    check(d.d2h_bytes < dense["daemon"].d2h_bytes,
          "daemon: the compact retire fetched no fewer bytes")
    out = {"phase": "daemon", "carriers": c, "blocks": blocks,
           "process": daemon_entry_point(),
           "datagrams": {i: len(comp["got"][i]) for i in range(c)},
           "tx_blocks": len(radio.tx_log),
           "launches": {"polyphase_resample": comp["launches"]},
           "dense_launches": dense["launches"],
           "d2h_bytes": {"compact": d.d2h_bytes,
                         "dense": dense["daemon"].d2h_bytes},
           "session_s": {k: r["wall_s"] for k, r in runs.items()},
           "device": torch.cuda.get_device_name(0)}
    record(out)
    return out


def daemon_entry_point() -> dict:
    """`python -m openbts_ttsou_tpu_torch.trx.daemon` as a BTS meets it:
    started as its own process (on the card, its default), brought up
    over its control port, its clock indication read, TSC-0 bursts queued
    on slot 0 of the 100 frames from the indicated one, and their
    loopback read back as uplink datagrams (bit errors under 2%, as
    tests/test_daemon.py holds); then stopped."""
    from openbts_ttsou_tpu_torch.runtime import UdpTransport
    from openbts_ttsou_tpu_torch.trx import protocol as proto

    base = DAEMON_PORT + 200
    proc = subprocess.Popen(
        [sys.executable, "-m", "openbts_ttsou_tpu_torch.trx.daemon",
         "--base-port", str(base)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    socks = [UdpTransport(base + 100 + i, "127.0.0.1", base + i)
             for i in range(3)]
    clock, ctrl, data = socks
    t0 = time.perf_counter()
    try:
        def cmd(verb, *args, timeout_ms=2000):
            ctrl.send(proto.pack_command(verb, *args))
            rsp = ctrl.recv(256, timeout_ms=timeout_ms)
            if rsp is None:
                return None
            kind, rverb, rargs = proto.parse_message(rsp)
            check(kind == "RSP" and rverb == verb and rargs[:1] == ["0"],
                  f"daemon process: {verb} answered {rsp!r}")
            return rsp

        # the process imports torch and reaches the card first
        while cmd("RXTUNE", 890000, timeout_ms=1000) is None:
            check(proc.poll() is None and time.perf_counter() - t0 < 120,
                  "daemon process did not answer RXTUNE")
        start_s = time.perf_counter() - t0
        for verb, args in (("TXTUNE", (935000,)), ("SETTSC", (0,)),
                           ("SETSLOT", (0, 1)), ("POWERON", ())):
            check(cmd(verb, *args) is not None, f"no response to {verb}")
        fn0 = None
        while (m := clock.recv(64, timeout_ms=500)) is not None:
            kind, verb, args = proto.parse_message(m)
            check((kind, verb) == ("IND", "CLOCK"), f"clock plane: {m!r}")
            fn0 = int(args[0])
        check(fn0 is not None, "daemon process sent no clock indication")
        bits = norm_burst(7)
        queued = set(range(fn0, fn0 + 100))
        for fn in sorted(queued):
            data.send(proto.pack_downlink(proto.DownlinkBurst(0, fn, 0,
                                                              bits)))
        good, seen = 0, 0
        deadline = time.perf_counter() + 30
        while good < 10 and time.perf_counter() < deadline:
            m = data.recv(256, timeout_ms=500)
            if m is None:
                check(proc.poll() is None, "daemon process exited")
                continue
            u = proto.unpack_uplink(m)
            if u.tn == 0 and u.fn in queued:
                seen += 1
                ber = float(np.mean((u.soft > 0.5).astype(np.uint8) != bits))
                good += ber < 0.02
        check(good >= 10, f"daemon process: {good} of {seen} looped-back "
                          f"bursts decoded")
        check(proc.poll() is None, "daemon process exited")
    finally:
        for s in socks:
            s.close()
        proc.terminate()
        try:
            out, _ = proc.communicate(timeout=20)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
    log(f"daemon process output:\n{out}")
    return {"entry_point": "python -m openbts_ttsou_tpu_torch.trx.daemon",
            "answered_after_s": start_s, "looped_back_bursts": good,
            "session_s": time.perf_counter() - t0}


# ---- phase 8 ---------------------------------------------------------------

def phase_duplex_card_vs_cpu() -> dict:
    """`duplex_block_compact` on 2 consecutive blocks of the adversarial
    streams at 4 carriers, on the card and on the CPU, state and tx tail
    carried: header bytes exact, datagram bytes exact but the soft bytes
    (±1), DAC samples ±1, state as `check_states`."""
    from openbts_ttsou_tpu_torch.models import transceiver as T
    from openbts_ttsou_tpu_torch.ops import fir
    from openbts_ttsou_tpu_torch.trx.engine import TrxConfig

    c, blocks = 4, 2
    cfg = TrxConfig(n_chan=c, max_toa=8)
    spec = T.UplinkSpec(frames=13)
    f, halo, t_in = spec.frames, T.RX_HALO_DEV, spec.block_in
    rng = np.random.default_rng(6)
    sym = np.concatenate(adversarial_streams(rng, c, f, blocks + 1), -1)
    dev = fir.polyphase_resample(torch.from_numpy(sym), 96, 65,
                                 fir.resampler_lpf(96, 65, 651))  # CPU
    ul = np.pad(to_i16(dev[:, : blocks * t_in + halo]).numpy(),
                ((0, 0), (halo, 0), (0, 0)))
    lives = (np.ones(c, bool), np.array([True, False, True, True]))
    devs = ("cuda", "cpu")
    states = {d: adversarial_state(cfg, d) for d in devs}
    tails = {d: torch.zeros((c, T.TX_TAIL_SYM), dtype=torch.complex64,
                            device=d) for d in devs}
    n_det_all = off = 0
    for k in range(blocks):
        bits = rng.integers(0, 2, (f, c, 8, 148)).astype(np.uint8)
        valid = rng.random((f, c, 8)) < 0.7
        gain = rng.integers(0, 10, (f, c, 8))
        buf = T.pack_dl_buffer_live(
            bits, valid, gain, 1000 + k * f, 1002 + k * f,
            ul[:, k * t_in: (k + 1) * t_in + 2 * halo], lives[k])
        res = {}
        for d in devs:
            states[d], tails[d], *res[d] = T.duplex_block_compact(
                cfg, spec, states[d], torch.from_numpy(buf).to(d), tails[d])
        (hg, tg, pg), (hc, tc, pc) = ([x.cpu().numpy() for x in res[d]]
                                      for d in devs)
        check(np.array_equal(hg, hc), f"duplex block {k}: header bytes")
        n_det, n_live = int(be32(hc[:4])), int(be32(hc[4:]))
        check(n_live == int(lives[k].sum()) and n_det > 0,
              f"duplex block {k}: n_det {n_det}, n_live {n_live}")
        off += close_int(tg[:n_live].view("<i2"), tc[:n_live].view("<i2"),
                         f"duplex block {k}: DAC samples")
        check(np.array_equal(pg[:n_det, :8], pc[:n_det, :8])
              and np.array_equal(pg[:n_det, 156:], pc[:n_det, 156:]),
              f"duplex block {k}: datagram header bytes")
        off += close_int(pg[:n_det, 8:156], pc[:n_det, 8:156],
                         f"duplex block {k}: soft bytes")
        check_states(states["cuda"], states["cpu"], f"duplex block {k}")
        a, b = tails["cuda"].cpu(), tails["cpu"]
        check(float((a - b).abs().max()) <= 2e-4 * float(b.abs().max()),
              f"duplex block {k}: tx tail")
        n_det_all += n_det
    out = {"phase": "duplex_card_vs_cpu", "carriers": c, "blocks": blocks,
           "detections": n_det_all, "bytes_off_by_1": off,
           "valid_dfe_slots": int(states["cpu"].chan_valid.sum())}
    check(out["valid_dfe_slots"] > 0, "duplex card vs CPU: DFE unexercised")
    record(out)
    return out


# ---- phases 9-12: the resident layer 1 ------------------------------------

#: the bench's duplex_decoded slot split (bench.py:290,326): TCH/F on
#: slots 2-5, XCCH on 0, 1, 6 and 7
XCCH_TNS, TCH_TNS = (0, 1, 6, 7), (2, 3, 4, 5)
RES_WINDOWS = 5  # 4 windows of content, then one that flushes the carries
BUS_PORT = DAEMON_PORT + 300  # the USRP bus phase's daemon


def first_tch_start() -> int:
    """The first FN ≡ 0 mod 4 at which the TCH/F multiframe starts a
    diagonal: 13-frame windows from there meet all four FN%4 phases."""
    from openbts_ttsou_tpu_torch.gsm.tdma import FACCH_TCHF

    fn = int(np.where(FACCH_TCHF.reverse_map() == 0)[0][0])
    while fn % 4:
        fn += 26
    return fn


def resident_contents(c: int, fn0: int, windows: int, seed: int):
    """Downlink content of `windows` windows for c carriers, all but the
    last full: on every TCH slot, speech or (3 in 10) FACCH on each
    dispatch the window sends; on every XCCH slot, an L2 frame at every
    group start inside the window. Returns (contents, sent) with sent a
    Counter of (kind, carrier, slot, packed bits)."""
    from openbts_ttsou_tpu_torch.gsm import l1fec

    rng = np.random.default_rng(seed)
    nd = l1fec._tch_tx_tables(13)[2]  # dispatches a window sends, by phase
    tt, xt = list(TCH_TNS), list(XCCH_TNS)
    contents, sent = [], collections.Counter()
    for w in range(windows):
        fnw = fn0 + 13 * w
        x = np.zeros((4, c, 8, 184), np.uint8)
        xv = np.zeros((4, c, 8), bool)
        sp = np.zeros((3, c, 8, 260), np.uint8)
        spv = np.zeros((3, c, 8), bool)
        fa = np.zeros((3, c, 8, 184), np.uint8)
        fav = np.zeros((3, c, 8), bool)
        tch_mask = np.zeros((c, 8), bool)
        tch_mask[:, tt] = True
        if w < windows - 1:
            n = int(nd[fnw % 26])
            use_f = rng.random((n, c, len(tt))) < 0.3
            fa[:n, :, tt] = rng.integers(0, 2, (n, c, len(tt), 184))
            fav[:n, :, tt] = use_f
            sp[:n, :, tt] = rng.integers(0, 2, (n, c, len(tt), 260))
            spv[:n, :, tt] = ~use_f
            off = (-fnw) % 4
            ng = len([s for s in range(off, 13, 4)])  # starts inside
            x[:ng, :, xt] = rng.integers(0, 2, (ng, c, len(xt), 184))
            xv[:ng, :, xt] = True
        for kind, bits, valid in (("s", sp, spv), ("f", fa, fav),
                                  ("x", x, xv)):
            sent.update(frame_keys(kind, bits, valid))
        contents.append((x, xv, sp, spv, fa, fav, tch_mask))
    return contents, sent


def frame_keys(kind: str, bits: np.ndarray, mask: np.ndarray) -> list:
    """(kind, carrier, slot, packed bits) of every frame bits[g, c, tn]
    where mask[g, c, tn]."""
    g, ch, tn = np.nonzero(mask)
    packed = np.packbits(bits[g, ch, tn], axis=-1)
    return [(kind, int(a), int(b), p.tobytes())
            for a, b, p in zip(ch, tn, packed)]


def decoded_keys(blocks) -> collections.Counter:
    """The frames one window's DecodedBlocks reports decoded (speech where
    tch_good, FACCH where facch_ok, XCCH where ok)."""
    b = {k: v.cpu().numpy() for k, v in blocks._asdict().items()}
    out = collections.Counter()
    for kind, bits, mask in (("s", b["tch_speech"], b["tch_good"]),
                             ("f", b["facch_bits"], b["facch_ok"]),
                             ("x", b["bits"], b["ok"])):
        out.update(frame_keys(kind, bits, mask))
    return out


def new_resident(c: int, fn0: int, device):
    """ResidentL1 on c carriers with the bench split, combination I on
    every slot (all carry content)."""
    from openbts_ttsou_tpu_torch.models import ResidentL1
    from openbts_ttsou_tpu_torch.trx.engine import ChanType, TrxConfig

    r = ResidentL1(TrxConfig(n_chan=c), xcch_tns=XCCH_TNS, tch_tns=TCH_TNS,
                   fn0=fn0, device=device)
    r.state = r.state._replace(chan_type=torch.full(
        (c, 8), ChanType.I, dtype=torch.int32, device=device))
    return r


def to_device(content, device) -> tuple:
    return tuple(torch.from_numpy(a).to(device) for a in content)


def air_windows(txs: list, full_scale: float, extra=None) -> list:
    """The uplink windows of a looped-back downlink: the tx blocks at
    amplitude 9000 (plus `extra`, e.g. noise, of the same shape) as one
    stream, cut into windows with their two RX_HALO_DEV halos. The tx
    starts TX_DELAY_DEV early and TX_DELAY_DEV == RX_HALO_DEV, so the
    plain concatenation is the halo'd stream."""
    from openbts_ttsou_tpu_torch.models.transceiver import RX_HALO_DEV

    c, b = txs[0].shape[0], txs[0].shape[1]
    air = torch.cat([t / full_scale * 9000.0 for t in txs]
                    + [torch.zeros((c, 2 * RX_HALO_DEV), dtype=txs[0].dtype,
                                   device=txs[0].device)], -1)
    if extra is not None:
        air = air + extra
    return [air[:, w * b: (w + 1) * b + 2 * RX_HALO_DEV].contiguous()
            for w in range(len(txs))]


def viterbi_census(fn) -> list:
    """fn() with every `fec.viterbi_decode` call timed alone (the card
    synchronised around it): [{rows, steps, ms}] in call order."""
    from openbts_ttsou_tpu_torch.gsm import fec

    orig, calls = fec.viterbi_decode, []

    def timed(soft):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(soft)
        torch.cuda.synchronize()
        calls.append({"rows": soft.numel() // soft.shape[-1],
                      "steps": soft.shape[-1] // 2 + fec.V_DEFERRAL,
                      "ms": (time.perf_counter() - t0) * 1e3})
        return out

    fec.viterbi_decode = timed
    try:
        fn()
    finally:
        fec.viterbi_decode = orig
    return calls


def phase_resident() -> dict:
    """`ResidentL1` at 512 carriers with the bench split, two passes of
    RES_WINDOWS windows from an FN where all four FN%4 phases occur.
    Pass 1 transmits random speech, FACCH and L2 frames on every carrier
    with a silent uplink; pass 2 takes pass 1's stream back as its
    uplink. Known answer: every frame sent is decoded exactly once,
    bit-exact, with its flag, and nothing else is. Pass 2 is timed
    window by window, K1 counted over it; then one window profiled, the
    decode leg alone profiled, its Viterbi calls timed, decode_block and
    _encode_dl_window run under sync-debug mode "error", and a window
    timed in turns with duplex_block_wire on the same uplink and bursts
    (the FEC legs' cost)."""
    from openbts_ttsou_tpu_torch.models import transceiver as T
    from openbts_ttsou_tpu_torch.ops import cuda_fir, fir
    from openbts_ttsou_tpu_torch.parallel.halo import resample_block

    c, fn0 = N_CHAN, first_tch_start()
    contents, sent = resident_contents(c, fn0, RES_WINDOWS, seed=40)
    dl = [to_device(x, "cuda") for x in contents]
    spec = T.UplinkSpec()
    silent = torch.zeros((c, spec.block_in + 2 * T.RX_HALO_DEV),
                         dtype=torch.complex64, device="cuda")
    r = new_resident(c, fn0, "cuda")
    check({(fn0 + 13 * w) % 4 for w in range(RES_WINDOWS)} == {0, 1, 2, 3},
          "resident: the windows miss an FN%4 phase")
    t0 = time.perf_counter()
    txs = [r.step(silent, d)[0] for d in dl]
    torch.cuda.synchronize()
    pass1_ms = (time.perf_counter() - t0) / RES_WINDOWS * 1e3
    uls = air_windows(txs, r.cfg.tx_full_scale)
    del txs

    r = new_resident(c, fn0, "cuda")
    cuda_fir.polyphase_resample_cuda.launches = 0
    blocks, ms = [], []
    for w in range(RES_WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blocks.append(r.step(uls[w], dl[w])[1])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = {"polyphase_resample":
                cuda_fir.polyphase_resample_cuda.launches}
    check(launches["polyphase_resample"] == 2 * RES_WINDOWS,
          f"resident: K1 launched {launches['polyphase_resample']} times in "
          f"{RES_WINDOWS} windows, expected 2 a window")
    got = collections.Counter()
    for b in blocks:
        got.update(decoded_keys(b))
    kinds = {k: sum(n for key, n in sent.items() if key[0] == k)
             for k in "sfx"}
    check(max(got.values()) == 1, "resident: a frame decoded twice")
    check(got == sent, f"resident: {len(sent - got)} frames sent and not "
          f"decoded, {len(got - sent)} decoded and not sent (of "
          f"{sum(sent.values())})")

    # one more window, profiled, and its decode leg alone; the carry is
    # put back after each
    snap = r.carry()
    flush = dl[-1]
    prof = device_profile(lambda: r.step(uls[-1], flush),
                          statistics.median(ms))
    r.restore(snap)
    census = viterbi_census(lambda: r.step(uls[-1], flush))
    r.restore(snap)
    st = r.state._replace(fn=torch.full((), r.fn, dtype=torch.int32,
                                        device="cuda"))
    sym = resample_block(uls[-1], spec.p, spec.q,
                         fir.resampler_lpf(spec.p, spec.q, spec.taps),
                         T.RX_HALO_DEV, spec.block_in)
    _, res = T._exact_rx(r.cfg, spec.frames, st,
                         sym[..., : spec.block_symbols])

    def decode():
        return T.decode_block(res, st.fn, spec.frames, 0,
                              prev_soft=r.prev_soft,
                              prev_valid=r.prev_valid, xcch_tns=XCCH_TNS,
                              tch_tns=TCH_TNS, rach_tns=r.cfg.rach_slots)

    def encode():
        return T._encode_dl_window(
            r.cfg, spec, st, *flush, r.tx_carry[0], st.fn,
            xcch_phase=r.fn % 4, xcch_carry=r.tx_carry[1],
            xcch_tns=XCCH_TNS, tch_tns=TCH_TNS)

    decode()
    encode()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode()
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3
    decode_prof = device_profile(decode, decode_ms)
    # neither FEC leg may wait for the card
    torch.cuda.set_sync_debug_mode("error")
    try:
        decode()
        encode()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    # what the FEC legs add, in turns from one carry on one window: the
    # resident step against duplex_block_wire on the same uplink and the
    # bursts the encode leg makes (the host's speed drifts within a call)
    bits, valid, _, _ = encode()
    atten = torch.zeros(valid.shape, device="cuda")
    turns = {"resident_step": [], "duplex_block_wire": []}
    for _ in range(3):
        r.restore(snap)
        for name, fn in (("resident_step", lambda: r.step(uls[-1], flush)),
                         ("duplex_block_wire", lambda: T.duplex_block_wire(
                             r.cfg, spec, st, uls[-1], snap["tx_tail"],
                             bits, valid, atten))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            turns[name].append((time.perf_counter() - t0) * 1e3)
    r.restore(snap)
    out = {"phase": "resident", "carriers": c, "windows": RES_WINDOWS,
           "split": {"xcch_tns": XCCH_TNS, "tch_tns": TCH_TNS},
           "fn0": fn0, "frames_sent": kinds,
           "frames_decoded": sum(got.values()),
           "pass1_ms_per_window": pass1_ms, "pass2_ms": ms,
           "pass2_ms_per_window": statistics.median(ms),
           "launches": launches,
           "launches_per_window": {k: v / RES_WINDOWS
                                   for k, v in launches.items()},
           "profile": prof,
           "in_turns_ms": turns,
           "decode_leg": {"ms": decode_ms, "profile": decode_prof},
           "viterbi": {"calls": census,
                       "steps": sum(x["steps"] for x in census),
                       "ms": sum(x["ms"] for x in census)},
           "sync_debug_error_passed": ["decode_block", "_encode_dl_window"],
           "device": torch.cuda.get_device_name(0)}
    record(out)
    return out, uls, blocks


def blocks_match(a, b, what: str) -> None:
    """Two DecodedBlocks report the same decodes: equal flags, and equal
    payloads wherever a flag is set (garbage of failed groups reads the
    soft bits at the window's edges, which a window without halos
    resamples differently)."""
    for name in ("ok", "tch_good", "facch_ok", "tch_valid", "first_fn",
                 "tch_end_fn"):
        check(torch.equal(getattr(a, name), getattr(b, name)),
              f"{what}: {name} differs")
    check(decoded_keys(a) == decoded_keys(b), f"{what}: decoded frames")


def phase_uplink_decoded(uls: list, blocks: list) -> dict:
    """`uplink_block_decoded_stream` at 512 carriers on the resident
    phase's uplink windows (without their halos), its prelude carried:
    each window decodes what the resident phase's pass 2 did."""
    from openbts_ttsou_tpu_torch.models import transceiver as T
    from openbts_ttsou_tpu_torch.ops import cuda_fir

    c, fn0 = N_CHAN, first_tch_start()
    spec = T.UplinkSpec()
    r = new_resident(c, fn0, "cuda")
    st, cfg = r.state, r.cfg
    prev, pv = r.prev_soft, r.prev_valid
    h = T.RX_HALO_DEV
    cuda_fir.polyphase_resample_cuda.launches = 0
    ms = []
    for w, ul in enumerate(uls):
        x = ul[:, h: h + spec.block_in].contiguous()
        st = st._replace(fn=torch.full((), fn0 + 13 * w, dtype=torch.int32,
                                       device="cuda"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, _, got, prev, pv = T.uplink_block_decoded_stream(
            cfg, spec, st, x, 0, prev, pv, XCCH_TNS, TCH_TNS)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        blocks_match(got, blocks[w], f"uplink decoded window {w}")
    launches = {"polyphase_resample":
                cuda_fir.polyphase_resample_cuda.launches}
    check(launches["polyphase_resample"] == len(uls),
          f"uplink decoded: K1 launched {launches} in {len(uls)} windows")
    out = {"phase": "uplink_decoded", "carriers": c, "windows": len(uls),
           "ms": ms, "ms_per_window": statistics.median(ms),
           "launches": launches}
    record(out)
    return out


def phase_resident_card_vs_cpu() -> dict:
    """ResidentL1 at 4 carriers on the card and on the CPU over 4 windows
    of content with noise σ 40 on the looped-back uplink: DecodedBlocks
    exact, tx as int16 DAC samples within ±1 (at most 0.1% off). A carry
    taken on the card after window 2 and restored on the CPU through
    convert.py continues as the card does."""
    from openbts_ttsou_tpu_torch import convert
    from openbts_ttsou_tpu_torch.models import transceiver as T

    c, n_win, fn0 = 4, 4, first_tch_start() + 26
    contents, sent = resident_contents(c, fn0, n_win, seed=41)
    spec = T.UplinkSpec()
    silent = torch.zeros((c, spec.block_in + 2 * T.RX_HALO_DEV),
                         dtype=torch.complex64, device="cuda")
    r = new_resident(c, fn0, "cuda")
    txs = [r.step(silent, to_device(x, "cuda"))[0] for x in contents]
    gen = torch.Generator(device="cuda").manual_seed(3)
    n_air = n_win * spec.block_in + 2 * T.RX_HALO_DEV
    noise = torch.randn((c, n_air), dtype=torch.complex64, device="cuda",
                        generator=gen) * 40.0
    uls = air_windows(txs, r.cfg.tx_full_scale, noise)
    runs = {}
    for dev in ("cuda", "cpu"):
        r = new_resident(c, fn0, dev)
        outs = []
        for w in range(n_win):
            tx, b = r.step(uls[w].to(dev), to_device(contents[w], dev))
            outs.append((tx.cpu(), type(b)(*(v.cpu() for v in b))))
            if dev == "cuda" and w == 2:
                snap = convert.resident_carry_to_numpy(r.carry())
        runs[dev] = outs
    off, got = 0, collections.Counter()
    for w in range(n_win):
        (tg, bg), (tc, bc) = runs["cuda"][w], runs["cpu"][w]
        for k in bg._fields:
            check(torch.equal(getattr(bg, k), getattr(bc, k)),
                  f"resident card vs CPU window {w}: {k} differs")
        off += close_int(to_i16(tg).numpy(), to_i16(tc).numpy(),
                         f"resident card vs CPU window {w}: DAC samples")
        got.update(decoded_keys(bg))
    check(got == sent, f"resident card vs CPU: {len(sent - got)} frames "
          f"lost, {len(got - sent)} extra, of {sum(sent.values())}")
    cpu = new_resident(c, 0, "cpu")
    cpu.restore(convert.resident_carry_from_numpy(snap, "cpu"))
    check(cpu.fn == fn0 + 13 * 3, "resident carry: fn")
    tx, b = cpu.step(uls[3].cpu(), to_device(contents[3], "cpu"))
    for k in b._fields:
        check(torch.equal(getattr(b, k), getattr(runs["cuda"][3][1], k)),
              f"resident carry card → CPU: {k} differs")
    off += close_int(to_i16(tx).numpy(), to_i16(runs["cuda"][3][0]).numpy(),
                     "resident carry card → CPU: DAC samples")
    out = {"phase": "resident_card_vs_cpu", "carriers": c, "windows": n_win,
           "frames_sent_and_decoded": sum(sent.values()),
           "dac_samples_off_by_1": off, "carry_restored_after_window": 2}
    record(out)
    return out


def phase_usrp_bus() -> dict:
    """The port's BlockTrxDaemon on the card over USRPBankRadio →
    SocketBus → a `python -m openbts_ttsou_tpu_torch.trx.bus_server`
    process at 2 carriers, the server streaming a planted-burst stimulus
    (TSC-0 bursts of amplitude 5000 on slots 1-3 of every frame). Every
    detection's hard bits must equal its planted burst, and the daemon's
    DAC blocks must reach the server as USRP packets."""
    from openbts_ttsou_tpu_torch.ops import cuda_fir, gmsk
    from openbts_ttsou_tpu_torch.runtime import UdpTransport
    from openbts_ttsou_tpu_torch.trx import protocol as proto
    from openbts_ttsou_tpu_torch.trx.daemon import (BlockTrxDaemon,
                                                    TrxDaemonConfig)
    from openbts_ttsou_tpu_torch.trx.usrp import (SocketBus, USRPBankRadio,
                                                  USRPRadio)

    n, slots, steps = 2, (1, 2, 3), 6
    offs = np.concatenate([[0], np.cumsum([157, 156, 156, 156] * 2)])[:8]
    sym = np.zeros((1, 13 * 1250), np.complex64)
    bits = {}
    for tn in slots:
        bits[tn] = norm_burst(200 + tn)
        w = 5000.0 * gmsk.modulate_burst_np(bits[tn][None], 1)[0]
        for f in range(13):
            sym[0, f * 1250 + offs[tn]: f * 1250 + offs[tn] + len(w)] += w
    dev = to_device_rate(sym)[0, : 13 * 1250 * 96 // 65]
    stim = to_i16(dev).cpu().numpy()
    work = ROOT / "build" / "usrp_bus"
    work.mkdir(parents=True, exist_ok=True)
    np.save(work / "stim.npy", stim)
    sock = work / "usrp.sock"
    if sock.exists():
        sock.unlink()
    t0 = time.perf_counter()
    srv = subprocess.Popen(
        [sys.executable, "-m", "openbts_ttsou_tpu_torch.trx.bus_server",
         "--socket", str(sock), "--carriers", str(n), "--hw-delay", "0",
         "--stimulus", str(work / "stim.npy")], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    base, peer = BUS_PORT, BUS_PORT + 50
    socks = []
    try:
        while not sock.exists():
            check(srv.poll() is None and time.perf_counter() - t0 < 120,
                  "bus server did not bind its socket")
            time.sleep(0.05)
        bound_s = time.perf_counter() - t0
        radios = [USRPRadio(SocketBus(str(sock), carrier=i))
                  for i in range(n)]
        daemon = BlockTrxDaemon(USRPBankRadio(radios), TrxDaemonConfig(
            base_port=base, peer_port_offset=50, n_arfcn=n, device="cuda"))
        ctrl = [UdpTransport(peer + 3 * i + 1, "127.0.0.1", base + 3 * i + 1)
                for i in range(n)]
        data = [UdpTransport(peer + 3 * i + 2, "127.0.0.1", base + 3 * i + 2)
                for i in range(n)]
        socks = ctrl + data
        for i in range(n):
            for verb, a in (("RXTUNE", (890000,)), ("TXTUNE", (935000,)),
                            ("SETTSC", (0,))):
                ctrl[i].send(proto.pack_command(verb, *a))
            for tn in slots:
                ctrl[i].send(proto.pack_command("SETSLOT", tn, 1))
        daemon.step()
        for i in range(n):
            ctrl[i].send(proto.pack_command("POWERON"))
        cuda_fir.polyphase_resample_cuda.launches = 0
        t1 = time.perf_counter()
        for _ in range(steps):
            daemon.step()
        daemon.flush()
        session_s = time.perf_counter() - t1
        launches = {"polyphase_resample":
                    cuda_fir.polyphase_resample_cuda.launches}
        blocks = daemon._rx_block
        check(daemon.on and blocks == steps, f"usrp bus: {blocks} blocks")
        check(launches["polyphase_resample"] == 2 * blocks,
              f"usrp bus: K1 launched {launches} in {blocks} blocks")
        want = (blocks - 1) * 13 * len(slots)  # the first block's halo is cold
        got = {}
        for i in range(n):
            dgrams = []
            end = time.perf_counter() + 30
            while len(dgrams) < want and time.perf_counter() < end:
                if (d := data[i].recv(256, timeout_ms=200)) is not None:
                    dgrams.append(d)
            while (d := data[i].recv(256, timeout_ms=0)) is not None:
                dgrams.append(d)
            ups = [proto.unpack_uplink(d) for d in dgrams]
            check(len(ups) >= want, f"usrp bus carrier {i}: {len(ups)} "
                                    f"detections, expected {want}")
            check({u.tn for u in ups} == set(slots),
                  f"usrp bus carrier {i}: slots {sorted({u.tn for u in ups})}")
            for u in ups:
                check(np.array_equal((u.soft > 0.5).astype(np.uint8),
                                     bits[u.tn]),
                      f"usrp bus carrier {i}: fn {u.fn} tn {u.tn} bits")
            got[i] = len(ups)
        tx_bytes = [r.bus.tx_bytes for r in radios]
        check(all(b > blocks * 24000 * 4 for b in tx_bytes),
              f"usrp bus: {tx_bytes} bytes written, the DAC blocks did not "
              f"reach the server")
        daemon.close()
    finally:
        for s in socks:
            s.close()
        srv.terminate()
        try:
            srv_out, _ = srv.communicate(timeout=20)
        except subprocess.TimeoutExpired:
            srv.kill()
            srv_out, _ = srv.communicate()
    log(f"bus server output:\n{srv_out}")
    out = {"phase": "usrp_bus", "carriers": n, "blocks": blocks,
           "entry_point": "python -m openbts_ttsou_tpu_torch.trx.bus_server",
           "server_bound_after_s": bound_s, "session_s": session_s,
           "detections": got, "bus_tx_bytes": tx_bytes,
           "launches": launches}
    record(out)
    return out


# ---- phases 13-14: the BTS over the air ------------------------------------

BTS_PORT = DAEMON_PORT + 400  # phase 13's daemon; its BTSApp listens 100 above
BTS_SPAWN_PORT = DAEMON_PORT + 600  # phase 14's spawned daemon
BTS_AMPL = 9000.0  # the simulated MS's burst amplitude (tests/test_e2e_lur.py)
BTS_IMSI = "001010123456789"
BTS_SPEECH = 50  # GSM 06.10 frames each way in the call
BTS_PROFILE_FRAMES = 51


#: phase 13's settings over examples/openbts_tpu.config: every C0
#: timeslot equipped (TN0 C-V: beacon, CCCH, RACH, SDCCH/4; TN1 C-VII:
#: SDCCH/8; TN2-7 TCH/F). The rig runs slower than the air, so the
#: channel-recycling timers (wall clock) are raised out of the way, as
#: tests/test_e2e_lur.py does.
BTS_SETTINGS = (("GSM.NumC7s", "1"), ("GSM.NumTCH", "6"),
                ("GSM.Timer.T3101", "600000"), ("GSM.Timer.T3109", "600000"),
                ("GSM.Timer.T3111", "2500"))


def bts_config():
    """examples/openbts_tpu.config with BTS_SETTINGS."""
    from openbts_ttsou_tpu_torch.utils.config import ConfigurationTable

    cfg = ConfigurationTable(str(ROOT / "examples" / "openbts_tpu.config"))
    for key, value in BTS_SETTINGS:
        cfg.set(key, value)
    return cfg


class DaemonClock:
    """The BTS frame clock slaved to the in-process daemon (the wall-clock
    Clock assumes a radio paced in real time)."""

    def __init__(self, daemon):
        self.daemon = daemon

    def fn(self):
        return self.daemon.tx_fn

    def set_fn(self, fn):
        pass


class BtsRig:
    """`BTSApp` and the port's per-frame `TrxDaemon` in one process over a
    `DuplexLoopbackRadio`, both on `device`, brought up through the
    daemon's `handle_control` (tests/test_e2e_lur.py's rig). `pump` steps
    both one frame at a time and keeps each step's wall time; `record`
    collects every downlink burst the app hands the daemon, every L3
    message that reaches Control and every one the MS decodes, by frame
    number."""

    def __init__(self, device, base_port: int, cfg=None):
        from openbts_ttsou_tpu_torch.apps.openbts import BTSApp
        from openbts_ttsou_tpu_torch.trx import protocol as proto
        from openbts_ttsou_tpu_torch.trx.daemon import (TrxDaemon,
                                                        TrxDaemonConfig)
        from openbts_ttsou_tpu_torch.trx.radio import DuplexLoopbackRadio

        self.radio = DuplexLoopbackRadio()
        self.daemon = TrxDaemon(self.radio, TrxDaemonConfig(
            base_port=base_port, device=device))
        self.app = app = BTSApp(cfg or bts_config(), trx_base_port=base_port,
                                device=device)
        app.bts.clock = DaemonClock(self.daemon)
        for ch in app.dcch:
            ch.l1.clock = app.bts.clock.fn
            ch.sacch.clock = app.bts.clock.fn
        for tch in app.bts.tch_pool:
            tch.l1.clock = app.bts.clock.fn
        self.sip_out: list = []
        app.control.sip_send = self.sip_out.append
        slots = [(0, 5)] + [(tn, 7) for tn in app._c7_tns] + \
            [(t.tn, 1) for t in app.bts.tch_pool]
        for verb, args in (("RXTUNE", (890000,)), ("TXTUNE", (935000,)),
                           ("SETTSC", (app.bts.bcc,)),
                           *(("SETSLOT", s) for s in slots),
                           ("POWERON", ())):
            rsp = self.daemon.handle_control(proto.pack_command(verb, *args))
            check(proto.parse_message(rsp)[2][:1] == ["0"],
                  f"bts rig: {verb} {args} answered {rsp!r}")
        self.daemon_ms: list = []
        self.app_ms: list = []
        self.bursts: list | None = None
        self.l3: list | None = None
        arfcn = app.trx.arfcn(0)
        write, dispatch = arfcn.write_high_side, app.control.dispatch_l3

        def write_logged(burst, gain_db=0):
            if self.bursts is not None:
                self.bursts.append((burst.fn, burst.tn,
                                    np.asarray(burst.bits, np.uint8)
                                    .tobytes()))
            write(burst, gain_db)

        def dispatch_logged(ch, bits):
            if self.l3 is not None:
                self.l3.append(("bts", app.bts.clock.fn(),
                                np.asarray(bits, np.uint8).tobytes()))
            dispatch(ch, bits)

        arfcn.write_high_side = write_logged
        app.control.dispatch_l3 = dispatch_logged

    def record(self) -> None:
        self.bursts, self.l3 = [], []

    def pump(self, frames: int = 1) -> None:
        for _ in range(frames):
            t0 = time.perf_counter()
            self.daemon.step()
            t1 = time.perf_counter()
            self.app.step()
            t2 = time.perf_counter()
            self.daemon_ms.append((t1 - t0) * 1e3)
            self.app_ms.append((t2 - t1) * 1e3)

    def reclaim(self) -> None:
        """Hand every dedicated channel back and drop every transaction
        (tests/test_e2e_lur.py's _reclaim_channels), so each scenario
        starts from a fresh RACH."""
        app, ctl = self.app, self.app.control
        for ch in list(app.dcch) + list(app.bts.tch_pool):
            ch.l1.close()
            if ch.sacch is not None:
                ch.sacch.close()
            ch.reset()
            app.bts.release(ch)
        ctl.channel_transactions.clear()
        ctl.pending_release.clear()
        for t in list(ctl.transactions.entries()):
            if t.sip is not None:
                t.sip.close()
            ctl.transactions.remove(t.id)
        self.sip_out.clear()

    def close(self) -> None:
        self.app.shutdown()
        self.daemon.close()


class SimMS:
    """A mobile station on the MS side of the rig's radio, built from the
    port's own ops on the CPU: GMSK modulation, midamble detection and
    demodulation, the L1 codecs and LAPDm (tests/test_e2e_lur.py's MS).
    It holds one dedicated channel at a time."""

    def __init__(self, rig: BtsRig):
        from openbts_ttsou_tpu_torch.gsm.lapdm import L2LAPDm

        self.rig, self.daemon = rig, rig.daemon
        self.bcc = rig.app.bts.bcc
        self.l2 = L2LAPDm(c=0, sapi=0)
        self.l2_sms = L2LAPDm(c=0, sapi=3)
        self.got: list = []  # L3 messages decoded on the SAPI-0 link
        self.tn = self.dl_map = self.ul_map = None
        self.ul_fn = self.fn_scan = 0

    # -- air interface ---------------------------------------------------
    def tx_burst(self, bits, fn: int, tn: int = 0) -> None:
        from openbts_ttsou_tpu_torch.ops import gmsk
        from openbts_ttsou_tpu_torch.trx.daemon import SLOT_OFFSETS

        wave = BTS_AMPL * gmsk.modulate_burst_np(
            np.asarray(bits, np.uint8)[None], 1, guard_len=9)[0]
        self.rig.radio.ms_write(wave, self.daemon._frame_ts(fn)
                                + int(SLOT_OFFSETS[tn]))

    def tx_rach(self, ra: int, fn: int) -> None:
        from openbts_ttsou_tpu_torch.gsm import l1fec
        from openbts_ttsou_tpu_torch.utils import constants as C

        coded = l1fec.rach_encode(torch.tensor([ra]),
                                  torch.tensor(self.bcc)).numpy()[0]
        bits = np.zeros(148, np.uint8)
        bits[:8] = [0, 1, 0, 1, 0, 1, 0, 1]
        bits[8:49] = C.RACH_SYNCH_SEQUENCE
        bits[49:85] = coded
        self.tx_burst(bits, fn)

    def rx_soft(self, fn: int, tn: int = 0):
        """One downlink burst demodulated off the air, or None."""
        from openbts_ttsou_tpu_torch.ops import correlate, gmsk
        from openbts_ttsou_tpu_torch.trx.daemon import SLOT_OFFSETS

        raw = self.rig.radio.ms_read(157, self.daemon._frame_ts(fn)
                                     + int(SLOT_OFFSETS[tn]))
        if np.abs(raw).max() < 1.0:
            return None
        x = torch.from_numpy(np.ascontiguousarray(raw[None]))
        det, _, _ = correlate.analyze_traffic_burst(x, self.bcc, 1)
        if not bool(det.detected[0]):
            return None
        return gmsk.demodulate_burst(x, 1, det.amplitude,
                                     det.toa)[0].numpy()[:148]

    def rx_l2_block(self, fn: int, tn: int = 0):
        from openbts_ttsou_tpu_torch.gsm import l1fec
        from openbts_ttsou_tpu_torch.gsm.transfer import L2Frame

        softs = []
        for f in range(fn, fn + 4):
            s = self.rx_soft(f, tn)
            if s is None:
                return None
            softs.append(s)
        frames, ok = l1fec.xcch_decode(torch.from_numpy(np.stack(softs))[None])
        if not bool(ok[0]):
            return None
        return L2Frame(l1fec.lsb8msb(frames[0]).numpy())

    def tx_l2(self, frame, fn_from: int) -> int:
        from openbts_ttsou_tpu_torch.gsm import l1fec

        bits = l1fec.lsb8msb(torch.from_numpy(np.asarray(frame.bits,
                                                         np.uint8)))
        fn = self.ul_map.next_write_time(fn_from)  # a block's first burst
        while self.ul_map.reverse(fn) % 4:
            fn = self.ul_map.next_write_time(fn + 1)
        for b in l1fec.xcch_encode(bits[None], tsc=self.bcc)[0].numpy():
            fn = self.ul_map.next_write_time(fn)
            self.tx_burst(b, fn, self.tn)
            fn += 1
        return fn

    # -- access ----------------------------------------------------------
    def ccch_message(self, fn_from: int, frames: int, offset: int, want):
        """Pump until an L3 message of type `want` is decoded from the CCCH
        block at `offset` of a 51-multiframe (6: AGCH, 12: PCH)."""
        from openbts_ttsou_tpu_torch.gsm.l3 import parse_l3

        fn = fn_from
        while fn < fn_from + frames:
            self.rig.pump()
            while fn < self.daemon.fn - 5:
                if fn % 51 == offset:
                    frame = self.rx_l2_block(fn)
                    if frame is not None:
                        msg = parse_l3(frame.bits[8:])  # Bbis pseudolength
                        if want(msg):
                            return msg
                fn += 1
        return None

    def access(self, ra: int, l3_msg) -> None:
        """RACH in a C-V access window → the Immediate Assignment off the
        AGCH → SABM carrying `l3_msg` on the assigned SDCCH (contention
        resolution)."""
        from openbts_ttsou_tpu_torch.gsm import tdma
        from openbts_ttsou_tpu_torch.gsm.l3 import rr
        from openbts_ttsou_tpu_torch.gsm.lapdm import LAPDState
        from openbts_ttsou_tpu_torch.gsm.transfer import FrameType

        bts = self.rig.app.bts
        free = bts.sdcch_available()
        fn_r = self.daemon.fn + 8
        while fn_r % 51 not in range(14, 37):
            fn_r += 1
        self.tx_rach(ra, fn_r)
        for _ in range(80):
            self.rig.pump()
            if bts.sdcch_available() < free:
                break
        check(bts.sdcch_available() < free, f"RACH {ra:#x} not granted")
        ia = self.ccch_message(fn_r, 160, 6, lambda m: isinstance(
            m, rr.ImmediateAssignment) and m.reference.ra == ra)
        check(ia is not None, f"no Immediate Assignment for RA {ra:#x}")
        tao = ia.channel.type_and_offset
        check(4 <= tao < 16, f"IA channel type {tao}")
        sub = tao - 4 if tao < 8 else tao - 8
        self.tn = ia.channel.tn
        self.dl_map, self.ul_map = (tdma.SDCCH_4 if tao < 8
                                    else tdma.SDCCH_8)[sub]
        self.channel = next(c for c in self.rig.app.dcch
                            if c.l1.tn == self.tn
                            and c.l1.subchannel == sub)
        self.l2._send_u(FrameType.SABM, True, self.l2.c, l3_msg.encode())
        self.l2.state = LAPDState.AwaitingEstablish  # awaiting the UA
        self.ul_fn = self.tx_l2(self.l2.take_l1_out()[0],
                                self.daemon.fn + 4)
        self.fn_scan = self.daemon.fn - 10

    # -- the dedicated channel ---------------------------------------------
    def send_l3(self, msg, l2=None) -> None:
        from openbts_ttsou_tpu_torch.gsm.transfer import L3Frame, Primitive

        (l2 or self.l2).write_high_side(
            L3Frame(msg.encode() if hasattr(msg, "encode") else msg,
                    Primitive.DATA))
        self.flush()

    def flush(self) -> None:
        for l2 in (self.l2, self.l2_sms):
            for out in l2.take_l1_out():
                self.ul_fn = self.tx_l2(out, max(self.ul_fn,
                                                 self.daemon.fn + 4))

    def drive(self, rounds: int, want=None, until=None):
        """Pump; decode the SDCCH downlink into both SAPs; send the MS's
        LAPDm answers; collect SAPI-0 L3 messages. Returns the first of
        type `want`, or True once `until()` holds, or None."""
        from openbts_ttsou_tpu_torch.gsm.l3 import parse_l3

        for _ in range(rounds):
            self.rig.pump()
            while self.fn_scan < self.daemon.fn - 5:
                if self.dl_map.reverse(self.fn_scan) == 0:
                    frame = self.rx_l2_block(self.fn_scan, self.tn)
                    if frame is not None:
                        (self.l2_sms if frame.sapi() == 3
                         else self.l2).write_low_side(frame)
                self.fn_scan += 1
            self.flush()
            while (l3 := self.l2.read_high_side()) is not None:
                if self.rig.l3 is not None:
                    self.rig.l3.append(("ms", self.daemon.fn, np.asarray(
                        l3.bits, np.uint8).tobytes()))
                if len(l3.bits) >= 16:
                    m = parse_l3(l3.bits)
                    if m is not None:
                        self.got.append(m)
                        if want is not None and isinstance(m, want):
                            return m
            if until is not None and until():
                return True
        return None


def ota_location_update(rig: BtsRig) -> dict:
    """tests/test_e2e_lur.py::test_over_the_air_location_update: RACH →
    IA → SABM(LUR) → SIP REGISTER → 200 OK → LU Accept with a TMSI
    decoded off the air."""
    from openbts_ttsou_tpu_torch.gsm.l3 import common as l3c
    from openbts_ttsou_tpu_torch.gsm.l3 import mm
    from openbts_ttsou_tpu_torch.sip.message import SIPMessage, make_response

    app, t0 = rig.app, len(rig.daemon_ms)
    ms = SimMS(rig)
    rig.pump(5)  # beacon warm-up
    ms.access(0x42, mm.LocationUpdatingRequest(
        app.bts.lai(), l3c.MobileIdentity.imsi(BTS_IMSI)))
    check(ms.drive(120, until=lambda: bool(rig.sip_out)),
          "no REGISTER emitted")
    reg = SIPMessage.parse(rig.sip_out.pop())
    check(reg.method == "REGISTER" and f"IMSI{BTS_IMSI}" in
          (reg.get("from") or ""), f"not the MS's REGISTER: {reg.method}")
    t = app.control.transactions.entries()[0]
    app.control.on_sip_response(t, ms.channel, make_response(reg, 200, "OK"))
    accept = ms.drive(140, mm.LocationUpdatingAccept)
    check(accept is not None and accept.identity is not None,
          f"no LocationUpdatingAccept decoded; got {ms.got}")
    check(app.control.tmsis.imsi(accept.identity.tmsi) == BTS_IMSI,
          "the TMSI decoded off the air is not the MS's in control.tmsis")
    check(accept.lai.lac == app.bts.lac, "LU Accept LAC")
    return {"tmsi": accept.identity.tmsi, "frames": len(rig.daemon_ms) - t0}


def ota_voice_call(rig: BtsRig, speech: int, profile=None) -> dict:
    """tests/test_e2e_lur.py::test_over_the_air_voice_call with `speech`
    GSM 06.10 frames each way: access → CM Service → Setup → early
    assignment to a TCH/F → Connect → AssignmentComplete; speech from the
    MS's TCH encoder over the air to RTP, and RTP to the air decoded by
    the MS; then the MS's DISC hands the SDCCH back. `profile(rig, frame)`,
    when given, runs `frame()` (one frame of the call) BTS_PROFILE_FRAMES
    times once half the downlink speech has been sent."""
    import socket
    import struct

    from openbts_ttsou_tpu_torch.control.voice import (payload_to_rtp,
                                                       rtp_to_payload)
    from openbts_ttsou_tpu_torch.gsm import channels, tdma
    from openbts_ttsou_tpu_torch.gsm.l3 import cc, mm, rr
    from openbts_ttsou_tpu_torch.gsm.l3 import common as l3c
    from openbts_ttsou_tpu_torch.gsm.transfer import (L3Frame, Primitive,
                                                      RxBurst)
    from openbts_ttsou_tpu_torch.sip.message import (SIPMessage, make_response,
                                                     make_sdp)

    app, daemon, t0 = rig.app, rig.daemon, len(rig.daemon_ms)
    rng = np.random.default_rng(7)
    ms = SimMS(rig)
    free = app.bts.sdcch_available()
    ms.access(0x33, mm.CMServiceRequest(
        service_type=1, identity=l3c.MobileIdentity.imsi(BTS_IMSI)))
    check(ms.drive(140, mm.CMServiceAccept) is not None,
          f"no CMServiceAccept; got {ms.got}")
    ms.send_l3(cc.Setup(cc.CalledPartyBCDNumber("8005551000")))
    assign = ms.drive(420, rr.AssignmentCommand) or next(
        (m for m in ms.got if isinstance(m, rr.AssignmentCommand)), None)
    check(assign is not None, f"no AssignmentCommand; got {ms.got}")
    tch_tn = assign.channel.tn
    check(any(t.tn == tch_tn for t in app.bts.tch_pool),
          f"assigned TN{tch_tn} is not a TCH/F")
    invite = next(SIPMessage.parse(b) for b in rig.sip_out
                  if SIPMessage.parse(b).method == "INVITE")
    rig.sip_out.clear()
    t = max((x for x in app.control.transactions.entries()
             if x.imsi == BTS_IMSI and x.called == "8005551000"),
            key=lambda x: x.id)
    rtp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        rtp.bind(("127.0.0.1", 0))
        rtp.setblocking(False)
        app.control.on_sip_response(t, ms.channel, make_response(
            invite, 200, "OK", to_tag="vv",
            body=make_sdp("127.0.0.1", rtp.getsockname()[1])))
        check(ms.drive(160, cc.Connect) is not None,
              f"no Connect; got {ms.got}")
        ms.send_l3(rr.AssignmentComplete())
        for _ in range(6):
            ms.drive(50)
            if getattr(t, "voice", None) is not None:
                break
        check(getattr(t, "voice", None) is not None,
              "voice pump not attached")
        check(t.tch.l1.active and t.tch.tn == tch_tn, "TCH not open")
        setup_frames = len(rig.daemon_ms) - t0

        # the MS's TCH modem on the CPU: an encoder for the uplink, a
        # decoder for the downlink
        ms_tx = channels.TCHFACCHL1(tch_tn, tdma.FACCH_TCHF,
                                    tdma.FACCH_TCHF, tsc=ms.bcc,
                                    device="cpu")
        ms_rx = channels.TCHFACCHL1(tch_tn, tdma.FACCH_TCHF,
                                    tdma.FACCH_TCHF, tsc=ms.bcc,
                                    device="cpu")
        ms_tx.open(0)
        ms_rx.open(0)
        fn0 = daemon.fn + 6  # on an 8-burst interleaver boundary
        while (tdma.FACCH_TCHF.reverse(fn0) or 0) % 8 != 0 or \
                tdma.FACCH_TCHF.reverse(fn0) is None:
            fn0 += 1
        ms_tx.next_write_fn = fn0
        up = [rng.integers(0, 2, 260).astype(np.uint8)
              for _ in range(speech)]
        down = [rng.integers(0, 2, 260).astype(np.uint8)
                for _ in range(speech)]
        for fr in up:
            ms_tx.send_tch(fr)
        for _ in range(speech + 1):  # the speech, then a filler to flush
            ms_tx.dispatch_block()
        bursts = list(ms_tx.tx_queue)
        ms_tx.tx_queue.clear()
        bts_port = t.sip.rtp.local_port
        up_set = {fr.tobytes() for fr in up}
        down_set = {fr.tobytes() for fr in down}
        last_fn = bursts[-1].fn
        st = {"sent": 0, "bi": 0, "fn_tch": daemon.fn - 2, "frames": 0,
              "up_ok": 0}

        def speech_frame():
            """One frame of the call: the MS's uplink bursts due, one RTP
            frame every 4 frames (about the air's pace), both steps, the
            RTP the BTS sent, and the MS's TCH receiver."""
            while st["bi"] < len(bursts) and \
                    bursts[st["bi"]].fn <= daemon.fn + 6:
                b = bursts[st["bi"]]
                ms.tx_burst(b.bits, b.fn, tn=tch_tn)
                st["bi"] += 1
            if st["sent"] < speech and st["frames"] % 4 == 0:
                n = st["sent"]
                rtp.sendto(struct.pack("!BBHII", 0x80, 3, n, n * 160, 0x1234)
                           + payload_to_rtp(down[n]), ("127.0.0.1", bts_port))
                st["sent"] += 1
            st["frames"] += 1
            rig.pump()
            while True:
                try:
                    data, _ = rtp.recvfrom(2048)
                except BlockingIOError:
                    break
                u = rtp_to_payload(data[12:]) if len(data) >= 45 else None
                st["up_ok"] += u is not None and u.tobytes() in up_set
            while st["fn_tch"] < daemon.fn - 5:
                fn = st["fn_tch"]
                if tdma.FACCH_TCHF.reverse(fn) is not None:
                    soft = ms.rx_soft(fn, tn=tch_tn)
                    if soft is not None:
                        ms_rx.write_low_side(RxBurst(soft, fn=fn, tn=tch_tn))
                st["fn_tch"] += 1

        profiled = None
        for _ in range(40 * speech + 400):
            if profile is not None and profiled is None and \
                    st["sent"] >= speech // 2:
                profiled = profile(rig, speech_frame)
            else:
                speech_frame()
            up_ok = st["up_ok"]
            dn_ok = sum(d.tobytes() in down_set for d in ms_rx.speech_out)
            if daemon.fn > last_fn + 8 and up_ok >= speech and \
                    dn_ok >= speech:
                break
        # the JAX test lets 1 frame in 3 go (>= 2 of 3 each way)
        check(up_ok >= speech - 1, f"uplink speech: {up_ok} of {speech} "
                                   f"frames reached RTP bit-exact")
        check(dn_ok >= speech - 1, f"downlink speech: {dn_ok} of {speech} "
                                   f"frames decoded bit-exact by the MS")
        speech_frames = len(rig.daemon_ms) - t0 - setup_frames
        hold = facch_hold(rig, ms, ms_tx, ms_rx, tch_tn, t)
    finally:
        rtp.close()

    # the MS releases its SDCCH link over the air (DISC → reclaim),
    # answering the BTS's LAPDm there as it goes
    ms.l2.write_high_side(L3Frame(primitive=Primitive.RELEASE))
    ms.flush()
    check(ms.drive(300, until=lambda: app.bts.sdcch_available() == free),
          "SDCCH not reclaimed after the MS's DISC")
    return {"tch_tn": tch_tn, "speech_up": up_ok, "speech_down": dn_ok,
            "setup_frames": setup_frames, "speech_frames": speech_frames,
            "facch_frames": hold, "frames": len(rig.daemon_ms) - t0,
            "profile": profiled}


def facch_hold(rig: BtsRig, ms: SimMS, ms_tx, ms_rx, tch_tn: int, t) -> int:
    """In-call signalling on the FACCH (tests/test_e2e_lur.py's very-early
    call and its Hold): the MS establishes LAPDm on the TCH's FACCH and
    asks to hold the call; the BTS answers HoldReject, cause 0x3f, over
    the FACCH. Returns the frames it took."""
    from openbts_ttsou_tpu_torch.gsm.l3 import cc, parse_l3
    from openbts_ttsou_tpu_torch.gsm.lapdm import L2LAPDm, LAPDState
    from openbts_ttsou_tpu_torch.gsm.transfer import (ChannelType, L3Frame,
                                                      Primitive, RxBurst)
    from openbts_ttsou_tpu_torch.gsm import tdma

    daemon, n0 = rig.daemon, len(rig.daemon_ms)
    l2 = L2LAPDm(c=0, sapi=0, chan_type=ChannelType.FACCH)
    ms_rx.upstream = l2
    fn_scan = daemon.fn - 2
    got = []

    def drive(rounds, done):
        nonlocal fn_scan
        for _ in range(rounds):
            rig.pump()
            while fn_scan < daemon.fn - 5:
                if tdma.FACCH_TCHF.reverse(fn_scan) is not None:
                    soft = ms.rx_soft(fn_scan, tn=tch_tn)
                    if soft is not None:
                        ms_rx.write_low_side(RxBurst(soft, fn=fn_scan,
                                                     tn=tch_tn))
                fn_scan += 1
            outs = l2.take_l1_out()
            if outs:  # FACCH steals whole blocks on a fresh diagonal
                ms_tx.resync(daemon.fn, lead=5)
                for out in outs:
                    ms_tx.send_l2(out)
                while ms_tx._facch_q or (ms_tx._offset != 0
                                         and ms_tx.tx_queue):
                    ms_tx.dispatch_block()
                ms_tx.dispatch_block()  # the second half of the diagonal
            while ms_tx.tx_queue and ms_tx.tx_queue[0].fn <= daemon.fn + 30:
                b = ms_tx.tx_queue.popleft()
                if b.fn > daemon.fn - 2:
                    ms.tx_burst(b.bits, b.fn, tn=tch_tn)
            while (l3 := l2.read_high_side()) is not None:
                if len(l3.bits) >= 16 and (m := parse_l3(l3.bits)):
                    got.append(m)
            if done():
                return True
        return False

    l2.write_high_side(L3Frame(primitive=Primitive.ESTABLISH))
    check(drive(200, lambda: l2.state == LAPDState.LinkEstablished),
          "FACCH link not established")
    hold = cc.Hold()
    hold.ti = t.ti_value
    l2.write_high_side(L3Frame(hold.encode(), Primitive.DATA))
    check(drive(300, lambda: any(isinstance(m, cc.HoldReject)
                                 for m in got)),
          f"no HoldReject on the FACCH; got {got}")
    rej = next(m for m in got if isinstance(m, cc.HoldReject))
    check(rej.cause.value == 0x3F and rej.ti == (1 << 3) | t.ti_value,
          f"HoldReject cause {rej.cause.value:#x} ti {rej.ti:#x}")
    return len(rig.daemon_ms) - n0


def ota_mt_sms(rig: BtsRig) -> dict:
    """tests/test_e2e_lur.py::test_over_the_air_mt_sms: page on the PCH →
    RACH → SABM(Paging Response) → SAPI-3 link → SMS-DELIVER off the air
    → CP-ACK and CP-DATA(RP-ACK) → transaction closed, SDCCH released."""
    from openbts_ttsou_tpu_torch.control.common import ServiceType
    from openbts_ttsou_tpu_torch.gsm.l3 import rr
    from openbts_ttsou_tpu_torch.gsm.lapdm import LAPDState
    from openbts_ttsou_tpu_torch.sms import messages as sms_m

    app, daemon, t0 = rig.app, rig.daemon, len(rig.daemon_ms)
    ms = SimMS(rig)
    free = app.bts.sdcch_available()
    text = "wake up neo"
    app.control.initiate_mtsms(BTS_IMSI, "5552000", text)
    page = ms.ccch_message(daemon.fn, 240, 12, lambda m: isinstance(
        m, rr.PagingRequestType1) and any(
            i is not None and i.kind != 0 for i in (m.id1, m.id2)))
    check(page is not None, "no page decoded on the PCH")
    page_id = next(i for i in (page.id1, page.id2)
                   if i is not None and i.kind != 0)
    ms.access(0x29, rr.PagingResponse(page_id))
    deliver = None

    def delivered():
        nonlocal deliver
        while (l3 := ms.l2_sms.read_high_side()) is not None:
            if len(l3.bits) >= 16:
                cp = sms_m.parse_cp(np.packbits(l3.bits).tobytes())
                if isinstance(cp, sms_m.CPData):
                    rp = sms_m.parse_rp(cp.rpdu)
                    if isinstance(rp, sms_m.RPData):
                        deliver = sms_m.TLDeliver.parse(rp.tpdu)
        return deliver is not None

    check(ms.drive(240, until=delivered), "no SMS-DELIVER decoded on SAPI 3")
    check(deliver.text == text and deliver.orig == "5552000",
          f"SMS-DELIVER {deliver.orig}: {deliver.text!r}")
    check(ms.l2_sms.state == LAPDState.LinkEstablished, "SAPI-3 link down")
    for pdu in (sms_m.CPAck(ti=0).encode(),
                sms_m.CPData(ti=0, rpdu=sms_m.RPAck(
                    reference=1, mo=True).encode()).encode()):
        ms.send_l3(np.unpackbits(np.frombuffer(pdu, np.uint8)), ms.l2_sms)

    def closed():
        return app.control.transactions.find_by_imsi(
            BTS_IMSI, services=(ServiceType.MobileTerminatedSMS,)) is None \
            and app.bts.sdcch_available() == free

    check(ms.drive(700, until=closed),
          "MT-SMS transaction not closed / SDCCH not released")
    return {"text": deliver.text, "frames": len(rig.daemon_ms) - t0}


def ota_sms_via_smqueue(rig: BtsRig) -> dict:
    """tests/test_e2e_lur.py::test_over_the_air_sms_via_smqueue: the MS
    submits an SMS to its own number over the air (CM Service for SMS,
    a SAPI-3 link, CP-DATA in segmented I-frames → SIP MESSAGE); the
    port's smqueue queues it, rewrites the sender through the HLR and
    forwards it; the BTS takes the forwarded MESSAGE and pages the MS,
    which answers and decodes the SMS-DELIVER off the air."""
    from openbts_ttsou_tpu_torch.control.common import ServiceType
    from openbts_ttsou_tpu_torch.gsm.l3 import common as l3c
    from openbts_ttsou_tpu_torch.gsm.l3 import mm, rr
    from openbts_ttsou_tpu_torch.gsm.lapdm import LAPDState
    from openbts_ttsou_tpu_torch.gsm.transfer import FrameType
    from openbts_ttsou_tpu_torch.sip.message import SIPMessage
    from openbts_ttsou_tpu_torch.smqueue import SMq
    from openbts_ttsou_tpu_torch.sms import messages as sms_m

    app, daemon, t0 = rig.app, rig.daemon, len(rig.daemon_ms)
    wall0 = time.perf_counter()
    number, text = "5553000", "ping via smqueue"
    app.control.hlr.add_user(BTS_IMSI, number)  # a self-addressed loop
    ms = SimMS(rig)
    ms.access(0x21, mm.CMServiceRequest(
        service_type=4, identity=l3c.MobileIdentity.imsi(BTS_IMSI)))
    check(ms.drive(120, until=lambda: ms.l2.state ==
                   LAPDState.LinkEstablished), "MO-SMS link not up")
    ms.l2_sms._send_u(FrameType.SABM, True, ms.l2_sms.c)
    ms.l2_sms.state = LAPDState.AwaitingEstablish
    ms.flush()
    check(ms.drive(120, until=lambda: ms.l2_sms.state ==
                   LAPDState.LinkEstablished), "SAPI-3 link not up")
    tl = sms_m.TLSubmit(mr=1, dest=number, text=text)
    rp = sms_m.RPData(reference=2, dest="170", tpdu=tl.encode(), mo=True)
    cp = sms_m.CPData(ti=0, rpdu=rp.encode()).encode()
    ms.send_l3(np.unpackbits(np.frombuffer(cp, np.uint8)), ms.l2_sms)
    check(ms.drive(160, until=lambda: bool(rig.sip_out)),
          "no SIP MESSAGE out")
    mo_msg = SIPMessage.parse(rig.sip_out[-1])
    check(mo_msg.method == "MESSAGE" and mo_msg.body == text
          and mo_msg.uri_user("to") == number, f"MO MESSAGE {mo_msg.uri}")

    # smqueue: queue, sender rewrite, forward
    forwarded = []
    smq = SMq(send=lambda to, rendered: forwarded.append((to, rendered)),
              resolve=lambda u: u if u == number else None,
              hlr=app.control.hlr)
    check(smq.handle_sip_message(mo_msg).status == 200, "smqueue refused")
    now = time.monotonic()
    for k in range(8):
        smq.process_queue(now + k + 1)
        if forwarded:
            break
    check(bool(forwarded), "smqueue did not forward the MESSAGE")
    to_user, rendered = forwarded[0]
    mt_msg = SIPMessage.parse(rendered.encode())
    check(to_user == number and mt_msg.body == text
          and mt_msg.uri_user("from") == number,
          f"forwarded to {to_user} from {mt_msg.uri_user('from')}")

    # the BTS takes the forwarded MESSAGE and pages; the MS answers
    app._on_message(mt_msg)
    t = app.control.transactions.find_by_imsi(
        BTS_IMSI, services=(ServiceType.MobileTerminatedSMS,))
    check(t is not None and t.message == text, "no MT-SMS transaction")
    ms2 = SimMS(rig)
    page = ms2.ccch_message(daemon.fn, 240, 12, lambda m: isinstance(
        m, rr.PagingRequestType1) and any(
            i is not None and i.kind != 0 for i in (m.id1, m.id2)))
    check(page is not None, "no page for the forwarded SMS")
    page_id = next(i for i in (page.id1, page.id2)
                   if i is not None and i.kind != 0)
    ms2.access(0x2D, rr.PagingResponse(page_id))
    deliver = []

    def delivered():
        while (l3 := ms2.l2_sms.read_high_side()) is not None:
            if len(l3.bits) >= 16:
                cpm = sms_m.parse_cp(np.packbits(l3.bits).tobytes())
                if isinstance(cpm, sms_m.CPData):
                    rpm = sms_m.parse_rp(cpm.rpdu)
                    if isinstance(rpm, sms_m.RPData):
                        deliver.append(sms_m.TLDeliver.parse(rpm.tpdu))
        return bool(deliver)

    check(ms2.drive(240, until=delivered), "forwarded SMS not delivered")
    check(deliver[0].text == text and deliver[0].orig == number,
          f"SMS-DELIVER {deliver[0].orig}: {deliver[0].text!r}")
    return {"text": deliver[0].text, "orig": deliver[0].orig,
            "frames": len(rig.daemon_ms) - t0,
            "wall_s": time.perf_counter() - wall0}


#: the channels' FEC calls (gsm/channels.py), each timed around its call:
#: each ends in the `.cpu()` that brings its result back
FEC_CALLS = ("xcch_encode_bursts", "xcch_decode_block", "rach_decode_bits",
             "sch_encode_burst", "facch_encode", "tch_encode_block",
             "map_bursts", "facch_decode_frame", "tch_decode_frame")


def timed_fec_calls(times: dict):
    """Wrap the channels' FEC calls so each call on a CUDA device appends
    its wall time (ms) to times[name]; returns a function that undoes it."""
    from openbts_ttsou_tpu_torch.gsm import channels

    saved = {name: getattr(channels, name) for name in FEC_CALLS}

    def wrap(name, fn):
        def timed(*args):
            if args[-1].type != "cuda":  # the MS's codecs run on the CPU
                return fn(*args)
            t0 = time.perf_counter()
            out = fn(*args)
            times.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3)
            return out
        return timed

    for name, fn in saved.items():
        setattr(channels, name, wrap(name, fn))
    return lambda: [setattr(channels, n, f) for n, f in saved.items()]


def stats_ms(xs: list) -> dict:
    xs = sorted(xs)
    return {"n": len(xs), "median": statistics.median(xs),
            "p99": xs[min(len(xs) - 1, int(0.99 * len(xs)))],
            "max": xs[-1]}


def profile_call_frames(rig: BtsRig, frame) -> dict:
    """BTS_PROFILE_FRAMES frames of the call under torch.profiler: device
    busy time, device events and kernel launches a frame, against the
    BTS's unprofiled step time (daemon + app) over as many frames just
    before."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = BTS_PROFILE_FRAMES
    wall_ms = sum(rig.daemon_ms[-n:]) + sum(rig.app_ms[-n:])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            frame()
        torch.cuda.synchronize()
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC"))
    check(busy_ms > 0, "bts: the profiler saw no device time")
    top = sorted(dev, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    return {"frames": n, "device_busy_ms": busy_ms,
            "bts_step_ms_unprofiled": wall_ms,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "device_events_per_frame": sum(e.count for e in dev) / n,
            "launches_per_frame": launches / n,
            "top": [{"name": e.key[:70], "count": e.count,
                     "ms": e.self_device_time_total / 1e3} for e in top]}


def phase_bts() -> dict:
    """The BTS over the air at full C0 width on the card (module
    docstring, phase 13), then the location update again with daemon and
    app on the CPU: the same downlink bursts and L3 messages by FN."""
    from openbts_ttsou_tpu_torch.ops import cuda_fir

    fec_ms: dict = {}
    rig = BtsRig("cuda", BTS_PORT)
    undo = timed_fec_calls(fec_ms)
    cuda_fir.polyphase_resample_cuda.launches = 0
    t0 = time.perf_counter()
    try:
        rig.record()
        lur = ota_location_update(rig)
        card = (rig.bursts, rig.l3)
        rig.bursts = rig.l3 = None
        rig.reclaim()
        call = ota_voice_call(rig, BTS_SPEECH, profile=profile_call_frames)
        rig.reclaim()
        sms = ota_mt_sms(rig)
        rig.reclaim()
        smq = ota_sms_via_smqueue(rig)
    finally:
        undo()
        rig.close()
    session_s = time.perf_counter() - t0
    launches = {"polyphase_resample":
                cuda_fir.polyphase_resample_cuda.launches}
    check(launches["polyphase_resample"] == 0,
          f"bts: K1 launched {launches} on the symbol-rate path")
    frames = len(rig.daemon_ms)

    cpu = BtsRig("cpu", BTS_PORT + 10)
    try:
        cpu.record()
        lur_cpu = ota_location_update(cpu)
    finally:
        cpu.close()
    check(lur_cpu["tmsi"] == lur["tmsi"], "bts card vs CPU: TMSI")
    check(cpu.bursts == card[0],
          f"bts card vs CPU: {len(card[0])} and {len(cpu.bursts)} downlink "
          f"bursts differ")
    check(cpu.l3 == card[1], "bts card vs CPU: the L3 messages differ")
    out = {"phase": "bts", "config": "examples/openbts_tpu.config + "
                                     "GSM.NumC7s 1, GSM.NumTCH 6",
           "frames": frames, "session_s": session_s,
           "air_ms_per_frame": 60 / 13,
           "daemon_step_ms": stats_ms(rig.daemon_ms),
           "app_step_ms": stats_ms(rig.app_ms),
           "location_update": lur, "call": call, "mt_sms": sms,
           "sms_via_smqueue": smq,
           "fec_call_ms": {k: stats_ms(v) for k, v in fec_ms.items()},
           "card_vs_cpu": {"downlink_bursts": len(card[0]),
                           "l3_messages": len(card[1])},
           "launches": launches}
    record(out)
    return out


def phase_bts_entry_point() -> dict:
    """`BTSApp(spawn_transceiver=True)` on the card: it starts `python -m
    openbts_ttsou_tpu_torch.trx.daemon --device cuda` as a child; bring-up
    over the control sockets within a deadline; clock indications; the
    app steps two 51-multiframes of beacon traffic; shutdown reaps the
    child."""
    from openbts_ttsou_tpu_torch.apps.openbts import BTSApp

    t0 = time.perf_counter()
    app = BTSApp(bts_config(), trx_base_port=BTS_SPAWN_PORT,
                 spawn_transceiver=True, device="cuda")
    child = app.trx_child
    try:
        check(child is not None and "--device" in child.args and
              child.args[child.args.index("--device") + 1] == "cuda",
              f"spawned {child and child.args}")
        clocks = []
        handle = app.trx.handle_clock

        def counted(data):
            clocks.append(time.perf_counter())
            handle(data)

        app.trx.handle_clock = counted
        app.trx.start()
        # the child imports torch and reaches the card first
        while app.trx.arfcn(0).send_command("POWEROFF", retries=1) is None:
            check(child.poll() is None, "the daemon child exited")
            check(time.perf_counter() - t0 < 120,
                  "the daemon child did not answer in 120 s")
        answered_s = time.perf_counter() - t0
        check(app.bringup(), "bring-up failed")
        up_s = time.perf_counter() - t0
        n0 = len(clocks)
        fn0 = app._beacon_fn
        steps = 0
        while app._beacon_fn - fn0 < 102 or len(clocks) <= n0:
            check(child.poll() is None, "the daemon child exited")
            check(time.perf_counter() - t0 < 240, "the app stalled")
            app.step()
            steps += 1
            time.sleep(0.002)
        beacon = app._beacon_fn - fn0
    finally:
        app.shutdown()
    check(child.poll() is not None, "shutdown did not reap the child")
    out = {"phase": "bts_entry_point",
           "entry_point": " ".join(child.args[1:]),
           "answered_after_s": answered_s, "bringup_after_s": up_s,
           "clock_indications": len(clocks),
           "app_steps": steps, "beacon_frames": beacon,
           "session_s": time.perf_counter() - t0,
           "child_returncode": child.returncode}
    record(out)
    return out


# ---- phases 15-17: the sharded pipelines and the distributed runtime -------

SHARDS = 4  # phase 15's mesh: (chan 2, time 2), all on cuda:0
SHARD_FRAMES = 13
SHARD_STEPS = {"uplink": 3, "duplex": 3, "decoded": 2}
SHARD_SMALL_CHAN = 8  # phase 16: card against CPU


def sharded_stream(steps: int) -> torch.Tensor:
    """The uplink main path's stream (the bench recipe) over `steps`
    steps of the (2, 2) mesh at the device rate, on the card."""
    return to_device_rate(bench_symbols(N_CHAN, steps * 2 * SHARD_FRAMES))


def compare_rx(got, want, frames: slice, what: str) -> None:
    """Detections, RACH flags, RSSI and timing exactly, soft bits within
    5e-3, on the given frames."""
    for name in ("detected", "is_rach", "rssi", "timing"):
        check(torch.equal(getattr(got, name)[frames],
                          getattr(want, name)[frames]),
              f"{what}: {name} differs from the serial chain")
    err = float((got.soft_bits[frames] - want.soft_bits[frames]).abs().max())
    check(err <= 5e-3, f"{what}: soft bits differ by {err}")


def decode_by_shards(res, fn0: int, mesh_shape: dict, frames: int,
                     prev_soft, prev_valid, **kw):
    """Phase 15's reference for a decoded step: `decode_block` on each
    shard's carriers and frames of the step's RxResult (the shapes the
    step decodes), time shard t's prelude the DECODE_PRELUDE frames
    before its own (time shard 0's the previous step's tail,
    `prev_soft`), joined over carriers and time as the step joins
    them."""
    from openbts_ttsou_tpu_torch.models.transceiver import (
        DECODE_PRELUDE, DecodedBlocks, decode_block)

    c_local = res.soft_bits.shape[1] // mesh_shape["chan"]
    per_time = ("first_fn", "tch_end_fn", "tch_valid")
    rows = []
    for c in range(mesh_shape["chan"]):
        cs = slice(c * c_local, (c + 1) * c_local)
        decs = []
        for t in range(mesh_shape["time"]):
            lo = t * frames
            part = type(res)(*(x[lo: lo + frames, cs] for x in res))
            decs.append(decode_block(
                part, fn0 + lo, frames,
                prev_soft=(prev_soft[0][:, cs] if t == 0 else
                           res.soft_bits[lo - DECODE_PRELUDE: lo, cs]),
                prev_valid=(prev_valid if t == 0 else
                            torch.ones((), dtype=torch.bool,
                                       device=res.soft_bits.device)),
                **kw))
        rows.append([torch.cat([d[i].reshape(-1) if name in per_time
                                else d[i] for d in decs])
                     for i, name in enumerate(DecodedBlocks._fields)])
    return DecodedBlocks(*(
        rows[0][i] if name in per_time else torch.cat([r[i] for r in rows], 1)
        for i, name in enumerate(DecodedBlocks._fields)))


def phase_sharded() -> dict:
    """Phase 15: the sharded steps on the card at 512 carriers, held on
    interior frames against the serial chain over the same 26-frame
    windows (`uplink_block` for the rx, `downlink_block` for the tx,
    which must be bit-identical); the decoded steps' DecodedBlocks held
    exactly against `decode_by_shards` on their own soft bits. K1's
    launch shapes must be ones phase 2 held against the plain form."""
    from openbts_ttsou_tpu_torch.models.transceiver import (
        DECODE_PRELUDE, UplinkSpec, downlink_block, uplink_block)
    from openbts_ttsou_tpu_torch.ops import cuda_fir, fir
    from openbts_ttsou_tpu_torch.parallel import make_mesh
    from openbts_ttsou_tpu_torch.parallel.sharded import (
        ShardedPipelineSpec, sharded_duplex_pipeline,
        sharded_uplink_pipeline, state_for_shards)
    from openbts_ttsou_tpu_torch.tools.kernel_bakeoff import K1_SHAPES
    from openbts_ttsou_tpu_torch.trx.engine import TrxConfig

    mesh = make_mesh(SHARDS, "cuda")
    check(mesh.shape == {"chan": 2, "time": 2}
          and all(s.device == torch.device("cuda", 0) for s in mesh.shards),
          f"mesh {mesh.shape} on {[str(s.device) for s in mesh.shards]}")
    n_time = mesh.shape["time"]
    cfg = TrxConfig(n_chan=N_CHAN)
    spec = ShardedPipelineSpec(n_chan_total=N_CHAN,
                               frames_per_shard=SHARD_FRAMES)
    wspec = UplinkSpec(frames=n_time * SHARD_FRAMES)  # the serial window
    steps = max(SHARD_STEPS.values())
    dev = sharded_stream(steps)
    block = n_time * spec.block_in
    windows = [dev[:, k * block: (k + 1) * block].contiguous()
               for k in range(steps)]
    rng = np.random.default_rng(15)
    dl = []
    for _ in range(SHARD_STEPS["duplex"]):
        bits = rng.integers(0, 2, (wspec.frames, N_CHAN, 8, 148),
                            dtype=np.uint8)
        valid = np.zeros((wspec.frames, N_CHAN, 8), bool)
        valid[:, :, 1] = True
        dl.append(tuple(torch.from_numpy(a).cuda() for a in (
            bits, valid, np.zeros(valid.shape, np.float32))))
    state0 = new_transceiver(cfg, UplinkSpec()).state

    # the serial chain over the same windows, its state carried
    serial_rx, serial_tx, serial_thr = [], [], []
    st = state0
    for k in range(steps):
        st, res = uplink_block(cfg, wspec, st, windows[k])
        serial_rx.append(res)
        serial_thr.append(st.energy_threshold.clone())
    for k in range(SHARD_STEPS["duplex"]):
        serial_tx.append(downlink_block(cfg, wspec, state0, *dl[k]))
    up = sharded_uplink_pipeline(mesh, cfg, spec)
    duplex = sharded_duplex_pipeline(mesh, cfg, spec)
    decoded = sharded_uplink_pipeline(mesh, cfg, spec, mode="decoded",
                                      xcch_tns=(0, 1, 6, 7),
                                      tch_tns=(2, 3, 4, 5))
    up(state_for_shards(state0, n_time), windows[0], 0)  # warm
    torch.cuda.synchronize()

    # the sharded steps: K1's launches counted over them alone, and the
    # shapes of the CUDA tensors resampled (each one K1 launch) recorded
    traffic, step_ms = {}, {k: [] for k in SHARD_STEPS}
    outs = {k: [] for k in SHARD_STEPS}
    resample = fir.polyphase_resample
    k1_shapes = collections.Counter()

    def resample_seen(x, p, q, lpf):
        if x.is_cuda:
            k1_shapes[(*x.shape, p, q)] += 1
        return resample(x, p, q, lpf)

    fir.polyphase_resample = resample_seen
    try:
        cuda_fir.polyphase_resample_cuda.launches = 0
        st_sh = state_for_shards(state0, n_time)
        for k in range(SHARD_STEPS["uplink"]):
            mesh.reset_traffic()
            t0 = time.perf_counter()
            st_sh, res, clock = up(st_sh, windows[k], k * wspec.frames)
            torch.cuda.synchronize()
            step_ms["uplink"].append((time.perf_counter() - t0) * 1e3)
            traffic["uplink"] = {k: list(v) for k, v in mesh.traffic.items()}
            outs["uplink"].append((res, st_sh.energy_threshold.clone(),
                                   int(clock)))
        st_sh = state_for_shards(state0, n_time)
        for k in range(SHARD_STEPS["duplex"]):
            mesh.reset_traffic()
            t0 = time.perf_counter()
            st_sh, res, tx, clock = duplex(st_sh, windows[k], *dl[k],
                                           k * wspec.frames)
            torch.cuda.synchronize()
            step_ms["duplex"].append((time.perf_counter() - t0) * 1e3)
            traffic["duplex"] = {k: list(v) for k, v in mesh.traffic.items()}
            outs["duplex"].append((res, tx))
        st_sh = state_for_shards(state0, n_time)
        prev = torch.zeros((1, DECODE_PRELUDE, N_CHAN, 8, 148), device="cuda")
        pvalid = torch.zeros((), dtype=torch.bool, device="cuda")
        for k in range(SHARD_STEPS["decoded"]):
            t0 = time.perf_counter()
            st_sh, res, _, dec = decoded(st_sh, windows[k], k * wspec.frames,
                                         prev, pvalid)
            torch.cuda.synchronize()
            step_ms["decoded"].append((time.perf_counter() - t0) * 1e3)
            outs["decoded"].append((res, dec, prev, pvalid))
            prev = res.soft_bits[-DECODE_PRELUDE:][None]
            pvalid = torch.ones((), dtype=torch.bool, device="cuda")
    finally:
        fir.polyphase_resample = resample
    launches = {"polyphase_resample":
                cuda_fir.polyphase_resample_cuda.launches}
    held = {(rows, t_in, p, q) for rows, p, q, _, t_in in K1_SHAPES}
    check(set(k1_shapes) <= held
          and sum(k1_shapes.values()) == launches["polyphase_resample"],
          f"sharded: K1 launched at {sorted(k1_shapes)} "
          f"({launches} launches), not all held against the plain form "
          f"in phase 2")
    want_k1 = SHARDS * (SHARD_STEPS["uplink"] + 2 * SHARD_STEPS["duplex"]
                        + SHARD_STEPS["decoded"])
    check(launches["polyphase_resample"] == want_k1,
          f"sharded: K1 launched {launches} times, expected {want_k1}")

    interior = slice(1, wspec.frames - 1)
    exact_all = True
    for k, (res, thr, clock) in enumerate(outs["uplink"]):
        compare_rx(res, serial_rx[k], interior, f"sharded uplink step {k}")
        exact_all &= all(torch.equal(getattr(res, n), getattr(serial_rx[k], n))
                         for n in ("detected", "rssi", "timing"))
        check(torch.equal(thr[0], serial_thr[k]) and torch.equal(thr[0],
                                                                 thr[1]),
              f"sharded uplink step {k}: threshold {thr.unique().tolist()}")
        check(clock == block, f"sharded uplink step {k}: clock {clock}")
        check(int(res.detected.sum()) == N_CHAN * wspec.frames
              and bool(res.detected[:, :, 1].all()),
              f"sharded uplink step {k}: detections")
    tx_identical = True
    for k, (res, tx) in enumerate(outs["duplex"]):
        compare_rx(res, serial_rx[k], interior, f"sharded duplex step {k}")
        tx_identical &= torch.equal(tx, serial_tx[k])
        err = float((tx - serial_tx[k]).abs().max())
        check(tx_identical, f"sharded duplex step {k}: tx differs from "
                            f"the serial downlink by up to {err}")
    n_g = (DECODE_PRELUDE + SHARD_FRAMES) // 4
    for k, (res, dec, prev_k, pvalid_k) in enumerate(outs["decoded"]):
        compare_rx(res, serial_rx[k], interior, f"sharded decoded step {k}")
        check(dec.bits.shape == (n_time * n_g, N_CHAN, 8, 184)
              and dec.tch_speech.shape[1:] == (N_CHAN, 8, 260)
              and dec.first_fn.shape == (n_time,),
              f"sharded decoded step {k}: shapes")
        want = decode_by_shards(res, k * wspec.frames, mesh.shape,
                                SHARD_FRAMES, prev_k, pvalid_k,
                                xcch_tns=(0, 1, 6, 7),
                                tch_tns=(2, 3, 4, 5),
                                rach_tns=cfg.rach_slots)
        for name, a, b in zip(dec._fields, dec, want):
            check(torch.equal(a, b), f"sharded decoded step {k}: {name} "
                                     f"differs from decode_by_shards")
    want_cp = 2 * (N_CHAN // 2) * spec.halo_in * 8
    check(traffic["uplink"]["permute"] == [2, want_cp],
          f"sharded: halo traffic {traffic['uplink']}")
    check(traffic["duplex"]["permute"][1]
          == want_cp + 2 * (N_CHAN // 2) * 65 * 8,
          f"sharded: duplex halo traffic {traffic['duplex']}")

    ms_step = statistics.median(step_ms["uplink"])
    prof = device_profile(lambda: up(st_sh, windows[0], 0), ms_step)
    out = {"phase": "sharded", "carriers": N_CHAN, "mesh": mesh.shape,
           "k1_shapes": {str(list(k)): n for k, n in k1_shapes.items()},
           "shard_devices": [str(s.device) for s in mesh.shards],
           "frames_per_shard": SHARD_FRAMES, "steps": SHARD_STEPS,
           "ms_per_step": step_ms,
           "msamples_per_s_uplink": N_CHAN * block / ms_step / 1e3,
           "launches": launches, "traffic_bytes_per_step": traffic,
           "rx_equal_serial_on_all_frames": exact_all,
           "tx_bit_identical": tx_identical, "profile": prof,
           "card": torch.cuda.get_device_name(0)}
    record(out)
    return out


def phase_sharded_card_vs_cpu() -> dict:
    """Phase 16: the (2, 2) mesh at 8 carriers on the card and on the CPU
    over 2 steps of the adversarial streams (RACH, energy without a
    burst, DFE carriers): detections and integer state equal."""
    from openbts_ttsou_tpu_torch.ops import fir
    from openbts_ttsou_tpu_torch.parallel import make_mesh
    from openbts_ttsou_tpu_torch.parallel.sharded import (
        ShardedPipelineSpec, sharded_uplink_pipeline, state_for_shards)
    from openbts_ttsou_tpu_torch.trx.engine import TrxConfig

    c, n_time = SHARD_SMALL_CHAN, 2
    cfg = TrxConfig(n_chan=c, max_toa=8)
    spec = ShardedPipelineSpec(n_chan_total=c, frames_per_shard=SHARD_FRAMES)
    streams = adversarial_streams(np.random.default_rng(16), c,
                                  n_time * SHARD_FRAMES, 2)
    lpf = fir.resampler_lpf(96, 65, 651)
    run = {}
    for dev in ("cuda", "cpu"):
        mesh = make_mesh(SHARDS, dev)
        step = sharded_uplink_pipeline(mesh, cfg, spec)
        st4 = adversarial_state(TrxConfig(n_chan=4), dev)
        st = st4._replace(**{
            name: torch.cat([x, x]) for name, x in st4._asdict().items()
            if name not in ("fn",)})
        st_sh = state_for_shards(st, n_time)
        run[dev] = []
        for k, sym in enumerate(streams):
            x = fir.polyphase_resample(torch.from_numpy(sym), 96, 65, lpf)
            st_sh, res, _ = step(st_sh, x.to(dev), k * n_time * SHARD_FRAMES)
            run[dev].append((st_sh, res))
    n_det = n_rach = 0
    for k, ((sg, g), (sh, h)) in enumerate(zip(run["cuda"], run["cpu"])):
        for name in ("detected", "is_rach", "rssi", "timing"):
            check(torch.equal(getattr(g, name).cpu(), getattr(h, name)),
                  f"sharded step {k}: {name} differs between card and CPU")
        check_states(sg, sh, f"sharded step {k}")
        n_det += int(h.detected.sum())
        n_rach += int(h.is_rach.sum())
    check(n_det > 0 and n_rach > 0, "phase 16 left detection or RACH "
                                    "unexercised")
    out = {"phase": "sharded_card_vs_cpu", "carriers": c, "steps": 2,
           "mesh": {"chan": 2, "time": 2}, "detections": n_det,
           "rach_detections": n_rach}
    record(out)
    return out


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_module(args: list):
    """`python -m <args>` from the repo's root, started."""
    return (subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True), time.perf_counter())


def finish_module(started, what: str, timeout: float = 300) -> dict:
    """Wait for a `start_module` process (killed past `timeout`); its last
    stdout line is its JSON result, which must say ok."""
    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"{what} ran past {timeout} s")
    lines = out.strip().splitlines()
    check(proc.returncode == 0 and lines,
          f"{what} exited {proc.returncode}: {err[-2000:]}")
    res = json.loads(lines[-1])
    check(res.get("ok") is True, f"{what}: {res}")
    res["process_s"] = time.perf_counter() - t0
    return res


def phase_distributed() -> dict:
    """Phase 17: the distributed runtime on the card, two processes at
    once: one worker rank at world size 1 over NCCL (two time shards on
    cuda:0, the duplex step checked against the serial chain, the
    mismatches summed by an NCCL all-reduce) and the dry run at 4 shards
    on the card. With one rank the mesh's collectives stay in the
    process, so NCCL covers the group's start and that one all-reduce;
    its send/recv and all-gather between ranks need two cards."""
    worker = start_module(
        ["openbts_ttsou_tpu_torch.parallel.worker", "--world-size", "1",
         "--rank", "0", "--init-method", f"tcp://127.0.0.1:{free_port()}",
         "--shards-per-rank", "2", "--duplex", "--device", "cuda",
         "--timeout", "120"])
    dry = start_module(["openbts_ttsou_tpu_torch.parallel.dryrun",
                        "--shards", "4"])
    try:
        worker = finish_module(worker, "parallel.worker")
    finally:
        dry = finish_module(dry, "parallel.dryrun")
    check(worker["backend"] == "nccl" and worker["mismatches_all_ranks"] == 0,
          f"worker: {worker}")
    check(dry["device"].startswith("cuda"), f"dryrun ran on {dry['device']}")
    out = {"phase": "distributed", "worker": worker, "dryrun": dry}
    record(out)
    return out


# ---- phase 18: the tools ----------------------------------------------------

TOOLS_PORT = DAEMON_PORT + 1000  # the in-process soaks (a 128-carrier one
# binds 774 ports from here)
TOOLS_SOAK_PROC_PORT = DAEMON_PORT + 2000  # the soak run as a process
TOOLS_TRX_PORT = DAEMON_PORT + 2100  # the daemon trx_ping pings
TOOLS_WIDE_PORT = 24000  # the 512-carrier soak binds 3,076 UDP ports from
# here, below Linux's ephemeral range
SOAK_BF, SOAK_WARMUP, SOAK_BLOCKS = 26, 6, 10
SOAK_ROWS = (1, 8, 128)  # replay rows; the first runs as a process
SOAK_WIDE, SOAK_WIDE_BLOCKS = 512, 4  # the row past FD_SETSIZE
INVENTORY_SHARDS, INVENTORY_CHAN = 8, 1024  # (4, 2) shards of phase 15's
# 256 carriers a chan shard
SCALING_ARGS = ["--carriers", "96", "--shards", "2", "--steps", "4",
                "--duplex", "1"]  # the JAX tool's defaults
# K1's shapes in the scaling workers (processes, so not recorded): a
# shard's duplex step at 96 carriers, the worker's serial chain over 4
# steps of 26 frames and its serial downlink of a step
SCALING_K1_SHAPES = {(96, 24192, 65, 96, 961), (96, 16380, 96, 65, 651),
                     (96, 192000, 65, 96, 961), (96, 32500, 96, 65, 651)}
# (rows, p, q, taps, T) of the 128-carrier soak's K1 calls, timed
K1_SOAK_SHAPES = ((128, 65, 96, 961, 48192), (128, 96, 65, 651, 32630))


def soak_args(carriers: int, base: int, bus: str = "replay",
              ul_slots: int = 7, blocks: int = SOAK_BLOCKS) -> list:
    return ["--device", "cuda", "--carriers", str(carriers),
            "--block-frames", str(SOAK_BF), "--depth", "2",
            "--warmup", str(SOAK_WARMUP), "--blocks", str(blocks),
            "--ul-slots", str(ul_slots), "--bus", bus,
            "--base-port", str(base), "--timeout", "300"]


def check_soak(r: dict, what: str) -> None:
    """A soak row's record: the uplink flowed, K1 ran twice a block, and
    a replay row's timed window neither dumped nor underran nor lost an
    uplink datagram (every frame of its blocks brought one a loaded slot
    a carrier)."""
    blocks = r["blocks_timed"]
    need = SOAK_BF * r["carriers"] * r["ul_slots"] * (
        blocks - 2 if r["bus"] == "replay" else blocks // 2)
    check(r["uplink_datagrams"] >= need,
          f"{what}: {r['uplink_datagrams']} uplink datagrams < {need}")
    check(r["k1_launches"] == 2 * r["blocks_run"],
          f"{what}: K1 launched {r['k1_launches']} times in "
          f"{r['blocks_run']} blocks")
    if r["bus"] == "replay":
        check(r["stale_dumped"] == 0 and r["underruns"] == 0,
              f"{what}: {r['stale_dumped']} stale, {r['underruns']} "
              f"underruns in the timed window")
        check(r["uplink_lost_timed"] == 0
              and r["uplink_timed"] == r["expected_uplink_timed"],
              f"{what}: {r['uplink_timed']} uplink datagrams in the timed "
              f"window, {r['expected_uplink_timed']} expected")
    check(r["realtime"] == (r["ms_per_frame"] < r["air_ms_per_frame"]
                            and r["stale_dumped"] == r["underruns"] == 0),
          f"{what}: realtime flag")
    check_card_fields(r, what)


def run_tool(out: dict, name: str, tool, argv: list) -> dict:
    """tool.main(argv), its seconds added to out["seconds"][name]."""
    t0 = time.perf_counter()
    rec = tool.main(argv)
    out["seconds"][name] = (out["seconds"].get(name, 0.0)
                            + time.perf_counter() - t0)
    return rec


def check_card_fields(r: dict, what: str) -> None:
    check(r.get("device") == torch.cuda.get_device_name(0)
          and bool(r.get("card")), f"{what}: card fields {r.get('card')}")


def phase_tools(sharded_traffic: dict) -> dict:
    """Phase 18: the port's tools (`openbts_ttsou_tpu_torch/tools/`) on
    the card, each through its `main([...])`, the 1-carrier soak as `python
    -m`: the wire soak at 1, 8 and 128 carriers (replay bus, 26-frame
    blocks, depth 2, full load; 10 timed blocks after 6 warm-up blocks,
    which cover the daemon's clock lead growing from 20 to 26 frames), at
    512 (4 timed blocks, past descriptor 1024) and at 8 over the socket
    bus, the K1 probe, both exact schedules at 128, 256 and 512 carriers,
    the per-stage benches at 512, the mesh at 1, 2 and 4 shards of 64
    carriers, the roofline, the collective inventory (held to phase 15's
    `sharded_traffic`, {kind: [count, bytes]} a step), two worker
    processes against one, an IQ capture recorded and replayed, a
    control-plane ping of `python -m openbts_ttsou_tpu_torch.trx.daemon`
    and the transfer probe. K1's launches are counted from zero over the
    soaks and over the other tools apart (the probe's comparison
    launches left out), K1 is held against its plain form at every
    shape they launched it at (and at the scaling workers' shapes), and
    timed at the 128-carrier soak's two shapes."""
    from openbts_ttsou_tpu_torch.ops import cuda_fir, fir
    from openbts_ttsou_tpu_torch.tools import (iq_tool, kernel_probe,
                                               transfer_probe, trx_ping)

    out = {"phase": "tools", "seconds": {}}
    work = ROOT / "build" / "tools"
    work.mkdir(parents=True, exist_ok=True)
    daemon_log = open(work / "phase18_trx_daemon.log", "w")
    daemon = subprocess.Popen(
        [sys.executable, "-m", "openbts_ttsou_tpu_torch.trx.daemon",
         "--device", "cuda", "--base-port", str(TOOLS_TRX_PORT)], cwd=ROOT,
        stdout=daemon_log, stderr=subprocess.STDOUT)
    try:
        out["transfer_probe"] = run_tool(out, "transfer_probe",
                                         transfer_probe, [])
        check_card_fields(out["transfer_probe"], "transfer_probe")
        probe = run_tool(out, "kernel_probe", kernel_probe, [])
        check(probe["ok"], f"kernel_probe: {probe['rows']}")
        out["kernel_probe"] = probe
        capture = str(work / "phase18_capture.npz")
        run_tool(out, "iq_tool", iq_tool,
                 ["record", "--device", "cuda", "--out", capture,
                  "--chans", "4", "--frames", "26"])
        rep = run_tool(out, "iq_tool", iq_tool,
                       ["replay", capture, "--device", "cuda"])
        check(rep["hits"] == rep["planted"] > 0,
              f"iq_tool: {rep['hits']} of {rep['planted']} bursts detected")
        out["iq_tool"] = rep
        # the daemon needs ~9 s to answer (torch import, the card)
        end = time.perf_counter() + 120
        ping_args = ["--device", "cuda", "--base-port", str(TOOLS_TRX_PORT),
                     "--local-port", str(TOOLS_TRX_PORT + 101),
                     "--timeout-ms", "500"]
        while True:
            check(daemon.poll() is None, "the trx daemon exited: " + (
                work / "phase18_trx_daemon.log").read_text()[-2000:])
            ping = run_tool(out, "trx_ping", trx_ping, ping_args)
            if ping["answered"] == len(trx_ping.VERBS):
                break
            check(time.perf_counter() < end, f"trx_ping: {ping}")
        check(all(v["kind"] == "RSP" and v["verb"] == verb
                  and v["args"][0] == "0"
                  for verb, v in ping["verbs"].items()), f"trx_ping: {ping}")
        out["trx_ping"] = ping
    finally:
        daemon.terminate()
        try:
            daemon.wait(timeout=20)
        except subprocess.TimeoutExpired:
            daemon.kill()
            daemon.wait()
        daemon_log.close()

    # K1's launch shapes on the soaks and the tools, held against the
    # plain form at the end of the phase
    resample = fir.polyphase_resample
    k1_shapes = collections.Counter()

    def resample_seen(x, p, q, lpf):
        if x.is_cuda:
            k1_shapes[(x.numel() // x.shape[-1], x.shape[-1], p, q,
                       len(lpf))] += 1
        return resample(x, p, q, lpf)

    fir.polyphase_resample = resample_seen
    try:
        soak_k1 = tools_soaks(out)
        soak_shapes = set(k1_shapes)
        tools_k1 = tools_probes(out, sharded_traffic)
    finally:
        fir.polyphase_resample = resample
    # the soak process's launches: 1 carrier at the in-process soaks'
    # lengths
    shapes = set(k1_shapes) | {(1, t, p, q, taps) for _, t, p, q, taps
                               in soak_shapes} | SCALING_K1_SHAPES
    out["k1_checked"] = check_k1_shapes(shapes)
    # K1 timed at the 128-carrier soak's two shapes
    from openbts_ttsou_tpu_torch.tools.kernel_bakeoff import bake

    gen = torch.Generator(device="cuda").manual_seed(18)
    out["k1_soak_timed"] = [bake(*s, gen) for s in K1_SOAK_SHAPES]
    for r in out["k1_soak_timed"]:
        check(r["shape_ok"] and r["finite"]
              and r["max_abs_err"] <= 2e-4 * r["max_abs_plain"],
              f"K1 {r['geometry']}: max|kernel - plain| {r['max_abs_err']}")
    out["launches"] = {"polyphase_resample": soak_k1}
    out["tools_launches"] = {"polyphase_resample": tools_k1}
    record(out)
    return out


def check_k1_shapes(shapes) -> dict:
    """K1 against its plain form at each (rows, T, p, q, taps) given, on
    random input, to 2e-4 of the output's scale (phase 2's bound)."""
    from openbts_ttsou_tpu_torch.ops import cuda_fir, fir

    gen = torch.Generator(device="cuda").manual_seed(18)
    errs = {}
    for rows, t_in, p, q, taps in sorted(shapes):
        x = torch.randn((rows, t_in), dtype=torch.complex64, device="cuda",
                        generator=gen)
        lpf = fir.resampler_lpf(p, q, taps)
        got = cuda_fir.polyphase_resample_cuda(x, p, q, lpf)
        want = cuda_fir.polyphase_resample_plain(x, p, q, lpf)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        check(got.shape == want.shape and err <= 2e-4 * scale,
              f"K1 {p}/{q} [{rows}, {t_in}]: max|kernel - plain| {err} "
              f"against {scale}")
        errs[str([rows, t_in, p, q, taps])] = err
    return errs


def tools_soaks(out: dict) -> int:
    """Phase 18's soaks; K1's launches over them, counted from zero."""
    from openbts_ttsou_tpu_torch.ops import cuda_fir
    from openbts_ttsou_tpu_torch.tools import daemon_soak

    cuda_fir.polyphase_resample_cuda.launches = 0
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "openbts_ttsou_tpu_torch.tools.daemon_soak",
         *soak_args(SOAK_ROWS[0], TOOLS_SOAK_PROC_PORT)], cwd=ROOT,
        capture_output=True, text=True, timeout=400)
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0 and bool(lines),
          f"daemon_soak process exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    rows = [{**json.loads(lines[-1]), "process_s": time.perf_counter() - t0}]
    out["seconds"]["daemon_soak_process"] = rows[0]["process_s"]
    for n in SOAK_ROWS[1:]:
        rows.append(run_tool(out, f"daemon_soak_{n}", daemon_soak,
                             soak_args(n, TOOLS_PORT)))
    wide = run_tool(out, f"daemon_soak_{SOAK_WIDE}", daemon_soak,
                    soak_args(SOAK_WIDE, TOOLS_WIDE_PORT,
                              blocks=SOAK_WIDE_BLOCKS))
    check(wide["largest_fd"] > 1024, f"soak {SOAK_WIDE} carriers: largest "
                                     f"descriptor {wide['largest_fd']}, "
                                     f"not past FD_SETSIZE")
    rows.append(wide)
    rows.append(run_tool(out, "daemon_soak_socket_8", daemon_soak,
                         soak_args(8, TOOLS_PORT, "socket", 3)))
    for r in rows:
        check_soak(r, f"soak {r['carriers']} carriers {r['bus']}")
    # each in-process row also resampled its uplink bank once (stimulus)
    soak_k1 = sum(r["k1_launches"] for r in rows)
    check(cuda_fir.polyphase_resample_cuda.launches
          == soak_k1 - rows[0]["k1_launches"] + len(rows) - 1,
          f"soak: K1 launched {cuda_fir.polyphase_resample_cuda.launches} "
          f"times in-process")
    out["soak"] = rows
    return soak_k1


def tools_probes(out: dict, sharded_traffic: dict) -> int:
    """Phase 18's benches and probes; K1's launches over them, counted
    from zero."""
    from openbts_ttsou_tpu_torch.ops import cuda_fir
    from openbts_ttsou_tpu_torch.tools import (dfe_cost_probe,
                                               encode_stage_probe,
                                               exact_bakeoff, scaling_bench,
                                               stage_bench)

    cuda_fir.polyphase_resample_cuda.launches = 0
    bake = run_tool(out, "exact_bakeoff", exact_bakeoff,
                    ["--device", "cuda", "--carriers", "128,256,512"])
    check(bake["results_equal"], "exact_bakeoff: schedules differ")
    out["exact_bakeoff"] = bake
    for name, tool, args in (
            ("stage_bench", stage_bench, ["--carriers", "512"]),
            ("dfe_cost_probe", dfe_cost_probe, ["--carriers", "512"]),
            ("encode_stage_probe", encode_stage_probe,
             ["--carriers", "512"]),
            ("scaling_bench", scaling_bench,
             ["--shards", "1,2,4", "--chan-per-shard", "64"])):
        out[name] = run_tool(out, name, tool, ["--device", "cuda", *args])
    for name in ("exact_bakeoff", "stage_bench", "dfe_cost_probe",
                 "encode_stage_probe", "scaling_bench"):
        check_card_fields(out[name], name)
    check(all(r["use_dfe_every_frame"] for r in out["dfe_cost_probe"]["rows"]),
          "dfe_cost_probe: the DFE-on leg lost use_dfe")
    tools_last(out, sharded_traffic)
    tools_k1 = cuda_fir.polyphase_resample_cuda.launches
    check(tools_k1 > 0, "the tools never launched K1")
    return tools_k1


def tools_last(out: dict, sharded_traffic: dict) -> None:
    """The tools of the last slice: the roofline at 512 carriers (every
    region and the block with a count, a bound, a time and a share), the
    collective inventory at 8 shards of phase 15's width a chan shard,
    equal to phase 15's traffic a step, and two worker processes on the
    card against one, their results equal."""
    from openbts_ttsou_tpu_torch.tools import (collective_inventory,
                                               roofline, scaling_2proc)

    roof = run_tool(out, "roofline", roofline,
                    ["--device", "cuda", "--carriers", str(N_CHAN),
                     "--block-carriers", str(N_CHAN)])
    check_card_fields(roof, "roofline")
    for r in roof["regions"] + roof["rows"]:
        what = f"roofline {r.get('name', r.get('carriers'))}"
        check(r["bound_ms"] > 0 and r["share"] and 0 < r["share"] <= 1,
              f"{what}: bound {r['bound_ms']} ms, share {r['share']}")
    check({r["name"] for r in roof["regions"]} >= {
        "K1 65/96", "K1 96/65", "K2", "K3", "K4", "K5", "K6", "K7",
        "K8 xcch", "K8 rach", "K8 tch", "K8 facch"}, "roofline: regions")
    out["roofline"] = roof

    inv = run_tool(out, "collective_inventory", collective_inventory,
                   ["--device", "cuda", "--shards", str(INVENTORY_SHARDS),
                    "--carriers", str(INVENTORY_CHAN)])
    check(inv["mesh"] == {"chan": 4, "time": 2}, f"inventory {inv['mesh']}")
    for kind in ("uplink", "duplex"):
        got = {k: [v["count"], v["bytes_per_step"]]
               for k, v in inv[kind].items()}
        check(got == sharded_traffic[kind],
              f"collective_inventory {kind}: {got} against phase 15's "
              f"{sharded_traffic[kind]}")
    out["collective_inventory"] = inv

    sc = run_tool(out, "scaling_2proc", scaling_2proc,
                  ["--device", "cuda", *SCALING_ARGS, "--timeout", "300"])
    d = sc["detail"]
    check(d["results_equal"] and d["soft_differ"] == 0
          and d["tx_differ"] == 0,
          f"scaling_2proc: two processes differ from one ({d})")
    check(all(w["device"].startswith("cuda")
              for w in d["workers_1proc"] + d["workers_2proc"]),
          "scaling_2proc: a worker ran off the card")
    out["scaling_2proc"] = sc


# ---- phase 19: the bench ----------------------------------------------------

BENCH_ITERS = 4  # the default bench (exact @512): its best 2k run is 8 blocks


def check_bench_row(r: dict, what: str) -> dict:
    """A bench record: a positive rate, no error, the card's fields, and
    K1 launched once for the stimulus and its mode's count a block over
    every block the bench ran, each launch at a shape the record gives.
    Returns those shapes, {(rows, T, p, q, taps): launches}."""
    from openbts_ttsou_tpu_torch.bench import K1_PER_BLOCK

    check("error" not in r and r.get("value", 0) > 0,
          f"bench {what}: {r.get('error')}")
    d = r["detail"]
    check_card_fields(d, f"bench {what}")
    want = 1 + K1_PER_BLOCK[d["mode"]] * d["blocks_total"]
    check(d["k1_launches"] == want,
          f"bench {what}: K1 launched {d['k1_launches']} times, expected "
          f"{want} (1 + {K1_PER_BLOCK[d['mode']]} a block × "
          f"{d['blocks_total']} blocks)")
    shapes = {tuple(json.loads(k)): n for k, n in d["k1_shapes"].items()}
    check(sum(shapes.values()) == d["k1_launches"]
          and {k[0] for k in shapes} == {d["n_chan"]},
          f"bench {what}: K1 launched {d['k1_launches']} times, "
          f"{sum(shapes.values())} at recorded shapes {sorted(shapes)}")
    return shapes


def phase_bench() -> dict:
    """Phase 19: the port's benchmark program on the card, each bench run
    its own process. `python -m openbts_ttsou_tpu_torch.tools.bench_sweep
    --quick` (the five modes at 128 carriers, the JAX sweep's iters rule,
    BENCH_REPS=1: a downlink block takes ~1.3 ms there, so fewer than 32
    blocks leave t(2k) − t(k) under the bench's 0.02 s noise guard); the
    default `python -m openbts_ttsou_tpu_torch.bench` (exact @512) at
    BENCH_ITERS=4, whose best 2k run of 8 blocks must count phase 3's
    6,656 detections a block; every row's K1 launches (counted in its own
    process) equal to its mode's count, each launch at a shape the row
    records; K1 held against its plain form at every such shape and at
    each mode's shapes at every width of the full sweep (8 to 1024
    rows: the kernel's grid changes with the rows); and `entry()` on the
    card equal to `entry()` on the CPU."""
    from openbts_ttsou_tpu_torch import entry
    from openbts_ttsou_tpu_torch.models import transceiver as T
    from openbts_ttsou_tpu_torch.tools.bench_sweep import GRID

    out = {"phase": "bench", "seconds": {}}
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "openbts_ttsou_tpu_torch.tools.bench_sweep",
         "--quick", "--timeout", "300", "--out",
         str(ROOT / "build" / "tools" / "phase19_sweep.json")],
        cwd=ROOT, env={**env, "BENCH_REPS": "1"}, capture_output=True,
        text=True, timeout=900)
    out["seconds"]["sweep_quick"] = time.perf_counter() - t0
    lines = p.stdout.strip().splitlines()
    sweep = json.loads(lines[-1]) if lines else {"rows": []}
    check(p.returncode == 0 and sweep.get("ok") and len(sweep["rows"]) == 5,
          f"bench_sweep --quick exited {p.returncode}: {sweep['rows']} "
          f"{p.stderr[-2000:]}")
    shapes, by_mode = set(), {}
    for r in sweep["rows"]:
        seen = check_bench_row(r, f"{r['mode']} @ {r['carriers']}")
        shapes |= set(seen)
        by_mode[r["mode"]] = {k[1:] for k in seen}
        schedule = None if r["mode"] == "downlink" else "batched"
        check(r["detail"]["exact_schedule"] == schedule,
              f"bench {r['mode']} @ 128: schedule "
              f"{r['detail']['exact_schedule']}")
    out["sweep_quick"] = sweep["rows"]

    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "openbts_ttsou_tpu_torch.bench"],
                       cwd=ROOT, env={**env, "BENCH_ITERS": str(BENCH_ITERS)},
                       capture_output=True, text=True, timeout=600)
    out["seconds"]["bench_default"] = time.perf_counter() - t0
    check(p.returncode == 0, f"bench exited {p.returncode}: "
                             f"{p.stderr[-2000:]}")
    rec = json.loads(p.stdout.strip().splitlines()[-1])
    shapes |= set(check_bench_row(rec, "exact @512"))
    d = rec["detail"]
    check(d["mode"] == "exact" and d["n_chan"] == N_CHAN
          and d["blocks_run"] == 2 * BENCH_ITERS
          and d["exact_schedule"] == T.exact_schedule(N_CHAN),
          f"bench default: {d}")
    want = 13 * N_CHAN * 2 * BENCH_ITERS
    check(d["detections_run"] == want,
          f"bench exact @512: {d['detections_run']} detections in "
          f"{d['blocks_run']} blocks, expected {want}")
    out["bench_default"] = rec

    t0 = time.perf_counter()
    shapes |= {(c, *k) for mode, c, _ in GRID for k in by_mode[mode]}
    out["k1_checked"] = check_k1_shapes(shapes)
    out["seconds"]["k1_checked"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    runs = {}
    for dev in ("cuda", "cpu"):
        fn, (state, frame) = entry.entry(dev)
        runs[dev] = fn(state, frame)
    out["seconds"]["entry"] = time.perf_counter() - t0
    (sg, rg), (sc, rc) = runs["cuda"], runs["cpu"]
    for name in ("detected", "is_rach", "rssi", "timing"):
        check(torch.equal(getattr(rg, name).cpu(), getattr(rc, name)),
              f"entry: card and CPU differ in {name}")
    err = float((rg.soft_bits.cpu() - rc.soft_bits).abs().max())
    check(err <= 2e-4, f"entry: soft bits differ by {err}")
    check_states(sg, sc, "entry")
    out["entry"] = {"soft_bits_max_abs_err": err,
                    "detected": int(rg.detected.sum())}

    out["launches"] = {"polyphase_resample": sum(
        r["detail"]["k1_launches"] for r in sweep["rows"] + [rec])}
    record(out)
    return out


def kernels_line(kern: dict, launches: dict) -> dict:
    """The `kernels` record: K1 at the uplink shape, every shape's times
    beside its bound, and its launches on each main path (uplink,
    duplex, daemon, ..., sharded, soak, tools, bench), each counted
    from zero over that path's run (bench: in each bench process)."""
    from openbts_ttsou_tpu_torch.tools.kernel_bakeoff import K1_SHAPES

    rows, p, q, _, t_in = K1_SHAPES[0]
    up = kern[rows, p, q, t_in]
    keys = ("instantiation", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_share", "gbytes_per_s")
    by_path = {path: n["polyphase_resample"] for path, n in launches.items()}
    return {"kernels": [{
        "name": "polyphase_resample", "route": "cuda",
        "source": "openbts_ttsou_tpu_torch/csrc/polyphase_resample.cu",
        "replaces": "openbts_ttsou_tpu/ops/pallas_fir.py:121",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "launches_note": "bts: the BTS's per-frame TrxDaemon runs at "
                         "symbol rate (rx_step/tx_step), so K1 is not on "
                         "its path",
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
    t_start = time.perf_counter()
    phase_s = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        return out

    card = timed("card", phase_card)
    kern = timed("kernels", phase_kernels)
    if "--kernels-only" in sys.argv[1:]:  # phases 1-2: build and time
        print(card, flush=True)
        return 0
    main_path, trx, x = timed("main_path", phase_main_path)
    timed("profile", phase_profile, trx.cfg, trx.spec, trx, x,
          main_path["ms_per_block"])
    del trx, x
    timed("card_vs_cpu", phase_card_vs_cpu)
    duplex = timed("duplex", phase_duplex)
    daemon = timed("daemon", phase_daemon)
    timed("duplex_card_vs_cpu", phase_duplex_card_vs_cpu)
    resident, uls, blocks = timed("resident", phase_resident)
    uplink_decoded = timed("uplink_decoded", phase_uplink_decoded, uls,
                           blocks)
    del uls, blocks
    timed("resident_card_vs_cpu", phase_resident_card_vs_cpu)
    bus = timed("usrp_bus", phase_usrp_bus)
    bts = timed("bts", phase_bts)
    timed("bts_entry_point", phase_bts_entry_point)
    sharded = timed("sharded", phase_sharded)
    timed("sharded_card_vs_cpu", phase_sharded_card_vs_cpu)
    timed("distributed", phase_distributed)
    tools = timed("tools", phase_tools,
                  sharded["traffic_bytes_per_step"])
    bench = timed("bench", phase_bench)
    record({"phase": "wall", "phase_s": phase_s,
            "total_s": time.perf_counter() - t_start})

    launches = {"uplink": main_path["launches"],
                "duplex": duplex["launches"], "daemon": daemon["launches"],
                "resident": resident["launches"],
                "uplink_decoded": uplink_decoded["launches"],
                "usrp_bus": bus["launches"], "bts": bts["launches"],
                "sharded": sharded["launches"], "soak": tools["launches"],
                "tools": tools["tools_launches"], "bench": bench["launches"]}
    print(json.dumps(kernels_line(kern, launches)), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
