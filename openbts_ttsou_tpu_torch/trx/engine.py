"""Batched GSM layer-0 engine: burst clock, detection dispatch,
demodulation, adaptive threshold, channel/DFE state, and the transmit
modulator with its filler table.

Port of `openbts_ttsou_tpu/trx/engine.py`. Reference behavior:
`Transceiver52M/Transceiver.{h,cpp}` — `expectedCorrType`
(Transceiver.cpp:207-266), `pullRadioVector` (:268-408, the uplink hot
path), adaptive energy threshold (:91,294-303,336-375), per-timeslot
channel state and 50-frame DFE re-estimation (:311-348), RSSI/TOA
reporting (:396-399).

`rx_frames` (`tx_frames`) receives (transmits) a window of F GSM frames
for every carrier at once, `[frame, chan, slot, samples]` flattened to
`[frame·chan·slot]` bursts; `rx_step` (`tx_step`) is the same over a
window of one frame. All state is an explicit `TrxState` NamedTuple of
tensors on one device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from openbts_ttsou_tpu_torch.ops import correlate as xcorr
from openbts_ttsou_tpu_torch.ops import cuda_walk
from openbts_ttsou_tpu_torch.ops import dfe as dfe_mod
from openbts_ttsou_tpu_torch.ops import gmsk
from openbts_ttsou_tpu_torch.utils import constants as C
from openbts_ttsou_tpu_torch.utils.gsm_time import (HYPERFRAME,
                                                    SLOT_SAMPLE_PATTERN,
                                                    fn_delta)
from openbts_ttsou_tpu_torch.utils.profiling import span
from openbts_ttsou_tpu_torch.utils.tables import copy_table

SLOT_SAMPLES = 157  # uniform per-slot sample window (1 sps), masked per TN
CHAN_TAPS = 6  # channel estimate length in symbols (sigProcLib.cpp:1009)
DFE_NF = 7  # feedforward taps (Transceiver.cpp:345)


class ChanType:
    """Channel combinations (Transceiver.h:79-88)."""

    NONE = 0
    I = 1  # noqa: E741
    II = 2
    III = 3
    IV = 4
    V = 5
    VI = 6
    VII = 7
    LOOPBACK = 8


class CorrType:
    """Expected burst type (Transceiver.h:91-96)."""

    OFF = 0
    IDLE = 1
    RACH = 2
    TSC = 3


class TrxConfig(NamedTuple):
    """Static engine configuration."""

    n_chan: int = 1  # number of ARFCN carriers
    sps: int = 1  # samples per symbol
    rach_threshold: float = C.RACH_DETECT_THRESHOLD
    tsc_threshold: float = C.TSC_DETECT_THRESHOLD
    tx_full_scale: float = C.TX_FULL_SCALE
    rssi_full_scale: float = C.RSSI_FULL_SCALE
    #: static TSC correlation window (2·max_toa+1 lags, the 52M
    #: CUSTOM-span correlation); None = the 64M full-segment geometry
    max_toa: int | None = None
    #: static tuple of timeslots that can carry RACH; None = all 8
    rach_slots: tuple | None = None


class TrxState(NamedTuple):
    """Per-[chan] and per-[chan, slot] state (Transceiver.h:110-140)."""

    fn: torch.Tensor  # [] int32 — current frame number
    chan_type: torch.Tensor  # [C, 8] int32 (ChanType)
    tsc: torch.Tensor  # [C] int32 — training sequence code
    max_expected_delay: torch.Tensor  # [C] int32
    energy_threshold: torch.Tensor  # [C] f32
    prev_false_detect_fn: torch.Tensor  # [C] i32
    chan_valid: torch.Tensor  # [C, 8] bool
    chan_response: torch.Tensor  # [C, 8, CHAN_TAPS·sps] c64
    chan_resp_offset: torch.Tensor  # [C, 8] f32
    chan_amplitude: torch.Tensor  # [C, 8] c64
    snr: torch.Tensor  # [C, 8] f32
    dfe_forward: torch.Tensor  # [C, 8, DFE_NF] c64
    dfe_feedback: torch.Tensor  # [C, 8, CHAN_TAPS − 1] c64
    chan_estimate_fn: torch.Tensor  # [C, 8] i32
    filler: torch.Tensor  # [C, 8, SLOT_SAMPLES·sps] c64


class RxResult(NamedTuple):
    """Per-frame receive output (all [C, 8] + soft bits [C, 8, 148])."""

    detected: torch.Tensor  # bool
    is_rach: torch.Tensor  # bool
    soft_bits: torch.Tensor  # f32 [C, 8, 148] in [0, 1]
    rssi: torch.Tensor  # i32
    timing: torch.Tensor  # i32 — TOA in 1/256 symbol


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for and absent; never falls back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run on the CPU")
    return dev


def init_state(cfg: TrxConfig, device="cuda") -> TrxState:
    """Fresh engine state with the dummy-burst filler table
    (Transceiver.cpp:69-93), on `device`."""
    dev = resolve_device(device)
    c, sps = cfg.n_chan, cfg.sps
    nw = CHAN_TAPS * sps
    dummy = np.zeros((8, SLOT_SAMPLES * sps), np.complex64)
    for tn in range(8):
        guard = 8 + (1 if tn % 4 == 0 else 0)
        mod = gmsk.modulate_burst_np(C.DUMMY_BURST[None], sps,
                                     guard_len=guard)[0]
        dummy[tn, : len(mod)] = mod * cfg.tx_full_scale
    filler = torch.from_numpy(dummy).to(dev)

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return TrxState(
        fn=z((), torch.int32),
        chan_type=z((c, 8), torch.int32),
        tsc=z((c,), torch.int32),
        max_expected_delay=z((c,), torch.int32),
        energy_threshold=torch.full((c,), C.INITIAL_ENERGY_THRESHOLD,
                                    dtype=torch.float32, device=dev),
        prev_false_detect_fn=z((c,), torch.int32),
        chan_valid=z((c, 8), torch.bool),
        chan_response=z((c, 8, nw), torch.complex64),
        chan_resp_offset=z((c, 8), torch.float32),
        chan_amplitude=torch.ones((c, 8), dtype=torch.complex64, device=dev),
        snr=torch.ones((c, 8), dtype=torch.float32, device=dev),
        dfe_forward=z((c, 8, DFE_NF), torch.complex64),
        # the DFE is symbol-rate, so the feedback span is CHAN_TAPS − 1
        # regardless of sps
        dfe_feedback=z((c, 8, CHAN_TAPS - 1), torch.complex64),
        chan_estimate_fn=z((c, 8), torch.int32),
        filler=filler.expand(c, 8, SLOT_SAMPLES * sps).clone(),
    )


def expected_corr_type(chan_type: torch.Tensor, fn) -> torch.Tensor:
    """Vectorized expectedCorrType (Transceiver.cpp:207-266).

    chan_type: [C, 8] int32; fn: int or int tensor broadcastable against
    chan_type (e.g. [F, 1, 1]). Returns CorrType int32 of the broadcast
    shape."""
    fn = torch.as_tensor(fn, dtype=torch.int32, device=chan_type.device)
    m2 = fn % 2
    m51 = fn % 51  # combination I ignores the mod-26 idle slot (cpp:214-218)
    shape = torch.broadcast_shapes(chan_type.shape, fn.shape)
    ct = chan_type.expand(shape)

    def full(v):
        return torch.full(shape, v, dtype=torch.int32, device=ct.device)

    def pick(cond, a, b):
        return torch.where(torch.broadcast_to(cond, shape), a, b)

    tsc, idle, rach = (full(CorrType.TSC), full(CorrType.IDLE),
                       full(CorrType.RACH))
    v_is_rach = (((m51 <= 36) & (m51 >= 14)) | (m51 == 4) | (m51 == 5)
                 | (m51 == 45) | (m51 == 46))
    out = full(CorrType.OFF)
    for combo, val in (
            (ChanType.I, tsc),
            (ChanType.II, pick(m2 == 1, idle, tsc)),
            (ChanType.III, tsc),
            (ChanType.IV, rach),
            (ChanType.VI, rach),
            (ChanType.V, pick(v_is_rach, rach, tsc)),
            (ChanType.VII, pick((m51 <= 14) & (m51 >= 12), idle, tsc)),
            (ChanType.LOOPBACK, pick((m51 <= 50) & (m51 >= 48), idle, tsc)),
    ):
        out = torch.where(ct == combo, val, out)
    return out


def _detect_rach_slots(frame3: torch.Tensor, sps: int, threshold: float,
                       rach_slots) -> xcorr.Detection:
    """detect_rach over every (row, slot) burst of frame3 [N, 8, T], or
    only over the slots of `rach_slots`, with no-detection elsewhere
    (the reference runs no RACH correlator there, Transceiver.cpp:358-364).
    Returns fields flattened to [N·8]."""
    m = frame3.shape[0]
    n = m * 8
    if rach_slots is None:
        return xcorr.detect_rach(frame3.reshape(n, -1), sps,
                                 threshold=threshold)
    ks = sorted({int(t) for t in rach_slots})
    dev = frame3.device
    z = torch.zeros((m, 8), dtype=torch.float32, device=dev)
    out = xcorr.Detection(torch.zeros((m, 8), dtype=torch.bool, device=dev),
                          torch.zeros((m, 8), dtype=torch.complex64,
                                      device=dev), z, z.clone())
    if ks:
        d = xcorr.detect_rach(frame3[:, ks].reshape(m * len(ks), -1), sps,
                              threshold=threshold)
        for field in ("detected", "amplitude", "toa", "peak_to_mean"):
            getattr(out, field)[:, ks] = getattr(d, field).reshape(m, len(ks))
    return xcorr.Detection(out.detected.reshape(-1),
                           out.amplitude.reshape(-1), out.toa.reshape(-1),
                           out.peak_to_mean.reshape(-1))


def rach_allowed_mask(cfg: TrxConfig, corr_type: torch.Tensor) -> torch.Tensor:
    """True where a slot is not a RACH slot outside cfg.rach_slots (such
    a slot runs no correlator and counts as inactive)."""
    if cfg.rach_slots is None:
        return torch.ones_like(corr_type, dtype=torch.bool)
    allowed = np.zeros(8, bool)
    allowed[list(cfg.rach_slots)] = True
    allowed_t = copy_table(allowed, corr_type.device)
    return ~((corr_type == CorrType.RACH) & ~allowed_t)


def threshold_walk(fn, e_thr, prev_false, active, gate, success):
    """The slot-ordered adaptive-threshold fold of one frame
    (Transceiver.cpp:294-303, 331-333, 350-356, 366-375). active, gate,
    success: [C, 8] bool. Returns (e_thr, prev_false)."""
    fn_b = torch.broadcast_to(fn, prev_false.shape)
    for tn in range(8):
        frames_elapsed = fn_delta(fn, prev_false).to(torch.float32)
        low_energy = active[:, tn] & ~gate[:, tn]
        quiet = low_energy & (frames_elapsed > 50)
        e_thr = torch.where(quiet, e_thr - 10.0, e_thr)
        prev_false = torch.where(quiet, fn_b, prev_false)
        hit = success[:, tn]
        e_thr = torch.where(hit, torch.clamp(e_thr - 1.0, min=0.0), e_thr)
        miss = active[:, tn] & gate[:, tn] & ~success[:, tn]
        e_thr = torch.where(miss, e_thr + 10.0 * torch.exp(-frames_elapsed),
                            e_thr)
        prev_false = torch.where(miss, fn_b, prev_false)
    return e_thr, prev_false


class ExactWalk(NamedTuple):
    """What the sequential walk of `rx_frames` leaves: per frame the
    gated successes, the channel validity and the last adoption's frame
    after it ([F, C, 8]) and the threshold it entered with ([F, C]);
    then the walk's final threshold, last false-detect frame ([C]),
    validity, estimate frame and last adoption ([C, 8])."""

    success: torch.Tensor
    valid_post: torch.Tensor
    last_post: torch.Tensor
    thr_entry: torch.Tensor
    thr: torch.Tensor
    prev_false: torch.Tensor
    valid: torch.Tensor
    est_fn: torch.Tensor
    last: torch.Tensor


def exact_walk(fns: torch.Tensor, active: torch.Tensor, is_tsc: torch.Tensor,
               energy: torch.Tensor, detected: torch.Tensor,
               det_ok: torch.Tensor, need_dfe: torch.Tensor,
               state: TrxState) -> ExactWalk:
    """The threshold walk of `rx_frames` (K7): on CUDA tensors one
    launch of the kernel (`ops/cuda_walk.py`), on CPU tensors
    `exact_walk_plain`. The same outputs, bit for bit."""
    if energy.is_cuda:
        return ExactWalk(*cuda_walk.exact_walk_cuda(
            fns, active, is_tsc, energy, detected, det_ok, need_dfe,
            state.energy_threshold, state.prev_false_detect_fn,
            state.chan_valid, state.chan_estimate_fn))
    if energy.device.type != "cpu":
        raise ValueError(f"exact_walk: no kernel for {energy.device}")
    return exact_walk_plain(fns, active, is_tsc, energy, detected, det_ok,
                            need_dfe, state)


def exact_walk_plain(fns: torch.Tensor, active: torch.Tensor,
                     is_tsc: torch.Tensor, energy: torch.Tensor,
                     detected: torch.Tensor, det_ok: torch.Tensor,
                     need_dfe: torch.Tensor,
                     state: TrxState) -> ExactWalk:
    """The threshold walk of `rx_frames`, frame by frame on [C, 8]
    tensors (Transceiver.cpp:294-375): the energy gate against the
    running threshold, success, channel adoption (a TSC success that
    wants an estimate) and `threshold_walk`. fns [F]; active, is_tsc,
    energy, detected (the raw TSC detection) and det_ok (the
    threshold-independent detection) [F, C, 8]; need_dfe [C]. The CPU
    path, and what the card tests hold the kernel to."""
    f, c = energy.shape[:2]
    thr = state.energy_threshold
    prev_false = state.prev_false_detect_fn
    valid = state.chan_valid
    est_fn = state.chan_estimate_fn
    last = torch.full((c, 8), -1, dtype=torch.int32, device=energy.device)
    success_s, valid_post_s, last_post_s, thr_entry_s = [], [], [], []
    for i in range(f):
        fn_i, act_i, tsc_i = fns[i], active[i], is_tsc[i]
        thr_entry_s.append(thr)
        gate = (energy[i] > (thr * thr)[:, None]) & act_i
        success = gate & det_ok[i]
        want = ((fn_delta(fn_i, est_fn) > 50) | ~valid) & need_dfe[:, None]
        do_est = want & tsc_i & success
        valid = torch.where(do_est, True,
                            valid & ~(~detected[i] & tsc_i & gate))
        est_fn = torch.where(do_est, fn_i, est_fn)
        last = torch.where(do_est, i, last)
        thr, prev_false = threshold_walk(fn_i, thr, prev_false, act_i, gate,
                                         success)
        success_s.append(success)
        valid_post_s.append(valid)
        last_post_s.append(last)
    return ExactWalk(torch.stack(success_s), torch.stack(valid_post_s),
                     torch.stack(last_post_s), torch.stack(thr_entry_s),
                     thr, prev_false, valid, est_fn, last)


def rssi_timing(cfg: TrxConfig, amplitude: torch.Tensor, toa: torch.Tensor):
    """RSSI floor(20·log10(fullScale/|amp|)) and timing round(TOA·256/sps),
    half-to-even (Transceiver.cpp:396-399)."""
    amp_abs = torch.clamp(amplitude.abs(), min=1e-9)
    rssi = torch.floor(20.0 * torch.log10(cfg.rssi_full_scale / amp_abs)
                       ).to(torch.int32)
    timing = torch.round(toa * 256.0 / cfg.sps).to(torch.int32)
    return rssi, timing


def rx_frames(cfg: TrxConfig, state: TrxState, wins: torch.Tensor
              ) -> tuple[TrxState, RxResult]:
    """Receive a window of uplink frames for all channels.

    wins: [F, C, 8, SLOT_SAMPLES·sps] complex64 per-slot sample windows.
    Returns the state after the window and per-frame results
    [F, C, 8, ...]. Implements pullRadioVector (Transceiver.cpp:268-408)
    frame by frame, exactly: the threshold-independent work
    (correlators, channel estimation, DFE design, demodulation,
    equalizer) runs once over all F·C·8 bursts, and only the sequential
    recurrences (per-slot threshold walk, energy gate against the
    running threshold, channel/DFE adoption, cpp:294-375) run frame by
    frame, in `exact_walk` (one kernel launch on the card, K7). Per-burst
    equalizer weights and the final state select the last adoption at
    or before each frame, or the entry state.
    """
    c, sps = cfg.n_chan, cfg.sps
    f = wins.shape[0]
    dev = wins.device
    bursts = wins.reshape((-1, wins.shape[-1]))  # [F·C·8, T]
    fn0 = state.fn
    fns = (fn0 + torch.arange(f, dtype=torch.int32, device=dev)) % HYPERFRAME

    corr_type = expected_corr_type(state.chan_type, fns[:, None, None])
    active = ((corr_type == CorrType.TSC) | (corr_type == CorrType.RACH)) \
        & rach_allowed_mask(cfg, corr_type)
    is_tsc = corr_type == CorrType.TSC  # [F, C, 8]
    is_rach = corr_type == CorrType.RACH
    ts_flat = is_tsc.reshape(-1)
    ra_flat = is_rach.reshape(-1)

    # raw per-burst energy once; the walk compares it with the running
    # threshold (energyDetect gate, cpp:292-303)
    _, energy = xcorr.energy_detect(bursts, 20 * sps, 0.0)
    energy = energy.reshape(f, c, 8)

    need_dfe = state.max_expected_delay > 1  # [C]
    # estimation gate, with no threshold walk: frame i wants an estimate
    # where the DFE is on and the slot's estimate is stale or invalid.
    # Staleness only grows until an adoption (which needs the gate open),
    # and only a TSC burst of an earlier frame clears validity, so the
    # last frame's staleness and the TSC slots of frames 0..F-2 bound it;
    # at F = 1 the bound is the frame's own want
    stale_ub = fn_delta(fns[-1], state.chan_estimate_fn) > 50  # [C,8]
    # host sync: the estimation/DFE-design gate
    with span("sync.est_gate"):
        gate_est = bool((need_dfe[:, None] & (stale_ub | ~state.chan_valid
                                              | is_tsc[:-1].any(0))).any())

    tsc_flat = state.tsc.repeat_interleave(8).repeat(f)
    det_tsc, chan_est, chan_off = xcorr.analyze_traffic_burst(
        bursts, tsc_flat, sps, threshold=cfg.tsc_threshold,
        estimate_channel=True, max_toa=cfg.max_toa,
        gate_estimation=gate_est)
    det_rach = _detect_rach_slots(
        wins.reshape(f * c, 8, wins.shape[-1]), sps, cfg.rach_threshold,
        cfg.rach_slots)

    # type dispatch + TOA acceptance: the threshold-independent part of
    # `success`; the energy gate joins in the walk
    no = torch.zeros_like(ts_flat)
    det_any = torch.where(ts_flat, det_tsc.detected,
                          torch.where(ra_flat, det_rach.detected, no))
    # RACH acceptance window (SETMAXDELAY, 0 = unbounded)
    med = (state.max_expected_delay.repeat_interleave(8).repeat(f)
           .to(torch.float32) * sps)
    det_any = det_any & torch.where(ra_flat & (med > 0),
                                    det_rach.toa <= med, ~no)
    # TSC acceptance: |TOA| ≤ max(SETMAXDELAY, 3)·sps per carrier
    tsc_bound = torch.clamp(med, min=3.0 * sps)
    det_any = det_any & torch.where(
        ts_flat, (det_tsc.toa <= tsc_bound) & (det_tsc.toa >= -tsc_bound),
        ~no)
    amplitude = torch.where(ts_flat, det_tsc.amplitude, det_rach.amplitude)
    toa = torch.where(ts_flat, det_tsc.toa, det_rach.toa)

    # ---- the light sequential walk: threshold + adoption -------------
    with span("rx.walk"):
        walk = exact_walk(fns, active, is_tsc, energy,
                          det_tsc.detected.reshape(f, c, 8),
                          det_any.reshape(f, c, 8), need_dfe, state)
    thr, prev_false, valid, est_fn, last = (
        walk.thr, walk.prev_false, walk.valid, walk.est_fn, walk.last)
    success = walk.success.reshape(-1)  # [F·C·8]

    # ---- estimation candidates + DFE design (batched, gated) ---------
    n = f * c * 8
    thr_b = walk.thr_entry.repeat_interleave(8, dim=-1).reshape(-1)
    new_snr_all = amplitude.abs() ** 2 / (thr_b * thr_b + 1.0)  # cpp:330
    amp_safe = torch.where(amplitude == 0, torch.ones_like(amplitude),
                           amplitude)
    chan_norm_all = chan_est / amp_safe[:, None]
    # the DFE is symbol-rate: decimate the oversampled estimate
    dfe_chan_all = chan_norm_all[..., ::sps] if sps > 1 else chan_norm_all
    if gate_est:  # the same host-synced gate as above
        with span("rx.dfe_design"):
            w_all, b_all = dfe_mod.design_dfe(
                dfe_chan_all, torch.clamp(new_snr_all, min=1e-6), DFE_NF)
    else:
        w_all = torch.zeros((n, DFE_NF), dtype=torch.complex64, device=dev)
        b_all = torch.zeros((n, CHAN_TAPS - 1), dtype=torch.complex64,
                            device=dev)

    # ---- per-burst candidate selection: entry state or frame j's -----
    c8 = c * 8
    cols = torch.arange(c8, device=dev)

    def cands(entry, per_frame):
        """[F+1, C8, ...]: row 0 the entry state, row j+1 frame j's."""
        return torch.cat([entry.reshape((1, c8) + entry.shape[2:]),
                          per_frame.reshape((f, c8) + per_frame.shape[1:])])

    def sel(cand, pick):
        """cand [F+1, C8, ...] at rows pick [K, C8] → [K, C8, ...]."""
        return cand[pick.to(torch.int64), cols]

    # equalizer weights per burst: the adoption state AFTER its own frame
    pick_post = walk.last_post.reshape(f, c8) + 1  # [F, C8]
    w_sel = sel(cands(state.dfe_forward, w_all), pick_post
                ).reshape(n, DFE_NF)
    b_sel = sel(cands(state.dfe_feedback, b_all), pick_post
                ).reshape(n, CHAN_TAPS - 1)
    off_sel = sel(cands(state.chan_resp_offset, chan_off), pick_post
                  ).reshape(n)

    use_dfe = (ts_flat & need_dfe.repeat_interleave(8).repeat(f)
               & walk.valid_post.reshape(-1))
    k = 148

    # ---- demod + equalizer (batched, equalizer gated, cpp:381-395) ---
    soft_plain = gmsk.demodulate_burst(bursts, sps, amplitude, toa)
    # host sync: the equalizer runs only when some burst needs it
    with span("sync.dfe_gate"):
        dfe_open = bool(use_dfe.any())
    if dfe_open:
        with span("rx.equalize"):
            soft_eq = dfe_mod.equalize_burst(bursts / amp_safe[:, None],
                                             toa - off_sel, sps, w_sel,
                                             b_sel)[:, :k]
        soft = torch.where(use_dfe[:, None], soft_eq, soft_plain[:, :k])
    else:
        soft = soft_plain[:, :k]
    soft = torch.where(success[:, None], soft, 0.5)
    rssi, timing = rssi_timing(cfg, amplitude, toa)

    # ---- final state: LAST adoption per (chan, slot), or entry -------
    pick_f = (last.reshape(1, c8) + 1)

    def final(entry, per_frame):
        return sel(cands(entry, per_frame), pick_f)[0]

    new_state = state._replace(
        fn=(fn0 + f) % HYPERFRAME,
        energy_threshold=thr,
        prev_false_detect_fn=prev_false,
        chan_valid=valid,
        chan_estimate_fn=est_fn,
        chan_response=final(state.chan_response, chan_norm_all
                            ).reshape(c, 8, -1),
        chan_resp_offset=final(state.chan_resp_offset, chan_off
                               ).reshape(c, 8),
        chan_amplitude=final(state.chan_amplitude, amplitude).reshape(c, 8),
        snr=final(state.snr, new_snr_all).reshape(c, 8),
        dfe_forward=final(state.dfe_forward, w_all).reshape(c, 8, -1),
        dfe_feedback=final(state.dfe_feedback, b_all).reshape(c, 8, -1),
    )
    res = RxResult(
        detected=success.reshape(f, c, 8),
        is_rach=(success & ra_flat).reshape(f, c, 8),
        soft_bits=soft.reshape(f, c, 8, k),
        rssi=rssi.reshape(f, c, 8),
        timing=timing.reshape(f, c, 8),
    )
    return new_state, res


def rx_step(cfg: TrxConfig, state: TrxState, frame: torch.Tensor
            ) -> tuple[TrxState, RxResult]:
    """Process one uplink frame for all channels: `rx_frames` over a
    window of one. frame: [C, 8, SLOT_SAMPLES·sps] complex64 per-slot
    sample windows."""
    state, res = rx_frames(cfg, state, frame[None])
    return state, RxResult(*(x[0] for x in res))


def tx_step(cfg: TrxConfig, state: TrxState, bits: torch.Tensor,
            valid: torch.Tensor, atten_db: torch.Tensor, fn=None
            ) -> torch.Tensor:
    """Modulate one downlink frame for all channels.

    bits: [C, 8, 148] uint8; valid: [C, 8] bool (filler-table fallback
    where False, Transceiver.cpp:165-175); atten_db: [C, 8] float32
    relative attenuation (addRadioVector scale, cpp:111); fn is unused
    (the reference's tx walk reads no frame-dependent state). Returns
    [C, 8, SLOT_SAMPLES·sps] slot windows, zero past each slot's
    157/156 length."""
    del fn
    return tx_frames(cfg, state, bits[None], valid[None], atten_db[None])[0]


def tx_frames(cfg: TrxConfig, state: TrxState, bits: torch.Tensor,
              valid: torch.Tensor, atten_db: torch.Tensor) -> torch.Tensor:
    """Modulate a whole window of downlink frames in one batch:
    bits [F, C, 8, 148], valid/atten_db [F, C, 8] →
    [F, C, 8, SLOT_SAMPLES·sps]. tx_step reads only block-constant state
    (filler table, full scale), so the reference's frame-at-a-time
    driveTransmitFIFO walk (Transceiver.cpp:672-722) is one F·C·8-burst
    modulation."""
    f, c, sps = bits.shape[0], cfg.n_chan, cfg.sps
    t = SLOT_SAMPLES * sps
    dev = bits.device
    flat = bits.reshape(f * c * 8, bits.shape[-1])
    mod = gmsk.modulate_burst(flat, sps, guard_len=9)  # [F·C·8, 157·sps]
    scale = cfg.tx_full_scale * 10.0 ** (
        -atten_db.reshape(-1).to(torch.float32) / 10.0)
    mod = mod * scale.to(torch.float32)[:, None]
    # zero the samples past the true slot length (157/156/156/156)
    slot_len = copy_table(SLOT_SAMPLE_PATTERN, dev, torch.int64) * sps
    mask = (torch.arange(t, device=dev)[None, :]
            < slot_len.repeat(f * c)[:, None])
    mod = torch.where(mask, mod[:, :t], torch.zeros((), dtype=mod.dtype,
                                                     device=dev))
    fill = state.filler.reshape(1, c * 8, t).expand(f, c * 8, t
                                                    ).reshape(f * c * 8, t)
    out = torch.where(valid.reshape(-1)[:, None], mod, fill)
    return out.reshape(f, c, 8, t)
