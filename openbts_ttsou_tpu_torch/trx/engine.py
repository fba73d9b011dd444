"""Batched GSM layer-0 engine: burst clock, detection dispatch,
demodulation, adaptive threshold, channel/DFE state, and the transmit
modulator with its filler table.

Port of `openbts_ttsou_tpu/trx/engine.py`. Reference behavior:
`Transceiver52M/Transceiver.{h,cpp}` — `expectedCorrType`
(Transceiver.cpp:207-266), `pullRadioVector` (:268-408, the uplink hot
path), adaptive energy threshold (:91,294-303,336-375), per-timeslot
channel state and 50-frame DFE re-estimation (:311-348), RSSI/TOA
reporting (:396-399).

One `rx_step` (`tx_step`) receives (transmits) a whole GSM frame for
every carrier at once:
`[chan, slot, samples]` flattened to `[chan·slot]` bursts. All state is
an explicit `TrxState` NamedTuple of tensors on one device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from openbts_ttsou_tpu_torch.ops import correlate as xcorr
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


def _flat(x):
    return x.reshape((-1,) + x.shape[2:])


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


def rssi_timing(cfg: TrxConfig, amplitude: torch.Tensor, toa: torch.Tensor):
    """RSSI floor(20·log10(fullScale/|amp|)) and timing round(TOA·256/sps),
    half-to-even (Transceiver.cpp:396-399)."""
    amp_abs = torch.clamp(amplitude.abs(), min=1e-9)
    rssi = torch.floor(20.0 * torch.log10(cfg.rssi_full_scale / amp_abs)
                       ).to(torch.int32)
    timing = torch.round(toa * 256.0 / cfg.sps).to(torch.int32)
    return rssi, timing


def rx_step(cfg: TrxConfig, state: TrxState, frame: torch.Tensor
            ) -> tuple[TrxState, RxResult]:
    """Process one uplink frame for all channels.

    frame: [C, 8, SLOT_SAMPLES·sps] complex64 per-slot sample windows.
    Implements pullRadioVector (Transceiver.cpp:268-408) densely over the
    [chan, slot] batch.
    """
    c, sps = cfg.n_chan, cfg.sps
    fn = state.fn
    bursts = _flat(frame)  # [C*8, T]
    n = bursts.shape[0]
    dev = bursts.device

    corr_type = expected_corr_type(state.chan_type, fn)  # [C,8]
    active = ((corr_type == CorrType.TSC) | (corr_type == CorrType.RACH)) \
        & rach_allowed_mask(cfg, corr_type)

    # --- energy gate (cpp:292-303) ------------------------------------
    thr = state.energy_threshold.repeat_interleave(8)  # [C*8]
    has_energy, _ = xcorr.energy_detect(bursts, 20 * sps, thr)
    has_energy = has_energy.reshape(c, 8) & active

    # --- TSC path (cpp:311-348) ---------------------------------------
    need_dfe = state.max_expected_delay > 1  # [C]
    tsc_flat = state.tsc.repeat_interleave(8)
    frames_since_est = fn_delta(fn, state.chan_estimate_fn)  # [C,8]
    want_est = ((frames_since_est > 50) | ~state.chan_valid) & \
        need_dfe[:, None]
    # host sync: the estimation/DFE-design gate (a CUDA graph must not
    # branch on device data)
    with span("sync.est_gate"):
        est_open = bool(want_est.any())
    det_tsc, chan_est, chan_off = xcorr.analyze_traffic_burst(
        bursts, tsc_flat, sps, threshold=cfg.tsc_threshold,
        estimate_channel=True, max_toa=cfg.max_toa,
        gate_estimation=est_open)

    # --- RACH path (cpp:358-375) --------------------------------------
    det_rach = _detect_rach_slots(frame, sps, cfg.rach_threshold,
                                  cfg.rach_slots)

    is_tsc = (corr_type == CorrType.TSC).reshape(-1)
    is_rach = (corr_type == CorrType.RACH).reshape(-1)
    gate = has_energy.reshape(-1)
    no = torch.zeros_like(gate)
    success = gate & torch.where(is_tsc, det_tsc.detected,
                                 torch.where(is_rach, det_rach.detected, no))
    # RACH acceptance window (SETMAXDELAY, 0 = unbounded)
    max_toa = (state.max_expected_delay.repeat_interleave(8)
               .to(torch.float32) * cfg.sps)
    success = success & torch.where(is_rach & (max_toa > 0),
                                    det_rach.toa <= max_toa, ~no)
    # TSC acceptance: |TOA| ≤ max(SETMAXDELAY, 3)·sps per carrier
    tsc_bound = torch.clamp(max_toa, min=3.0 * cfg.sps)
    success = success & torch.where(
        is_tsc, (det_tsc.toa <= tsc_bound) & (det_tsc.toa >= -tsc_bound),
        ~no)
    amplitude = torch.where(is_tsc, det_tsc.amplitude, det_rach.amplitude)
    toa = torch.where(is_tsc, det_tsc.toa, det_rach.toa)

    # --- channel state update (cpp:315-346) ---------------------------
    do_est = want_est.reshape(-1) & is_tsc & success
    new_snr = amplitude.abs() ** 2 / (thr * thr + 1.0)  # cpp:330
    amp_safe = torch.where(amplitude == 0, torch.ones_like(amplitude),
                           amplitude)
    chan_norm = chan_est / amp_safe[:, None]
    # the DFE is symbol-rate: decimate the oversampled estimate
    dfe_chan = chan_norm[..., :: cfg.sps] if cfg.sps > 1 else chan_norm
    if est_open:  # the same host-synced gate as above
        with span("rx.dfe_design"):
            dfe_w, dfe_b = dfe_mod.design_dfe(
                dfe_chan, torch.clamp(new_snr, min=1e-6), DFE_NF)
    else:
        dfe_w = torch.zeros((n, DFE_NF), dtype=torch.complex64, device=dev)
        dfe_b = torch.zeros((n, CHAN_TAPS - 1), dtype=torch.complex64,
                            device=dev)

    def upd(old, new, mask):
        m = mask.reshape((c, 8) + (1,) * (old.ndim - 2))
        return torch.where(m, new.reshape(old.shape), old)

    new_state = state._replace(
        chan_valid=torch.where(
            do_est.reshape(c, 8), True,
            state.chan_valid & ~((~det_tsc.detected & is_tsc & gate)
                                 .reshape(c, 8))),
        chan_response=upd(state.chan_response, chan_norm, do_est),
        chan_resp_offset=upd(state.chan_resp_offset, chan_off, do_est),
        chan_amplitude=upd(state.chan_amplitude, amplitude, do_est),
        snr=upd(state.snr, new_snr, do_est),
        dfe_forward=upd(state.dfe_forward, dfe_w, do_est),
        dfe_feedback=upd(state.dfe_feedback, dfe_b, do_est),
        chan_estimate_fn=upd(state.chan_estimate_fn,
                             torch.broadcast_to(fn, (n,)), do_est),
    )

    # --- adaptive energy threshold, folded over the 8 slots in order ---
    e_thr, prev_false = threshold_walk(
        fn, state.energy_threshold, state.prev_false_detect_fn, active,
        has_energy, success.reshape(c, 8))
    new_state = new_state._replace(energy_threshold=e_thr,
                                   prev_false_detect_fn=prev_false)

    # --- demodulation (cpp:381-395) -----------------------------------
    soft_plain = gmsk.demodulate_burst(bursts, sps, amplitude, toa)
    use_dfe = is_tsc & need_dfe.repeat_interleave(8) & \
        new_state.chan_valid.reshape(-1)
    k = 148
    # host sync: the equalizer runs only when some burst needs it
    with span("sync.dfe_gate"):
        dfe_open = bool(use_dfe.any())
    if dfe_open:
        with span("rx.equalize"):
            soft_eq = dfe_mod.equalize_burst(
                bursts / amp_safe[:, None],
                toa - new_state.chan_resp_offset.reshape(-1), sps,
                _flat(new_state.dfe_forward), _flat(new_state.dfe_feedback)
            )[:, :k]
        soft = torch.where(use_dfe[:, None], soft_eq, soft_plain[:, :k])
    else:
        soft = soft_plain[:, :k]
    soft = torch.where(success[:, None], soft, 0.5)

    rssi, timing = rssi_timing(cfg, amplitude, toa)
    new_state = new_state._replace(fn=(fn + 1) % HYPERFRAME)
    res = RxResult(
        detected=success.reshape(c, 8),
        is_rach=(success & is_rach).reshape(c, 8),
        soft_bits=soft.reshape(c, 8, k),
        rssi=rssi.reshape(c, 8),
        timing=timing.reshape(c, 8),
    )
    return new_state, res


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
