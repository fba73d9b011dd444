"""The flagship model's uplink: a complete multi-carrier GSM receiver.

Port of the uplink half of `openbts_ttsou_tpu/models/transceiver.py`:

  device-rate IQ → polyphase 65/96 (CUDA kernel K1) → slot windows →
  energy/TSC/RACH detect → demod/equalize → soft bits

with the reference's exact per-frame semantics (pullRadioVector,
Transceiver.cpp:268-408). One `Transceiver` owns the `TrxState`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from openbts_ttsou_tpu_torch.ops import correlate as xcorr
from openbts_ttsou_tpu_torch.ops import dfe as dfe_mod
from openbts_ttsou_tpu_torch.ops import fir
from openbts_ttsou_tpu_torch.ops import gmsk as gmsk_mod
from openbts_ttsou_tpu_torch.trx import engine as eng
from openbts_ttsou_tpu_torch.utils.gsm_time import (FRAME_SYMBOLS,
                                                    HYPERFRAME,
                                                    SLOT_SAMPLE_PATTERN,
                                                    fn_delta)


class UplinkSpec(NamedTuple):
    """Static geometry of one uplink processing block."""

    frames: int = 13  # 13 frames → integral 65/96 resampling (60 ms)
    p: int = 65
    q: int = 96
    taps: int = 961

    @property
    def block_symbols(self) -> int:
        return self.frames * FRAME_SYMBOLS

    @property
    def block_in(self) -> int:
        assert (self.block_symbols * self.q) % self.p == 0
        return self.block_symbols * self.q // self.p


#: carrier count at or below which the block runs the batched exact
#: schedule (`process_block_exact`); above it, the per-frame `rx_step`
#: loop. Both compute the same exact semantics; the boundary is the JAX
#: package's, kept until H100 measurements choose one.
EXACT_BATCH_MAX_CHAN = 128


def _slot_windows(symbols: torch.Tensor, frames: int) -> torch.Tensor:
    """[C, frames·1250] symbol-rate stream → [frames, C, 8, 157] slot
    windows along the 157/156/156/156 framing
    (Transceiver52M/radioInterface.cpp:270-292). Indices past the end of
    the stream clamp to its last sample."""
    offs = np.concatenate([[0], np.cumsum(SLOT_SAMPLE_PATTERN)])[:-1]
    starts = np.arange(frames)[:, None] * FRAME_SYMBOLS + offs[None, :]
    idx = starts[..., None] + np.arange(eng.SLOT_SAMPLES)  # [F, 8, 157]
    idx = np.minimum(idx, symbols.shape[-1] - 1)
    win = symbols[:, torch.from_numpy(idx).to(symbols.device)]
    return win.movedim(0, 1)


def process_block_frames(cfg: eng.TrxConfig, frames: int,
                         state: eng.TrxState, sym: torch.Tensor
                         ) -> tuple[eng.TrxState, eng.RxResult]:
    """Exact-semantics block receiver, frame by frame: `eng.rx_step` over
    the window's frames (the JAX package's `lax.scan` of rx_step)."""
    wins = _slot_windows(sym, frames)
    results = []
    for f in range(frames):
        state, res = eng.rx_step(cfg, state, wins[f])
        results.append(res)
    return state, eng.RxResult(*(torch.stack(f) for f in zip(*results)))


def _exact_rx(cfg: eng.TrxConfig, frames: int, state: eng.TrxState,
              sym: torch.Tensor) -> tuple[eng.TrxState, eng.RxResult]:
    """Exact-semantics window receiver; the schedule follows
    EXACT_BATCH_MAX_CHAN."""
    if cfg.n_chan <= EXACT_BATCH_MAX_CHAN:
        return process_block_exact(cfg, frames, state, sym)
    return process_block_frames(cfg, frames, state, sym)


def uplink_block(cfg: eng.TrxConfig, spec: UplinkSpec, state: eng.TrxState,
                 samples: torch.Tensor) -> tuple[eng.TrxState, eng.RxResult]:
    """Process one device-rate block for all channels.

    samples: [C, spec.block_in] complex64 at the 400 kS/s device rate, on
    the state's device. Returns per-frame results stacked
    [frames, C, 8, ...] with the reference's exact per-frame semantics."""
    lpf = fir.resampler_lpf(spec.p, spec.q, spec.taps)
    sym = fir.polyphase_resample(samples, spec.p, spec.q, lpf)
    return _exact_rx(cfg, spec.frames, state,
                     sym[..., : spec.block_symbols])


def process_block_exact(cfg: eng.TrxConfig, frames: int,
                        state: eng.TrxState, sym: torch.Tensor
                        ) -> tuple[eng.TrxState, eng.RxResult]:
    """Exact-semantics block receiver at block-batched sizes.

    Semantically identical to running `eng.rx_step` frame by frame: the
    threshold-independent work (correlators, channel estimation, DFE
    design, demodulation, equalizer) runs once over all frames·C·8
    bursts, and only the sequential recurrences (per-slot threshold
    walk, energy gate against the running threshold, channel/DFE
    adoption, Transceiver.cpp:294-375) run frame by frame on [C, 8]
    tensors. Per-burst equalizer weights and the final state select the
    last adoption at or before each frame, or the entry state.
    """
    c, sps = cfg.n_chan, cfg.sps
    f = frames
    dev = sym.device
    wins = _slot_windows(sym, f)  # [F, C, 8, T]
    bursts = wins.reshape((-1, wins.shape[-1]))  # [F·C·8, T]
    fn0 = state.fn
    fns = (fn0 + torch.arange(f, dtype=torch.int32, device=dev)) % HYPERFRAME

    corr_type = eng.expected_corr_type(state.chan_type, fns[:, None, None])
    active = ((corr_type == eng.CorrType.TSC)
              | (corr_type == eng.CorrType.RACH)) \
        & eng.rach_allowed_mask(cfg, corr_type)
    is_tsc = corr_type == eng.CorrType.TSC  # [F, C, 8]
    is_rach = corr_type == eng.CorrType.RACH
    ts_flat = is_tsc.reshape(-1)
    ra_flat = is_rach.reshape(-1)

    # raw per-burst energy once; the walk compares it with the running
    # threshold (energyDetect gate, cpp:292-303)
    _, energy = xcorr.energy_detect(bursts, 20 * sps, 0.0)
    energy = energy.reshape(f, c, 8)

    need_dfe = state.max_expected_delay > 1  # [C]
    # estimation gate: an upper bound on "some frame wants an estimate"
    # that needs no threshold walk (staleness is monotone, and a
    # mid-window validity clear needs a TSC burst in the window)
    stale_ub = fn_delta(fns[-1], state.chan_estimate_fn) > 50  # [C,8]
    # host sync: the estimation/DFE-design gate
    gate_est = bool((need_dfe[:, None] & (stale_ub | ~state.chan_valid
                                          | is_tsc.any(0))).any())

    tsc_flat = state.tsc.repeat_interleave(8).repeat(f)
    det_tsc, chan_est, chan_off = xcorr.analyze_traffic_burst(
        bursts, tsc_flat, sps, threshold=cfg.tsc_threshold,
        estimate_channel=True, max_toa=cfg.max_toa,
        gate_estimation=gate_est)
    det_rach = eng._detect_rach_slots(
        wins.reshape(f * c, 8, wins.shape[-1]), sps, cfg.rach_threshold,
        cfg.rach_slots)

    # type dispatch + TOA acceptance: the threshold-independent part of
    # `success`; the energy gate joins in the walk
    no = torch.zeros_like(ts_flat)
    det_any = torch.where(ts_flat, det_tsc.detected,
                          torch.where(ra_flat, det_rach.detected, no))
    med = (state.max_expected_delay.repeat_interleave(8).repeat(f)
           .to(torch.float32) * sps)
    det_any = det_any & torch.where(ra_flat & (med > 0),
                                    det_rach.toa <= med, ~no)
    tsc_bound = torch.clamp(med, min=3.0 * sps)
    det_any = det_any & torch.where(
        ts_flat, (det_tsc.toa <= tsc_bound) & (det_tsc.toa >= -tsc_bound),
        ~no)
    amplitude = torch.where(ts_flat, det_tsc.amplitude, det_rach.amplitude)
    toa = torch.where(ts_flat, det_tsc.toa, det_rach.toa)

    # ---- the light sequential walk: threshold + adoption -------------
    thr = state.energy_threshold
    prev_false = state.prev_false_detect_fn
    valid = state.chan_valid
    est_fn = state.chan_estimate_fn
    last = torch.full((c, 8), -1, dtype=torch.int32, device=dev)
    d_raw_all = det_tsc.detected.reshape(f, c, 8)
    d_ok_all = det_any.reshape(f, c, 8)
    success_s, valid_post_s, last_post_s, thr_entry_s = [], [], [], []
    for i in range(f):
        fn_i, act_i, tsc_i = fns[i], active[i], is_tsc[i]
        thr_entry_s.append(thr)
        gate = (energy[i] > (thr * thr)[:, None]) & act_i
        success = gate & d_ok_all[i]
        want = ((fn_delta(fn_i, est_fn) > 50) | ~valid) & need_dfe[:, None]
        do_est = want & tsc_i & success
        valid = torch.where(do_est, True,
                            valid & ~(~d_raw_all[i] & tsc_i & gate))
        est_fn = torch.where(do_est, fn_i, est_fn)
        last = torch.where(do_est, i, last)
        thr, prev_false = eng.threshold_walk(fn_i, thr, prev_false, act_i,
                                             gate, success)
        success_s.append(success)
        valid_post_s.append(valid)
        last_post_s.append(last)
    success = torch.stack(success_s).reshape(-1)  # [F·C·8]

    # ---- estimation candidates + DFE design (batched, gated) ---------
    n = f * c * 8
    thr_b = torch.stack(thr_entry_s).repeat_interleave(8, dim=-1).reshape(-1)
    new_snr_all = amplitude.abs() ** 2 / (thr_b * thr_b + 1.0)
    amp_safe = torch.where(amplitude == 0, torch.ones_like(amplitude),
                           amplitude)
    chan_norm_all = chan_est / amp_safe[:, None]
    dfe_chan_all = chan_norm_all[..., ::sps] if sps > 1 else chan_norm_all
    if gate_est:  # the same host-synced gate as above
        w_all, b_all = dfe_mod.design_dfe(
            dfe_chan_all, torch.clamp(new_snr_all, min=1e-6), eng.DFE_NF)
    else:
        w_all = torch.zeros((n, eng.DFE_NF), dtype=torch.complex64,
                            device=dev)
        b_all = torch.zeros((n, eng.CHAN_TAPS - 1), dtype=torch.complex64,
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
    pick_post = torch.stack(last_post_s).reshape(f, c8) + 1  # [F, C8]
    w_sel = sel(cands(state.dfe_forward, w_all), pick_post
                ).reshape(n, eng.DFE_NF)
    b_sel = sel(cands(state.dfe_feedback, b_all), pick_post
                ).reshape(n, eng.CHAN_TAPS - 1)
    off_sel = sel(cands(state.chan_resp_offset, chan_off), pick_post
                  ).reshape(n)

    use_dfe = (ts_flat & need_dfe.repeat_interleave(8).repeat(f)
               & torch.stack(valid_post_s).reshape(-1))
    k = 148

    # ---- demod + equalizer (batched, equalizer gated) ----------------
    soft_plain = gmsk_mod.demodulate_burst(bursts, sps, amplitude, toa)
    # host sync: the equalizer runs only when some burst needs it
    if bool(use_dfe.any()):
        soft_eq = dfe_mod.equalize_burst(bursts / amp_safe[:, None],
                                         toa - off_sel, sps, w_sel,
                                         b_sel)[:, :k]
        soft = torch.where(use_dfe[:, None], soft_eq, soft_plain[:, :k])
    else:
        soft = soft_plain[:, :k]
    soft = torch.where(success[:, None], soft, 0.5)
    rssi, timing = eng.rssi_timing(cfg, amplitude, toa)

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
    res = eng.RxResult(
        detected=success.reshape(f, c, 8),
        is_rach=(success & ra_flat).reshape(f, c, 8),
        soft_bits=soft.reshape(f, c, 8, k),
        rssi=rssi.reshape(f, c, 8),
        timing=timing.reshape(f, c, 8),
    )
    return new_state, res


class Transceiver:
    """Stateful wrapper (the `Transceiver` object of
    Transceiver52M/Transceiver.h:44, minus the threads), receive side."""

    def __init__(self, cfg: eng.TrxConfig = eng.TrxConfig(),
                 spec: UplinkSpec = UplinkSpec(), device="cuda"):
        self.cfg = cfg
        self.spec = spec
        self.device = eng.resolve_device(device)
        self.state = eng.init_state(cfg, self.device)

    # -- control verbs (driveControl, Transceiver.cpp:423-569) ---------
    def set_slot(self, chan: int, tn: int, combo: int) -> None:
        ct = self.state.chan_type.clone()
        ct[chan, tn] = combo
        self.state = self.state._replace(chan_type=ct)

    def set_tsc(self, chan: int, tsc: int) -> None:
        t = self.state.tsc.clone()
        t[chan] = tsc
        self.state = self.state._replace(tsc=t)

    def set_max_delay(self, chan: int, delay: int) -> None:
        d = self.state.max_expected_delay.clone()
        d[chan] = delay
        self.state = self.state._replace(max_expected_delay=d)

    # -- data plane ----------------------------------------------------
    def process_uplink(self, samples) -> eng.RxResult:
        samples = torch.as_tensor(samples, device=self.device)
        self.state, res = uplink_block(self.cfg, self.spec, self.state,
                                       samples.contiguous())
        return res

    def rx_frame(self, frame) -> eng.RxResult:
        frame = torch.as_tensor(frame, device=self.device)
        self.state, res = eng.rx_step(self.cfg, self.state, frame)
        return res
