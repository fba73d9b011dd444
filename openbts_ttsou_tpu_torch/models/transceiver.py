"""The flagship model: a complete multi-carrier GSM transceiver.

Port of `openbts_ttsou_tpu/models/transceiver.py` (all but the FEC
models):

  uplink:   device-rate IQ → polyphase 65/96 (CUDA kernel K1) → slot
            windows → energy/TSC/RACH detect → demod/equalize → soft bits
  downlink: burst bits → GMSK modulate (+filler fallback) → polyphase
            96/65 (K1) → device-rate IQ

with the reference's exact per-frame semantics (pullRadioVector,
Transceiver.cpp:268-408; driveTransmitFIFO, :672-722), and the streaming
duplex block the wire daemon runs: both directions of one 13-frame window
with exact stream continuity across blocks, its results packed for the
UDP data plane on the device. One `Transceiver` owns the `TrxState`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from openbts_ttsou_tpu_torch.ops import correlate as xcorr
from openbts_ttsou_tpu_torch.ops import dfe as dfe_mod
from openbts_ttsou_tpu_torch.ops import fir
from openbts_ttsou_tpu_torch.ops import gmsk as gmsk_mod
from openbts_ttsou_tpu_torch.parallel.halo import resample_block
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


def _assemble_stream(slots: torch.Tensor) -> torch.Tensor:
    """[frames, C, 8, 157] slot windows → [C, frames·1250] stream, slots
    laid at the 157/156/156/156 offsets. A 156-sample slot's window
    overlaps the next slot by its last sample, which `eng.tx_frames` and
    the filler table leave zero, so the scatter-add's collisions (and the
    clamped overflow index) add only +0: the result is exact in any
    order of adds."""
    frames, c = slots.shape[0], slots.shape[1]
    offs = np.concatenate([[0], np.cumsum(SLOT_SAMPLE_PATTERN)])[:-1]
    idx = (np.arange(frames)[:, None, None] * FRAME_SYMBOLS
           + offs[None, :, None] + np.arange(eng.SLOT_SAMPLES)[None, None, :])
    idx = np.minimum(idx, frames * FRAME_SYMBOLS)
    flat_idx = torch.from_numpy(idx.reshape(-1)).to(slots.device)
    vals = slots.movedim(1, 0).reshape(c, -1)
    out = torch.zeros((c, frames * FRAME_SYMBOLS + 1, 2),
                      dtype=torch.float32, device=slots.device)
    # on float planes: index_add_ of complex tensors is not on every
    # backend
    out.index_add_(1, flat_idx, torch.view_as_real(vals.contiguous()))
    return torch.view_as_complex(out[:, :-1].contiguous())


def downlink_block(cfg: eng.TrxConfig, spec: UplinkSpec, state: eng.TrxState,
                   bits: torch.Tensor, valid: torch.Tensor,
                   atten_db: torch.Tensor, fn0=None) -> torch.Tensor:
    """Modulate `frames` downlink frames and resample to device rate.

    bits: [frames, C, 8, 148]; valid/atten_db: [frames, C, 8]. Returns
    [C, spec.block_in] device-rate samples (driveTransmitFIFO →
    pushBuffer, Transceiver.cpp:672-722, radioInterface.cpp:123-186).
    fn0 is unused: the stream layout is frame-indexed."""
    del fn0
    slots = eng.tx_frames(cfg, state, bits, valid, atten_db)
    sym = _assemble_stream(slots)
    lpf = fir.resampler_lpf(spec.q, spec.p, 651)
    out = fir.polyphase_resample(sym, spec.q, spec.p, lpf)
    return out[..., : spec.block_in]


# Streaming-duplex halo geometry. The 961-tap 65/96 rx resampler reads
# ±⌈960/130⌉ = 8 device samples around each symbol, rounded to one
# 96-sample polyphase period a side; the 651-tap 96/65 tx resampler
# reads ±⌈650/192⌉ = 4 symbols, rounded to one 65-symbol period and
# carried as a 2×65-symbol left history (the reference's
# sendHistory/rcvHistory INHISTORY=130/OUTHISTORY=192 buffers,
# Transceiver/radioInterface.h:35-41, radioInterface.cpp:123-260).
RX_HALO_DEV = 96
TX_TAIL_SYM = 130
TX_DELAY_DEV = (TX_TAIL_SYM // 2) * 96 // 65  # 96 device samples


class WireBlock(NamedTuple):
    """One block's uplink results quantized for the UDP data plane
    (driveReceiveFIFO serialization, Transceiver.cpp:652-667)."""

    detected: torch.Tensor  # [F, C, 8] bool
    soft_u8: torch.Tensor  # [F, C, 8, 148] uint8, soft bits ×255
    rssi: torch.Tensor  # [F, C, 8] int32
    timing: torch.Tensor  # [F, C, 8] int32 (1/256 symbol)


def duplex_block_wire(cfg: eng.TrxConfig, spec: UplinkSpec,
                      state: eng.TrxState, ul_halo: torch.Tensor,
                      tx_tail: torch.Tensor, dl_bits: torch.Tensor,
                      dl_valid: torch.Tensor, dl_atten: torch.Tensor,
                      tx_fn0=None, io_i16: bool = False
                      ) -> tuple[eng.TrxState, torch.Tensor, torch.Tensor,
                                 WireBlock]:
    """One streaming-duplex block: modulate and 96/65-resample the
    downlink window, and detect and demodulate the uplink window, with
    exact stream continuity across blocks.

    ul_halo: [C, RX_HALO_DEV + block_in + RX_HALO_DEV] device-rate rx
             samples (one polyphase period of past and future stream),
             complex64, or int16 I/Q pairs [C, T, 2] with io_i16;
    tx_tail: [C, TX_TAIL_SYM], the previous block's last modulated
             symbols (zeros on the first block);
    dl_bits/dl_valid/dl_atten: [frames, C, 8, ...] downlink window.

    Returns (state', tx [C, block_in], tx_tail', WireBlock). The tx
    samples start TX_DELAY_DEV device samples early (the filter delay the
    reference absorbs in its history buffers); the daemon writes them at
    ts − TX_DELAY_DEV. With io_i16 the tx leaves as int16 I/Q pairs
    [C, block_in, 2], rounded half to even and clipped like
    USRPifyVector (radioInterface.cpp:101-146). tx_fn0 is unused. K1
    runs twice: 96/65 on the [C, 130 + frames·1250] tx stream and 65/96
    on the [C, 2·96 + block_in] rx window."""
    del tx_fn0
    if io_i16:
        ul_halo = torch.complex(ul_halo[..., 0].to(torch.float32),
                                ul_halo[..., 1].to(torch.float32))
    frames = spec.frames

    # ---- downlink (driveTransmitFIFO → pushBuffer) --------------------
    slots = eng.tx_frames(cfg, state, dl_bits, dl_valid, dl_atten)
    sym = _assemble_stream(slots)  # [C, frames·1250]
    stream = torch.cat([tx_tail.to(sym.dtype), sym], -1)
    lpf_tx = fir.resampler_lpf(spec.q, spec.p, 651)
    y = fir.polyphase_resample(stream, spec.q, spec.p, lpf_tx)
    tx = y[..., TX_DELAY_DEV: TX_DELAY_DEV + spec.block_in]
    if io_i16:  # DAC format
        tx = torch.stack([tx.real, tx.imag], -1)
        tx = torch.clamp(torch.round(tx), -32767.0, 32767.0).to(torch.int16)
    new_tail = sym[..., -TX_TAIL_SYM:].contiguous()

    # ---- uplink (pullBuffer → detection/demod) ------------------------
    lpf_rx = fir.resampler_lpf(spec.p, spec.q, spec.taps)
    sym_ul = resample_block(ul_halo.contiguous(), spec.p, spec.q, lpf_rx,
                            RX_HALO_DEV, spec.block_in)
    state2, res = _exact_rx(cfg, frames, state,
                            sym_ul[..., : spec.block_symbols])
    soft_u8 = torch.clamp(torch.round(res.soft_bits * 255.0), 0.0, 255.0
                          ).to(torch.uint8)
    wire = WireBlock(res.detected, soft_u8, res.rssi, res.timing)
    return state2, tx, new_tail, wire


# ---------------------------------------------------------------------------
# single-buffer block I/O: the duplex block crosses the host boundary as
# one uint8 buffer each way, and the uplink datagrams are built on the
# device in the reference's wire format
# ---------------------------------------------------------------------------

DL_ROW = 150  # per-(frame, chan, slot): 148 bit-bytes + valid + gain
UL_PKT = 158  # uplink datagram (protocol.UPLINK_LEN)
PACK_HDR = 8  # fn0 (4 bytes BE) + tx_fn0 (4 bytes BE)


def pack_dl_buffer(bits: np.ndarray, valid: np.ndarray, gain: np.ndarray,
                   fn0: int, tx_fn0: int,
                   ul_i16: np.ndarray | None = None) -> np.ndarray:
    """Host side: dense downlink window (and optionally the uplink int16
    samples) → one uint8 buffer.

    bits [F, C, 8, 148] uint8, valid [F, C, 8] bool, gain [F, C, 8]
    (the wire's attenuation byte, driveTransmitPriorityQueue); ul_i16
    int16 [C, T, 2] ADC samples appended as raw little-endian bytes."""
    f, c = bits.shape[0], bits.shape[1]
    body = np.empty((f, c, 8, DL_ROW), np.uint8)
    body[..., :148] = bits
    body[..., 148] = valid
    body[..., 149] = np.asarray(gain, np.int64) & 0xFF
    hdr = np.frombuffer(np.array([fn0, tx_fn0], ">u4").tobytes(), np.uint8)
    parts = [hdr, body.reshape(-1)]
    if ul_i16 is not None:
        parts.append(np.ascontiguousarray(ul_i16, "<i2")
                     .view(np.uint8).reshape(-1))
    return np.concatenate(parts)


def _be32(x: torch.Tensor) -> torch.Tensor:
    """int32 [...] → big-endian bytes [..., 4] uint8."""
    return torch.stack([(x >> s) & 0xFF for s in (24, 16, 8, 0)], -1
                       ).to(torch.uint8)


def duplex_block_packed(cfg: eng.TrxConfig, spec: UplinkSpec,
                        state: eng.TrxState, io_buf: torch.Tensor,
                        tx_tail: torch.Tensor
                        ) -> tuple[eng.TrxState, torch.Tensor, torch.Tensor]:
    """`duplex_block_wire` with single-buffer I/O both ways. io_buf is
    the 1-D uint8 buffer of `pack_dl_buffer(..., ul_i16=...)`: header,
    downlink window and uplink int16 ADC bytes. fn0 and tx_fn0 are
    decoded on the device (no host sync). Returns (state', tx_tail', out)
    with `out` a 1-D uint8 buffer laid out as
      [C·block_in·4]   tx int16 I/Q bytes (DAC format)
      [F·C·8·UL_PKT]   ready-to-send uplink datagrams
      [F·C·8]          detection mask bytes
    parsed on the host with `unpack_block_result`."""
    f, c = spec.frames, cfg.n_chan
    hdr = io_buf[:PACK_HDR].to(torch.int32)
    fn0 = (hdr[0] << 24) | (hdr[1] << 16) | (hdr[2] << 8) | hdr[3]
    tx_fn0 = (hdr[4] << 24) | (hdr[5] << 16) | (hdr[6] << 8) | hdr[7]
    dl_end = PACK_HDR + f * c * 8 * DL_ROW
    body = io_buf[PACK_HDR:dl_end].reshape(f, c, 8, DL_ROW)
    bits = body[..., :148]
    valid = body[..., 148] > 0
    atten = body[..., 149].to(torch.float32)
    t_halo = spec.block_in + 2 * RX_HALO_DEV
    # little-endian int16 on host and card alike; dl_end is even, so the
    # slice keeps the 2-byte alignment `view` needs
    ul_i16 = io_buf[dl_end: dl_end + c * t_halo * 4].view(
        torch.int16).reshape(c, t_halo, 2)
    state = state._replace(fn=fn0)
    state2, tx, tail2, wire = duplex_block_wire(
        cfg, spec, state, ul_i16, tx_tail, bits, valid, atten, tx_fn0,
        io_i16=True)

    # device-side datagram assembly, the bytes of protocol.pack_uplink
    # (driveReceiveFIFO serialization, Transceiver.cpp:652-667)
    dev = io_buf.device
    fns = (fn0 + torch.arange(f, dtype=torch.int32, device=dev)) % HYPERFRAME
    fnb = _be32(fns)[:, None, None, :].expand(f, c, 8, 4)
    tnb = torch.arange(8, dtype=torch.uint8, device=dev
                       )[None, None, :, None].expand(f, c, 8, 1)
    rssib = (wire.rssi & 0xFF).to(torch.uint8)[..., None]
    toa_u = wire.timing & 0xFFFF  # two's complement of a negative TOA
    toab = torch.stack([(toa_u >> 8) & 0xFF, toa_u & 0xFF], -1
                       ).to(torch.uint8)
    nul = torch.zeros((f, c, 8, 2), dtype=torch.uint8, device=dev)
    pkts = torch.cat([tnb, fnb, rssib, toab, wire.soft_u8, nul], -1)

    out = torch.cat([tx.view(torch.uint8).reshape(-1), pkts.reshape(-1),
                     wire.detected.to(torch.uint8).reshape(-1)])
    return state2, tail2, out


UL_PKT_C = UL_PKT + 2  # packed uplink row: datagram + carrier index


def duplex_block_compact(cfg: eng.TrxConfig, spec: UplinkSpec,
                         state: eng.TrxState, io_buf: torch.Tensor,
                         tx_tail: torch.Tensor
                         ) -> tuple[eng.TrxState, torch.Tensor, torch.Tensor,
                                    torch.Tensor, torch.Tensor]:
    """`duplex_block_packed` with the results compacted on the device,
    so the host fetches only the datagrams of detected bursts and the
    DAC rows of live carriers.

    io_buf is `pack_dl_buffer_live(...)`: `pack_dl_buffer` plus a
    trailing [C] live-carrier mask. Returns (state', tx_tail', hdr,
    tx_buf, pkt_buf):

      hdr     [8]                  uint8: n_det (BE32), n_live (BE32)
      tx_buf  [C+1, block_in·4]    DAC rows of the live carriers,
                                   prefix-packed (row C is the drop slot)
      pkt_buf [F·C·8+1, UL_PKT_C]  datagram + 2-byte carrier index of the
                                   detected rows, prefix-packed (row
                                   F·C·8 is the drop slot)

    Only tx_buf[:n_live] and pkt_buf[:n_det] are defined: every dropped
    row lands in its drop slot, and which of them stays there is
    unspecified. The row positions come from a cumulative sum on the
    device, so nothing syncs the host. A carrier whose window and
    previous window are all filler transmits the host's cached filler
    block (the filler table is one constant pattern, Transceiver.cpp:
    69-85). driveReceiveFIFO, too, serializes only detected bursts
    (Transceiver.cpp:652-667)."""
    f, c = spec.frames, cfg.n_chan
    body_end = PACK_HDR + f * c * 8 * DL_ROW
    t_halo = spec.block_in + 2 * RX_HALO_DEV
    ul_end = body_end + c * t_halo * 4
    live = io_buf[ul_end: ul_end + c] > 0  # [C]
    dev = io_buf.device

    state2, tail2, out = duplex_block_packed(cfg, spec, state, io_buf,
                                             tx_tail)
    a = c * spec.block_in * 4
    b = a + f * c * 8 * UL_PKT
    tx_rows = out[:a].reshape(c, spec.block_in * 4)
    pkt_rows = out[a:b].reshape(f * c * 8, UL_PKT)
    det = out[b:] > 0  # [F·C·8]

    # carrier index of each flattened (f, c, tn) row, as 2 BE bytes
    chan_idx = torch.arange(c, dtype=torch.int32, device=dev
                            ).repeat_interleave(8).repeat(f)
    chan_b = torch.stack([(chan_idx >> 8) & 0xFF, chan_idx & 0xFF], -1
                         ).to(torch.uint8)
    rows160 = torch.cat([pkt_rows, chan_b], -1)

    n_rows = f * c * 8
    pos = torch.where(det, torch.cumsum(det, 0) - 1, n_rows)
    pkt_buf = torch.zeros((n_rows + 1, UL_PKT_C), dtype=torch.uint8,
                          device=dev)
    pkt_buf[pos] = rows160

    lpos = torch.where(live, torch.cumsum(live, 0) - 1, c)
    tx_buf = torch.zeros((c + 1, spec.block_in * 4), dtype=torch.uint8,
                         device=dev)
    tx_buf[lpos] = tx_rows

    hdr = torch.cat([_be32(det.sum().to(torch.int32)),
                     _be32(live.sum().to(torch.int32))])
    return state2, tail2, hdr, tx_buf, pkt_buf


def pack_dl_buffer_live(bits: np.ndarray, valid: np.ndarray,
                        gain: np.ndarray, fn0: int, tx_fn0: int,
                        ul_i16: np.ndarray, live: np.ndarray) -> np.ndarray:
    """`pack_dl_buffer` + the [C] live-carrier mask that
    `duplex_block_compact` reads (a carrier is live unless its current
    and previous downlink windows were pure filler)."""
    base = pack_dl_buffer(bits, valid, gain, fn0, tx_fn0, ul_i16=ul_i16)
    return np.concatenate([base, np.asarray(live, np.uint8).reshape(-1)])


def unpack_block_result(out: np.ndarray, n_chan: int, spec: UplinkSpec
                        ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host side: one fetched uint8 buffer → (tx int16 [C, block_in, 2],
    datagrams [F, C, 8, UL_PKT], detected [F, C, 8] bool)."""
    f, c, t = spec.frames, n_chan, spec.block_in
    a = c * t * 4
    b = a + f * c * 8 * UL_PKT
    tx = out[:a].view("<i2").reshape(c, t, 2)
    pkts = out[a:b].reshape(f, c, 8, UL_PKT)
    det = out[b:].reshape(f, c, 8).astype(bool)
    return tx, pkts, det


class Transceiver:
    """Stateful wrapper (the `Transceiver` object of
    Transceiver52M/Transceiver.h:44, minus the threads)."""

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

    def tx_frame(self, bits, valid, atten_db) -> torch.Tensor:
        def dev(x):
            return torch.as_tensor(x, device=self.device)

        return eng.tx_step(self.cfg, self.state, dev(bits), dev(valid),
                           dev(atten_db), self.state.fn)
