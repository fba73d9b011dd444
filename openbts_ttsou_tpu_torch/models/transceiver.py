"""The flagship model: a complete multi-carrier GSM transceiver.

Port of `openbts_ttsou_tpu/models/transceiver.py`:

  uplink:   device-rate IQ → polyphase 65/96 (CUDA kernel K1) → slot
            windows → energy/TSC/RACH detect → demod/equalize → soft bits
            [→ FEC decode: XCCH, RACH, TCH/FS, FACCH]
  downlink: [L2 frames and vocoder bits → FEC encode →] burst bits →
            GMSK modulate (+filler fallback) → polyphase 96/65 (K1) →
            device-rate IQ

with the reference's exact per-frame semantics (pullRadioVector,
Transceiver.cpp:268-408; driveTransmitFIFO, :672-722); the streaming
duplex block the wire daemon runs: both directions of one 13-frame window
with exact stream continuity across blocks, its results packed for the
UDP data plane on the device; and `duplex_block_decoded`, the resident
BTS layer 1, where only L2 frames and vocoder bits cross the host
boundary (`models/resident.py` streams it). One `Transceiver` owns the
`TrxState`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from openbts_ttsou_tpu_torch.gsm import fec, l1fec
from openbts_ttsou_tpu_torch.gsm.tdma import FACCH_TCHF
from openbts_ttsou_tpu_torch.ops import fir
from openbts_ttsou_tpu_torch.parallel.halo import resample_block
from openbts_ttsou_tpu_torch.trx import engine as eng
from openbts_ttsou_tpu_torch.utils.gsm_time import (FRAME_SYMBOLS,
                                                    HYPERFRAME,
                                                    SLOT_SAMPLE_PATTERN)
from openbts_ttsou_tpu_torch.utils.profiling import span
from openbts_ttsou_tpu_torch.utils.tables import (copy_table, device_table,
                                                  row_at)


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
#: schedule (`process_block_exact`: `eng.rx_frames` over the window);
#: above it, the per-frame `rx_step` loop (the same receiver a frame at
#: a time). `exact_schedule` is the one reader. Measured with `tools/exact_bakeoff` (one 13-frame block
#: from one entry state, results equal) on an H100 80GB HBM3 at 700 W in
#: two calls: at 128, 256, 512, 1024 and 2048 carriers the batched
#: schedule took 57.2, 51.6, 51.5, 59.2, 77.3 ms and 47.8, 43.2, 39.3,
#: 59.7, 71.9 ms against the loop's 201.1, 237.7, 267.1, 226.3, 252.6 ms
#: and 154.3, 165.7, 208.1, 205.0, 219.0 ms. Its memory peak grows with
#: the carriers, 0.75, 1.50, 2.99, 5.98 and 11.96 GiB (the loop's 0.11 to
#: 1.75), so the loop stays above 2048: at 4096 the batched peak would
#: pass a quarter of the card's 80 GB.
EXACT_BATCH_MAX_CHAN = 2048


def _slot_windows(symbols: torch.Tensor, frames: int) -> torch.Tensor:
    """[C, frames·1250] symbol-rate stream → [frames, C, 8, 157] slot
    windows along the 157/156/156/156 framing
    (Transceiver52M/radioInterface.cpp:270-292). Indices past the end of
    the stream clamp to its last sample."""
    offs = np.concatenate([[0], np.cumsum(SLOT_SAMPLE_PATTERN)])[:-1]
    starts = np.arange(frames)[:, None] * FRAME_SYMBOLS + offs[None, :]
    idx = starts[..., None] + np.arange(eng.SLOT_SAMPLES)  # [F, 8, 157]
    idx = np.minimum(idx, symbols.shape[-1] - 1)
    win = symbols[:, copy_table(idx, symbols.device)]
    return win.movedim(0, 1)


def process_block_frames(cfg: eng.TrxConfig, frames: int,
                         state: eng.TrxState, sym: torch.Tensor
                         ) -> tuple[eng.TrxState, eng.RxResult]:
    """Exact-semantics block receiver, frame by frame: `eng.rx_step` over
    the window's frames (the JAX package's `lax.scan` of rx_step)."""
    wins = _slot_windows(sym, frames)
    results = []
    for f in range(frames):
        with span("rx.frame"):
            state, res = eng.rx_step(cfg, state, wins[f])
        results.append(res)
    return state, eng.RxResult(*(torch.stack(f) for f in zip(*results)))


def exact_schedule(n_chan: int) -> str:
    """The exact receiver's schedule at `n_chan` carriers: "batched"
    (`process_block_exact`) or "frames" (`process_block_frames`)."""
    return "batched" if n_chan <= EXACT_BATCH_MAX_CHAN else "frames"


def _exact_rx(cfg: eng.TrxConfig, frames: int, state: eng.TrxState,
              sym: torch.Tensor) -> tuple[eng.TrxState, eng.RxResult]:
    """Exact-semantics window receiver; the schedule follows
    EXACT_BATCH_MAX_CHAN."""
    with span("rx.exact"):
        if exact_schedule(cfg.n_chan) == "batched":
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
    """Exact-semantics block receiver at block-batched sizes:
    `eng.rx_frames` over the window's slot windows at once."""
    return eng.rx_frames(cfg, state, _slot_windows(sym, frames))


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
    flat_idx = copy_table(idx.reshape(-1), slots.device)
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


# ---------------------------------------------------------------------------
# the resident layer 1: FEC decode of the uplink, FEC encode of the
# downlink, and both in one duplex block
# ---------------------------------------------------------------------------

class DecodedBlocks(NamedTuple):
    """FEC output for one uplink block: XCCH blocks fully contained in
    the window (`bits` [G, C, 8, 184] uint8 in air bit order, `ok`
    [G, C, 8] bool FireCode syndrome, `first_fn` [] int32, the FN of
    group 0's first burst), per-frame RACH decodes (`rach_ra` [F, C, 8]
    int32, `rach_ok` [F, C, 8] bool: RA value and color-code check where
    a RACH was detected), and TCH/FS + FACCH 8-burst diagonal half-blocks
    completing inside the window (TCHFACCHL1Decoder, GSML1FEC.cpp:
    1031-1175): `tch_speech` [Gt, C, 8, 260] uint8 coder-order vocoder
    frames, `tch_good` [Gt, C, 8] (class-1a parity + tail, and not
    stolen), `facch_bits` [Gt, C, 8, 184] air-order FACCH frames with
    `facch_ok` (FireCode, and stolen), `tch_stolen` [Gt, C, 8] (the
    completing burst's Hl flag), `tch_end_fn` [Gt] int32 FN of each
    group's completing burst (−1 where `tch_valid` is False: the window
    held no such group)."""

    bits: torch.Tensor
    ok: torch.Tensor
    first_fn: torch.Tensor
    rach_ra: torch.Tensor
    rach_ok: torch.Tensor
    tch_speech: torch.Tensor
    tch_good: torch.Tensor
    facch_bits: torch.Tensor
    facch_ok: torch.Tensor
    tch_stolen: torch.Tensor
    tch_end_fn: torch.Tensor
    tch_valid: torch.Tensor


def uplink_block_decoded(cfg: eng.TrxConfig, spec: UplinkSpec,
                         state: eng.TrxState, samples: torch.Tensor,
                         bsic: int = 0, xcch_tns: tuple | None = None,
                         tch_tns: tuple | None = None
                         ) -> tuple[eng.TrxState, eng.RxResult,
                                    DecodedBlocks]:
    """The resident receiver: device-rate IQ → detection/demod → FEC
    decode of the window's XCCH groups (the FN%4-aligned 4-burst blocks
    fully inside the window, GSML1FEC.cpp:572-630), RACH bursts and
    TCH/FACCH half-blocks, on the samples' device. The reference splits
    this at the UDP boundary (soft bits cross to the BTS process)."""
    fn0 = state.fn
    new_state, res = uplink_block(cfg, spec, state, samples)
    return new_state, res, decode_block(
        res, fn0, spec.frames, bsic, xcch_tns=xcch_tns, tch_tns=tch_tns,
        rach_tns=cfg.rach_slots)


@functools.lru_cache(maxsize=None)
def _tch_group_tables(frames: int):
    """Static TCH half-block geometry per window phase p = fn0 % 26.

    The TCH/F 26-multiframe (GSMTDMA.cpp:245-270) skips fn%26 ∈ {12, 25}
    (SACCH/idle); the diagonal burst index B = reverseMapping(fn) % 8 is
    continuous across repeats (24 ≡ 0 mod 8). A half-block completes at
    every burst with B % 4 == 3 whose 7 predecessors are also inside the
    window (TCHFACCHL1Decoder::processBurst, GSML1FEC.cpp:1051-1068).

    Returns (frame_idx [26, Gt, 8], end_frame [26, Gt], valid [26, Gt]).
    """
    rev = FACCH_TCHF.reverse_map()  # [26], −1 on SACCH/idle
    per_phase = []
    gmax = 1
    for p in range(26):
        tch = [(f, int(rev[(p + f) % 26]) % 8) for f in range(frames)
               if rev[(p + f) % 26] >= 0]
        groups = [([tch[i - 7 + j][0] for j in range(8)], f)
                  for i, (f, b) in enumerate(tch)
                  if b % 4 == 3 and i >= 7]
        per_phase.append(groups)
        gmax = max(gmax, len(groups))
    idx = np.zeros((26, gmax, 8), np.int32)
    end = np.zeros((26, gmax), np.int32)
    valid = np.zeros((26, gmax), bool)
    for p, groups in enumerate(per_phase):
        for g, (fr, f_end) in enumerate(groups):
            idx[p, g], end[p, g], valid[p, g] = fr, f_end, True
    return idx, end, valid


def _tch_group_table(frames: int, k: int) -> np.ndarray:
    t = _tch_group_tables(frames)[k]
    return t if t.dtype == bool else t.astype(np.int64)


#: frames of previous-window soft bits carried by the streaming decoder:
#: a TCH 8-burst diagonal can reach 8 frames back (8 bursts spanning one
#: idle frame); XCCH groups need at most 3
DECODE_PRELUDE = 8


def _tns_index(tns: tuple) -> np.ndarray:
    return np.asarray(tns, np.int64)


def _sub_tns(x: torch.Tensor, tns: tuple, axis: int) -> torch.Tensor:
    """The static TN subset `tns` of axis `axis`."""
    return x.index_select(axis, device_table(_tns_index, (tuple(tns),),
                                             x.device))


def _back_tns(x: torch.Tensor, tns: tuple, axis: int,
              fill=0) -> torch.Tensor:
    """Scatter a TN-subset result back into the full 8-slot lane
    (non-configured slots report `fill`; the host demux never reads them,
    as TRXManager's per-(TN, FN) demux table does not)."""
    full = list(x.shape)
    full[axis] = 8
    out = torch.full(full, fill, dtype=x.dtype, device=x.device)
    return out.index_copy_(axis, device_table(_tns_index, (tuple(tns),),
                                              x.device), x)



def _rep4(x: torch.Tensor) -> torch.Tensor:
    """Repeat each entry of axis 0 four times (a group → its 4 bursts)."""
    return x.unsqueeze(1).expand((x.shape[0], 4) + x.shape[1:]).reshape(
        (x.shape[0] * 4,) + x.shape[1:])


def _fn_tensor(fn, device) -> torch.Tensor:
    """A frame number as an int64 0-d tensor on `device` (a Python int
    becomes a fill, not a host-to-device copy)."""
    if isinstance(fn, torch.Tensor):
        return fn.to(device=device, dtype=torch.int64)
    return torch.full((), int(fn), dtype=torch.int64, device=device)


def uplink_block_decoded_stream(cfg: eng.TrxConfig, spec: UplinkSpec,
                                state: eng.TrxState, samples: torch.Tensor,
                                bsic: int, prev_soft: torch.Tensor,
                                prev_valid: torch.Tensor,
                                xcch_tns: tuple | None = None,
                                tch_tns: tuple | None = None):
    """Streaming resident receiver: like `uplink_block_decoded`, but FEC
    groups whose bursts span the window boundary decode too, by prepending
    the previous window's last DECODE_PRELUDE frames of soft bits (the
    reference's per-burst decoders never lose groups to windowing: mI[]
    persists across bursts, GSML1FEC.cpp:572-630, 1031-1100). Each group
    is decoded exactly once: only groups completing inside the new window
    are reported.

    prev_soft [DECODE_PRELUDE, C, 8, 148] (zeros on the first window),
    prev_valid [] bool (False on the first window: prelude-spanning
    groups are then masked out). Returns (state', res, blocks,
    prev_soft', prev_valid')."""
    fn0 = state.fn
    new_state, res = uplink_block(cfg, spec, state, samples)
    blocks = decode_block(res, fn0, spec.frames, bsic, prev_soft=prev_soft,
                          prev_valid=prev_valid, xcch_tns=xcch_tns,
                          tch_tns=tch_tns, rach_tns=cfg.rach_slots)
    return (new_state, res, blocks, res.soft_bits[-DECODE_PRELUDE:],
            torch.ones((), dtype=torch.bool, device=samples.device))


@span("fec.decode")
def decode_block(res: eng.RxResult, fn0, frames: int, bsic: int = 0,
                 prev_soft: torch.Tensor | None = None,
                 prev_valid: torch.Tensor | None = None,
                 xcch_tns: tuple | None = None,
                 tch_tns: tuple | None = None,
                 rach_tns: tuple | None = None) -> DecodedBlocks:
    """FEC-decode one block's RxResult on its device: the FN%4-aligned
    4-burst XCCH groups inside the window, per-frame RACH decode, and the
    TCH/FS + FACCH 8-burst diagonal half-blocks. With `prev_soft` (the
    streaming carry, see `uplink_block_decoded_stream`), groups spanning
    the left window edge decode as well; groups are reported exactly once
    (those completing in the current window).

    fn0 is the window's first FN, a 0-d tensor on the device (state.fn)
    or an int; the phase arithmetic stays on the device, so the call
    issues no host sync once its constant tables are on the device.
    `xcch_tns`/`tch_tns`/`rach_tns` (static TN tuples, default all 8)
    restrict each decoder to the timeslots configured for that channel
    type (TRXManager's per-(TN, FN) demux table, TRXManager.cpp:146-168);
    outputs keep the full [..., 8, ...] shape, and non-configured slots
    report not-ok/invalid."""
    soft_bits = res.soft_bits
    c = soft_bits.shape[1]
    dev = soft_bits.device
    p = DECODE_PRELUDE if prev_soft is not None else 0
    if p:
        soft_all = torch.cat([prev_soft.to(soft_bits.dtype), soft_bits])
        pv = prev_valid.to(device=dev, dtype=torch.bool)
    else:
        soft_all = soft_bits
        pv = torch.ones((), dtype=torch.bool, device=dev)
    fn0_ext = (_fn_tensor(fn0, dev) - p) % HYPERFRAME
    n_g = (p + frames) // 4
    off = (-fn0_ext) % 4  # frames until the next FN%4 block boundary

    # ---- XCCH: the window's 4-burst groups on the FN%4 grid -----------
    xt = tuple(range(8)) if xcch_tns is None else tuple(xcch_tns)
    nx = len(xt)
    soft_x = soft_all if nx == 8 else _sub_tns(soft_all, xt, 2)
    # zero-pad the frame axis so the slice at off ≤ 3 stays in range;
    # groups reaching past the window are masked invalid below
    soft_p = torch.cat([soft_x, soft_x.new_zeros((3,) + soft_x.shape[1:])])
    frame_idx = off + torch.arange(n_g * 4, device=dev)
    soft = soft_p.index_select(0, frame_idx)
    # [G·4, C, nx, 148] → [G, C, nx, 4, 148]
    grp_x = soft.reshape(n_g, 4, c, nx, 148).movedim(1, 3)
    bits, ok = l1fec.xcch_decode(grp_x.reshape(n_g * c * nx, 4, 148))
    bits = bits.reshape(n_g, c, nx, 184)
    ok = ok.reshape(n_g, c, nx)
    if nx < 8:
        bits = _back_tns(bits, xt, 2)
        ok = _back_tns(ok, xt, 2, fill=False)
    ends = off + (torch.arange(n_g, device=dev) + 1) * 4
    # report each group once: it must END inside the current window;
    # prelude-reaching groups need a valid carry
    complete = (ends <= p + frames) & (ends > p) & ((ends - 4 >= p) | pv)

    # ---- RACH: every detected access burst, on the RACH-capable slots
    # (RACHL1Decoder::writeLowSide, GSML1FEC.cpp:474-513) ---------------
    rt = tuple(range(8)) if rach_tns is None else tuple(rach_tns)
    rach_soft = soft_bits[..., l1fec.RACH_DATA_START:
                          l1fec.RACH_DATA_START + 36]
    if len(rt) < 8:
        rach_soft = _sub_tns(rach_soft, rt, 2)
    ra, ra_ok = l1fec.rach_decode(rach_soft, bsic)
    if len(rt) < 8:
        ra = _back_tns(ra, rt, 2)
        ra_ok = _back_tns(ra_ok, rt, 2, fill=False)

    # ---- TCH/FS + FACCH (TCHFACCHL1Decoder::processBurst + deinterleave
    # + decode/decodeTCH, GSML1FEC.cpp:1031-1175). In window coordinates
    # the deinterleaver's circular-row offsets (0/4) fold away: with the
    # group's 8 bursts ordered oldest → newest, coded bit k reads burst
    # k % 8, i.e. tch_interleave_map(0) --------------------------------
    n_fr = p + frames
    gt = _tch_group_tables(n_fr)[0].shape[1]
    p26 = fn0_ext % 26
    gf = row_at(device_table(_tch_group_table, (n_fr, 0), dev), p26)
    ge = row_at(device_table(_tch_group_table, (n_fr, 1), dev), p26)
    gv = row_at(device_table(_tch_group_table, (n_fr, 2), dev), p26)
    # once-only and carry-validity masking, as for the XCCH groups
    gv = gv & (ge >= p) & ((gf[:, 0] >= p) | pv)
    tt = tuple(range(8)) if tch_tns is None else tuple(tch_tns)
    nt = len(tt)
    soft_t = soft_all if nt == 8 else _sub_tns(soft_all, tt, 2)
    grp = soft_t.index_select(0, gf.reshape(-1))
    grp = grp.reshape(gt, 8, c, nt, 148).movedim(1, 3)
    payload, (hl, _hu) = fec.unmap_from_burst(grp)  # [Gt, C, nt, 8, 114]
    coded = fec.deinterleave(
        payload.reshape(gt * c * nt, 8, 114),
        fec.interleave_map_on(fec.tch_interleave_map, dev, 0))  # [.., 456]
    # stealing flag: Hl of the completing (newest) burst (GSML1FEC.cpp:
    # 1073; the encoder sets both H bits, GSM 05.03 4.2.5; the decoder
    # keys on Hl)
    stolen = hl[..., 7] > 0.5  # [Gt, C, nt]
    speech, tch_parity = l1fec.tch_decode(coded)
    fbits, f_ok = l1fec.xcch_decode_coded(coded)
    speech = speech.reshape(gt, c, nt, 260)
    tch_parity = tch_parity.reshape(gt, c, nt)
    fbits = fbits.reshape(gt, c, nt, 184)
    f_ok = f_ok.reshape(gt, c, nt)
    if nt < 8:
        speech = _back_tns(speech, tt, 2)
        tch_parity = _back_tns(tch_parity, tt, 2, fill=False)
        fbits = _back_tns(fbits, tt, 2)
        f_ok = _back_tns(f_ok, tt, 2, fill=False)
        stolen = _back_tns(stolen, tt, 2, fill=False)
    gvc = gv[:, None, None]

    return DecodedBlocks(
        bits=bits,
        ok=ok & complete[:, None, None],
        first_fn=((fn0_ext + off) % HYPERFRAME).to(torch.int32),
        rach_ra=ra.to(torch.int32),
        rach_ok=ra_ok & res.is_rach,
        tch_speech=speech,
        tch_good=tch_parity & ~stolen & gvc,
        facch_bits=fbits,
        facch_ok=f_ok & stolen & gvc,
        tch_stolen=stolen & gvc,
        tch_end_fn=torch.where(gv, (fn0_ext + ge) % HYPERFRAME,
                               -1).to(torch.int32),
        tch_valid=gv,
    )


def _stamp_tsc(state: eng.TrxState, bits: torch.Tensor) -> torch.Tensor:
    """Write each carrier's training sequence (the SETTSC plane) into the
    midamble, bits 61..86, of [F, C, ..., 148] bursts."""
    mid = fec.training_sequences_on(bits.device).index_select(
        0, state.tsc.to(torch.int64))  # [C, 26]
    shape = bits.shape[:-1] + (26,)
    mid = mid.reshape((1, bits.shape[1]) + (1,) * (bits.ndim - 3) + (26,))
    return torch.cat([bits[..., :61], mid.expand(shape).to(bits.dtype),
                      bits[..., 87:]], -1)


def downlink_block_encoded(cfg: eng.TrxConfig, spec: UplinkSpec,
                           state: eng.TrxState, frames184: torch.Tensor,
                           valid: torch.Tensor, atten_db: torch.Tensor,
                           fn0=None) -> torch.Tensor:
    """FEC-encoding downlink: 184-bit L2 frames → FireCode parity +
    rate-1/2 conv + diagonal interleave + burst mapping
    (XCCHL1Encoder::sendFrame, GSML1FEC.cpp:768-849) → GMSK modulate →
    96/65 resample, for every (chan, slot).

    frames184: [G, C, 8, 184] air-order frames for the G = frames//4
    FN%4-aligned groups starting at fn0 (fn0 must be block-aligned);
    valid/atten_db: [G, C, 8]. Returns [C, spec.block_in] device-rate
    samples; invalid (group, chan, slot) entries transmit the filler
    table like downlink_block."""
    g, c = frames184.shape[0], cfg.n_chan
    assert g * 4 <= spec.frames
    bursts = l1fec.xcch_encode(frames184, tsc=None)  # [G, C, 8, 4, 148]
    # [G, C, 8, 4, 148] → [G·4 frames, C, 8, 148], TSC per carrier from
    # the engine state
    bits = _stamp_tsc(state, bursts.movedim(3, 1).reshape(g * 4, c, 8, 148))
    pad = spec.frames - g * 4
    bits = torch.cat([bits, bits.new_zeros((pad, c, 8, 148))])
    v = torch.cat([_rep4(valid), valid.new_zeros((pad, c, 8))])
    a = torch.cat([_rep4(atten_db), atten_db.new_zeros((pad, c, 8))])
    return downlink_block(cfg, spec, state, bits, v, a, fn0)


#: leftover coded XCCH frames a streaming window carries to its
#: successor: a 4-burst group starting ≤3 frames before the window edge
#: finishes inside the next window
XCCH_TX_CARRY = 3


class XcchTxCarry:
    """Cross-window carry for the streaming XCCH downlink grid (see
    `_encode_dl_window` with `xcch_phase`): the ≤3 coded burst frames of
    a group that started in the previous window plus their valid plane,
    the transmit-side mirror of the receiver's DECODE_PRELUDE."""

    @staticmethod
    def zeros(c: int, device="cuda"):
        return (torch.zeros((XCCH_TX_CARRY, c, 8, 148), dtype=torch.uint8,
                            device=device),
                torch.zeros((XCCH_TX_CARRY, c, 8), dtype=torch.bool,
                            device=device))


@span("fec.encode")
def _encode_dl_window(cfg: eng.TrxConfig, spec: UplinkSpec,
                      state: eng.TrxState, frames184: torch.Tensor,
                      xcch_valid: torch.Tensor, speech: torch.Tensor,
                      sp_valid: torch.Tensor, facch: torch.Tensor,
                      fa_valid: torch.Tensor, tch_mask: torch.Tensor,
                      carry, fn0: torch.Tensor,
                      xcch_phase: int | None = None,
                      xcch_carry: tuple | None = None,
                      xcch_tns: tuple | None = None,
                      tch_tns: tuple | None = None):
    """The FEC-encode leg shared by `downlink_block_tch` and
    `duplex_block_decoded`: XCCH + TCH/FS + FACCH content for one window
    → (bits [F, C, 8, 148] with each carrier's TSC stamped, valid
    [F, C, 8], tch_carry', xcch_carry'). fn0 (a 0-d device tensor) is
    read on the device only.

    Two XCCH layouts:
    * legacy (`xcch_phase=None`): fn0 must be FN%4-aligned; group g
      occupies window frames [4g..4g+3] (downlink_block_encoded's
      contract).
    * streaming (`xcch_phase = fn0 % 4`, static): groups live on the
      ABSOLUTE FN%4 grid, the grid the uplink decoder's groups use
      (decode_block), so 13-frame windows whose starts drift mod 4 still
      transmit decodable groups. Group g of this window starts at local
      frame ((-phase) % 4) + 4g; a group extending past the window edge
      carries its tail frames to the next window through `xcch_carry`.
      frames184 is then [4, C, 8, 184] (the at most 4 group starts).

    `xcch_tns`/`tch_tns` (static): each encoder runs only on its
    configured TNs; outputs scatter back to the full 8-slot lane."""
    f, c = spec.frames, cfg.n_chan
    g = frames184.shape[0]
    gt = speech.shape[0]
    xt = tuple(range(8)) if xcch_tns is None else tuple(xcch_tns)
    nx = len(xt)
    tt = tuple(range(8)) if tch_tns is None else tuple(tch_tns)
    nt = len(tt)

    # ---- XCCH leg (XCCHL1Encoder::sendFrame, GSML1FEC.cpp:768-849) ---
    f184 = frames184 if nx == 8 else _sub_tns(frames184, xt, 2)
    xvs = xcch_valid if nx == 8 else _sub_tns(xcch_valid, xt, 2)
    bursts = l1fec.xcch_encode(f184, tsc=None)  # [G, C, nx, 4, 148]
    new_xcch_carry = None
    if xcch_phase is None:
        xb = bursts.movedim(3, 1).reshape(g * 4, c, nx, 148)
        pad = f - g * 4
        xb = torch.cat([xb, xb.new_zeros((pad, c, nx, 148))])
        xv = torch.cat([_rep4(xvs), xvs.new_zeros((pad, c, nx))])
    else:
        assert g == 4 and xcch_carry is not None
        off = (-int(xcch_phase)) % 4  # local frame of the first grid
        cb, cv = xcch_carry
        if nx < 8:
            cb, cv = _sub_tns(cb, xt, 2), _sub_tns(cv, xt, 2)
        nb = bursts.movedim(3, 1).reshape(16, c, nx, 148)
        seq_b = torch.cat([cb, nb])  # [19, C, nx, 148]
        seq_v = torch.cat([cv, _rep4(xvs)])
        # static slice: carry frames fill local 0..off−1 (the window
        # reads the LAST `off` carry entries), the window spans
        # grid-relative [XCCH_TX_CARRY−off, +f)
        start = XCCH_TX_CARRY - off
        xb = seq_b[start: start + f]
        xv = seq_v[start: start + f]
        # next carry, right-aligned so the successor's static slice
        # [XCCH_TX_CARRY−off', :] lands on the continuation frames: its
        # off' = (off − f) % 4 says how many it consumes
        off_next = (off - f) % 4
        cstart = start + f - (XCCH_TX_CARRY - off_next)
        keep = (torch.arange(XCCH_TX_CARRY, device=cv.device)
                >= XCCH_TX_CARRY - off_next)[:, None, None]
        ncb = seq_b[cstart: cstart + XCCH_TX_CARRY]
        ncv = seq_v[cstart: cstart + XCCH_TX_CARRY] & keep
        if nx < 8:
            ncb = _back_tns(ncb, xt, 2)
            ncv = _back_tns(ncv, xt, 2, fill=False)
        new_xcch_carry = (ncb, ncv)
    if nx < 8:
        xb = _back_tns(xb, xt, 2)
        xv = _back_tns(xv, xt, 2, fill=False)

    # ---- TCH/FS + FACCH leg (TCHFACCHL1Encoder, GSML1FEC.cpp:
    # 1106-1120, 1280-1393) --------------------------------------------
    if nt < 8:
        sp_s = _sub_tns(speech, tt, 2)
        spv_s = _sub_tns(sp_valid, tt, 2)
        fa_s = _sub_tns(facch, tt, 2)
        fav_s = _sub_tns(fa_valid, tt, 2)
        # TchTxCarry lanes are [C·8, ...] per (carrier, TN): subset the
        # TN lane axis the same way
        carry_s = tuple(
            _sub_tns(x.reshape((c, 8) + x.shape[1:]), tt, 1)
            .reshape((c * nt,) + x.shape[1:]) for x in carry)
    else:
        sp_s, spv_s, fa_s, fav_s, carry_s = (speech, sp_valid, facch,
                                             fa_valid, carry)
    n = c * nt
    tb, t_isburst, _hu, carry2 = l1fec.tch_tx_window(
        sp_s.reshape(gt, n, 260), spv_s.reshape(gt, n),
        fa_s.reshape(gt, n, 184), fav_s.reshape(gt, n), carry_s, fn0, f)
    tb = tb.reshape(f, c, nt, 148)
    t_isburst = t_isburst.reshape(f, c, nt)
    if nt < 8:
        tb = _back_tns(tb, tt, 2)
        t_isburst = _back_tns(t_isburst, tt, 2, fill=False)
        carry2 = tuple(
            _back_tns(x.reshape((c, nt) + x.shape[1:]), tt, 1,
                      fill=False if x.dtype == torch.bool else 0)
            .reshape((c * 8,) + x.shape[1:]) for x in carry2)
    tv = t_isburst & tch_mask[None]

    bits = torch.where(tch_mask[None, :, :, None], tb, xb)
    valid = torch.where(tch_mask[None], tv, xv)
    return _stamp_tsc(state, bits), valid, carry2, new_xcch_carry


def duplex_block_decoded(cfg: eng.TrxConfig, spec: UplinkSpec,
                         state: eng.TrxState, ul_halo: torch.Tensor,
                         tx_tail: torch.Tensor, dl_content: tuple,
                         atten_db: torch.Tensor, tx_carry,
                         fn0_dl: torch.Tensor, prev_soft: torch.Tensor,
                         prev_valid: torch.Tensor, bsic: int = 0,
                         xcch_phase: int = 0,
                         xcch_tns: tuple | None = None,
                         tch_tns: tuple | None = None):
    """The resident BTS layer 1, both directions of one window: downlink
    FEC (XCCH + TCH/FS + FACCH encode, diagonal interleave, stealing
    flags) → GMSK modulate → 96/65 resample (K1), and uplink 65/96
    resample (K1) → exact detection/demod → streaming FEC decode (XCCH +
    RACH + TCH/FS + FACCH with the cross-window soft-bit prelude). The
    reference splits this across two processes and a UDP socket
    (Transceiver52M ↔ GSML1FEC); here L2 frames and vocoder bits are the
    only host traffic.

    dl_content = (frames184 [4, C, 8, 184] on the ABSOLUTE FN%4 grid
    (`_encode_dl_window`'s streaming layout), xcch_valid [4, C, 8],
    speech [Gt, C, 8, 260], sp_valid, facch [Gt, C, 8, 184], fa_valid,
    tch_mask [C, 8]); tx_carry = (l1fec.TchTxCarry.zeros(C*8),
    XcchTxCarry.zeros(C)), both encoder carries; xcch_phase (static) =
    fn0_dl % 4; prev_soft/prev_valid the streaming decode carry
    (uplink_block_decoded_stream). Stream continuity (ul_halo, tx_tail,
    TX_DELAY_DEV) as in duplex_block_wire. `xcch_tns`/`tch_tns` (static,
    default all 8): the configured slot split of both legs; `tch_mask`
    must be False outside `tch_tns`. RACH decode follows cfg.rach_slots.

    Returns (state', tx [C, block_in], tx_tail', DecodedBlocks,
    tx_carry', prev_soft', prev_valid'). GSML1FEC.cpp:572-630,1106-1120
    (the encode/decode pair) riding Transceiver.cpp:268-408/672-722 (the
    radio pair)."""
    frames = spec.frames
    (frames184, xcch_valid, speech, sp_valid, facch, fa_valid,
     tch_mask) = dl_content
    tch_carry, xcch_carry = tx_carry

    # ---- downlink: FEC encode → modulate → resample -------------------
    bits, valid, tch_carry2, xcch_carry2 = _encode_dl_window(
        cfg, spec, state, frames184, xcch_valid, speech, sp_valid, facch,
        fa_valid, tch_mask, tch_carry, fn0_dl, xcch_phase=xcch_phase,
        xcch_carry=xcch_carry, xcch_tns=xcch_tns, tch_tns=tch_tns)
    with span("tx.modulate"):
        slots = eng.tx_frames(cfg, state, bits, valid, atten_db)
        sym = _assemble_stream(slots)
    stream = torch.cat([tx_tail.to(sym.dtype), sym], -1)
    y = fir.polyphase_resample(stream, spec.q, spec.p,
                               fir.resampler_lpf(spec.q, spec.p, 651))
    tx = y[..., TX_DELAY_DEV: TX_DELAY_DEV + spec.block_in]
    new_tail = sym[..., -TX_TAIL_SYM:].contiguous()

    # ---- uplink: resample → exact rx → streaming FEC decode -----------
    fn0 = state.fn
    sym_ul = resample_block(ul_halo.contiguous(), spec.p, spec.q,
                            fir.resampler_lpf(spec.p, spec.q, spec.taps),
                            RX_HALO_DEV, spec.block_in)
    state2, res = _exact_rx(cfg, frames, state,
                            sym_ul[..., : spec.block_symbols])
    blocks = decode_block(res, fn0, frames, bsic, prev_soft=prev_soft,
                          prev_valid=prev_valid, xcch_tns=xcch_tns,
                          tch_tns=tch_tns, rach_tns=cfg.rach_slots)
    return (state2, tx, new_tail, blocks, (tch_carry2, xcch_carry2),
            res.soft_bits[-DECODE_PRELUDE:],
            torch.ones((), dtype=torch.bool, device=tx.device))


def downlink_block_tch(cfg: eng.TrxConfig, spec: UplinkSpec,
                       state: eng.TrxState, frames184: torch.Tensor,
                       xcch_valid: torch.Tensor, speech: torch.Tensor,
                       sp_valid: torch.Tensor, facch: torch.Tensor,
                       fa_valid: torch.Tensor, tch_mask: torch.Tensor,
                       atten_db: torch.Tensor, carry, fn0: torch.Tensor):
    """FEC-encoding downlink with TCH/FS + FACCH, the transmit mirror of
    decode_block's TCH decoder.

    XCCH leg: frames184 [G, C, 8, 184] air-order L2 frames on the
    G = frames//4 FN%4-aligned groups (XCCHL1Encoder::sendFrame,
    GSML1FEC.cpp:768-849), masked by xcch_valid [G, C, 8]. TCH leg:
    speech [Gt, C, 8, 260] coder-order vocoder frames (sp_valid
    [Gt, C, 8]) and facch [Gt, C, 8, 184] (fa_valid) feed the windowed
    diagonal interleaver (tch_tx_window; TCHFACCHL1Encoder,
    GSML1FEC.cpp:1106-1120, 1280-1393), with `carry` from
    `l1fec.TchTxCarry.zeros(C*8)` threading the cross-window diagonal
    halves. tch_mask [C, 8] bool selects the TCH/F slots; all others take
    the XCCH leg. atten_db [frames, C, 8]. Returns ([C, spec.block_in]
    device-rate samples, carry'); slots with no content transmit the
    filler table."""
    bits, valid, carry2, _ = _encode_dl_window(
        cfg, spec, state, frames184, xcch_valid, speech, sp_valid, facch,
        fa_valid, tch_mask, carry, fn0)
    return downlink_block(cfg, spec, state, bits, valid, atten_db,
                          fn0), carry2


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
    @span("trx.uplink")
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
