"""Per-channel L1 FEC codecs: XCCH, RACH, SCH, TCH/FS.

Port of `openbts_ttsou_tpu/gsm/l1fec.py`. Reference behavior:
`GSM/GSML1FEC.{h,cpp}` — XCCHL1Encoder/Decoder (GSML1FEC.cpp:530-860),
RACHL1Decoder (:440-513), SCHL1Encoder (:880-925), TCHFACCHL1Encoder/
Decoder (:998-1405). These compose the `gsm.fec` primitives into the full
GSM 05.03 channel-coding chains.

Everything is functional and batched over leading axes, on the device
of its inputs; the reference's threaded encoder/decoder objects become
`*_encode`/`*_decode` functions plus the TDMA pacing data in `gsm.tdma`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from openbts_ttsou_tpu_torch.gsm import fec
from openbts_ttsou_tpu_torch.gsm.tdma import FACCH_TCHF
from openbts_ttsou_tpu_torch.utils import constants as C
from openbts_ttsou_tpu_torch.utils.tables import device_table, row_at


def lsb8msb(bits: torch.Tensor) -> torch.Tensor:
    """Reverse the bit order within each full byte; a trailing partial
    byte is left alone (BitVector::LSB8MSB, BitVector.cpp:189-196). Used
    at the L2↔L1 boundary: GSM transmits octets LSB-first."""
    n = bits.shape[-1]
    n8 = 8 * (n // 8)
    rev = torch.flip(bits[..., :n8].reshape(bits.shape[:-1] + (n // 8, 8)),
                     (-1,))
    return torch.cat([rev.reshape(bits.shape[:-1] + (n8,)), bits[..., n8:]],
                     -1)


def pack_field(vals, widths) -> torch.Tensor:
    """Pack integer fields MSB-first into a uint8 bit tensor
    (BitVector::writeField semantics). vals: [..., ] int tensors, all on
    one device."""
    planes = []
    for v, w in zip(vals, widths):
        v = v.to(torch.int32)
        shifts = torch.arange(w - 1, -1, -1, dtype=torch.int32,
                              device=v.device)
        planes.append(((v[..., None] >> shifts) & 1).to(torch.uint8))
    return torch.cat(planes, -1)


def unpack_field(bits: torch.Tensor, pos: int, width: int) -> torch.Tensor:
    """Read an MSB-first integer field (BitVector::peekField); int32."""
    seg = bits[..., pos: pos + width].to(torch.int32)
    weights = 1 << torch.arange(width - 1, -1, -1, dtype=torch.int32,
                                device=bits.device)
    return (seg * weights).sum(-1, dtype=torch.int32)


def _xcch_map(device) -> torch.Tensor:
    return fec.interleave_map_on(fec.xcch_interleave_map, device)


def _tch_map(device) -> torch.Tensor:
    return fec.interleave_map_on(fec.tch_interleave_map, device, 0)


# ---------------------------------------------------------------------------
# XCCH (SDCCH / SACCH / FACCH / BCCH / CCCH data part): GSM 05.03 4.1
# ---------------------------------------------------------------------------

def xcch_encode(frames: torch.Tensor, stealing=(1, 1),
                tsc: int | None = None) -> torch.Tensor:
    """184-bit L1 frame → 4 bursts [..., 4, 148]
    (XCCHL1Encoder::encode + interleave + transmit,
    GSML1FEC.cpp:795-849). Input must already be in air bit order
    (callers apply `lsb8msb` to L2 octet frames)."""
    c = _facch_coded(frames)  # [..., 456]
    i = fec.interleave(c, _xcch_map(c.device), 4)
    return fec.map_to_burst(i, stealing, tsc=tsc)


def xcch_decode_coded(c_soft: torch.Tensor):
    """456 deinterleaved soft coded bits → (frame [..., 184] air-order,
    ok [...]): the Viterbi + FireCode tail of XCCHL1Decoder::decode
    (GSML1FEC.cpp:632-655). Also the FACCH frame decoder: FACCH is XCCH
    coding on the TCH's stolen 8-burst diagonal."""
    u = fec.viterbi_decode(c_soft)  # [..., 228]
    ok = fec.syndrome_ok(u[..., :224], fec.FIRECODE_XCCH)
    return u[..., :184], ok


def xcch_decode(soft_bursts: torch.Tensor):
    """4 soft bursts [..., 4, 148] (or payloads [..., 4, 114]) →
    (frames [..., 184], ok [...]) (XCCHL1Decoder::processBurst +
    deinterleave + decode, GSML1FEC.cpp:572-655)."""
    soft_bursts = soft_bursts.to(torch.float32)
    if soft_bursts.shape[-1] == 148:
        payload, _ = fec.unmap_from_burst(soft_bursts)
    else:
        payload = soft_bursts
    return xcch_decode_coded(fec.deinterleave(payload,
                                              _xcch_map(payload.device)))


# ---------------------------------------------------------------------------
# RACH: GSM 05.03 4.6
# ---------------------------------------------------------------------------

def rach_encode(ra: torch.Tensor, bsic: torch.Tensor) -> torch.Tensor:
    """RA byte(s) → 36 coded bits [..., 36] (the MS-side inverse of
    RACHL1Decoder, for tests and loopback)."""
    d = lsb8msb(pack_field([ra], [8]))  # transmitted bit order
    parity = fec.parity_word(d, fec.PARITY_RACH, invert=True)
    # parity is also XOR'd with the BSIC "color" (GSM 05.03 4.6)
    parity = parity ^ pack_field([bsic], [6])
    tail = torch.zeros(d.shape[:-1] + (4,), dtype=torch.uint8,
                       device=d.device)
    return fec.conv_encode(torch.cat([d, parity, tail], -1))


def rach_decode(soft: torch.Tensor, bsic: int):
    """36 soft bits (burst bits 49..85) → (RA [...], ok [...])
    (RACHL1Decoder::writeLowSide, GSML1FEC.cpp:474-513): Viterbi, zero
    tail check, 6-bit parity XOR BSIC check, LSB8MSB → RA."""
    u = fec.viterbi_decode(soft)  # [..., 18]
    tail_ok = unpack_field(u, 14, 4) == 0
    sent_parity = (~unpack_field(u, 8, 6)) & 0x3F
    d = u[..., :8]
    calc = fec.parity_word(d, fec.PARITY_RACH, invert=False)
    calc_parity = unpack_field(calc, 0, 6)
    ok = tail_ok & ((sent_parity ^ calc_parity) == bsic)
    ra = unpack_field(lsb8msb(d), 0, 8)
    return ra, ok


# RACH burst geometry: synch sequence at bits 8..48, data at 49..84
# (RACHL1Decoder reads segment(49,36), GSML1FEC.cpp:478)
RACH_DATA_START = 49


# ---------------------------------------------------------------------------
# SCH: GSM 05.03 4.7
# ---------------------------------------------------------------------------

def sch_pack(bsic, t1, t2, t3p) -> torch.Tensor:
    """Pack the 25-bit SCH payload (GSM 04.08 9.1.30 + LSB8MSB,
    SCHL1Encoder::generate, GSML1FEC.cpp:898-905)."""
    return lsb8msb(pack_field([bsic, t1, t2, t3p], [6, 11, 5, 3]))


def _sch_synch() -> np.ndarray:
    return np.asarray(C.SCH_SYNCH_SEQUENCE, np.uint8)


def sch_encode(bsic, t1, t2, t3p) -> torch.Tensor:
    """SCH burst bits [..., 148]: coded halves at 3..41/106..144 with the
    64-bit extended training sequence at 42..105
    (GSML1FEC.cpp:880-925)."""
    d = sch_pack(bsic, t1, t2, t3p)
    lead, dev = d.shape[:-1], d.device
    p = fec.parity_word(d, fec.PARITY_SCH)
    tail = torch.zeros(lead + (4,), dtype=torch.uint8, device=dev)
    e = fec.conv_encode(torch.cat([d, p, tail], -1))  # [..., 78]
    zeros3 = torch.zeros(lead + (3,), dtype=torch.uint8, device=dev)
    synch = device_table(_sch_synch, (), dev).expand(lead + (64,))
    return torch.cat([zeros3, e[..., :39], synch, e[..., 39:], zeros3], -1)


def sch_decode(soft_burst: torch.Tensor):
    """SCH burst soft bits → ({bsic, t1, t2, t3p}, ok)."""
    soft_burst = soft_burst.to(torch.float32)
    e = torch.cat([soft_burst[..., 3:42], soft_burst[..., 106:145]], -1)
    u = fec.viterbi_decode(e)  # [..., 39]
    ok = fec.syndrome_ok(u[..., :35], fec.PARITY_SCH) & \
        (unpack_field(u, 35, 4) == 0)
    d = lsb8msb(u[..., :25])
    fields = {
        "bsic": unpack_field(d, 0, 6),
        "t1": unpack_field(d, 6, 11),
        "t2": unpack_field(d, 17, 5),
        "t3p": unpack_field(d, 22, 3),
    }
    return fields, ok


# ---------------------------------------------------------------------------
# TCH/FS: GSM 05.03 3.1
# ---------------------------------------------------------------------------

def _tch_even() -> np.ndarray:
    """Coder bits 2k (k = 0..90): class 1 bits u[0..90]."""
    return 2 * np.arange(91, dtype=np.int64)


def _tch_odd_rev() -> np.ndarray:
    """Coder bits 2k+1 in the order of u[94..184] (u[184−k] = d[2k+1])."""
    return 2 * (184 - np.arange(94, 185, dtype=np.int64)) + 1


def _tch_u_odd() -> np.ndarray:
    """u positions 184−k (k = 0..90), the odd coder bits' slots."""
    return 184 - np.arange(91, dtype=np.int64)


def tch_encode(d: torch.Tensor) -> torch.Tensor:
    """260-bit vocoder frame (coder order) → 456 coded bits
    (TCHFACCHL1Encoder::encodeTCH, GSML1FEC.cpp:1280-1310):
    u = [d[2k] (91) | parity (3) | d[2k+1] for u[94..184] (91) | tail (4)]."""
    d = d.to(torch.uint8)
    dev = d.device
    p = fec.parity_word(d[..., :50], fec.PARITY_TCH)
    tail = torch.zeros(d.shape[:-1] + (4,), dtype=torch.uint8, device=dev)
    u = torch.cat([d.index_select(-1, device_table(_tch_even, (), dev)), p,
                   d.index_select(-1, device_table(_tch_odd_rev, (), dev)),
                   tail], -1)  # [..., 189]
    c1 = fec.conv_encode(u)  # [..., 378]
    return torch.cat([c1, d[..., 182:260]], -1)  # [..., 456]


def tch_decode(c_soft: torch.Tensor):
    """456 soft bits → (d [..., 260] coder-order vocoder frame, good)
    (TCHFACCHL1Decoder::decodeTCH, GSML1FEC.cpp:1125-1175)."""
    c_soft = c_soft.to(torch.float32)
    u = fec.viterbi_decode(c_soft[..., :378])  # [..., 189]
    lead = u.shape[:-1]
    odd = u.index_select(-1, device_table(_tch_u_odd, (), u.device))
    d182 = torch.stack([u[..., :91], odd], -1).reshape(lead + (182,))
    d = torch.cat([d182, (c_soft[..., 378:] > 0.5).to(torch.uint8)], -1)
    sent_parity = (~unpack_field(u, 91, 3)) & 0x7
    calc = fec.parity_word(d[..., :50], fec.PARITY_TCH, invert=False)
    calc_parity = unpack_field(calc, 0, 3)
    good = (sent_parity == calc_parity) & (unpack_field(u, 185, 4) == 0)
    return d, good


# ---------------------------------------------------------------------------
# TCH/FS + FACCH windowed downlink encoder (device-resident)
# ---------------------------------------------------------------------------

class TchTxCarry:
    """Cross-window diagonal-interleaver carry for the fused TCH downlink
    (the encoder's persistent mI[]/mPreviousFACCH, GSML1FEC.cpp:
    1380-1393): the interleaved rows of the last two dispatched coded
    blocks plus their FACCH flags, per burst lane."""

    @staticmethod
    def zeros(n: int, device="cuda"):
        z = torch.zeros((n, 8, 114), dtype=torch.uint8, device=device)
        f = torch.zeros((n,), dtype=torch.bool, device=device)
        return (z, z, f, f)  # (i_prev, i_cur, facch_prev, facch_cur)


@functools.lru_cache(maxsize=None)
def _tch_tx_tables(frames: int) -> tuple[np.ndarray, ...]:
    """Static per-window-phase geometry for the TCH/F downlink
    dispatcher. Coded bit k of dispatch block g lands in global burst
    4g + k%8 (even interleaver columns from the current block, odd from
    the previous — GSM 05.03 3.1.3), so each window needs only:

      blk  [26, frames]  block index d per frame into the window's block
                         list [prev, cur, new0, new1, ...] (−1 where the
                         frame is not a TCH burst);
      pos  [26, frames]  burst position b = B % 4 within its block;
      nd   [26]          number of NEW dispatch blocks in the window;

    each indexed by the phase p = fn0 % 26."""
    rev = FACCH_TCHF.reverse_map()  # [26], −1 on SACCH/idle
    blk = np.full((26, frames), -1, np.int32)
    pos = np.zeros((26, frames), np.int32)
    nd = np.zeros(26, np.int32)
    for p in range(26):
        d = 1  # carried current block until the first new dispatch
        dcount = 0
        for f in range(frames):
            b8 = int(rev[(p + f) % 26])
            if b8 < 0:
                continue
            b = b8 % 4
            if b == 0:  # a new half-block dispatch starts here
                d = 2 + dcount
                dcount += 1
            blk[p, f] = d
            pos[p, f] = b
        nd[p] = dcount
    return blk, pos, nd


def _tch_tx_table(frames: int, k: int) -> np.ndarray:
    return _tch_tx_tables(frames)[k].astype(np.int64)



def tch_tx_window(speech: torch.Tensor, speech_valid: torch.Tensor,
                  facch: torch.Tensor, facch_valid: torch.Tensor, carry,
                  fn0: torch.Tensor, frames: int):
    """Encode one window of TCH/FS + FACCH downlink for N burst lanes in
    one batch (TCHFACCHL1Encoder::sendFrame/dispatch + interleave,
    GSML1FEC.cpp:1310-1393, re-derived for windowed batching: no
    sequential dispatch loop, no mutable diagonal buffer).

    speech [G, N, 260] coder-order vocoder frames, speech_valid [G, N];
    facch [G, N, 184] air-order FACCH frames, facch_valid [G, N] (FACCH
    steals the dispatch, the encoder's priority, GSML1FEC.cpp:1325-1340;
    silence filler when neither is valid); carry from
    `TchTxCarry.zeros(N)` or a previous window; fn0 [] int32 window-start
    FN on the device (same frame origin as the uplink decoder's tables),
    read on the device only. G must be ≥ the MAX dispatch count over
    phases (3 for frames=13; checked); extra entries are coded but never
    dispatched and do not enter the carry.

    Returns (bits [frames, N, 148] uint8 with a zeroed midamble, is_burst
    [frames, N] bool (False on SACCH/idle frames), hu [frames, N] the
    stealing flag, new_carry)."""
    i_prev, i_cur, f_prev, f_cur = carry
    n = i_prev.shape[0]
    g = speech.shape[0]
    dev = i_prev.device
    if g < int(_tch_tx_tables(frames)[2].max()):
        raise ValueError(f"G={g} < max dispatch count "
                         f"{int(_tch_tx_tables(frames)[2].max())} for "
                         f"frames={frames}")
    p26 = (fn0.to(torch.int64) % 26).to(dev)
    blk = row_at(device_table(_tch_tx_table, (frames, 0), dev), p26)
    pos = row_at(device_table(_tch_tx_table, (frames, 1), dev), p26)
    ndp = row_at(device_table(_tch_tx_table, (frames, 2), dev), p26)

    # code every dispatch's content in one batch: FACCH > speech > fill
    c_facch = _facch_coded(facch)  # [G, N, 456]
    c_speech = tch_encode(speech)  # [G, N, 456]
    use_f = facch_valid[..., None]
    use_s = (~facch_valid & speech_valid)[..., None]
    coded = torch.where(use_f, c_facch,
                        torch.where(use_s, c_speech,
                                    torch.zeros_like(c_speech)))
    i_new = fec.interleave(coded, _tch_map(dev), 8)
    # block list: [prev, cur, new...] → [2+G, N, 8, 114]
    blocks = torch.cat([i_prev[None], i_cur[None], i_new])
    flags = torch.cat([f_prev[None], f_cur[None], facch_valid])

    # per-frame gather: burst(d, b) = blocks[d][:, b] (even columns)
    #                               + blocks[d-1][:, 4+b] (odd columns)
    rows = blocks.movedim(2, 1).reshape((2 + g) * 8, n, 114)
    safe_blk = torch.clamp(blk, min=1)  # −1 rows masked by is_burst below
    cur_rows = rows.index_select(0, safe_blk * 8 + pos)
    prv_rows = rows.index_select(0, (safe_blk - 1) * 8 + 4 + pos)
    i114 = cur_rows + prv_rows  # disjoint even/odd columns
    hu = flags.index_select(0, safe_blk)  # [frames, N]
    hl = flags.index_select(0, safe_blk - 1)
    bits = fec.map_to_burst(i114, stealing=(hl, hu), tsc=None)
    is_burst = (blk >= 0)[:, None].expand(frames, n)

    # carry out: the last two DISPATCHED blocks of the window's list, at
    # list indices nd and 1+nd (new block k sits at 2+k), indexed from
    # the phase's dispatch count, not from G: with G > nd the tail
    # entries of `blocks` were coded but never dispatched
    nd1 = torch.stack([ndp, ndp + 1])
    cb, cf = blocks.index_select(0, nd1), flags.index_select(0, nd1)
    return bits, is_burst, hu, (cb[0], cb[1], cf[0], cf[1])


def _facch_coded(frames184: torch.Tensor) -> torch.Tensor:
    """184-bit air-order FACCH frame → 456 coded bits (the XCCH coding
    chain without interleave and mapping; FACCH shares it,
    GSML1FEC.cpp:795-808)."""
    frames184 = frames184.to(torch.uint8)
    p = fec.parity_word(frames184, fec.FIRECODE_XCCH)
    tail = torch.zeros(frames184.shape[:-1] + (4,), dtype=torch.uint8,
                       device=frames184.device)
    return fec.conv_encode(torch.cat([frames184, p, tail], -1))
