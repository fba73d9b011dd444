"""The GSM 05.03 channel coders the benchmark needs, plain PyTorch.

The benchmark's frozen copy of the encoding half of the port's
`gsm/py` and `gsm/l1py` (it imports nothing of the port): the
Fire code and TCH parity, the rate-1/2 convolutional code, the XCCH and
TCH diagonal interleavers, the burst mapping, the XCCH, FACCH and TCH/FS
encoders, and the windowed TCH/FACCH dispatcher. Reference behavior:
`CommonLibs/BitVector.{h,cpp}` and `GSM/GSML1FEC.cpp:530-860, 998-1405`.
The traffic generator codes the uplink with it; the reference codes the
downlink with it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from trxbench.reference import constants as C

# (poly, parity_bits, codeword_bits) as constructed in GSML1FEC.cpp:
FIRECODE_XCCH = (0x10004820009, 40, 224)  # GSML1FEC.cpp:537
PARITY_TCH = (0x0B, 3, 50)  # GSML1FEC.cpp:1005


def _poly_bits(poly: int, n: int) -> np.ndarray:
    """Exponents 0..n-1 of `poly` as an [n] uint8 array (LSB first)."""
    return np.array([(poly >> i) & 1 for i in range(n)], np.uint8)


@functools.lru_cache(maxsize=None)
def _crc_contribution_matrix(poly: int, size: int, n_bits: int,
                             encoder: bool) -> np.ndarray:
    """[n_bits, size] GF(2) matrix C with final_state = (bits @ C) mod 2.

    The LFSR update (Generator::encoderShift / syndromeShift,
    BitVector.h:66-83) is linear over GF(2) in the input bits with a zero
    initial state, so the final state is the XOR of each input bit's
    unit-impulse response, computed here once per (poly, size, length)."""
    coeff = _poly_bits(poly, size).astype(np.uint8)
    c = np.zeros((n_bits, size), np.uint8)
    for i in range(n_bits):
        state = np.zeros(size, np.uint8)
        for t in range(n_bits):
            in_bit = np.uint8(1 if t == i else 0)
            msb = state[size - 1]
            fb = (msb ^ in_bit) if encoder else msb
            new_lsb = np.uint8(0) if encoder else in_bit
            state = np.concatenate([[new_lsb], state[: size - 1]]) ^ \
                (fb * coeff)
        c[i] = state
    return c


def _crc_matrix_f32(poly: int, size: int, n_bits: int,
                    encoder: bool) -> np.ndarray:
    return _crc_contribution_matrix(poly, size, n_bits,
                                    encoder).astype(np.float32)


def crc_state_run(bits: torch.Tensor, poly: int, size: int, *,
                  encoder: bool) -> torch.Tensor:
    """Run the LFSR over `bits` along the last axis; return the final
    state as an [..., size] uint8 bit-plane (index 0 = exponent 0 / LSB).

    encoder=True → Generator::encoderShift (BitVector.h:77-83);
    encoder=False → syndromeShift (BitVector.h:66-71). One float32 matmul
    against the unit-response matrix: the sums are integers ≤ n_bits, far
    below 2^24, so the product is exact (with TF32 too, whose operands
    hold 0 and 1 exactly and whose sums are float32)."""
    c = device_table(_crc_matrix_f32, (poly, size, bits.shape[-1], encoder),
                     bits.device)
    acc = torch.matmul(bits.to(torch.float32), c)
    return (acc.to(torch.int32) & 1).to(torch.uint8)


def parity_word(data: torch.Tensor, spec=FIRECODE_XCCH,
                invert: bool = True) -> torch.Tensor:
    """The parity field for `data` [..., K]: [..., P] bits in frame order
    (MSB of the register first, Parity::writeParityWord + fillField,
    BitVector.cpp:411-418)."""
    poly, p, _ = spec
    state = crc_state_run(data, poly, p, encoder=True)
    if invert:
        state = state ^ 1
    return torch.flip(state, (-1,))  # MSB-first into the frame


VITERBI_POLYS = (0x19, 0x1B)  # ViterbiR2O4 mCoeffs (BitVector.cpp:292-293)
V_ORDER = 4


def conv_encode(bits: torch.Tensor) -> torch.Tensor:
    """Rate-1/2 convolutional encode: [..., K] → [..., 2K] uint8
    (BitVector::encode, BitVector.cpp:217-238). Output bit 2i is G0's,
    2i+1 is G1's, from a zero initial state."""
    bits = bits.to(torch.uint8)
    k = bits.shape[-1]
    outs = []
    for poly in VITERBI_POLYS:
        taps = _poly_bits(poly, V_ORDER + 1)  # taps[s] multiplies bit i−s
        acc = torch.zeros_like(bits)
        for s in range(V_ORDER + 1):
            if taps[s]:
                acc = acc ^ F.pad(bits, (s, 0))[..., :k]
        outs.append(acc)
    return torch.stack(outs, -1).reshape(bits.shape[:-1] + (2 * k,))


@functools.lru_cache(maxsize=None)
def xcch_interleave_map() -> np.ndarray:
    """k → flat index B*114+j of i[B][j] for the 4-burst diagonal
    interleaver (GSM 05.03 4.1.4; GSML1FEC.cpp:811-822)."""
    k = np.arange(456)
    B = k % 4
    j = 2 * ((49 * k) % 57) + ((k % 8) // 4)
    return (B * 114 + j).astype(np.int32)


@functools.lru_cache(maxsize=None)
def tch_interleave_map(block_offset: int = 0) -> np.ndarray:
    """k → flat index B*114+j for the 8-burst diagonal TCH interleaver
    (GSM 05.03 3.1.3; GSML1FEC.cpp:1380-1393)."""
    k = np.arange(456)
    B = (k + block_offset) % 8
    j = 2 * ((49 * k) % 57) + ((k % 8) // 4)
    return (B * 114 + j).astype(np.int32)


def device_table(fn, args: tuple, device) -> torch.Tensor:
    """`fn(*args)`, a numpy array, as a tensor on `device`."""
    return torch.from_numpy(np.ascontiguousarray(fn(*args))).to(device)


def row_at(table: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """table[p] for a 0-d index tensor p on the table's device."""
    return table.index_select(0, p.reshape(1))[0]


def _map64(fn, *args) -> np.ndarray:
    return fn(*args).astype(np.int64)


def _xcch_map(device) -> torch.Tensor:
    return device_table(_map64, (xcch_interleave_map,), device)


def _tch_map(device) -> torch.Tensor:
    return device_table(_map64, (tch_interleave_map, 0), device)


def _as_index(imap, device) -> torch.Tensor:
    if isinstance(imap, torch.Tensor):
        return imap.to(device=device, dtype=torch.int64)
    return torch.from_numpy(np.asarray(imap, np.int64)).to(device)


def interleave(c: torch.Tensor, imap, num_bursts: int) -> torch.Tensor:
    """c [..., 456] → i [..., num_bursts, 114] via scatter. `imap` is a
    numpy map or an index tensor (`interleave_map_on`)."""
    flat = torch.zeros(c.shape[:-1] + (num_bursts * 114,), dtype=c.dtype,
                       device=c.device)
    flat.index_copy_(-1, _as_index(imap, c.device), c)
    return flat.reshape(c.shape[:-1] + (num_bursts, 114))


def _training_sequences() -> np.ndarray:
    return np.asarray(C.TRAINING_SEQUENCE, np.uint8)


def training_sequences_on(device) -> torch.Tensor:
    """[8, 26] uint8 training sequences on `device`, copied once."""
    return device_table(_training_sequences, (), torch.device(device))


def map_to_burst(i_frame: torch.Tensor, stealing=(1, 1),
                 tsc: int | None = None) -> torch.Tensor:
    """114 interleaved bits → 148-bit normal burst: bits 3..59 and
    88..144, stealing flags Hl/Hu at 60/87, training sequence at 61..86
    when `tsc` is given (the encoder hardcodes TSC=BCC,
    GSML1FEC.cpp:723-726), tails zero. i_frame: [..., 114]. A stealing
    flag is an int or a uint8/bool tensor of the leading shape."""
    i = i_frame.to(torch.uint8)
    lead = i.shape[:-1]
    dev = i.device

    def flag(v):
        if isinstance(v, torch.Tensor):
            return v.to(torch.uint8).expand(lead)[..., None]
        return torch.full(lead + (1,), int(v), dtype=torch.uint8, device=dev)

    zeros3 = torch.zeros(lead + (3,), dtype=torch.uint8, device=dev)
    if tsc is None:
        mid = torch.zeros(lead + (26,), dtype=torch.uint8, device=dev)
    else:
        mid = training_sequences_on(dev)[tsc].expand(lead + (26,))
    return torch.cat([zeros3, i[..., :57], flag(stealing[0]), mid,
                      flag(stealing[1]), i[..., 57:], zeros3], -1)


def xcch_encode(frames: torch.Tensor, stealing=(1, 1),
                tsc: int | None = None) -> torch.Tensor:
    """184-bit L1 frame → 4 bursts [..., 4, 148]
    (XCCHL1Encoder::encode + interleave + transmit,
    GSML1FEC.cpp:795-849). Input must already be in air bit order
    (callers apply `lsb8msb` to L2 octet frames)."""
    c = _facch_coded(frames)  # [..., 456]
    i = interleave(c, _xcch_map(c.device), 4)
    return map_to_burst(i, stealing, tsc=tsc)


def _tch_even() -> np.ndarray:
    """Coder bits 2k (k = 0..90): class 1 bits u[0..90]."""
    return 2 * np.arange(91, dtype=np.int64)


def _tch_odd_rev() -> np.ndarray:
    """Coder bits 2k+1 in the order of u[94..184] (u[184−k] = d[2k+1])."""
    return 2 * (184 - np.arange(94, 185, dtype=np.int64)) + 1


def tch_encode(d: torch.Tensor) -> torch.Tensor:
    """260-bit vocoder frame (coder order) → 456 coded bits
    (TCHFACCHL1Encoder::encodeTCH, GSML1FEC.cpp:1280-1310):
    u = [d[2k] (91) | parity (3) | d[2k+1] for u[94..184] (91) | tail (4)]."""
    d = d.to(torch.uint8)
    dev = d.device
    p = parity_word(d[..., :50], PARITY_TCH)
    tail = torch.zeros(d.shape[:-1] + (4,), dtype=torch.uint8, device=dev)
    u = torch.cat([d.index_select(-1, device_table(_tch_even, (), dev)), p,
                   d.index_select(-1, device_table(_tch_odd_rev, (), dev)),
                   tail], -1)  # [..., 189]
    c1 = conv_encode(u)  # [..., 378]
    return torch.cat([c1, d[..., 182:260]], -1)  # [..., 456]


def tchf_reverse_map() -> np.ndarray:
    """The TCH/F 26-multiframe (GSMTDMA.cpp:245-270): frame → burst index
    within the traffic pattern, −1 on the SACCH (12) and idle (25)
    frames."""
    out = np.full(26, -1, np.int32)
    for i, f in enumerate(f for f in range(25) if f != 12):
        out[f] = i
    return out


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
    rev = tchf_reverse_map()  # [26], −1 on SACCH/idle
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
    i_new = interleave(coded, _tch_map(dev), 8)
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
    bits = map_to_burst(i114, stealing=(hl, hu), tsc=None)
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
    p = parity_word(frames184, FIRECODE_XCCH)
    tail = torch.zeros(frames184.shape[:-1] + (4,), dtype=torch.uint8,
                       device=frames184.device)
    return conv_encode(torch.cat([frames184, p, tail], -1))
