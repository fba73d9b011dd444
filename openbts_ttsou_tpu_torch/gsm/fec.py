"""FEC primitives: CRC/Fire parity, convolutional code, Viterbi, interleaving.

Port of `openbts_ttsou_tpu/gsm/fec.py`. Reference behavior:
`CommonLibs/BitVector.{h,cpp}` — `Generator` LFSR (BitVector.h:35-87),
`Parity` (BitVector.h:94), convolutional `encode` (BitVector.cpp:217),
`ViterbiR2O4` rate-1/2 K=5 soft decoder (BitVector.h:121,
BitVector.cpp:289-525) — and the GSM 05.03 interleaving formulas of
`GSM/GSML1FEC.cpp:616-630,811-822,1106-1120,1380-1393`.

* The Viterbi decoder reproduces the reference's deferred-decision
  decoder (deferral 24: emit the bit 24 steps back of the current best
  survivor, no traceback) bit for bit, including its tie-breaking: a
  strict `<` keeps the 0-prefix candidate, and the survivor is the first
  minimum. On the card it is one kernel launch a call (K8,
  `csrc/viterbi.cu`); the plain form for CPU tensors computes the branch
  metrics of every step in one batched pass, then issues only the
  add-compare-select (ten tensor ops a step).
* CRC state is a GF(2) product of the bits with the LFSR's unit-response
  matrix: exact in float32, since the sums are integers at most 228.
* Interleavers are constant index maps applied as gathers/scatters; every
  constant table is copied to the device once (`utils/tables.py`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from openbts_ttsou_tpu_torch.ops import cuda_viterbi
from openbts_ttsou_tpu_torch.utils import constants as C
from openbts_ttsou_tpu_torch.utils.profiling import span
from openbts_ttsou_tpu_torch.utils.tables import copy_table, device_table

# ---------------------------------------------------------------------------
# Parity / CRC (Generator + Parity)
# ---------------------------------------------------------------------------

# (poly, parity_bits, codeword_bits) as constructed in GSML1FEC.cpp:
FIRECODE_XCCH = (0x10004820009, 40, 224)  # GSML1FEC.cpp:537
PARITY_RACH = (0x06F, 6, 8)  # GSML1FEC.h:473
PARITY_SCH = (0x0575, 10, 25)  # GSML1FEC.cpp:882
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


def syndrome_ok(data_and_parity: torch.Tensor,
                spec=FIRECODE_XCCH) -> torch.Tensor:
    """True where the [..., K+P] codeword (with the *inverted* parity as
    transmitted) has zero syndrome (XCCHL1Decoder::decode,
    GSML1FEC.cpp:640-652: invert parity, then syndromeShift over d|p)."""
    poly, p, _ = spec  # the spec's codeword-size field is metadata only
    dp = data_and_parity.to(torch.uint8)
    n = dp.shape[-1]
    fixed = torch.cat([dp[..., : n - p], dp[..., n - p:] ^ 1], -1)
    state = crc_state_run(fixed, poly, p, encoder=False)
    return (state == 0).all(-1)


# ---------------------------------------------------------------------------
# Convolutional code (rate 1/2, K=5, G0=1+D³+D⁴, G1=1+D+D³+D⁴)
# ---------------------------------------------------------------------------

VITERBI_POLYS = (0x19, 0x1B)  # ViterbiR2O4 mCoeffs (BitVector.cpp:292-293)
V_ORDER = 4
V_STATES = 16
V_DEFERRAL = 24  # 6 * order (BitVector.h "mDeferral")


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
def _viterbi_tables():
    """Expected output bits per (path, new_state): path 0 is the previous
    state ns>>1, path 1 is (ns>>1)|8. Returns (e0 [2,16], e1 [2,16],
    prev [2,16]) uint8/int32."""
    e0 = np.zeros((2, V_STATES), np.uint8)
    e1 = np.zeros((2, V_STATES), np.uint8)
    prev = np.zeros((2, V_STATES), np.int32)

    def par(x):
        return bin(x).count("1") & 1

    for ns in range(V_STATES):
        b = ns & 1
        for path in range(2):
            p = (ns >> 1) | (8 * path)
            idx5 = ((p << 1) | b) & 0x1F
            e0[path, ns] = par(idx5 & VITERBI_POLYS[0])
            e1[path, ns] = par(idx5 & VITERBI_POLYS[1])
            prev[path, ns] = p
    return e0, e1, prev


def _viterbi_prev() -> np.ndarray:
    """[32] int64: the predecessor of each (path, new_state), path-major."""
    return _viterbi_tables()[2].reshape(-1).astype(np.int64)


def _viterbi_code() -> np.ndarray:
    """[32] int64: 2·e0 + e1, the expected output pair of each
    (path, new_state), path-major."""
    e0, e1, _ = _viterbi_tables()
    return (2 * e0 + e1).reshape(-1).astype(np.int64)


def _viterbi_low_bit() -> np.ndarray:
    """[16] int64: each new state's input bit (its LSB)."""
    return np.arange(V_STATES, dtype=np.int64) & 1


def codeword_rows(soft: torch.Tensor) -> torch.Tensor:
    """soft [..., 2K] as the kernel's [rows, 2K]: a view wherever the
    leading axes flatten to one row stride (so a slice of wider rows,
    TCH's [..., :378] or RACH's 36 bits of 148, is read in place), else a
    contiguous copy."""
    rows = soft.reshape(-1, soft.shape[-1])
    return rows if rows.stride(-1) == 1 else rows.contiguous()


@span("fec.viterbi")
def viterbi_decode(soft: torch.Tensor) -> torch.Tensor:
    """Soft-input Viterbi decode: [..., 2K] soft bits in [0,1] → [..., K]
    uint8 hard bits (K8): on CUDA tensors one launch of the kernel
    (`ops/cuda_viterbi.py`), on CPU tensors `viterbi_decode_plain`. The
    same bits, ties included."""
    soft = soft.to(torch.float32)
    if soft.is_cuda:
        bits = cuda_viterbi.viterbi_decode_cuda(codeword_rows(soft))
        return bits.reshape(soft.shape[:-1] + bits.shape[-1:])
    if soft.device.type != "cpu":
        raise ValueError(f"viterbi_decode: no kernel for {soft.device}")
    return viterbi_decode_plain(soft)


def viterbi_decode_plain(soft: torch.Tensor) -> torch.Tensor:
    """Soft-input Viterbi decode: [..., 2K] soft bits in [0,1] → [..., K]
    uint8 hard bits. Bit-exact emulation of SoftVector::decode +
    ViterbiR2O4::step (BitVector.cpp:289-525): deferred-decision decoder
    with deferral 24, cost tables 0.25/clamped probabilities, hard-sliced
    branch comparison, 0-prefix-preferred pruning. The CPU path, and what
    the card tests hold the kernel to.

    The histories are int64 (only bit 24 of a history is ever read, so
    the bits a wider word keeps above bit 31 change nothing)."""
    soft = soft.to(torch.float32)
    lead = soft.shape[:-1]
    soft2 = soft.reshape((-1, soft.shape[-1]))
    bsz, sz = soft2.shape
    assert sz % 2 == 0
    n_out = sz // 2
    steps = n_out + V_DEFERRAL
    dev = soft2.device

    # cost tables (BitVector.cpp:473-495): p = clamp(min(s,1−s), 0.01),
    # ip = clamp(1−p, 0.01); match=0.25/ip, mismatch=0.25/p; pads 0.5.
    # Tensor / tensor divides once (a Python scalar over a tensor would
    # take the reciprocal and multiply: two roundings)
    hard = soft2 > 0.5
    p = torch.clamp(torch.minimum(soft2, 1.0 - soft2), min=0.01)
    ip = torch.clamp(1.0 - p, min=0.01)
    quarter = torch.full_like(p, 0.25)
    match = quarter / ip
    mismatch = quarter / p

    # padded hard bits repeat the final sliced bit (BitVector.cpp:466-469)
    extra = 2 * steps - sz
    hard_p = torch.cat([hard, hard[:, -1:].expand(bsz, extra)], -1)
    half = torch.full((bsz, extra), 0.5, dtype=torch.float32, device=dev)
    match_p = torch.cat([match, half], -1)
    mismatch_p = torch.cat([mismatch, half], -1)

    # branch metrics of every step at once, [steps, B, 32]: the metric
    # of expected pair (e0, e1) is v0(e0) + v1(e1), where v is the
    # mismatch cost if the expected bit differs from the sliced one, else
    # the match cost (the reference's per-bit select, one fp32 add)
    def per_bit(j):
        h = hard_p[:, j::2].T  # [steps, B]
        ma, mi = match_p[:, j::2].T, mismatch_p[:, j::2].T
        return torch.stack([torch.where(h, mi, ma),   # expected bit 0
                            torch.where(h, ma, mi)], -1)  # expected bit 1

    v0, v1 = per_bit(0), per_bit(1)  # [steps, B, 2]
    bm4 = (v0[..., :, None] + v1[..., None, :]).reshape(steps, bsz, 4)
    bm = bm4.index_select(2, device_table(_viterbi_code, (), dev))
    bm = bm.view(steps, bsz, 2, V_STATES)
    del v0, v1, bm4

    prev = device_table(_viterbi_prev, (), dev)
    low = device_table(_viterbi_low_bit, (), dev)
    cost = torch.zeros((bsz, V_STATES), dtype=torch.float32, device=dev)
    hist = torch.zeros((bsz, V_STATES), dtype=torch.int64, device=dev)
    picked = []  # history of the best survivor, per emitting step
    for t in range(steps):
        cand = cost.index_select(1, prev).view(bsz, 2, V_STATES) + bm[t]
        take1 = cand[:, 1] < cand[:, 0]  # strict: ties keep the 0-prefix
        cost = torch.where(take1, cand[:, 1], cand[:, 0])
        h = hist.index_select(1, prev).view(bsz, 2, V_STATES)
        hist = (torch.where(take1, h[:, 1], h[:, 0]) << 1) | low
        if t >= V_DEFERRAL:
            best = torch.argmin(cost, 1, keepdim=True)  # first minimum
            picked.append(torch.gather(hist, 1, best))
    bits = ((torch.cat(picked, 1) >> V_DEFERRAL) & 1).to(torch.uint8)
    return bits.reshape(lead + (n_out,))


# ---------------------------------------------------------------------------
# Interleaving (GSM 05.03)
# ---------------------------------------------------------------------------

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


def _map64(fn, *args) -> np.ndarray:
    return fn(*args).astype(np.int64)


def interleave_map_on(fn, device, *args) -> torch.Tensor:
    """An interleave map (`xcch_interleave_map`, `tch_interleave_map`) as
    an int64 index tensor on `device`, copied once."""
    return device_table(_map64, (fn,) + args, torch.device(device))


def _as_index(imap, device) -> torch.Tensor:
    if isinstance(imap, torch.Tensor):
        return imap.to(device=device, dtype=torch.int64)
    return copy_table(np.asarray(imap, np.int64), device)


def interleave(c: torch.Tensor, imap, num_bursts: int) -> torch.Tensor:
    """c [..., 456] → i [..., num_bursts, 114] via scatter. `imap` is a
    numpy map or an index tensor (`interleave_map_on`)."""
    flat = torch.zeros(c.shape[:-1] + (num_bursts * 114,), dtype=c.dtype,
                       device=c.device)
    flat.index_copy_(-1, _as_index(imap, c.device), c)
    return flat.reshape(c.shape[:-1] + (num_bursts, 114))


def deinterleave(i: torch.Tensor, imap) -> torch.Tensor:
    """i [..., num_bursts, 114] → c [..., 456] via gather."""
    flat = i.reshape(i.shape[:-2] + (-1,))
    return flat.index_select(-1, _as_index(imap, i.device))


# ---------------------------------------------------------------------------
# Burst mapping (GSM 05.02 5.2.3; GSML1FEC.cpp:823-849 / 550-614)
# ---------------------------------------------------------------------------

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


def unmap_from_burst(burst: torch.Tensor):
    """148 soft/hard bits → (114 payload bits, (hl, hu) stealing flags)
    (XCCHL1Decoder::processBurst reads data1/data2,
    GSML1FEC.cpp:572-614)."""
    payload = torch.cat([burst[..., 3:60], burst[..., 88:145]], -1)
    return payload, (burst[..., 60], burst[..., 87])
