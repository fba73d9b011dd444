"""The GSM 05.03 uplink decoders the benchmark needs, plain PyTorch.

The benchmark's frozen copy of the decoding half of the port's
`gsm/fec.py`, `gsm/l1fec.py` and `models/transceiver.py` `decode_block`
(it imports nothing of the port): the soft-input Viterbi decoder of
OpenBTS's `ViterbiR2O4` (deferral 24, no traceback, a strict `<` that
keeps the 0-prefix candidate, the first minimum as the survivor), the
Fire code and parity checks, the XCCH 4-burst and TCH/FS + FACCH 8-burst
deinterleavers and the RACH decoder, over one window's soft bits with
the previous window's last 8 frames carried in front. Reference
behavior: `CommonLibs/BitVector.cpp:289-525` and
`GSM/GSML1FEC.cpp:474-513, 572-655, 1031-1175`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from trxbench.reference import coding
from trxbench.reference.coding import device_table, row_at

HYPERFRAME = 2048 * 26 * 51
PARITY_RACH = (0x06F, 6, 8)  # GSML1FEC.h:473
RACH_DATA_START = 49  # RACHL1Decoder reads segment(49, 36), GSML1FEC.cpp:478
PRELUDE = 8  # frames of soft bits carried from the previous window
V_STATES = 16
V_DEFERRAL = 24


class Decoded(NamedTuple):
    """One window's decodes, in the port's `DecodedBlocks` order."""

    bits: torch.Tensor  # [G, C, 8, 184] uint8 XCCH frames
    ok: torch.Tensor  # [G, C, 8] bool
    first_fn: torch.Tensor  # [] int32
    rach_ra: torch.Tensor  # [F, C, 8] int32
    rach_ok: torch.Tensor  # [F, C, 8] bool
    tch_speech: torch.Tensor  # [Gt, C, 8, 260] uint8
    tch_good: torch.Tensor  # [Gt, C, 8] bool
    facch_bits: torch.Tensor  # [Gt, C, 8, 184] uint8
    facch_ok: torch.Tensor  # [Gt, C, 8] bool
    tch_stolen: torch.Tensor  # [Gt, C, 8] bool
    tch_end_fn: torch.Tensor  # [Gt] int32
    tch_valid: torch.Tensor  # [Gt] bool


# ---- the Viterbi decoder ---------------------------------------------------

@functools.lru_cache(maxsize=None)
def _trellis() -> tuple[np.ndarray, np.ndarray]:
    """(prev [32], code [32]) int64, path-major over (path, new state):
    the predecessor state and the expected output pair 2·g0 + g1."""
    prev = np.zeros(2 * V_STATES, np.int64)
    code = np.zeros(2 * V_STATES, np.int64)
    for path in range(2):
        for ns in range(V_STATES):
            p = (ns >> 1) | (8 * path)
            reg = ((p << 1) | (ns & 1)) & 0x1F
            g = [bin(reg & poly).count("1") & 1
                 for poly in coding.VITERBI_POLYS]
            prev[path * V_STATES + ns] = p
            code[path * V_STATES + ns] = 2 * g[0] + g[1]
    return prev, code


def _prev() -> np.ndarray:
    return _trellis()[0]


def _code() -> np.ndarray:
    return _trellis()[1]


def viterbi_decode(soft: torch.Tensor) -> torch.Tensor:
    """[..., 2K] soft bits in [0, 1] → [..., K] uint8 (SoftVector::decode
    + ViterbiR2O4::step): costs 0.25/ip on a match and 0.25/p on a
    mismatch of the sliced bit, p = max(min(s, 1 − s), 0.01), ip =
    max(1 − p, 0.01); 24 padding steps of cost 0.5 repeating the last
    sliced bit; at each step after the 24th, bit 24 of the history of
    the first state of least cost."""
    lead = soft.shape[:-1]
    s = soft.to(torch.float32).reshape(-1, soft.shape[-1])
    b, n = s.shape
    k = n // 2
    steps = k + V_DEFERRAL
    dev = s.device
    hard = s > 0.5
    p = torch.clamp(torch.minimum(s, 1.0 - s), min=0.01)
    ip = torch.clamp(1.0 - p, min=0.01)
    quarter = torch.full_like(p, 0.25)
    match, mismatch = quarter / ip, quarter / p
    pad = 2 * steps - n
    hard = torch.cat([hard, hard[:, -1:].expand(b, pad)], -1)
    half = torch.full((b, pad), 0.5, dtype=torch.float32, device=dev)
    match = torch.cat([match, half], -1)
    mismatch = torch.cat([mismatch, half], -1)

    def cost_of(j: int) -> torch.Tensor:
        """[steps, B, 2]: the cost of expecting 0 and 1 at bit j of each
        step's pair."""
        h = hard[:, j::2].T
        ma, mi = match[:, j::2].T, mismatch[:, j::2].T
        return torch.stack([torch.where(h, mi, ma), torch.where(h, ma, mi)],
                           -1)

    c0, c1 = cost_of(0), cost_of(1)
    pair = (c0[..., :, None] + c1[..., None, :]).reshape(steps, b, 4)
    branch = pair.index_select(2, device_table(_code, (), dev))
    branch = branch.view(steps, b, 2, V_STATES)
    prev = device_table(_prev, (), dev)
    low = torch.arange(V_STATES, dtype=torch.int64, device=dev) & 1
    cost = torch.zeros((b, V_STATES), dtype=torch.float32, device=dev)
    hist = torch.zeros((b, V_STATES), dtype=torch.int64, device=dev)
    out = []
    for t in range(steps):
        cand = cost.index_select(1, prev).view(b, 2, V_STATES) + branch[t]
        one = cand[:, 1] < cand[:, 0]
        cost = torch.where(one, cand[:, 1], cand[:, 0])
        h = hist.index_select(1, prev).view(b, 2, V_STATES)
        hist = (torch.where(one, h[:, 1], h[:, 0]) << 1) | low
        if t >= V_DEFERRAL:
            best = torch.argmin(cost, 1, keepdim=True)
            out.append(torch.gather(hist, 1, best))
    bits = ((torch.cat(out, 1) >> V_DEFERRAL) & 1).to(torch.uint8)
    return bits.reshape(lead + (k,))


# ---- codes, fields, maps ---------------------------------------------------

def syndrome_ok(word: torch.Tensor, spec) -> torch.Tensor:
    """True where data | inverted parity has a zero syndrome
    (GSML1FEC.cpp:640-652)."""
    poly, p, _ = spec
    w = word.to(torch.uint8)
    n = w.shape[-1]
    fixed = torch.cat([w[..., : n - p], w[..., n - p:] ^ 1], -1)
    return (coding.crc_state_run(fixed, poly, p, encoder=False)
            == 0).all(-1)


def field(bits: torch.Tensor, pos: int, width: int) -> torch.Tensor:
    """The MSB-first integer at bits[pos: pos + width], int32."""
    w = 1 << torch.arange(width - 1, -1, -1, dtype=torch.int32,
                          device=bits.device)
    return (bits[..., pos: pos + width].to(torch.int32) * w).sum(
        -1, dtype=torch.int32)


def lsb8msb(bits: torch.Tensor) -> torch.Tensor:
    """Each whole byte's bits reversed (BitVector::LSB8MSB)."""
    n = bits.shape[-1]
    n8 = 8 * (n // 8)
    rev = torch.flip(bits[..., :n8].reshape(bits.shape[:-1] + (n // 8, 8)),
                     (-1,))
    return torch.cat([rev.reshape(bits.shape[:-1] + (n8,)), bits[..., n8:]],
                     -1)


def _payload(burst: torch.Tensor) -> torch.Tensor:
    """The 114 data bits of 148-bit bursts."""
    return torch.cat([burst[..., 3:60], burst[..., 88:145]], -1)


def _deinterleave(i: torch.Tensor, fn, *args) -> torch.Tensor:
    idx = device_table(coding._map64, (fn,) + args, i.device)
    return i.reshape(i.shape[:-2] + (-1,)).index_select(-1, idx)


def xcch_decode_coded(c: torch.Tensor):
    """456 soft coded bits → (184 bits, Fire code ok)."""
    u = viterbi_decode(c)
    return u[..., :184], syndrome_ok(u[..., :224], coding.FIRECODE_XCCH)


def _u_odd() -> np.ndarray:
    return 184 - np.arange(91, dtype=np.int64)


def tch_decode(c: torch.Tensor):
    """456 soft coded bits → (260 coder-order bits, parity and tail ok)
    (GSML1FEC.cpp:1125-1175)."""
    c = c.to(torch.float32)
    u = viterbi_decode(c[..., :378])
    lead = u.shape[:-1]
    odd = u.index_select(-1, device_table(_u_odd, (), u.device))
    d182 = torch.stack([u[..., :91], odd], -1).reshape(lead + (182,))
    d = torch.cat([d182, (c[..., 378:] > 0.5).to(torch.uint8)], -1)
    sent = (~field(u, 91, 3)) & 0x7
    calc = field(coding.parity_word(d[..., :50], coding.PARITY_TCH,
                                    invert=False), 0, 3)
    return d, (sent == calc) & (field(u, 185, 4) == 0)


def rach_decode(soft: torch.Tensor, bsic: int):
    """36 soft bits → (RA, ok) (GSML1FEC.cpp:474-513)."""
    u = viterbi_decode(soft)
    sent = (~field(u, 8, 6)) & 0x3F
    calc = field(coding.parity_word(u[..., :8], PARITY_RACH, invert=False),
                 0, 6)
    ok = (field(u, 14, 4) == 0) & ((sent ^ calc) == bsic)
    return field(lsb8msb(u[..., :8]), 0, 8), ok


@functools.lru_cache(maxsize=None)
def _tch_groups(frames: int):
    """Per phase fn0 % 26: the frames of each TCH 8-burst half-block that
    completes inside a window of `frames` frames (frame_idx [26, Gt, 8],
    end [26, Gt], valid [26, Gt])."""
    rev = coding.tchf_reverse_map()
    groups = []
    for p in range(26):
        tch = [(f, int(rev[(p + f) % 26]) % 8) for f in range(frames)
               if rev[(p + f) % 26] >= 0]
        groups.append([([tch[i - 7 + j][0] for j in range(8)], f)
                       for i, (f, b) in enumerate(tch)
                       if b % 4 == 3 and i >= 7])
    gt = max(1, max(len(g) for g in groups))
    idx = np.zeros((26, gt, 8), np.int64)
    end = np.zeros((26, gt), np.int64)
    valid = np.zeros((26, gt), bool)
    for p, gs in enumerate(groups):
        for g, (fr, f_end) in enumerate(gs):
            idx[p, g], end[p, g], valid[p, g] = fr, f_end, True
    return idx, end, valid


def _tch_group(frames: int, k: int) -> np.ndarray:
    return _tch_groups(frames)[k]


def _lanes(x: torch.Tensor, tns: tuple, axis: int, fill=0) -> torch.Tensor:
    """A result over the slots `tns` back in the full 8-slot lane."""
    shape = list(x.shape)
    shape[axis] = 8
    out = torch.full(shape, fill, dtype=x.dtype, device=x.device)
    idx = torch.tensor(tns, dtype=torch.int64, device=x.device)
    return out.index_copy_(axis, idx, x)


def _pick(x: torch.Tensor, tns: tuple, axis: int) -> torch.Tensor:
    return x.index_select(axis, torch.tensor(tns, dtype=torch.int64,
                                             device=x.device))


# ---- one window ------------------------------------------------------------

def decode_window(soft: torch.Tensor, is_rach: torch.Tensor, fn0: int,
                  prev_soft: torch.Tensor, prev_valid: bool, bsic: int,
                  xcch_tns: tuple, tch_tns: tuple, rach_tns: tuple | None
                  ) -> Decoded:
    """One window's decodes from its soft bits [F, C, 8, 148] and RACH
    flags [F, C, 8], with the previous window's last PRELUDE frames of
    soft bits in front: every XCCH group and TCH/FACCH half-block that
    ends inside the window (one reaching into the prelude only where
    `prev_valid`), and every detected access burst on `rach_tns` (all
    slots where None). Slots outside a decoder's list report nothing."""
    frames, c = soft.shape[0], soft.shape[1]
    dev = soft.device
    p = PRELUDE
    every = torch.cat([prev_soft.to(soft.dtype), soft])  # [p + F, C, 8, 148]
    start = (int(fn0) - p) % HYPERFRAME
    off = (-start) % 4

    # XCCH: the 4-burst groups on the FN % 4 grid
    n_g = (p + frames) // 4
    xt = tuple(xcch_tns)
    sx = _pick(every, xt, 2)
    sx = torch.cat([sx, sx.new_zeros((3,) + sx.shape[1:])])[off: off
                                                            + 4 * n_g]
    grp = sx.reshape(n_g, 4, c, len(xt), 148).movedim(1, 3)
    coded = _deinterleave(_payload(grp.to(torch.float32)),
                          coding.xcch_interleave_map)
    bits, ok = xcch_decode_coded(coded)
    ends = off + 4 * (np.arange(n_g) + 1)
    whole = (ends <= p + frames) & (ends > p) & ((ends - 4 >= p)
                                                 | bool(prev_valid))
    ok = ok & torch.from_numpy(whole).to(dev)[:, None, None]

    # RACH on every detected access burst
    rt = tuple(range(8)) if rach_tns is None else tuple(rach_tns)
    rs = _pick(soft[..., RACH_DATA_START: RACH_DATA_START + 36], rt, 2)
    ra, ra_ok = rach_decode(rs, bsic)

    # TCH/FS + FACCH 8-burst half-blocks
    n_fr = p + frames
    ph = torch.tensor(start % 26, dtype=torch.int64, device=dev)
    gf = row_at(device_table(_tch_group, (n_fr, 0), dev), ph)
    ge = row_at(device_table(_tch_group, (n_fr, 1), dev), ph)
    gv = row_at(device_table(_tch_group, (n_fr, 2), dev), ph)
    gv = gv & (ge >= p) & ((gf[:, 0] >= p) | bool(prev_valid))
    gt = gf.shape[0]
    tt = tuple(tch_tns)
    st = _pick(every, tt, 2).index_select(0, gf.reshape(-1))
    st = st.reshape(gt, 8, c, len(tt), 148).movedim(1, 3)
    coded = _deinterleave(_payload(st), coding.tch_interleave_map, 0)
    stolen = st[..., 7, 60] > 0.5  # the newest burst's Hl flag
    speech, good = tch_decode(coded)
    fbits, f_ok = xcch_decode_coded(coded)
    gvc = gv[:, None, None]
    return Decoded(
        bits=_lanes(bits, xt, 2), ok=_lanes(ok, xt, 2, False),
        first_fn=torch.tensor((start + off) % HYPERFRAME, dtype=torch.int32,
                              device=dev),
        rach_ra=_lanes(ra, rt, 2), rach_ok=_lanes(ra_ok, rt, 2, False)
        & is_rach,
        tch_speech=_lanes(speech, tt, 2),
        tch_good=_lanes(good & ~stolen, tt, 2, False) & gvc,
        facch_bits=_lanes(fbits, tt, 2),
        facch_ok=_lanes(f_ok & stolen, tt, 2, False) & gvc,
        tch_stolen=_lanes(stolen, tt, 2, False) & gvc,
        tch_end_fn=torch.where(gv, (start + ge) % HYPERFRAME, -1).to(
            torch.int32),
        tch_valid=gv)


def differences(program, reference: Decoded) -> int:
    """The decoded units (an XCCH group, a TCH half-block, a RACH burst on
    one carrier and slot) in which the program's decodes differ from the
    reference's in any bit or flag, plus the window-wide fields that
    differ. `program`: the port's 12 fields in `Decoded` order."""
    p = [torch.as_tensor(t).to(reference.bits.device) for t in program]
    r = list(reference)
    names = Decoded._fields
    f = {n: (a, b) for n, a, b in zip(names, p, r)}

    def unit(*keys):
        """[..., C, 8] where any of the keys' values differ."""
        out = None
        for k in keys:
            a, b = f[k]
            if a.shape != b.shape:
                raise ValueError(f"{k}: shape {tuple(a.shape)} against "
                                 f"{tuple(b.shape)}")
            d = a != b
            if d.ndim == 4:
                d = d.any(-1)
            out = d if out is None else out | d
        return out

    n = int(unit("bits", "ok").sum())
    n += int(unit("rach_ra", "rach_ok").sum())
    n += int(unit("tch_speech", "tch_good", "facch_bits", "facch_ok",
                  "tch_stolen").sum())
    for k in ("first_fn", "tch_end_fn", "tch_valid"):
        a, b = f[k]
        n += int((a != b).sum())
    return n
