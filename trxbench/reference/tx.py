"""The reference transmitter: one 13-frame window of downlink content
(L2 frames, speech, FACCH) → bursts → GMSK → the device-rate stream.

The benchmark's frozen copy of the port's `_encode_dl_window` (its
streaming XCCH layout), `_stamp_tsc`, `_assemble_stream` and
`trx/engine.py::tx_frames`, with the benchmark's own 96/65 resampler in
place of K1 (`models/transceiver.py`; Transceiver.cpp:672-722,
radioInterface.cpp:123-186, GSML1FEC.cpp:768-849, 1106-1120). It imports
nothing of the port. The traffic generator codes the uplink with it.
"""

from __future__ import annotations

import numpy as np
import torch

from trxbench.reference import coding, fir, gmsk
from trxbench.reference.rx import (FRAME_SYMBOLS, SLOT_SAMPLE_PATTERN,
                                   SLOT_SAMPLES)

#: tx stream continuity: the 651-tap 96/65 resampler reads ±4 symbols, so
#: each window carries the last 130 symbols of the one before
#: (radioInterface.h:35-41) and its output starts 96 device samples in
TX_TAIL_SYM = 130
TX_DELAY_DEV = (TX_TAIL_SYM // 2) * 96 // 65
DL_P, DL_Q, DL_TAPS = 96, 65, 651
#: coded XCCH frames a window carries to the next (a group started ≤ 3
#: frames before its edge)
XCCH_TX_CARRY = 3


def _sub(x: torch.Tensor, tns: tuple, axis: int) -> torch.Tensor:
    return x.index_select(axis, torch.as_tensor(tns, device=x.device))


def _back(x: torch.Tensor, tns: tuple, axis: int, fill=0) -> torch.Tensor:
    full = list(x.shape)
    full[axis] = 8
    out = torch.full(full, fill, dtype=x.dtype, device=x.device)
    return out.index_copy_(axis, torch.as_tensor(tns, device=x.device), x)


def _rep4(x: torch.Tensor) -> torch.Tensor:
    return x.unsqueeze(1).expand((x.shape[0], 4) + x.shape[1:]).reshape(
        (x.shape[0] * 4,) + x.shape[1:])


def xcch_carry_zeros(c: int, device):
    return (torch.zeros((XCCH_TX_CARRY, c, 8, 148), dtype=torch.uint8,
                        device=device),
            torch.zeros((XCCH_TX_CARRY, c, 8), dtype=torch.bool,
                        device=device))


def stamp_tsc(tsc: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Each carrier's training sequence (tsc [C]) into bits 61..86 of
    [F, C, 8, 148] bursts."""
    mid = coding.training_sequences_on(bits.device).index_select(
        0, tsc.to(torch.int64))
    mid = mid.reshape(1, bits.shape[1], 1, 26).expand(
        bits.shape[:-1] + (26,))
    return torch.cat([bits[..., :61], mid.to(bits.dtype), bits[..., 87:]],
                     -1)


def encode_window(content: tuple, tch_carry, xcch_carry, fn0: int,
                  tsc: torch.Tensor, xcch_tns: tuple, tch_tns: tuple,
                  frames: int = 13):
    """One window's content → (bits [F, C, 8, 148], valid [F, C, 8],
    tch_carry', xcch_carry'). content = (frames184 [4, C, 8, 184] on the
    absolute FN%4 grid, xcch_valid, speech [3, C, 8, 260], sp_valid,
    facch [3, C, 8, 184], fa_valid, tch_mask [C, 8]); fn0 the window's
    first frame number."""
    frames184, xcch_valid, speech, sp_valid, facch, fa_valid, tch_mask = \
        content
    f, c = frames, frames184.shape[1]
    xt, tt = tuple(xcch_tns), tuple(tch_tns)
    nx, nt = len(xt), len(tt)
    dev = frames184.device

    # XCCH on the absolute FN%4 grid, the tails of a group that crosses
    # the window's edge carried to the next window
    bursts = coding.xcch_encode(_sub(frames184, xt, 2), tsc=None)
    off = (-fn0) % 4
    cb, cv = (_sub(x, xt, 2) for x in xcch_carry)
    seq_b = torch.cat([cb, bursts.movedim(3, 1).reshape(16, c, nx, 148)])
    seq_v = torch.cat([cv, _rep4(_sub(xcch_valid, xt, 2))])
    start = XCCH_TX_CARRY - off
    xb, xv = seq_b[start: start + f], seq_v[start: start + f]
    off_next = (off - f) % 4
    cstart = start + f - (XCCH_TX_CARRY - off_next)
    keep = (torch.arange(XCCH_TX_CARRY, device=dev)
            >= XCCH_TX_CARRY - off_next)[:, None, None]
    xcch_carry2 = (_back(seq_b[cstart: cstart + XCCH_TX_CARRY], xt, 2),
                   _back(seq_v[cstart: cstart + XCCH_TX_CARRY] & keep, xt,
                         2, fill=False))
    xb, xv = _back(xb, xt, 2), _back(xv, xt, 2, fill=False)

    # TCH/FS + FACCH on the 26-multiframe diagonal
    n = c * nt
    carry_s = tuple(_sub(x.reshape((c, 8) + x.shape[1:]), tt, 1)
                    .reshape((n,) + x.shape[1:]) for x in tch_carry)
    gt = speech.shape[0]
    tb, is_burst, _hu, carry2 = coding.tch_tx_window(
        _sub(speech, tt, 2).reshape(gt, n, 260),
        _sub(sp_valid, tt, 2).reshape(gt, n),
        _sub(facch, tt, 2).reshape(gt, n, 184),
        _sub(fa_valid, tt, 2).reshape(gt, n), carry_s,
        torch.tensor(fn0, device=dev), f)
    tb = _back(tb.reshape(f, c, nt, 148), tt, 2)
    tv = _back(is_burst.reshape(f, c, nt), tt, 2, fill=False) \
        & tch_mask[None]
    tch_carry2 = tuple(
        _back(x.reshape((c, nt) + x.shape[1:]), tt, 1,
              fill=False if x.dtype == torch.bool else 0)
        .reshape((c * 8,) + x.shape[1:]) for x in carry2)

    bits = torch.where(tch_mask[None, :, :, None], tb, xb)
    valid = torch.where(tch_mask[None], tv, xv)
    return stamp_tsc(tsc, bits), valid, tch_carry2, xcch_carry2


def tx_frames(bits: torch.Tensor, valid: torch.Tensor, scale: float,
              filler: torch.Tensor) -> torch.Tensor:
    """[F, C, 8, 148] bits → [F, C, 8, 157] slot windows: GMSK with a
    9-symbol guard at `scale`, zero past each slot's 157/156 samples,
    `filler` [C, 8, 157] where not valid (Transceiver.cpp:165-175)."""
    f, c = bits.shape[0], bits.shape[1]
    t = SLOT_SAMPLES
    dev = bits.device
    mod = gmsk.modulate_burst(bits.reshape(-1, 148), 1, guard_len=9)
    mod = mod * torch.tensor(scale, dtype=torch.float32, device=dev)
    slot_len = torch.tensor(SLOT_SAMPLE_PATTERN, device=dev)
    mask = (torch.arange(t, device=dev)[None, :]
            < slot_len.repeat(f * c)[:, None])
    mod = torch.where(mask, mod[:, :t], torch.zeros((), dtype=mod.dtype,
                                                     device=dev))
    fill = filler.reshape(1, c * 8, t).expand(f, c * 8, t).reshape(-1, t)
    return torch.where(valid.reshape(-1)[:, None], mod, fill
                       ).reshape(f, c, 8, t)


def assemble(slots: torch.Tensor) -> torch.Tensor:
    """[F, C, 8, 157] slot windows → [C, F·1250] symbols at the
    157/156/156/156 offsets (a 156-sample slot's last window sample is
    zero, so the overlapping adds are exact)."""
    frames, c = slots.shape[0], slots.shape[1]
    offs = np.concatenate([[0], np.cumsum(SLOT_SAMPLE_PATTERN)])[:-1]
    idx = (np.arange(frames)[:, None, None] * FRAME_SYMBOLS
           + offs[None, :, None] + np.arange(SLOT_SAMPLES)[None, None, :])
    idx = np.minimum(idx, frames * FRAME_SYMBOLS)
    flat = torch.from_numpy(idx.reshape(-1)).to(slots.device)
    vals = slots.movedim(1, 0).reshape(c, -1)
    out = torch.zeros((c, frames * FRAME_SYMBOLS + 1, 2),
                      dtype=torch.float32, device=slots.device)
    out.index_add_(1, flat, torch.view_as_real(vals.contiguous()))
    return torch.view_as_complex(out[:, :-1].contiguous())


def tx_window(sym: torch.Tensor, tail: torch.Tensor, block_in: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """A window's symbols [C, F·1250] behind the last window's tail →
    (device-rate samples [C, block_in], the next tail)."""
    stream = torch.cat([tail.to(sym.dtype), sym], -1)
    y = fir.resample(stream, DL_P, DL_Q,
                     fir.resampler_lpf(DL_P, DL_Q, DL_TAPS))
    return (y[..., TX_DELAY_DEV: TX_DELAY_DEV + block_in],
            sym[..., -TX_TAIL_SYM:].contiguous())
