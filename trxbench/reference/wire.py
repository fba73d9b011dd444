"""The reference for the bytes of the served path: what a transceiver
that speaks OpenBTS's UDP planes sends the BTS for one block, and what it
gives its radio's DAC.

Uplink: a block's int16 window (the radio's samples, with one polyphase
period of halo a side) through the benchmark's resampler and the frozen
per-frame receiver (`reference/rx.py`), each detection serialized as
driveReceiveFIFO does (Transceiver.cpp:652-667, parsed by TRXManager.cpp:
205-234): TN, FN (4 bytes, big-endian), RSSI (dB below full scale, one
byte), TOA (1/256 symbol, 2 bytes big-endian, two's complement), the 148
soft bits ×255 rounded half to even and clipped to 0..255, 2 pad bytes.
Downlink: a block of bursts through the frozen transmitter
(`reference/tx.py`: GMSK, the slot layout, the 96/65 resampler behind
the last block's tail) and into the DAC's int16 I/Q, rounded half to
even and clipped at ±32767 as USRPifyVector does (radioInterface.cpp:
101-146).

Plain PyTorch and numpy; it imports nothing of the port. float32 with
TF32 off, as the configuration states: set here at import and again by
the harness at each run's start (the TF32 control turns it on for its
own reading).
"""

from __future__ import annotations

import numpy as np
import torch

from trxbench.reference import constants as C
from trxbench.reference import fir
from trxbench.reference import rx as ref
from trxbench.reference import tx as reftx

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: bytes of an uplink datagram
UPLINK_LEN = 1 + 4 + 1 + 2 + 148 + 2
#: the receiver's halo a side, device samples (one 96-sample polyphase
#: period), and its length at the symbol rate
RX_HALO_DEV = 96
RX_HALO_SYM = RX_HALO_DEV * ref.UL_P // ref.UL_Q


def serialize(res: ref.RxResult, fn0: int) -> tuple[np.ndarray, np.ndarray]:
    """Every detection of a block's results [F, C, 8, ...] as a datagram:
    (carriers [n] int64, datagrams [n, UPLINK_LEN] uint8), frame-major."""
    det = res.detected.cpu().numpy()
    f, c, tn = np.nonzero(det)
    n = len(f)
    soft = torch.clamp(torch.round(res.soft_bits * 255.0), 0.0, 255.0
                       ).to(torch.uint8).cpu().numpy()
    rssi = res.rssi.cpu().numpy().astype(np.int64)
    toa = res.timing.cpu().numpy().astype(np.int64) & 0xFFFF
    out = np.zeros((n, UPLINK_LEN), np.uint8)
    out[:, 0] = tn
    fn = ((fn0 + f) % ref.HYPERFRAME).astype(">u4")
    out[:, 1:5] = fn[:, None].view(np.uint8).reshape(n, 4)
    out[:, 5] = rssi[f, c, tn] & 0xFF
    out[:, 6] = toa[f, c, tn] >> 8
    out[:, 7] = toa[f, c, tn] & 0xFF
    out[:, 8:156] = soft[f, c, tn]
    return c.astype(np.int64), out


def uplink(cfg: ref.TrxConfig, state: ref.TrxState, ul_i16: torch.Tensor,
           frames: int) -> tuple[ref.TrxState, np.ndarray, np.ndarray]:
    """One block's uplink: (state after, carriers, datagrams). ul_i16 is
    the int16 window [C, halo + block_in + halo, 2]; the block's first
    frame number is the state's."""
    x = torch.complex(ul_i16[..., 0].to(torch.float32),
                      ul_i16[..., 1].to(torch.float32))
    sym = fir.resample(x, ref.UL_P, ref.UL_Q,
                       fir.resampler_lpf(ref.UL_P, ref.UL_Q, ref.UL_TAPS))
    fn0 = int(state.fn)
    state2, res = ref.rx_symbols(cfg, state, sym[..., RX_HALO_SYM:], frames)
    carriers, datagrams = serialize(res, fn0)
    return state2, carriers, datagrams


def dac(tx: torch.Tensor) -> np.ndarray:
    """Device-rate samples [C, T] complex → the DAC's int16 I/Q [C, T, 2]."""
    iq = torch.stack([tx.real, tx.imag], -1)
    return torch.clamp(torch.round(iq), -32767.0, 32767.0).to(
        torch.int16).cpu().numpy()


def downlink(bits: torch.Tensor, filler: torch.Tensor, tail: torch.Tensor,
             block_in: int) -> tuple[np.ndarray, torch.Tensor]:
    """One block's downlink, every burst present: bits [F, C, 8, 148] at
    full scale (attenuation 0) behind the last block's tail [C, 130] →
    (DAC rows [C, block_in, 2] int16, the next tail)."""
    valid = torch.ones(bits.shape[:3], dtype=torch.bool, device=bits.device)
    slots = reftx.tx_frames(bits, valid, C.TX_FULL_SCALE, filler)
    tx, tail2 = reftx.tx_window(reftx.assemble(slots), tail, block_in)
    return dac(tx), tail2
