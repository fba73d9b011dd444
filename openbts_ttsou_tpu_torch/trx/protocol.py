"""The TRX↔BTS wire protocol: data / control / clock planes.

Byte-compatible with the reference's UDP protocol so an unmodified BTS
stack (TRXManager) can drive this transceiver:

- data downlink (BTS→TRX), 154 bytes:
  ``[TN | FN:4 BE | gain | 148 bit-bytes]``
  (driveTransmitPriorityQueue, Transceiver52M/Transceiver.cpp:571-630)
- data uplink (TRX→BTS), 158 bytes:
  ``[TN | FN:4 BE | RSSI | TOA:2 BE | 148 soft-bytes ×255 | NUL]``
  (driveReceiveFIFO, Transceiver.cpp:632-670; parse
  TRXManager.cpp:205-234)
- control: text ``CMD <verb> [args]`` → ``RSP <verb> <status> [args]``
  (driveControl, Transceiver.cpp:423-569)
- clock: text ``IND CLOCK <fn>`` (writeClockInterface,
  Transceiver.cpp:726-739)

NumPy only: the port's own copy of `openbts_ttsou_tpu/trx/protocol.py`.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

SLOT_LEN = 148
DOWNLINK_LEN = 1 + 4 + 1 + SLOT_LEN  # 154
UPLINK_LEN = 1 + 4 + 1 + 2 + SLOT_LEN + 2  # 158 (trailing NUL + pad)

CLOCK_LEAD_FRAMES = 20  # IND CLOCK FN+20 (Transceiver.cpp:731)
CLOCK_PERIOD_FRAMES = 216  # beacon cadence (Transceiver.cpp:605-609)


@dataclasses.dataclass
class DownlinkBurst:
    tn: int
    fn: int
    gain: int  # relative attenuation in dB (addRadioVector RSSI arg)
    bits: np.ndarray  # [148] uint8


@dataclasses.dataclass
class UplinkBurst:
    tn: int
    fn: int
    rssi: int  # dB below full scale (positive)
    toa: int  # 1/256 symbol units
    soft: np.ndarray  # [148] float in [0, 1]


def pack_downlink(b: DownlinkBurst) -> bytes:
    head = struct.pack(">BIB", b.tn, b.fn & 0xFFFFFFFF, b.gain & 0xFF)
    return head + bytes(np.asarray(b.bits, np.uint8).tobytes())


def pack_downlink_block(bits: np.ndarray, valid: np.ndarray, fn0: int,
                        gain: int = 0,
                        hyperframe: int = 2715648) -> np.ndarray:
    """Vectorized downlink packet assembly (the BTS side of the wire):
    bits [F, 8, 148] uint8, valid [F, 8] bool. Returns [n, 154] uint8
    datagrams, bytes identical to `pack_downlink`, frame-major."""
    idx = np.argwhere(np.asarray(valid, bool))
    n = idx.shape[0]
    out = np.zeros((n, DOWNLINK_LEN), np.uint8)
    if n == 0:
        return out
    f, tn = idx[:, 0], idx[:, 1]
    fn = ((fn0 + f) % hyperframe).astype(">u4")
    out[:, 0] = tn
    out[:, 1:5] = fn[:, None].view(np.uint8).reshape(n, 4)
    out[:, 5] = gain & 0xFF
    out[:, 6:6 + SLOT_LEN] = np.asarray(bits)[f, tn]
    return out


def unpack_downlink(data: bytes) -> DownlinkBurst:
    if len(data) != DOWNLINK_LEN:
        raise ValueError(f"bad downlink length {len(data)}")
    tn, fn, gain = struct.unpack(">BIB", data[:6])
    bits = np.frombuffer(data[6:6 + SLOT_LEN], np.uint8).copy()
    return DownlinkBurst(tn, fn, gain, bits)


def pack_uplink(b: UplinkBurst) -> bytes:
    head = struct.pack(">BIBh", b.tn, b.fn & 0xFFFFFFFF, b.rssi & 0xFF,
                       b.toa)
    soft = np.clip(np.round(np.asarray(b.soft) * 255.0), 0, 255).astype(
        np.uint8)
    return head + soft.tobytes() + b"\x00\x00"


def pack_uplink_block(det: np.ndarray, soft_u8: np.ndarray,
                      rssi: np.ndarray, timing: np.ndarray,
                      fn0: int, hyperframe: int = 2715648) -> np.ndarray:
    """Vectorized uplink packet assembly for one carrier's block:
    det [F, 8] bool, soft_u8 [F, 8, 148] uint8 (wire-scaled ×255),
    rssi/timing [F, 8] int. Returns [n_detected, 158] uint8 datagrams
    (one per detection, same bytes as `pack_uplink`), frame-major so
    they leave in time order (driveReceiveFIFO, Transceiver.cpp:652-667).
    """
    idx = np.argwhere(np.asarray(det, bool))  # [n, 2] = (frame, tn)
    n = idx.shape[0]
    out = np.zeros((n, UPLINK_LEN), np.uint8)
    if n == 0:
        return out
    f, tn = idx[:, 0], idx[:, 1]
    fn = ((fn0 + f) % hyperframe).astype(">u4")
    out[:, 0] = tn
    out[:, 1:5] = fn[:, None].view(np.uint8).reshape(n, 4)
    out[:, 5] = (np.asarray(rssi)[f, tn] & 0xFF).astype(np.uint8)
    out[:, 6:8] = (np.asarray(timing)[f, tn].astype(">i2")[:, None]
                   .view(np.uint8).reshape(n, 2))
    out[:, 8:8 + SLOT_LEN] = np.asarray(soft_u8)[f, tn]
    return out


def unpack_uplink(data: bytes) -> UplinkBurst:
    if len(data) < UPLINK_LEN - 2:
        raise ValueError(f"bad uplink length {len(data)}")
    tn, fn, rssi, toa = struct.unpack(">BIBh", data[:8])
    soft = np.frombuffer(data[8:8 + SLOT_LEN], np.uint8).astype(
        np.float32) / 255.0
    return UplinkBurst(tn, fn, rssi, toa, soft)


def pack_command(verb: str, *args) -> bytes:
    parts = ["CMD", verb] + [str(a) for a in args]
    return (" ".join(parts)).encode() + b"\x00"


def pack_response(verb: str, status: int, *args) -> bytes:
    parts = ["RSP", verb, str(status)] + [str(a) for a in args]
    return (" ".join(parts)).encode() + b"\x00"


def parse_message(data: bytes) -> tuple[str, str, list[str]]:
    """Parse a control/clock text message → (kind, verb, args), where
    kind is CMD/RSP/IND."""
    text = data.rstrip(b"\x00").decode(errors="replace")
    parts = text.split()
    if len(parts) < 2:
        raise ValueError(f"bogus control message {text!r}")
    return parts[0], parts[1], parts[2:]


def pack_clock(fn: int) -> bytes:
    return f"IND CLOCK {fn}".encode() + b"\x00"
