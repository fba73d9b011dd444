"""The in-call voice pump: TCH vocoder frames ↔ RTP.

Reference behavior: the in-call loop of `Control/CallControl.cpp:393-407`
— `TCH->recvTCH()` → `engine.TxFrame()` (uplink voice to RTP) and
`engine.RxFrame()` → `TCH->sendTCH()` (downlink voice to the air), with
GSM 06.10 frames in 33-byte RTP payloads (payload type 3).

The 33-byte wire format: 4-bit signature 0xD + 260 bits of vocoder
payload (RFC 3551 4.5.8.1).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

GSM_FRAME_BYTES = 33
GSM_SIGNATURE = 0xD


def payload_to_rtp(bits260: np.ndarray) -> bytes:
    """260 payload bits → 33-byte GSM-FR RTP frame."""
    bits = np.zeros(264, np.uint8)
    sig = GSM_SIGNATURE
    for i in range(4):
        bits[i] = (sig >> (3 - i)) & 1
    bits[4:264] = np.asarray(bits260, np.uint8)
    return np.packbits(bits).tobytes()


def rtp_to_payload(frame: bytes) -> Optional[np.ndarray]:
    """33-byte GSM-FR RTP frame → 260 payload bits (None if not GSM)."""
    if len(frame) < GSM_FRAME_BYTES:
        return None
    bits = np.unpackbits(np.frombuffer(frame[:GSM_FRAME_BYTES], np.uint8))
    sig = (bits[0] << 3) | (bits[1] << 2) | (bits[2] << 1) | bits[3]
    if sig != GSM_SIGNATURE:
        return None
    return bits[4:264]


class VoicePump:
    """Bridges one TCH channel with one SIP engine's RTP session."""

    def __init__(self, tch, engine):
        # accepts the TCHFACCHLogicalChannel wrapper or a bare
        # TCHFACCHL1: speech_out (uplink), send_tch (downlink)
        self.tch = getattr(tch, "l1", tch)
        self.engine = engine  # SIPEngine with an RTP session
        self.frames_up = 0
        self.frames_down = 0

    def pump(self, max_frames: int = 4) -> int:
        """Move pending voice both ways; returns frames moved
        (the CallControl in-call loop body)."""
        moved = 0
        # uplink: air → RTP
        for _ in range(max_frames):
            if not self.tch.speech_out:
                break
            payload = self.tch.speech_out.popleft()
            self.engine.tx_frame(payload_to_rtp(payload))
            self.frames_up += 1
            moved += 1
        # downlink: RTP → air
        for _ in range(max_frames):
            frame = self.engine.rx_frame()
            if frame is None:
                break
            payload = rtp_to_payload(frame)
            if payload is not None:
                self.tch.send_tch(payload)
                self.frames_down += 1
                moved += 1
        return moved
