"""GSMTAP burst/frame tap for Wireshark-style tracing.

Reference behavior: the intended-but-missing `GSMTAPDump.h` hook called
at `GSM/GSML1FEC.cpp:790` (`gWriteGSMTAP`) — every decoded frame/burst
can be mirrored to a UDP collector in GSMTAP v2 format (port 4729) for
live protocol tracing. This implementation completes what the fork left
dangling.
"""

from __future__ import annotations

import socket
import struct
from typing import Optional

import numpy as np

GSMTAP_PORT = 4729
GSMTAP_VERSION = 2
GSMTAP_TYPE_UM = 0x01
GSMTAP_BURST_NORMAL = 0x04

# GSMTAP channel types
CHANNEL_UNKNOWN = 0x00
CHANNEL_BCCH = 0x01
CHANNEL_CCCH = 0x02
CHANNEL_RACH = 0x03
CHANNEL_AGCH = 0x04
CHANNEL_PCH = 0x05
CHANNEL_SDCCH = 0x06
CHANNEL_SDCCH8 = 0x08
CHANNEL_TCH_F = 0x09
CHANNEL_ACCH = 0x80  # SACCH flag


class GSMTAPDumper:
    """UDP GSMTAP emitter (gWriteGSMTAP equivalent)."""

    def __init__(self, host: str = "127.0.0.1", port: int = GSMTAP_PORT,
                 enabled: bool = True):
        self.target = (host, port)
        self.enabled = enabled
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.count = 0

    def write(self, payload: bytes, *, arfcn: int = 0, tn: int = 0,
              fn: int = 0, chan_type: int = CHANNEL_SDCCH,
              rssi_db: int = 0, snr_db: int = 0, uplink: bool = True,
              sub_slot: int = 0) -> None:
        """Emit one GSMTAP v2 packet (16-byte header + payload)."""
        if not self.enabled:
            return
        flags = 0x4000 if uplink else 0  # ARFCN uplink flag
        header = struct.pack(
            "!BBBBHbBIBBBB",
            GSMTAP_VERSION,
            4,  # header length in 32-bit words
            GSMTAP_TYPE_UM,
            tn & 0x7,
            (arfcn & 0x3FFF) | flags,
            snr_db & 0x7F,
            rssi_db & 0xFF,
            fn & 0xFFFFFFFF,
            chan_type & 0xFF,
            sub_slot & 0xFF,
            0,  # antenna
            0,  # reserved
        )
        try:
            self.sock.sendto(header + payload, self.target)
            self.count += 1
        except OSError:
            pass

    def write_l2_frame(self, bits: np.ndarray, **kw) -> None:
        """Emit a decoded 23-octet L2 frame (the reference's tap
        point, GSML1FEC.cpp:790)."""
        padded = np.zeros(-(-len(bits) // 8) * 8, np.uint8)
        padded[: len(bits)] = np.asarray(bits, np.uint8)
        self.write(np.packbits(padded).tobytes(), **kw)


# module-level default tap (off until configured, like the missing
# GSMTAPDump globals)
gGSMTAP: Optional[GSMTAPDumper] = None


def enable(host: str = "127.0.0.1", port: int = GSMTAP_PORT) -> GSMTAPDumper:
    global gGSMTAP
    gGSMTAP = GSMTAPDumper(host, port)
    return gGSMTAP


def tap_frame(bits, **kw) -> None:
    if gGSMTAP is not None:
        gGSMTAP.write_l2_frame(bits, **kw)
