"""RTP session for GSM 06.10 full-rate voice with a jitter buffer
and RTCP.

Reference behavior: the libortp usage inside `SIP/SIPEngine.cpp`
(`TxFrame`/`RxFrame`, SIPEngine.h:268-269): payload type 3 (GSM-FR),
33-byte frames, 160 samples (20 ms) per frame at 8 kHz. libortp's
receive side reorders by sequence number and rides over loss; the
small sequence-ordered jitter buffer here covers that role — frames
come out of `rx_frame` in sequence order, out-of-order arrivals up to
`jitter_depth` frames are re-slotted, late duplicates are dropped,
and a loss is skipped once the buffer backs up behind the gap. The
depth ADAPTS between `jitter_depth` and `max_jitter_depth`: each loss
skip deepens the buffer one frame (more reorder tolerance), and a
quiet spell (no skips for `ADAPT_QUIET` frames) shrinks it back — the
latency/loss trade libortp's adaptive jitter compensation makes.

RTCP (RFC 3550, libortp's session side-channel on port+1): Sender
Reports with NTP/RTP timestamp pairs and packet/octet counts, one
Receiver Report block with fraction-lost / cumulative-lost / extended
highest sequence / interarrival jitter, and parsing of the peer's
SR/RR into `rtcp_stats`.
"""

from __future__ import annotations

import random
import socket
import struct
import time as systime
from typing import Dict, Optional, Tuple

GSM_PAYLOAD_TYPE = 3
SAMPLES_PER_FRAME = 160  # 20 ms @ 8 kHz
GSM_FRAME_BYTES = 33
RTCP_SR = 200
RTCP_RR = 201
RTCP_INTERVAL_S = 5.0  # RFC 3550 default report interval
ADAPT_QUIET = 250  # frames (~5 s) without skips before shrinking
NTP_EPOCH_OFFSET = 2208988800  # 1900→1970 seconds


def _seq_lt(a: int, b: int) -> bool:
    """a strictly before b in modular 16-bit sequence space."""
    return ((b - a) & 0xFFFF) < 0x8000 and a != b


class RTPSession:
    """Symmetric UDP RTP endpoint."""

    def __init__(self, local_port: int = 0, payload_type: int =
                 GSM_PAYLOAD_TYPE, jitter_depth: int = 4):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("0.0.0.0", local_port))
        self.sock.setblocking(False)
        self.local_port = self.sock.getsockname()[1]
        self.payload_type = payload_type
        self.ssrc = random.getrandbits(32)
        self.seq = random.getrandbits(16)
        self.timestamp = random.getrandbits(31)
        self.remote: Optional[Tuple[str, int]] = None
        self.jitter_depth = jitter_depth
        self.min_jitter_depth = jitter_depth
        self.max_jitter_depth = max(4 * jitter_depth, jitter_depth + 8)
        self._quiet_frames = 0
        self._jitter: Dict[int, bytes] = {}
        self._next_seq: Optional[int] = None
        self.late_drops = 0
        self.loss_skips = 0
        # RTCP endpoint on port+1 (the RFC 3550 / libortp convention)
        self.rtcp_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            self.rtcp_sock.bind(("0.0.0.0", self.local_port + 1))
        except OSError:  # port+1 taken: ephemeral (peer learns via SDP)
            self.rtcp_sock.bind(("0.0.0.0", 0))
        self.rtcp_sock.setblocking(False)
        self.remote_rtcp: Optional[Tuple[str, int]] = None
        self.packets_sent = 0
        self.octets_sent = 0
        self.packets_received = 0
        self._base_seq: Optional[int] = None
        self._max_seq_ext = 0  # extended highest sequence received
        self._seq_cycles = 0
        self._expected_prior = 0
        self._received_prior = 0
        self._jitter_est = 0.0  # RFC 3550 A.8 interarrival jitter
        self._last_transit: Optional[float] = None
        self._last_sr_time = 0.0
        self._peer_ssrc = 0
        self.rtcp_stats: Dict[str, float] = {}

    def connect(self, host: str, port: int) -> None:
        self.remote = (host, port)
        self.remote_rtcp = (host, port + 1)

    def tx_frame(self, payload: bytes) -> None:
        """Send one voice frame (SIPEngine::TxFrame)."""
        if self.remote is None:
            return
        header = struct.pack(
            "!BBHII",
            0x80,  # V=2
            self.payload_type & 0x7F,
            self.seq & 0xFFFF,
            self.timestamp & 0xFFFFFFFF,
            self.ssrc,
        )
        self.sock.sendto(header + payload, self.remote)
        self.seq = (self.seq + 1) & 0xFFFF
        self.timestamp = (self.timestamp + SAMPLES_PER_FRAME) & 0xFFFFFFFF
        self.packets_sent += 1
        self.octets_sent += len(payload)
        self.rtcp_tick()

    def _drain_socket(self) -> None:
        """Pull every queued datagram into the jitter buffer."""
        while True:
            try:
                data, _ = self.sock.recvfrom(2048)
            except BlockingIOError:
                return
            if len(data) < 12:
                continue
            v_p_x_cc = data[0]
            cc = v_p_x_cc & 0x0F
            offset = 12 + 4 * cc
            if (v_p_x_cc >> 6) != 2 or len(data) <= offset:
                continue
            if (data[1] & 0x7F) != self.payload_type:
                continue  # foreign payload type (ortp filters these)
            seq = struct.unpack_from("!H", data, 2)[0]
            rtp_ts = struct.unpack_from("!I", data, 4)[0]
            self._peer_ssrc = struct.unpack_from("!I", data, 8)[0]
            self._account_rx(seq, rtp_ts)
            if self._next_seq is not None and _seq_lt(seq,
                                                     self._next_seq):
                self.late_drops += 1  # already played past it
                continue
            self._jitter[seq] = data[offset:]

    def _account_rx(self, seq: int, rtp_ts: int) -> None:
        """Reception statistics (RFC 3550 A.1/A.8): extended sequence
        tracking and interarrival jitter."""
        self.packets_received += 1
        if self._base_seq is None:
            self._base_seq = seq
            self._max_seq_ext = seq
        else:
            prev = self._max_seq_ext & 0xFFFF
            if _seq_lt(prev, seq):
                if seq < prev:  # wrapped
                    self._seq_cycles += 1
                self._max_seq_ext = (self._seq_cycles << 16) | seq
        arrival = systime.monotonic() * 8000.0  # RTP clock units
        transit = arrival - rtp_ts
        if self._last_transit is not None:
            d = abs(transit - self._last_transit)
            self._jitter_est += (d - self._jitter_est) / 16.0
        self._last_transit = transit

    def rx_frame(self) -> Optional[bytes]:
        """Next voice frame in SEQUENCE order, or None
        (SIPEngine::RxFrame; ordering/loss handling is libortp's jitter
        compensation role)."""
        self._drain_socket()
        # a receive-only session (one-way hold, pre-first-tx) must
        # still emit RRs and drain inbound RTCP — tick from the rx
        # path too, not just tx_frame
        self.rtcp_tick()
        if not self._jitter:
            return None
        if self._next_seq is None:  # first packet(s) seed the cursor
            anchor = next(iter(self._jitter))

            def signed_dist(s: int) -> int:
                d = (s - anchor) & 0xFFFF
                return d - 0x10000 if d >= 0x8000 else d

            self._next_seq = min(self._jitter, key=signed_dist)
        if self._next_seq in self._jitter:
            p = self._jitter.pop(self._next_seq)
            self._next_seq = (self._next_seq + 1) & 0xFFFF
            self._quiet_frames += 1
            if self._quiet_frames >= ADAPT_QUIET and \
                    self.jitter_depth > self.min_jitter_depth:
                self.jitter_depth -= 1  # stable line: shed latency
                self._quiet_frames = 0
            return p
        if len(self._jitter) >= self.jitter_depth:
            # the expected frame is lost and the line is backing up:
            # skip the gap to the oldest buffered frame, and deepen the
            # buffer (the skip may have been reordering, not loss —
            # libortp's adaptive jitter compensation trade)
            s = min(self._jitter,
                    key=lambda s: (s - self._next_seq) & 0xFFFF)
            p = self._jitter.pop(s)
            self._next_seq = (s + 1) & 0xFFFF
            self.loss_skips += 1
            self._quiet_frames = 0
            if self.jitter_depth < self.max_jitter_depth:
                self.jitter_depth += 1
            return p
        return None  # wait for the reordered frame to arrive

    # -- RTCP (RFC 3550; libortp's session side-channel) ---------------
    def _report_block(self) -> bytes:
        """One receiver-report block about the peer's stream."""
        if self._base_seq is None:
            return b""
        expected = self._max_seq_ext - self._base_seq + 1
        lost = max(0, expected - self.packets_received)
        exp_i = expected - self._expected_prior
        rec_i = self.packets_received - self._received_prior
        self._expected_prior = expected
        self._received_prior = self.packets_received
        lost_i = max(0, exp_i - rec_i)
        fraction = (lost_i << 8) // exp_i if exp_i > 0 else 0
        return struct.pack(
            "!IBBHIIII", self._peer_ssrc, min(fraction, 255),
            (lost >> 16) & 0xFF, lost & 0xFFFF,
            self._max_seq_ext & 0xFFFFFFFF,
            int(self._jitter_est) & 0xFFFFFFFF, 0, 0)

    def rtcp_tick(self, now: Optional[float] = None) -> None:
        """Send an SR/RR on the report interval and drain inbound
        RTCP. Called from tx_frame; harmless to call more often."""
        now = systime.monotonic() if now is None else now
        self._drain_rtcp()
        if self.remote_rtcp is None or \
                now - self._last_sr_time < RTCP_INTERVAL_S:
            return
        self._last_sr_time = now
        rb = self._report_block()
        nrb = 1 if rb else 0
        if self.packets_sent:
            ntp = systime.time() + NTP_EPOCH_OFFSET
            ntp_hi = int(ntp) & 0xFFFFFFFF
            ntp_lo = int((ntp % 1.0) * (1 << 32)) & 0xFFFFFFFF
            body = struct.pack("!IIIIII", self.ssrc, ntp_hi, ntp_lo,
                               self.timestamp, self.packets_sent,
                               self.octets_sent) + rb
            hdr = struct.pack("!BBH", 0x80 | nrb, RTCP_SR,
                              len(body) // 4)
        else:
            body = struct.pack("!I", self.ssrc) + rb
            hdr = struct.pack("!BBH", 0x80 | nrb, RTCP_RR,
                              len(body) // 4)
        try:
            self.rtcp_sock.sendto(hdr + body, self.remote_rtcp)
        except OSError:
            pass

    def _drain_rtcp(self) -> None:
        """Parse inbound SR/RR into `rtcp_stats`."""
        while True:
            try:
                data, addr = self.rtcp_sock.recvfrom(2048)
            except (BlockingIOError, OSError):
                return
            if len(data) < 8 or (data[0] >> 6) != 2:
                continue
            pt = data[1]
            rc = data[0] & 0x1F
            if pt == RTCP_SR and len(data) >= 28:
                (ssrc, ntp_hi, ntp_lo, rtp_ts, pkts,
                 octets) = struct.unpack_from("!IIIIII", data, 4)
                self.rtcp_stats.update(
                    peer_ssrc=ssrc, peer_packets_sent=pkts,
                    peer_octets_sent=octets, peer_rtp_ts=rtp_ts)
                off = 28
            elif pt == RTCP_RR:
                off = 8
            else:
                continue
            if rc >= 1 and len(data) >= off + 24:
                (_ssrc, frac_cum, ehsn,
                 jit) = struct.unpack_from("!IIII", data, off)
                self.rtcp_stats.update(
                    reported_fraction_lost=(frac_cum >> 24) / 256.0,
                    reported_cum_lost=frac_cum & 0xFFFFFF,
                    reported_highest_seq=ehsn,
                    reported_jitter=jit)

    def close(self) -> None:
        self.sock.close()
        self.rtcp_sock.close()
