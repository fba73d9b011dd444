"""Hardware-ready USRP device driver over a pluggable bus transport.

Composes the device-layer pieces that already existed separately —
the native timestamped sample ring with USRP packet reassembly and
32→64-bit timestamp extension (`native/sample_ring.cpp`), the RFX900
synthesizer plan (`trx/rfx900.py`), and the alignment ping — into a
`Radio` the daemon can drive unchanged, the way the reference's
`USRPDevice` binds ring+ping+regs over libusrp
(Transceiver52M/USRPDevice.cpp:232-296 start, :318-460 readSamples,
:467-505 writeSamples, :518 updateAlignment).

The USB endpoints are abstracted as a `Bus` with raw packet
`read`/`write`; `SimBus` is a software USRP speaking the real 512-byte
packet format (with 32-bit timestamp wraps, control-channel ping
replies, and underrun flags) so the whole driver is testable with no
hardware — the role SWLOOPBACK plays in the reference
(USRPDevice.h:90-98), but at the bus level so the packet path is
exercised too.

NumPy only: the port's own copy of `openbts_ttsou_tpu/trx/usrp.py`, on
the port's `runtime`, `radio` and `rfx900`.
"""

from __future__ import annotations

import struct

import numpy as np

from openbts_ttsou_tpu_torch.trx.radio import Radio, SynthRadioMixin

PKT_BYTES = 512
PAYLOAD_BYTES = 504  # per-packet sample payload (writeSamples: 504)
CTRL_CHAN = 0x1F
#: empirical delay between a ping reply's timestamp and the true
#: receive timestamp (USRPDevice.h:86)
PINGOFFSET = 272
#: ping request payload: shorts {0x00, 0x02, 0x00, 0x00}
#: (updateAlignment, USRPDevice.cpp:518-526); the reply's word2 high
#: half reads (0x01 << 8) | 0x02 (readSamples, USRPDevice.cpp:368)
PING_REQUEST = struct.pack("<HHHH", 0x0000, 0x0002, 0x0000, 0x0000)
PING_REPLY_TAG = (0x01 << 8) | 0x02


def build_packets(payload: bytes, ts: int, chan: int = 0,
                  rssi: int = 0) -> bytes:
    """Packetize a payload byte stream into 512-byte USRP packets.

    Mirrors USRPDevice::writeSamples (USRPDevice.cpp:467-505):
    word0 = (isStart<<12 | isEnd<<11 | (RSSI&0x3f)<<5 | CHAN) << 16
            | payloadLen, word1 = ts & 0xffffffff, then payload bytes
    (the timestamp advances one sample per 4 payload bytes).
    """
    out = bytearray()
    n = len(payload)
    written = 0
    is_start = 1
    while written < n or (n == 0 and written == 0):
        chunk = payload[written: written + PAYLOAD_BYTES]
        is_end = 1 if n - written <= PAYLOAD_BYTES else 0
        word0 = ((is_start << 12) | (is_end << 11) | ((rssi & 0x3F) << 5)
                 | chan) << 16 | len(chunk)
        pkt = struct.pack("<II", word0, ts & 0xFFFFFFFF) + chunk
        out += pkt + b"\x00" * (PKT_BYTES - len(pkt))
        written += len(chunk)
        ts += len(chunk) // 4
        is_start = 0
        if n == 0:
            break
    return bytes(out)


class Bus:
    """Raw USB-endpoint contract (the libusrp tx/rx fastpath the
    reference drives through m_uTx/m_uRx)."""

    def read(self, max_bytes: int) -> bytes:
        """Up to max_bytes of 512-byte rx packets ('' when dry)."""
        raise NotImplementedError

    def write(self, data: bytes) -> int:
        raise NotImplementedError

    def start(self) -> bool:
        return True

    def stop(self) -> bool:
        return True

    def program_regs(self, side: str, regs) -> bool:
        """Program daughterboard PLL registers (compute_regs output —
        the reference pokes these via libusrp I/O writes,
        USRPDevice.cpp:232-296)."""
        return True


class USRPRadio(SynthRadioMixin, Radio):
    """`USRPDevice` equivalent: timestamped duplex sample I/O over a
    packet bus, with ring reassembly, timestamp extension, alignment
    ping, and RFX900 tuning."""

    def __init__(self, bus: Bus, sample_rate: float = 400e3,
                 capacity: int = 1 << 21):
        from openbts_ttsou_tpu_torch.runtime import SampleRing

        self.bus = bus
        self.sample_rate = sample_rate
        self.ring = SampleRing(capacity)
        self.timestamp_offset = 0
        self.ping_timestamp: int | None = None
        self.is_aligned = False
        self.underruns = 0
        self.last_rssi = 0
        # Python mirror of the ring's 32→64-bit timestamp extension,
        # used only to stamp control replies (rare); both observers see
        # the same packet stream in order, so they stay in lockstep
        self._hi32 = 0
        self._last_lo32: int | None = None

    # -- bring-up (USRPDevice::start, USRPDevice.cpp:232-296) ----------
    def start(self) -> bool:
        return self.bus.start()

    def stop(self) -> bool:
        return self.bus.stop()

    def set_tx_freq(self, freq: float) -> bool:
        from openbts_ttsou_tpu_torch.trx import rfx900

        try:
            plan = rfx900.tune_tx(freq)
        except ValueError:
            return False
        self.tx_residual_hz = plan.residual
        return self.bus.program_regs("tx", plan)

    def set_rx_freq(self, freq: float) -> bool:
        from openbts_ttsou_tpu_torch.trx import rfx900

        try:
            plan = rfx900.tune_rx(freq)
        except ValueError:
            return False
        self.rx_residual_hz = plan.residual
        return self.bus.program_regs("rx", plan)

    # -- tx (writeSamples, USRPDevice.cpp:467-505) ----------------------
    def write_samples(self, iq: np.ndarray, ts: int) -> int:
        iq = np.asarray(iq)
        if np.iscomplexobj(iq):
            iq = np.clip(np.stack([iq.real, iq.imag], -1).round(),
                         -32767, 32767)
        pay = np.ascontiguousarray(iq, np.int16).tobytes()
        self.bus.write(build_packets(pay, ts))
        return len(pay) // 4

    # -- rx (readSamples, USRPDevice.cpp:318-460) ------------------------
    def _pump(self, chunk: bytes) -> None:
        """One bus read chunk → ring + control-reply scan."""
        _, underrun, rssi, skipped = self.ring.write_packets(chunk)
        if underrun:
            self.underruns += 1
        self.last_rssi = rssi
        # mirror the timestamp extension and catch ping replies
        for off in range(0, len(chunk) - PKT_BYTES + 1, PKT_BYTES):
            word0, lo32 = struct.unpack_from("<II", chunk, off)
            if self._last_lo32 is not None and self._last_lo32 > lo32:
                self._hi32 += 1
            self._last_lo32 = lo32
            ts64 = (self._hi32 << 32) | lo32
            if (word0 >> 16) & 0x1F != CTRL_CHAN:
                continue
            (word2,) = struct.unpack_from("<I", chunk, off + 8)
            if (word2 >> 16) == PING_REPLY_TAG and \
                    self.ping_timestamp is not None:
                # timestampOffset = replyTs − pingTs + PINGOFFSET
                # (readSamples, USRPDevice.cpp:370-373)
                self.timestamp_offset = (ts64 - self.ping_timestamp
                                         + PINGOFFSET)
                self.is_aligned = True

    def read_samples(self, n: int, ts: int) -> np.ndarray:
        target = ts + self.timestamp_offset
        tries = 0
        while self.ring.end_ts < target + n and tries < 64:
            need = target + n - max(self.ring.end_ts, 0)
            want = PKT_BYTES * -(-need // 126)  # ceil, ≈126 samples/pkt
            chunk = self.bus.read(min(want, 16 * PKT_BYTES * 8))
            if not chunk:
                break
            self._pump(chunk)
            tries += 1
        return self.ring.read_complex(n, target)

    # -- alignment (updateAlignment, USRPDevice.cpp:518-526) -------------
    def update_alignment(self, ts: int = 0, probe_len: int = 256) -> int:
        self.ping_timestamp = ts
        self.bus.write(build_packets(PING_REQUEST, ts & 0xFFFFFFFF,
                                     chan=CTRL_CHAN))
        # drain until the reply arrives (readSamples does this inline)
        for _ in range(16):
            chunk = self.bus.read(16 * PKT_BYTES)
            if not chunk:
                break
            self._pump(chunk)
            if self.is_aligned:
                break
        return self.timestamp_offset


class SimBus(Bus):
    """Software USRP at the bus level: accepts tx packets, loops the
    samples back to rx after `hw_delay` samples, answers control pings,
    and streams rx packets with 32-bit wrapping timestamps — the
    device side of USRPDevice.cpp:318-505 for tests."""

    def __init__(self, hw_delay: int = 100, start_ts: int = 0,
                 noise_std: float = 0.0, underrun_at: int | None = None,
                 stimulus: np.ndarray | None = None):
        self.hw_delay = hw_delay
        self.rx_cursor = start_ts  # device's running rx sample counter
        self.loop: dict[int, np.ndarray] = {}  # ts → int16 [n, 2]
        self.ctrl_replies: list[bytes] = []
        self.noise_std = noise_std
        self.underrun_at = underrun_at
        #: optional periodic antenna signal (int16 [T, 2]) tiled into
        #: the rx stream — an on-air stimulus independent of the tx
        #: loopback, so receive-only scenarios see real bursts
        self.stimulus = stimulus
        self._rng = np.random.default_rng(0)
        self.started = False
        self.programmed: list[tuple[str, object]] = []
        self.tx_packets = 0  # data packets accepted (diagnostics)

    def start(self) -> bool:
        self.started = True
        return True

    def program_regs(self, side: str, regs) -> bool:
        self.programmed.append((side, regs))
        return True

    def write(self, data: bytes) -> int:
        for off in range(0, len(data) - PKT_BYTES + 1, PKT_BYTES):
            word0, ts = struct.unpack_from("<II", data, off)
            chan = (word0 >> 16) & 0x1F
            paylen = word0 & 0x1FF
            pay = data[off + 8: off + 8 + paylen]
            if chan == CTRL_CHAN:
                if pay[:4] == PING_REQUEST[:4]:
                    # The reply's stamp models the ping crossing the
                    # Tx→Rx path: true delay `hw_delay`, stamped
                    # PINGOFFSET early — the board quirk the empirical
                    # constant corrects for (USRPDevice.h:86), so the
                    # driver's measured offset equals hw_delay exactly.
                    # Held until the rx stream reaches it: the board
                    # interleaves replies in timestamp order, which is
                    # what keeps the host's 32-bit wrap detector sane.
                    w2 = PING_REPLY_TAG << 16
                    rts = (ts + self.hw_delay - PINGOFFSET) & 0xFFFFFFFF
                    reply = struct.pack(
                        "<III", (CTRL_CHAN << 16) | 4, rts, w2)
                    self.ctrl_replies.append(
                        (rts, reply + b"\x00" * (PKT_BYTES - len(reply))))
                continue
            iq = np.frombuffer(pay, np.int16).reshape(-1, 2)
            self.loop[(ts + self.hw_delay) & 0xFFFFFFFF] = iq
            self.tx_packets += 1

    def _rx_samples(self, n: int) -> np.ndarray:
        """n int16 IQ samples starting at rx_cursor: looped-back tx
        plus noise."""
        out = np.zeros((n, 2), np.float64)
        if self.noise_std:
            out += self._rng.normal(0, self.noise_std, (n, 2))
        if self.stimulus is not None:
            t = self.stimulus.shape[0]
            idx = (self.rx_cursor + np.arange(n)) % t
            out += self.stimulus[idx]
        for ts, iq in list(self.loop.items()):
            # position relative to cursor in 32-bit modular time
            rel = (ts - (self.rx_cursor & 0xFFFFFFFF)) & 0xFFFFFFFF
            if rel > 1 << 31:
                rel -= 1 << 32
            lo = max(rel, 0)
            hi = min(rel + len(iq), n)
            if hi <= lo:
                if rel + len(iq) < 0:
                    del self.loop[ts]  # fully in the past
                continue
            out[lo:hi] += iq[lo - rel: hi - rel]
        return np.clip(out, -32767, 32767).astype(np.int16)

    def read(self, max_bytes: int) -> bytes:
        """Emit up to max_bytes of packets in TIMESTAMP ORDER: data
        packets (≤126 samples each), with pending control replies
        interleaved exactly at their stamp position — a real board's
        stream is monotone, which the host's naive 32-bit wrap detector
        (USRPDevice.cpp:358) depends on. A data packet is truncated so
        the reply slots in at its precise timestamp; a reply whose time
        already passed is stamped at the current cursor (boards stamp
        at processing time)."""
        out = bytearray()
        per = PAYLOAD_BYTES // 4  # 126 samples per full data packet
        for _ in range(max_bytes // PKT_BYTES):
            n_samp = per
            if self.ctrl_replies:
                rts = self.ctrl_replies[0][0]
                rel = (rts - (self.rx_cursor & 0xFFFFFFFF)) & 0xFFFFFFFF
                if rel == 0 or rel >= 1 << 31:
                    _, pkt = self.ctrl_replies.pop(0)
                    pkt = bytearray(pkt)
                    struct.pack_into("<I", pkt, 4,
                                     self.rx_cursor & 0xFFFFFFFF)
                    out += bytes(pkt)
                    continue
                if rel < per:
                    n_samp = int(rel)  # truncate up to the reply's slot
            iq = self._rx_samples(n_samp)
            pay = iq.tobytes()
            word0 = ((1 << 12) | (1 << 11)) << 16 | len(pay)
            if self.underrun_at is not None and \
                    self.rx_cursor >= self.underrun_at:
                word0 |= 0x4 << 28
                self.underrun_at = None
            pkt = struct.pack("<II", word0,
                              self.rx_cursor & 0xFFFFFFFF) + pay
            out += pkt + b"\x00" * (PKT_BYTES - len(pkt))
            self.rx_cursor += n_samp
        return bytes(out)


# ---------------------------------------------------------------------------
# Transport-crossing bus + block-scale bank adapter
# ---------------------------------------------------------------------------

class SocketBus(Bus):
    """A `Bus` whose endpoint lives in ANOTHER PROCESS, reached over an
    AF_UNIX stream socket — the process/transport boundary where a
    libusb backend would sit (the reference's m_uTx/m_uRx fastpath into
    the usb subsystem, USRPDevice.cpp:318-505). Framing: request
    [op:1][carrier:2][len:4][payload], response [len:4][payload]."""

    def __init__(self, path: str, carrier: int = 0,
                 timeout_s: float = 10.0):
        import socket

        self.carrier = carrier
        self.tx_bytes = 0  # bytes sent over the bus (requests)
        self.rx_bytes = 0  # bytes received (responses)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.settimeout(timeout_s)
        self._sock.connect(path)

    def _rpc(self, op: bytes, payload: bytes = b"") -> bytes:
        self._sock.sendall(op + struct.pack("<HI", self.carrier,
                                            len(payload)) + payload)
        self.tx_bytes += 7 + len(payload)
        hdr = self._recv_exact(4)
        (n,) = struct.unpack("<I", hdr)
        self.rx_bytes += 4 + n
        return self._recv_exact(n)

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("bus server closed")
            buf += chunk
        return buf

    def read(self, max_bytes: int) -> bytes:
        return self._rpc(b"R", struct.pack("<I", max_bytes))

    def write(self, data: bytes) -> int:
        resp = self._rpc(b"W", data)
        return struct.unpack("<I", resp)[0]

    def start(self) -> bool:
        return self._rpc(b"S") == b"\x01"

    def stop(self) -> bool:
        return self._rpc(b"T") == b"\x01"

    def program_regs(self, side: str, regs) -> bool:
        return self._rpc(b"P", side.encode() + b"\x00"
                         + repr(regs).encode()) == b"\x01"

    def close(self) -> None:
        self._sock.close()


def serve_bus(path: str, buses: list, max_requests: int | None = None
              ) -> None:
    """Serve N `SimBus` instances over one AF_UNIX socket (the device
    side of `SocketBus`): accepts any number of client connections and
    dispatches by the carrier id in each request frame. Runs until the
    socket is removed, the parent dies, or max_requests is served."""
    import os
    import select
    import socket

    if os.path.exists(path):
        os.unlink(path)
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(path)
    srv.listen(16)
    conns: list = []
    served = 0

    def handle(conn) -> bool:
        hdr = b""
        while len(hdr) < 7:
            chunk = conn.recv(7 - len(hdr))
            if not chunk:
                return False
            hdr += chunk
        op, carrier, n = hdr[:1], *struct.unpack("<HI", hdr[1:])
        payload = b""
        while len(payload) < n:
            chunk = conn.recv(n - len(payload))
            if not chunk:
                return False
            payload += chunk
        bus = buses[carrier]
        if op == b"R":
            (mx,) = struct.unpack("<I", payload)
            resp = bus.read(mx)
        elif op == b"W":
            bus.write(payload)
            resp = struct.pack("<I", len(payload))
        elif op == b"S":
            resp = b"\x01" if bus.start() else b"\x00"
        elif op == b"T":
            resp = b"\x01" if bus.stop() else b"\x00"
        elif op == b"P":
            side, regs = payload.split(b"\x00", 1)
            bus.program_regs(side.decode(), regs.decode())
            resp = b"\x01"
        else:
            resp = b""
        conn.sendall(struct.pack("<I", len(resp)) + resp)
        return True

    try:
        while max_requests is None or served < max_requests:
            r, _, _ = select.select([srv] + conns, [], [], 1.0)
            for s in r:
                if s is srv:
                    c, _ = srv.accept()
                    conns.append(c)
                elif not handle(s):
                    conns.remove(s)
                    s.close()
                else:
                    served += 1
            if not os.path.exists(path):
                break
    finally:
        for c in conns:
            c.close()
        srv.close()


class USRPBankRadio:
    """Bank adapter: N `USRPRadio`s behind the BlockTrxDaemon's
    `read_bank`/`write_bank` seam, so the block-pipelined daemon drives
    real bus-level radios the way it drives `ReplayBankRadio`. Control verbs
    broadcast to every radio (the daemon's bank plumbing carries no
    carrier index; per-carrier RF tuning needs one daemon per carrier
    group, as the reference runs one process per ARFCN)."""

    int16_io = False  # read_bank returns complex64 [C, n]

    def __init__(self, radios: list[USRPRadio]):
        self.radios = radios

    def read_bank(self, n: int, ts: int) -> np.ndarray:
        return np.stack([r.read_samples(n, ts) for r in self.radios])

    def write_bank(self, tx_i16: np.ndarray, ts: int) -> None:
        for c, r in enumerate(self.radios):
            r.write_samples(np.asarray(tx_i16[c], np.int16), ts)

    def start(self) -> bool:
        return all(r.start() for r in self.radios)

    def stop(self) -> bool:
        return all(r.stop() for r in self.radios)

    def set_tx_freq(self, freq: float) -> bool:
        return all(r.set_tx_freq(freq) for r in self.radios)

    def set_rx_freq(self, freq: float) -> bool:
        return all(r.set_rx_freq(freq) for r in self.radios)

    def update_alignment(self, ts: int = 0) -> list[int]:
        return [r.update_alignment(ts) for r in self.radios]
