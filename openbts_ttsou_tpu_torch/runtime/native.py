"""ctypes bindings for the port's native C++ runtime.

The compute path is PyTorch; the runtime around it — datagram transport
for the three planes, the timestamped sample ring and the transmit burst
queue — is native C++ (like the reference's CommonLibs/Sockets +
USRPDevice ring), loaded here via ctypes. The sources are the port's
own, under `csrc/runtime/`: the transport waits with `poll()`, so a
socket at any descriptor works (a process of the wire daemon holds
3n + 1 sockets at n carriers), and its handle table takes 8192 sockets.
The library is built at first use with `g++` into `build/native/` at
the repository root, and rebuilt when it is older than a source.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC_DIR = Path(__file__).resolve().parents[1] / "csrc" / "runtime"
SOURCES = ("udp_transport.cpp", "sample_ring.cpp", "burst_queue.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
LIB_PATH = BUILD_DIR / "libtrx_runtime.so"
CXX_FLAGS = ["-O2", "-fPIC", "-Wall", "-std=c++17", "-shared"]
_lib = None
_lock = threading.Lock()


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any((SRC_DIR / f).stat().st_mtime > built
               for f in (*SOURCES, "runtime.h"))


def _build() -> None:
    """Compile the library under a name of this process, then move it
    into place in one step, so a process loading it meanwhile never
    reads a half-written file. A failed build raises."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{LIB_PATH.name}.{os.getpid()}.tmp"
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp),
           *(str(SRC_DIR / f) for f in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed building the native runtime (exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, LIB_PATH)


def load_runtime() -> ctypes.CDLL:
    """Load (building if needed) the native runtime library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _stale():
            _build()
        lib = ctypes.CDLL(str(LIB_PATH))
        lib.udt_open.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.udt_open.restype = ctypes.c_int
        lib.udt_send.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
        lib.udt_send.restype = ctypes.c_int
        lib.udt_recv.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_int]
        lib.udt_recv.restype = ctypes.c_int
        lib.udt_close.argtypes = [ctypes.c_int]
        lib.udt_open_unix.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.udt_open_unix.restype = ctypes.c_int
        lib.ring_create.argtypes = [ctypes.c_size_t]
        lib.ring_create.restype = ctypes.c_void_p
        lib.ring_destroy.argtypes = [ctypes.c_void_p]
        for fn in ("ring_write", "ring_read"):
            f = getattr(lib, fn)
            f.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                          ctypes.c_int64]
            f.restype = ctypes.c_int64
        lib.ring_end_ts.argtypes = [ctypes.c_void_p]
        lib.ring_end_ts.restype = ctypes.c_int64
        lib.ring_start_ts.argtypes = [ctypes.c_void_p]
        lib.ring_start_ts.restype = ctypes.c_int64
        lib.ring_write_packets.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_int64, ctypes.c_void_p]
        lib.ring_write_packets.restype = ctypes.c_int64
        lib.ring_last_pkt_ts.argtypes = [ctypes.c_void_p]
        lib.ring_last_pkt_ts.restype = ctypes.c_int64
        lib.bpq_create.argtypes = [ctypes.c_size_t]
        lib.bpq_create.restype = ctypes.c_void_p
        lib.bpq_destroy.argtypes = [ctypes.c_void_p]
        lib.bpq_push.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p, ctypes.c_int]
        lib.bpq_push.restype = ctypes.c_int
        lib.bpq_pop_exact.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p, ctypes.c_int]
        lib.bpq_pop_exact.restype = ctypes.c_int
        lib.bpq_dump_stale.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.bpq_dump_stale.restype = ctypes.c_int
        lib.bpq_size.argtypes = [ctypes.c_void_p]
        lib.bpq_size.restype = ctypes.c_int
        lib.bpq_min_fn.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.bpq_min_fn.restype = ctypes.c_int64
        lib.udt_send_batch.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                       ctypes.c_int, ctypes.c_int]
        lib.udt_send_batch.restype = ctypes.c_int
        lib.udt_drain_fixed.argtypes = [ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_void_p]
        lib.udt_drain_fixed.restype = ctypes.c_int
        lib.bpq_push_block.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_int64, ctypes.c_void_p]
        lib.bpq_push_block.restype = ctypes.c_int
        lib.bpq_pop_block.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_void_p]
        lib.bpq_pop_block.restype = ctypes.c_int
        _lib = lib
        return lib


class UnixDatagramTransport:
    """Unix-domain datagram plane (UDDSocket, CommonLibs/Sockets.h:157).
    Same send/recv/close surface as `UdpTransport`."""

    def __init__(self, local_path: str, remote_path: str = ""):
        self._lib = load_runtime()
        self._h = self._lib.udt_open_unix(local_path.encode(),
                                          remote_path.encode())
        if self._h < 0:
            raise OSError(f"udt_open_unix failed on {local_path}")

    send = None  # bound below, shared with UdpTransport
    recv = None
    close = None


class UdpTransport:
    """One plane of the TRX↔BTS protocol (UDPSocket equivalent,
    CommonLibs/Sockets.h:128)."""

    def __init__(self, local_port: int, remote_host: str = "127.0.0.1",
                 remote_port: int = 0):
        self._lib = load_runtime()
        self._h = self._lib.udt_open(local_port, remote_host.encode(),
                                     remote_port)
        if self._h < 0:
            raise OSError(f"udt_open failed on port {local_port}")

    def send(self, data: bytes) -> int:
        return self._lib.udt_send(self._h, data, len(data))

    def recv(self, maxlen: int = 2048, timeout_ms: int = -1) -> bytes | None:
        buf = ctypes.create_string_buffer(maxlen)
        n = self._lib.udt_recv(self._h, buf, maxlen, timeout_ms)
        if n <= 0:
            return None
        return buf.raw[:n]

    def send_batch(self, pkts: np.ndarray) -> int:
        """Send every row of a [n, pkt_len] uint8 array as one datagram
        each (one native call per burst batch)."""
        pkts = np.ascontiguousarray(pkts, np.uint8)
        if pkts.size == 0:
            return 0
        return self._lib.udt_send_batch(
            self._h, pkts.ctypes.data_as(ctypes.c_void_p),
            pkts.shape[0], pkts.shape[1])

    def drain_fixed(self, pkt_len: int, max_pkts: int = 4096) -> np.ndarray:
        """Drain queued datagrams of exactly pkt_len bytes without
        blocking → [n, pkt_len] uint8."""
        out = np.empty((max_pkts, pkt_len), np.uint8)
        n = self._lib.udt_drain_fixed(
            self._h, pkt_len, max_pkts, out.ctypes.data_as(ctypes.c_void_p))
        return out[:max(n, 0)]

    def close(self):
        if self._h >= 0:
            self._lib.udt_close(self._h)
            self._h = -1

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class SampleRing:
    """Timestamped int16-I/Q ring (USRPDevice ring equivalent,
    Transceiver52M/USRPDevice.h:68-88)."""

    def __init__(self, capacity_samples: int = 1 << 21):
        self._lib = load_runtime()
        self._r = self._lib.ring_create(capacity_samples)

    def write(self, iq: np.ndarray, ts: int) -> int:
        """iq: int16 [n, 2] or complex64 [n] (scaled to int16)."""
        iq = np.asarray(iq)
        if np.iscomplexobj(iq):
            iq = np.stack([iq.real, iq.imag], axis=-1).astype(np.int16)
        iq = np.ascontiguousarray(iq, np.int16)
        n = iq.shape[0]
        return int(self._lib.ring_write(
            self._r, iq.ctypes.data_as(ctypes.c_void_p), n, ts))

    def read(self, n: int, ts: int) -> tuple[np.ndarray, int]:
        out = np.zeros((n, 2), np.int16)
        got = int(self._lib.ring_read(
            self._r, out.ctypes.data_as(ctypes.c_void_p), n, ts))
        return out, got

    def read_complex(self, n: int, ts: int) -> np.ndarray:
        out, _ = self.read(n, ts)
        return (out[:, 0].astype(np.float32)
                + 1j * out[:, 1].astype(np.float32)).astype(np.complex64)

    def write_packets(self, pkts: bytes) -> tuple[int, bool, int, int]:
        """Reassemble USRP-format 512-byte packets into the ring with
        32→64-bit timestamp extension (USRPDevice::readSamples,
        Transceiver52M/USRPDevice.cpp:318-410). Returns (samples
        written, underrun flag seen, last RSSI field, non-data packets
        skipped)."""
        flags = (ctypes.c_int32 * 3)()
        n = int(self._lib.ring_write_packets(
            self._r, pkts, len(pkts), flags))
        return n, bool(flags[0]), int(flags[1]), int(flags[2])

    @property
    def last_pkt_ts(self) -> int:
        """Latest extended (64-bit) packet timestamp, −1 before the
        first packet."""
        return int(self._lib.ring_last_pkt_ts(self._r))

    @property
    def end_ts(self) -> int:
        return int(self._lib.ring_end_ts(self._r))

    @property
    def start_ts(self) -> int:
        return int(self._lib.ring_start_ts(self._r))

    def __del__(self):
        try:
            if self._r:
                self._lib.ring_destroy(self._r)
                self._r = None
        except Exception:
            pass


class BurstQueue:
    """Native transmit burst priority queue (VectorQueue,
    Transceiver52M/radioInterface.cpp:30-73): bursts keyed by
    (fn, chan, tn) in modular hyperframe time, with exact-pop
    (getCurrentBurst) and stale-drain (getStaleBurst)."""

    MAX_BURST = 512

    def __init__(self, max_bursts: int = 0):
        self._lib = load_runtime()
        self._q = self._lib.bpq_create(max_bursts)

    def push(self, fn: int, chan: int, tn: int, data: bytes) -> bool:
        return self._lib.bpq_push(self._q, fn, chan, tn, data,
                                  len(data)) == 0

    def pop_exact(self, fn: int, chan: int, tn: int) -> bytes | None:
        buf = ctypes.create_string_buffer(self.MAX_BURST)
        n = self._lib.bpq_pop_exact(self._q, fn, chan, tn, buf,
                                    self.MAX_BURST)
        return buf.raw[:n] if n > 0 else None

    def dump_stale(self, fn: int) -> int:
        return int(self._lib.bpq_dump_stale(self._q, fn))

    def push_block(self, chan: int, pkts: np.ndarray,
                   tx_fn: int) -> tuple[int, int]:
        """Bulk-ingest [n, 154] raw downlink datagrams for one carrier.
        Returns (queued, late) — `late` counts bursts whose FN already
        passed tx_fn (the underrun signal, Transceiver.cpp:688-716)."""
        pkts = np.ascontiguousarray(pkts, np.uint8)
        if pkts.size == 0:
            return 0, 0
        late = ctypes.c_int32(0)
        n = self._lib.bpq_push_block(
            self._q, chan, pkts.ctypes.data_as(ctypes.c_void_p),
            pkts.shape[0], tx_fn, ctypes.byref(late))
        return int(n), int(late.value)

    def pop_block(self, fn0: int, frames: int, n_chan: int
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """Pop every burst scheduled in [fn0, fn0+frames) into dense
        arrays: (bits [frames, n_chan, 8, 148] uint8, valid
        [frames, n_chan, 8] bool, gain [frames, n_chan, 8] f32, count)."""
        bits = np.zeros((frames, n_chan, 8, 148), np.uint8)
        valid = np.zeros((frames, n_chan, 8), np.uint8)
        gain = np.zeros((frames, n_chan, 8), np.float32)
        n = self._lib.bpq_pop_block(
            self._q, fn0, frames, n_chan,
            bits.ctypes.data_as(ctypes.c_void_p),
            valid.ctypes.data_as(ctypes.c_void_p),
            gain.ctypes.data_as(ctypes.c_void_p))
        return bits, valid.astype(bool), gain, int(n)

    def __len__(self) -> int:
        return int(self._lib.bpq_size(self._q))

    def min_fn(self, ref: int) -> int:
        return int(self._lib.bpq_min_fn(self._q, ref))

    def __del__(self):
        try:
            if self._q:
                self._lib.bpq_destroy(self._q)
                self._q = None
        except Exception:
            pass


# UDD shares the handle-based data path with UDP
UnixDatagramTransport.send = UdpTransport.send
UnixDatagramTransport.recv = UdpTransport.recv
if hasattr(UdpTransport, "close"):
    UnixDatagramTransport.close = UdpTransport.close
