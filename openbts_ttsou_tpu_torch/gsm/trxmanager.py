"""BTS-side transceiver bridge: demux table, clock sync, control verbs.

Port of `openbts_ttsou_tpu/gsm/trxmanager.py`, on the port's `runtime`
and `trx.protocol`. Reference behavior: `TRXManager/TRXManager.{h,cpp}` —
`TransceiverManager` (clock socket + per-ARFCN managers, TRXManager.h:57),
`ARFCNManager` (data socket, demux table `mDemuxTable[8][102*51+...]`,
installDecoder at TRXManager.cpp:146-168, writeHighSide serialization at
:173-199, driveRx at :205-234, control verbs with retry at :249-284).

Speaks the exact wire protocol of `trx.protocol` to the transceiver
daemon (ours, or the reference's C++ transceiver — the bytes match).
"""

from __future__ import annotations

import threading
import time as systime
from typing import Dict, Optional, Tuple

import numpy as np

from openbts_ttsou_tpu_torch.runtime import UdpTransport
from openbts_ttsou_tpu_torch.trx import protocol as proto
from openbts_ttsou_tpu_torch.gsm.transfer import RxBurst, TxBurst
from openbts_ttsou_tpu_torch.utils.gsm_time import HYPERFRAME, Time
from openbts_ttsou_tpu_torch.utils.logger import get_logger

log = get_logger("trxmanager")

# Demux table modulus: every mapping repeat length (26/51/102/104)
# divides 5304 = lcm(104, 51) — the reference's mDemuxTable[8][5304]
# (TRXManager.cpp:146-168).
DEMUX_MODULUS = 5304


class Clock:
    """BTS frame clock slaved to IND CLOCK (gBTS.clock();
    TRXManager.cpp:89 clockHandler)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._base_fn = 0
        self._base_time = systime.monotonic()

    def set_fn(self, fn: int) -> None:
        with self._lock:
            self._base_fn = fn % HYPERFRAME
            self._base_time = systime.monotonic()

    def fn(self) -> int:
        from openbts_ttsou_tpu_torch.utils.gsm_time import FRAME_SECONDS

        with self._lock:
            elapsed = systime.monotonic() - self._base_time
            return int(self._base_fn + elapsed / FRAME_SECONDS) % HYPERFRAME

    def get(self) -> Time:
        return Time(self.fn(), 0)


class ARFCNManager:
    """One carrier's data+control planes (TRXManager.h:115)."""

    def __init__(self, local_port: int, remote_host: str, remote_port: int):
        # data = base+2, control = base+1 on both sides
        self.data_sock = UdpTransport(local_port + 2, remote_host,
                                      remote_port + 2)
        self.ctrl_sock = UdpTransport(local_port + 1, remote_host,
                                      remote_port + 1)
        self._demux: Dict[Tuple[int, int], object] = {}
        self._demux_lock = threading.Lock()

    # -- control verbs (TRXManager.cpp:249-284 retry/backoff) ----------
    def send_command(self, verb: str, *args, retries: int = 3,
                     timeout_ms: int = 1000) -> Optional[list[str]]:
        for attempt in range(retries):
            self.ctrl_sock.send(proto.pack_command(verb, *args))
            deadline = systime.monotonic() + timeout_ms / 1000 * (attempt + 1)
            while systime.monotonic() < deadline:
                resp = self.ctrl_sock.recv(256, timeout_ms=100)
                if resp is None:
                    continue
                try:
                    kind, rverb, rargs = proto.parse_message(resp)
                except ValueError:
                    continue
                if kind == "RSP" and rverb == verb:
                    if rargs and rargs[0] == "0":
                        return rargs[1:]
                    log.warning("TRX %s failed: %s", verb, rargs)
                    return None
        log.error("TRX %s: no response", verb)
        return None

    def power_off(self):
        return self.send_command("POWEROFF") is not None

    def power_on(self):
        return self.send_command("POWERON") is not None

    def tune(self, rx_khz: int, tx_khz: int) -> bool:
        ok = self.send_command("RXTUNE", rx_khz) is not None
        return ok and self.send_command("TXTUNE", tx_khz) is not None

    def set_tsc(self, tsc: int) -> bool:
        return self.send_command("SETTSC", tsc) is not None

    def set_slot(self, tn: int, combo: int) -> bool:
        return self.send_command("SETSLOT", tn, combo) is not None

    def set_power(self, db: int) -> bool:
        return self.send_command("SETPOWER", db) is not None

    def set_max_delay(self, symbols: int) -> bool:
        return self.send_command("SETMAXDELAY", symbols) is not None

    # -- demux table (installDecoder, TRXManager.cpp:146-168) ----------
    def install_decoder(self, decoder) -> None:
        """decoder must expose .tn and .uplink (a TDMAMapping) and a
        write_low_side(RxBurst)."""
        mapping = decoder.uplink
        assert DEMUX_MODULUS % mapping.repeat_length == 0
        with self._demux_lock:
            for fn in range(DEMUX_MODULUS):
                if mapping.reverse(fn) is not None:
                    self._demux[(decoder.tn, fn)] = decoder

    # -- data plane ----------------------------------------------------
    def write_high_side(self, burst: TxBurst, gain_db: int = 0) -> None:
        """Serialize a downlink burst (TRXManager.cpp:173-199)."""
        self.data_sock.send(proto.pack_downlink(
            proto.DownlinkBurst(burst.tn, burst.fn, gain_db, burst.bits)))

    def drive_rx(self, timeout_ms: int = 0) -> int:
        """Read and dispatch pending uplink bursts
        (driveRx, TRXManager.cpp:205-234). Returns bursts handled."""
        n = 0
        while True:
            data = self.data_sock.recv(512, timeout_ms=timeout_ms)
            if data is None:
                return n
            try:
                ub = proto.unpack_uplink(data)
            except ValueError:
                continue
            self.receive_burst(RxBurst(ub.soft, ub.fn, ub.tn,
                                       rssi=-ub.rssi,
                                       timing_error=ub.toa / 256.0))
            n += 1

    def receive_burst(self, burst: RxBurst) -> None:
        with self._demux_lock:
            decoder = self._demux.get((burst.tn, burst.fn % DEMUX_MODULUS))
        if decoder is not None:
            decoder.write_low_side(burst)


class TransceiverManager:
    """Clock plane + ARFCN managers (TRXManager.h:57;
    start/clockHandler TRXManager.cpp:58-110)."""

    def __init__(self, n_arfcn: int = 1, local_base: int = 5800,
                 remote_host: str = "127.0.0.1", remote_base: int = 5700):
        self.clock = Clock()
        self.clock_sock = UdpTransport(local_base, remote_host, remote_base)
        self.arfcns = [
            ARFCNManager(local_base + 3 * i, remote_host,
                         remote_base + 3 * i)
            for i in range(n_arfcn)
        ]
        self._running = False
        self._clock_thread: Optional[threading.Thread] = None

    def arfcn(self, i: int = 0) -> ARFCNManager:
        return self.arfcns[i]

    def handle_clock(self, data: bytes) -> None:
        try:
            kind, verb, args = proto.parse_message(data)
        except ValueError:
            return
        if kind == "IND" and verb == "CLOCK" and args:
            self.clock.set_fn(int(args[0]))

    def poll_clock(self, timeout_ms: int = 0) -> bool:
        data = self.clock_sock.recv(128, timeout_ms=timeout_ms)
        if data is None:
            return False
        self.handle_clock(data)
        return True

    def start(self) -> None:
        """Background clock thread (TRXManager.cpp:58)."""
        if self._running:
            return
        self._running = True

        def loop():
            while self._running:
                self.poll_clock(timeout_ms=250)

        self._clock_thread = threading.Thread(target=loop, daemon=True)
        self._clock_thread.start()

    def stop(self) -> None:
        self._running = False
        if self._clock_thread:
            self._clock_thread.join(timeout=1.0)
