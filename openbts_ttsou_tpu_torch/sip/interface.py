"""SIP UDP interface: socket + per-call-ID demux.

Reference behavior: `SIP/SIPInterface.{h,cpp}` — one UDP socket (port
5062 by default), inbound messages demuxed by Call-ID into per-
transaction FIFOs; unmatched INVITEs/MESSAGEs trigger paging via a
callback (SIPInterface.h:47-100).
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Deque, Dict, Optional

from openbts_ttsou_tpu_torch.runtime import UdpTransport
from openbts_ttsou_tpu_torch.sip.message import SIPMessage


class SIPInterface:
    def __init__(self, local_port: int = 5062,
                 proxy_host: str = "127.0.0.1", proxy_port: int = 5060,
                 on_new_invite: Optional[Callable[[SIPMessage], None]] = None,
                 on_new_message: Optional[Callable[[SIPMessage], None]] = None):
        self.sock = UdpTransport(local_port, proxy_host, proxy_port)
        self.local_port = local_port
        self._fifos: Dict[str, Deque[SIPMessage]] = {}
        self._lock = threading.Lock()
        self.on_new_invite = on_new_invite
        self.on_new_message = on_new_message

    def send(self, data: bytes) -> None:
        self.sock.send(data)

    def add_call(self, call_id: str) -> bool:
        """Open a call's FIFO; True when it was not open yet."""
        with self._lock:
            if call_id in self._fifos:
                return False
            self._fifos[call_id] = collections.deque()
            return True

    def remove_call(self, call_id: str) -> None:
        with self._lock:
            self._fifos.pop(call_id, None)

    def fifo_size(self, call_id: str) -> int:
        with self._lock:
            q = self._fifos.get(call_id)
            return len(q) if q else 0

    def read(self, call_id: str) -> Optional[SIPMessage]:
        with self._lock:
            q = self._fifos.get(call_id)
            return q.popleft() if q else None

    def take(self, call_id: str,
             match: Callable[[SIPMessage], bool]) -> Optional[SIPMessage]:
        """Remove and return the first message of a call for which
        `match` holds; the call's other messages stay queued in order."""
        with self._lock:
            q = self._fifos.get(call_id)
            for i, msg in enumerate(q or ()):
                if match(msg):
                    del q[i]
                    return msg
            return None

    def drive(self, timeout_ms: int = 0) -> int:
        """Read and demux pending datagrams
        (SIPInterface::drive). Returns messages handled."""
        n = 0
        while True:
            data = self.sock.recv(4096, timeout_ms=timeout_ms)
            if data is None:
                return n
            try:
                msg = SIPMessage.parse(data)
            except Exception:
                continue
            self._dispatch(msg)
            n += 1

    def _dispatch(self, msg: SIPMessage) -> None:
        call_id = msg.call_id() or ""
        with self._lock:
            q = self._fifos.get(call_id)
        if q is not None:
            q.append(msg)
            return
        # unmatched: new inbound transaction → paging triggers
        # (SIPInterface checkInvite, SIPInterface.cpp)
        if msg.is_request and msg.method == "INVITE" and self.on_new_invite:
            self.add_call(call_id)
            self.on_new_invite(msg)
        elif msg.is_request and msg.method == "MESSAGE" and \
                self.on_new_message:
            self.add_call(call_id)
            self.on_new_message(msg)
