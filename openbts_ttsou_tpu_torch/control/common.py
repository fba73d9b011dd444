"""Shared control-plane state: transactions, TMSI table, pager.

Reference behavior: `Control/ControlCommon.{h,cpp}` —
`TransactionEntry`/`TransactionTable` (ControlCommon.h:378,541: IMSI,
TI, Q.931 state, SIP engine, timers), `TMSITable` (TMSI↔IMSI map with
dump/restore), `Pager` (paging list with expiry; impl
RadioResource.cpp:325-470).
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import threading
import time as systime
from typing import Dict, List, Optional

from openbts_ttsou_tpu_torch.gsm.l3.common import MobileIdentity


class Q931CallState(enum.Enum):
    """Q.931 call states used by the reference
    (ControlCommon.h TransactionEntry)."""

    NullState = 0
    Paging = 1
    MOCInitiated = 2
    MOCProceeding = 3
    MTCConfirmed = 4
    CallReceived = 5
    CallPresent = 6
    ConnectIndication = 7
    Active = 8
    DisconnectIndication = 9
    ReleaseRequest = 10
    SMSDelivering = 11
    SMSSubmitting = 12


class ServiceType(enum.Enum):
    MobileOriginatedCall = 1
    EmergencyCall = 2
    MobileTerminatedCall = 3
    MobileOriginatedSMS = 4
    MobileTerminatedSMS = 5
    LocationUpdate = 6
    TestCall = 7


@dataclasses.dataclass
class TransactionEntry:
    """One control transaction (ControlCommon.h:378)."""

    id: int
    service: ServiceType
    imsi: str = ""
    tmsi: Optional[int] = None
    ti_flag: int = 0
    ti_value: int = 0
    called: str = ""
    calling: str = ""
    state: Q931CallState = Q931CallState.NullState
    sip = None  # SIPEngine, attached by call control
    message: str = ""  # SMS payload in transit
    created: float = dataclasses.field(default_factory=systime.monotonic)
    state_time: float = dataclasses.field(default_factory=systime.monotonic)

    def set_state(self, state: Q931CallState) -> None:
        self.state = state
        self.state_time = systime.monotonic()

    def stale(self, timeout_s: float = 180.0) -> bool:
        return systime.monotonic() - self.state_time > timeout_s


class TransactionTable:
    """Keyed transaction store (ControlCommon.h:541)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._next_id = itertools.count(1)
        self._table: Dict[int, TransactionEntry] = {}

    def new(self, service: ServiceType, **kw) -> TransactionEntry:
        with self._lock:
            t = TransactionEntry(next(self._next_id), service, **kw)
            self._table[t.id] = t
            return t

    def add(self, entry: TransactionEntry) -> None:
        with self._lock:
            self._table[entry.id] = entry

    def find(self, tid: int) -> Optional[TransactionEntry]:
        with self._lock:
            return self._table.get(tid)

    def find_by_imsi(self, imsi: str,
                     services: Optional[tuple] = None
                     ) -> Optional[TransactionEntry]:
        """Match by IMSI, optionally restricted to service types (the
        reference's paging lookup searches only MT transactions,
        TransactionTable.cpp find-by-mobile-ID)."""
        with self._lock:
            for t in self._table.values():
                if t.imsi == imsi and (services is None
                                       or t.service in services):
                    return t
            return None

    def find_by_ti(self, ti_flag: int, ti_value: int,
                   imsi: str) -> Optional[TransactionEntry]:
        with self._lock:
            for t in self._table.values():
                if (t.imsi == imsi and t.ti_flag == ti_flag
                        and t.ti_value == ti_value):
                    return t
            return None

    def remove(self, tid: int) -> None:
        with self._lock:
            self._table.pop(tid, None)

    def clear_stale(self, timeout_s: float = 180.0) -> int:
        with self._lock:
            dead = [k for k, t in self._table.items() if t.stale(timeout_s)]
            for k in dead:
                del self._table[k]
            return len(dead)

    def size(self) -> int:
        with self._lock:
            return len(self._table)

    def entries(self) -> List[TransactionEntry]:
        with self._lock:
            return list(self._table.values())


class TMSITable:
    """TMSI↔IMSI assignment with dump/restore
    (ControlCommon.h:627; CLI `tmsis`/`dumptmsis`)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_tmsi: Dict[int, str] = {}
        self._by_imsi: Dict[str, int] = {}
        self._next = 0x10000

    def assign(self, imsi: str) -> int:
        with self._lock:
            if imsi in self._by_imsi:
                return self._by_imsi[imsi]
            tmsi = self._next
            self._next += 1
            self._by_tmsi[tmsi] = imsi
            self._by_imsi[imsi] = tmsi
            return tmsi

    def imsi(self, tmsi: int) -> Optional[str]:
        with self._lock:
            return self._by_tmsi.get(tmsi)

    def tmsi(self, imsi: str) -> Optional[int]:
        with self._lock:
            return self._by_imsi.get(imsi)

    def size(self) -> int:
        with self._lock:
            return len(self._by_tmsi)

    def dump(self, path: str) -> None:
        with self._lock, open(path, "w") as f:
            for tmsi, imsi in self._by_tmsi.items():
                f.write(f"{tmsi:08x} {imsi}\n")

    def restore(self, path: str) -> None:
        with self._lock, open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) == 2:
                    tmsi = int(parts[0], 16)
                    self._by_tmsi[tmsi] = parts[1]
                    self._by_imsi[parts[1]] = tmsi
                    self._next = max(self._next, tmsi + 1)


@dataclasses.dataclass
class PagingEntry:
    identity: MobileIdentity
    expiry: float
    transaction_id: int = 0


class Pager:
    """Paging list with repeat-until-expiry semantics
    (ControlCommon.h:297; service loop RadioResource.cpp:325-470).

    The reference runs a thread writing PagingRequest messages to the
    PCH; here `page_batch()` returns the next identities to page and the
    BTS loop sends them — same rotation, no thread.
    """

    def __init__(self, default_life_s: float = 10.0):
        self._lock = threading.Lock()
        self._list: List[PagingEntry] = []
        self.default_life = default_life_s

    def add(self, identity: MobileIdentity, life_s: Optional[float] = None,
            transaction_id: int = 0) -> None:
        with self._lock:
            expiry = systime.monotonic() + (life_s or self.default_life)
            for e in self._list:
                if repr(e.identity) == repr(identity):
                    e.expiry = max(e.expiry, expiry)
                    return
            self._list.append(PagingEntry(identity, expiry, transaction_id))

    def remove(self, identity: MobileIdentity) -> bool:
        with self._lock:
            n = len(self._list)
            self._list = [e for e in self._list
                          if repr(e.identity) != repr(identity)]
            return len(self._list) != n

    def size(self) -> int:
        with self._lock:
            self._expire()
            return len(self._list)

    def _expire(self) -> None:
        now = systime.monotonic()
        self._list = [e for e in self._list if e.expiry > now]

    def page_batch(self, max_ids: int = 2) -> List[MobileIdentity]:
        """Next identities to page (round-robin rotation, up to 2 per
        PagingRequestType1)."""
        with self._lock:
            self._expire()
            if not self._list:
                return []
            batch = [e.identity for e in self._list[:max_ids]]
            self._list = self._list[max_ids:] + self._list[:max_ids]
            return batch
