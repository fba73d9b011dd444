"""Home Location Register interfaces.

Reference behavior: `HLR/HLR.{h,cpp}` — abstract `HLR`
(getIMSI/getCLID/getRegistrationIP/addUser, HLR.h:37-100), the
`AsteriskHLR` implementation that rewrites Asterisk sip.conf /
extensions.conf and issues `sip reload`, and the TTL'd `HLRCache`
(HLR.h:105-168).
"""

from __future__ import annotations

import re
import subprocess
import threading
import time as systime
from typing import Dict, Optional, Tuple


class HLR:
    """Abstract subscriber registry (HLR.h:37)."""

    def get_imsi(self, clid: str) -> Optional[str]:
        raise NotImplementedError

    def get_clid(self, imsi: str) -> Optional[str]:
        raise NotImplementedError

    def get_registration_ip(self, imsi: str) -> Optional[str]:
        raise NotImplementedError

    def add_user(self, imsi: str, clid: str) -> bool:
        raise NotImplementedError


class LocalHLR(HLR):
    """In-memory registry (useful standalone and for tests)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._clid_by_imsi: Dict[str, str] = {}
        self._imsi_by_clid: Dict[str, str] = {}
        self._ip_by_imsi: Dict[str, str] = {}

    def add_user(self, imsi: str, clid: str) -> bool:
        with self._lock:
            self._clid_by_imsi[imsi] = clid
            self._imsi_by_clid[clid] = imsi
            return True

    def set_registration_ip(self, imsi: str, ip: str) -> None:
        with self._lock:
            self._ip_by_imsi[imsi] = ip

    def get_imsi(self, clid: str) -> Optional[str]:
        with self._lock:
            return self._imsi_by_clid.get(clid)

    def get_clid(self, imsi: str) -> Optional[str]:
        with self._lock:
            return self._clid_by_imsi.get(imsi)

    def get_registration_ip(self, imsi: str) -> Optional[str]:
        with self._lock:
            return self._ip_by_imsi.get(imsi)


class AsteriskHLR(HLR):
    """Asterisk-config-backed HLR (HLR/HLR.cpp): subscribers appear as
    SIP peers in sip.conf and extensions in extensions.conf; writes are
    config rewrites followed by an Asterisk `sip reload`."""

    SIP_STANZA = ("[{imsi}]\ntype=friend\nhost=dynamic\n"
                  "context=sip-local\ncallerid={clid}\ncanreinvite=no\n"
                  "dtmfmode=info\n")
    EXTEN_LINE = "exten => {clid},1,Dial(SIP/{imsi})\n"

    def __init__(self, sip_conf: str, extensions_conf: str,
                 reload_cmd: Optional[list[str]] = None):
        self.sip_conf = sip_conf
        self.extensions_conf = extensions_conf
        self.reload_cmd = reload_cmd  # e.g. ["asterisk","-rx","sip reload"]

    # -- parsing (HLR.cpp getIMSI/getCLID regex scans) -----------------
    def _read(self, path: str) -> str:
        try:
            with open(path) as f:
                return f.read()
        except FileNotFoundError:
            return ""

    def get_imsi(self, clid: str) -> Optional[str]:
        text = self._read(self.extensions_conf)
        m = re.search(rf"exten\s*=>\s*{re.escape(clid)},1,Dial\(SIP/(\w+)\)",
                      text)
        return m.group(1) if m else None

    def get_clid(self, imsi: str) -> Optional[str]:
        text = self._read(self.sip_conf)
        m = re.search(rf"\[{re.escape(imsi)}\][^[]*?callerid=(\S+)", text,
                      re.S)
        return m.group(1) if m else None

    def get_registration_ip(self, imsi: str) -> Optional[str]:
        # The reference greps Asterisk's sip database; stand-alone we
        # track nothing — Asterisk owns registrations.
        return None

    def add_user(self, imsi: str, clid: str) -> bool:
        if self.get_clid(imsi) is None:
            with open(self.sip_conf, "a") as f:
                f.write("\n" + self.SIP_STANZA.format(imsi=imsi, clid=clid))
        if self.get_imsi(clid) is None:
            with open(self.extensions_conf, "a") as f:
                f.write(self.EXTEN_LINE.format(imsi=imsi, clid=clid))
        if self.reload_cmd:
            try:
                subprocess.run(self.reload_cmd, check=False, timeout=10,
                               capture_output=True)
            except Exception:
                return False
        return True


class HLRCache(HLR):
    """TTL read-through cache over another HLR (HLR.h:105-168)."""

    def __init__(self, backing: HLR, ttl_s: float = 600.0):
        self.backing = backing
        self.ttl = ttl_s
        self._lock = threading.Lock()
        self._cache: Dict[Tuple[str, str], Tuple[Optional[str], float]] = {}

    def _get(self, kind: str, key: str, fetch):
        now = systime.monotonic()
        with self._lock:
            hit = self._cache.get((kind, key))
            if hit and hit[1] > now:
                return hit[0]
        val = fetch(key)
        with self._lock:
            self._cache[(kind, key)] = (val, now + self.ttl)
        return val

    def get_imsi(self, clid: str) -> Optional[str]:
        return self._get("imsi", clid, self.backing.get_imsi)

    def get_clid(self, imsi: str) -> Optional[str]:
        return self._get("clid", imsi, self.backing.get_clid)

    def get_registration_ip(self, imsi: str) -> Optional[str]:
        return self._get("ip", imsi, self.backing.get_registration_ip)

    def add_user(self, imsi: str, clid: str) -> bool:
        with self._lock:
            self._cache.pop(("clid", imsi), None)
            self._cache.pop(("imsi", clid), None)
        return self.backing.add_user(imsi, clid)
