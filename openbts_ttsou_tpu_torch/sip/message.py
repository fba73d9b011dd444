"""Minimal RFC 3261 SIP message codec.

Reference behavior: `SIP/SIPMessage.{h,cpp}` + `SIPUtility.{h,cpp}` —
request/response construction (INVITE, REGISTER, MESSAGE, BYE, OK…),
via-branch/tag generation, SDP bodies for RTP sessions. The reference
uses libosip2; this is a dependency-free equivalent covering the subset
the BTS uses.
"""

from __future__ import annotations

import dataclasses
import random
import string
from typing import Dict, List, Optional


def _token(n: int = 12) -> str:
    return "".join(random.choice(string.ascii_lowercase + string.digits)
                   for _ in range(n))


def new_tag() -> str:
    return _token(8)


def new_branch() -> str:
    return "z9hG4bK" + _token(10)  # RFC 3261 magic cookie


def new_call_id(host: str) -> str:
    return f"{_token(16)}@{host}"


@dataclasses.dataclass
class SIPMessage:
    """One SIP request or response."""

    method: str = ""  # request method, "" for responses
    uri: str = ""
    status: int = 0  # response status, 0 for requests
    reason: str = ""
    headers: Dict[str, List[str]] = dataclasses.field(default_factory=dict)
    body: str = ""

    # -- header helpers ------------------------------------------------
    def get(self, name: str) -> Optional[str]:
        vals = self.headers.get(name.lower())
        return vals[0] if vals else None

    def get_all(self, name: str) -> List[str]:
        return self.headers.get(name.lower(), [])

    def set(self, name: str, value: str) -> "SIPMessage":
        self.headers[name.lower()] = [value]
        return self

    def add(self, name: str, value: str) -> "SIPMessage":
        self.headers.setdefault(name.lower(), []).append(value)
        return self

    @property
    def is_request(self) -> bool:
        return bool(self.method)

    def call_id(self) -> Optional[str]:
        return self.get("call-id")

    def cseq(self) -> tuple[int, str]:
        v = self.get("cseq") or "0 NONE"
        num, _, meth = v.partition(" ")
        return int(num), meth.strip()

    def header_param(self, name: str, param: str) -> Optional[str]:
        v = self.get(name)
        if not v:
            return None
        for part in v.split(";")[1:]:
            k, _, val = part.strip().partition("=")
            if k == param:
                return val
        return None

    def uri_user(self, name: str) -> Optional[str]:
        """user part of the URI in a To/From/Contact header."""
        v = self.get(name)
        if not v:
            return None
        start = v.find("sip:")
        if start < 0:
            return None
        rest = v[start + 4 :]
        for stop in ("@", ">", ";", " "):
            idx = rest.find(stop)
            if idx >= 0 and stop == "@":
                return rest[:idx]
            if idx >= 0:
                rest = rest[:idx]
        return rest

    # -- serialization -------------------------------------------------
    _ORDER = ["via", "max-forwards", "from", "to", "call-id", "cseq",
              "contact", "expires", "content-type", "content-length"]

    def render(self) -> bytes:
        if self.is_request:
            start = f"{self.method} {self.uri} SIP/2.0"
        else:
            start = f"SIP/2.0 {self.status} {self.reason}"
        body = self.body.encode()
        self.set("content-length", str(len(body)))
        lines = [start]
        done = set()
        for name in self._ORDER:
            for v in self.headers.get(name, []):
                lines.append(f"{_canonical(name)}: {v}")
            done.add(name)
        for name, vals in self.headers.items():
            if name in done:
                continue
            for v in vals:
                lines.append(f"{_canonical(name)}: {v}")
        return ("\r\n".join(lines) + "\r\n\r\n").encode() + body

    @classmethod
    def parse(cls, data: bytes) -> "SIPMessage":
        head, _, body = data.partition(b"\r\n\r\n")
        lines = head.decode(errors="replace").split("\r\n")
        start = lines[0]
        msg = cls()
        if start.startswith("SIP/2.0"):
            parts = start.split(" ", 2)
            msg.status = int(parts[1])
            msg.reason = parts[2] if len(parts) > 2 else ""
        else:
            parts = start.split(" ")
            msg.method = parts[0]
            msg.uri = parts[1] if len(parts) > 1 else ""
        for line in lines[1:]:
            if not line.strip():
                continue
            name, _, value = line.partition(":")
            msg.add(name.strip(), value.strip())
        msg.body = body.decode(errors="replace")
        return msg


def _canonical(name: str) -> str:
    special = {"call-id": "Call-ID", "cseq": "CSeq", "www-authenticate":
               "WWW-Authenticate"}
    if name in special:
        return special[name]
    return "-".join(p.capitalize() for p in name.split("-"))


def make_request(method: str, to_user: str, from_user: str, host: str,
                 port: int, local_host: str, local_port: int,
                 call_id: Optional[str] = None, cseq: int = 1,
                 from_tag: Optional[str] = None,
                 body: str = "", content_type: str = "") -> SIPMessage:
    """Build a request the way the reference's sip_* constructors do
    (SIPMessage.cpp)."""
    m = SIPMessage(method=method, uri=f"sip:{to_user}@{host}:{port}")
    m.set("via", f"SIP/2.0/UDP {local_host}:{local_port};"
                 f"branch={new_branch()}")
    m.set("max-forwards", "70")
    m.set("from", f"<sip:{from_user}@{local_host}>;tag="
                  f"{from_tag or new_tag()}")
    m.set("to", f"<sip:{to_user}@{host}>")
    m.set("call-id", call_id or new_call_id(local_host))
    m.set("cseq", f"{cseq} {method}")
    m.set("contact", f"<sip:{from_user}@{local_host}:{local_port}>")
    if body:
        m.set("content-type", content_type or "application/sdp")
        m.body = body
    return m


def make_response(request: SIPMessage, status: int, reason: str,
                  to_tag: Optional[str] = None, body: str = "",
                  content_type: str = "") -> SIPMessage:
    """Response echoing Via/From/Call-ID/CSeq (RFC 3261 8.2.6)."""
    r = SIPMessage(status=status, reason=reason)
    for via in request.get_all("via"):
        r.add("via", via)
    r.set("from", request.get("from") or "")
    to = request.get("to") or ""
    if to_tag and "tag=" not in to:
        to = f"{to};tag={to_tag}"
    r.set("to", to)
    r.set("call-id", request.call_id() or "")
    r.set("cseq", request.get("cseq") or "")
    if body:
        r.set("content-type", content_type or "application/sdp")
        r.body = body
    return r


def make_sdp(host: str, rtp_port: int, codec: int = 3,
             session_id: Optional[str] = None) -> str:
    """SDP offer/answer for GSM-FR RTP (payload type 3 = GSM 06.10),
    as the reference builds for INVITE/OK (SIPMessage.cpp sdp)."""
    sid = session_id or str(random.randint(10 ** 8, 10 ** 9))
    name = {3: "GSM", 0: "PCMU"}.get(codec, str(codec))
    return ("v=0\r\n"
            f"o=openbts {sid} {sid} IN IP4 {host}\r\n"
            "s=call\r\n"
            f"c=IN IP4 {host}\r\n"
            "t=0 0\r\n"
            f"m=audio {rtp_port} RTP/AVP {codec}\r\n"
            f"a=rtpmap:{codec} {name}/8000\r\n")


def parse_sdp_rtp(body: str) -> tuple[Optional[str], Optional[int]]:
    """(host, rtp_port) from an SDP body."""
    host = None
    port = None
    for line in body.splitlines():
        if line.startswith("c=IN IP4 "):
            host = line.split()[-1]
        elif line.startswith("m=audio "):
            port = int(line.split()[1])
    return host, port
