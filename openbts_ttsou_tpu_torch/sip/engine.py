"""Per-transaction SIP user agent.

Reference behavior: `SIP/SIPEngine.{h,cpp}` — the state machine
{NullState, Starting, Proceeding, Ringing, Busy, Connecting, Active,
Clearing, Cleared, Fail, MessageSubmit, Timeout} (SIPEngine.h:46-59)
with Register/Unregister, the MOC INVITE flow
(MOCSendINVITE/MOCWaitForOK/MOCSendACK), the MTC answering flow
(MTCSendRinging/MTCSendOK/MTCWaitForACK), MOSMS MESSAGE submission and
MOD/MTD BYE clearing; RTP via `sip.rtp`.

Transport is injected (a `send(bytes)` callable) and inbound messages
are delivered by the SIPInterface demux — event-driven like the rest of
this stack, so it is testable without real sockets. The reference's
one blocking wait, the DTMF relay's INFO (sendINFOAndWaitForOK), is
split in two: `send_dtmf_info` sends the INFO and `dtmf_answer` reads a
later message of the call; Control keeps the wait.
"""

from __future__ import annotations

import enum
from typing import Callable, Optional

from openbts_ttsou_tpu_torch.sip.message import (
    SIPMessage,
    make_request,
    make_response,
    make_sdp,
    new_call_id,
    new_tag,
    parse_sdp_rtp,
)
from openbts_ttsou_tpu_torch.sip.rtp import RTPSession


class SIPState(enum.Enum):
    """SIPEngine.h:46-59."""

    NullState = 0
    Timeout = 1
    Starting = 2
    Proceeding = 3
    Ringing = 4
    Busy = 5
    Connecting = 6
    Active = 7
    Clearing = 8
    Cleared = 9
    Fail = 10
    MessageSubmit = 11


class SIPEngine:
    def __init__(self, username: str, local_host: str, local_port: int,
                 proxy_host: str, proxy_port: int,
                 send: Callable[[bytes], None]):
        self.username = username
        self.local_host = local_host
        self.local_port = local_port
        self.proxy_host = proxy_host
        self.proxy_port = proxy_port
        self._send = send
        self.state = SIPState.NullState
        self.call_id: Optional[str] = None
        self.cseq = 1
        self.from_tag = new_tag()
        self.to_tag: Optional[str] = None
        self.remote_user = ""
        self.rtp: Optional[RTPSession] = None
        self._invite: Optional[SIPMessage] = None
        self._last_request: Optional[SIPMessage] = None

    # ------------------------------------------------------------------
    def _transmit(self, msg: SIPMessage) -> None:
        self._last_request = msg if msg.is_request else self._last_request
        self._send(msg.render())

    def _next_cseq(self) -> int:
        self.cseq += 1
        return self.cseq

    # -- registration (SIPEngine::Register, cpp) -----------------------
    def register(self, expires: int = 3600) -> None:
        self.call_id = self.call_id or new_call_id(self.local_host)
        m = make_request("REGISTER", self.username, self.username,
                         self.proxy_host, self.proxy_port,
                         self.local_host, self.local_port,
                         call_id=self.call_id, cseq=self._next_cseq(),
                         from_tag=self.from_tag)
        m.uri = f"sip:{self.proxy_host}:{self.proxy_port}"
        m.set("expires", str(expires))
        self._transmit(m)
        self.state = SIPState.Starting

    def unregister(self) -> None:
        self.register(expires=0)

    # -- MOC (SIPEngine.h:184-199) -------------------------------------
    def moc_send_invite(self, called: str, codec: int = 3) -> SIPState:
        self.remote_user = called
        self.call_id = new_call_id(self.local_host)
        self.rtp = self.rtp or RTPSession()
        sdp = make_sdp(self.local_host, self.rtp.local_port, codec)
        m = make_request("INVITE", called, self.username,
                         self.proxy_host, self.proxy_port,
                         self.local_host, self.local_port,
                         call_id=self.call_id, cseq=self._next_cseq(),
                         from_tag=self.from_tag, body=sdp)
        self._invite = m
        self._transmit(m)
        self.state = SIPState.Starting
        return self.state

    def moc_resend_invite(self) -> SIPState:
        if self._invite is not None:
            self._transmit(self._invite)
        return self.state

    def moc_send_ack(self) -> SIPState:
        assert self._invite is not None
        ack = make_request("ACK", self.remote_user, self.username,
                           self.proxy_host, self.proxy_port,
                           self.local_host, self.local_port,
                           call_id=self.call_id, cseq=self.cseq,
                           from_tag=self.from_tag)
        ack.set("cseq", f"{self.cseq} ACK")
        if self.to_tag:
            ack.set("to", f"<sip:{self.remote_user}@{self.proxy_host}>"
                          f";tag={self.to_tag}")
        self._transmit(ack)
        self.state = SIPState.Active
        return self.state

    # -- MTC (SIPEngine.h:223-243) -------------------------------------
    def mtc_accept_invite(self, invite: SIPMessage) -> None:
        """Adopt an inbound INVITE as the transaction context."""
        self._invite = invite
        self.call_id = invite.call_id()
        self.remote_user = invite.uri_user("from") or ""
        self.to_tag = new_tag()
        self.state = SIPState.Starting

    def mtc_send_trying(self) -> SIPState:
        assert self._invite is not None
        self._send(make_response(self._invite, 100, "Trying",
                                 self.to_tag).render())
        self.state = SIPState.Proceeding
        return self.state

    def mtc_send_ringing(self) -> SIPState:
        assert self._invite is not None
        self._send(make_response(self._invite, 180, "Ringing",
                                 self.to_tag).render())
        self.state = SIPState.Ringing
        return self.state

    def mtc_send_ok(self, codec: int = 3) -> SIPState:
        assert self._invite is not None
        self.rtp = self.rtp or RTPSession()
        host, port = parse_sdp_rtp(self._invite.body)
        if host and port:
            self.rtp.connect(host, port)
        sdp = make_sdp(self.local_host, self.rtp.local_port, codec)
        self._send(make_response(self._invite, 200, "OK", self.to_tag,
                                 body=sdp).render())
        self.state = SIPState.Connecting
        return self.state

    # -- SMS (SIPEngine.h:205-219) -------------------------------------
    def mosms_send_message(self, called: str, text: str) -> SIPState:
        self.remote_user = called
        self.call_id = new_call_id(self.local_host)
        m = make_request("MESSAGE", called, self.username,
                         self.proxy_host, self.proxy_port,
                         self.local_host, self.local_port,
                         call_id=self.call_id, cseq=self._next_cseq(),
                         from_tag=self.from_tag, body=text,
                         content_type="text/plain")
        self._transmit(m)
        self.state = SIPState.MessageSubmit
        return self.state

    def send_dtmf_info(self, key: str,
                       duration_ms: int = 250) -> Optional[int]:
        """In-call DTMF via SIP INFO application/dtmf-relay (the send
        half of SIPEngine::sendINFOAndWaitForOK). Returns the INFO's
        CSeq, or None when the INFO could not be sent."""
        body = f"Signal={key}\r\nDuration={duration_ms}\r\n"
        m = make_request("INFO", self.remote_user or self.username,
                         self.username, self.proxy_host, self.proxy_port,
                         self.local_host, self.local_port,
                         call_id=self.call_id, cseq=self._next_cseq(),
                         from_tag=self.from_tag, body=body,
                         content_type="application/dtmf-relay")
        try:
            self._transmit(m)
        except OSError:
            return None
        return self.cseq

    @staticmethod
    def dtmf_answer(msg: SIPMessage, cseq: int) -> Optional[bool]:
        """What `msg` says of the INFO sent with `cseq`: None when it is
        not a final answer to it, True for a 200, False for any other
        final status (a failed relay)."""
        if msg.is_request or msg.status < 200 or \
                msg.cseq() != (cseq, "INFO"):
            return None
        return msg.status == 200

    def mtsms_send_ok(self, message: SIPMessage) -> None:
        self._send(make_response(message, 200, "OK", new_tag()).render())

    # -- clearing (SIPEngine.h:245-258) --------------------------------
    def mod_send_bye(self) -> SIPState:
        m = make_request("BYE", self.remote_user or self.username,
                         self.username, self.proxy_host, self.proxy_port,
                         self.local_host, self.local_port,
                         call_id=self.call_id, cseq=self._next_cseq(),
                         from_tag=self.from_tag)
        if self.to_tag:
            m.set("to", f"<sip:{self.remote_user}@{self.proxy_host}>"
                        f";tag={self.to_tag}")
        self._transmit(m)
        self.state = SIPState.Clearing
        return self.state

    def mtd_send_ok(self, bye: SIPMessage) -> SIPState:
        self._send(make_response(bye, 200, "OK").render())
        self.state = SIPState.Cleared
        return self.state

    # -- inbound dispatch ----------------------------------------------
    def receive(self, msg: SIPMessage) -> SIPState:
        """Advance the state machine on an inbound message
        (the MOCWaitForOK / MTCWaitForACK / MODWaitForOK flows)."""
        if msg.is_request:
            if msg.method == "ACK":
                if self.state == SIPState.Connecting:
                    self.state = SIPState.Active
            elif msg.method == "BYE":
                self.mtd_send_ok(msg)
            return self.state
        # responses
        _, cmethod = msg.cseq()
        if cmethod == "REGISTER":
            if msg.status == 200:
                self.state = SIPState.Cleared
            elif msg.status >= 400:
                self.state = SIPState.Fail
            return self.state
        if cmethod == "INVITE":
            if msg.status == 100:
                self.state = SIPState.Proceeding
            elif msg.status in (180, 183):
                self.state = SIPState.Ringing
            elif msg.status == 200:
                self.to_tag = msg.header_param("to", "tag")
                host, port = parse_sdp_rtp(msg.body)
                if self.rtp and host and port:
                    self.rtp.connect(host, port)
                self.state = SIPState.Connecting
            elif msg.status == 486:
                self.state = SIPState.Busy
            elif msg.status >= 400:
                self.state = SIPState.Fail
            return self.state
        if cmethod == "MESSAGE":
            if msg.status == 200:
                self.state = SIPState.Cleared
            elif msg.status >= 400:
                self.state = SIPState.Fail
            return self.state
        if cmethod == "BYE":
            if msg.status == 200:
                self.state = SIPState.Cleared
            return self.state
        return self.state

    # -- voice plane ---------------------------------------------------
    def tx_frame(self, frame: bytes) -> None:
        if self.rtp:
            self.rtp.tx_frame(frame)

    def rx_frame(self) -> Optional[bytes]:
        return self.rtp.rx_frame() if self.rtp else None

    def close(self) -> None:
        if self.rtp:
            self.rtp.close()
            self.rtp = None
