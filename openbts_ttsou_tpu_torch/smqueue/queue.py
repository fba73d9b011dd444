"""RFC 3428 store-and-forward SMS daemon.

Reference behavior: `smqueue/` — `short_msg`/`short_msg_pending` with a
16-state per-message machine (`smqueue.h:59-83`), a time-sorted queue,
per-state timeout tables with a next-state-on-timeout transition
(`smqueue.cpp:46-120`), the `main_loop` (smqueue.cpp:1819) over its own
SIP mini-stack (`smnet.{h,cpp}`), and shortcode command plugins
(`smcommands.cpp`).

This implementation keeps the full state set and the timeout-table
idiom: each message sits in the priority queue keyed by its next action
time; when it pops, the handler for its state runs; "ASKED_*" states
are waits on an external reply whose timeout falls back to the matching
"REQUEST_*" retry state.
"""

from __future__ import annotations

import dataclasses
import enum
import heapq
import itertools
import time as systime
from typing import Callable, Dict, List, Optional

from openbts_ttsou_tpu_torch.sip.message import SIPMessage, make_request, make_response
from openbts_ttsou_tpu_torch.utils.logger import get_logger

log = get_logger("smqueue")


class ShortMsgState(enum.IntEnum):
    """The reference's sm_state enum (smqueue.h:59-83), 1:1."""

    NoState = 0
    RequestFromAddressLookup = 1
    AskedForFromAddressLookup = 2
    AwaitingTryDestinationImsi = 3
    RequestDestinationImsi = 4
    AskedForDestinationImsi = 5
    AwaitingTryDestinationSipUrl = 6
    RequestDestinationSipUrl = 7
    AskedForDestinationSipUrl = 8
    AwaitingTryMsgDelivery = 9
    RequestMsgDelivery = 10
    AskedForMsgDelivery = 11
    DeleteMeState = 12
    AwaitingRegisterHandset = 13
    RegisterHandset = 14
    AskedToRegisterHandset = 15


INITIAL_STATE = ShortMsgState.RequestFromAddressLookup

#: shortcode handler sentinel: queue the message normally after all
#: (the reference's SCA_TREAT_AS_ORDINARY, smcommands.cpp:54)
TREAT_AS_ORDINARY = object()

# The reference's full per-(from-state, to-state) timeout table
# (smqueue.cpp:46-120), transcribed one-for-one. TIMEOUTS[a][b] is the
# timeout (seconds) armed when a message moves from state a to state b;
# NT = "no timeout" (only fires if something is really broken), RT =
# "retry" (start over from scratch after an error).
NT = 6000
RT = 600
#           NS  RF  AF   WD  RD  AD   WS  RS  AS   WM  RM  AM   DM   WR  RH  AR
TIMEOUTS: tuple = (
    (NT,  0, NT,  NT,  0, NT,  NT,  0, NT,  NT,  0, NT,   0,  NT, NT, NT),  # NoState
    (0,  10, 10,  NT,  0, NT,  NT, NT, NT,  NT, NT, NT,   0,   1,  0, NT),  # RequestFromAddressLookup
    (0,  60, NT,  NT, NT, NT,  NT, NT, NT,  NT, NT, NT,   0,  NT, NT, NT),  # AskedForFromAddressLookup
    (0,  RT, NT,  RT, NT, NT,  NT, NT, NT,  NT, NT, NT,   0,  NT, NT, NT),  # AwaitingTryDestinationImsi
    (0,  RT, NT,  RT, NT, NT,  NT,  0, NT,  NT, NT, NT,   0,  NT, NT, NT),  # RequestDestinationImsi
    (0,  RT, NT,  RT, NT, NT,  NT, NT, NT,  NT, NT, NT,   0,  NT, NT, NT),  # AskedForDestinationImsi
    (0,  RT, NT,  RT, NT, NT,  NT, NT, NT,  NT, NT, NT,   0,  NT, NT, NT),  # AwaitingTryDestinationSipUrl
    (0,  RT, NT,  RT, NT, NT,  NT, NT, NT,  NT,  0, NT,   0,  NT, NT, NT),  # RequestDestinationSipUrl
    (0,  RT, NT,  RT, NT, NT,  NT, NT, NT,  NT, NT, NT,   0,  NT, NT, NT),  # AskedForDestinationSipUrl
    (0,  RT, NT,  RT, NT, NT,  NT, NT, NT,  75,  0, NT,   0,  NT, NT, NT),  # AwaitingTryMsgDelivery
    (0,  RT, NT,  RT, NT, NT,  NT, 75, NT,  75, 75, 15,   0,  NT, NT, NT),  # RequestMsgDelivery
    (0,  RT, NT,  NT, NT, NT,  NT, NT, NT,  60, 10, NT,   0,  NT, NT, NT),  # AskedForMsgDelivery
    (0,   0,  0,   0,  0,  0,   0,  0,  0,   0,  0,  0,   0,   0,  0,  0),  # DeleteMeState
    (0,   0, NT,  RT, NT, NT,  NT, NT, NT,  NT, NT, NT,   0,   1,  0, NT),  # AwaitingRegisterHandset
    (0,   0, NT,  RT, NT, NT,  NT, NT, NT,  NT, NT, NT,   0,   1,  1,  2),  # RegisterHandset
    (0,   0, NT,  RT, NT, NT,  NT, NT, NT,  NT, NT, NT,   0,   1,  1, 10),  # AskedToRegisterHandset
)
assert len(TIMEOUTS) == 16 and all(len(r) == 16 for r in TIMEOUTS)

#: state → state entered when its timer fires ("ASKED_*" waits fall
#: back to the matching "REQUEST_*" retry, the reference handlers'
#: timeout actions).
TIMEOUT_NEXT_STATE: Dict[ShortMsgState, ShortMsgState] = {
    ShortMsgState.AskedForFromAddressLookup:
        ShortMsgState.RequestFromAddressLookup,
    ShortMsgState.AwaitingTryDestinationImsi:
        ShortMsgState.RequestDestinationImsi,
    ShortMsgState.AskedForDestinationImsi:
        ShortMsgState.RequestDestinationImsi,
    ShortMsgState.AwaitingTryDestinationSipUrl:
        ShortMsgState.RequestDestinationSipUrl,
    ShortMsgState.AskedForDestinationSipUrl:
        ShortMsgState.RequestDestinationSipUrl,
    ShortMsgState.AwaitingTryMsgDelivery:
        ShortMsgState.RequestMsgDelivery,
    ShortMsgState.AskedForMsgDelivery:
        ShortMsgState.RequestMsgDelivery,
    ShortMsgState.AwaitingRegisterHandset:
        ShortMsgState.RegisterHandset,
    ShortMsgState.AskedToRegisterHandset:
        ShortMsgState.RegisterHandset,
}

#: Back-compat view of the old condensed table: state → (timeout from
#: the canonical predecessor, timeout-fallback state).
_CANONICAL_FROM: Dict[ShortMsgState, ShortMsgState] = {
    ShortMsgState.AskedForFromAddressLookup:
        ShortMsgState.RequestFromAddressLookup,
    ShortMsgState.AwaitingTryDestinationImsi:
        ShortMsgState.AskedForFromAddressLookup,
    ShortMsgState.AskedForDestinationImsi:
        ShortMsgState.RequestDestinationImsi,
    ShortMsgState.AwaitingTryDestinationSipUrl:
        ShortMsgState.AskedForDestinationImsi,
    ShortMsgState.AskedForDestinationSipUrl:
        ShortMsgState.RequestDestinationSipUrl,
    ShortMsgState.AwaitingTryMsgDelivery:
        ShortMsgState.RequestMsgDelivery,
    ShortMsgState.AskedForMsgDelivery:
        ShortMsgState.RequestMsgDelivery,
    ShortMsgState.AwaitingRegisterHandset:
        ShortMsgState.RequestFromAddressLookup,
    ShortMsgState.AskedToRegisterHandset:
        ShortMsgState.RegisterHandset,
}
STATE_TIMEOUTS: Dict[ShortMsgState, tuple[float, ShortMsgState]] = {
    st: (float(TIMEOUTS[frm][st]), TIMEOUT_NEXT_STATE[st])
    for st, frm in _CANONICAL_FROM.items()
}


def sm_state_name(state: ShortMsgState) -> str:
    """Printable state name (sm_state_strings, smqueue.h:89-90)."""
    return state.name


@dataclasses.dataclass(order=True)
class ShortMsg:
    """One queued message (short_msg_pending, smqueue.h:306)."""

    next_action_time: float
    seq: int = dataclasses.field(compare=True)
    frm: str = dataclasses.field(compare=False, default="")
    to: str = dataclasses.field(compare=False, default="")
    body: str = dataclasses.field(compare=False, default="")
    state: ShortMsgState = dataclasses.field(
        compare=False, default=INITIAL_STATE)
    retries: int = dataclasses.field(compare=False, default=0)
    call_id: str = dataclasses.field(compare=False, default="")
    dest_imsi: str = dataclasses.field(compare=False, default="")
    dest_url: str = dataclasses.field(compare=False, default="")

    def set_state(self, st: ShortMsgState, now: float) -> None:
        """Enter `st`, arming the reference's transition timeout
        TIMEOUTS[old][new] (smqueue.cpp set_state_and_timeout idiom).
        Where the reference marks the transition NT (our async-lookup
        graph takes a few edges its synchronous HLR path never did),
        fall back to the condensed per-state wait; REQUEST_*/terminal
        states stay immediately actionable."""
        t2d = TIMEOUTS[self.state][st]
        self.state = st
        if t2d != NT:
            self.next_action_time = now + float(t2d)
        elif st in STATE_TIMEOUTS:
            self.next_action_time = now + STATE_TIMEOUTS[st][0]
        else:
            self.next_action_time = now


class SMq:
    """The store-and-forward engine (SMq, smqueue.h; main_loop
    smqueue.cpp:1819). Transport and lookups are injected for
    testability."""

    MAX_RETRIES = 5
    RETRY_INTERVAL_S = 30.0

    def __init__(self, send: Callable[[str, str], None],
                 resolve: Callable[[str], Optional[str]],
                 resolve_sender: Optional[Callable[[str], bool]] = None,
                 register_handset: Optional[Callable[[str], bool]] = None,
                 local_host: str = "127.0.0.1", local_port: int = 5063,
                 hlr=None):
        """send(dest_uri_user, rendered_request): deliver a SIP MESSAGE;
        resolve(user): user/shortcode → registered destination user
        (the IMSI/SIP-URL lookup pair), or None if unknown;
        resolve_sender(user): from-address validation (True = known);
        register_handset(user): kick off handset registration for an
        unregistered destination (the REGISTER_HANDSET flow);
        hlr: optional `control.hlr.HLR` behind the 101 registration
        shortcode (my_hlr in smcommands.cpp)."""
        self._send = send
        self._resolve = resolve
        self._resolve_sender = resolve_sender or (lambda u: True)
        self._register_handset = register_handset
        self.hlr = hlr
        self.local_host = local_host
        self.local_port = local_port
        self._heap: List[ShortMsg] = []
        self._seq = itertools.count()
        self.shortcodes: Dict[str, Callable[[ShortMsg], Optional[str]]] = {}
        self.install_default_shortcodes()
        self.delivered: List[ShortMsg] = []
        self.failed: List[ShortMsg] = []
        self.quit_requested = False

    # -- shortcode plugins (smcommands.cpp:init_smcommands, :360-368) --
    def install_default_shortcodes(self) -> None:
        self.shortcodes["101"] = self._sc_register
        self.shortcodes["411"] = self._sc_four_one_one
        self.shortcodes["666"] = lambda m: None  # blackhole test code
        self.shortcodes["2336"] = self._sc_debug_dump
        self.shortcodes["2337"] = self._sc_quick_chk
        self.shortcodes["2338"] = self._sc_zap_queued
        self.shortcodes["314158"] = self._sc_whiplash

    def _sc_register(self, m: ShortMsg) -> Optional[str]:
        """Phone-number self-registration (shortcode_register,
        smcommands.cpp:225-358): parse the number, consult the HLR,
        add the user. The sender user is the IMSI."""
        phonenum, exclaim = [], 0
        for ch in m.body:
            if ch.isdigit():
                phonenum.append(ch)
            elif ch == "+":
                if phonenum:
                    return "Error: + can only be first"
            elif ch in " ()\r\n":
                continue
            elif ch == "!":
                exclaim += 1
            else:
                return f"Error: invalid '{ch}'."
        num = "".join(phonenum)
        if len(num) < 10 and exclaim != 3:
            return ("Try again, give us a whole 10-digit phone number, "
                    f"not just {num}")
        if len(num) > 15 and exclaim != 3:
            return ("Try again, give us a short (10-digit?) phone "
                    f"number, not {num}")
        if self.hlr is None:
            return "Registration unavailable."
        imsi = m.frm
        existing = self.hlr.get_clid(imsi)
        if existing:
            if existing == num:
                return (f"Welcome to the free cellular network, {num}. "
                        "You may be able to make short outgoing calls "
                        "if you dial 1.")
            return f"Your phone is already registered as {existing}."
        if self.hlr.get_imsi(num):
            return (f"That phone number {num} is already in use.  Try "
                    "another (then call that one to talk to whoever "
                    "took yours).")
        self.hlr.add_user(imsi, num)
        if self._register_handset is not None:  # SCA_REGISTER flow
            self._register_handset(imsi)
        return (f"Welcome to the free cellular network, {num}. "
                "You may be able to make short outgoing calls "
                "if you dial 1.")

    def _sc_four_one_one(self, m: ShortMsg) -> str:
        """Queue status line (shortcode_four_one_one,
        smcommands.cpp:80-151)."""
        delivering = {ShortMsgState.RequestDestinationSipUrl,
                      ShortMsgState.RequestMsgDelivery,
                      ShortMsgState.AskedForMsgDelivery,
                      ShortMsgState.AwaitingTryMsgDelivery}
        registering = sum(1 for x in self._heap if x.state in (
            ShortMsgState.AwaitingRegisterHandset,
            ShortMsgState.RegisterHandset,
            ShortMsgState.AskedToRegisterHandset))
        bouncing = sum(1 for x in self._heap
                       if x.state in delivering and x.frm == "411")
        parts = [f"{len(self._heap)} queued"]
        if registering:
            parts.append(f"{registering} registering")
        if bouncing:
            parts.append(f"{bouncing} bouncing")
        phonenum = self.hlr.get_clid(m.frm) if self.hlr else None
        parts.append(m.frm)
        parts.append(f"phonenum {phonenum}")
        parts.append("at " + systime.strftime("%b %d %H:%M:%S"))
        parts.append(f"'{m.body}'")
        return ", ".join(parts)

    def _sc_debug_dump(self, m: ShortMsg) -> None:
        """debug_dump to the log, no reply (SCA_DONE)."""
        for x in sorted(self._heap):
            log.warning("DUMP tag=%d state=%s %s->%s %r", x.seq,
                        sm_state_name(x.state), x.frm, x.to, x.body[:40])
        return None

    def _sc_quick_chk(self, m: ShortMsg) -> str:
        return f"{len(self._heap)} queued."

    def _sc_zap_queued(self, m: ShortMsg) -> Optional[str]:
        """Delete a queued message by tag; '-' prefix = no reply;
        '6000' = sweep NoState/huge-timeout messages
        (shortcode_zap_queued, smcommands.cpp:162-222)."""
        text = m.body.strip()
        noreply = text.startswith("-")
        if noreply:
            text = text[1:]
        if text == "6000":
            now = systime.monotonic()
            toolate = 5000 + (self._heap[0].next_action_time
                              if self._heap else now)
            keep = [x for x in self._heap
                    if x.state != ShortMsgState.NoState
                    and x.next_action_time < toolate]
            n = len(self._heap) - len(keep)
            self._heap = keep
            heapq.heapify(self._heap)
            return None if noreply else f"Removed {n} messages."
        for x in self._heap:
            if str(x.seq) == text:
                self._heap.remove(x)
                heapq.heapify(self._heap)
                return None if noreply else (
                    f"Deleting queued msg '{text}' in state "
                    f"{int(x.state)} and timeout "
                    f"{x.next_action_time - systime.monotonic():.0f}")
        return None if noreply else \
            f"No message queued with tag '{text}'."

    def _sc_whiplash(self, m: ShortMsg):
        """The 314158 maintenance code (whiplash_quit,
        smcommands.cpp:35-55): 'Snidely quit' requests shutdown,
        'Snidely testsave' snapshots the queue; anything else is an
        ordinary message."""
        if not m.body.startswith("Snidely "):
            return TREAT_AS_ORDINARY
        cmd = m.body[8:]
        if cmd.startswith("quit"):
            self.quit_requested = True
            return None
        if cmd.startswith("testsave"):
            self.save_queue_to_file("testsave.txt")
            return "Done."
        return "Unknown Command"

    def save_queue_to_file(self, path: str,
                           now: Optional[float] = None) -> int:
        """Snapshot the queue (save_queue_to_file, smqueue.cpp:2009):
        a `=== <state> <delay> …` header per message followed by the
        length-delimited body, like the reference's `=== state time
        addr len \\n text` records. Timeouts are stored as remaining
        delay (our clock is monotonic, not wall time), so a reload
        re-arms each message's pending timer rather than firing
        everything at once."""
        now = systime.monotonic() if now is None else now
        # binary mode: the header's length field counts BYTES, so the
        # reader must count bytes too (non-ASCII bodies round-trip)
        with open(path, "wb") as f:
            for x in sorted(self._heap):
                delay = max(0.0, x.next_action_time - now)
                body = x.body.encode()
                f.write((f"=== {int(x.state)} {delay:.3f} {x.retries} "
                         f"{x.frm or '-'} {x.to or '-'} "
                         f"{x.call_id or '-'} {x.dest_imsi or '-'} "
                         f"{x.dest_url or '-'} {len(body)}\n").encode())
                f.write(body + b"\n")
        log.info("saved %d queued messages to %s", len(self._heap), path)
        return len(self._heap)

    def read_queue_from_file(self, path: str,
                             now: Optional[float] = None) -> int:
        """Reload a saved queue at boot (read_queue_from_file,
        smqueue.cpp:2041; wired at startup smqueue.cpp:2225-2232):
        each record resumes in its saved state with its remaining
        timeout re-armed. Malformed records are skipped and counted,
        like the reference's howmanyerrs path. Returns messages
        loaded."""
        now = systime.monotonic() if now is None else now
        try:
            f = open(path, "rb")
        except OSError:
            log.warning("failed to read queue from %s", path)
            return 0
        loaded = errs = 0
        with f:
            while True:
                hdr = f.readline()
                if not hdr:
                    break
                parts = hdr.split()
                if len(parts) != 10 or parts[0] != b"===":
                    errs += 1
                    continue
                try:
                    state = ShortMsgState(int(parts[1]))
                    delay = float(parts[2])
                    retries = int(parts[3])
                    nbytes = int(parts[9])
                except (ValueError, KeyError):
                    errs += 1
                    continue
                raw = f.read(nbytes)  # exact byte count (binary mode)
                f.readline()  # trailing newline
                if len(raw) < nbytes:
                    errs += 1
                    break  # truncated file
                try:
                    body = raw.decode()
                except UnicodeDecodeError:
                    errs += 1
                    continue
                frm, to, call_id, imsi, url = (
                    "" if p == b"-" else p.decode() for p in parts[4:9])
                msg = ShortMsg(now + delay, next(self._seq), frm, to,
                               body, state, retries=retries,
                               call_id=call_id, dest_imsi=imsi,
                               dest_url=url)
                if state == ShortMsgState.DeleteMeState:
                    continue  # already terminal; don't resurrect
                heapq.heappush(self._heap, msg)
                loaded += 1
        log.info("read %d messages total, %d bad ones", loaded, errs)
        return loaded

    # -- ingress -------------------------------------------------------
    def submit(self, frm: str, to: str, body: str,
               call_id: str = "") -> ShortMsg:
        """Accept a MESSAGE into the queue (handles shortcodes
        immediately, like the reference's originate/shortcode path)."""
        msg = ShortMsg(systime.monotonic(), next(self._seq), frm, to,
                       body, INITIAL_STATE, call_id=call_id)
        handler = self.shortcodes.get(to)
        if handler is not None:
            reply = handler(msg)
            if reply is not TREAT_AS_ORDINARY:
                msg.state = ShortMsgState.DeleteMeState
                if reply is not None:
                    # shortcode response goes back to the sender
                    self.submit(to, frm, reply)
                return msg
        heapq.heappush(self._heap, msg)
        return msg

    def handle_sip_message(self, sip_msg: SIPMessage) -> SIPMessage:
        """Inbound SIP MESSAGE → queue + 200 OK (the smnet ingress)."""
        frm = sip_msg.uri_user("from") or ""
        to = sip_msg.uri_user("to") or ""
        self.submit(frm, to, sip_msg.body, sip_msg.call_id() or "")
        return make_response(sip_msg, 200, "OK")

    def handle_delivery_response(self, call_id: str, status: int) -> None:
        """A response for a forwarded MESSAGE arrived."""
        now = systime.monotonic()
        for m in self._heap:
            if m.call_id == call_id and \
                    m.state == ShortMsgState.AskedForMsgDelivery:
                if status == 200:
                    m.set_state(ShortMsgState.DeleteMeState, now)
                    self.delivered.append(m)
                elif status >= 400:
                    m.retries += 1
                    m.set_state(ShortMsgState.RequestMsgDelivery, now)
                    m.next_action_time = now + self.RETRY_INTERVAL_S
                heapq.heapify(self._heap)
                return

    def handle_registration_complete(self, user: str, ok: bool) -> None:
        """Handset registration finished (the ASKED_TO_REGISTER_HANDSET
        exit): re-run the destination lookup, or bounce."""
        now = systime.monotonic()
        for m in self._heap:
            if m.to == user and m.state in (
                    ShortMsgState.AskedToRegisterHandset,
                    ShortMsgState.AwaitingRegisterHandset):
                m.set_state(ShortMsgState.RequestDestinationImsi if ok
                            else ShortMsgState.DeleteMeState, now)
                if not ok:
                    self.failed.append(m)
        heapq.heapify(self._heap)

    # -- the queue engine (main_loop) ----------------------------------
    def queue_size(self) -> int:
        return len(self._heap)

    def _bounce(self, msg: ShortMsg, now: float,
                errstr: str = "can't send") -> None:
        """Give up: bounce an error SMS from "411" back to the sender
        and delete (bounce_message, smqueue.cpp:1103-1148) — except
        when the sender IS 411, which would loop endlessly."""
        msg.set_state(ShortMsgState.DeleteMeState, now)
        self.failed.append(msg)
        if msg.frm and msg.frm != "411":
            text = (f"Can't send your SMS to {msg.to}: {errstr}: "
                    f"{msg.body}")
            bounce = ShortMsg(now, next(self._seq), "411", msg.frm,
                              text, INITIAL_STATE)
            heapq.heappush(self._heap, bounce)

    def process_queue(self, now: Optional[float] = None) -> int:
        """Run all due state transitions; returns actions taken."""
        now = systime.monotonic() if now is None else now
        actions = 0
        requeue: List[ShortMsg] = []
        while self._heap and self._heap[0].next_action_time <= now:
            msg = heapq.heappop(self._heap)
            actions += 1
            st = msg.state

            if st in (ShortMsgState.NoState,
                      ShortMsgState.RequestFromAddressLookup):
                # annotate/verify the sender; unknown senders still
                # forward (the reference only marks them). With an HLR,
                # rewrite IMSI-form senders to their caller ID (the
                # reference's lookup_from_address getCLIDLocal rewrite)
                self._resolve_sender(msg.frm)
                if self.hlr is not None:
                    imsi = (msg.frm[4:] if msg.frm.startswith("IMSI")
                            else msg.frm)
                    clid = self.hlr.get_clid(imsi)
                    if clid:
                        msg.frm = clid
                msg.set_state(ShortMsgState.RequestDestinationImsi, now)
                requeue.append(msg)

            elif st in (ShortMsgState.AwaitingTryDestinationImsi,
                        ShortMsgState.RequestDestinationImsi):
                dest = self._resolve(msg.to)
                if dest is None:
                    if self._register_handset is not None:
                        msg.set_state(ShortMsgState.RegisterHandset, now)
                        requeue.append(msg)
                        continue
                    msg.retries += 1
                    if msg.retries > self.MAX_RETRIES:
                        # BounceMessage.IMSILookupFailed (smqueue.cpp:1466)
                        self._bounce(msg, now,
                                     "Destination handset is not "
                                     "registered")
                        continue
                    msg.set_state(
                        ShortMsgState.AwaitingTryDestinationImsi, now)
                    requeue.append(msg)
                    continue
                msg.dest_imsi = dest
                msg.set_state(ShortMsgState.RequestDestinationSipUrl, now)
                requeue.append(msg)

            elif st in (ShortMsgState.AwaitingTryDestinationSipUrl,
                        ShortMsgState.RequestDestinationSipUrl):
                # IMSI → SIP URL; with the registry-backed resolver the
                # URL is the registered user at the relay
                msg.dest_url = msg.dest_imsi or msg.to
                msg.set_state(ShortMsgState.RequestMsgDelivery, now)
                requeue.append(msg)

            elif st in (ShortMsgState.AwaitingTryMsgDelivery,
                        ShortMsgState.RequestMsgDelivery):
                req = make_request("MESSAGE", msg.to, msg.frm,
                                   self.local_host, self.local_port,
                                   self.local_host, self.local_port,
                                   call_id=msg.call_id or None,
                                   body=msg.body,
                                   content_type="text/plain")
                msg.call_id = req.call_id() or msg.call_id
                self._send(msg.to, req.render().decode())
                msg.set_state(ShortMsgState.AskedForMsgDelivery, now)
                requeue.append(msg)

            elif st == ShortMsgState.AskedForMsgDelivery:
                # delivery-ack timeout → retry (timeout table row)
                msg.retries += 1
                if msg.retries > self.MAX_RETRIES:
                    self._bounce(msg, now, "delivery failed")
                    continue
                msg.set_state(ShortMsgState.RequestMsgDelivery, now)
                requeue.append(msg)

            elif st == ShortMsgState.RegisterHandset:
                ok = bool(self._register_handset and
                          self._register_handset(msg.to))
                if not ok:
                    self._bounce(msg, now)
                    continue
                msg.set_state(ShortMsgState.AskedToRegisterHandset, now)
                requeue.append(msg)

            elif st in (ShortMsgState.AskedForFromAddressLookup,
                        ShortMsgState.AskedForDestinationImsi,
                        ShortMsgState.AskedForDestinationSipUrl,
                        ShortMsgState.AskedToRegisterHandset,
                        ShortMsgState.AwaitingRegisterHandset):
                # waiting-state timeout: fall back per the table
                msg.retries += 1
                if msg.retries > self.MAX_RETRIES:
                    self._bounce(msg, now)
                    continue
                msg.set_state(TIMEOUT_NEXT_STATE[st], now)
                requeue.append(msg)

            elif st == ShortMsgState.DeleteMeState:
                pass  # dropped

            else:  # pragma: no cover - defensive
                requeue.append(msg)
        for m in requeue:
            heapq.heappush(self._heap, m)
        return actions


def main():  # pragma: no cover - manual entry point
    """Run smqueue as a standalone daemon over UDP (smqueue.cpp:1819)."""
    import argparse

    from openbts_ttsou_tpu_torch.runtime import UdpTransport

    ap = argparse.ArgumentParser(description="SMS store-and-forward")
    ap.add_argument("--port", type=int, default=5063)
    ap.add_argument("--relay-host", default="127.0.0.1")
    ap.add_argument("--relay-port", type=int, default=5062)
    ap.add_argument("--savefile", default="savedqueue.txt",
                    help="queue snapshot read at boot / written at "
                         "exit (gConfig 'savefile', smqueue.cpp:2225)")
    args = ap.parse_args()
    sock = UdpTransport(args.port, args.relay_host, args.relay_port)
    registry: dict[str, str] = {}

    smq = SMq(send=lambda to, req: sock.send(req.encode()),
              resolve=lambda u: u if (u in registry or u.isdigit())
              else None,
              local_port=args.port)
    smq.read_queue_from_file(args.savefile)
    log.warning("smqueue listening on %d, queue holds %d msgs",
                args.port, smq.queue_size())
    try:
        while not smq.quit_requested:
            data = sock.recv(4096, timeout_ms=200)
            if data:
                try:
                    msg = SIPMessage.parse(data)
                except Exception:
                    continue
                if msg.is_request and msg.method == "MESSAGE":
                    sock.send(smq.handle_sip_message(msg).render())
                elif msg.is_request and msg.method == "REGISTER":
                    user = msg.uri_user("from") or ""
                    registry[user] = user
                    sock.send(make_response(msg, 200, "OK").render())
                elif not msg.is_request:
                    smq.handle_delivery_response(msg.call_id() or "",
                                                 msg.status)
            smq.process_queue()
    finally:
        # save on the way out, like both exit legs of smqueue's main
        # (smqueue.cpp:2241-2252)
        smq.save_queue_to_file(args.savefile)


if __name__ == "__main__":  # pragma: no cover
    main()
