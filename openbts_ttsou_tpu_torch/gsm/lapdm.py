"""LAPDm data link layer (GSM 04.06), BTS side.

Reference behavior: `GSM/GSML2LAPDm.{h,cpp}` — the five-state machine
{LinkReleased, AwaitingEstablish, AwaitingRelease, LinkEstablished,
ContentionResolution} (GSML2LAPDm.h:175-181), SABM contention resolution
(cpp:511-589), I-frame sequencing with k=1 (cpp:765-798), RR/REJ
supervision (cpp:689-760), T200 retransmission (cpp:423-440), and
multiframe segmentation (cpp:912-980).

Design: the reference runs a service thread blocking on an L1 FIFO with
T200 timeouts. Here the engine is event-driven and deterministic:
`write_low_side(frame)` processes an uplink frame, `write_high_side`
accepts L3 primitives, `tick(now_ms)` fires T200, and downlink frames
are collected from `take_l1_out()` — trivially testable and wrappable
in a thread or asyncio loop.
"""

from __future__ import annotations

import collections
import enum
from typing import Deque, List, Optional

import numpy as np

from openbts_ttsou_tpu_torch.gsm.transfer import (
    ChannelType,
    ControlFormat,
    FrameFormat,
    FrameType,
    L2Address,
    L2Control,
    L2Frame,
    L2Header,
    L2Length,
    L3Frame,
    Primitive,
    S_BITS,
    U_BITS,
    n201,
)


class LAPDState(enum.Enum):
    """Q.921 4.3 subset (GSML2LAPDm.h:175-181)."""

    LinkReleased = 0
    AwaitingEstablish = 1
    AwaitingRelease = 2
    LinkEstablished = 3
    ContentionResolution = 4


class L2LAPDm:
    """One LAPDm entity (one SAP on one channel)."""

    def __init__(self, c: int = 1, sapi: int = 0,
                 chan_type: ChannelType = ChannelType.SDCCH,
                 t200_ms: int = 900, n200: int = 5,
                 master: Optional["L2LAPDm"] = None):
        self.c = c  # command bit: 1 for BTS (GSML2LAPDm.h:196)
        self.r = 1 - c
        self.sapi = sapi
        self.chan_type = chan_type
        self.t200_ms = t200_ms
        self.n200 = n200
        self.master = master
        self.max_i_payload = n201(FrameFormat.B, chan_type)  # octets

        self.state = LAPDState.LinkReleased
        self.vs = 0  # send counter (GSM 04.06 3.5.2.2)
        self.va = 0  # ack counter
        self.vr = 0  # receive counter
        self.rc = 0  # retransmission counter
        # acknowledged downlink progress, never reset (see tx_progress)
        self.acked = 0
        self.establishment_in_progress = False
        self.contention_check = 0
        self.recv_buffer = np.zeros(0, np.uint8)
        self.sent_frame: Optional[L2Frame] = None
        self._t200_deadline: Optional[int] = None
        self._now = 0

        self.l3_out: Deque[L3Frame] = collections.deque()
        self._l1_out: Deque[L2Frame] = collections.deque()
        self._pending_segments: Deque[tuple[np.ndarray, int]] = \
            collections.deque()

    # ------------------------------------------------------------------
    # plumbing
    # ------------------------------------------------------------------
    def take_l1_out(self) -> List[L2Frame]:
        out = list(self._l1_out)
        self._l1_out.clear()
        return out

    def tx_drained(self) -> bool:
        """True when all queued downlink has been delivered and
        acknowledged: no pending segments, no unacked I-frame (k=1
        window closed, GSM 04.06 5.5.2), nothing awaiting L1."""
        return (not self._pending_segments and self.vs == self.va
                and not self._l1_out)

    def tx_depth(self) -> int:
        """Outstanding downlink work: queued segments + the open
        unacked window + frames awaiting L1. It is not a progress
        measure: a T200 retransmission re-enqueues the outstanding
        I-frame, which then counts both in the window and in the L1
        queue until L1 takes it; `tx_progress` counts acknowledged
        progress only."""
        return (len(self._pending_segments)
                + ((self.vs - self.va) % 8) + len(self._l1_out))

    def tx_progress(self) -> int:
        """A counter that moves only when the peer acknowledges: V(A)
        advanced, or a queued segment was taken into the (k=1) window.
        Retransmissions leave it alone, so Control's deferred release
        tells a live-but-slow MS (counter moving) from a vanished one
        (counter frozen)."""
        return self.acked

    def read_high_side(self) -> Optional[L3Frame]:
        return self.l3_out.popleft() if self.l3_out else None

    def _emit(self, frame: L2Frame) -> None:
        self._l1_out.append(frame)

    def _t200_set(self) -> None:
        self._t200_deadline = self._now + self.t200_ms

    def _t200_reset(self) -> None:
        self._t200_deadline = None

    # ------------------------------------------------------------------
    # frame builders (cpp:800-910)
    # ------------------------------------------------------------------
    def _header(self, control: L2Control, length: L2Length,
                cr: Optional[int] = None) -> L2Header:
        return L2Header(FrameFormat.B,
                        L2Address(self.c if cr is None else cr, self.sapi),
                        control, length)

    def _send_s(self, ftype: FrameType, fbit: bool) -> None:
        ctl = L2Control(ControlFormat.S, nr=self.vr, pf=int(fbit),
                        bits=S_BITS[ftype])
        # response frames carry the R bit (sendSFrameRR, cpp:800-812)
        self._emit(L2Frame.from_header(self._header(ctl, L2Length(),
                                                    cr=self.r)))

    def _send_u(self, ftype: FrameType, pf: bool, cr: int,
                l3: Optional[np.ndarray] = None) -> None:
        length = L2Length(0 if l3 is None else len(l3) // 8)
        ctl = L2Control(ControlFormat.U, pf=int(pf), bits=U_BITS[ftype])
        self._emit(L2Frame.from_header(self._header(ctl, length, cr=cr), l3))

    def send_idle(self) -> None:
        """The LAPDm idle frame: UI with L=0 (mIdleFrame)."""
        self._send_u(FrameType.UI, False, self.c)

    # ------------------------------------------------------------------
    # L3 → L2 (writeHighSide, cpp:317-378)
    # ------------------------------------------------------------------
    def write_high_side(self, frame: L3Frame) -> None:
        prim = frame.primitive
        if prim == Primitive.UNIT_DATA:
            self._send_u(FrameType.UI, False, self.c, frame.bits)
        elif prim == Primitive.DATA:
            self._send_multiframe(frame)
        elif prim == Primitive.ESTABLISH:
            # BTS never initiates on SAP0 (GSM 04.06 5.4.1.1)
            if self.state == LAPDState.LinkEstablished:
                return
            self._clear_counters()
            self.state = LAPDState.AwaitingEstablish
            self._send_u(FrameType.SABM, True, self.c)
            self.rc = 0
            self._t200_set()
        elif prim == Primitive.RELEASE:
            if self.state == LAPDState.LinkReleased:
                return
            self._clear_counters()
            self.establishment_in_progress = False
            self.state = LAPDState.AwaitingRelease
            self._t200_set()
            self._send_u(FrameType.DISC, True, self.c)
        elif prim == Primitive.ERROR:
            self._abnormal_release()
        elif prim == Primitive.HARDRELEASE:
            self._clear_state()
        else:
            raise ValueError(prim)

    def _send_multiframe(self, frame: L3Frame) -> None:
        """Segment into I-frames, k=1 (sendMultiframeData,
        cpp:912-958)."""
        bits = frame.bits
        n = self.max_i_payload * 8
        segments = [bits[i : i + n] for i in range(0, max(len(bits), 1), n)]
        for i, seg in enumerate(segments):
            m = 1 if i + 1 < len(segments) else 0
            self._pending_segments.append((seg, m))
        self._pump_i_frames()

    def _pump_i_frames(self) -> None:
        """Send the next I-frame if the window (k=1) is open."""
        if self.state not in (LAPDState.LinkEstablished,
                              LAPDState.ContentionResolution):
            return
        if self.vs != self.va:  # one frame outstanding
            return
        if not self._pending_segments:
            return
        seg, m = self._pending_segments.popleft()
        self.acked += 1
        ctl = L2Control(ControlFormat.I, nr=self.vr, ns=self.vs, pf=0)
        hdr = self._header(ctl, L2Length(len(seg) // 8, m))
        f = L2Frame.from_header(hdr, seg)
        self.vs = (self.vs + 1) % 8
        self.sent_frame = f
        self.rc = 0
        self._t200_set()
        self._emit(f)

    # ------------------------------------------------------------------
    # L1 → L2 (receiveFrame, cpp:453-490)
    # ------------------------------------------------------------------
    def write_low_side(self, frame: L2Frame) -> None:
        if self.master and self.master.state == LAPDState.LinkReleased:
            self.state = LAPDState.LinkReleased
        cf = frame.control_format()
        if cf == ControlFormat.U:
            self._receive_u(frame)
        elif cf == ControlFormat.S:
            self._receive_s(frame)
        else:
            self._receive_i(frame)

    def _receive_u(self, frame: L2Frame) -> None:
        t = frame.u_frame_type()
        if t == FrameType.SABM:
            self._receive_sabm(frame)
        elif t == FrameType.DISC:
            self._receive_disc(frame)
        elif t == FrameType.UA:
            self._receive_ua(frame)
        elif t == FrameType.DM:
            self._receive_dm(frame)
        elif t == FrameType.UI:
            if frame.l() != 0:
                self.l3_out.append(L3Frame(frame.l3_part(),
                                           Primitive.UNIT_DATA))
        # BOGUS ignored (reference logs)

    def _receive_sabm(self, frame: L2Frame) -> None:
        """cpp:511-589."""
        if not frame.pf():
            return
        st = self.state
        if st == LAPDState.LinkReleased:
            self._clear_counters()
            self.establishment_in_progress = True
            self.l3_out.append(L3Frame(primitive=Primitive.ESTABLISH))
            if frame.l():
                self.state = LAPDState.ContentionResolution
                self.contention_check = frame.sum()
                self.l3_out.append(L3Frame(frame.l3_part(), Primitive.DATA))
                self._send_ua_echo(frame)
            else:
                self.state = LAPDState.LinkEstablished
                self._send_u(FrameType.UA, frame.pf(), self.r)
        elif st == LAPDState.ContentionResolution:
            if frame.sum() != self.contention_check:
                return
            self.state = LAPDState.LinkEstablished
            self._send_ua_echo(frame)
        elif st == LAPDState.AwaitingEstablish:
            self._send_u(FrameType.UA, frame.pf(), self.r)
        elif st == LAPDState.AwaitingRelease:
            self._send_u(FrameType.DM, frame.pf(), self.r)
        elif st == LAPDState.LinkEstablished:
            if self.establishment_in_progress:
                if frame.l():
                    self._send_ua_echo(frame)
                else:
                    self._send_u(FrameType.UA, frame.pf(), self.r)
            elif frame.l():
                self._abnormal_release()
            else:
                self._send_u(FrameType.UA, frame.pf(), self.r)
                self._clear_counters()

    def _send_ua_echo(self, frame: L2Frame) -> None:
        """UA echoing the SABM payload for contention resolution
        (sendUFrameUA(frame), cpp:854-869)."""
        self._send_u(FrameType.UA, frame.pf(), self.r, frame.l3_part())

    def _receive_disc(self, frame: L2Frame) -> None:
        self.establishment_in_progress = False
        st = self.state
        if st == LAPDState.AwaitingEstablish:
            self._clear_state()
        elif st == LAPDState.LinkReleased:
            self._send_u(FrameType.DM, frame.pf(), self.r)
            self._clear_state()
        elif st in (LAPDState.ContentionResolution,
                    LAPDState.LinkEstablished):
            self._send_u(FrameType.UA, frame.pf(), self.r)
            self._clear_state()
        elif st == LAPDState.AwaitingRelease:
            self._send_u(FrameType.UA, frame.pf(), self.r)

    def _receive_ua(self, frame: L2Frame) -> None:
        if not frame.pf():
            return
        if self.state == LAPDState.AwaitingEstablish:
            # data queued behind the SABM survives establishment
            pending = list(self._pending_segments)
            self._clear_counters()
            self._pending_segments.extend(pending)
            self.state = LAPDState.LinkEstablished
            self.l3_out.append(L3Frame(primitive=Primitive.ESTABLISH))
            self._pump_i_frames()
        elif self.state == LAPDState.AwaitingRelease:
            self._clear_state()

    def _receive_dm(self, frame: L2Frame) -> None:
        if self.state == LAPDState.LinkReleased:
            return
        if not frame.pf():
            return
        self._clear_state()

    def _receive_s(self, frame: L2Frame) -> None:
        self.establishment_in_progress = False
        t = frame.s_frame_type()
        if t == FrameType.RR:
            self._receive_rr(frame)
        elif t == FrameType.REJ:
            self._receive_rej(frame)

    def _receive_rr(self, frame: L2Frame) -> None:
        if self.state == LAPDState.ContentionResolution:
            self.state = LAPDState.LinkEstablished
        if self.state != LAPDState.LinkEstablished:
            return
        if frame.cr() != self.c and frame.pf():
            self._send_s(FrameType.RR, True)
        self._process_ack(frame.nr())

    def _receive_rej(self, frame: L2Frame) -> None:
        if self.state == LAPDState.ContentionResolution:
            self.state = LAPDState.LinkEstablished
        if self.state != LAPDState.LinkEstablished:
            return
        self._process_ack(frame.nr())
        if frame.pf():
            if frame.cr() != self.c:
                self._send_s(FrameType.RR, True)
        self.send_idle()

    def _receive_i(self, frame: L2Frame) -> None:
        """cpp:765-798."""
        self.establishment_in_progress = False
        if self.state == LAPDState.ContentionResolution:
            self.state = LAPDState.LinkEstablished
        if self.state != LAPDState.LinkEstablished:
            return
        self._process_ack(frame.nr())
        if frame.ns() == self.vr:
            self.vr = (self.vr + 1) % 8
            self._buffer_i_frame(frame)
            self._send_s(FrameType.RR, bool(frame.pf()))
        else:
            self._send_s(FrameType.REJ, bool(frame.pf()))

    def _buffer_i_frame(self, frame: L2Frame) -> None:
        """Segment reassembly (bufferIFrameData, cpp:207-244)."""
        part = frame.l3_part()
        if not frame.m():
            if len(self.recv_buffer) == 0:
                self.l3_out.append(L3Frame(part, Primitive.DATA))
            else:
                whole = np.concatenate([self.recv_buffer, part])
                self.l3_out.append(L3Frame(whole, Primitive.DATA))
                self.recv_buffer = np.zeros(0, np.uint8)
            return
        self.recv_buffer = np.concatenate([self.recv_buffer, part])

    # ------------------------------------------------------------------
    # acks, timers, state resets
    # ------------------------------------------------------------------
    def _process_ack(self, nr: int) -> None:
        """cpp:189-204 + window pump."""
        self.acked += (nr - self.va) % 8
        self.va = nr
        if self.va == self.vs:
            self.rc = 0
            self._t200_reset()
            self.sent_frame = None
        self._pump_i_frames()

    def tick(self, now_ms: int) -> None:
        """Advance time; fire T200 if expired (T200Expiration,
        cpp:423-440)."""
        self._now = now_ms
        if self._t200_deadline is None or now_ms < self._t200_deadline:
            return
        self._t200_reset()
        if self.state == LAPDState.AwaitingRelease:
            self._release_link()
        elif self.state in (LAPDState.ContentionResolution,
                            LAPDState.LinkEstablished,
                            LAPDState.AwaitingEstablish):
            if self.rc > self.n200:
                self._abnormal_release()
            else:
                self._retransmission_procedure()

    def _retransmission_procedure(self) -> None:
        """cpp:273-286: resend the outstanding frame with P=1."""
        self.rc += 1
        if self.state == LAPDState.AwaitingEstablish:
            self._send_u(FrameType.SABM, True, self.c)
        elif self.sent_frame is not None:
            self._emit(self.sent_frame)
        self._t200_set()

    def _release_link(self) -> None:
        """cpp:150-160."""
        if self.state != LAPDState.LinkReleased:
            self.l3_out.append(L3Frame(primitive=Primitive.RELEASE))
        self._clear_state()

    def _abnormal_release(self) -> None:
        """cpp:258-271: DM + ERROR to L3 + full reset."""
        if self.state != LAPDState.LinkReleased:
            self.l3_out.append(L3Frame(primitive=Primitive.ERROR))
        self._send_u(FrameType.DM, True, self.r)
        self._clear_state()

    def _clear_counters(self) -> None:
        self.vs = self.va = self.vr = 0
        self.rc = 0
        self._t200_reset()
        self.recv_buffer = np.zeros(0, np.uint8)
        self._pending_segments.clear()
        self.sent_frame = None

    def _clear_state(self) -> None:
        self._clear_counters()
        self.state = LAPDState.LinkReleased
        self.establishment_in_progress = False


class CCCHL2:
    """Thin downlink-only L2 for CCCH (Bbis format; GSML2LAPDm.h:121,
    cpp:69-79)."""

    def __init__(self):
        self._l1_out: List[L2Frame] = []

    def write_high_side(self, l3: L3Frame) -> None:
        assert l3.primitive == Primitive.UNIT_DATA
        hdr = L2Header(FrameFormat.Bbis,
                       length=L2Length(len(l3.bits) // 8))
        self._l1_out.append(L2Frame.from_header(hdr, l3.bits))

    def take_l1_out(self) -> List[L2Frame]:
        out = self._l1_out
        self._l1_out = []
        return out
