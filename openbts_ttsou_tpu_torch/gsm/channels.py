"""The logical-channel stack: L1 channel objects, SAP mux, logical channels.

Port of `openbts_ttsou_tpu/gsm/channels.py`. Reference behavior:
`GSM/GSML1FEC.{h,cpp}` (the L1Encoder/L1Decoder class
layer pairing FEC with TDMA mappings), `GSM/GSMSAPMux.{h,cpp}` (SAP
multiplexing between one L1 and up to 4 L2s), and
`GSM/GSMLogicalChannel.{h,cpp}` (L1+SAPMux+LAPDm bundles with blocking
L3 send/recv).

Design: the heavy math lives in the batched `gsm.l1fec` codecs; these
host objects add burst pacing (TDMA mappings), interleaver block
assembly, and routing. They are event-driven (no threads): the BTS loop
feeds uplink RxBursts in and drains downlink TxBursts out.

Every L1 channel runs its FEC on one torch device (`device`, "cuda"
unless the caller names another; no fallback to the CPU). Per-channel
state stays on the host (tx deques, the XCCH burst slots, the TCH
diagonals); each FEC call below copies its input to the device, runs the
port's codec there, and brings its result back, with the decision flag
packed beside it, in one `.cpu()`: one host sync per call, the point
where the reference's decoder reads its CRC verdict. Constant tables
(interleave maps, TSCs) are copied to each device once
(`utils/tables.py`).
"""

from __future__ import annotations

import collections
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from openbts_ttsou_tpu_torch.gsm import fec, gsm610, l1fec, tdma
from openbts_ttsou_tpu_torch.gsm.lapdm import L2LAPDm
from openbts_ttsou_tpu_torch.gsm.transfer import (
    ChannelType,
    L2Frame,
    L3Frame,
    RxBurst,
    TxBurst,
)
from openbts_ttsou_tpu_torch.trx.engine import resolve_device
from openbts_ttsou_tpu_torch.utils.gsm_time import HYPERFRAME, Time, fn_delta


# ---------------------------------------------------------------------------
# FEC calls on the channel's device: numpy in, numpy out, one .cpu() each
# ---------------------------------------------------------------------------

def _on(x: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _lsb8msb(bits) -> np.ndarray:
    """`l1fec.lsb8msb` on the host: the bit order within each full byte
    reversed, a trailing partial byte left alone (BitVector::LSB8MSB)."""
    bits = np.asarray(bits, np.uint8)
    n8 = 8 * (len(bits) // 8)
    return np.concatenate([bits[:n8].reshape(-1, 8)[:, ::-1].reshape(-1),
                           bits[n8:]])


def xcch_encode_bursts(bits: np.ndarray, tsc: Optional[int],
                       device: torch.device) -> np.ndarray:
    """184 L1 bits (air order) → 4 bursts [4, 148] uint8."""
    return l1fec.xcch_encode(_on(bits, device)[None], tsc=tsc)[0].cpu().numpy()


def xcch_decode_block(block: np.ndarray, device: torch.device
                      ) -> Tuple[bool, np.ndarray]:
    """4 soft bursts [4, 148] → (ok, 184 L1 bits in air order)."""
    frames, ok = l1fec.xcch_decode(_on(block, device)[None])
    out = torch.cat([frames[0], ok.to(torch.uint8)]).cpu().numpy()
    return bool(out[184]), out[:184]


def rach_decode_bits(e: np.ndarray, bsic: int, device: torch.device
                     ) -> Tuple[bool, int]:
    """36 soft RACH bits → (ok, RA)."""
    ra, ok = l1fec.rach_decode(_on(e, device)[None], bsic)
    out = torch.stack([ra[0], ok[0].to(ra.dtype)]).cpu().numpy()
    return bool(out[1]), int(out[0])


def sch_encode_burst(bsic: int, t1: int, t2: int, t3p: int,
                     device: torch.device) -> np.ndarray:
    """The SCH burst [148] uint8 for one frame's (T1, T2, T3')."""
    v = torch.tensor([bsic, t1, t2, t3p], dtype=torch.int32, device=device)
    return l1fec.sch_encode(v[0], v[1], v[2], v[3]).cpu().numpy()


def facch_encode(bits: np.ndarray, device: torch.device) -> np.ndarray:
    """184 L1 bits (air order) → 456 coded bits: FIRE parity, four tail
    zeros, the convolutional code (the XCCH chain FACCH shares)."""
    return l1fec._facch_coded(_on(bits, device)[None])[0].cpu().numpy()


def tch_encode_block(d: np.ndarray, device: torch.device) -> np.ndarray:
    """260 coder-order vocoder bits → 456 coded bits."""
    return l1fec.tch_encode(_on(d, device)[None])[0].cpu().numpy()


def map_bursts(halves: np.ndarray, stealing: Tuple[int, int],
               tsc: Optional[int], device: torch.device) -> np.ndarray:
    """Interleaved rows [n, 114] → normal bursts [n, 148] uint8."""
    return fec.map_to_burst(_on(halves, device), stealing=stealing,
                            tsc=tsc).cpu().numpy()


def _tch_deinterleave(iframe: np.ndarray, offset: int,
                      device: torch.device) -> torch.Tensor:
    """The TCH diagonal [8, 114] → 456 soft coded bits [1, 456]."""
    return fec.deinterleave(_on(iframe, device)[None], fec.interleave_map_on(
        fec.tch_interleave_map, device, offset))


def facch_decode_frame(iframe: np.ndarray, offset: int,
                       device: torch.device) -> Tuple[bool, np.ndarray]:
    """The TCH diagonal [8, 114] read as a FACCH frame → (ok, 184 L1
    bits in air order)."""
    frames, ok = l1fec.xcch_decode_coded(_tch_deinterleave(iframe, offset,
                                                          device))
    out = torch.cat([frames[0], ok.to(torch.uint8)]).cpu().numpy()
    return bool(out[184]), out[:184]


def tch_decode_frame(iframe: np.ndarray, offset: int,
                     device: torch.device) -> Tuple[bool, np.ndarray]:
    """The TCH diagonal [8, 114] read as speech → (good, 260 coder-order
    vocoder bits)."""
    d, good = l1fec.tch_decode(_tch_deinterleave(iframe, offset, device))
    out = torch.cat([d[0], good.to(torch.uint8)]).cpu().numpy()
    return bool(out[260]), out[:260]


class SAPMux:
    """Routes L2 frames between one L1 and per-SAP L2 entities
    (GSM/GSMSAPMux.h:47-71)."""

    def __init__(self):
        self._l2: Dict[int, L2LAPDm] = {}
        self._downstream: Optional["XCCHL1"] = None

    def attach_l2(self, l2: L2LAPDm, sapi: int) -> None:
        self._l2[sapi] = l2

    def attach_l1(self, l1: "XCCHL1") -> None:
        self._downstream = l1
        l1.upstream = self

    def write_low_side(self, frame: L2Frame) -> None:
        """L1 → correct SAP's L2 (SAPMux::writeLowSide)."""
        sapi = frame.sapi()
        l2 = self._l2.get(sapi)
        if l2 is not None:
            l2.write_low_side(frame)

    def write_high_side(self, frame: L2Frame) -> None:
        """L2 → L1 (SAPMux::writeHighSide)."""
        assert self._downstream is not None
        self._downstream.send_l2(frame)


class L1Channel:
    """Shared L1 plumbing: TDMA pacing + physical-parameter tracking
    (L1Encoder/L1Decoder base, GSML1FEC.h:81-343)."""

    def __init__(self, tn: int, downlink: tdma.TDMAMapping,
                 uplink: tdma.TDMAMapping, device="cuda"):
        self.tn = tn
        self.device = resolve_device(device)
        self.downlink = downlink
        self.uplink = uplink
        self.tx_queue: Deque[TxBurst] = collections.deque()
        self.next_write_fn = 0
        self.active = False
        self.clock = None  # optional callable → current FN (gBTS.time)
        # uplink physical measurements (L1Decoder::setPhy)
        self.rssi_sum = 0.0
        self.timing_sum = 0.0
        self.phy_count = 0
        self.good_frames = 0
        self.bad_frames = 0
        self.opened_at_s = 0.0
        self.last_good_s = 0.0

    def open(self, fn: int = 0) -> None:
        import time as _time

        self.active = True
        self.next_write_fn = fn
        self.opened_at_s = _time.monotonic()
        self.last_good_s = self.opened_at_s

    def close(self) -> None:
        self.active = False
        self.tx_queue.clear()

    def fer(self) -> float:
        total = self.good_frames + self.bad_frames
        return self.bad_frames / total if total else 0.0

    def recyclable(self, now_s: float, t3101_s: float = 4.0,
                   t3109_s: float = 30.0) -> bool:
        """True when the channel should be reclaimed: never used after
        open (T3101) or uplink lost (T3109) — the decoder "recyclable"
        timeouts of GSML1FEC.cpp:365-372 / TCH uplinkLost."""
        if not self.active:
            return False
        if self.good_frames == 0:
            return now_s - self.opened_at_s > t3101_s
        return now_s - self.last_good_s > t3109_s

    def record_phy(self, rssi: float, timing: float) -> None:
        import time as _time

        self.rssi_sum += rssi
        self.timing_sum += timing
        self.phy_count += 1
        self.last_good_s = _time.monotonic()

    def _align_block_start(self, fn: int, modulus: int = 4) -> int:
        """Advance fn to the next mapped frame whose burst index is a
        multiple of `modulus`: interleaved blocks must start on a block
        boundary or the receiver deinterleaves across two blocks
        (L1Encoder::rollForward keeps mNextWriteTime on the mapping,
        GSML1FEC.cpp:205)."""
        fn = self.downlink.next_write_time(fn)
        guard = 0
        while (self.downlink.reverse(fn) or 0) % modulus != 0:
            fn = self.downlink.next_write_time(fn + 1)
            guard += 1
            if guard > 128:  # malformed mapping; fail open
                break
        return fn

    def _schedule(self, bursts: np.ndarray, fn: int) -> int:
        """Queue 148-bit bursts at consecutive mapped frame numbers
        (rollForward, GSML1FEC.cpp:205; resync against the BTS clock
        like L1Encoder::resync before transmitting)."""
        if self.clock is not None:
            now = self.clock()
            if fn_delta(fn, now + 3) < 0:
                fn = self._align_block_start((now + 3) % HYPERFRAME)
        for b in np.atleast_2d(bursts):
            fn = self.downlink.next_write_time(fn)
            self.tx_queue.append(TxBurst(np.asarray(b, np.uint8), fn,
                                         self.tn))
            fn += 1
        return fn

    def resync(self, fn_now: int, lead: int = 3) -> None:
        """Jump the write pointer forward if it lags the clock
        (L1Encoder::resync, GSML1FEC.cpp: mNextWriteTime vs gBTS.time).
        Without this, bursts scheduled after an idle period land in the
        past and are dropped as stale."""
        if fn_delta(self.next_write_fn, fn_now + lead) < 0:
            self.next_write_fn = self._align_block_start(
                (fn_now + lead) % HYPERFRAME)

    def pop_due(self, fn: int) -> Optional[TxBurst]:
        """The burst scheduled for frame fn, if any."""
        while self.tx_queue and (self.tx_queue[0].fn - fn) % HYPERFRAME > \
                HYPERFRAME // 2:
            self.tx_queue.popleft()  # stale
        if self.tx_queue and self.tx_queue[0].fn == fn:
            return self.tx_queue.popleft()
        return None


class XCCHL1(L1Channel):
    """SDCCH/SACCH/FACCH-style 4-burst XCCH channel
    (XCCHL1Encoder/Decoder, GSML1FEC.cpp:530-860)."""

    def __init__(self, tn: int, downlink: tdma.TDMAMapping,
                 uplink: tdma.TDMAMapping, tsc: int | None = None,
                 device="cuda"):
        super().__init__(tn, downlink, uplink, device)
        self.tsc = tsc  # TSC hardcoded to the BCC (GSML1FEC.cpp:726)
        self.upstream: Optional[SAPMux] = None
        self._rx_bursts: List[Optional[np.ndarray]] = [None] * 4

    # -- downlink ------------------------------------------------------
    def send_l2(self, frame: L2Frame) -> None:
        """L2 frame → FEC → 4 bursts queued (sendFrame + transmit)."""
        bits = _lsb8msb(frame.bits)
        bursts = xcch_encode_bursts(bits, self.tsc, self.device)  # [4, 148]
        self.next_write_fn = self._schedule(bursts, self.next_write_fn)

    # -- uplink --------------------------------------------------------
    def write_low_side(self, burst: RxBurst) -> None:
        """Accumulate the 4-burst block, decode, deliver
        (processBurst/deinterleave/decode, GSML1FEC.cpp:550-660)."""
        if not self.active:
            return
        b = self.uplink.reverse(burst.fn)
        if b is None:
            return
        b %= 4
        self._rx_bursts[b] = np.asarray(burst.soft, np.float32)
        self.record_phy(burst.rssi, burst.timing_error)
        if b != 3:
            return
        block = np.stack([
            x if x is not None else np.full(148, 0.5, np.float32)
            for x in self._rx_bursts])
        self._rx_bursts = [None] * 4
        ok, u = xcch_decode_block(block, self.device)
        if not ok:
            self.bad_frames += 1
            return
        self.good_frames += 1
        bits = _lsb8msb(u)
        from openbts_ttsou_tpu_torch.utils import gsmtap

        if gsmtap.gGSMTAP is not None:
            # the reference's tap point (gWriteGSMTAP, GSML1FEC.cpp:790)
            gsmtap.gGSMTAP.write_l2_frame(
                bits, tn=self.tn, fn=burst.fn,
                chan_type=gsmtap.CHANNEL_SDCCH, uplink=True,
                rssi_db=int(burst.rssi),
                sub_slot=getattr(self, "subchannel", 0))
        if self.upstream is not None:
            self.upstream.write_low_side(L2Frame(bits))


class SACCHL1(XCCHL1):
    """SACCH: XCCH FEC plus the 16-bit L1 header carrying power control
    and timing advance (SACCHL1Encoder/Decoder, GSML1FEC.h:576-990,
    GSML1FEC.cpp:685-695,1485-1492). The L2 payload is 168 bits."""

    def __init__(self, tn: int, downlink: tdma.TDMAMapping,
                 uplink: tdma.TDMAMapping, tsc: int | None = None,
                 device="cuda"):
        super().__init__(tn, downlink, uplink, tsc, device)
        self.ordered_ms_power = 33  # dBm ordered via the L1 header
        self.ordered_ms_timing = 0
        self.actual_ms_power = 40  # reported by the MS (cpp:1419)
        self.actual_ms_timing = 0

    @staticmethod
    def _encode_power(dbm: int) -> int:
        """GSM 05.05 4.1.1 power-control level for GSM900
        (encodePower)."""
        return max(0, min(31, (39 - dbm) // 2))

    @staticmethod
    def _decode_power(level: int) -> int:
        return 39 - 2 * level

    def send_l2(self, frame: L2Frame) -> None:
        """Prepend the L1 header (u[0:8]=power, u[8:16]=TA,
        GSML1FEC.cpp:1488-1489) before the 168-bit L2 payload."""
        header = np.zeros(16, np.uint8)
        pw = self._encode_power(self.ordered_ms_power)
        ta = int(self.ordered_ms_timing + 0.5)
        for i in range(8):
            header[i] = (pw >> (7 - i)) & 1
            header[8 + i] = (ta >> (7 - i)) & 1
        payload = _lsb8msb(frame.bits)[:168]
        bits = np.concatenate([header, payload])
        bursts = xcch_encode_bursts(bits, self.tsc, self.device)
        self.next_write_fn = self._schedule(bursts, self.next_write_fn)

    def write_low_side(self, burst: RxBurst) -> None:
        if not self.active:
            return
        b = self.uplink.reverse(burst.fn)
        if b is None:
            return
        b %= 4
        self._rx_bursts[b] = np.asarray(burst.soft, np.float32)
        self.record_phy(burst.rssi, burst.timing_error)
        if b != 3:
            return
        block = np.stack([
            x if x is not None else np.full(148, 0.5, np.float32)
            for x in self._rx_bursts])
        self._rx_bursts = [None] * 4
        ok, u = xcch_decode_block(block, self.device)
        if not ok:
            self.bad_frames += 1
            return
        self.good_frames += 1
        # L1 header: power at u[3:8] (5 bits), TA at u[9:16]
        # (SACCHL1Decoder, GSML1FEC.cpp:691-694)
        pw = int("".join(map(str, u[3:8])), 2)
        self.actual_ms_power = self._decode_power(pw)
        ta = int("".join(map(str, u[9:16])), 2)
        if ta < 64:
            self.actual_ms_timing = ta
        payload = _lsb8msb(u[16:184])
        if self.upstream is not None:
            self.upstream.write_low_side(L2Frame(payload))


class CCCHL1(XCCHL1):
    """Downlink-only CCCH (AGCH/PCH): same FEC, unit-data only
    (CCCHL1Encoder; GSML1FEC.h NDCCH variants)."""

    def write_low_side(self, burst: RxBurst) -> None:  # pragma: no cover
        pass


class RACHL1(L1Channel):
    """RACH decoder channel (RACHL1Decoder, GSML1FEC.cpp:440-513)."""

    def __init__(self, tn: int, bsic: int,
                 handler: Callable[[int, Time, float, float], None],
                 mapping: tdma.TDMAMapping = tdma.RACH_C5, device="cuda"):
        super().__init__(tn, mapping, mapping, device)
        self.bsic = bsic
        self.handler = handler

    def write_low_side(self, burst: RxBurst) -> None:
        soft = np.asarray(burst.soft, np.float32)
        e = soft[l1fec.RACH_DATA_START : l1fec.RACH_DATA_START + 36]
        ok, ra = rach_decode_bits(e, self.bsic, self.device)
        if ok:
            self.good_frames += 1
            self.handler(ra, Time(burst.fn, burst.tn),
                         burst.rssi, burst.timing_error)
        else:
            self.bad_frames += 1


class SCHL1(L1Channel):
    """SCH beacon encoder (SCHL1Encoder, GSML1FEC.cpp:880-925)."""

    def __init__(self, bsic: int, device="cuda"):
        super().__init__(0, tdma.SCH, tdma.SCH, device)
        self.bsic = bsic

    def generate(self, fn: int) -> Optional[TxBurst]:
        if self.downlink.reverse(fn) is None:
            return None
        t1 = (fn // 1326) % 2048
        t2 = fn % 26
        t3p = ((fn % 51) - 1) // 10
        burst = sch_encode_burst(self.bsic, t1, t2, t3p, self.device)
        return TxBurst(burst, fn, 0)


class FCCHL1(L1Channel):
    """FCCH: all-zero bursts = pure tone (FCCHL1Encoder,
    GSML1FEC.cpp:927-950)."""

    def __init__(self, device="cuda"):
        super().__init__(0, tdma.FCCH, tdma.FCCH, device)

    def generate(self, fn: int) -> Optional[TxBurst]:
        if self.downlink.reverse(fn) is None:
            return None
        return TxBurst(np.zeros(148, np.uint8), fn, 0)


class TCHFACCHL1(XCCHL1):
    """TCH/FS + FACCH with 8-burst diagonal interleaving and stealing
    flags (TCHFACCHL1Encoder/Decoder, GSML1FEC.cpp:998-1405)."""

    def __init__(self, tn: int, downlink: tdma.TDMAMapping,
                 uplink: tdma.TDMAMapping, tsc: int | None = None,
                 device="cuda"):
        super().__init__(tn, downlink, uplink, tsc, device)
        self.speech_out: Deque[np.ndarray] = collections.deque()  # rx voice
        self.speech_in: Deque[np.ndarray] = collections.deque()  # tx voice
        self._facch_q: Deque[L2Frame] = collections.deque()
        self._offset = 0  # interleaver half-phase (mOffset)
        self._prev_facch = False
        self._iframe = np.full((8, 114), 0.5, np.float32)  # rx diagonal
        self._itx = np.zeros(8 * 114, np.uint8)  # tx diagonal (mI)

    # -- downlink ------------------------------------------------------
    def resync(self, fn_now: int, lead: int = 3) -> None:
        """TCH blocks ride an 8-burst diagonal: align the write pointer
        to an 8-burst boundary and restart the interleaver phase when
        jumping (encoder mOffset/mI reset, GSML1FEC.cpp TCH encoder)."""
        if fn_delta(self.next_write_fn, fn_now + lead) < 0:
            self.next_write_fn = self._align_block_start(
                (fn_now + lead) % HYPERFRAME, modulus=8)
            self._offset = 0
            self._itx[:] = 0
            self._prev_facch = False

    def send_l2(self, frame: L2Frame) -> None:
        """FACCH frame: steal the next TCH block (sendFrame →
        dispatch, GSML1FEC.cpp:1310-1376)."""
        self._facch_q.append(frame)

    def send_tch(self, vocoder_payload: np.ndarray) -> None:
        """Queue one 260-bit GSM 06.10 frame (payload bit order)."""
        self.speech_in.append(np.asarray(vocoder_payload, np.uint8))

    def dispatch_block(self) -> None:
        """Encode the next 4-burst half-block: FACCH > TCH > filler."""
        current_facch = False
        if self._facch_q:
            frame = self._facch_q.popleft()
            current_facch = True
            c = facch_encode(_lsb8msb(frame.bits), self.device)
        elif self.speech_in:
            payload = self.speech_in.popleft()
            d = gsm610.payload_to_coder(payload)
            c = tch_encode_block(d, self.device)
        else:
            c = np.zeros(456, np.uint8)  # silence filler block
        # Scatter into the persistent diagonal buffer: each block fills
        # half of 8 bursts; the other half carries the previous block
        # (GSM 05.03 3.1.3; encoder mI[], GSML1FEC.cpp:1380-1393).
        self._itx[fec.tch_interleave_map(self._offset)] = c
        i = self._itx.reshape(8, 114)
        bursts = map_bursts(i[self._offset: self._offset + 4],
                            (int(self._prev_facch), int(current_facch)),
                            self.tsc, self.device)
        fn = self.next_write_fn
        for burst in bursts:
            fn = self.downlink.next_write_time(fn)
            self.tx_queue.append(TxBurst(burst, fn, self.tn))
            fn += 1
        self.next_write_fn = fn
        self._offset = 4 - self._offset
        self._prev_facch = current_facch

    # -- uplink --------------------------------------------------------
    def write_low_side(self, burst: RxBurst) -> None:
        """8-burst diagonal accumulation (processBurst,
        GSML1FEC.cpp:1031-1100)."""
        if not self.active:
            return
        b = self.uplink.reverse(burst.fn)
        if b is None:
            return
        b %= 8
        soft = np.asarray(burst.soft, np.float32)
        self._iframe[b, :57] = soft[3:60]
        self._iframe[b, 57:] = soft[88:145]
        self.record_phy(burst.rssi, burst.timing_error)
        if b % 4 != 3:
            return
        offset = 4 if b == 3 else 0
        stolen = soft[60] > 0.5  # Hl stealing flag
        if stolen:
            ok, u = facch_decode_frame(self._iframe, offset, self.device)
            if ok:
                self.good_frames += 1
                bits = _lsb8msb(u)
                if self.upstream is not None:
                    self.upstream.write_low_side(L2Frame(bits))
            else:
                self.bad_frames += 1
        else:
            good, d = tch_decode_frame(self._iframe, offset, self.device)
            if good:
                self.good_frames += 1
                payload = gsm610.coder_to_payload(d)
                self.speech_out.append(payload)
            else:
                self.bad_frames += 1


class LogicalChannel:
    """L1 + SAPMux + LAPDm bundle, with an optional associated SACCH
    (GSMLogicalChannel.h:65-137; SDCCHLogicalChannel carries its SACCH,
    GSMLogicalChannel.h:249+)."""

    is_tch = False

    def __init__(self, l1: XCCHL1, sapis=(0,),
                 chan_type: ChannelType = ChannelType.SDCCH,
                 sacch: "SACCHL1 | None" = None):
        self.l1 = l1
        self.sacch = sacch
        self._tick_base = None
        self._tick_fn_last = None
        self._tick_ms = 0.0
        self.mux = SAPMux()
        self.mux.attach_l1(l1)
        self.l2: Dict[int, L2LAPDm] = {}
        master = None
        for sapi in sapis:
            l2 = L2LAPDm(c=1, sapi=sapi, chan_type=chan_type, master=master)
            if master is None:
                master = l2
            self.l2[sapi] = l2
            self.mux.attach_l2(l2, sapi)
        if sacch is not None:
            # SACCH carries its own LAPDm (measurement reports arrive as
            # UI frames on SAP 0)
            self.sacch_l2 = L2LAPDm(c=1, sapi=0,
                                    chan_type=ChannelType.SACCH)
            mux = SAPMux()
            mux.attach_l1(sacch)
            mux.attach_l2(self.sacch_l2, 0)
            self.sacch_mux = mux

    def open(self, fn: int = 0) -> None:
        self.l1.open(fn)
        if self.sacch is not None:
            self.sacch.open(fn)

    def close(self) -> None:
        """Deactivate L1 (+SACCH) — LogicalChannel::close-equivalent;
        Control's _finish_call closes the TCH through this."""
        self.l1.close()
        if self.sacch is not None:
            self.sacch.close()

    def tx_drained(self) -> bool:
        """True when every LAPDm entity has delivered its queued
        downlink (Control's deferred hard release waits on this — the
        reference's sequential sends guarantee delivery before the
        channel drops, LogicalChannel::send blocking semantics)."""
        return all(l2.tx_drained() for l2 in self.l2.values())

    def tx_depth(self) -> int:
        """Total outstanding downlink across SAPs (see
        L2LAPDm.tx_depth)."""
        return sum(l2.tx_depth() for l2 in self.l2.values())

    def tx_progress(self) -> int:
        """Acknowledged downlink progress across SAPs, a counter that
        only grows (see L2LAPDm.tx_progress)."""
        return sum(l2.tx_progress() for l2 in self.l2.values())

    def reset(self) -> None:
        """Hard-release all LAPDm entities (the HARDRELEASE primitive,
        GSMTransfer.h:72) so the channel can be reallocated cleanly."""
        for l2 in self.l2.values():
            l2._clear_state()
        if self.sacch is not None:
            self.sacch_l2._clear_state()

    def recv_sacch(self):
        """Next measurement-report-style L3 frame from the SACCH."""
        if self.sacch is None:
            return None
        return self.sacch_l2.read_high_side()

    def send_sacch(self, l3: L3Frame, fill: bool = False) -> None:
        """Downlink SACCH frame (SI5/SI6 fill or dedicated signaling).

        The reference's SACCHL1Encoder decides fill-vs-data only at
        dispatch time, so real data never queues behind filler.  Here
        fill blocks may be pre-queued by the app loop; to preserve the
        reference's latency, a fill block that has not started
        transmitting is preempted (removed and its slot re-used) when
        real L3 data arrives."""
        if self.sacch is None:
            return
        sa = self.sacch
        mark = getattr(sa, "_fill_mark", None)
        if not fill and mark is not None:
            prev_len, prev_fn, post_len = mark
            if len(sa.tx_queue) == post_len:  # fill untouched: preempt
                for _ in range(post_len - prev_len):
                    sa.tx_queue.pop()
                sa.next_write_fn = prev_fn
            sa._fill_mark = None
        prev = (len(sa.tx_queue), sa.next_write_fn)
        self.sacch_l2.write_high_side(l3)
        for frame in self.sacch_l2.take_l1_out():
            self.sacch_mux.write_high_side(frame)
        if fill:
            sa._fill_mark = (prev[0], prev[1], len(sa.tx_queue))

    def send(self, l3: L3Frame, sapi: int = 0) -> None:
        """L3 → LAPDm → L1 (LogicalChannel::send)."""
        self.l2[sapi].write_high_side(l3)
        self.pump()

    def recv(self, sapi: int = 0) -> Optional[L3Frame]:
        return self.l2[sapi].read_high_side()

    def pump(self) -> None:
        """Move any queued L2 frames down into L1, driving T200 so lost
        frames retransmit (the reference's per-channel T200Expiration
        thread). Time comes from the BTS frame clock when attached —
        GSM link timers must follow air-interface time — with a
        wall-clock fallback for clockless fixtures."""
        import time as _time

        if self.l1.clock is not None:
            fn = self.l1.clock()
            if self._tick_fn_last is None:
                self._tick_fn_last = fn
            d = fn_delta(fn, self._tick_fn_last)
            if d > 0:
                self._tick_ms += d * 60.0 / 13.0  # 4.615 ms per frame
                self._tick_fn_last = fn
            now_ms = int(self._tick_ms)
        else:
            if self._tick_base is None:
                self._tick_base = _time.monotonic()
            now_ms = int((_time.monotonic() - self._tick_base) * 1000)
        for l2 in self.l2.values():
            if hasattr(l2, "tick"):
                l2.tick(now_ms)
            for frame in l2.take_l1_out():
                self.mux.write_high_side(frame)

    def write_low_side(self, burst: RxBurst) -> None:
        self.l1.write_low_side(burst)
        self.pump()  # any responses (RR/UA…) head straight down


class TCHFACCHLogicalChannel(LogicalChannel):
    """TCH/F traffic channel with its FACCH signalling link
    (TCHFACCHLogicalChannel, GSMLogicalChannel.h:411-455): LAPDm rides
    the FACCH stealing path of the shared `TCHFACCHL1`; `send_tch` /
    `recv_tch` move GSM 06.10 vocoder frames (sendTCH/recvTCH)."""

    is_tch = True

    def __init__(self, l1: TCHFACCHL1, sacch: "SACCHL1 | None" = None):
        super().__init__(l1, sapis=(0,), chan_type=ChannelType.FACCH,
                         sacch=sacch)

    @property
    def tn(self) -> int:
        return self.l1.tn

    def send_tch(self, vocoder_payload: np.ndarray) -> None:
        self.l1.send_tch(vocoder_payload)

    def recv_tch(self):
        return (self.l1.speech_out.popleft()
                if self.l1.speech_out else None)
