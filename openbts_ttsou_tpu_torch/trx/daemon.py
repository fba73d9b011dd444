"""The transceiver daemon: the `runTransceiver` equivalent.

Port of `openbts_ttsou_tpu/trx/daemon.py`. Binds the three UDP planes
(clock = base, control = base+1, data = base+2; peer at base+100+i —
Transceiver52M/Transceiver.cpp:42-44, runTransceiver.cpp:68-74), drives
the radio through the engine on a torch device, and speaks the
reference's wire protocol so an unmodified BTS stack (TRXManager) can
control it:

    python -m openbts_ttsou_tpu_torch.trx.daemon --base-port 5700

runs on `cuda` unless given `--device cpu`.

Where the reference runs one transceiver process per ARFCN, this daemon
batches N carriers through one engine while exposing the per-ARFCN
control/data port triples (base + 3·i + {1,2}) that `TRXManager`
expects. `TrxDaemon` steps one GSM frame at a time through
`rx_step`/`tx_step`; `BlockTrxDaemon` runs one streaming duplex block
(`models.transceiver.duplex_block_compact`) per 13-frame window.

Control verbs that write engine state (SETTSC, SETSLOT, SETMAXDELAY)
replace the written tensor with an updated copy: a block already queued
on the device keeps reading the state it was dispatched with.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from openbts_ttsou_tpu_torch.models import transceiver as trx_model
from openbts_ttsou_tpu_torch.runtime import BurstQueue, UdpTransport
from openbts_ttsou_tpu_torch.trx import engine as eng
from openbts_ttsou_tpu_torch.trx import protocol as proto
from openbts_ttsou_tpu_torch.trx.radio import Radio
from openbts_ttsou_tpu_torch.utils.gsm_time import (FRAME_SYMBOLS,
                                                    HYPERFRAME,
                                                    SLOT_SAMPLE_PATTERN)
from openbts_ttsou_tpu_torch.utils.profiling import span

SLOT_OFFSETS = np.concatenate([[0], np.cumsum(SLOT_SAMPLE_PATTERN)])[:-1]


@dataclasses.dataclass
class TrxDaemonConfig:
    base_port: int = 5700
    peer_host: str = "127.0.0.1"
    peer_port_offset: int = 100  # BTS listens at base+100+i
    sps: int = 1
    n_arfcn: int = 1
    start_fn: int = 0
    tx_latency_frames: int = 2  # initial latency (runTransceiver.cpp:71)
    #: static TSC correlation window in samples (the 52M 2·maxTOA+1-lag
    #: restriction, Transceiver52M/sigProcLib.cpp:983-1000); None = the
    #: full ±10-symbol segment. SETMAXDELAY values at or below this
    #: still apply per carrier.
    max_toa: int | None = None
    #: static tuple of timeslots that can carry RACH (combination
    #: IV/V/VI slots in the channel plan); None = all 8
    rach_slots: tuple | None = None
    #: torch device the engine runs on; "cuda" raises without a GPU
    device: str = "cuda"


class TrxDaemon:
    """N-ARFCN transceiver daemon over a pluggable radio (one radio per
    carrier, or one vectorized `BankRadio` for all of them)."""

    def __init__(self, radio, cfg: TrxDaemonConfig = TrxDaemonConfig()):
        self.cfg = cfg
        self.device = eng.resolve_device(cfg.device)
        if hasattr(radio, "read_bank"):
            self.bank = radio
            self.radios: List[Radio] = [radio] * cfg.n_arfcn
        else:
            self.bank = None
            self.radios = radio if isinstance(radio, list) else [radio]
            assert len(self.radios) == cfg.n_arfcn
        base, peer = cfg.base_port, cfg.base_port + cfg.peer_port_offset
        self.clock_sock = UdpTransport(base, cfg.peer_host, peer)
        self.ctrl_socks = [
            UdpTransport(base + 3 * i + 1, cfg.peer_host, peer + 3 * i + 1)
            for i in range(cfg.n_arfcn)]
        self.data_socks = [
            UdpTransport(base + 3 * i + 2, cfg.peer_host, peer + 3 * i + 2)
            for i in range(cfg.n_arfcn)]
        self.engine_cfg = eng.TrxConfig(n_chan=cfg.n_arfcn, sps=cfg.sps,
                                        max_toa=cfg.max_toa,
                                        rach_slots=cfg.rach_slots)
        self.state = eng.init_state(self.engine_cfg, self.device)
        self.carrier_on = [False] * cfg.n_arfcn
        self.tx_freq = [0.0] * cfg.n_arfcn
        self.rx_freq = [0.0] * cfg.n_arfcn
        self.power = [-10] * cfg.n_arfcn
        self.fn = cfg.start_fn  # receive-side frame clock
        self.tx_fn = cfg.start_fn + cfg.tx_latency_frames
        self.underruns = 0
        self.stale_dumped = 0  # bursts dropped past their deadline
        self.clock_lead = proto.CLOCK_LEAD_FRAMES
        self.last_clock_fn: Optional[int] = None
        # native priority queue of pending downlink bursts keyed by
        # (fn, carrier, tn) — the reference's VectorQueue
        # (radioInterface.cpp:30-73)
        self.pending_tx = BurstQueue()

    @property
    def on(self) -> bool:
        return any(self.carrier_on)

    def _set_state(self, field: str, index, value: int) -> None:
        """Functional update of one element of a state tensor."""
        t = getattr(self.state, field).clone()
        t[index] = value
        self.state = self.state._replace(**{field: t})

    # ------------------------------------------------------------------
    # control plane (driveControl, Transceiver.cpp:423-569)
    # ------------------------------------------------------------------
    def handle_control(self, data: bytes, carrier: int = 0) -> bytes | None:
        try:
            kind, verb, args = proto.parse_message(data)
        except ValueError:
            return None
        if kind != "CMD":
            return None
        self._send_clock()
        try:
            return self._dispatch_command(verb, args, carrier)
        except (ValueError, IndexError, TypeError):
            # malformed arguments: NAK like the reference's bogus-
            # command path (driveControl, Transceiver.cpp:423-569)
            return proto.pack_response(verb, 1)

    def _dispatch_command(self, verb: str, args, carrier: int
                          ) -> bytes | None:
        ok = 0
        extra: tuple = ()
        if verb == "POWEROFF":
            self.carrier_on[carrier] = False
        elif verb == "POWERON":
            if not self.tx_freq[carrier] or not self.rx_freq[carrier]:
                ok = 1
            elif not self.carrier_on[carrier]:
                self.radios[carrier].start()
                self.carrier_on[carrier] = True
        elif verb == "RXTUNE":
            self.rx_freq[carrier] = float(args[0]) * 1e3
            ok = 0 if self.radios[carrier].set_rx_freq(
                self.rx_freq[carrier]) else 1
            extra = (args[0],)
        elif verb == "TXTUNE":
            self.tx_freq[carrier] = float(args[0]) * 1e3
            ok = 0 if self.radios[carrier].set_tx_freq(
                self.tx_freq[carrier]) else 1
            extra = (args[0],)
        elif verb == "SETTSC":
            tsc = int(args[0])
            if 0 <= tsc <= 7:
                self._set_state("tsc", carrier, tsc)
            else:
                ok = 1
            extra = (tsc,)
        elif verb == "SETSLOT":
            tn, combo = int(args[0]), int(args[1])
            if 0 <= tn <= 7:
                self._set_state("chan_type", (carrier, tn), combo)
            else:
                ok = 1
            extra = (tn, combo)
        elif verb == "SETPOWER":
            self.power[carrier] = int(args[0])
            extra = (self.power[carrier],)
        elif verb == "ADJPOWER":
            self.power[carrier] += int(args[0])
            extra = (self.power[carrier],)
        elif verb == "SETMAXDELAY":
            # the engine bounds accepted TOAs to ±max(value, 3)·sps per
            # carrier (Transceiver52M/sigProcLib.cpp:982-990); the static
            # correlation window is TrxDaemonConfig.max_toa
            self._set_state("max_expected_delay", carrier, int(args[0]))
            extra = (args[0],)
        else:
            return None  # bogus command: reference just logs
        return proto.pack_response(verb, ok, *extra)

    # ------------------------------------------------------------------
    # data plane
    # ------------------------------------------------------------------
    def handle_downlink(self, data: bytes, carrier: int = 0) -> None:
        try:
            burst = proto.unpack_downlink(data)
        except ValueError:
            return
        # adaptive transmit latency (driveTransmitFIFO,
        # Transceiver.cpp:688-716): a burst arriving for a frame already
        # transmitted is an underrun — grow the clock lead so the BTS
        # schedules further ahead; shrink slowly when clean.
        if (self.tx_fn - burst.fn) % HYPERFRAME < HYPERFRAME // 2 and \
                burst.fn != self.tx_fn:
            self.underruns += 1
            self.clock_lead = min(self.clock_lead + 1, 40)
            self._send_clock(force=True)
        elif self.underruns and (burst.fn - self.tx_fn) % HYPERFRAME > \
                self.clock_lead + 10:
            self.clock_lead = max(self.clock_lead - 1,
                                  proto.CLOCK_LEAD_FRAMES)
        self.pending_tx.push(
            burst.fn % HYPERFRAME, carrier, burst.tn,
            np.float32(burst.gain).tobytes()
            + np.asarray(burst.bits, np.uint8).tobytes())

    def _frame_ts(self, fn: int) -> int:
        return (fn - self.cfg.start_fn) * FRAME_SYMBOLS * self.cfg.sps

    def _to_dev(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(self.device)

    def step_frame(self) -> List[Tuple[int, proto.UplinkBurst]]:
        """Advance one GSM frame for all carriers: transmit tx_fn,
        receive fn. Returns (carrier, burst) uplink tuples."""
        n, sps = self.cfg.n_arfcn, self.cfg.sps
        # ---- downlink (driveTransmitFIFO + pushRadioVector) ----------
        # drop bursts whose deadline already passed; the filler table
        # covers the slot instead (Transceiver.cpp:144-154)
        self.stale_dumped += self.pending_tx.dump_stale(self.tx_fn)
        bits = np.zeros((n, 8, 148), np.uint8)
        valid = np.zeros((n, 8), bool)
        atten = np.zeros((n, 8), np.float32)
        for c in range(n):
            for tn in range(8):
                b = self.pending_tx.pop_exact(self.tx_fn, c, tn)
                if b is not None:
                    bits[c, tn] = np.frombuffer(b[4:], np.uint8)[:148] & 1
                    valid[c, tn] = True
                    atten[c, tn] = float(np.frombuffer(b[:4],
                                                       np.float32)[0])
        slots = eng.tx_step(self.engine_cfg, self.state, self._to_dev(bits),
                            self._to_dev(valid), self._to_dev(atten),
                            self.tx_fn).cpu().numpy()
        for c in range(n):
            if not self.carrier_on[c]:
                continue
            frame_samples = np.zeros(FRAME_SYMBOLS * sps, np.complex64)
            for tn in range(8):
                off = SLOT_OFFSETS[tn] * sps
                ln = SLOT_SAMPLE_PATTERN[tn] * sps
                frame_samples[off: off + ln] += slots[c, tn, :ln]
            self.radios[c].write_samples(frame_samples,
                                         self._frame_ts(self.tx_fn))
        self.tx_fn = (self.tx_fn + 1) % HYPERFRAME

        # ---- uplink (driveReceiveFIFO + pullRadioVector) -------------
        ts = self._frame_ts(self.fn)
        frame = np.zeros((n, 8, eng.SLOT_SAMPLES * sps), np.complex64)
        for c in range(n):
            if not self.carrier_on[c]:
                continue
            raw = self.radios[c].read_samples(FRAME_SYMBOLS * sps + sps, ts)
            for tn in range(8):
                off = SLOT_OFFSETS[tn] * sps
                frame[c, tn] = raw[off: off + eng.SLOT_SAMPLES * sps]
        self.state = self.state._replace(fn=torch.tensor(
            self.fn, dtype=torch.int32, device=self.device))
        self.state, res = eng.rx_step(self.engine_cfg, self.state,
                                      self._to_dev(frame))
        out: List[Tuple[int, proto.UplinkBurst]] = []
        det = res.detected.cpu().numpy()
        soft = res.soft_bits.cpu().numpy()
        rssi = res.rssi.cpu().numpy()
        timing = res.timing.cpu().numpy()
        for c in range(n):
            if not self.carrier_on[c]:
                continue
            for tn in range(8):
                if det[c, tn]:
                    out.append((c, proto.UplinkBurst(
                        tn, self.fn, int(rssi[c, tn]),
                        int(timing[c, tn]), soft[c, tn])))
        self.fn = (self.fn + 1) % HYPERFRAME
        return out

    def measure_alignment(self, carrier: int = 0,
                          probe_len: int = 64) -> int:
        """Measure the radio's Tx→Rx timestamp offset with an impulse
        probe (USRPDevice::updateAlignment, USRPDevice.cpp:518; with a
        software radio the offset is the loopback delay)."""
        ts = self._frame_ts(self.tx_fn) + 10_000  # quiet region
        probe = np.zeros(probe_len, np.complex64)
        probe[0] = 20000.0
        self.radios[carrier].write_samples(probe, ts)
        window = self.radios[carrier].read_samples(4 * probe_len,
                                                   ts - probe_len)
        peak = int(np.argmax(np.abs(window)))
        return peak - probe_len  # samples of Tx→Rx delay

    def _send_clock(self, force: bool = False) -> None:
        self.clock_sock.send(proto.pack_clock(
            (self.tx_fn + self.clock_lead) % HYPERFRAME))
        self.last_clock_fn = self.tx_fn

    def step(self) -> None:
        """One service iteration: control, data ingest, one frame."""
        for c in range(self.cfg.n_arfcn):
            # drain the whole control queue each step (the reference's
            # ControlServiceLoop services commands as they arrive,
            # Transceiver.cpp:754-760)
            while True:
                msg = self.ctrl_socks[c].recv(256, timeout_ms=0)
                if not msg:
                    break
                resp = self.handle_control(msg, c)
                if resp:
                    self.ctrl_socks[c].send(resp)
            while True:
                d = self.data_socks[c].recv(512, timeout_ms=0)
                if not d:
                    break
                self.handle_downlink(d, c)
        if not self.on:
            return
        for carrier, burst in self.step_frame():
            self.data_socks[carrier].send(proto.pack_uplink(burst))
        if (self.last_clock_fn is None or
                (self.tx_fn - self.last_clock_fn) % HYPERFRAME
                >= proto.CLOCK_PERIOD_FRAMES):
            self._send_clock()

    def run(self, max_frames: int | None = None) -> None:
        n = 0
        while max_frames is None or n < max_frames:
            self.step()
            n += 1

    def close(self) -> None:
        """Close the clock, control and data sockets."""
        for sock in [self.clock_sock, *self.ctrl_socks, *self.data_socks]:
            sock.close()


class BlockTrxDaemon(TrxDaemon):
    """Block-pipelined daemon: one duplex block per 13-frame window
    (downlink modulate + 96/65 resample and uplink 65/96 resample +
    detect + demod, `models.transceiver.duplex_block_compact` or
    `duplex_block_packed`) behind the same 3-plane wire protocol.

    Where the reference overlaps I/O and DSP with three service threads
    (Transceiver52M/Transceiver.cpp:744-778), each `step()` dispatches
    block N and then retires block N − d, d the `pipeline_depth` (fetch,
    radio write, uplink datagram batch), while the device works on the
    blocks after it. The engine's receive path syncs the host at its
    estimation and equalizer gates, so on a GPU the overlap covers only
    the work queued after the last of them. Burst marshalling is native
    and dense: `bpq_pop_block` / `bpq_push_block` / `udt_send_batch`
    move whole windows per call.

    Spans (`utils/profiling.span`), one set a step: `trxd.step` is the
    root; inside it `trxd.control` (the control planes), `trxd.ingest`
    (the downlink data planes into the burst queue), `trxd.marshal` (the
    window's bursts and uplink samples into one buffer, and its upload,
    a `sync.upload`), the duplex block's own spans, and `trxd.retire`
    (the oldest block's fetch, each copy a `sync.retire`, then its DAC
    write and uplink datagrams). A retire outside `step` (`flush`) is a
    root of its own.
    """

    def __init__(self, radio, cfg: TrxDaemonConfig = TrxDaemonConfig(),
                 block_frames: int = 13, pipeline_depth: int = 1,
                 compact: bool = True):
        super().__init__(radio, cfg)
        assert block_frames % 13 == 0, \
            "65/96 streaming needs 13-frame multiples"
        self.spec = trx_model.UplinkSpec(frames=block_frames)
        n = cfg.n_arfcn
        self._tx_tail = torch.zeros((n, trx_model.TX_TAIL_SYM),
                                    dtype=torch.complex64,
                                    device=self.device)
        self._rx_block = 0
        self._tx_block = 0
        self._frames_since_late = 0
        #: blocks kept in flight before retiring. Depth 1 overlaps host
        #: I/O with one device block (the reference's thread overlap).
        self.pipeline_depth = pipeline_depth
        self._pending: list = []
        #: device-side result compaction (duplex_block_compact): the
        #: host fetches only detected datagrams and live-carrier DAC rows
        self.compact = compact
        self._prev_any_valid = np.ones(n, bool)  # bootstrap: all live
        self._filler_tx: np.ndarray | None = None  # cached filler block
        self.d2h_bytes = 0  # result bytes fetched (both paths)
        self.d2h_bytes_dense = 0  # what the dense layout would have cost
        # radio samples cross to the device as int16 I/Q, the USRP sample
        # format, converted to float there (the reference does this on
        # the host in USRPifyVector, radioInterface.cpp:101-146); radios
        # that speak int16 natively (`int16_io`) skip all conversions
        self._radio_i16 = bool(getattr(self.bank, "int16_io", False))

    # -- plane servicing (bulk) -----------------------------------------
    def _service_control(self) -> None:
        for c, sock in enumerate(self.ctrl_socks):
            while True:
                msg = sock.recv(256, timeout_ms=0)
                if not msg:
                    break
                resp = self.handle_control(msg, c)
                if resp:
                    sock.send(resp)

    def _ingest_downlink(self) -> None:
        late_total = 0
        for c, sock in enumerate(self.data_socks):
            pkts = sock.drain_fixed(proto.DOWNLINK_LEN, 16384)
            if len(pkts):
                _, late = self.pending_tx.push_block(c, pkts, self.tx_fn)
                late_total += late
        # adaptive clock lead (driveTransmitFIFO, Transceiver.cpp:
        # 688-716): late bursts grow the lead; a quiet 216 frames
        # shrinks it back toward the initial value
        if late_total:
            self.underruns += late_total
            self.clock_lead = min(self.clock_lead + 1, 40)
            self._frames_since_late = 0
            self._send_clock(force=True)
        else:
            self._frames_since_late += self.spec.frames
            if self._frames_since_late >= proto.CLOCK_PERIOD_FRAMES:
                self.clock_lead = max(self.clock_lead - 1,
                                      proto.CLOCK_LEAD_FRAMES)
                self._frames_since_late = 0

    # -- radio I/O at the 400 kS/s device rate ---------------------------
    def _read_ul(self, block: int) -> np.ndarray:
        """int16 [C, halo+block_in+halo, 2] uplink window."""
        halo = trx_model.RX_HALO_DEV
        n = self.spec.block_in + 2 * halo
        ts = block * self.spec.block_in - halo
        if self.bank is not None:
            raw = self.bank.read_bank(n, ts)
        else:
            raw = np.stack([r.read_samples(n, ts) for r in self.radios])
        if not self._radio_i16:  # complex radio → ADC format
            raw = np.clip(np.stack([raw.real, raw.imag], -1).round(),
                          -32767, 32767).astype(np.int16)
        return raw

    def _write_tx(self, tx_i16: np.ndarray, block: int) -> None:
        """tx_i16: int16 [C, block_in, 2] — the DAC sample format."""
        ts = block * self.spec.block_in - trx_model.TX_DELAY_DEV
        if self.bank is not None:
            self.bank.write_bank(tx_i16, ts)
            return
        txc = (tx_i16[..., 0].astype(np.float32)
               + 1j * tx_i16[..., 1].astype(np.float32))
        for c, r in enumerate(self.radios):
            if self.carrier_on[c]:
                r.write_samples(txc[c], ts)

    # -- the pipeline -----------------------------------------------------
    def _retire(self, pending) -> None:
        """Fetch the oldest block's packed result in one transfer and
        push it out."""
        out, tx_block = pending
        with span("sync.retire"):
            buf = out.cpu().numpy()  # uint8: the block's sync point
        self.d2h_bytes += buf.nbytes
        self.d2h_bytes_dense += buf.nbytes
        tx, pkts, det = trx_model.unpack_block_result(
            buf, self.cfg.n_arfcn, self.spec)
        self._write_tx(tx, tx_block)
        for c in range(self.cfg.n_arfcn):
            if not self.carrier_on[c]:
                continue
            mask = det[:, c].reshape(-1)
            if mask.any():
                rows = pkts[:, c].reshape(-1, pkts.shape[-1])[mask]
                self.data_socks[c].send_batch(rows)

    def _retire_compact(self, pending) -> None:
        """Fetch the oldest block's compacted result: the 8-byte header,
        then exactly the live DAC rows and the detected datagram rows.
        Filler carriers replay the cached filler block."""
        (hdr, tx_buf, pkt_buf), live, cacheable, tx_block = pending
        ul_pkt = trx_model.UL_PKT
        with span("sync.retire"):
            h = hdr.cpu().numpy()  # the block's sync point
        n_det = int.from_bytes(h[:4].tobytes(), "big")
        n_live = int.from_bytes(h[4:8].tobytes(), "big")
        n, t4 = self.cfg.n_arfcn, self.spec.block_in * 4
        f = self.spec.frames

        live_idx = np.flatnonzero(live)
        assert len(live_idx) == n_live
        tx = np.empty((n, self.spec.block_in, 2), np.int16)
        if n_live:
            with span("sync.retire"):
                rows = tx_buf[:n_live].cpu().numpy()
            self.d2h_bytes += rows.nbytes
            tx[live_idx] = rows.view("<i2").reshape(
                n_live, self.spec.block_in, 2)
        if n_live < n:
            if self._filler_tx is None:
                # bootstrap miss: the mask said live for every carrier
                # until a (filler, filler-tail) block has been seen
                raise RuntimeError("filler cache empty but carrier "
                                   "suppressed")
            tx[~live] = self._filler_tx
        elif self._filler_tx is None:
            # capture the cache from a carrier whose current and previous
            # windows were filler (its output is the periodic filler
            # block; the pattern is the same on every carrier)
            cand = np.flatnonzero(cacheable)
            if len(cand):
                self._filler_tx = tx[cand[0]].copy()
        self._write_tx(tx, tx_block)

        if n_det:
            with span("sync.retire"):
                prows = pkt_buf[:n_det].cpu().numpy()
            self.d2h_bytes += prows.nbytes
            chans = (prows[:, ul_pkt].astype(np.int32) << 8) | \
                prows[:, ul_pkt + 1]
            order = np.argsort(chans, kind="stable")
            prows, chans = prows[order], chans[order]
            starts = np.searchsorted(chans, np.arange(n))
            ends = np.searchsorted(chans, np.arange(n), side="right")
            for c in range(n):
                if ends[c] > starts[c] and self.carrier_on[c]:
                    self.data_socks[c].send_batch(
                        np.ascontiguousarray(
                            prows[starts[c]: ends[c], :ul_pkt]))
        self.d2h_bytes += h.nbytes
        self.d2h_bytes_dense += (n * t4 + f * n * 8 * (ul_pkt + 1))

    @span("trxd.step")
    def step(self) -> None:
        """One block service iteration: control, bulk data ingest,
        dispatch block N, retire block N − pipeline_depth, clock
        beacon."""
        f = self.spec.frames
        with span("trxd.control"):
            self._service_control()
        with span("trxd.ingest"):
            self._ingest_downlink()
        if not self.on:
            return
        with span("trxd.marshal"):
            # downlink window marshalling (stale-burst dump + dense pop,
            # pushRadioVector semantics, Transceiver.cpp:141-181)
            self.stale_dumped += self.pending_tx.dump_stale(self.tx_fn)
            bits, valid, gain, _ = self.pending_tx.pop_block(
                self.tx_fn, f, self.cfg.n_arfcn)
            ul = self._read_ul(self._rx_block)
            if self.compact:
                any_valid = valid.any(axis=(0, 2))  # [C]
                cacheable = ~any_valid & ~self._prev_any_valid
                live = any_valid | self._prev_any_valid | \
                    (self._filler_tx is None)
                self._prev_any_valid = any_valid
                io_buf = trx_model.pack_dl_buffer_live(
                    bits, valid, gain, self.fn, self.tx_fn, ul, live)
            else:
                io_buf = trx_model.pack_dl_buffer(bits, valid, gain,
                                                  self.fn, self.tx_fn,
                                                  ul_i16=ul)
            # from pageable host memory the copy waits for the device
            with span("sync.upload"):
                dev_buf = self._to_dev(io_buf)
        if self.compact:
            st, tail, hdr, tx_buf, pkt_buf = trx_model.duplex_block_compact(
                self.engine_cfg, self.spec, self.state, dev_buf,
                self._tx_tail)
            pend = ((hdr, tx_buf, pkt_buf), np.asarray(live, bool),
                    cacheable, self._tx_block)
        else:
            st, tail, out = trx_model.duplex_block_packed(
                self.engine_cfg, self.spec, self.state, dev_buf,
                self._tx_tail)
            pend = (out, self._tx_block)
        self.state, self._tx_tail = st, tail
        self._pending.append(pend)
        self.fn = (self.fn + f) % HYPERFRAME
        self.tx_fn = (self.tx_fn + f) % HYPERFRAME
        self._rx_block += 1
        self._tx_block += 1
        while len(self._pending) > self.pipeline_depth:
            self._retire_one()
        if (self.last_clock_fn is None or
                (self.tx_fn - self.last_clock_fn) % HYPERFRAME
                >= proto.CLOCK_PERIOD_FRAMES):
            self._send_clock()

    @span("trxd.retire")
    def _retire_one(self) -> None:
        p = self._pending.pop(0)
        (self._retire_compact if self.compact else self._retire)(p)

    def flush(self) -> None:
        """Retire every in-flight block (call after the last step)."""
        while self._pending:
            self._retire_one()

    def run(self, max_frames: int | None = None) -> None:
        n = 0
        while max_frames is None or n < max_frames:
            self.step()
            n += self.spec.frames
        self.flush()


def main(argv=None):  # pragma: no cover - manual entry point
    import argparse

    from openbts_ttsou_tpu_torch.trx.radio import LoopbackRadio

    ap = argparse.ArgumentParser(description="GSM transceiver daemon "
                                 "(PyTorch)")
    ap.add_argument("--base-port", type=int, default=5700)
    ap.add_argument("--peer", default="127.0.0.1")
    ap.add_argument("--arfcns", type=int, default=1)
    ap.add_argument("--loopback-delay", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (default: cuda)")
    args = ap.parse_args(argv)
    radios = [LoopbackRadio(delay_samples=args.loopback_delay)
              for _ in range(args.arfcns)]
    daemon = TrxDaemon(radios,
                       TrxDaemonConfig(base_port=args.base_port,
                                       peer_host=args.peer,
                                       n_arfcn=args.arfcns,
                                       device=args.device))
    daemon.run()


if __name__ == "__main__":  # pragma: no cover
    main()
