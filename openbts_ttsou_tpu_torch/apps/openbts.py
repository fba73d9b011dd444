"""The BTS application: composition root + service loop + CLI.

Port of `openbts_ttsou_tpu/apps/openbts.py`:

    python -m openbts_ttsou_tpu_torch.apps.openbts [--device cpu] [--spawn-trx]

Every L1 channel runs its FEC on the app's torch device ("cuda" unless
the caller names another; no fallback to the CPU), and a spawned
transceiver is the port's daemon on the same device. Reference
behavior: `apps/OpenBTS.cpp:174-340` — config load, forked
transceiver child with hangup watchdog (restartTransceiver,
OpenBTS.cpp:93-155), radio bring-up sequence (:200-214), beacon and
channel-set instantiation (:215-291), BTS start and the CLI REPL with
periodic load logging (:305-340).

The reference's per-channel threads become one event-driven service
loop (`BTSApp.step`); the transceiver runs either in-process
(`TrxDaemon`) or as a child process speaking the UDP wire protocol.
"""

from __future__ import annotations

import subprocess
import sys
import time as systime
from typing import List, Optional

import numpy as np

from openbts_ttsou_tpu_torch.cli import Parser
from openbts_ttsou_tpu_torch.control.hlr import LocalHLR
from openbts_ttsou_tpu_torch.control.procedures import ControlLayer
from openbts_ttsou_tpu_torch.gsm import channels, tdma
from openbts_ttsou_tpu_torch.gsm.btsconfig import BTSConfig
from openbts_ttsou_tpu_torch.gsm.transfer import L2Frame, Primitive
from openbts_ttsou_tpu_torch.gsm.trxmanager import TransceiverManager
from openbts_ttsou_tpu_torch.gsm.lapdm import CCCHL2
from openbts_ttsou_tpu_torch.sip.interface import SIPInterface
from openbts_ttsou_tpu_torch.trx.engine import resolve_device
from openbts_ttsou_tpu_torch.utils.config import ConfigurationTable
from openbts_ttsou_tpu_torch.utils.logger import ALARM, get_logger

log = get_logger("openbts")


class BTSApp:
    """Everything the reference's main() wires up."""

    def __init__(self, config: Optional[ConfigurationTable] = None,
                 trx_base_port: int = 5700,
                 spawn_transceiver: bool = False,
                 sip_enabled: bool = False, device="cuda"):
        self.device = dev = resolve_device(device)
        self.bts = BTSConfig(config)
        c = self.bts.config
        self.trx_base_port = trx_base_port
        self.trx_child: Optional[subprocess.Popen] = None
        if spawn_transceiver:
            self.restart_transceiver()
        self.n_arfcn = c.get_int("GSM.NumARFCNs", 1)
        self.trx = TransceiverManager(
            n_arfcn=self.n_arfcn, local_base=trx_base_port + 100,
            remote_base=trx_base_port)
        self.bts.clock = self.trx.clock
        self.sip: Optional[SIPInterface] = None
        if sip_enabled:
            self.sip = SIPInterface(
                local_port=c.get_int("SIP.Port", 5062),
                proxy_host=c.get_str("Asterisk.IP", "127.0.0.1"),
                proxy_port=c.get_int("Asterisk.Port", 5060),
                on_new_invite=self._on_invite,
                on_new_message=self._on_message)
        self.control = ControlLayer(
            self.bts, hlr=LocalHLR(),
            sip_send=(self.sip.send if self.sip else (lambda d: None)),
            sip_fifos=self.sip)
        self.parser = Parser(self)

        # beacon + channel set (OpenBTS.cpp:215-291)
        self.sch = channels.SCHL1(self.bts.bsic(), device=dev)
        self.fcch = channels.FCCHL1(device=dev)
        self.bcch = channels.CCCHL1(0, tdma.BCCH, tdma.BCCH,
                                    tsc=self.bts.bcc, device=dev)
        self.agch = channels.CCCHL1(0, tdma.CCCH[0], tdma.CCCH[0],
                                    tsc=self.bts.bcc, device=dev)
        self.pch = channels.CCCHL1(0, tdma.CCCH[1], tdma.CCCH[1],
                                   tsc=self.bts.bcc, device=dev)
        self.ccch_l2 = CCCHL2()
        self.rach = channels.RACHL1(0, self.bts.bsic(),
                                    self.control.handle_rach, device=dev)
        self.dcch: List[channels.LogicalChannel] = []
        # SDCCH/4 on the C-V beacon slot (OpenBTS.cpp:215-259 builds the
        # beacon + SDCCH/4 set; combination V carries the RACH)
        n_sdcch = c.get_int("GSM.NumSDCCH", 4)
        for i in range(min(n_sdcch, 4)):
            dl, ul = tdma.SDCCH_4[i]
            l1 = channels.XCCHL1(0, dl, ul, tsc=self.bts.bcc, device=dev)
            l1.subchannel = i
            sa_dl, sa_ul = tdma.SACCH_C4[i]
            sacch = channels.SACCHL1(0, sa_dl, sa_ul, tsc=self.bts.bcc,
                                     device=dev)
            ch = channels.LogicalChannel(l1, sapis=(0, 3), sacch=sacch)
            l1.clock = self.bts.clock.fn
            sacch.clock = self.bts.clock.fn
            self.bts.add_sdcch(ch)
            self.dcch.append(ch)
        # SDCCH/8 slots (combination VII), OpenBTS.cpp NumC7s loop
        n_c7 = c.get_int("GSM.NumC7s", 0)
        self._c7_tns = []
        tn_next = 1
        for _ in range(min(n_c7, 7)):
            tn = tn_next
            tn_next += 1
            self._c7_tns.append(tn)
            for i in range(8):
                dl, ul = tdma.SDCCH_8[i]
                l1 = channels.XCCHL1(tn, dl, ul, tsc=self.bts.bcc,
                                     device=dev)
                l1.subchannel = i
                sa_dl, sa_ul = tdma.SACCH_C8[i]
                sacch = channels.SACCHL1(tn, sa_dl, sa_ul,
                                         tsc=self.bts.bcc, device=dev)
                ch = channels.LogicalChannel(l1, sapis=(0, 3),
                                             sacch=sacch)
                l1.clock = self.bts.clock.fn
                sacch.clock = self.bts.clock.fn
                self.bts.add_sdcch(ch)
                self.dcch.append(ch)
        # TCH/F slots: fill the remaining C0 timeslots first, then whole
        # extra carriers (one ARFCNManager per carrier, TRXManager.h:62,
        # 115; the beacon/CCCH/RACH stay C0-only per their mappings)
        n_tch = c.get_int("GSM.NumTCH", 2)
        tch_sites = [(0, tn) for tn in range(tn_next, 8)]
        for car in range(1, self.n_arfcn):
            tch_sites += [(car, tn) for tn in range(8)]
        for car, tn in tch_sites[:n_tch]:
            tch_l1 = channels.TCHFACCHL1(tn, tdma.FACCH_TCHF,
                                         tdma.FACCH_TCHF, tsc=self.bts.bcc,
                                         device=dev)
            tch_l1.clock = self.bts.clock.fn
            tch_l1.carrier = car
            self.bts.add_tch(channels.TCHFACCHLogicalChannel(tch_l1))
        self.trx.arfcn(0).install_decoder(self.rach)
        for tch in self.bts.tch_pool:
            self.trx.arfcn(self._carrier_of(tch)).install_decoder(tch.l1)
        for ch in self.dcch:
            arfcn = self.trx.arfcn(self._carrier_of(ch))
            arfcn.install_decoder(ch.l1)
            if ch.sacch is not None:
                arfcn.install_decoder(ch.sacch)
        self._last_fn = -1
        self._beacon_fn = 0
        self._last_load_log = 0.0
        self._si56_flip = 0
        self._link_was_up: dict = {}
        self._last_clock_fn = -1
        self._last_clock_change = systime.monotonic()

    @staticmethod
    def _carrier_of(ch) -> int:
        """The carrier index a channel (or L1) transmits on."""
        l1 = getattr(ch, "l1", ch)
        return getattr(l1, "carrier", 0)

    # -- transceiver child management (OpenBTS.cpp:93-155) -------------
    def restart_transceiver(self) -> None:
        """(Re)start the port's daemon as a child process on the app's
        device."""
        if self.trx_child is not None:
            self.trx_child.kill()
            self.trx_child.wait(timeout=5)
        self.trx_child = subprocess.Popen(
            [sys.executable, "-m", "openbts_ttsou_tpu_torch.trx.daemon",
             "--base-port", str(self.trx_base_port),
             "--arfcns", str(getattr(self, "n_arfcn", 1)),
             "--device", str(self.device)])

    def bringup(self, arfcn_khz: int = 890000) -> bool:
        """Radio bring-up sequence (OpenBTS.cpp:200-214), repeated per
        carrier at 200 kHz spacing (one ARFCNManager per carrier,
        TRXManager.h:115)."""
        ok = True
        for car in range(self.n_arfcn):
            a = self.trx.arfcn(car)
            khz = arfcn_khz + 200 * car
            ok &= a.power_off()
            ok &= a.set_tsc(self.bts.bcc)
            ok &= a.tune(khz, khz + 45000)
            ok &= a.set_power(0)
            ok &= a.set_max_delay(4)
        a0 = self.trx.arfcn(0)
        ok &= a0.set_slot(0, 5)  # C-V beacon slot (OpenBTS.cpp:213)
        for tn in getattr(self, "_c7_tns", []):
            ok &= a0.set_slot(tn, 7)  # combination VII (SDCCH/8)
        for car, tn in sorted({(self._carrier_of(t), t.tn)
                               for t in self.bts.tch_pool}):
            ok &= self.trx.arfcn(car).set_slot(tn, 1)  # C-I (TCH/F)
        for car in range(self.n_arfcn):
            ok &= self.trx.arfcn(car).power_on()
        return ok

    # -- SIP inbound hooks ---------------------------------------------
    def _on_invite(self, msg) -> None:
        user = msg.uri_user("to") or ""
        imsi = user[4:] if user.startswith("IMSI") else \
            self.control.hlr.get_imsi(user) or user
        t = self.control.initiate_mtc(imsi,
                                      calling=msg.uri_user("from") or "")
        engine = self.control._new_engine(f"IMSI{imsi}")
        engine.mtc_accept_invite(msg)
        t.sip = engine

    def _on_message(self, msg) -> None:
        user = msg.uri_user("to") or ""
        imsi = user[4:] if user.startswith("IMSI") else \
            self.control.hlr.get_imsi(user) or user
        self.control.initiate_mtsms(imsi, msg.uri_user("from") or "",
                                    msg.body)

    # -- service loop --------------------------------------------------
    def step(self) -> None:
        """One iteration: clock, rx, beacon/CCCH scheduling, SIP,
        paging (the union of the reference's service threads)."""
        self.trx.poll_clock(timeout_ms=0)
        arfcn = self.trx.arfcn(0)
        for a in self.trx.arfcns:
            a.drive_rx(timeout_ms=0)
        fn_now = self.bts.clock.fn()
        # drain decoded L3 from dedicated channels into Control — the
        # TCH pool included: its LAPDm rides the FACCH
        # (TCHFACCHLogicalChannel), so AssignmentComplete and in-call
        # signalling arrive here too
        for ch in self.dcch + list(self.bts.tch_pool):
            ch.l1.resync(fn_now)
            if ch.sacch is not None:
                ch.sacch.resync(fn_now)
            ch.pump()
            while True:
                l3 = ch.recv(0)
                if l3 is None:
                    break
                if l3.primitive == Primitive.DATA and len(l3.bits) >= 16:
                    self.control.dispatch_l3(ch, l3.bits)
            while True:
                l3 = ch.recv_sacch()
                if l3 is None:
                    break
                from openbts_ttsou_tpu_torch.gsm.l3 import parse_l3, rr as rr_l3

                msg = parse_l3(l3.bits) if len(l3.bits) >= 16 else None
                if isinstance(msg, rr_l3.MeasurementReport):
                    # feed downlink power control with RXLEV (the
                    # SACCH measurement path, GSML1FEC.cpp:685-695)
                    ch.sacch.ordered_ms_power = max(
                        5, min(33, 33 - (msg.rxlev_full - 40) // 4))
                    # closed-loop timing advance from the decoder's
                    # averaged timing error (L1Decoder::setPhy →
                    # ordered TA in the SACCH L1 header)
                    n = max(ch.l1.phy_count, 1)
                    ta = ch.sacch.ordered_ms_timing + \
                        ch.l1.timing_sum / n
                    ch.sacch.ordered_ms_timing = max(0, min(63,
                                                            int(ta)))
            while 3 in ch.l2:  # SMS SAP (TCH FACCH carries SAPI 0 only)
                l3 = ch.recv(3)
                if l3 is None:
                    break
                if l3.primitive == Primitive.DATA and len(l3.bits) >= 16:
                    blob = np.packbits(l3.bits).tobytes()
                    self.control.handle_sms_cpdata(ch, blob)
        # beacon + CCCH downlink for the near future
        fn_now = self.bts.clock.fn()
        horizon = fn_now + 30
        while self._beacon_fn <= horizon:
            self._generate_downlink(self._beacon_fn)
            self._beacon_fn += 1
        # dedicated-channel downlink; open SACCHs idle-fill with the
        # SI5/SI6 rotation (GSMConfig mSI5Frame/mSI6Frame served by
        # SACCHL1Encoder between dedicated frames)
        for ch in self.dcch:
            if ch.sacch is not None and ch.sacch.active and \
                    not ch.sacch.tx_queue:
                ch.send_sacch(self.bts.sacch_fill_frame(self._si56_flip),
                              fill=True)
                self._si56_flip += 1
            while ch.l1.tx_queue and ch.l1.tx_queue[0].fn <= horizon:
                arfcn.write_high_side(ch.l1.tx_queue.popleft())
            if ch.sacch is not None:
                while ch.sacch.tx_queue and \
                        ch.sacch.tx_queue[0].fn <= horizon:
                    arfcn.write_high_side(ch.sacch.tx_queue.popleft())
        # TCH downlink: keep each open channel's 4-burst blocks ahead
        # of the clock (speech > FACCH > silence filler), and run the
        # in-call voice pumps (CallControl.cpp:393-407 loop body)
        for tch in self.bts.tch_pool:
            l1 = tch.l1
            a = self.trx.arfcn(self._carrier_of(tch))
            if l1.active:
                l1.resync(fn_now)
                while l1.next_write_fn <= horizon:
                    l1.dispatch_block()
            while l1.tx_queue and l1.tx_queue[0].fn <= horizon:
                a.write_high_side(l1.tx_queue.popleft())
        for t in self.control.transactions.entries():
            pump = getattr(t, "voice", None)
            if pump is not None:
                pump.pump()
        if self.sip:
            self.sip.drive(timeout_ms=0)
        self.control.dtmf_tick()
        self.control.page_tick()
        self.control.release_tick()
        # normal release: the MS closed its LAPDm (DISC) — reclaim the
        # channel once the link drops (the reference's T3111 close-out
        # in DCCHDispatch after RELEASE)
        from openbts_ttsou_tpu_torch.gsm.lapdm import LAPDState

        for ch in self.dcch + list(self.bts.tch_pool):
            st = ch.l2[0].state
            if st == LAPDState.LinkEstablished:
                # key the flag to this occupancy (open time) so a
                # reallocated channel is never reclaimed spuriously
                self._link_was_up[id(ch)] = getattr(
                    ch.l1, "opened_at_s", None)
            elif st == LAPDState.LinkReleased and \
                    self._link_was_up.pop(id(ch), None) == getattr(
                        ch.l1, "opened_at_s", object()) and ch.l1.active:
                log.info("link released by MS; reclaiming TN%d sub%d",
                         ch.l1.tn, getattr(ch.l1, "subchannel", 0))
                ch.l1.close()
                if ch.sacch is not None:
                    ch.sacch.close()
                if hasattr(ch, "reset"):
                    ch.reset()
                self.bts.release(ch)
                self.control.channel_transactions.pop(id(ch), None)
                self.control.pending_release.pop(id(ch), None)
        # channel recycling (decoder timeouts, GSML1FEC.cpp:365-372)
        now = systime.monotonic()
        t3101 = self.bts.config.get_int("GSM.Timer.T3101", 8000) / 1000.0
        t3109 = self.bts.config.get_int("GSM.Timer.T3109", 30000) / 1000.0
        for ch in self.dcch + list(self.bts.tch_pool):
            if ch.l1.recyclable(now, t3101, t3109):
                log.warning("recycling stale SDCCH TN%d sub%d",
                            ch.l1.tn, getattr(ch.l1, "subchannel", 0))
                ch.l1.close()
                if hasattr(ch, "reset"):
                    ch.reset()
                self.bts.release(ch)
                self.control.channel_transactions.pop(id(ch), None)
                self.control.pending_release.pop(id(ch), None)
        # transceiver hangup detector (OpenBTS.cpp:125-155): restart
        # the child when the clock stops advancing past the timeout
        if self.trx_child is not None:
            fn_now2 = self.bts.clock.fn()
            if fn_now2 != self._last_clock_fn:
                self._last_clock_fn = fn_now2
                self._last_clock_change = systime.monotonic()
            elif systime.monotonic() - self._last_clock_change > \
                    self.bts.config.get_int("TRX.HangupTimeout", 30):
                log.log(ALARM, "transceiver hung (clock stalled); "
                        "restarting")
                self.restart_transceiver()
                self._last_clock_change = systime.monotonic()
        # periodic load line (OpenBTS.cpp:157-172 writes a CSV to
        # log.out; we emit through the logger)
        now = systime.monotonic()
        if now - self._last_load_log > 15.0:
            self._last_load_log = now
            b = self.bts
            log.info(
                "load: sdcch=%d/%d tch=%d/%d paging=%d t3122=%ds "
                "transactions=%d",
                b.sdcch_total() - b.sdcch_available(), b.sdcch_total(),
                b.tch_total() - b.tch_available(), b.tch_total(),
                b.pager.size(), b.t3122(),
                self.control.transactions.size())

    def _generate_downlink(self, fn: int) -> None:
        arfcn = self.trx.arfcn(0)
        b = self.sch.generate(fn)
        if b:
            arfcn.write_high_side(b)
        b = self.fcch.generate(fn)
        if b:
            arfcn.write_high_side(b)
        # BCCH: SI rotation by TC (BCCHL1Encoder::generate,
        # GSML1FEC.cpp:977-996)
        if tdma.BCCH.reverse(fn) == 0:
            tc = (fn // 51) % 8
            self.ccch_l2.write_high_side(self.bts.si_frame_for_tc(tc))
            for f in self.ccch_l2.take_l1_out():
                self._send_ccch(self.bcch, f, fn)
        # AGCH on CCCH block 0, PCH on CCCH block 1 (the reference
        # splits AGCH/PCH across the CCCH blocks; GSMConfig.cpp
        # getAGCH/getPCH feed distinct CCCHL1 encoders)
        if tdma.CCCH[0].reverse(fn) == 0:
            frame = self.bts.next_agch_frame()
            if frame is not None:
                self.ccch_l2.write_high_side(frame)
                for f in self.ccch_l2.take_l1_out():
                    self._send_ccch(self.agch, f, fn)
        if tdma.CCCH[1].reverse(fn) == 0:
            frame = self.bts.next_pch_frame()
            if frame is not None:
                self.ccch_l2.write_high_side(frame)
                for f in self.ccch_l2.take_l1_out():
                    self._send_ccch(self.pch, f, fn)

    def _send_ccch(self, l1: channels.CCCHL1, frame: L2Frame,
                   fn: int) -> None:
        l1.active = True
        l1.next_write_fn = fn
        l1.send_l2(frame)
        arfcn = self.trx.arfcn(0)
        while l1.tx_queue:
            arfcn.write_high_side(l1.tx_queue.popleft())

    def run_cli(self) -> None:  # pragma: no cover - interactive
        print(f"openbts-ttsou-tpu ready; type 'help'")
        while True:
            try:
                line = input("OpenBTS> ")
            except EOFError:
                break
            out = self.parser.process(line)
            if out:
                print(out)
            if line.strip() == "exit":
                break

    def shutdown(self) -> None:
        self.trx.stop()
        if self.trx_child is not None:
            self.trx_child.kill()
            self.trx_child.wait(timeout=10)


def main():  # pragma: no cover - manual entry point
    import argparse

    ap = argparse.ArgumentParser(description="OpenBTS on PyTorch")
    ap.add_argument("--config", default=None)
    ap.add_argument("--trx-port", type=int, default=5700)
    ap.add_argument("--spawn-trx", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the L1 FEC and of a spawned "
                         "transceiver (default: cuda)")
    args = ap.parse_args()
    cfg = ConfigurationTable(args.config) if args.config else None
    app = BTSApp(cfg, trx_base_port=args.trx_port,
                 spawn_transceiver=args.spawn_trx, sip_enabled=True,
                 device=args.device)
    app.trx.start()
    app.bringup()
    import threading

    def loop():
        while True:
            app.step()
            systime.sleep(0.002)

    threading.Thread(target=loop, daemon=True).start()
    app.run_cli()
    app.shutdown()


if __name__ == "__main__":  # pragma: no cover
    main()
