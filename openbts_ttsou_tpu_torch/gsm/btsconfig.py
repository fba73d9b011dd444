"""The BTS object: beacon, channel pools, access control, clock.

Port of `openbts_ttsou_tpu/gsm/btsconfig.py`. Reference behavior: `GSM/GSMConfig.{h,cpp}` — the one `gBTS` instance:
precomputed SI beacon frames (GSMConfig.cpp:57+), SDCCH/TCH channel
pools with `getSDCCH()/getTCH()` allocation, AGCH/PCH queues, T3122
access-backoff bounds, BSIC (NCC/BCC), and the BTS frame clock.
"""

from __future__ import annotations

import collections
import threading
from typing import Deque, List, Optional

from openbts_ttsou_tpu_torch.control.common import Pager
from openbts_ttsou_tpu_torch.gsm import channels
from openbts_ttsou_tpu_torch.gsm.l3 import rr
from openbts_ttsou_tpu_torch.gsm.l3.common import LAI
from openbts_ttsou_tpu_torch.gsm.transfer import L3Frame, Primitive
from openbts_ttsou_tpu_torch.gsm.trxmanager import Clock
from openbts_ttsou_tpu_torch.utils.config import ConfigurationTable


class BTSConfig:
    """The gBTS equivalent."""

    def __init__(self, config: Optional[ConfigurationTable] = None):
        self.config = config or ConfigurationTable()
        c = self.config
        self.mcc = c.get_str("GSM.MCC", "001")
        self.mnc = c.get_str("GSM.MNC", "01")
        self.lac = c.get_int("GSM.LAC", 1000)
        self.cell_id = c.get_int("GSM.CI", 10)
        self.ncc = c.get_int("GSM.NCC", 0)
        self.bcc = c.get_int("GSM.BCC", 2)
        self.arfcn = c.get_int("GSM.ARFCN", 0)
        self.t3122_min_s = c.get_num("GSM.T3122Min", 2.0)
        self.t3122_max_s = c.get_num("GSM.T3122Max", 255.0)
        self._t3122_s = self.t3122_min_s

        self.clock = Clock()
        self.pager = Pager()
        self.lock = threading.RLock()

        # channel pools (GSMConfig.h getSDCCH/getTCH)
        self.sdcch_pool: List[channels.LogicalChannel] = []
        self.tch_pool: List[channels.TCHFACCHL1] = []
        self._sdcch_busy: dict[int, bool] = {}
        self._tch_busy: dict[int, bool] = {}

        # AGCH/PCH downlink queues (L3 frames for the CCCH)
        self.agch_q: Deque[L3Frame] = collections.deque()
        self.pch_q: Deque[L3Frame] = collections.deque()

    # -- identity ------------------------------------------------------
    def bsic(self) -> int:
        """NCC(3) | BCC(3) (GSM 03.03 4.3.2)."""
        return (self.ncc << 3) | self.bcc

    def lai(self) -> LAI:
        return LAI(self.mcc, self.mnc, self.lac)

    # -- channel pools -------------------------------------------------
    def add_sdcch(self, ch: channels.LogicalChannel) -> None:
        with self.lock:
            self.sdcch_pool.append(ch)
            self._sdcch_busy[id(ch)] = False

    def add_tch(self, ch: channels.TCHFACCHL1) -> None:
        with self.lock:
            self.tch_pool.append(ch)
            self._tch_busy[id(ch)] = False

    def get_sdcch(self) -> Optional[channels.LogicalChannel]:
        """Allocate a free SDCCH (GSMConfig getSDCCH); None → congestion."""
        with self.lock:
            for ch in self.sdcch_pool:
                if not self._sdcch_busy[id(ch)]:
                    self._sdcch_busy[id(ch)] = True
                    return ch
            return None

    def get_tch(self) -> Optional[channels.TCHFACCHL1]:
        with self.lock:
            for ch in self.tch_pool:
                if not self._tch_busy[id(ch)]:
                    self._tch_busy[id(ch)] = True
                    return ch
            return None

    def release(self, ch) -> None:
        with self.lock:
            if id(ch) in self._sdcch_busy:
                self._sdcch_busy[id(ch)] = False
            if id(ch) in self._tch_busy:
                self._tch_busy[id(ch)] = False

    def sdcch_available(self) -> int:
        with self.lock:
            return sum(1 for ch in self.sdcch_pool
                       if not self._sdcch_busy[id(ch)])

    def tch_available(self) -> int:
        with self.lock:
            return sum(1 for ch in self.tch_pool
                       if not self._tch_busy[id(ch)])

    def sdcch_total(self) -> int:
        return len(self.sdcch_pool)

    def tch_total(self) -> int:
        return len(self.tch_pool)

    # -- T3122 access backoff (GSMConfig growT3122/shrinkT3122) --------
    def t3122(self) -> int:
        return int(self._t3122_s)

    def grow_t3122(self) -> None:
        self._t3122_s = min(self._t3122_s * 2, self.t3122_max_s)

    def shrink_t3122(self) -> None:
        self._t3122_s = max(self._t3122_s / 2, self.t3122_min_s)

    # -- beacon --------------------------------------------------------
    def si1(self) -> rr.SystemInformationType1:
        return rr.SystemInformationType1(
            rr.CellChannelDescription((self.arfcn or 1,)),
            rr.RACHControlParameters())

    def si2(self) -> rr.SystemInformationType2:
        neigh = tuple(
            int(x) for x in self.config.get_vector("GSM.Neighbors")
        ) if self.config.defines("GSM.Neighbors") else ()
        return rr.SystemInformationType2(
            rr.CellChannelDescription(neigh), ncc_permitted=0xFF,
            rach=rr.RACHControlParameters())

    def si4(self) -> rr.SystemInformationType4:
        return rr.SystemInformationType4(self.lai(),
                                         rach=rr.RACHControlParameters())

    def si_frame_for_tc(self, tc: int) -> L3Frame:
        """SI rotation by TC (BCCHL1Encoder::generate,
        GSML1FEC.cpp:977-996): 1,2,3,4,3,2,3,4."""
        seq = [self.si1, self.si2, self.si3, self.si4,
               self.si3, self.si2, self.si3, self.si4]
        return L3Frame(seq[tc % 8]().encode(), Primitive.UNIT_DATA)

    def si3(self) -> rr.SystemInformationType3:
        return rr.SystemInformationType3(
            cell_id=self.cell_id, lai=self.lai(),
            rach=rr.RACHControlParameters(),
            ccch_conf=1, t3212=self.config.get_int("GSM.T3212", 0))

    def si3_frame(self) -> L3Frame:
        return L3Frame(self.si3().encode(), Primitive.UNIT_DATA)

    def si5(self) -> rr.SystemInformationType5:
        return rr.SystemInformationType5(
            rr.CellChannelDescription((self.arfcn,)
                                      if 1 <= self.arfcn <= 124 else ()))

    def si6(self) -> rr.SystemInformationType6:
        return rr.SystemInformationType6(cell_id=self.cell_id,
                                         lai=self.lai())

    def sacch_fill_frame(self, which: int) -> L3Frame:
        """SI5/SI6 alternating SACCH downlink fill (GSMConfig
        mSI5Frame/mSI6Frame, GSMConfig.h:99-131)."""
        si = self.si5() if which % 2 == 0 else self.si6()
        return L3Frame(si.encode(), Primitive.UNIT_DATA)

    # -- CCCH scheduling ----------------------------------------------
    def send_agch(self, frame: L3Frame) -> None:
        self.agch_q.append(frame)

    def send_pch(self, frame: L3Frame) -> None:
        self.pch_q.append(frame)

    def next_ccch_frame(self) -> Optional[L3Frame]:
        """AGCH priority over PCH (GSMConfig getAGCH/getPCH drain)."""
        if self.agch_q:
            return self.agch_q.popleft()
        if self.pch_q:
            return self.pch_q.popleft()
        return None

    def next_agch_frame(self) -> Optional[L3Frame]:
        return self.agch_q.popleft() if self.agch_q else None

    def next_pch_frame(self) -> Optional[L3Frame]:
        return self.pch_q.popleft() if self.pch_q else None
