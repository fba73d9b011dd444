"""Host-side streaming wrapper for the resident BTS layer 1.

Port of `openbts_ttsou_tpu/models/resident.py`. `duplex_block_decoded`
(models/transceiver.py) runs FEC in both directions for one 13-frame
window on the card, but it threads FIVE pieces of cross-window streaming
state (the engine TrxState, the tx symbol tail, the TCH diagonal-
interleaver carry, the streaming XCCH tx grid carry, and the rx soft-bit
decode prelude) plus the FN%4 phase that picks the XCCH grid layout.
`ResidentL1` owns all of that, so a consumer pushes one window of
downlink CONTENT (L2 frames and vocoder bits) and uplink SAMPLES per
step and receives the device-rate tx stream and the window's decodes:
the L2-frames-in / L2-frames-out contract the reference's GSML1FEC
presents to the SAP mux (GSML1FEC.h:81,343), with the whole layer below
it (coding, interleaving, GMSK, resampling, detection, demodulation,
Viterbi) resident on the device.

Checkpoint/resume: `carry()` returns the complete streaming state as
one dict; `restore()` installs it (`convert.resident_carry_to_numpy` /
`resident_carry_from_numpy` carry it between devices and packages).
"""

from __future__ import annotations

import numpy as np
import torch

from openbts_ttsou_tpu_torch.gsm import l1fec
from openbts_ttsou_tpu_torch.models import transceiver as M
from openbts_ttsou_tpu_torch.trx import engine as eng
from openbts_ttsou_tpu_torch.utils.gsm_time import HYPERFRAME
from openbts_ttsou_tpu_torch.utils.profiling import span


class ResidentL1:
    """Streams `duplex_block_decoded` window by window.

    `cfg`/`spec` fix the geometry, `bsic` the RACH color code,
    `xcch_tns`/`tch_tns` the static slot split (decode_block docstring).
    `fn0` is the first window's frame number; each `step` advances it by
    `spec.frames`. Runs on `device`, CUDA unless the caller names another
    (raises when CUDA is asked for and absent). The frame number stays a
    host int; each step writes it to the device as the state's `fn`.
    """

    def __init__(self, cfg: eng.TrxConfig, spec: M.UplinkSpec | None = None,
                 bsic: int = 0, xcch_tns: tuple | None = None,
                 tch_tns: tuple | None = None,
                 state: eng.TrxState | None = None, fn0: int = 0,
                 device="cuda"):
        self.device = eng.resolve_device(device)
        self.cfg = cfg
        self.spec = spec or M.UplinkSpec()
        self.bsic = bsic
        self.xcch_tns = xcch_tns
        self.tch_tns = tch_tns
        c, dev = cfg.n_chan, self.device
        self.state = state if state is not None else eng.init_state(cfg, dev)
        self.fn = int(fn0) % HYPERFRAME
        self.tx_tail = torch.zeros((c, M.TX_TAIL_SYM), dtype=torch.complex64,
                                   device=dev)
        self.tx_carry = (l1fec.TchTxCarry.zeros(c * 8, dev),
                         M.XcchTxCarry.zeros(c, dev))
        self.prev_soft = torch.zeros((M.DECODE_PRELUDE, c, 8, 148),
                                     dtype=torch.float32, device=dev)
        self.prev_valid = torch.zeros((), dtype=torch.bool, device=dev)

    # -- streaming state as one dict (checkpoint/resume) ---------------
    def carry(self) -> dict:
        return {"state": self.state, "fn": self.fn,
                "tx_tail": self.tx_tail, "tx_carry": self.tx_carry,
                "prev_soft": self.prev_soft,
                "prev_valid": self.prev_valid}

    def restore(self, carry: dict) -> None:
        self.state = carry["state"]
        self.fn = int(carry["fn"]) % HYPERFRAME
        self.tx_tail = carry["tx_tail"]
        self.tx_carry = carry["tx_carry"]
        self.prev_soft = carry["prev_soft"]
        self.prev_valid = carry["prev_valid"]

    def _dev(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    @span("l1.step")
    def step(self, ul_halo, dl_content, atten_db=None):
        """One 13-frame window.

        ul_halo: [C, block_in + 2·RX_HALO_DEV] complex64 device-rate
        uplink (the caller's stream slice, RX_HALO_DEV of context each
        side, the daemon's halo'd read); dl_content: the 7-tuple of
        `_encode_dl_window`'s streaming layout (frames184 [4, C, 8, 184]
        on the ABSOLUTE FN%4 grid, xcch_valid, speech, sp_valid, facch,
        fa_valid, tch_mask); atten_db: [F, C, 8] float32 per-burst
        attenuation (zeros when omitted). Arrays may be numpy or tensors.

        Returns (tx [C, block_in] device-rate downlink, DecodedBlocks)."""
        spec = self.spec
        if atten_db is None:
            atten_db = torch.zeros((spec.frames, self.cfg.n_chan, 8),
                                   dtype=torch.float32, device=self.device)
        fn = self.fn
        fn_t = torch.full((), fn, dtype=torch.int32, device=self.device)
        st = self.state._replace(fn=fn_t)
        (st2, tx, tail2, blocks, carry2, prev2,
         pvalid2) = M.duplex_block_decoded(
            self.cfg, spec, st, self._dev(ul_halo), self.tx_tail,
            tuple(self._dev(x) for x in dl_content), self._dev(atten_db),
            self.tx_carry, fn_t, self.prev_soft, self.prev_valid,
            self.bsic, fn % 4, self.xcch_tns, self.tch_tns)
        self.state = st2
        self.tx_tail = tail2
        self.tx_carry = carry2
        self.prev_soft = prev2
        self.prev_valid = pvalid2
        self.fn = (fn + spec.frames) % HYPERFRAME
        return tx, blocks

    # -- downlink content helpers --------------------------------------
    def empty_content(self, tch_mask: np.ndarray) -> tuple:
        """An all-idle window's dl_content (filler everywhere)."""
        c, dev = self.cfg.n_chan, self.device

        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return (z((4, c, 8, 184), torch.uint8), z((4, c, 8), torch.bool),
                z((3, c, 8, 260), torch.uint8), z((3, c, 8), torch.bool),
                z((3, c, 8, 184), torch.uint8), z((3, c, 8), torch.bool),
                torch.as_tensor(np.asarray(tch_mask, bool), device=dev))

    def xcch_group_slots(self) -> list[int]:
        """Local start frames of the groups the CURRENT window transmits
        on the absolute FN%4 grid: group g starts at local frame
        ((-fn) % 4) + 4g, and the caller fills frames184[g] for each start
        listed, all ≤ frames − 1 (a group may end in the next window,
        through the tx carry). A group starting at or past the window's
        end is the next window's group 0: filled here, it would never be
        sent."""
        off = (-self.fn) % 4
        return [off + 4 * g for g in range(4)
                if off + 4 * g < self.spec.frames]
