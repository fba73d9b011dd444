"""Entry adapter: the resident layer 1, `ResidentL1.step`.

One call is one 13-frame window both ways for every carrier: the
window's downlink content (L2 frames, speech, FACCH) through the FEC
encoder, GMSK and the 96/65 resampler to device-rate IQ, and the
window's device-rate uplink (with its halos) through the 65/96
resampler, the exact receiver and the FEC decoders. Its outputs, the
downlink samples and the `DecodedBlocks`, are copied to the host after
every call.

The configuration file gives `carriers`, `frames`, `slots` (the channel
combination of TN 0-7 in the engine state), `tsc`, `max_delay`, `bsic`,
`xcch_tns` and `tch_tns`; the traffic's generator gives one period of
windows, cycled window by window, the uplink content it coded, and the
carriers received well above sensitivity (`clean`;
`trxbench/generators/coded.py`).

Known answer, every call, on the clean carriers: the decoded frames
(speech where `tch_good`, FACCH where `facch_ok`, L2 frames where `ok`)
are frames the uplink carried, none twice in a period, no RACH is
reported, and each whole period of windows in steady state decodes every
frame the uplink carried exactly once. Reference, from the layer's
carried state before each sampled call (the first call of the run from
the reference's own initial state): the downlink window through the
reference coder and transmitter (`trxbench/reference/tx.py`), and the
uplink window through the benchmark's resampler, the frozen receiver and
the frozen decoders (`trxbench/reference/decode.py`), on every carrier.
Compared: the downlink samples (widest gap over the full scale), the
decodes (units that differ in any bit or flag, a carrier: the
near-sensitivity carriers hold the Viterbi decoder to the reference
where it corrects errors), the soft bits the layer carries to the next window (its last
8 frames), and the carried state (the engine state, the tx tail, both
encoder carries; widest gap as for the uplink bank).
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import numpy as np
import torch

from trxbench import gaps, generate
from trxbench.reference import coding, fir
from trxbench.reference import decode as refdec
from trxbench.reference import rx as ref
from trxbench.reference import tx as reftx

PRELUDE = 8  # frames of soft bits the layer carries to the next window
TX_FULL_SCALE = 13500.0
#: multipliers of the frame hash (odd, 64-bit)
_MIX = np.array([0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F,
                 0x165667B19E3779F9, 0xD6E8FEB86659FD93], np.uint64)


def frame_hashes(kind: int, bits: np.ndarray, mask: np.ndarray
                 ) -> np.ndarray:
    """A 64-bit hash of (kind, carrier, slot, bits) for every frame
    bits[g, c, tn] where mask[g, c, tn]."""
    g, ch, tn = np.nonzero(mask)
    packed = np.packbits(bits[g, ch, tn], axis=-1)
    pad = (-packed.shape[-1]) % 8
    words = np.pad(packed, ((0, 0), (0, pad))).view("<u8")
    with np.errstate(over="ignore"):
        h = (np.uint64(kind) * _MIX[0] + ch.astype(np.uint64) * _MIX[1]
             + tn.astype(np.uint64) * _MIX[2])
        for k in range(words.shape[1]):
            h = (h ^ words[:, k]) * _MIX[3]
            h ^= h >> np.uint64(29)
    return h


def content_hashes(content: tuple, clean: np.ndarray) -> np.ndarray:
    """The hashes of the frames `content` carries on the `clean`
    carriers."""
    x, xv, sp, spv, fa, fav, _ = (t.cpu().numpy() for t in content)
    on = clean[None, :, None]
    return np.concatenate([frame_hashes(0, sp, spv & on),
                           frame_hashes(1, fa, fav & on),
                           frame_hashes(2, x, xv & on)])


class Entry:
    """The port's resident layer 1 behind the harness's calls."""

    def __init__(self, config: dict, device: torch.device):
        from openbts_ttsou_tpu_torch.trx import engine as eng

        self.config = config
        self.device = device
        c = int(config["carriers"])
        self.n_chan = c
        self.xt = tuple(config["xcch_tns"])
        self.tt = tuple(config["tch_tns"])
        rach = config.get("rach_slots")
        self.rach = None if rach is None else tuple(rach)
        self.cfg = eng.TrxConfig(n_chan=c, max_toa=config.get("max_toa"),
                                 rach_slots=self.rach)
        self.fn0 = 0
        self.layer = None
        self.samples_per_call = c * 24000
        self.host = gaps.HostCopy(device)
        self._sent = None
        self._calls = 0
        self._group: list = []

    def _configure(self, layer) -> None:
        st = layer.state
        ct = torch.tensor(self.config["slots"], dtype=torch.int32,
                          device=self.device).expand(self.n_chan, 8)
        layer.state = st._replace(
            chan_type=ct.clone(),
            tsc=torch.full_like(st.tsc, int(self.config["tsc"])),
            max_expected_delay=torch.full_like(
                st.max_expected_delay, int(self.config["max_delay"])))

    # ---- inputs and the call ---------------------------------------------
    def make_inputs(self, generator, params: dict, seed: int) -> list:
        pool = generator.make(params, self.config, seed, self.device)
        items, expect = pool["items"], pool["expect"]
        self.fn0 = int(params["fn0"])
        self.period = self.min_calls = len(items)
        self.clean = np.asarray(expect["clean"], bool)
        self._sent = np.sort(np.concatenate(
            [content_hashes(c, self.clean)
             for c in expect["uplink_content"]]))
        self._sent_weak = np.sort(np.concatenate(
            [content_hashes(c, ~self.clean)
             for c in expect["uplink_content"]]))
        self._weak_decoded = 0
        from openbts_ttsou_tpu_torch.models.resident import ResidentL1

        self.layer = ResidentL1(self.cfg, bsic=int(self.config["bsic"]),
                                xcch_tns=self.xt, tch_tns=self.tt,
                                fn0=self.fn0, device=self.device)
        self._configure(self.layer)
        return items

    def state(self) -> dict:
        return self.layer.carry()

    def call(self, item):
        ul, dl = item
        return self.layer.step(ul, dl)

    def to_host(self, out) -> tuple:
        tx, blocks = out
        return self.host((tx,) + tuple(blocks))

    def known_misses(self, host: tuple, item: int) -> int:
        """Problems the decodes of this call show on the clean carriers: a
        frame never sent, one decoded twice in a period, a RACH reported;
        at the end of each whole period in steady state, a frame sent and
        not decoded."""
        b = dict(zip(refdec.Decoded._fields, (t.numpy() for t in host[1:])))
        on = self.clean[None, :, None]
        got = np.concatenate([
            frame_hashes(0, b["tch_speech"], b["tch_good"] & on),
            frame_hashes(1, b["facch_bits"], b["facch_ok"] & on),
            frame_hashes(2, b["bits"], b["ok"] & on)])
        misses = int((b["rach_ok"] & on).sum())
        weak = np.concatenate([
            frame_hashes(0, b["tch_speech"], b["tch_good"] & ~on),
            frame_hashes(1, b["facch_bits"], b["facch_ok"] & ~on),
            frame_hashes(2, b["bits"], b["ok"] & ~on)])
        self._weak_decoded += int(np.isin(weak, self._sent_weak).sum())
        misses += int((~np.isin(got, self._sent)).sum())
        self._group.append(got)
        self._calls += 1
        if self._calls % self.period == 0:
            misses += self._close_group(whole=self._calls > self.period)
        return misses

    def _close_group(self, whole: bool) -> int:
        """Duplicates in the period's decodes; where the period is whole
        and steady (not the first), every frame sent decoded."""
        got = np.sort(np.concatenate(self._group)) if self._group \
            else np.zeros(0, np.uint64)
        self._group = []
        misses = int(len(got) - len(np.unique(got)))
        if whole:
            misses += int((~np.isin(self._sent, got)).sum())
        return misses

    def finish(self) -> int:
        """The last, partial period's duplicates."""
        return self._close_group(whole=False)

    def describe(self) -> dict:
        from openbts_ttsou_tpu_torch.models import transceiver as T

        return {"exact_schedule": T.exact_schedule(self.n_chan),
                "frames_sent_a_period_clean": int(len(self._sent)),
                "weak_carriers": int((~self.clean).sum()),
                "weak_frames_decoded_share": self._weak_decoded
                / max(1, len(self._sent_weak) * self._calls
                      / self.period)}

    # ---- the comparison ----------------------------------------------------
    def _ref_config(self) -> ref.TrxConfig:
        return ref.TrxConfig(n_chan=self.n_chan,
                             max_toa=self.config.get("max_toa"),
                             rach_slots=self.rach)

    def reference_carry(self) -> dict:
        """The layer's carried state at the run's start, worked out by the
        reference."""
        c, dev = self.n_chan, self.device
        st = ref.configured_state(self._ref_config(), self.config["slots"],
                                  int(self.config["tsc"]),
                                  int(self.config["max_delay"]), dev)
        return {"state": st, "fn": self.fn0,
                "tx_tail": torch.zeros((c, reftx.TX_TAIL_SYM),
                                       dtype=torch.complex64, device=dev),
                "tx_carry": (coding.TchTxCarry.zeros(c * 8, dev),
                             reftx.xcch_carry_zeros(c, dev)),
                "prev_soft": torch.zeros((PRELUDE, c, 8, 148),
                                         dtype=torch.float32, device=dev),
                "prev_valid": torch.zeros((), dtype=torch.bool, device=dev)}

    def reference(self, carry: dict, item, first: bool) -> tuple:
        """(carry after, outputs) of the reference for one call: the
        downlink samples and the 12 fields of the decodes, as the host
        copy of the layer's outputs holds them."""
        carry = self.reference_carry() if first else gaps.moved(
            carry, self.device)
        ul, dl = item
        own = self.reference_carry()["state"]  # its own filler and TSCs
        fn = int(carry["fn"])
        tch_carry, xcch_carry = carry["tx_carry"]
        bits, valid, tch2, xcch2 = reftx.encode_window(
            dl, tch_carry, xcch_carry, fn, own.tsc, self.xt, self.tt)
        slots = reftx.tx_frames(bits, valid, TX_FULL_SCALE, own.filler)
        tx, tail = reftx.tx_window(reftx.assemble(slots), carry["tx_tail"],
                                   24000)
        sym = fir.resample(ul, ref.UL_P, ref.UL_Q,
                           fir.resampler_lpf(ref.UL_P, ref.UL_Q, ref.UL_TAPS))
        start = generate.RX_HALO_DEV * ref.UL_P // ref.UL_Q
        st = ref.TrxState(*carry["state"])._replace(
            fn=torch.tensor(fn, dtype=torch.int32, device=self.device))
        st2, res = ref.rx_symbols(self._ref_config(), st, sym[..., start:])
        decoded = refdec.decode_window(
            res.soft_bits, res.is_rach, fn, carry["prev_soft"],
            bool(carry["prev_valid"]), int(self.config["bsic"]), self.xt,
            self.tt, self.rach)
        after = {"state": st2, "fn": (fn + 13) % ref.HYPERFRAME,
                 "tx_tail": tail, "tx_carry": (tch2, xcch2),
                 "prev_soft": res.soft_bits[-PRELUDE:],
                 "prev_valid": torch.ones((), dtype=torch.bool,
                                          device=self.device)}
        return after, (tx,) + tuple(decoded)

    @staticmethod
    def _flat_carry(carry: dict) -> list:
        tch, xcch = carry["tx_carry"]
        return (list(zip(ref.TrxState._fields, carry["state"]))
                + [("tx_tail", carry["tx_tail"])]
                + [(f"tch_carry{i}", t) for i, t in enumerate(tch)]
                + [(f"xcch_carry{i}", t) for i, t in enumerate(xcch)])

    def gaps_of(self, out, carry_after: dict, ref_after: dict, ref_out
                ) -> dict:
        """The numbers compared for one call. out: the downlink samples
        and the 12 fields of the decodes."""
        ref_tx, ref_dec = ref_out[0], refdec.Decoded(*ref_out[1:])
        tx = out[0].to(ref_tx.device)
        ref_flat = dict(self._flat_carry(ref_after))
        state = gaps.state_gap((name, p, ref_flat[name]) for name, p
                               in self._flat_carry(carry_after))
        soft = carry_after["prev_soft"].to(ref_tx.device)
        return {"tx_gap": float((tx - ref_tx).abs().max()) / TX_FULL_SCALE,
                "soft_gap": float((soft.double()
                                   - ref_after["prev_soft"].double())
                                  .abs().max()),
                "decode_diffs_per_carrier": refdec.differences(
                    out[1:], ref_dec) / self.n_chan,
                "state_gap": state}

    def compare(self, kept: list, pool: list) -> dict:
        worst: dict = {}
        for k in kept:
            ref_after, ref_out = self.reference(k["state_before"],
                                                pool[k["item"]], k["first"])
            after = dict(k["state_after"])
            g = self.gaps_of(k["out"], after, ref_after, ref_out)
            # the layer's frame number, kept on the host, advances by 13
            moved = (int(after["fn"]) - int(k["state_before"]["fn"])) \
                % ref.HYPERFRAME
            g["state_gap"] = max(g["state_gap"], float(abs(moved - 13)))
            for name, v in g.items():
                worst[name] = max(worst.get(name, 0.0), float(v))
            del ref_after, ref_out
        return worst

    def release(self) -> None:
        self.layer = None
        self.host = None


# ---- faults planted in the timed path, for the check of the comparison ----

FAULTS = ("stale_state", "half_batch", "altered_answer", "hard_decision")


@contextlib.contextmanager
def fault(name: str) -> Iterator[None]:
    """Break the port's layer 1 while the block runs:
    `stale_state` returns the state and carries it was given;
    `half_batch` leaves the upper half of the carriers' decodes out;
    `altered_answer` flips one decoded bit and alters one downlink
    sample where they are produced (all three in `duplex_block_decoded`);
    `hard_decision` slices the Viterbi decoder's soft input to 0 and 1
    (`gsm/fec.py` `viterbi_decode`), a shortcut that decodes clean
    frames alike and loses frames near sensitivity."""
    from openbts_ttsou_tpu_torch.gsm import fec
    from openbts_ttsou_tpu_torch.models import transceiver as T

    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")
    if name == "hard_decision":
        viterbi = fec.viterbi_decode

        def sliced(soft):
            return viterbi((soft > 0.5).to(torch.float32))

        fec.viterbi_decode = sliced
        try:
            yield
        finally:
            fec.viterbi_decode = viterbi
        return
    inner = T.duplex_block_decoded

    def broken(cfg, spec, state, ul_halo, tx_tail, dl_content, atten_db,
               tx_carry, fn0_dl, prev_soft, prev_valid, *args, **kw):
        out = inner(cfg, spec, state, ul_halo, tx_tail, dl_content,
                    atten_db, tx_carry, fn0_dl, prev_soft, prev_valid,
                    *args, **kw)
        st2, tx, tail2, blocks, carry2, prev2, pv2 = out
        if name == "stale_state":
            return (state, tx, tx_tail, blocks, tx_carry, prev_soft,
                    prev_valid)
        b = blocks._asdict()
        if name == "half_batch":
            h = cfg.n_chan // 2
            for k in ("ok", "tch_good", "facch_ok"):
                b[k] = b[k].clone()
                b[k][:, h:] = False
        else:
            b["bits"] = b["bits"].clone()
            b["bits"][:, 0, :, 5] ^= 1
            tx = tx.clone()
            tx[0, 100] += 1000.0
        return (st2, tx, tail2, type(blocks)(**b), carry2, prev2, pv2)

    T.duplex_block_decoded = broken
    try:
        yield
    finally:
        T.duplex_block_decoded = inner
