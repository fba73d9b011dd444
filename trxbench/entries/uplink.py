"""Entry adapter: the uplink receive bank, `Transceiver.process_uplink`.

One call is one block of device-rate IQ for every carrier (13 frames,
24000 samples a carrier) through the port's exact receiver; its
`RxResult` (detections, RACH flags, soft bits, RSSI, TOA) is copied to
the host after every call.

The configuration file gives `carriers`, `frames`, `slots` (the channel
combination of TN 0-7, set on every carrier through `set_slot`), `tsc`
(`set_tsc`), `max_delay` (`set_max_delay`), `max_toa` (null: the full
TSC segment) and `rach_slots` (null: every slot). The traffic's
generator gives blocks of device-rate IQ and, for each, `detect`
[F, C, 8] and optionally `rach` [F, C, 8]: the bursts the receiver has
to detect, and those it has to flag as access bursts
(`trxbench/generators/bursts.py`).

Known answer, every call: every burst the generator expects is
detected (and flagged as RACH where it expects that). Reference (`trxbench/reference/rx.py`): each
sampled call's block through the benchmark's own resampler and the
frozen per-frame receiver, from the state the program held before the
call; the first call of the run starts from the reference's own
configured state. Compared: detection and RACH flags (count of bursts
that differ), soft bits, RSSI and TOA of bursts both sides detected
(widest gap), and the state after the call (widest gap over its fields,
relative to the field's largest value).
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

from trxbench import gaps
from trxbench.reference import rx as ref


class Entry:
    """The port's uplink receive bank behind the harness's calls."""

    def __init__(self, config: dict, device: torch.device):
        from openbts_ttsou_tpu_torch.models import transceiver as T
        from openbts_ttsou_tpu_torch.trx import engine as eng

        self.config = config
        self.device = device
        c = int(config["carriers"])
        self.n_chan = c
        rach = config.get("rach_slots")
        cfg = eng.TrxConfig(n_chan=c, max_toa=config.get("max_toa"),
                            rach_slots=None if rach is None else tuple(rach))
        self.trx = T.Transceiver(cfg, T.UplinkSpec(frames=int(
            config["frames"])), device)
        for chan in range(c):
            for tn, combo in enumerate(config["slots"]):
                self.trx.set_slot(chan, tn, int(combo))
            self.trx.set_tsc(chan, int(config["tsc"]))
            self.trx.set_max_delay(chan, int(config["max_delay"]))
        self.samples_per_call = c * self.trx.spec.block_in
        self.schedule = T.exact_schedule(c)
        self.host = gaps.HostCopy(device)

    # ---- inputs and the call ---------------------------------------------
    def make_inputs(self, generator, params: dict, seed: int
                    ) -> list[torch.Tensor]:
        pool = generator.make(params, self.config, seed, self.device)
        self.expect = pool["expect"]
        return pool["items"]

    def state(self):
        return self.trx.state

    def call(self, x: torch.Tensor):
        return self.trx.process_uplink(x)

    def to_host(self, out) -> tuple:
        return self.host(tuple(out))

    def known_misses(self, host: tuple, item: int) -> int:
        """Expected bursts not detected (or not flagged as RACH) in this
        call of pool item `item`."""
        exp = self.expect[item]
        misses = int((exp["detect"] & ~host[0].numpy()).sum())
        if "rach" in exp:
            misses += int((exp["rach"] & ~host[1].numpy()).sum())
        return misses

    def describe(self) -> dict:
        return {"exact_schedule": self.schedule}

    # ---- the comparison ----------------------------------------------------
    def _ref_config(self) -> ref.TrxConfig:
        rach = self.config.get("rach_slots")
        return ref.TrxConfig(n_chan=self.n_chan,
                             max_toa=self.config.get("max_toa"),
                             rach_slots=None if rach is None
                             else tuple(rach))

    def reference_state(self) -> ref.TrxState:
        c = self.config
        return ref.configured_state(self._ref_config(), c["slots"],
                                    int(c["tsc"]), int(c["max_delay"]),
                                    self.device)

    def reference(self, state_before, x: torch.Tensor, first: bool):
        """The reference's (state after, RxResult) for one call."""
        st = self.reference_state() if first else ref.TrxState(
            *gaps.moved(tuple(state_before), self.device))
        return ref.rx_block(self._ref_config(), st, x,
                            int(self.config["frames"]))

    @staticmethod
    def gaps_of(out, state_after, ref_state, ref_out) -> dict:
        """The numbers compared for one call (see the module docstring)."""
        det_p, rach_p, soft_p, rssi_p, toa_p = (t.to(ref_out[0].device)
                                                for t in out)
        det_r, rach_r, soft_r, rssi_r, toa_r = ref_out
        both = det_p & det_r
        flags = int(((det_p != det_r) | (rach_p != rach_r)).sum())

        def widest(a, b, mask):
            d = (a.double() - b.double()).abs()
            if d.ndim > mask.ndim:
                mask = mask[..., None].expand_as(d)
            d = torch.where(mask, d, torch.zeros_like(d))
            return float(d.max()) if d.numel() else 0.0

        state = gaps.state_gap(zip(ref.TrxState._fields, state_after,
                                   ref_state))
        return {"flag_diffs": flags,
                "soft_gap": widest(soft_p, soft_r, both),
                "rssi_gap": widest(rssi_p, rssi_r, both),
                "toa_gap": widest(toa_p, toa_r, both),
                "state_gap": state}

    def compare(self, kept: list, pool: list) -> dict:
        """Worst of each number over the kept calls. kept: dicts with
        `first`, `item`, `state_before`, `state_after` and `out` (the
        outputs as copied to the host)."""
        worst: dict = {}
        for k in kept:
            ref_state, ref_out = self.reference(k["state_before"],
                                                pool[k["item"]], k["first"])
            g = self.gaps_of(k["out"], k["state_after"], ref_state, ref_out)
            for name, v in g.items():
                worst[name] = max(worst.get(name, 0.0), float(v))
            del ref_state, ref_out
        return worst

    def release(self) -> None:
        """Drop the program's own objects once the window has closed."""
        self.trx = None
        self.host = None


# ---- faults planted in the timed path, for the check of the comparison ----

FAULTS = ("stale_state", "half_batch", "altered_answer")


@contextlib.contextmanager
def fault(name: str) -> Iterator[None]:
    """Break the port's `uplink_block` while the block runs:
    `stale_state` returns the state it was given; `half_batch` leaves the
    upper half of the carriers out (nothing detected there);
    `altered_answer` alters one burst's soft bit, RSSI and TOA where they
    are produced."""
    from openbts_ttsou_tpu_torch.models import transceiver as T

    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")
    inner = T.uplink_block

    def broken(cfg, spec, state, samples):
        st2, res = inner(cfg, spec, state, samples)
        if name == "stale_state":
            return state, res
        det, rach, soft, rssi, toa = (t.clone() for t in res)
        if name == "half_batch":
            h = cfg.n_chan // 2
            det[:, h:] = False
            rach[:, h:] = False
            soft[:, h:] = 0.5
            rssi[:, h:] = 0
            toa[:, h:] = 0
        else:
            f, c, tn = 0, 0, int(det[0, 0].to(torch.int8).argmax())
            soft[f, c, tn, 10] = 1.0 - soft[f, c, tn, 10]
            rssi[f, c, tn] += 1
            toa[f, c, tn] += 1
        return st2, type(res)(det, rach, soft, rssi, toa)

    T.uplink_block = broken
    try:
        yield
    finally:
        T.uplink_block = inner
