"""Carry engine state between the JAX package and this port.

The system has no learned parameters: what carries over between the two
implementations is the engine state (`TrxState`, field for field), its
static `TrxConfig`, the resident layer 1's streaming carry
(`ResidentL1.carry()`), and the set-up constants, which the port
recomputes itself. These helpers move a state given as numpy arrays
(e.g. `{k: np.asarray(v) for k, v in jax_state._asdict().items()}`, or a
state file's arrays) onto a device, and back; `trx/state_io.py` uses them
to read and write the JAX package's state files.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from openbts_ttsou_tpu_torch.trx.engine import (TrxConfig, TrxState,
                                                resolve_device)

#: dtype of every TrxState field
FIELD_DTYPES = {
    "fn": np.int32,
    "chan_type": np.int32,
    "tsc": np.int32,
    "max_expected_delay": np.int32,
    "energy_threshold": np.float32,
    "prev_false_detect_fn": np.int32,
    "chan_valid": np.bool_,
    "chan_response": np.complex64,
    "chan_resp_offset": np.float32,
    "chan_amplitude": np.complex64,
    "snr": np.float32,
    "dfe_forward": np.complex64,
    "dfe_feedback": np.complex64,
    "chan_estimate_fn": np.int32,
    "filler": np.complex64,
}


def state_from_numpy(d, device="cuda") -> TrxState:
    """TrxState of tensors on `device` from a mapping (or NamedTuple) of
    array-likes with the TrxState field names."""
    if not isinstance(d, Mapping):
        d = d._asdict()
    missing = set(TrxState._fields) - set(d)
    if missing:
        raise KeyError(f"state lacks fields {sorted(missing)}")
    dev = resolve_device(device)
    return TrxState(**{
        name: torch.from_numpy(np.array(d[name], dtype=FIELD_DTYPES[name]))
        .to(dev) for name in TrxState._fields})


def state_to_numpy(state: TrxState) -> dict[str, np.ndarray]:
    """{field: numpy array} of a TrxState, on the host."""
    return {name: getattr(state, name).detach().cpu().numpy()
            for name in TrxState._fields}


def config_from_dict(d: Mapping) -> TrxConfig:
    """TrxConfig from its `_asdict()` after a JSON round trip, which
    turns the `rach_slots` tuple into a list."""
    d = dict(d)
    if d.get("rach_slots") is not None:
        d["rach_slots"] = tuple(d["rach_slots"])
    return TrxConfig(**d)


#: the TchTxCarry and XcchTxCarry fields of a resident carry, in tuple
#: order, with their dtypes
TCH_CARRY_FIELDS = (("tch_i_prev", np.uint8), ("tch_i_cur", np.uint8),
                    ("tch_facch_prev", np.bool_),
                    ("tch_facch_cur", np.bool_))
XCCH_CARRY_FIELDS = (("xcch_bits", np.uint8), ("xcch_valid", np.bool_))


def _host(x, dtype) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.array(x, dtype=dtype)


def resident_carry_to_numpy(carry: Mapping) -> dict[str, np.ndarray]:
    """A `ResidentL1.carry()` as a flat dict of numpy arrays: the TrxState
    (`state.<field>`), `fn`, `tx_tail`, both transmit carries
    (TCH_CARRY_FIELDS, XCCH_CARRY_FIELDS), `prev_soft` and `prev_valid`.
    Takes the port's carry or the JAX package's (its arrays convert with
    `np.asarray`)."""
    st = carry["state"]
    if not isinstance(st, Mapping):
        st = st._asdict()
    out = {f"state.{k}": _host(st[k], FIELD_DTYPES[k])
           for k in TrxState._fields}
    out["fn"] = np.array(int(carry["fn"]), np.int64)
    out["tx_tail"] = _host(carry["tx_tail"], np.complex64)
    tch, xcch = carry["tx_carry"]
    for (name, dtype), x in zip(TCH_CARRY_FIELDS + XCCH_CARRY_FIELDS,
                                tuple(tch) + tuple(xcch)):
        out[name] = _host(x, dtype)
    out["prev_soft"] = _host(carry["prev_soft"], np.float32)
    out["prev_valid"] = _host(carry["prev_valid"], np.bool_)
    return out


def resident_carry_from_numpy(d: Mapping, device="cuda") -> dict:
    """The carry `ResidentL1.restore()` takes, on `device`, from the dict
    of `resident_carry_to_numpy`."""
    dev = resolve_device(device)

    def t(name, dtype):
        return torch.from_numpy(np.array(d[name], dtype=dtype)).to(dev)

    return {
        "state": state_from_numpy(
            {k: d[f"state.{k}"] for k in TrxState._fields}, dev),
        "fn": int(d["fn"]),
        "tx_tail": t("tx_tail", np.complex64),
        "tx_carry": (tuple(t(n, dt) for n, dt in TCH_CARRY_FIELDS),
                     tuple(t(n, dt) for n, dt in XCCH_CARRY_FIELDS)),
        "prev_soft": t("prev_soft", np.float32),
        "prev_valid": t("prev_valid", np.bool_),
    }
