"""Engine state checkpoint/resume.

The reference has no signal-state checkpointing (a transceiver restart
is cold with a random start FN, Transceiver.cpp:48). All stream state is
one explicit `TrxState`, so a checkpoint is that state plus the static
config, and a reloaded stream resumes with its adaptive thresholds,
channel estimates and filler table.

The file is the JAX package's `.npz` layout (`openbts_ttsou_tpu/trx/
state_io.py`): one array per TrxState field plus `__config__`, the
TrxConfig as UTF-8 JSON bytes. A state file written by either package
loads in the other.
"""

from __future__ import annotations

import json

import numpy as np

from openbts_ttsou_tpu_torch import convert
from openbts_ttsou_tpu_torch.trx import engine as eng


def save_state(path: str, cfg: eng.TrxConfig, state: eng.TrxState) -> None:
    arrays = convert.state_to_numpy(state)
    arrays["__config__"] = np.frombuffer(
        json.dumps(cfg._asdict()).encode(), np.uint8)
    np.savez(path, **arrays)


def load_state(path: str, device="cuda"
               ) -> tuple[eng.TrxConfig, eng.TrxState]:
    """(config, state on `device`) from a state file. Raises when CUDA is
    asked for and absent."""
    with np.load(path) as data:
        cfg = convert.config_from_dict(
            json.loads(bytes(data["__config__"]).decode()))
        arrays = {name: data[name] for name in eng.TrxState._fields}
    return cfg, convert.state_from_numpy(arrays, device)
