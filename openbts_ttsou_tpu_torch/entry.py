"""The single-card forward check, the counterpart of `__graft_entry__.entry()`:
one full-frame receive (energy gate → TSC/RACH correlate → channel
estimate/DFE → demod) for 4 carriers × 8 timeslots through the port's
`rx_step`, at the symbol rate (K1 is not on this path).

    fn, (state, frame) = entry()            # on cuda
    state2, result = fn(state, frame)
"""

from __future__ import annotations

import numpy as np
import torch


def entry(device="cuda"):
    """(fn, (state, frame)): `rx_step` at `TrxConfig(n_chan=4)`, slot 0
    combination IV and 1-7 combination I, on a frame of complex Gaussian
    noise ×400 from `default_rng(0)`, on `device` (CUDA unless the caller
    names another; raises without it)."""
    from openbts_ttsou_tpu_torch.trx.engine import (SLOT_SAMPLES, ChanType,
                                                    TrxConfig, init_state,
                                                    resolve_device, rx_step)

    dev = resolve_device(device)
    cfg = TrxConfig(n_chan=4)
    chan_type = torch.full((4, 8), ChanType.I, dtype=torch.int32)
    chan_type[:, 0] = ChanType.IV  # RACH slot
    state = init_state(cfg, dev)._replace(chan_type=chan_type.to(dev))
    rng = np.random.default_rng(0)
    frame = torch.from_numpy(
        (rng.standard_normal((4, 8, SLOT_SAMPLES))
         + 1j * rng.standard_normal((4, 8, SLOT_SAMPLES))
         ).astype(np.complex64) * 400.0).to(dev)

    def fn(state, frame):
        return rx_step(cfg, state, frame)

    return fn, (state, frame)
