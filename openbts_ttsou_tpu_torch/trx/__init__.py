"""The transceiver engine (reference: Transceiver52M/Transceiver.{h,cpp}).

A pair of step functions, `rx_step` / `tx_step`, batched over
`[channel, timeslot]` with all per-slot state in an explicit `TrxState`
of tensors; the daemon (`trx/daemon.py`) serves them over the
reference's UDP wire protocol.
"""

from openbts_ttsou_tpu_torch.trx.engine import (  # noqa: F401
    ChanType,
    CorrType,
    TrxConfig,
    TrxState,
    expected_corr_type,
    init_state,
    rx_step,
    tx_step,
)
