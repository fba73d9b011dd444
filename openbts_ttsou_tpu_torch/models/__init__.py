"""End-to-end pipeline models: the multi-carrier Transceiver, and
ResidentL1, the streaming host API of the resident BTS layer 1 (FEC in
both directions on the device)."""

from openbts_ttsou_tpu_torch.models.resident import ResidentL1  # noqa: F401
from openbts_ttsou_tpu_torch.models.transceiver import Transceiver  # noqa: F401
