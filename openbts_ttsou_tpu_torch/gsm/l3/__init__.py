"""L3 messages (GSM 04.08): RR / MM / CC codecs.

Reference behavior: `GSM/GSML3Message.{h,cpp}` (base + factory),
`GSML3CommonElements` (LAI, mobile identity), `GSML3RRMessages`,
`GSML3MMMessages`, `GSML3CCMessages` and their element files.
"""

from openbts_ttsou_tpu_torch.gsm.l3.codec import (  # noqa: F401
    BitReader,
    BitWriter,
    L3Message,
    L3PD,
    parse_l3,
)
from openbts_ttsou_tpu_torch.gsm.l3 import cc, common, mm, rr  # noqa: F401
