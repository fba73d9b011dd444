"""SMS codecs: GSM 04.11 CP/RP and GSM 03.40 TL (reference: SMS/)."""

from openbts_ttsou_tpu_torch.sms.messages import (  # noqa: F401
    CPAck,
    CPData,
    CPError,
    RPAck,
    RPData,
    RPError,
    TLDeliver,
    TLSubmit,
    pack_7bit,
    unpack_7bit,
)
