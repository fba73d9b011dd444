"""SIP/VoIP layer (reference: SIP/ over libosip2+libortp; here a
self-contained RFC 3261 subset with an RTP session)."""

from openbts_ttsou_tpu_torch.sip.message import SIPMessage, make_request, make_response  # noqa: F401
from openbts_ttsou_tpu_torch.sip.engine import SIPEngine, SIPState  # noqa: F401
