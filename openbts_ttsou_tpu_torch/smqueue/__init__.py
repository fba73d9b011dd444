"""SMS store-and-forward daemon (reference: smqueue/)."""

from openbts_ttsou_tpu_torch.smqueue.queue import ShortMsg, ShortMsgState, SMq  # noqa: F401
