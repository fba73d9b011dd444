"""`k1_roofline` (`k1_roofline.py`), read alike, in a cell whose end-to-end metric
besides `setup_s` is the card's busy time (`card_ms`)."""

from trxbench.metrics.k1_roofline import read  # noqa: F401
