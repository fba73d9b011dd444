"""`ul_Msps` (`ul_Msps.py`), read alike, in a cell whose end-to-end metric
besides `setup_s` is the card's busy time (`card_ms`)."""

from trxbench.metrics.ul_Msps import read  # noqa: F401
