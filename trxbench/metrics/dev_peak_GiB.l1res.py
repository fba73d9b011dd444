"""`dev_peak_GiB` (`dev_peak_GiB.py`), read alike, in a cell whose end-to-end metric
besides `setup_s` is the card's busy time (`card_ms`)."""

from trxbench.metrics.dev_peak_GiB import read  # noqa: F401
