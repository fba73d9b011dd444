"""`dev_idle` (`dev_idle.py`), read alike, in a cell whose end-to-end metric
besides `setup_s` is the card's busy time (`card_ms`)."""

from trxbench.metrics.dev_idle import read  # noqa: F401
