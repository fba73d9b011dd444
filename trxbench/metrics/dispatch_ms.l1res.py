"""`dispatch_ms` (`dispatch_ms.py`), read alike, in a cell whose end-to-end metric
besides `setup_s` is the card's busy time (`card_ms`)."""

from trxbench.metrics.dispatch_ms import read  # noqa: F401
