"""`sync_wait_ms` (`sync_wait_ms.py`), read alike, in a cell whose
end-to-end metric besides `setup_s` is the card's busy time
(`card_ms`)."""

from trxbench.metrics.sync_wait_ms import read  # noqa: F401
