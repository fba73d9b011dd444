"""`prog_syncs_per_block` (`prog_syncs_per_block.py`), read alike, in a cell whose
end-to-end metric besides `setup_s` is the card's busy time
(`card_ms`)."""

from trxbench.metrics.prog_syncs_per_block import read  # noqa: F401
