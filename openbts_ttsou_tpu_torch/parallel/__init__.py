"""Block-streaming helpers (overlap-save halos)."""
