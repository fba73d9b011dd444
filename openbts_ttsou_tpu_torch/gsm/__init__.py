"""GSM bit-level stack: FEC, TDMA mappings and the L1 codecs
(reference: GSM/)."""
