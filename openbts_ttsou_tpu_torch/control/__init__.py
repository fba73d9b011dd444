"""Control layer: GSM 04.08 procedures and shared state
(reference: Control/)."""
