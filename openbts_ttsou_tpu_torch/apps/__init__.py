"""Top-level applications (reference: apps/)."""
