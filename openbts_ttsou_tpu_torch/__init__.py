"""PyTorch/CUDA port of the GSM transceiver's exact uplink chain.

Mirrors the module layout of `openbts_ttsou_tpu` (the JAX reference) so
each function's counterpart sits at the same path. The package imports
`torch` and numpy only; its entry points run on the GPU (`device="cuda"`)
unless the caller asks for the CPU.
"""
