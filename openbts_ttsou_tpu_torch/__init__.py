"""PyTorch/CUDA port of the GSM software transceiver and its BTS.

Mirrors the module layout of `openbts_ttsou_tpu` (the JAX reference) so
each function's counterpart sits at the same path: the transceiver
(`ops`, `trx`, `models`, `parallel`), the layer-1 FEC (`gsm.fec`,
`gsm.l1fec`, `gsm.channels`) and the BTS host stack above it (`gsm`
LAPDm/L3/TRX manager, `control`, `sip`, `sms`, `cli`, `apps`). The
package imports `torch` and numpy only; its entry points run on the GPU
(`device="cuda"`) unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
