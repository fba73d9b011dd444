"""Native runtime bindings (ctypes over native/libtrx_runtime.so)."""

from openbts_ttsou_tpu_torch.runtime.native import (  # noqa: F401
    BurstQueue,
    SampleRing,
    UdpTransport,
    UnixDatagramTransport,
    load_runtime,
)
