"""Native runtime bindings (ctypes over the library built from
`csrc/runtime/` into `build/native/`)."""

from openbts_ttsou_tpu_torch.runtime.native import (  # noqa: F401
    BurstQueue,
    SampleRing,
    UdpTransport,
    UnixDatagramTransport,
    load_runtime,
)
