"""Standalone bus-server process: N software USRPs behind one AF_UNIX
socket.

Runs `serve_bus` over `SimBus` instances in its OWN process so the
`Bus.read/write` seam is exercised across the process/transport
boundary where a libusb backend would sit (USRPDevice.cpp:318-505's
usb fastpath). The client side is `SocketBus`. The port's own copy of
`openbts_ttsou_tpu/trx/bus_server.py`; it needs no device.

    python -m openbts_ttsou_tpu_torch.trx.bus_server \
        --socket usrp.sock --carriers 2 --hw-delay 98304 \
        [--stimulus bank.npy]

--stimulus: an int16 .npy of shape [T, 2] (or [C, T, 2] for
per-carrier banks) tiled periodically into each rx stream — planted
uplink bursts for receive tests, independent of tx loopback.
"""

from __future__ import annotations

import argparse

import numpy as np

from openbts_ttsou_tpu_torch.trx.usrp import SimBus, serve_bus


def main() -> None:
    ap = argparse.ArgumentParser(description="software USRP bus server")
    ap.add_argument("--socket", required=True)
    ap.add_argument("--carriers", type=int, default=1)
    ap.add_argument("--hw-delay", type=int, default=100)
    ap.add_argument("--noise-std", type=float, default=0.0)
    ap.add_argument("--stimulus", default=None)
    args = ap.parse_args()

    stim = None
    if args.stimulus:
        stim = np.load(args.stimulus)
    buses = []
    for c in range(args.carriers):
        s = None
        if stim is not None:
            s = stim[c] if stim.ndim == 3 else stim
        buses.append(SimBus(hw_delay=args.hw_delay,
                            noise_std=args.noise_std, stimulus=s))
    serve_bus(args.socket, buses)


if __name__ == "__main__":
    main()
