"""Transceiver control-plane ping (the reference's USRPping): sends each
control verb to a daemon's control port and reports the response and
its round-trip time. A host tool: `--device` is checked like every
tool's, and nothing runs on it.

    python -m openbts_ttsou_tpu_torch.tools.trx_ping [--base-port 5700]
"""

from __future__ import annotations

import time

from openbts_ttsou_tpu_torch.tools import common

TOOL = "trx_ping"
VERBS = (("RXTUNE", (890000,)), ("TXTUNE", (935000,)), ("SETTSC", (0,)),
         ("POWEROFF", ()))


def main(argv=None) -> dict:
    from openbts_ttsou_tpu_torch.runtime import UdpTransport
    from openbts_ttsou_tpu_torch.trx import protocol as proto

    ap = common.parser(__doc__)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--base-port", type=int, default=5700)
    ap.add_argument("--local-port", type=int, default=5801)
    ap.add_argument("--timeout-ms", type=int, default=2000)
    args = ap.parse_args(argv)
    dev = common.device_of(args)
    sock = UdpTransport(args.local_port, args.host, args.base_port + 1)
    verbs = {}
    try:
        for verb, vargs in VERBS:
            t0 = time.perf_counter()
            sock.send(proto.pack_command(verb, *vargs))
            resp = sock.recv(256, timeout_ms=args.timeout_ms)
            dt = (time.perf_counter() - t0) * 1e3
            if resp is None:
                print(f"{verb}: NO RESPONSE")
                verbs[verb] = None
                continue
            kind, rverb, rargs = proto.parse_message(resp)
            print(f"{verb}: {kind} {rverb} {' '.join(rargs)} ({dt:.1f} ms)")
            verbs[verb] = {"kind": kind, "verb": rverb, "args": rargs,
                           "ms": dt}
    finally:
        sock.close()
    return common.emit({"tool": TOOL, "verbs": verbs,
                        "answered": sum(v is not None for v in verbs.values()),
                        **common.card(dev)})


if __name__ == "__main__":
    main()
