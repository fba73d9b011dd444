"""Standalone SIP MESSAGE injector (the reference's sendSimple): sends
one text message to an smqueue or SIP endpoint and prints the response's
status. A host tool: `--device` is checked like every tool's, and
nothing runs on it.

    python -m openbts_ttsou_tpu_torch.tools.send_simple <to> <text...> \\
        [--port 5063]
"""

from __future__ import annotations

from openbts_ttsou_tpu_torch.tools import common

TOOL = "send_simple"


def main(argv=None) -> dict:
    from openbts_ttsou_tpu_torch.runtime import UdpTransport
    from openbts_ttsou_tpu_torch.sip.message import SIPMessage, make_request

    ap = common.parser(__doc__)
    ap.add_argument("to")
    ap.add_argument("text", nargs="+")
    ap.add_argument("--from-user", default="sendSimple")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=5063)
    ap.add_argument("--local-port", type=int, default=5069)
    args = ap.parse_args(argv)
    dev = common.device_of(args)
    sock = UdpTransport(args.local_port, args.host, args.port)
    try:
        req = make_request("MESSAGE", args.to, args.from_user, args.host,
                           args.port, "127.0.0.1", args.local_port,
                           body=" ".join(args.text),
                           content_type="text/plain")
        sock.send(req.render())
        resp = sock.recv(2048, timeout_ms=3000)
    finally:
        sock.close()
    if resp is None:
        print("no response")
        raise RuntimeError(f"no response from {args.host}:{args.port}")
    msg = SIPMessage.parse(resp)
    print(f"{msg.status} {msg.reason}")
    return common.emit({"tool": TOOL, "to": args.to, "status": msg.status,
                        "reason": msg.reason, **common.card(dev)})


if __name__ == "__main__":
    main()
