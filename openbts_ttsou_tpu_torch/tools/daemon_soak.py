"""Real-time soak: the block daemon with N carriers over the wire.

Stands up `BlockTrxDaemon` against a BTS stub in the same process that
speaks the reference's 3-plane UDP protocol: the stub configures every
carrier over the control plane (RXTUNE/TXTUNE/SETTSC/SETSLOT/POWERON),
follows the clock plane's IND CLOCK beacons, feeds the downlink data
plane one block of frames a step from its feed cursor, and drains the
uplink detections. The uplink air is a replayed device-rate bank with a
normal burst planted in each loaded slot (`--bus replay`), or the same
bank streamed by a `python -m openbts_ttsou_tpu_torch.trx.bus_server`
child through USRPBankRadio → SocketBus (`--bus socket`). K1 runs twice
a block: 65/96 on the uplink, 96/65 on the downlink.

The stub follows every beacon, as the port's BTS does
(`gsm/trxmanager.py` `handle_clock`): a beacon ahead of the feed cursor
moves the cursor to it; one at or behind it is ignored, so no
(carrier, slot, frame) is fed twice. A daemon whose blocks are longer
than its clock lead (26 frames against the initial 20) grows the lead a
frame each block that saw late bursts, so the first bf − 20 blocks feed
late; `--warmup` must cover them for the timed window to be clean.

Prints one JSON line: ms a GSM frame over the timed window (the air
takes 4.615), detections, datagram counts, and the stale and underrun
counts of the timed window. `realtime` holds only when the frame time
beats the air and no burst was late or dumped. The stub reads the frame
number of every uplink datagram, so the record also counts the timed
window's uplink: the frames of the blocks dispatched in it must each
bring one datagram a loaded slot a carrier, and `uplink_lost_timed`
says how many did not arrive.

    python -m openbts_ttsou_tpu_torch.tools.daemon_soak --carriers 8 \\
        --block-frames 26 --blocks 10 --warmup 6

The soak holds 2n + 1 stub and 2n + 1 daemon sockets of the native
transport (the daemon's span 3n + 1 ports) and, with `--bus socket`, n
bus sockets in one process: past FD_SETSIZE (1024) from 256 carriers,
which the port's transport takes (it waits with `poll()`). It raises
the soft RLIMIT_NOFILE as far as the hard limit allows, refuses a
carrier count that the hard limit or the transport's handle table
(`HANDLE_TABLE`) cannot hold, and reports `largest_fd`.
"""

from __future__ import annotations

import collections
import resource
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from openbts_ttsou_tpu_torch.runtime import UdpTransport
from openbts_ttsou_tpu_torch.tools import common
from openbts_ttsou_tpu_torch.trx import protocol as proto
from openbts_ttsou_tpu_torch.utils.gsm_time import HYPERFRAME, fn_compare

TOOL = "daemon_soak"
#: sockets the native transport's handle table holds (`kMax` of
#: csrc/runtime/udp_transport.cpp)
HANDLE_TABLE = 8192
#: descriptors kept free beside the soak's sockets (files, pipes, the
#: CUDA runtime's own)
FD_SPARE = 64


def parse_args(argv=None):
    ap = common.parser(__doc__)
    ap.add_argument("--carriers", type=int, default=128)
    ap.add_argument("--blocks", type=int, default=50,
                    help="timed blocks")
    ap.add_argument("--warmup", type=int, default=6,
                    help="blocks before the timed window")
    ap.add_argument("--base-port", type=int, default=36700,
                    help="the daemon's clock port; the stub listens "
                         "3·carriers + 3 above it")
    ap.add_argument("--depth", type=int, default=2,
                    help="blocks in flight before the daemon retires one")
    ap.add_argument("--block-frames", type=int, default=13,
                    help="frames a block (a multiple of 13)")
    ap.add_argument("--compact", type=int, default=1,
                    help="1: device-side compaction of the result (the "
                         "daemon's default); 0: dense")
    ap.add_argument("--ul-slots", type=int, default=7,
                    help="slots a frame carrying uplink bursts (7: full "
                         "load)")
    ap.add_argument("--dl-carriers", type=int, default=-1,
                    help="carriers fed downlink bursts (-1: all)")
    ap.add_argument("--bus", choices=("replay", "socket"), default="replay")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds the run may take (0: no limit)")
    ap.add_argument("--out", default=None,
                    help="directory of the bus server's socket and "
                         "stimulus (default: build/tools/soak_bus)")
    return ap.parse_args(argv)


def build_uplink_bank(n_chan: int, frames: int, ul_slots: int,
                      device: torch.device) -> np.ndarray:
    """int16 I/Q bank [n_chan, frames·1250·96/65, 2]: a TSC-0 burst of
    amplitude 5000 in slots 1..ul_slots of every frame (slot 0 runs
    combination IV, RACH, and stays quiet), resampled to the device rate
    by K1 on `device`. Every carrier carries the same air."""
    from openbts_ttsou_tpu_torch.ops import fir, gmsk
    from openbts_ttsou_tpu_torch.utils import constants as C

    rng = np.random.default_rng(0)
    sym = np.zeros((1, frames * 1250), np.complex64)
    offs = np.concatenate([[0], np.cumsum([157, 156, 156, 156] * 2)])[:8]
    for tn in range(1, 1 + ul_slots):
        b = np.concatenate(
            [[0, 0, 0], rng.integers(0, 2, 57), [1], C.TRAINING_SEQUENCE[0],
             [1], rng.integers(0, 2, 57), [0, 0, 0]]).astype(np.uint8)
        w = 5000.0 * gmsk.modulate_burst_np(b[None], 1)[0]
        for f in range(frames):
            o = f * 1250 + offs[tn]
            sym[:, o: o + len(w)] += w[None]
    dev = fir.polyphase_resample(torch.from_numpy(sym).to(device), 96, 65,
                                 fir.resampler_lpf(96, 65, 651))
    # NO pad: the replay tiles modulo its length, and the bank is
    # periodic only when its period is exactly the whole frames' device
    # length (a pad shifts every frame after the first wrap, and the
    # detections die)
    dev = dev[:, : frames * 1250 * 96 // 65]
    iq = torch.stack([dev.real, dev.imag], -1)
    i16 = torch.clamp(torch.round(iq), -32767.0, 32767.0).to(torch.int16)
    return np.broadcast_to(i16.cpu().numpy(),
                           (n_chan,) + tuple(i16.shape[1:])).copy()


class BtsStub:
    """The BTS side of the wire: n carriers' control and data sockets and
    the clock socket, bound `offset` above the daemon's ports."""

    def __init__(self, n: int, base: int, offset: int):
        peer = base + offset
        self.n = n
        self.clock = UdpTransport(peer, "127.0.0.1", base)
        self.ctrl = [UdpTransport(peer + 3 * i + 1, "127.0.0.1",
                                  base + 3 * i + 1) for i in range(n)]
        self.data = [UdpTransport(peer + 3 * i + 2, "127.0.0.1",
                                  base + 3 * i + 2) for i in range(n)]
        self.cursor: int | None = None  # next frame to feed
        self.beacons = 0
        self.fed = 0  # downlink datagrams sent
        self.received = 0  # uplink datagrams drained
        self.uplink_fn = collections.Counter()  # uplink datagrams a frame

    def on_beacon(self, fn: int) -> None:
        """Follow IND CLOCK: move the feed cursor forward to a beacon
        ahead of it (modulo the hyperframe), never back."""
        if self.cursor is None or fn_compare(fn, self.cursor) > 0:
            self.cursor = fn

    def follow_clock(self) -> None:
        while (d := self.clock.recv(64, timeout_ms=0)) is not None:
            kind, verb, a = proto.parse_message(d)
            if kind == "IND" and verb == "CLOCK":
                self.beacons += 1
                self.on_beacon(int(a[0]))

    def feed(self, bits: np.ndarray, valid: np.ndarray, n_dl: int) -> None:
        """Send one block of frames from the cursor to n_dl carriers."""
        if self.cursor is None:
            return
        pkts = proto.pack_downlink_block(bits, valid, self.cursor,
                                         hyperframe=HYPERFRAME)
        for i in range(n_dl):
            self.data[i].send_batch(pkts)
            self.fed += pkts.shape[0]
        self.cursor = (self.cursor + bits.shape[0]) % HYPERFRAME

    def drain(self) -> int:
        got = 0
        for i in range(self.n):
            pkts = self.data[i].drain_fixed(proto.UPLINK_LEN, 4096)
            if len(pkts):
                # bytes 1-4 of an uplink datagram: its frame number
                fns = pkts[:, 1:5].copy().view(">u4").ravel()
                self.uplink_fn.update(fns.tolist())
                got += len(pkts)
        self.received += got
        return got

    def uplink_in(self, fn0: int, frames: int) -> int:
        """Uplink datagrams drained for frames fn0 .. fn0 + frames − 1
        (modulo the hyperframe)."""
        return sum(self.uplink_fn[(fn0 + k) % HYPERFRAME]
                   for k in range(frames))

    def close(self) -> None:
        for s in (self.clock, *self.ctrl, *self.data):
            s.close()


def _check_descriptors(n: int, socket_bus: bool) -> int:
    """Make room for the soak's sockets: the soft RLIMIT_NOFILE raised as
    far as the hard limit allows. Raises ValueError where the hard limit
    or the transport's handle table cannot hold them. Returns the
    sockets needed."""
    handles = 2 * (2 * n + 1)  # the stub's and the daemon's
    need = handles + (n if socket_bus else 0)
    if handles > HANDLE_TABLE:
        raise ValueError(
            f"{n} carriers need {handles} native sockets: more than the "
            f"transport's handle table holds ({HANDLE_TABLE})")
    want = common.largest_fd() + 1 + need + FD_SPARE
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if hard != resource.RLIM_INFINITY and want > hard:
        raise ValueError(
            f"{n} carriers need {need} sockets beside descriptor "
            f"{common.largest_fd()}: more than the hard RLIMIT_NOFILE "
            f"({hard}) allows")
    if soft != resource.RLIM_INFINITY and soft < want:
        resource.setrlimit(resource.RLIMIT_NOFILE, (
            hard if hard != resource.RLIM_INFINITY else want, hard))
    return need


def _start_bus_server(n: int, stim: np.ndarray, work) -> tuple:
    """The bus server as a child process, and its socket's path once it
    is bound (waited for on a deadline)."""
    work.mkdir(parents=True, exist_ok=True)
    np.save(work / "stim.npy", stim)
    sock = work / "usrp.sock"
    if sock.exists():
        sock.unlink()
    srv = subprocess.Popen(
        [sys.executable, "-m", "openbts_ttsou_tpu_torch.trx.bus_server",
         "--socket", str(sock), "--carriers", str(n), "--hw-delay", "0",
         "--stimulus", str(work / "stim.npy")], cwd=common.ROOT)
    end = time.monotonic() + 120
    while not sock.exists():
        if srv.poll() is not None or time.monotonic() > end:
            srv.kill()
            srv.wait()
            raise RuntimeError("the bus server did not bind its socket")
        time.sleep(0.05)
    return srv, sock


def _stop(srv) -> None:
    srv.terminate()
    try:
        srv.wait(timeout=10)
    except subprocess.TimeoutExpired:
        srv.kill()
        srv.wait()


def run(args, stub_cls=BtsStub) -> dict:
    """The soak as `args` says, with `stub_cls` on the BTS side."""
    from openbts_ttsou_tpu_torch.trx.daemon import (BlockTrxDaemon,
                                                    TrxDaemonConfig)
    from openbts_ttsou_tpu_torch.trx.radio import ReplayBankRadio

    device = common.device_of(args)
    n, bf = args.carriers, args.block_frames
    socket_bus = args.bus == "socket"
    _check_descriptors(n, socket_bus)
    offset = 3 * n + 3  # the stub's ports lie above every daemon port
    common.log(TOOL, f"carriers={n} blocks={args.blocks} bf={bf} "
                     f"bus={args.bus} device={device}")
    bank_frames = 4 * bf
    srv = buses = None
    opened = []
    try:
        if socket_bus:
            from openbts_ttsou_tpu_torch.trx.usrp import (SocketBus,
                                                          USRPBankRadio,
                                                          USRPRadio)

            stim = build_uplink_bank(1, bank_frames, args.ul_slots,
                                     device)[0]
            work = (Path(args.out) if args.out
                    else common.OUT_DIR / "soak_bus")
            srv, sock = _start_bus_server(n, stim, work)
            buses = [SocketBus(str(sock), carrier=c) for c in range(n)]
            bank = USRPBankRadio([USRPRadio(b) for b in buses])
        else:
            bank = ReplayBankRadio(build_uplink_bank(
                n, bank_frames, args.ul_slots, device))
        k1_0 = common.k1_launches()  # the daemon's, not the bank's
        daemon = BlockTrxDaemon(
            bank, TrxDaemonConfig(base_port=args.base_port,
                                  peer_port_offset=offset, n_arfcn=n,
                                  device=str(device)),
            block_frames=bf, pipeline_depth=args.depth,
            compact=bool(args.compact))
        opened.append(daemon)
        stub = stub_cls(n, args.base_port, offset)
        opened.append(stub)
        fd_max = common.largest_fd()
        record = _soak(args, daemon, stub)
    finally:
        for o in opened:
            o.close()
        for b in buses or ():
            b.close()
        if srv is not None:
            _stop(srv)
    record.update(
        largest_fd=fd_max, k1_launches=common.k1_launches() - k1_0,
        blocks_run=daemon._rx_block, bus=args.bus,
        **({"bus_tx_MB": sum(b.tx_bytes for b in buses) / 1e6,
            "bus_rx_MB": sum(b.rx_bytes for b in buses) / 1e6,
            "bus_MBps": sum(b.tx_bytes + b.rx_bytes for b in buses)
            / record["timed_s"] / 1e6} if buses else {}),
        **common.card(device))
    need = record["expected_uplink_per_block"] * (
        max(args.blocks // 2, 1) if socket_bus else args.blocks - 2)
    if record["uplink_datagrams"] < need:
        raise RuntimeError(f"uplink starved: {record['uplink_datagrams']} "
                           f"datagrams < {need}")
    return record


def _soak(args, daemon, stub) -> dict:
    n, bf = args.carriers, args.block_frames
    n_dl = n if args.dl_carriers < 0 else min(args.dl_carriers, n)
    # bring-up over the control plane (OpenBTS.cpp:200-214)
    for i in range(n):
        for verb, a in (("RXTUNE", (890000,)), ("TXTUNE", (935000,)),
                        ("SETTSC", (0,)), ("SETSLOT", (0, 4))):
            stub.ctrl[i].send(proto.pack_command(verb, *a))
        for tn in range(1, 8):
            stub.ctrl[i].send(proto.pack_command("SETSLOT", tn, 1))
    daemon.step()  # services every queued command
    for i in range(n):
        stub.ctrl[i].send(proto.pack_command("POWERON"))
    daemon.step()
    if not (daemon.on and stub.ctrl[n - 1].recv(128, timeout_ms=2000)):
        raise RuntimeError("bring-up failed")

    rng = np.random.default_rng(7)
    dl_bits = rng.integers(0, 2, (bf, 8, 148)).astype(np.uint8)
    dl_valid = np.ones((bf, 8), bool)

    def pump():
        stub.follow_clock()
        stub.feed(dl_bits, dl_valid, n_dl)
        stub.drain()

    for _ in range(args.warmup):
        pump()
        daemon.step()
    common.log(TOOL, "warm-up done; timing")
    stale0, under0 = daemon.stale_dumped, daemon.underruns
    fed0, k1_0 = stub.fed, common.k1_launches()
    fn0 = daemon.fn  # the first timed block's first uplink frame
    t0 = time.perf_counter()
    for _ in range(args.blocks):
        pump()
        daemon.step()
    daemon.flush()
    timed_s = time.perf_counter() - t0
    stale = daemon.stale_dumped - stale0
    under = daemon.underruns - under0
    fed = stub.fed - fed0
    k1_timed = common.k1_launches() - k1_0
    stub.drain()  # the flushed blocks' datagrams (loopback delivers at once)
    ms_frame = timed_s * 1e3 / (args.blocks * bf)
    ul_want = args.blocks * bf * n * args.ul_slots
    ul_timed = stub.uplink_in(fn0, args.blocks * bf)
    return {
        "tool": TOOL, "carriers": n, "block_frames": bf,
        "depth": args.depth, "compact": bool(args.compact),
        "ul_slots": args.ul_slots, "dl_carriers": n_dl,
        "warmup": args.warmup, "blocks_timed": args.blocks,
        "timed_s": timed_s, "ms_per_frame": ms_frame,
        "air_ms_per_frame": common.FRAME_MS,
        "realtime": ms_frame < common.FRAME_MS and stale == 0 and under == 0,
        "stale_dumped": stale, "underruns": under,
        "downlink_fed": fed, "stale_fraction": stale / max(fed, 1),
        "uplink_datagrams": stub.received,
        "expected_uplink_per_block": bf * n * args.ul_slots,
        "uplink_timed": ul_timed, "expected_uplink_timed": ul_want,
        "uplink_lost_timed": ul_want - ul_timed,
        "downlink_datagrams": stub.fed, "clock_beacons": stub.beacons,
        "clock_lead": daemon.clock_lead,
        "k1_launches_timed": k1_timed,
        "d2h_bytes_per_block": daemon.d2h_bytes / max(daemon._rx_block, 1),
        "d2h_bytes_per_block_dense":
            daemon.d2h_bytes_dense / max(daemon._rx_block, 1)}


def main(argv=None) -> dict:
    args = parse_args(argv)
    with common.deadline(args.timeout, TOOL):
        return common.emit(run(args))


if __name__ == "__main__":
    main()
