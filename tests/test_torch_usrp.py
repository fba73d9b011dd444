"""The port's USRP driver over a simulated packet bus (`trx/usrp.py`,
`trx/bus_server.py`), on the CPU: the cases of tests/test_usrp.py against
the port's `usrp`, `bus_server` and daemons, and the copy's packets and
streams against the JAX package's.

Sockets: UDP ports 51600-51799 (a block of 100 a test, peers 50 above
the daemon's; the port's other daemon tests take other blocks of
51000-51999), AF_UNIX bus sockets under pytest's tmp_path. Every wait is
on a deadline of seconds until the expected count arrives, never a
fixed short poll: the daemon, the bus server process and the test share
a loaded machine when the suite runs in parallel.
"""

import struct
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from openbts_ttsou_tpu.trx import usrp as jusrp
from openbts_ttsou_tpu_torch.ops import fir, gmsk
from openbts_ttsou_tpu_torch.runtime import UdpTransport
from openbts_ttsou_tpu_torch.trx import protocol as proto
from openbts_ttsou_tpu_torch.trx import usrp as tusrp
from openbts_ttsou_tpu_torch.trx.daemon import (BlockTrxDaemon, TrxDaemon,
                                                TrxDaemonConfig)
from openbts_ttsou_tpu_torch.trx.usrp import (CTRL_CHAN, PKT_BYTES, SimBus,
                                              SocketBus, USRPBankRadio,
                                              USRPRadio, build_packets)
from openbts_ttsou_tpu_torch.utils import constants as C

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PEER = 50  # peer_port_offset
DEADLINE_S = 20.0


def norm_burst(rng, tsc=0):
    return np.concatenate(
        [[0, 0, 0], rng.integers(0, 2, 57), [1], C.TRAINING_SEQUENCE[tsc],
         [1], rng.integers(0, 2, 57), [0, 0, 0]]).astype(np.uint8)


def recv_until(sock, want: int, deadline_s: float = DEADLINE_S) -> list:
    """Datagrams from `sock` until `want` have arrived or the deadline
    passes; then whatever else is already queued."""
    out = []
    end = time.monotonic() + deadline_s
    while len(out) < want and time.monotonic() < end:
        d = sock.recv(256, timeout_ms=200)
        if d:
            out.append(d)
    while (d := sock.recv(256, timeout_ms=0)) is not None:
        out.append(d)
    return out


def start_bus_server(tmp_path: Path, *args) -> tuple[subprocess.Popen, str]:
    """`python -m openbts_ttsou_tpu_torch.trx.bus_server` on a socket under
    tmp_path, waited for on a deadline (the process imports torch)."""
    sock = tmp_path / "usrp.sock"
    srv = subprocess.Popen(
        [sys.executable, "-m", "openbts_ttsou_tpu_torch.trx.bus_server",
         "--socket", str(sock), *map(str, args)], cwd=ROOT)
    end = time.monotonic() + 120.0
    while not sock.exists():
        assert srv.poll() is None, "bus server exited"
        assert time.monotonic() < end, "bus server never bound its socket"
        time.sleep(0.05)
    return srv, str(sock)


def stop(srv: subprocess.Popen) -> None:
    srv.terminate()
    try:
        srv.wait(timeout=20)
    except subprocess.TimeoutExpired:
        srv.kill()
        srv.wait(timeout=20)


def test_build_packets_format():
    """writeSamples packetization (USRPDevice.cpp:467-505): header
    fields, 504-byte splits, per-packet timestamp advance; the bytes of
    the JAX package's copy."""
    n = 300  # samples → 1200 bytes → 3 packets (504+504+192)
    iq = np.arange(2 * n, dtype=np.int16).reshape(n, 2)
    pkts = build_packets(iq.tobytes(), ts=1000)
    assert pkts == jusrp.build_packets(iq.tobytes(), ts=1000)
    assert len(pkts) == 3 * PKT_BYTES
    seen = []
    for i in range(3):
        word0, ts = struct.unpack_from("<II", pkts, i * PKT_BYTES)
        assert (word0 >> 16) & 0x1F == 0
        assert (word0 >> 28) & 1 == (1 if i == 0 else 0)
        assert (word0 >> 27) & 1 == (1 if i == 2 else 0)
        seen.append((ts, word0 & 0x1FF))
    assert seen == [(1000, 504), (1126, 504), (1252, 1200 - 1008)]
    body = b"".join(pkts[i * PKT_BYTES + 8: i * PKT_BYTES + 8 + pl]
                    for i, (_, pl) in enumerate(seen))
    assert body == iq.tobytes()
    ping = build_packets(b"\x00" * 8, 7, chan=CTRL_CHAN, rssi=5)
    assert ping == jusrp.build_packets(b"\x00" * 8, 7, chan=CTRL_CHAN,
                                       rssi=5)


def test_sim_bus_streams_match_jax():
    """The port's SimBus and the JAX package's give the same rx packets
    for the same tx, stimulus, noise seed, ping and underrun."""
    rng = np.random.default_rng(2)
    stim = rng.integers(-3000, 3000, (777, 2)).astype(np.int16)
    buses = [m.SimBus(hw_delay=37, start_ts=(1 << 32) - 300, noise_std=5.0,
                      underrun_at=(1 << 32) + 100, stimulus=stim)
             for m in (jusrp, tusrp)]
    tx = build_packets(rng.integers(-9000, 9000, (500, 2)).astype(
        np.int16).tobytes(), (1 << 32) - 250)
    ping = build_packets(jusrp.PING_REQUEST, (1 << 32) - 200, chan=CTRL_CHAN)
    for b in buses:
        b.write(tx)
        b.write(ping)
    for _ in range(5):
        a, b = (bus.read(8 * PKT_BYTES) for bus in buses)
        assert a == b


def test_alignment_and_loopback():
    """updateAlignment (USRPDevice.cpp:518): the ping measures the Tx→Rx
    offset; after alignment a probe written at T reads back at T."""
    bus = SimBus(hw_delay=137)
    radio = USRPRadio(bus)
    assert radio.start() and bus.started
    assert radio.update_alignment(ts=4000) == 137 and radio.is_aligned
    probe = np.zeros(64, np.complex64)
    probe[0] = 20000.0
    radio.write_samples(probe, 20000)
    got = radio.read_samples(64, 20000)
    assert int(np.argmax(np.abs(got))) == 0 and abs(got[0]) > 10000


def test_timestamp_wrap_extension():
    """32→64-bit extension (readSamples, USRPDevice.cpp:358-363): a
    stream crossing the 2^32 sample boundary stays contiguous."""
    start = (1 << 32) - 500
    radio = USRPRadio(SimBus(hw_delay=0, start_ts=start))
    probe = np.zeros(1000, np.complex64)
    probe[0] = 9000.0
    probe[999] = 7000.0
    radio.write_samples(probe, start)
    got = radio.read_samples(1000, start)
    assert abs(got[0]) > 5000
    assert abs(got[999]) > 3500  # past the 32-bit boundary
    assert radio.ring.last_pkt_ts >= 1 << 32


def test_underrun_flag_surfaces():
    radio = USRPRadio(SimBus(hw_delay=0, underrun_at=0))
    radio.read_samples(600, 0)
    assert radio.underruns >= 1


def test_rfx900_tuning_programs_bus():
    bus = SimBus()
    radio = USRPRadio(bus)
    assert radio.set_tx_freq(935.2e6)
    assert radio.set_rx_freq(890.2e6)
    assert [s for s, _ in bus.programmed] == ["tx", "rx"]
    # residuals left for the digital mixer (USRPDevice.cpp:527,540),
    # bounded by the synthesizer's step plus the LO_OFFSET detune
    assert abs(radio.tx_residual_hz) < 8e6


def test_frame_daemon_runs_unchanged_over_usrp_radio():
    """The port's per-frame daemon drives USRPRadio(SimBus) as it drives
    LoopbackRadio: bring-up over the wire, downlink bursts loop back
    through the bus and are detected on the uplink with their bits."""
    base = 51600
    bus = SimBus(hw_delay=53)
    radio = USRPRadio(bus)
    radio.update_alignment(ts=1000)
    assert radio.timestamp_offset == 53
    daemon = TrxDaemon(radio, TrxDaemonConfig(
        base_port=base, peer_port_offset=PEER, device="cpu"))
    ctrl = UdpTransport(base + PEER + 1, "127.0.0.1", base + 1)
    data = UdpTransport(base + PEER + 2, "127.0.0.1", base + 2)
    try:
        def cmd(verb, *args):
            ctrl.send(proto.pack_command(verb, *args))
            daemon.step()
            rsp = recv_until(ctrl, 1)
            assert rsp, f"no response to {verb}"
            return proto.parse_message(rsp[0])

        for verb, args in (("RXTUNE", (890000,)), ("TXTUNE", (935000,)),
                           ("SETTSC", (0,)), ("SETSLOT", (0, 1))):
            assert cmd(verb, *args)[2][0] == "0"
        assert cmd("POWERON")[2][0] == "0" and daemon.on

        bits = norm_burst(np.random.default_rng(5))
        fns = range(daemon.tx_fn + 1, daemon.tx_fn + 4)
        for fn in fns:
            data.send(proto.pack_downlink(proto.DownlinkBurst(0, fn, 0,
                                                              bits)))
        uplinks = []
        for _ in range(8):
            daemon.step()
            uplinks += [proto.unpack_uplink(d) for d in recv_until(data, 0)]
        uplinks += [proto.unpack_uplink(d)
                    for d in recv_until(data, len(fns) - len(uplinks))]
        assert [u.fn for u in uplinks] == list(fns)
        for u in uplinks:
            assert u.tn == 0
            assert np.array_equal((u.soft > 0.5).astype(np.uint8), bits)
    finally:
        daemon.close()
        ctrl.close()
        data.close()


def test_socket_bus_crosses_process(tmp_path):
    """The Bus seam across a real process boundary: the port's bus server
    process hosts the SimBus, SocketBus speaks to it over an AF_UNIX
    socket; alignment ping, loopback and register programming all flow
    through the transport."""
    srv, sock = start_bus_server(tmp_path, "--carriers", 1,
                                 "--hw-delay", 137)
    try:
        bus = SocketBus(sock)
        radio = USRPRadio(bus)
        assert radio.start()
        assert radio.set_tx_freq(935.2e6) and radio.set_rx_freq(890.2e6)
        assert radio.update_alignment(ts=4000) == 137 and radio.is_aligned
        probe = np.zeros(64, np.complex64)
        probe[0] = 20000.0
        radio.write_samples(probe, 20000)
        got = radio.read_samples(64, 20000)
        assert int(np.argmax(np.abs(got))) == 0 and abs(got[0]) > 10000
        assert bus.tx_bytes > 0 and bus.rx_bytes > 0
        assert radio.stop()
        bus.close()
    finally:
        stop(srv)


def planted_stimulus(rng, n_slots=(1, 2, 3)):
    """Device-rate int16 [T, 2] with a TSC-0 burst of amplitude 5000 on
    each of `n_slots` in every frame, one 13-frame period (exactly
    block_in samples, so the tiling stays frame-aligned). Returns
    ({tn: bits}, stimulus)."""
    offs = np.concatenate([[0], np.cumsum([157, 156, 156, 156] * 2)])[:8]
    sym = np.zeros((1, 13 * 1250), np.complex64)
    bits = {}
    for tn in n_slots:
        bits[tn] = norm_burst(rng)
        w = 5000.0 * gmsk.modulate_burst_np(bits[tn][None], 1)[0]
        for f in range(13):
            o = f * 1250 + offs[tn]
            sym[0, o: o + len(w)] += w
    dev = fir.polyphase_resample(torch.from_numpy(sym), 96, 65,
                                 fir.resampler_lpf(96, 65, 651)
                                 ).numpy()[0, : 13 * 1250 * 96 // 65]
    stim = np.clip(np.stack([dev.real, dev.imag], -1).round(), -32767,
                   32767).astype(np.int16)
    return bits, stim


def test_block_daemon_over_socket_bus(tmp_path):
    """The port's block daemon across the process boundary: BlockTrxDaemon
    (on the CPU) over USRPBankRadio → SocketBus → the port's bus server
    process, whose SimBus streams a planted-burst stimulus. Every
    detection's hard bits equal its planted burst, and the daemon's DAC
    blocks reach the server as USRP packets."""
    n = 2
    bits, stim = planted_stimulus(np.random.default_rng(4))
    np.save(tmp_path / "stim.npy", stim)
    srv, sock = start_bus_server(tmp_path, "--carriers", n, "--hw-delay", 0,
                                 "--stimulus", tmp_path / "stim.npy")
    base = 51700
    socks = []
    try:
        radios = [USRPRadio(SocketBus(sock, carrier=c)) for c in range(n)]
        daemon = BlockTrxDaemon(USRPBankRadio(radios), TrxDaemonConfig(
            base_port=base, peer_port_offset=PEER, n_arfcn=n, device="cpu"))
        ctrl = [UdpTransport(base + PEER + 3 * i + 1, "127.0.0.1",
                             base + 3 * i + 1) for i in range(n)]
        data = [UdpTransport(base + PEER + 3 * i + 2, "127.0.0.1",
                             base + 3 * i + 2) for i in range(n)]
        socks = ctrl + data
        for i in range(n):
            for verb, a in (("RXTUNE", (890000,)), ("TXTUNE", (935000,)),
                            ("SETTSC", (0,))):
                ctrl[i].send(proto.pack_command(verb, *a))
            for tn in bits:
                ctrl[i].send(proto.pack_command("SETSLOT", tn, 1))
        daemon.step()
        for i in range(n):
            ctrl[i].send(proto.pack_command("POWERON"))
        daemon.step()
        assert daemon.on
        for _ in range(4):
            daemon.step()
        daemon.flush()
        blocks = daemon._rx_block
        assert blocks == 5

        for i in range(n):
            rsp = [proto.parse_message(m) for m in recv_until(ctrl[i], 5)]
            assert [r[1] for r in rsp] == ["RXTUNE", "TXTUNE", "SETTSC",
                                           "SETSLOT", "SETSLOT", "SETSLOT",
                                           "POWERON"][: len(rsp)]
            assert all(r[2][0] == "0" for r in rsp)
            # every slot of every frame of the 4 blocks after the first,
            # whose left halo starts cold
            got = [proto.unpack_uplink(d)
                   for d in recv_until(data[i], 4 * 13 * len(bits))]
            assert len(got) >= 4 * 13 * len(bits), \
                f"carrier {i}: {len(got)} detections over the socket bus"
            assert {u.tn for u in got} == set(bits)
            for u in got:
                assert np.array_equal((u.soft > 0.5).astype(np.uint8),
                                      bits[u.tn]), (i, u.fn, u.tn)
        # the daemon's DAC blocks crossed the bus as USRP packets
        assert all(r.bus.tx_bytes > blocks * 24000 * 4 for r in radios)
        assert radios[0].ring.last_pkt_ts > 0
        daemon.close()
    finally:
        for s in socks:
            s.close()
        stop(srv)
