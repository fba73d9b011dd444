"""The PyTorch port's wire side on the CPU: protocol, rfx900 and state
files against the JAX package, and the port's daemons over real UDP
sockets on the loopback interface.

- protocol, rfx900 plan words, pack helpers and state files: byte- or
  field-identical to the JAX package's;
- `TrxDaemon` (one frame a step): the bring-up, loopback, multi-carrier,
  alignment, robustness and clock-lead drives of tests/test_daemon.py;
- `BlockTrxDaemon` (one duplex block a step) and the JAX package's, fed
  the same `ReplayBankRadio` input through the same wire session: their
  uplink datagrams and tx captures agree (header bytes exact, soft bytes
  and int16 tx samples within ±1 with at most 0.1% off by 1), as in
  tests/test_block_daemon.py:132-240; and the port's compact retire
  equals its dense retire byte for byte (tests/test_block_daemon.py:299).

Every test binds its own block of 100 UDP ports in 51000-51999 (base,
base+3·i+{1,2}, peers at base+50+…), apart from the JAX suite's
40000-49960.
"""

import numpy as np
import pytest
import torch

from openbts_ttsou_tpu.models import transceiver as jtrx
from openbts_ttsou_tpu.trx import daemon as jdaemon
from openbts_ttsou_tpu.trx import engine as jeng
from openbts_ttsou_tpu.trx import protocol as jproto
from openbts_ttsou_tpu.trx import radio as jradio
from openbts_ttsou_tpu.trx import rfx900 as jrfx
from openbts_ttsou_tpu.trx import state_io as jstate_io
from openbts_ttsou_tpu_torch.models import transceiver as ttrx
from openbts_ttsou_tpu_torch.ops import fir as tfir
from openbts_ttsou_tpu_torch.ops import gmsk as tgmsk
from openbts_ttsou_tpu_torch.runtime import UdpTransport
from openbts_ttsou_tpu_torch.trx import engine as teng
from openbts_ttsou_tpu_torch.trx import protocol as proto
from openbts_ttsou_tpu_torch.trx import radio as tradio
from openbts_ttsou_tpu_torch.trx import rfx900 as trfx
from openbts_ttsou_tpu_torch.trx import state_io as tstate_io
from openbts_ttsou_tpu_torch.trx.daemon import (BlockTrxDaemon, TrxDaemon,
                                                TrxDaemonConfig)
from openbts_ttsou_tpu_torch.utils import constants as C
from openbts_ttsou_tpu_torch.utils.gsm_time import HYPERFRAME

torch.set_num_threads(1)

PEER = 50  # peer_port_offset: a daemon and its BTS sockets in 100 ports
OFFS = np.concatenate([[0], np.cumsum([157, 156, 156, 156] * 2)])[:8]


def norm_burst(tsc=0, seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate(
        [[0, 0, 0], rng.integers(0, 2, 57), [1], C.TRAINING_SEQUENCE[tsc],
         [1], rng.integers(0, 2, 57), [0, 0, 0]]).astype(np.uint8)


def cpu_cfg(base, **kw):
    return TrxDaemonConfig(base_port=base, peer_port_offset=PEER,
                           device="cpu", **kw)


def assert_close_int(a, b, what):
    """Integers within ±1, at most 0.1% of them off by 1."""
    d = np.abs(np.asarray(a, np.int64) - np.asarray(b, np.int64))
    assert d.max(initial=0) <= 1, f"{what}: max diff {d.max()}"
    assert (d > 0).mean() <= 1e-3, f"{what}: {(d > 0).mean():.2%} off by 1"


# ---- protocol, rfx900, state files ----------------------------------------

def _bursts(seed):
    rng = np.random.default_rng(seed)
    dl = [proto.DownlinkBurst(int(rng.integers(0, 8)),
                              int(rng.integers(0, 2 ** 32)),
                              int(rng.integers(-5, 300)),
                              rng.integers(0, 2, 148).astype(np.uint8))
          for _ in range(40)]
    ul = [proto.UplinkBurst(int(rng.integers(0, 8)),
                            int(rng.integers(0, HYPERFRAME)),
                            int(rng.integers(-3, 256)),
                            int(rng.integers(-32768, 32768)),
                            rng.random(148).astype(np.float32))
          for _ in range(40)]
    return rng, dl, ul


def test_protocol_matches_jax_byte_for_byte():
    rng, dl, ul = _bursts(1)
    assert (proto.DOWNLINK_LEN, proto.UPLINK_LEN, proto.CLOCK_LEAD_FRAMES,
            proto.CLOCK_PERIOD_FRAMES) == (
        jproto.DOWNLINK_LEN, jproto.UPLINK_LEN, jproto.CLOCK_LEAD_FRAMES,
        jproto.CLOCK_PERIOD_FRAMES)
    assert any(b.toa < 0 for b in ul)
    for b in dl:
        raw = proto.pack_downlink(b)
        assert raw == jproto.pack_downlink(jproto.DownlinkBurst(
            b.tn, b.fn, b.gain, b.bits))
        got, want = proto.unpack_downlink(raw), jproto.unpack_downlink(raw)
        assert (got.tn, got.fn, got.gain) == (want.tn, want.fn, want.gain)
        np.testing.assert_array_equal(got.bits, want.bits)
    for b in ul:
        raw = proto.pack_uplink(b)
        assert raw == jproto.pack_uplink(jproto.UplinkBurst(
            b.tn, b.fn, b.rssi, b.toa, b.soft))
        got, want = proto.unpack_uplink(raw), jproto.unpack_uplink(raw)
        assert (got.tn, got.fn, got.rssi, got.toa) == (
            want.tn, want.fn, want.rssi, want.toa)
        np.testing.assert_array_equal(got.soft, want.soft)
    det = rng.random((13, 8)) < 0.5
    soft = rng.integers(0, 256, (13, 8, 148)).astype(np.uint8)
    rssi = rng.integers(-5, 300, (13, 8))
    toa = rng.integers(-32768, 32768, (13, 8))
    bits = rng.integers(0, 2, (13, 8, 148)).astype(np.uint8)
    for fn0 in (0, HYPERFRAME - 5):
        np.testing.assert_array_equal(
            proto.pack_uplink_block(det, soft, rssi, toa, fn0),
            jproto.pack_uplink_block(det, soft, rssi, toa, fn0))
        np.testing.assert_array_equal(
            proto.pack_downlink_block(bits, det, fn0, gain=-3),
            jproto.pack_downlink_block(bits, det, fn0, gain=-3))
    for args in (("SETSLOT", 3, 7), ("POWERON",), ("RXTUNE", 890000)):
        assert proto.pack_command(*args) == jproto.pack_command(*args)
        assert proto.pack_response(args[0], 1, *args[1:]) == \
            jproto.pack_response(args[0], 1, *args[1:])
        msg = proto.pack_command(*args)
        assert proto.parse_message(msg) == jproto.parse_message(msg)
    assert proto.pack_clock(2715647) == jproto.pack_clock(2715647)
    with pytest.raises(ValueError):
        proto.parse_message(b"CMD")


def test_rfx900_plan_words_match_jax():
    for mhz in (824.2, 869.2, 890.0, 935.2, 947.6, 1805.2, 1842.4, 1930.2,
                1959.8, 1199.9, 1200.0):
        f = mhz * 1e6
        for fn in ("frequency_plan", "tune_tx", "tune_rx"):
            a, b = getattr(trfx, fn)(f), getattr(jrfx, fn)(f)
            assert (a.requested, a.actual, a.n_divider, a.div2, a.r_word,
                    a.control_word, a.n_word, a.residual) == (
                b.requested, b.actual, b.n_divider, b.div2, b.r_word,
                b.control_word, b.n_word, b.residual), (mhz, fn)
            assert a.spi_bytes() == b.spi_bytes()
    for band, arfcns in ((850, (128, 200, 251)), (900, (0, 62, 124, 975)),
                         (1800, (512, 885)), (1900, (512, 810))):
        for n in arfcns:
            assert trfx.uplink_freq_khz(band, n) == \
                jrfx.uplink_freq_khz(band, n)
            assert trfx.downlink_freq_khz(band, n) == \
                jrfx.downlink_freq_khz(band, n)
    with pytest.raises(ValueError):
        trfx.uplink_freq_khz(900, 200)


def _random_state(cfg, seed):
    rng = np.random.default_rng(seed)
    st = jeng.init_state(cfg)
    out = {}
    for name in st._fields:
        a = np.asarray(getattr(st, name))
        if a.dtype == bool:
            v = rng.random(a.shape) < 0.5
        elif np.issubdtype(a.dtype, np.integer):
            v = rng.integers(0, 1000, a.shape).astype(a.dtype)
        elif np.iscomplexobj(a):
            v = (rng.standard_normal(a.shape)
                 + 1j * rng.standard_normal(a.shape)).astype(a.dtype)
        else:
            v = rng.standard_normal(a.shape).astype(a.dtype)
        out[name] = v
    return out


def _assert_state_files_equal(a, b):
    for name in jeng.TrxState._fields:
        x, y = np.asarray(a[name]), np.asarray(b[name])
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_state_files_cross_between_packages(tmp_path, direction):
    """The same `.npz` layout both ways: every field equal, bit for bit,
    and the config (rach_slots a tuple again) equal."""
    jcfg = jeng.TrxConfig(n_chan=3, sps=1, max_toa=8, rach_slots=(0, 4))
    arrays = _random_state(jcfg, 2)
    path = str(tmp_path / "state.npz")
    if direction == "jax_to_port":
        import jax.numpy as jnp

        jstate_io.save_state(path, jcfg, jeng.TrxState(
            **{k: jnp.asarray(v) for k, v in arrays.items()}))
        cfg, st = tstate_io.load_state(path, device="cpu")
        got = {k: v.numpy() for k, v in st._asdict().items()}
    else:
        from openbts_ttsou_tpu_torch import convert

        tstate_io.save_state(path, teng.TrxConfig(**jcfg._asdict()),
                             convert.state_from_numpy(arrays, "cpu"))
        cfg, st = jstate_io.load_state(path)
        got = {k: np.asarray(v) for k, v in st._asdict().items()}
        cfg = jeng.TrxConfig(**{**cfg._asdict(),
                                "rach_slots": tuple(cfg.rach_slots)})
    assert cfg._asdict() == jcfg._asdict()
    _assert_state_files_equal(got, arrays)
    with np.load(path) as data:
        assert sorted(data.files) == sorted(
            list(jeng.TrxState._fields) + ["__config__"])


def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """Without CUDA the entry points raise unless asked for the CPU."""
    from openbts_ttsou_tpu_torch import convert

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = teng.TrxConfig(n_chan=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        teng.init_state(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrx.Transceiver(cfg)
    path = str(tmp_path / "s.npz")
    tstate_io.save_state(path, cfg, teng.init_state(cfg, "cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        tstate_io.load_state(path)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.state_from_numpy(
            convert.state_to_numpy(teng.init_state(cfg, "cpu")))
    assert TrxDaemonConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        TrxDaemon(tradio.LoopbackRadio(),
                  TrxDaemonConfig(base_port=51900, peer_port_offset=PEER))
    assert tstate_io.load_state(path, device="cpu")[0] == cfg


# ---- the per-frame daemon -------------------------------------------------

def _cmd(daemon, ctrl, verb, *args):
    ctrl.send(proto.pack_command(verb, *args))
    daemon.step()
    resp = ctrl.recv(256, timeout_ms=2000)
    assert resp is not None, f"no response to {verb}"
    kind, rverb, rargs = proto.parse_message(resp)
    assert kind == "RSP" and rverb == verb
    return int(rargs[0]), rargs[1:]


def test_trx_daemon_bringup_loopback_poweroff():
    """tests/test_daemon.py's rig: bring-up (POWERON before tuning
    fails), a downlink burst looped back to the uplink with BER < 2%,
    clock indications, POWEROFF."""
    base = 51000
    daemon = TrxDaemon(tradio.LoopbackRadio(), cpu_cfg(base))
    clock = UdpTransport(base + PEER, "127.0.0.1", base)
    ctrl = UdpTransport(base + PEER + 1, "127.0.0.1", base + 1)
    data = UdpTransport(base + PEER + 2, "127.0.0.1", base + 2)
    try:
        assert _cmd(daemon, ctrl, "POWERON")[0] == 1
        assert _cmd(daemon, ctrl, "RXTUNE", 890000)[0] == 0
        assert _cmd(daemon, ctrl, "TXTUNE", 935000)[0] == 0
        assert _cmd(daemon, ctrl, "SETTSC", 2) == (0, ["2"])
        assert _cmd(daemon, ctrl, "SETTSC", 9)[0] == 1
        assert _cmd(daemon, ctrl, "SETSLOT", 0, 1)[0] == 0
        assert _cmd(daemon, ctrl, "SETMAXDELAY", 3)[0] == 0
        assert _cmd(daemon, ctrl, "POWERON")[0] == 0
        assert daemon.on
        assert int(daemon.state.tsc[0]) == 2
        assert int(daemon.state.chan_type[0, 0]) == teng.ChanType.I
        assert int(daemon.state.max_expected_delay[0]) == 3
        msg = clock.recv(64, timeout_ms=2000)
        assert proto.parse_message(msg)[:2] == ("IND", "CLOCK")

        bits = norm_burst(tsc=2, seed=3)
        sent = [daemon.tx_fn + k for k in range(1, 4)]
        for fn in sent:
            data.send(proto.pack_downlink(proto.DownlinkBurst(0, fn, 0,
                                                              bits)))
        uplinks = []
        for _ in range(8):
            daemon.step()
            while (m := data.recv(512, timeout_ms=200)) is not None:
                uplinks.append(proto.unpack_uplink(m))
        got = sorted(u.fn for u in uplinks if u.tn == 0)
        assert set(sent) <= set(got), (sent, got)
        u = next(u for u in uplinks if u.fn == sent[0])
        assert np.mean((u.soft > 0.5).astype(int) != bits) < 0.02

        assert _cmd(daemon, ctrl, "POWEROFF")[0] == 0
        assert not daemon.on
    finally:
        for s in (clock, ctrl, data):
            s.close()
        daemon.close()
    # its ports are free again
    TrxDaemon(tradio.LoopbackRadio(), cpu_cfg(base)).close()


def test_trx_daemon_state_writes_are_functional():
    """A control verb replaces the state tensor it writes: a tensor
    handed out before (as to a queued block) keeps its values."""
    daemon = TrxDaemon(tradio.LoopbackRadio(), cpu_cfg(51100))
    before = daemon.state
    for verb, args in (("SETTSC", (5,)), ("SETSLOT", (2, 7)),
                       ("SETMAXDELAY", (9,))):
        daemon.handle_control(proto.pack_command(verb, *args))
    assert int(before.tsc[0]) == 0 and int(daemon.state.tsc[0]) == 5
    assert int(before.chan_type[0, 2]) == 0
    assert int(daemon.state.chan_type[0, 2]) == 7
    assert int(before.max_expected_delay[0]) == 0
    assert int(daemon.state.max_expected_delay[0]) == 9


def test_trx_daemon_multi_arfcn():
    """Two carriers through one engine, each on its own port triple."""
    base = 51200
    daemon = TrxDaemon([tradio.LoopbackRadio(), tradio.LoopbackRadio()],
                       cpu_cfg(base, n_arfcn=2))
    ctrls = [UdpTransport(base + PEER + 3 * i + 1, "127.0.0.1",
                          base + 3 * i + 1) for i in range(2)]
    datas = [UdpTransport(base + PEER + 3 * i + 2, "127.0.0.1",
                          base + 3 * i + 2) for i in range(2)]
    try:
        for i, c in enumerate(ctrls):
            for verb, args in (("RXTUNE", (890000 + i,)),
                               ("TXTUNE", (935000 + i,)),
                               ("SETTSC", (i,)), ("SETSLOT", (0, 1)),
                               ("POWERON", ())):
                c.send(proto.pack_command(verb, *args))
                daemon.step()
                kind, rverb, rargs = proto.parse_message(
                    c.recv(256, timeout_ms=2000))
                assert (kind, rverb, rargs[0]) == ("RSP", verb, "0")
        assert daemon.carrier_on == [True, True]
        assert daemon.state.tsc.tolist() == [0, 1]
        for i, d in enumerate(datas):
            d.send(proto.pack_downlink(proto.DownlinkBurst(
                0, daemon.tx_fn + 2 + i, 0, norm_burst(tsc=i, seed=8 + i))))
        got = [0, 0]
        for _ in range(8):
            daemon.step()
            for i, d in enumerate(datas):
                while d.recv(512, timeout_ms=100) is not None:
                    got[i] += 1
        assert got[0] >= 1 and got[1] >= 1, got
    finally:
        for s in ctrls + datas:
            s.close()


def test_trx_daemon_alignment_robustness_clock_lead():
    """measure_alignment finds the loopback delay; malformed control
    packets get no crash; late bursts grow the clock lead and early
    ones shrink it back; the radio's own impulse ping agrees."""
    daemon = TrxDaemon(tradio.LoopbackRadio(delay_samples=37),
                       cpu_cfg(51300))
    assert daemon.measure_alignment() == 37
    for pkt in (b"", b"CMD", b"CMD BOGUSVERB 1 2 3", b"\xff\x00garbage",
                b"CMD SETSLOT notanint x", b"IND CLOCK 5", b"CMD RXTUNE"):
        daemon.handle_control(pkt)
    assert b"POWEROFF" in daemon.handle_control(
        proto.pack_command("POWEROFF"))
    lead0 = daemon.clock_lead
    bits = np.zeros(148, np.uint8)
    daemon.handle_downlink(proto.pack_downlink(proto.DownlinkBurst(
        0, (daemon.tx_fn - 2) % HYPERFRAME, 0, bits)))
    assert daemon.underruns == 1 and daemon.clock_lead == lead0 + 1
    daemon.handle_downlink(proto.pack_downlink(proto.DownlinkBurst(
        0, (daemon.tx_fn + daemon.clock_lead + 20) % HYPERFRAME, 0, bits)))
    assert daemon.clock_lead == lead0
    r = tradio.LoopbackRadio(delay_samples=17, full_scale=1.0)
    assert r.update_alignment() == 17 == r.timestamp_offset
    assert tradio.DEVICE_RATE_64M == jradio.DEVICE_RATE_64M == 400e3


# ---- the block daemon -----------------------------------------------------

N_BLK = 2  # carriers in the block-daemon scenario


@pytest.fixture(scope="module")
def wire_scenario():
    """Device-rate uplink with normal bursts planted in slots 1-7 of
    every frame (slot 0 left off), 12 blocks of replay headroom."""
    frames = 13 * 12
    bits = np.zeros((N_BLK, 8, 148), np.uint8)
    sym = np.zeros((N_BLK, frames * 1250), np.complex64)
    for c in range(N_BLK):
        for tn in range(1, 8):
            bits[c, tn] = norm_burst(seed=10 * c + tn)
    for c in range(N_BLK):
        for tn in range(1, 8):
            w = 5000.0 * tgmsk.modulate_burst_np(bits[c, tn][None], 1)[0]
            for f in range(frames):
                o = f * 1250 + OFFS[tn]
                sym[c, o: o + len(w)] += w
    dev = tfir.polyphase_resample(torch.from_numpy(sym), 96, 65,
                                  tfir.resampler_lpf(96, 65, 651)).numpy()
    dev = dev[:, : frames * 1250 * 96 // 65]
    dev = np.pad(dev, ((0, 0), (0, 2 * ttrx.RX_HALO_DEV)))
    return bits, dev


def wire_session(daemon, base, dl_bits, steps=4):
    """Bring a block daemon up over its control sockets, queue two
    windows of downlink bursts on every slot, run `steps` blocks and a
    flush. Returns ({carrier: [datagram bytes]}, clock beacons, q0)."""
    n = daemon.cfg.n_arfcn
    peer = base + daemon.cfg.peer_port_offset
    clock = UdpTransport(peer, "127.0.0.1", base)
    ctrl = [UdpTransport(peer + 3 * i + 1, "127.0.0.1", base + 3 * i + 1)
            for i in range(n)]
    data = [UdpTransport(peer + 3 * i + 2, "127.0.0.1", base + 3 * i + 2)
            for i in range(n)]
    try:
        def cmd(i, verb, *args):
            ctrl[i].send(proto.pack_command(verb, *args))
            daemon.step()
            rsp = ctrl[i].recv(128, timeout_ms=500)
            assert rsp is not None and b"RSP " + verb.encode() in rsp

        for i in range(n):
            cmd(i, "RXTUNE", 890000)
            cmd(i, "TXTUNE", 935000)
            cmd(i, "SETTSC", 0)
            for tn in range(1, 8):
                cmd(i, "SETSLOT", tn, 1)
        for i in range(n):
            cmd(i, "POWERON")
        assert daemon.on
        q0 = daemon.tx_fn
        for fn in range(q0, q0 + 26):
            for i in range(n):
                for tn in range(8):
                    data[i].send(proto.pack_downlink(proto.DownlinkBurst(
                        tn, fn, 0, dl_bits)))
        for _ in range(steps):
            daemon.step()
        daemon.flush()
        got = {i: [] for i in range(n)}
        for i in range(n):
            while (d := data[i].recv(256, timeout_ms=50)) is not None:
                got[i].append(d)
        beacons = []
        while (d := clock.recv(64, timeout_ms=50)) is not None:
            beacons.append(d)
        return got, beacons, q0
    finally:
        for s in [clock] + ctrl + data:
            s.close()


def test_block_daemon_over_the_wire_matches_jax(wire_scenario):
    """The port's BlockTrxDaemon and the JAX package's, each driven
    through the same wire session on the same ReplayBankRadio input:
    the uplink datagrams decode to the planted bursts and equal the JAX
    daemon's (header bytes exact, soft bytes ±1); the tx captures are the
    JAX daemon's within ±1 and demodulate to the queued bits; stale
    bursts are dumped."""
    ul_bits, dev = wire_scenario
    base = 51400
    dl_bits = norm_burst(seed=99)
    jr = jradio.ReplayBankRadio(dev.copy(), capture_tx_blocks=8)
    jd = jdaemon.BlockTrxDaemon(jr, jdaemon.TrxDaemonConfig(
        base_port=base, peer_port_offset=PEER, n_arfcn=N_BLK))
    jgot, _, jq0 = wire_session(jd, base, dl_bits)
    tr = tradio.ReplayBankRadio(dev.copy(), capture_tx_blocks=8)
    td = BlockTrxDaemon(tr, cpu_cfg(base + 20, n_arfcn=N_BLK))
    tgot, beacons, q0 = wire_session(td, base + 20, dl_bits)
    assert q0 == jq0

    for i in range(N_BLK):
        assert len(tgot[i]) == len(jgot[i]) >= 7 * 13 * 2
        a = np.frombuffer(b"".join(tgot[i]), np.uint8).reshape(-1, 158)
        b = np.frombuffer(b"".join(jgot[i]), np.uint8).reshape(-1, 158)
        np.testing.assert_array_equal(a[:, :8], b[:, :8])
        np.testing.assert_array_equal(a[:, 156:], b[:, 156:])
        assert_close_int(a[:, 8:156], b[:, 8:156], f"carrier {i} soft")
        bursts = [proto.unpack_uplink(d) for d in tgot[i]]
        assert {u.tn for u in bursts} == set(range(1, 8))
        for u in bursts[:8]:
            assert np.array_equal((u.soft > 0.5).astype(np.uint8),
                                  ul_bits[i, u.tn] & 1)
            assert abs(u.toa) <= 256
    assert beacons and all(proto.parse_message(m)[:2] == ("IND", "CLOCK")
                           for m in beacons)

    assert len(tr.tx_log) == len(jr.tx_log) > 0
    for (ts_t, tx_t), (ts_j, tx_j) in zip(tr.tx_log, jr.tx_log):
        assert ts_t == ts_j and tx_t.dtype == tx_j.dtype == np.int16
        assert_close_int(tx_t, tx_j, f"tx block at {ts_t}")
    assert tr.tx_log[0][0] == -ttrx.TX_DELAY_DEV
    start = td.cfg.start_fn + td.cfg.tx_latency_frames
    tx_q = tr.tx_log[(q0 - start) // 13][1]
    tx_c = torch.complex(torch.from_numpy(tx_q[..., 0]).float(),
                         torch.from_numpy(tx_q[..., 1]).float())
    sym_tx = tfir.polyphase_resample(tx_c, 65, 96,
                                     tfir.resampler_lpf(65, 96, 961))
    off = 65 + ((q0 - start) % 13) * 1250 + 157
    soft = tgmsk.demodulate_burst(
        sym_tx[:, off: off + 157], 1,
        torch.full((N_BLK,), td.engine_cfg.tx_full_scale,
                   dtype=torch.complex64), torch.zeros(N_BLK)).numpy()
    for i in range(N_BLK):
        assert np.array_equal((soft[i, :148] > 0.5).astype(np.uint8),
                              dl_bits & 1)

    # bursts for frames already transmitted are dumped, not sent
    stale = td.stale_dumped
    td.pending_tx.push((td.tx_fn - 30) % HYPERFRAME, 0, 0,
                       np.float32(0).tobytes() + dl_bits.tobytes())
    td.step()
    td.flush()
    assert td.stale_dumped > stale


def test_compact_retire_matches_dense(wire_scenario):
    """The compact result path (prefix-packed detected datagrams and live
    DAC rows, host-side filler replay) emits the dense path's datagrams
    and DAC blocks byte for byte, and fetches fewer bytes once the
    downlink goes sparse."""
    _, dev = wire_scenario

    def run(base, compact):
        radio = tradio.ReplayBankRadio(dev.copy(), capture_tx_blocks=10)
        daemon = BlockTrxDaemon(radio, cpu_cfg(base, n_arfcn=N_BLK),
                                compact=compact)
        peer = base + PEER
        ctrl = [UdpTransport(peer + 3 * i + 1, "127.0.0.1",
                             base + 3 * i + 1) for i in range(N_BLK)]
        data = [UdpTransport(peer + 3 * i + 2, "127.0.0.1",
                             base + 3 * i + 2) for i in range(N_BLK)]
        try:
            for i in range(N_BLK):
                for verb, a in (("RXTUNE", (890000,)), ("TXTUNE", (935000,)),
                                ("SETTSC", (0,))):
                    ctrl[i].send(proto.pack_command(verb, *a))
                for tn in range(1, 8):
                    ctrl[i].send(proto.pack_command("SETSLOT", tn, 1))
            daemon.step()
            for i in range(N_BLK):
                ctrl[i].send(proto.pack_command("POWERON"))
            daemon.step()
            # one real burst window on carrier 0, then filler everywhere
            q0 = daemon.tx_fn
            for fn in range(q0, q0 + 13):
                data[0].send(proto.pack_downlink(proto.DownlinkBurst(
                    3, fn, 0, norm_burst(seed=7))))
            for _ in range(6):
                daemon.step()
            daemon.flush()
            got = {i: [] for i in range(N_BLK)}
            for i in range(N_BLK):
                while (d := data[i].recv(256, timeout_ms=50)) is not None:
                    got[i].append(d)
            return daemon, radio, got
        finally:
            for s in ctrl + data:
                s.close()

    d_dense, r_dense, got_dense = run(51500, compact=False)
    d_comp, r_comp, got_comp = run(51520, compact=True)
    for i in range(N_BLK):
        assert got_comp[i] == got_dense[i], f"carrier {i} datagrams differ"
        assert len(got_comp[i]) >= 7 * 13 * 2
    assert len(r_comp.tx_log) == len(r_dense.tx_log)
    for (ts_c, tx_c), (ts_d, tx_d) in zip(r_comp.tx_log, r_dense.tx_log):
        assert ts_c == ts_d
        assert np.array_equal(tx_c, tx_d)
    assert d_comp._filler_tx is not None, "filler cache never captured"
    assert d_comp.d2h_bytes < d_dense.d2h_bytes
    assert d_comp.d2h_bytes_dense == pytest.approx(d_dense.d2h_bytes,
                                                   rel=0.01)
