"""The PyTorch port's sharded pipelines (`parallel/`) against the JAX
package's, on the CPU.

The JAX steps run under `shard_map` on the virtual 8-device CPU mesh
(tests/conftest.py); the port's on a `Mesh` of CPU shards in one
process, with the same numpy inputs: `exchange_halo`, the sharded
uplink over 2 steps with the state carry at a (2, 2) mesh, the duplex
step, and 2 chained steps of the streaming decode with the slot split.
Port-only: `resample_block` against the full stream, the cross-shard
state carry against the port's serial engine (carry tracks it, no carry
diverges), the duplex downlink against the serial `downlink_block`, and
the dry run at 2 and 8 shards with its byte counts.

Tolerances, port against JAX:
- detections, RACH flags, RSSI, timing, the TrxState's integer and bool
  fields, DecodedBlocks and the halo exchange: exact;
- soft bits: within 5e-3 (tests/test_parallel.py's sharded-vs-serial
  bound);
- float TrxState fields: exact where the step leaves them alone; the DFE
  carrier's channel and equalizer fields within the uplink suite's bound
  (atol 2e-4, rtol 5e-6, tests/test_torch_uplink.py);
- float tx: within 2e-4 of the peak (tests/test_torch_duplex.py); the
  port's sharded tx equals its serial `downlink_block` exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from openbts_ttsou_tpu.parallel import halo as jhalo
from openbts_ttsou_tpu.parallel import mesh as jmesh
from openbts_ttsou_tpu.parallel import sharded as jsh
from openbts_ttsou_tpu.trx import engine as jeng
from openbts_ttsou_tpu_torch import convert
from openbts_ttsou_tpu_torch.gsm import l1fec as tl1
from openbts_ttsou_tpu_torch.gsm.tdma import FACCH_TCHF
from openbts_ttsou_tpu_torch.models import transceiver as ttrx
from openbts_ttsou_tpu_torch.ops import fir as tfir
from openbts_ttsou_tpu_torch.ops import gmsk as tgmsk
from openbts_ttsou_tpu_torch.parallel import dryrun
from openbts_ttsou_tpu_torch.parallel import distributed as tdist
from openbts_ttsou_tpu_torch.parallel import halo as thalo
from openbts_ttsou_tpu_torch.parallel import mesh as tmesh
from openbts_ttsou_tpu_torch.parallel import sharded as tsh
from openbts_ttsou_tpu_torch.trx import engine as teng
from openbts_ttsou_tpu_torch.utils import constants as TC

torch.set_num_threads(1)

F = 13
C = 4  # carriers, 2 a chan shard on the (2, 2) mesh
STEPS = 2
OFFS = np.concatenate([[0], np.cumsum([157, 156, 156, 156] * 2)])[:8]
# the float state fields the DFE adoption writes (float32 sums in
# another order)
DFE_FIELDS = ("chan_response", "chan_resp_offset", "chan_amplitude", "snr",
              "dfe_forward", "dfe_feedback")


def t(x) -> torch.Tensor:
    """A writable copy as a tensor (JAX hands out read-only arrays)."""
    return torch.from_numpy(np.array(x))


def tcfg(cfg):
    return teng.TrxConfig(**cfg._asdict())


def jax_mesh(c, t_):
    return jax.sharding.Mesh(np.asarray(jax.devices()[:c * t_]).reshape(c, t_),
                             ("chan", "time"))


def jput(mesh, x, spec):
    return jax.device_put(x, NamedSharding(mesh, spec))


def jstate_sh(mesh, state, n_time):
    """The [time]-stacked state placed as the pipeline shards it, so the
    first and later steps share one compiled program."""
    st = jsh.state_for_shards(state, n_time)
    return jax.tree.map(lambda x, s: jput(mesh, x, s), st,
                        jsh.state_partition_specs())


def tstate_sh(jstate, n_time):
    return tsh.state_for_shards(convert.state_from_numpy(
        {k: np.asarray(v) for k, v in jstate._asdict().items()}, "cpu"),
        n_time)


def assert_results(tres, jres, what):
    for name in jres._fields:
        a, b = getattr(tres, name).numpy(), np.asarray(getattr(jres, name))
        assert a.shape == b.shape and a.dtype == b.dtype, (what, name)
        if name == "soft_bits":
            np.testing.assert_allclose(a, b, atol=5e-3, err_msg=what)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {name}")


def assert_state(tst, jst, what):
    for name in jst._fields:
        a, b = getattr(tst, name).numpy(), np.asarray(getattr(jst, name))
        assert a.shape == b.shape and a.dtype == b.dtype, (what, name)
        if name in DFE_FIELDS:
            np.testing.assert_allclose(a, b, atol=2e-4, rtol=5e-6,
                                       err_msg=f"{what} {name}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {name}")


# ---- mesh and halos ---------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 9, 12])
def test_mesh_factors_match_jax(n):
    assert tmesh.mesh_factors(n) == jmesh.mesh_factors(n)


def test_make_mesh_places_shards():
    m = tmesh.make_mesh(4, "cpu")
    assert m.shape == {"chan": 2, "time": 2} and len(m.local) == 4
    assert all(s.device == torch.device("cpu") and s.rank == 0
               for s in m.shards)
    assert [(s.chan, s.time) for s in m.shards] == [(0, 0), (0, 1), (1, 0),
                                                   (1, 1)]
    assert m.line(m.shards[2], "time") == [m.shards[2], m.shards[3]]
    assert m.line(m.shards[1], "chan") == [m.shards[1], m.shards[3]]
    # one process holds the whole grid
    assert tdist.host_local_shard((8, 4), m) == (slice(0, 8), slice(0, 4))
    assert tdist.initialize() is False  # a single process needs no group
    with pytest.raises(ValueError, match="rank"):
        tmesh.Mesh((1, 2), ["cpu", "cpu"], [0, 1])  # no process group


@pytest.mark.parametrize("grid,left,right", [((1, 4), 3, 2), ((2, 2), 4, 0),
                                             ((2, 2), 0, 5)])
def test_exchange_halo_matches_jax(grid, left, right):
    c, n = grid
    x = np.arange(c * 40, dtype=np.float32).reshape(c, 40) * 1.5 - 7.0
    jm = jax_mesh(c, n)
    want = np.asarray(jax.jit(jax.shard_map(
        lambda xl: jhalo.exchange_halo(xl, left, right, "time"), mesh=jm,
        in_specs=P("chan", "time"), out_specs=P("chan", "time")))(x))
    m = tmesh.Mesh(grid, ["cpu"] * (c * n))
    tl = 40 // n
    got = thalo.exchange_halo(
        m, {s: t(x[s.chan: s.chan + 1, s.time * tl: (s.time + 1) * tl])
            for s in m.local}, left, right)
    width = left + tl + right
    for s in m.local:
        np.testing.assert_array_equal(
            got[s].numpy(), want[s.chan: s.chan + 1,
                                 s.time * width: (s.time + 1) * width])
    if n > 1:
        assert m.traffic["permute"][0] == (left > 0) + (right > 0)
        assert m.traffic["permute"][1] == (left + right) * 4


def test_resample_block_matches_full_stream():
    """Each time block resampled from its halos equals the slice of the
    full-stream resample, at both ratios."""
    rng = np.random.default_rng(31)
    for p, q, taps in ((65, 96, 961), (96, 65, 651)):
        lpf = tfir.resampler_lpf(p, q, taps)
        halo = thalo.resample_halo(p, q, taps)
        n_blocks, block = 4, q * 25
        x = (rng.standard_normal((2, n_blocks * block))
             + 1j * rng.standard_normal((2, n_blocks * block))
             ).astype(np.complex64)
        full = tfir.polyphase_resample(t(x), p, q, lpf).numpy()
        m = tmesh.Mesh((1, n_blocks), ["cpu"] * n_blocks)
        xh = thalo.exchange_halo(
            m, {s: t(x[:, s.time * block: (s.time + 1) * block])
                for s in m.local}, halo, halo)
        ob = block * p // q
        for s in m.local:
            got = thalo.resample_block(xh[s], p, q, lpf, halo, block)
            np.testing.assert_allclose(
                got.numpy(), full[:, s.time * ob: (s.time + 1) * ob],
                rtol=0, atol=1e-5 * np.abs(full).max())


# ---- the sharded steps against JAX ------------------------------------------

def burst_stream(rng, c, frames, tsc=2):
    """[c, frames·1250] symbols: TSC bursts on slots 1-7 at delays of
    −2…2 symbols (8 in 10 slots), RACH bursts on slot 0 of every fourth
    frame, noise σ 20."""
    sym = (rng.standard_normal((c, frames * 1250, 2)) * 20.0
           ).astype(np.float32).view(np.complex64)[..., 0]
    for f in range(frames):
        for ch in range(c):
            for tn in range(8):
                start = f * 1250 + OFFS[tn]
                if tn == 0:
                    if f % 4 != 1:
                        continue
                    bits = np.zeros(148, np.uint8)
                    bits[:8] = [0, 1, 0, 1, 0, 1, 0, 1]
                    bits[8:49] = TC.RACH_SYNCH_SEQUENCE
                    bits[49:85] = rng.integers(0, 2, 36)
                elif rng.random() < 0.8:
                    bits = rng.integers(0, 2, 148).astype(np.uint8)
                    bits[61:87] = TC.TRAINING_SEQUENCE[tsc]
                    start += int(rng.integers(-2, 3))
                else:
                    continue
                w = 9000.0 * tgmsk.modulate_burst_np(bits[None], 1,
                                                     guard_len=9)[0]
                end = min(start + len(w), sym.shape[1])
                sym[ch, start:end] += w[: end - start]
    return sym


def to_device_rate(sym):
    return tfir.polyphase_resample(t(sym), 96, 65,
                                   tfir.resampler_lpf(96, 65, 651)).numpy()


@pytest.fixture(scope="module")
def stream():
    """STEPS steps of a (2, 2) mesh: the device-rate uplink, a downlink
    window for the first step, and the entry state (slot 0 combination
    IV, slots 1-7 I, TSC 2; carriers 1 and 3 run the DFE)."""
    rng = np.random.default_rng(11)
    n_time = 2
    frames = STEPS * n_time * F
    dev = to_device_rate(burst_stream(rng, C, frames))
    cfg = jeng.TrxConfig(n_chan=C, rach_slots=(0,))
    combos = np.full((C, 8), jeng.ChanType.I, np.int32)
    combos[:, 0] = jeng.ChanType.IV
    state = jeng.init_state(cfg)._replace(
        chan_type=jnp.asarray(combos), tsc=jnp.full((C,), 2, jnp.int32),
        max_expected_delay=jnp.asarray([0, 4, 0, 4], jnp.int32))
    dl = (rng.integers(0, 2, (n_time * F, C, 8, 148)).astype(np.uint8),
          rng.random((n_time * F, C, 8)) < 0.7,
          rng.integers(0, 10, (n_time * F, C, 8)).astype(np.float32))
    return cfg, state, dev, dl


@pytest.fixture(scope="module")
def jax_uplink(stream):
    """JAX's sharded uplink over STEPS steps with the carry."""
    cfg, state, dev, _ = stream
    jm = jax_mesh(2, 2)
    spec = jsh.ShardedPipelineSpec(n_chan_total=C, frames_per_shard=F)
    step = jsh.sharded_uplink_pipeline(jm, cfg, spec)
    st = jstate_sh(jm, state, 2)
    block = 2 * spec.block_in
    out = []
    for s in range(STEPS):
        st, res, clock = step(
            st, jput(jm, dev[:, s * block: (s + 1) * block],
                     P("chan", "time")),
            jput(jm, jnp.asarray(s * 2 * F, jnp.int32), P()))
        out.append((jax.device_get(st), jax.device_get(res), int(clock)))
    return out


def test_sharded_uplink_matches_jax(stream, jax_uplink):
    cfg, state, dev, _ = stream
    m = tmesh.make_mesh(4, "cpu")
    spec = tsh.ShardedPipelineSpec(n_chan_total=C, frames_per_shard=F)
    step = tsh.sharded_uplink_pipeline(m, tcfg(cfg), spec)
    st = tstate_sh(state, 2)
    block = 2 * spec.block_in
    for s, (jst, jres, jclock) in enumerate(jax_uplink):
        m.reset_traffic()
        st, res, clock = step(st, t(dev[:, s * block: (s + 1) * block]),
                              s * 2 * F)
        assert_results(res, jres, f"step {s}")
        assert_state(st, jst, f"step {s}")
        assert int(clock) == jclock == 2 * spec.block_in
        # one step's traffic: the rx halo ring, 2 sums and a max, the
        # merge's 9 all-gathers
        assert m.traffic["permute"] == [2, 2 * 2 * spec.halo_in * 8]
        assert m.traffic["all-reduce"][0] == 3
        assert m.traffic["all-gather"][0] == 9
    assert int(res.detected.sum()) > 400 and bool(res.is_rach.any())


def test_sharded_duplex_matches_jax(stream):
    cfg, state, dev, (bits, valid, atten) = stream
    jm = jax_mesh(2, 2)
    spec = jsh.ShardedPipelineSpec(n_chan_total=C, frames_per_shard=F)
    x = dev[:, : 2 * spec.block_in]
    jst, jres, jtx, jclock = jsh.sharded_duplex_pipeline(jm, cfg, spec)(
        jstate_sh(jm, state, 2), jput(jm, x, P("chan", "time")),
        *(jput(jm, a, P("time", "chan")) for a in (bits, valid, atten)),
        jput(jm, jnp.asarray(0, jnp.int32), P()))
    m = tmesh.make_mesh(4, "cpu")
    tst, tres, ttx, tclock = tsh.sharded_duplex_pipeline(
        m, tcfg(cfg), spec)(tstate_sh(state, 2), t(x), t(bits), t(valid),
                            t(atten), 0)
    assert_results(tres, jax.device_get(jres), "duplex")
    assert_state(tst, jax.device_get(jst), "duplex")
    assert int(tclock) == int(jclock)
    jtx = np.asarray(jtx)
    assert ttx.shape == jtx.shape
    np.testing.assert_allclose(ttx.numpy(), jtx, rtol=0,
                               atol=2e-4 * np.abs(jtx).max())
    # the overlap-save identity: the sharded downlink is the serial one
    serial = ttrx.downlink_block(
        tcfg(cfg), ttrx.UplinkSpec(frames=2 * F),
        convert.state_from_numpy(
            {k: np.asarray(v) for k, v in state._asdict().items()}, "cpu"),
        t(bits), t(valid), t(atten))
    assert torch.equal(ttx, serial)
    assert m.traffic["permute"] == [4, 2 * 2 * (spec.halo_in + 65) * 8]


def test_sharded_steps_without_collectives(stream):
    """collectives=False (benchmark isolation): zero halos and no merge;
    the shards' own frames away from the edges still match."""
    cfg, state, dev, _ = stream
    m = tmesh.make_mesh(4, "cpu")
    spec = tsh.ShardedPipelineSpec(n_chan_total=C, frames_per_shard=F)
    x = t(dev[:, : 2 * spec.block_in])
    st0 = tstate_sh(state, 2)
    _, with_c, _ = tsh.sharded_uplink_pipeline(m, tcfg(cfg), spec)(st0, x, 0)
    m.reset_traffic()
    st, without, clock = tsh.sharded_uplink_pipeline(
        m, tcfg(cfg), spec, collectives=False)(st0, x, 0)
    assert m.traffic == {}
    assert int(clock) == 2 * spec.block_in
    inner = [f for f in range(2 * F) if f % F not in (0, F - 1)]
    assert torch.equal(with_c.detected[inner], without.detected[inner])
    # no merge: each time shard keeps its own end state
    assert not torch.equal(st.fn[0], st.fn[1])


# ---- the streaming decode, time-sharded ---------------------------------------

def tch_air_stream(n_chan, n_windows):
    """The device-rate air stream of TCH/FS speech on slot 2 of every
    carrier, from the port's downlink encoder window by window (the JAX
    test_sharded_streaming_decode_spanning_groups drive), and the frames
    sent."""
    rng = np.random.default_rng(41)
    cfg = teng.TrxConfig(n_chan=n_chan)
    rev = FACCH_TCHF.reverse_map()
    fn0 = int(np.where(rev == 0)[0][0])
    while fn0 % 4:
        fn0 += 26
    tch_mask = torch.zeros((n_chan, 8), dtype=torch.bool)
    tch_mask[:, 2] = True
    ct = torch.zeros((n_chan, 8), dtype=torch.int32)
    ct[:, 2] = teng.ChanType.I
    state = teng.init_state(cfg, "cpu")._replace(chan_type=ct)
    carry = tl1.TchTxCarry.zeros(n_chan * 8, "cpu")
    xcch = torch.zeros((3, n_chan, 8, 184), dtype=torch.uint8)
    xv = torch.zeros((3, n_chan, 8), dtype=torch.bool)
    atten = torch.zeros((13, n_chan, 8))
    sent, devs = [], []
    for w in range(n_windows):
        sp = np.zeros((3, n_chan, 8, 260), np.uint8)
        spv = np.zeros((3, n_chan, 8), bool)
        for j in range(3 if w < n_windows - 1 else 0):
            d = rng.integers(0, 2, 260).astype(np.uint8)
            sp[j, :, 2], spv[j, :, 2] = d, True
            sent.append(d)
        dev, carry = ttrx.downlink_block_tch(
            cfg, ttrx.UplinkSpec(), state, xcch, xv, t(sp), t(spv),
            torch.zeros((3, n_chan, 8, 184), dtype=torch.uint8),
            torch.zeros((3, n_chan, 8), dtype=torch.bool), tch_mask, atten,
            carry, torch.tensor(fn0 + 13 * w, dtype=torch.int32))
        devs.append(dev.numpy() / cfg.tx_full_scale * 9000.0)
    return fn0, np.concatenate(devs, axis=-1), sent


def test_sharded_decoded_matches_jax():
    """2 chained decoded steps at a (2, 2) mesh, 1 carrier a chan shard:
    groups spanning shard boundaries decode through the neighbour hop,
    those spanning the step boundary through prev_soft; every field of
    DecodedBlocks, the results and the state equal JAX's."""
    from openbts_ttsou_tpu.models.transceiver import DECODE_PRELUDE

    n_chan, n_time = 2, 2
    fn0, stream, sent = tch_air_stream(n_chan, 2 * n_time + 1)
    cfg = jeng.TrxConfig(n_chan=n_chan)
    ct = np.zeros((n_chan, 8), np.int32)
    ct[:, 2] = jeng.ChanType.I
    state = jeng.init_state(cfg)._replace(chan_type=jnp.asarray(ct),
                                          fn=jnp.asarray(fn0, jnp.int32))
    spec = jsh.ShardedPipelineSpec(n_chan_total=n_chan, frames_per_shard=F)
    kw = dict(xcch_tns=(0, 1, 6, 7), tch_tns=(2, 3, 4, 5))
    jm = jax_mesh(2, 2)
    jstep = jsh.sharded_uplink_pipeline(jm, cfg, spec, mode="decoded", **kw)
    tm = tmesh.make_mesh(4, "cpu")
    tstep = tsh.sharded_uplink_pipeline(tm, tcfg(cfg), spec, mode="decoded",
                                        **kw)
    jst, tst = jstate_sh(jm, state, n_time), tstate_sh(state, n_time)
    block = n_time * spec.block_in
    jprev = jput(jm, np.zeros((1, DECODE_PRELUDE, n_chan, 8, 148),
                              np.float32), P(None, None, "chan"))
    tprev = torch.zeros((1, DECODE_PRELUDE, n_chan, 8, 148))
    jpv, tpv = jput(jm, jnp.asarray(False), P()), torch.tensor(False)
    good = 0
    for k in range(2):
        win = np.ascontiguousarray(stream[:, k * block: (k + 1) * block])
        fnk = fn0 + F * n_time * k
        jst, jres, jclock, jdec = jstep(
            jst, jput(jm, win, P("chan", "time")),
            jput(jm, jnp.asarray(fnk, jnp.int32), P()), jprev, jpv)
        tst, tres, tclock, tdec = tstep(tst, t(win), fnk, tprev, tpv)
        jdec, jres = jax.device_get(jdec), jax.device_get(jres)
        for name in jdec._fields:
            a, b = getattr(tdec, name).numpy(), np.asarray(getattr(jdec,
                                                                   name))
            assert a.shape == b.shape and a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=f"step {k} {name}")
        assert_results(tres, jres, f"decoded step {k}")
        assert_state(tst, jax.device_get(jst), f"decoded step {k}")
        jprev = jres.soft_bits[-DECODE_PRELUDE:][None]
        jprev = jput(jm, jprev, P(None, None, "chan"))
        tprev = tres.soft_bits[-DECODE_PRELUDE:][None]
        jpv, tpv = jput(jm, jnp.asarray(True), P()), torch.tensor(True)
        good += int(tdec.tch_good.sum())
        # the soft-bit tail crosses the time-shard boundary: one hop
        assert tm.traffic["permute"][0] == 3 * (k + 1)
    assert good >= n_chan * (len(sent) - 6)


# ---- the state carry against the port's serial engine ----------------------

def test_cross_shard_state_carry():
    """The port's counterpart of tests/test_parallel.py::
    test_cross_shard_state_carry, against the port's serial engine.
    Near-threshold bursts whose detection depends on the accumulated
    threshold adaptation: slot 1 opens its energy gate only after the
    first quiet decrement (−10 at frame 51), slot 2 (from frame 104, a
    step boundary) only after ~50 slot-1 hits (−1 each). With the carry
    the step-boundary thresholds and every detection match the serial
    engine; without it each shard misses the other's hits and slot 2
    stays undetected."""
    n_time, steps = 2, 6
    frames_total = steps * n_time * F  # 156
    cfg = teng.TrxConfig(n_chan=1)
    spec = tsh.ShardedPipelineSpec(n_chan_total=1, frames_per_shard=F)
    bits = np.concatenate([[0, 0, 0], np.random.default_rng(5).integers(
        0, 2, 57), [1], TC.TRAINING_SEQUENCE[0], [1],
        np.random.default_rng(6).integers(0, 2, 57), [0, 0, 0]]
    ).astype(np.uint8)
    wave = tgmsk.modulate_burst_np(bits[None], 1)[0]
    up = tfir.resampler_lpf(96, 65, 651)
    down = tfir.resampler_lpf(65, 96, 961)
    # calibrate the energy gate (mean power of the slot window's first 20
    # samples against threshold²) after the 96/65 up, 65/96 down trip
    pilot = np.zeros((1, 13 * 1250), np.complex64)
    pilot[0, 6 * 1250 + 157: 6 * 1250 + 157 + len(wave)] = wave
    rt = tfir.polyphase_resample(tfir.polyphase_resample(t(pilot), 96, 65,
                                                         up), 65, 96,
                                 down).numpy()
    pw20 = np.mean(np.abs(rt[0, 6 * 1250 + 157: 6 * 1250 + 177]) ** 2)
    a1 = np.sqrt(60000.0 / pw20)  # between 240² and 250²
    a2 = np.sqrt(40000.0 / pw20)  # needs a threshold under 200
    sym = np.zeros((1, frames_total * 1250), np.complex64)
    for f in range(frames_total):
        off = f * 1250 + 157
        sym[0, off: off + len(wave)] += a1 * wave
        if f >= 104:
            sym[0, off + 156: off + 156 + len(wave)] += a2 * wave
    dev = tfir.polyphase_resample(t(sym), 96, 65, up)
    ct = torch.zeros((1, 8), dtype=torch.int32)
    ct[0, 1] = ct[0, 2] = teng.ChanType.I
    state0 = teng.init_state(cfg, "cpu")._replace(chan_type=ct)

    wins = ttrx._slot_windows(tfir.polyphase_resample(dev, 65, 96, down),
                              frames_total)
    st, det_serial, thr_serial = state0, [], []
    for f in range(frames_total):
        st, r = teng.rx_step(cfg, st, wins[f])
        det_serial.append(r.detected)
        if (f + 1) % (n_time * F) == 0:
            thr_serial.append(float(st.energy_threshold[0]))
    det_serial = torch.stack(det_serial)
    assert not det_serial[:51, 0, 1].any() and det_serial[52:, 0, 1].all()
    assert det_serial[104:, 0, 2].all() and not det_serial[:104, 0, 2].any()

    mesh = tmesh.Mesh((1, n_time), ["cpu"] * n_time)

    def run(carry):
        step = tsh.sharded_uplink_pipeline(mesh, cfg, spec,
                                           carry_state=carry)
        st_sh = tsh.state_for_shards(state0, n_time)
        dets, thrs = [], []
        block = n_time * spec.block_in
        for s in range(steps):
            st_sh, res, _ = step(st_sh, dev[:, s * block: (s + 1) * block],
                                 s * n_time * F)
            dets.append(res.detected)
            thrs.append(float(st_sh.energy_threshold[0, 0]))
        return torch.cat(dets), thrs

    det_carry, thr_carry = run(True)
    assert torch.equal(det_carry, det_serial)
    np.testing.assert_allclose(thr_carry, thr_serial, atol=1e-3)
    det_nc, thr_nc = run(False)
    assert det_nc[104:, 0, 2].sum() < det_serial[104:, 0, 2].sum()
    assert not np.allclose(thr_nc, thr_serial, atol=1.0)


# ---- the dry run --------------------------------------------------------------

@pytest.mark.parametrize("shards", [2, 8])
def test_dryrun_byte_counts(shards):
    """`python -m openbts_ttsou_tpu_torch.parallel.dryrun`'s checks on the
    CPU, with the JAX inventory's figures at 2 carriers a chan shard."""
    out = dryrun.run(shards, "cpu")
    c_local = 2
    halo = tsh.ShardedPipelineSpec(4, 13).halo_in
    assert out["ok"] and out["mesh"] == dict(zip(
        ("chan", "time"), tmesh.mesh_factors(shards)))
    assert out["uplink_traffic"]["permute"] == {
        "count": 2, "bytes_per_step": 2 * c_local * halo * 8}
    assert out["duplex_traffic"]["permute"]["bytes_per_step"] == \
        2 * c_local * (halo + 65) * 8
    assert out["uplink_traffic"]["all-reduce"]["bytes_per_step"] < 1024
    assert out["duplex_bytes_per_step"] < 0.05 * \
        out["local_input_bytes_per_step"]
