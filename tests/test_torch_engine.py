"""The PyTorch port's receive engine (`rx_step`, `init_state`, the state
converter) against the JAX package, on the CPU.

Each case starts both engines from the same state (the JAX state carried
over with `convert.state_from_numpy`) and feeds both the same numpy
frames; detections, RSSI and timing must be equal, soft bits and float
state within the tolerances stated below.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openbts_ttsou_tpu.ops import gmsk as jgmsk
from openbts_ttsou_tpu.trx import engine as jeng
from openbts_ttsou_tpu.utils import constants as JC
from openbts_ttsou_tpu_torch import convert
from openbts_ttsou_tpu_torch.models import transceiver as ttrx
from openbts_ttsou_tpu_torch.trx import engine as teng

torch.set_num_threads(1)

SLOT = jeng.SLOT_SAMPLES


def normal_burst_bits(tsc=0, seed=1):
    rng = np.random.default_rng(seed)
    return np.concatenate(
        [[0, 0, 0], rng.integers(0, 2, 57), [1], JC.TRAINING_SEQUENCE[tsc],
         [1], rng.integers(0, 2, 57), [0, 0, 0]]).astype(np.uint8)


def rach_burst_bits():
    return np.concatenate(
        [[0, 1, 0, 1, 0, 1, 0, 1], JC.RACH_SYNCH_SEQUENCE,
         np.zeros(99, int)]).astype(np.uint8)


def wave(bits, sps=1):
    return 9000.0 * jgmsk.modulate_burst_np(bits[None], sps, guard_len=9)[0]


def mk_frame(rng, c, bursts_by_slot, sps=1, noise=1.0):
    frame = ((rng.standard_normal((c, 8, SLOT * sps))
              + 1j * rng.standard_normal((c, 8, SLOT * sps))) * noise
             ).astype(np.complex64)
    for (ch, tn), w in bursts_by_slot.items():
        n = min(len(w), SLOT * sps)
        frame[ch, tn, :n] += w[:n]
    return frame


def to_numpy(state):
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def assert_results(rt, rj, atol=2e-4):
    """Detections, RSSI and timing exact; soft bits within 2e-4 (float32
    demod/equalizer arithmetic in another order, as the JAX suite's own
    engine-equivalence bound, tests/test_exact_block.py:80)."""
    for name in ("detected", "is_rach", "rssi", "timing"):
        a, b = getattr(rt, name).numpy(), np.asarray(getattr(rj, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_allclose(rt.soft_bits.numpy(),
                               np.asarray(rj.soft_bits), atol=atol)


def assert_states(st, sj, atol=2e-4):
    """Integer/bool fields exact; float fields as
    tests/test_exact_block.py:93-103 compares the JAX engines."""
    tn = convert.state_to_numpy(st)
    for name, b in to_numpy(sj).items():
        a = tn[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, atol=atol, rtol=5e-6,
                                       err_msg=name)


def run_both(cfg, jstate, frames):
    """Step both engines over `frames` from the same entry state."""
    tcfg = teng.TrxConfig(**cfg._asdict())
    tstate = convert.state_from_numpy(to_numpy(jstate), "cpu")
    for fr in frames:
        jstate, rj = jeng.rx_step(cfg, jstate, jnp.asarray(fr))
        tstate, rt = teng.rx_step(tcfg, tstate, torch.from_numpy(fr))
        assert_results(rt, rj)
        assert_states(tstate, jstate)
    return tstate, jstate


def _state(cfg, chan_type, **kw):
    st = jeng.init_state(cfg)._replace(chan_type=jnp.asarray(chan_type))
    return st._replace(**{k: jnp.asarray(v) for k, v in kw.items()})


def test_init_state_matches_jax():
    for cfg in (jeng.TrxConfig(n_chan=3), jeng.TrxConfig(n_chan=1, sps=4)):
        tst = teng.init_state(teng.TrxConfig(**cfg._asdict()), "cpu")
        assert_states(tst, jeng.init_state(cfg), atol=0)


def test_expected_corr_type_matches_jax():
    ct = np.array([[0, 1, 2, 3, 4, 5, 6, 7], [8, 1, 5, 5, 7, 2, 4, 0]],
                  np.int32)
    fns = np.arange(0, 110, dtype=np.int32)
    want = np.stack([np.asarray(jeng.expected_corr_type(jnp.asarray(ct),
                                                        jnp.int32(f)))
                     for f in fns])
    got = teng.expected_corr_type(torch.from_numpy(ct),
                                  torch.from_numpy(fns)[:, None, None])
    np.testing.assert_array_equal(got.numpy(), want)


def test_rx_step_detects_tsc_and_rach():
    cfg = jeng.TrxConfig(n_chan=2)
    ct = np.zeros((2, 8), np.int32)
    ct[0, 1] = jeng.ChanType.I
    ct[1, 0] = jeng.ChanType.IV
    rng = np.random.default_rng(23)
    frames = [mk_frame(rng, 2, {(0, 1): wave(normal_burst_bits()),
                                (1, 0): wave(rach_burst_bits())})
              for _ in range(2)]
    tst, _ = run_both(cfg, _state(cfg, ct), frames)
    # the JAX suite's own expectation (tests/test_engine.py:115-118)
    np.testing.assert_allclose(tst.energy_threshold.numpy(), [248.0, 248.0])


def test_rx_step_false_alarm_and_quiet_decay():
    cfg = jeng.TrxConfig(n_chan=1)
    ct = np.zeros((1, 8), np.int32)
    ct[0, 3] = jeng.ChanType.I
    ct[0, 0] = jeng.ChanType.I
    rng = np.random.default_rng(5)
    loud = np.zeros((1, 8, SLOT), np.complex64)
    loud[0, 3] = ((rng.standard_normal(SLOT) + 1j * rng.standard_normal(SLOT))
                  * 5000.0).astype(np.complex64)
    quiet = np.zeros((1, 8, SLOT), np.complex64)
    run_both(cfg, _state(cfg, ct, fn=np.int32(100)), [loud, loud, quiet])


def test_rx_step_threshold_storm():
    """tests/test_engine.py:156: a false-alarm storm climbs the threshold
    until the gate closes, then >50-frame gaps walk it back down."""
    cfg = jeng.TrxConfig(n_chan=1)
    ct = np.zeros((1, 8), np.int32)
    ct[0, 3] = jeng.ChanType.I
    rng = np.random.default_rng(77)
    slot = (rng.standard_normal(SLOT)
            + 1j * rng.standard_normal(SLOT)).astype(np.complex64)
    slot *= 283.0 / np.sqrt(np.mean(np.abs(slot[:20]) ** 2))
    storm = np.zeros((1, 8, SLOT), np.complex64)
    storm[0, 3] = slot
    tst, jst = run_both(cfg, _state(cfg, ct), [storm] * 40)
    peak = float(tst.energy_threshold[0])
    assert peak > 283.0
    quiet = np.zeros((1, 8, SLOT), np.complex64)
    for _ in range(4):
        jst = jst._replace(fn=jnp.int32(int(jst.fn) + 60))
        tst, jst = run_both(cfg, jst, [quiet])
    assert float(tst.energy_threshold[0]) == pytest.approx(peak - 40.0)


def test_rx_step_dfe_and_rach_slots():
    """SETMAXDELAY > 1 opens the estimation gate: channel estimate, DFE
    design and the equalizer run in both engines; RACH restricted to
    slot 0."""
    cfg = jeng.TrxConfig(n_chan=2, rach_slots=(0,), max_toa=8)
    ct = np.full((2, 8), jeng.ChanType.I, np.int32)
    ct[:, 0] = jeng.ChanType.IV
    ct[1, 4] = jeng.ChanType.IV  # RACH-typed, outside rach_slots
    rng = np.random.default_rng(11)
    frames = []
    for k in range(3):
        bursts = {(0, 0): wave(rach_burst_bits()),
                  (1, 4): wave(rach_burst_bits())}
        for tn in range(1, 8):
            d = int(rng.integers(0, 3))
            w = wave(normal_burst_bits(seed=10 * k + tn))
            bursts[(0, tn)] = np.concatenate([np.zeros(d, np.complex64), w])
            bursts[(1, tn)] = w if tn != 4 else bursts[(1, 4)]
        frames.append(mk_frame(rng, 2, bursts, noise=20.0))
    tst, _ = run_both(cfg, _state(cfg, ct, max_expected_delay=np.array(
        [4, 2], np.int32)), frames)
    assert tst.chan_valid[:, 1:].any()


def test_rx_step_detects_at_sps4():
    sps = 4
    cfg = jeng.TrxConfig(n_chan=1, sps=sps)
    ct = np.full((1, 8), jeng.ChanType.I, np.int32)
    frame = np.zeros((1, 8, SLOT * sps), np.complex64)
    w = 9000.0 * jgmsk.modulate_burst_np(normal_burst_bits(seed=9)[None],
                                         sps)[0]
    frame[0, 3, : len(w)] = w
    tst, _ = run_both(cfg, _state(cfg, ct), [frame])
    assert int(tst.fn) == 1


def test_transceiver_rx_frame_matches_rx_step():
    cfg = teng.TrxConfig(n_chan=2)
    trx = ttrx.Transceiver(cfg, device="cpu")
    for tn in range(8):
        trx.set_slot(0, tn, teng.ChanType.I)
    trx.set_tsc(1, 3)
    trx.set_max_delay(1, 2)
    st0 = trx.state
    frame = mk_frame(np.random.default_rng(2), 2,
                     {(0, 2): wave(normal_burst_bits())})
    res = trx.rx_frame(frame)
    st1, want = teng.rx_step(cfg, st0, torch.from_numpy(frame))
    for a, b in zip(res, want):
        assert torch.equal(a, b)
    assert bool(res.detected[0, 2]) and int(trx.state.fn) == 1
    assert int(st0.tsc[1]) == 3 and int(st0.max_expected_delay[1]) == 2


# ---- (f) the state converter ----------------------------------------------

def test_convert_round_trip():
    cfg = jeng.TrxConfig(n_chan=3)
    rng = np.random.default_rng(3)
    d = to_numpy(jeng.init_state(cfg))
    d["energy_threshold"] = rng.uniform(0, 400, 3).astype(np.float32)
    d["chan_response"] = (rng.standard_normal((3, 8, 6))
                          + 1j * rng.standard_normal((3, 8, 6))
                          ).astype(np.complex64)
    d["chan_valid"] = rng.random((3, 8)) < 0.5
    d["fn"] = np.int32(2715000)
    st = convert.state_from_numpy(d, device="cpu")
    assert isinstance(st, teng.TrxState)
    assert st.fn.dtype == torch.int32 and st.fn.shape == ()
    back = convert.state_to_numpy(st)
    assert back.keys() == d.keys()
    for k, v in d.items():
        assert back[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    with pytest.raises(KeyError):
        convert.state_from_numpy({"fn": 0}, device="cpu")


# ---- (h) CUDA by default, never a silent CPU fallback ----------------------

def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is usable here")
    cfg = teng.TrxConfig(n_chan=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        teng.init_state(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrx.Transceiver(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.state_from_numpy(
            to_numpy(jeng.init_state(jeng.TrxConfig(n_chan=1))))
