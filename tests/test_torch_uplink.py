"""The PyTorch port's uplink chain (`uplink_block`, `process_block_exact`,
the per-frame `rx_step` schedule) against the JAX package, on the CPU.

Adversarial symbol streams (the stream maker of tests/test_exact_block.py:42-77:
planted TSC and RACH bursts, noise-only frames, energy without detection,
DFE carriers with stale or invalid channel state) are brought to the
device rate once with the 96/65 resampler and fed, as the same numpy
samples, to both packages over consecutive 13-frame blocks.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openbts_ttsou_tpu.models import transceiver as jtrx
from openbts_ttsou_tpu.ops import gmsk as jgmsk
from openbts_ttsou_tpu.trx import engine as jeng
from openbts_ttsou_tpu.utils import constants as JC
from openbts_ttsou_tpu_torch import convert
from openbts_ttsou_tpu_torch.models import transceiver as ttrx
from openbts_ttsou_tpu_torch.ops import fir as tfir
from openbts_ttsou_tpu_torch.trx import engine as teng

torch.set_num_threads(1)

SPEC = jtrx.UplinkSpec()
TSPEC = ttrx.UplinkSpec()
F = SPEC.frames
FRAME = 1250


def make_stream(rng, c, tsc=2, amp=9000.0, rach_frames=(), tsc_rate=0.7,
                energy_noise_frames=(), noise=20.0):
    """[C, F·1250] symbol stream with planted bursts (as
    tests/test_exact_block.py:42-77 builds it)."""
    sym = (rng.standard_normal((c, F * FRAME, 2)) * noise
           ).astype(np.float32).view(np.complex64)[..., 0]
    offs = np.concatenate([[0], np.cumsum([157, 156, 156, 156] * 2)])[:8]
    for f in range(F):
        for ch in range(c):
            for tn in range(8):
                start = f * FRAME + offs[tn]
                if f in rach_frames and tn == 0:
                    bits = np.zeros(148, np.uint8)
                    bits[:8] = [0, 1, 0, 1, 0, 1, 0, 1]
                    bits[8:49] = JC.RACH_SYNCH_SEQUENCE
                    bits[49:85] = rng.integers(0, 2, 36)
                elif rng.random() < tsc_rate:
                    bits = rng.integers(0, 2, 148).astype(np.uint8)
                    bits[61:87] = JC.TRAINING_SEQUENCE[tsc]
                elif f in energy_noise_frames:
                    sym[ch, start: start + 157] += (
                        rng.standard_normal((157, 2)) * amp * 0.5
                    ).astype(np.float32).view(np.complex64)[..., 0]
                    continue
                else:
                    continue
                w = amp * jgmsk.modulate_burst_np(bits[None], 1,
                                                  guard_len=9)[0]
                end = min(start + len(w), sym.shape[1])
                sym[ch, start:end] += w[: end - start]
    return sym


def device_rate(sym):
    """Symbol stream → device-rate samples [C, block_in] (96/65, 651 taps,
    the bench's preparation)."""
    lpf = tfir.resampler_lpf(96, 65, 651)
    x = tfir.polyphase_resample(torch.from_numpy(sym), 96, 65, lpf)
    return np.ascontiguousarray(x[:, : SPEC.block_in].numpy())


def assert_results(rt, rj, atol=2e-4):
    """detected/is_rach/rssi/timing exact; soft bits within 2e-4 (the JAX
    suite's own engine-equivalence bound, tests/test_exact_block.py:80)."""
    for name in ("detected", "is_rach", "rssi", "timing"):
        a, b = getattr(rt, name).numpy(), np.asarray(getattr(rj, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_allclose(rt.soft_bits.numpy(),
                               np.asarray(rj.soft_bits), atol=atol)


def assert_states(st, sj, atol=2e-4):
    """As tests/test_exact_block.py:93-103: integer and bool fields exact,
    float fields to atol 2e-4 / rtol 5e-6 (float32, another order)."""
    tn = convert.state_to_numpy(st)
    for name in sj._fields:
        a, b = tn[name], np.asarray(getattr(sj, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, atol=atol, rtol=5e-6,
                                       err_msg=name)


def _base_state(cfg, combo=jeng.ChanType.I, tsc=2, max_delay=0):
    c = cfg.n_chan
    return jeng.init_state(cfg)._replace(
        chan_type=jnp.full((c, 8), combo, jnp.int32),
        tsc=jnp.full((c,), tsc, jnp.int32),
        max_expected_delay=jnp.full((c,), max_delay, jnp.int32))


def case_tsc_only(rng):
    cfg = jeng.TrxConfig(n_chan=2)
    return cfg, _base_state(cfg), [make_stream(rng, 2) for _ in range(2)]


def case_rach_and_mixed_combos(rng):
    cfg = jeng.TrxConfig(n_chan=2, rach_slots=(0,))
    combos = np.full((2, 8), jeng.ChanType.I, np.int32)
    combos[:, 0] = jeng.ChanType.V
    combos[:, 1] = jeng.ChanType.II
    combos[:, 7] = jeng.ChanType.VII
    st = _base_state(cfg)._replace(chan_type=jnp.asarray(combos))
    return cfg, st, [make_stream(rng, 2, rach_frames=(1, 5, 9))
                     for _ in range(2)]


def case_threshold_walk_adversarial(rng):
    cfg = jeng.TrxConfig(n_chan=2)
    st = _base_state(cfg)._replace(
        energy_threshold=jnp.full((2,), 900.0, jnp.float32),
        prev_false_detect_fn=jnp.full((2,), -60, jnp.int32))
    return cfg, st, [
        make_stream(rng, 2, tsc_rate=0.0, noise=5.0),
        make_stream(rng, 2, tsc_rate=0.0, energy_noise_frames=(0, 1, 2, 6),
                    noise=5.0),
        make_stream(rng, 2, tsc_rate=0.9)]


def case_dfe_adoption(rng):
    cfg = jeng.TrxConfig(n_chan=2, max_toa=8)
    st = _base_state(cfg, max_delay=4)
    return cfg, st, [make_stream(rng, 2, tsc_rate=0.8),
                     make_stream(rng, 2, tsc_rate=0.4,
                                 energy_noise_frames=(2, 3)),
                     make_stream(rng, 2, tsc_rate=0.8)]


def case_max_toa_window(rng):
    cfg = jeng.TrxConfig(n_chan=2, max_toa=6)
    st = _base_state(cfg)._replace(
        max_expected_delay=jnp.asarray([0, 1], jnp.int32))
    return cfg, st, [make_stream(rng, 2) for _ in range(2)]


CASES = {f.__name__[5:]: f for f in (
    case_tsc_only, case_rach_and_mixed_combos,
    case_threshold_walk_adversarial, case_dfe_adoption, case_max_toa_window)}


def drive_both(cfg, jstate, streams):
    tcfg = teng.TrxConfig(**cfg._asdict())
    tstate = convert.state_from_numpy(jstate._asdict(), "cpu")
    for sym in streams:
        x = device_rate(sym)
        jstate, rj = jtrx.uplink_block(cfg, SPEC, jstate, jnp.asarray(x))
        tstate, rt = ttrx.uplink_block(tcfg, TSPEC, tstate,
                                       torch.from_numpy(x))
        assert_results(rt, rj)
        assert_states(tstate, jstate)
    return tstate, jstate


@pytest.mark.parametrize("case", sorted(CASES))
def test_uplink_block_matches_jax(case):
    seed = sorted(CASES).index(case) + 7
    cfg, st, streams = CASES[case](np.random.default_rng(seed))
    drive_both(cfg, st, streams)


def test_rx_step_schedule_matches_jax(monkeypatch):
    """The per-frame rx_step loop (the schedule above the boundary) gives
    the batched schedule's results; the JAX package pins its two
    schedules equal (tests/test_exact_block.py)."""
    monkeypatch.setattr(ttrx, "EXACT_BATCH_MAX_CHAN", 0)
    cfg, st, streams = case_dfe_adoption(np.random.default_rng(41))
    drive_both(cfg, st, streams)


@pytest.mark.parametrize("n_chan", [1, 128, 512, 1024,
                                    ttrx.EXACT_BATCH_MAX_CHAN])
def test_exact_schedule_is_batched_up_to_the_boundary(n_chan):
    """The card runs the batched schedule at the widths it serves (512
    and 1024 carriers included); the frame loop only above the boundary,
    where the batched schedule's memory grows past its share."""
    assert ttrx.exact_schedule(n_chan) == "batched"
    assert ttrx.exact_schedule(ttrx.EXACT_BATCH_MAX_CHAN + 1) == "frames"


def test_process_block_exact_matches_jax():
    """The port's batched schedule on its own, fed the symbols that the
    JAX uplink_block resamples internally (to process_block_exact)."""
    cfg, st, streams = case_tsc_only(np.random.default_rng(43))
    tcfg = teng.TrxConfig(**cfg._asdict())
    tst = convert.state_from_numpy(st._asdict(), "cpu")
    lpf = tfir.resampler_lpf(SPEC.p, SPEC.q, SPEC.taps)
    for sym in streams:
        x = device_rate(sym)
        st, rj = jtrx.uplink_block(cfg, SPEC, st, jnp.asarray(x))
        s = tfir.polyphase_resample(torch.from_numpy(x), SPEC.p, SPEC.q, lpf)
        tst, rt = ttrx.process_block_exact(tcfg, F, tst,
                                           s[:, : SPEC.block_symbols])
        assert_results(rt, rj)
        assert_states(tst, st)


def test_transceiver_process_uplink_bench_recipe():
    """The bench recipe at 2 carriers (bench.py:162-195): every block
    gives 26 detections, all in slot 1, no RACH, timing 6, and the
    per-carrier energy threshold falls by 13 per block from 250."""
    c = 2
    cfg = teng.TrxConfig(n_chan=c)
    trx = ttrx.Transceiver(cfg, TSPEC, device="cpu")
    for ch in range(c):
        trx.set_slot(ch, 0, teng.ChanType.IV)
        for tn in range(1, 8):
            trx.set_slot(ch, tn, teng.ChanType.I)
    rng = np.random.default_rng(0)
    sym = (rng.standard_normal((c, TSPEC.block_symbols))
           + 1j * rng.standard_normal((c, TSPEC.block_symbols))
           ).astype(np.complex64) * 10.0
    bits = np.concatenate(
        [[0, 0, 0], rng.integers(0, 2, 57), [1], JC.TRAINING_SEQUENCE[0],
         [1], rng.integers(0, 2, 57), [0, 0, 0]]).astype(np.uint8)
    w = 9000.0 * jgmsk.modulate_burst_np(bits[None], 1)[0]
    for ch in range(c):
        for f in range(F):
            sym[ch, f * FRAME + 157: f * FRAME + 157 + 148] += w
    x = torch.from_numpy(device_rate(sym))
    for k in range(3):
        res = trx.process_uplink(x)
        det = res.detected.numpy()
        assert det.sum() == c * F and det[:, :, 1].all()
        assert not res.is_rach.any()
        assert (res.timing.numpy()[det] == 6).all()
        soft = res.soft_bits.numpy()
        assert np.isfinite(soft).all() and soft.min() >= 0 and soft.max() <= 1
        np.testing.assert_array_equal(trx.state.energy_threshold.numpy(),
                                      np.full(c, 250.0 - 13 * (k + 1)))
