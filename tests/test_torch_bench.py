"""The port's benchmark program (`openbts_ttsou_tpu_torch.bench`) against
the JAX package, on the CPU.

The stimulus is `bench.py`'s recipe re-derived here from the JAX package;
each mode's chained blocks are held against a JAX loop over the JAX
block functions with the per-block inputs of `bench.py`'s scan bodies
(the carrier roll by fn % 3, the gain perturbation, the counter's
handling), one JAX compile a mode reused across blocks; and two runs
from one initial state agree. `main()`, the sweep and `entry()` are
tests/test_torch_bench_main.py's.

Tolerances, port against JAX:
- symbol streams, downlink bits and content, per-block counts,
  detections, timing, RACH flags, RSSI: exact;
- the device-rate stimulus: rtol 2e-4, atol 2e-4 of the peak
  (tests/test_torch_ops.py's bound on the resampler);
- soft bits 2e-4 (tests/test_torch_engine.py), so a probe that sums n
  soft bits within n·2e-4; a probe that sums n values quantized to
  integers (soft bits ×255, int16 DAC samples) within n (each ±1);
  float tx samples 2e-4 of the peak each.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openbts_ttsou_tpu.gsm import l1fec as jl1
from openbts_ttsou_tpu.models import transceiver as jtrx
from openbts_ttsou_tpu.ops import fir as jfir
from openbts_ttsou_tpu.ops import gmsk as jgmsk
from openbts_ttsou_tpu.trx import engine as jeng
from openbts_ttsou_tpu.utils import constants as JC
from openbts_ttsou_tpu_torch import bench
from openbts_ttsou_tpu_torch.models import transceiver as ttrx
from openbts_ttsou_tpu_torch.trx import engine as teng

torch.set_num_threads(1)

SPEC = jtrx.UplinkSpec()
TSPEC = ttrx.UplinkSpec()
F = SPEC.frames
C = 3  # carriers: three, so the rolls by fn % 3 all differ
BLOCKS = 3  # 2k with k = 1 would miss the roll by 2; 3 blocks see all three
HYPERFRAME = 2715648


def jax_stimulus(c):
    """`bench.py`'s recipe (:162-195, 214-219, 288-299) through the JAX
    package: (symbols, device-rate samples, dl_bits, content)."""
    rng = np.random.default_rng(0)
    sym = (rng.standard_normal((c, SPEC.block_symbols))
           + 1j * rng.standard_normal((c, SPEC.block_symbols))
           ).astype(np.complex64) * 10.0
    bits = np.concatenate(
        [[0, 0, 0], rng.integers(0, 2, 57), [1], JC.TRAINING_SEQUENCE[0],
         [1], rng.integers(0, 2, 57), [0, 0, 0]]).astype(np.uint8)
    wave = 9000.0 * jgmsk.modulate_burst_np(bits[None], 1)[0]
    for ch in range(c):
        for f in range(F):
            off = f * 1250 + 157
            sym[ch, off: off + 148] += wave
    dev = np.asarray(jfir.polyphase_resample(
        jnp.asarray(sym), 96, 65, jfir.resampler_lpf(96, 65, 651))
        [:, : SPEC.block_in])
    dl_bits = np.random.default_rng(1).integers(
        0, 2, (F, c, 8, 148)).astype(np.uint8)
    rng3 = np.random.default_rng(2)
    tch_mask = np.zeros((c, 8), bool)
    tch_mask[:, 2:6] = True
    frames184 = rng3.integers(0, 2, (4, c, 8, 184)).astype(np.uint8)
    xv = np.ones((4, c, 8), bool)
    speech = rng3.integers(0, 2, (3, c, 8, 260)).astype(np.uint8)
    content = (frames184, xv, speech, np.ones((3, c, 8), bool),
               np.zeros((3, c, 8, 184), np.uint8), np.zeros((3, c, 8), bool),
               tch_mask)
    return sym, dev, dl_bits, content


def jax_state(cfg):
    ct = np.full((cfg.n_chan, 8), jeng.ChanType.I, np.int32)
    ct[:, 0] = jeng.ChanType.IV
    return jeng.init_state(cfg)._replace(chan_type=jnp.asarray(ct))


def jax_blocks(mode, cfg, x, dl_bits, content, n):
    """n blocks of `mode` through the JAX block functions, the per-block
    inputs as `bench.py`'s scan bodies build them (:221-364), one block
    a call. Returns (probes [n], counts [n], max |tx| over the blocks)."""
    c = cfg.n_chan
    st = jax_state(cfg)
    x = jnp.asarray(x)
    dl_bits = jnp.asarray(dl_bits)
    dl_valid = jnp.ones((F, c, 8), bool)
    dl_atten = jnp.zeros((F, c, 8), jnp.float32)
    probes, counts = [], []
    tail = jnp.zeros((c, jtrx.TX_TAIL_SYM), jnp.complex64)
    halo = jnp.pad(x, ((0, 0), (jtrx.RX_HALO_DEV, jtrx.RX_HALO_DEV)))
    ul_i16 = jnp.clip(jnp.round(jnp.stack([jnp.real(halo), jnp.imag(halo)],
                                          -1)), -32767, 32767
                      ).astype(jnp.int16)
    tc = (jl1.TchTxCarry.zeros(c * 8), jtrx.XcchTxCarry.zeros(c))
    prev = jnp.zeros((jtrx.DECODE_PRELUDE, c, 8, 148), jnp.float32)
    pv = jnp.asarray(False)
    jcontent = tuple(jnp.asarray(a) for a in content)
    fn = jnp.asarray(0, jnp.int32)
    peak = 0.0
    for _ in range(n):
        da = dl_atten + (fn % 977).astype(jnp.float32) * 1e-6
        if mode in ("exact", "decoded"):
            s = jnp.roll(x, st.fn % 3, axis=0)
            block = (jtrx.uplink_block if mode == "exact"
                     else jtrx.uplink_block_decoded)
            out = block(cfg, SPEC, st, s)
            st, res = out[0], out[1]
            probe = jnp.sum(res.soft_bits[..., 0])
            if mode == "decoded":
                probe = probe + jnp.sum(out[2].bits[..., 0])
            count = jnp.sum(res.detected)
        elif mode == "downlink":
            tx = jtrx.downlink_block(cfg, SPEC, st, dl_bits, dl_valid, da, fn)
            probe, count = jnp.sum(jnp.real(tx[..., 0])), jnp.sum(dl_valid)
        elif mode == "duplex":
            ul = jnp.roll(ul_i16, fn % 3, axis=0)
            st, tx, tail, wire = jtrx.duplex_block_wire(
                cfg, SPEC, st, ul, tail, dl_bits, dl_valid, da, fn, True)
            probe = (jnp.sum(wire.soft_u8[..., 0].astype(jnp.int32))
                     + jnp.sum(tx[:, 0, :].astype(jnp.int32)))
            count = jnp.sum(wire.detected)
        else:
            ul = jnp.roll(halo, fn % 3, axis=0)
            st = st._replace(fn=fn % HYPERFRAME)
            st, tx, tail, blocks, tc, prev, pv = jtrx.duplex_block_decoded(
                cfg, SPEC, st, ul, tail, jcontent, da, tc, fn, prev, pv,
                0, 0, bench.XCCH_TNS, bench.TCH_TNS)
            probe = (jnp.sum(blocks.bits[..., 0].astype(jnp.int32))
                     + jnp.sum(jnp.real(tx[:, 0]))
                     + jnp.sum(blocks.tch_speech[..., 0].astype(jnp.int32)))
            count = jnp.sum(blocks.ok) + jnp.sum(blocks.tch_good)
        if mode in ("downlink", "duplex_decoded"):
            peak = max(peak, float(jnp.max(jnp.abs(tx))))
        fn = fn + F
        probes.append(float(probe))
        counts.append(int(count))
    return np.asarray(probes), np.asarray(counts), peak


@pytest.fixture(scope="module")
def stim():
    """The port's stimulus at C carriers on the CPU, and the JAX
    recipe's."""
    return bench.stimulus(C, "cpu", TSPEC), jax_stimulus(C)


def test_stimulus_equals_the_jax_recipe(stim):
    port, (sym, dev, dl_bits, content) = stim
    np.testing.assert_array_equal(bench.bench_symbols(C, F), sym)
    got = port.samples.numpy()
    assert got.shape == dev.shape == (C, SPEC.block_in)
    np.testing.assert_allclose(got, dev, rtol=2e-4,
                               atol=2e-4 * np.abs(dev).max())
    np.testing.assert_array_equal(port.dl_bits.numpy(), dl_bits)
    assert port.dl_valid.all() and not port.dl_atten.any()
    assert port.dl_valid.shape == port.dl_atten.shape == (F, C, 8)
    for a, b in zip(port.content, content, strict=True):
        np.testing.assert_array_equal(a.numpy(), b)


# (mode, TrxConfig overrides, probe tolerance a summed term)
CASES = {
    "exact": ("exact", {}),
    "exact_max_toa_4": ("exact", {"max_toa": 4}),
    "exact_rach_slot_0": ("exact", {"rach_slots": (0,)}),
    "decoded": ("decoded", {}),
    "downlink": ("downlink", {}),
    "duplex": ("duplex", {}),
    "duplex_decoded": ("duplex_decoded", {}),
}


def probe_atol(mode, c, peak):
    """The bound on a mode's probe: its summed terms times each term's
    bound (see the module's docstring); `peak` is max |tx|."""
    soft = F * c * 8  # soft bits in a block's probe
    return {"exact": soft * 2e-4,
            "decoded": soft * 2e-4,  # plus FEC bits, exact
            "downlink": c * 2e-4 * peak,
            "duplex": soft + 2 * c,  # soft ×255 and int16 I/Q, ±1 each
            "duplex_decoded": c * 2e-4 * peak}[mode]  # decoded bits exact


@pytest.mark.parametrize("case", list(CASES))
def test_mode_matches_a_jax_loop(stim, case):
    """run_blocks over 3 blocks against the JAX loop: counts exact,
    probes within the stated bound."""
    mode, over = CASES[case]
    port, (_, _, dl_bits, content) = stim
    jcfg = jeng.TrxConfig(n_chan=C, **over)
    tcfg = teng.TrxConfig(**jcfg._asdict())
    step, carry = bench.make_step(mode, tcfg, TSPEC,
                                  bench.bench_state(tcfg, "cpu"), port)
    probes, counts = bench.run_blocks(step, carry, BLOCKS)
    x = port.samples.numpy()
    want_p, want_c, peak = jax_blocks(mode, jcfg, x, dl_bits, content,
                                      BLOCKS)
    np.testing.assert_array_equal(counts.numpy(), want_c)
    np.testing.assert_allclose(probes.numpy().astype(np.float64), want_p,
                               rtol=0, atol=probe_atol(mode, C, peak))
    if mode in ("exact", "duplex"):  # the recipe's known answer
        assert (counts.numpy() == F * C).all()
    if mode == "downlink":
        assert (counts.numpy() == F * C * 8).all()


@pytest.mark.parametrize("mode", ["exact", "duplex_decoded"])
def test_reps_from_one_initial_state_agree(stim, mode):
    """Two runs from the same initial carry (not copied) give identical
    counts and probes: no block function writes into the state."""
    port, _ = stim
    cfg = teng.TrxConfig(n_chan=C)
    step, carry = bench.make_step(mode, cfg, TSPEC,
                                  bench.bench_state(cfg, "cpu"), port)
    before = bench.clone_carry(carry)
    a = bench.run_blocks(step, carry, 2)
    b = bench.run_blocks(step, carry, 2)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    flat = [(u, v) for u, v in zip(torch.utils._pytree.tree_leaves(carry),
                                   torch.utils._pytree.tree_leaves(before))]
    assert flat and all(torch.equal(u, v) if isinstance(u, torch.Tensor)
                        else u == v for u, v in flat)
