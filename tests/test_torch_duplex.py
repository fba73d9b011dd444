"""The PyTorch port's downlink and streaming duplex block against the JAX
package, on the CPU.

The same numpy inputs (made from seeds) go through both packages: the
GMSK modulator, `ops/signal.py`, the transmit engine (`tx_frames`,
`tx_step`), `_assemble_stream`, the halo resampler, `downlink_block`,
and the three duplex forms (`duplex_block_wire` in both `io_i16` forms,
`duplex_block_packed`, `duplex_block_compact`) over 3 consecutive blocks
of one stream, with the state and the tx tail carried block to block.

Tolerances, port against JAX:
- detections, RSSI, timing, header and datagram header bytes, carrier
  indices and the TrxState's integer and bool fields: exact;
- float TrxState fields: exact where the block leaves them alone; the
  DFE carrier's channel and equalizer fields within the uplink suite's
  bound (atol 2e-4, rtol 5e-6, tests/test_torch_uplink.py);
- soft bytes and int16 tx samples: within ±1, at most 0.1% off by 1
  (float32 sums in another order move a value across a rounding edge);
- float tx: within 2e-4 of the peak (tests/test_pallas.py:23).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openbts_ttsou_tpu.models import transceiver as jtrx
from openbts_ttsou_tpu.ops import gmsk as jgmsk
from openbts_ttsou_tpu.ops import signal as jsig
from openbts_ttsou_tpu.parallel import halo as jhalo
from openbts_ttsou_tpu.trx import engine as jeng
from openbts_ttsou_tpu.utils import constants as JC
from openbts_ttsou_tpu_torch import convert
from openbts_ttsou_tpu_torch.models import transceiver as ttrx
from openbts_ttsou_tpu_torch.ops import cuda_fir
from openbts_ttsou_tpu_torch.ops import fir as tfir
from openbts_ttsou_tpu_torch.ops import gmsk as tgmsk
from openbts_ttsou_tpu_torch.ops import signal as tsig
from openbts_ttsou_tpu_torch.parallel import halo as thalo
from openbts_ttsou_tpu_torch.trx import engine as teng

torch.set_num_threads(1)

SPEC = jtrx.UplinkSpec()
TSPEC = ttrx.UplinkSpec()
F = SPEC.frames
C = 2
BLOCKS = 3
HALO = jtrx.RX_HALO_DEV
OFFS = np.concatenate([[0], np.cumsum([157, 156, 156, 156] * 2)])[:8]
# slot 0 RACH (combination IV), slots 1-7 TSC (I); carrier 1 runs the DFE
CFG = jeng.TrxConfig(n_chan=C, rach_slots=(0,))
# float state fields the DFE adoption writes (float32 sums, another order)
DFE_FIELDS = ("chan_response", "chan_resp_offset", "chan_amplitude", "snr",
              "dfe_forward", "dfe_feedback")


def t(x) -> torch.Tensor:
    """A writable copy as a tensor (JAX hands out read-only arrays)."""
    return torch.from_numpy(np.array(x))


def tcfg(cfg):
    return teng.TrxConfig(**cfg._asdict())


def assert_close_int(a, b, what):
    """Integers within ±1, at most 0.1% of them off by 1."""
    d = np.abs(np.asarray(a, np.int64) - np.asarray(b, np.int64))
    assert d.max(initial=0) <= 1, f"{what}: max diff {d.max()}"
    assert (d > 0).mean() <= 1e-3, f"{what}: {(d > 0).mean():.2%} off by 1"


def assert_state(tst, jst):
    """Integer and bool fields exact, float fields exact but the DFE
    adoption's, which hold the uplink suite's bound."""
    tn = convert.state_to_numpy(tst)
    for name in jst._fields:
        a, b = tn[name], np.asarray(getattr(jst, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if name in DFE_FIELDS:
            np.testing.assert_allclose(a, b, atol=2e-4, rtol=5e-6,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def burst_bits(rng, tsc):
    bits = rng.integers(0, 2, 148).astype(np.uint8)
    bits[61:87] = JC.TRAINING_SEQUENCE[tsc]
    return bits


def entry_state():
    combos = np.full((C, 8), jeng.ChanType.I, np.int32)
    combos[:, 0] = jeng.ChanType.IV
    return jeng.init_state(CFG)._replace(
        chan_type=jnp.asarray(combos),
        tsc=jnp.full((C,), 2, jnp.int32),
        max_expected_delay=jnp.asarray([0, 4], jnp.int32))


@pytest.fixture(scope="module")
def scenario():
    """One continuous uplink stream of BLOCKS 13-frame blocks (+1 frame
    of right halo) at the device rate: TSC-2 bursts on slots 1-7 at
    delays of −2…2 symbols (negative TOAs), RACH bursts on slot 0 of
    some frames, noise; and a random downlink window per block, with
    filler slots and attenuations 0-9 dB."""
    rng = np.random.default_rng(11)
    frames = BLOCKS * F + 1
    sym = (rng.standard_normal((C, frames * 1250, 2)) * 20.0
           ).astype(np.float32).view(np.complex64)[..., 0]
    for f in range(frames):
        for ch in range(C):
            for tn in range(8):
                start = f * 1250 + OFFS[tn]
                if tn == 0:
                    if f % 4 != 1:
                        continue
                    bits = np.zeros(148, np.uint8)
                    bits[:8] = [0, 1, 0, 1, 0, 1, 0, 1]
                    bits[8:49] = JC.RACH_SYNCH_SEQUENCE
                    bits[49:85] = rng.integers(0, 2, 36)
                elif rng.random() < 0.8:
                    bits = burst_bits(rng, 2)
                    start += int(rng.integers(-2, 3))
                else:
                    continue
                w = 9000.0 * jgmsk.modulate_burst_np(bits[None], 1,
                                                     guard_len=9)[0]
                end = min(start + len(w), sym.shape[1])
                sym[ch, start:end] += w[: end - start]
    lpf = tfir.resampler_lpf(96, 65, 651)
    dev = tfir.polyphase_resample(t(sym), 96, 65, lpf).numpy()
    dev = np.pad(dev, ((0, 0), (HALO, 0)))  # stream start: cold history
    windows = [np.ascontiguousarray(
        dev[:, k * SPEC.block_in: (k + 1) * SPEC.block_in + 2 * HALO])
        for k in range(BLOCKS)]
    dl = [(rng.integers(0, 2, (F, C, 8, 148)).astype(np.uint8),
           rng.random((F, C, 8)) < 0.7,
           rng.integers(0, 10, (F, C, 8)).astype(np.float32))
          for _ in range(BLOCKS)]
    return windows, dl


def to_i16(x):
    return np.clip(np.stack([x.real, x.imag], -1).round(), -32767,
                   32767).astype(np.int16)


# ---- ops ------------------------------------------------------------------

@pytest.mark.parametrize("sps,guard", [(1, 0), (1, 9), (4, 9)])
def test_modulate_burst_matches_jax(sps, guard):
    """rtol 1e-5 of the peak (float32 sums of 3·sps+1 real taps)."""
    bits = np.random.default_rng(sps + guard).integers(
        0, 2, (3, 5, 148)).astype(np.uint8)
    want = np.asarray(jgmsk.modulate_burst(jnp.asarray(bits), sps,
                                           guard_len=guard))
    got = tgmsk.modulate_burst(t(bits), sps, guard_len=guard).numpy()
    assert got.shape == want.shape and got.dtype == np.complex64
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    # the numpy set-up modulator is the same function
    np.testing.assert_allclose(got, tgmsk.modulate_burst_np(bits, sps,
                                                            guard),
                               atol=1e-5 * np.abs(want).max())


def test_gmsk_rotations_match_jax():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4, 300)) + 1j * rng.standard_normal((4, 300))
         ).astype(np.complex64)
    for jf, tf in ((jgmsk.gmsk_rotate, tgmsk.gmsk_rotate),
                   (jgmsk.gmsk_reverse_rotate, tgmsk.gmsk_reverse_rotate)):
        np.testing.assert_allclose(tf(t(x), 2).numpy(),
                                   np.asarray(jf(jnp.asarray(x), 2)),
                                   rtol=1e-5, atol=1e-6)


def _signal_cases():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((3, 200)) + 1j * rng.standard_normal((3, 200))
         ).astype(np.complex64)
    xr = rng.standard_normal((3, 200)).astype(np.float32)
    lin = np.array([-1.0, 0.0, 1e-30, 1e-8, 0.3, 1.0, 7.0], np.float32)
    dbs = np.array([-250.0, -30.0, -3.0, -0.1, 0.0, 4.0], np.float32)
    ix = rng.uniform(-3.0, 203.0, (3,)).astype(np.float32)
    return {
        "norm2": lambda m: m.norm2(x),
        "power": lambda m: m.power(x),
        "db": lambda m: m.db(lin),
        "db_inv": lambda m: m.db_inv(dbs),
        "frequency_shift": lambda m: m.frequency_shift(x, 0.37, 0.5),
        "sinc_interpolate": lambda m: m.sinc_interpolate(x, ix),
        "resample_linear": lambda m: m.resample_linear(x, 1.7, 320),
        "resample_linear_real": lambda m: m.resample_linear(xr, 0.6, 90),
    }


class _Args:
    """Calls a module's function with its arrays as tensors (port) or
    jax arrays (reference)."""

    def __init__(self, mod, conv):
        self.mod, self.conv = mod, conv

    def __getattr__(self, name):
        fn = getattr(self.mod, name)
        return lambda *a, **k: fn(*[self.conv(v) if isinstance(v, np.ndarray)
                                    else v for v in a], **k)


@pytest.mark.parametrize("name", sorted(_signal_cases()))
def test_signal_ops_match_jax(name):
    """rtol 1e-5 (atol 1e-5 of the peak for the oscillator's zeros)."""
    call = _signal_cases()[name]
    want = np.asarray(call(_Args(jsig, jnp.asarray)))
    got = call(_Args(tsig, t)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_gaussian_noise_statistics():
    """The port draws from a torch.Generator, JAX from a key: the samples
    differ, the statistics agree (variance within 2%, circular, zero
    mean), and a generator seeded alike gives the same samples."""
    var = 9.0
    gen = torch.Generator().manual_seed(4)
    x = tsig.gaussian_noise(gen, (200_000,), var).numpy()
    assert x.dtype == np.complex64
    import jax

    y = np.asarray(jsig.gaussian_noise(jax.random.PRNGKey(4), (200_000,),
                                       var))
    for z in (x, y):
        assert abs(np.mean(np.abs(z) ** 2) / var - 1) < 0.02
        assert abs(np.var(z.real) / np.var(z.imag) - 1) < 0.03
        assert abs(z.mean()) < 0.05
    again = tsig.gaussian_noise(torch.Generator().manual_seed(4),
                                (200_000,), var).numpy()
    np.testing.assert_array_equal(x, again)


# ---- engine and stream assembly -----------------------------------------

def _tx_inputs(seed, frames):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (frames, C, 8, 148)).astype(np.uint8)
    valid = rng.random((frames, C, 8)) < 0.6
    atten = rng.uniform(0.0, 12.0, (frames, C, 8)).astype(np.float32)
    return bits, valid, atten


def test_tx_frames_and_tx_step_match_jax():
    """Valid and filler slots, attenuations 0-12 dB: within 1e-5 of the
    peak (float32 modulation, and 10^(−a/10) by another pow); the filler
    slots copy the table, exactly."""
    bits, valid, atten = _tx_inputs(6, 4)
    jst = jeng.init_state(CFG)
    tst = convert.state_from_numpy(jst._asdict(), "cpu")
    want = np.asarray(jeng.tx_frames(CFG, jst, jnp.asarray(bits),
                                     jnp.asarray(valid), jnp.asarray(atten)))
    got = teng.tx_frames(tcfg(CFG), tst, t(bits), t(valid), t(atten)).numpy()
    assert got.shape == want.shape == (4, C, 8, teng.SLOT_SAMPLES)
    peak = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-5 * peak)
    np.testing.assert_array_equal(got[~valid], want[~valid])
    # 156-sample slots end in a zero
    assert not np.abs(got[:, :, [1, 2, 3, 5, 6, 7], 156]).any()
    step_j = np.asarray(jeng.tx_step(CFG, jst, jnp.asarray(bits[1]),
                                     jnp.asarray(valid[1]),
                                     jnp.asarray(atten[1]), jst.fn))
    step_t = teng.tx_step(tcfg(CFG), tst, t(bits[1]), t(valid[1]),
                          t(atten[1]), tst.fn).numpy()
    np.testing.assert_allclose(step_t, step_j, atol=1e-5 * peak)
    # the Transceiver wrapper's tx_frame is tx_step on its own state
    trx = ttrx.Transceiver(tcfg(CFG), TSPEC, device="cpu")
    np.testing.assert_array_equal(
        trx.tx_frame(bits[1], valid[1], atten[1]).numpy(), step_t)


def test_assemble_stream_is_exact():
    bits, valid, atten = _tx_inputs(7, F)
    jst = jeng.init_state(CFG)
    slots = np.asarray(jeng.tx_frames(CFG, jst, jnp.asarray(bits),
                                      jnp.asarray(valid), jnp.asarray(atten)))
    want = np.asarray(jtrx._assemble_stream(jnp.asarray(slots)))
    got = ttrx._assemble_stream(t(slots)).numpy()
    assert got.shape == want.shape == (C, F * 1250)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p,q,taps", [(65, 96, 961), (96, 65, 651)])
def test_resample_block_matches_jax(p, q, taps):
    """Halo width identical; the block's outputs within 2e-4 of the peak
    of JAX's resample_block, and equal to the full-stream resample's
    slice (the overlap-save identity)."""
    assert thalo.resample_halo(p, q, taps) == jhalo.resample_halo(p, q, taps)
    halo = thalo.resample_halo(p, q, taps)
    block = 20 * q
    rng = np.random.default_rng(p)
    x = (rng.standard_normal((C, 3 * block)) +
         1j * rng.standard_normal((C, 3 * block))).astype(np.complex64)
    xh = np.ascontiguousarray(x[:, block - halo: 2 * block + halo])
    lpf = tfir.resampler_lpf(p, q, taps)
    got = thalo.resample_block(t(xh), p, q, lpf, halo, block).numpy()
    want = np.asarray(jhalo.resample_block(jnp.asarray(xh), p, q, lpf,
                                           halo, block))
    assert got.shape == want.shape == (C, block * p // q)
    peak = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=2e-4 * peak)
    full = tfir.polyphase_resample(t(x), p, q, lpf).numpy()
    np.testing.assert_allclose(got, full[:, block * p // q: 2 * block * p // q],
                               atol=1e-5 * peak)


@pytest.mark.parametrize("p,q,taps,n_in,start,n_keep,inst", [
    (65, 96, 961, SPEC.block_in + 2 * HALO, 65, SPEC.block_symbols, "R5U21"),
    (96, 65, 651, jtrx.TX_TAIL_SYM + SPEC.block_symbols,
     jtrx.TX_DELAY_DEV, SPEC.block_in, "R4U10")])
def test_duplex_k1_calls_plan_onto_compiled_instantiations(
        p, q, taps, n_in, start, n_keep, inst):
    """K1's two calls a duplex block, [C, 24192] at 65/96 and [C, 16380]
    at 96/65, run the kernel's compile-time instantiations (not the
    runtime-width one), and their outputs cover the slices the block
    keeps."""
    lpf = tfir.resampler_lpf(p, q, taps)
    assert cuda_fir.instantiation(p, q, lpf) == inst
    assert (n_in, tfir.polyphase_output_len(n_in, p, q)) == {
        65: (24192, 16380), 96: (16380, 24192)}[p]
    assert start + n_keep <= tfir.polyphase_output_len(n_in, p, q)
    assert cuda_fir.instantiation(3, 200, tfir.resampler_lpf(3, 200, 31)
                                  ) == "runtime"


def test_downlink_block_matches_jax():
    """Float tx within 2e-4 of the peak."""
    bits, valid, atten = _tx_inputs(8, F)
    jst = entry_state()
    tst = convert.state_from_numpy(jst._asdict(), "cpu")
    want = np.asarray(jtrx.downlink_block(
        CFG, SPEC, jst, jnp.asarray(bits), jnp.asarray(valid),
        jnp.asarray(atten), jnp.asarray(0, jnp.int32)))
    got = ttrx.downlink_block(tcfg(CFG), TSPEC, tst, t(bits), t(valid),
                              t(atten)).numpy()
    assert got.shape == want.shape == (C, SPEC.block_in)
    np.testing.assert_allclose(got, want, atol=2e-4 * np.abs(want).max())


# ---- the duplex block -----------------------------------------------------

@pytest.mark.parametrize("io_i16", [False, True])
def test_duplex_block_wire_streams_match_jax(scenario, io_i16):
    """3 streamed blocks, state and tx tail carried: detections, RSSI,
    timing and state as above, soft bytes ±1, tx within 2e-4 of the peak
    (float) or ±1 (int16)."""
    windows, dl = scenario
    jst = entry_state()
    tst = convert.state_from_numpy(jst._asdict(), "cpu")
    jtail = jnp.zeros((C, jtrx.TX_TAIL_SYM), jnp.complex64)
    ttail = torch.zeros((C, ttrx.TX_TAIL_SYM), dtype=torch.complex64)
    n_det = n_neg = 0
    for k in range(BLOCKS):
        ul = to_i16(windows[k]) if io_i16 else windows[k]
        bits, valid, atten = dl[k]
        jst, jtx, jtail, jw = jtrx.duplex_block_wire(
            CFG, SPEC, jst, jnp.asarray(ul), jtail, jnp.asarray(bits),
            jnp.asarray(valid), jnp.asarray(atten),
            jnp.asarray(k * F, jnp.int32), io_i16)
        tst, ttx, ttail, tw = ttrx.duplex_block_wire(
            tcfg(CFG), TSPEC, tst, t(ul), ttail, t(bits), t(valid),
            t(atten), k * F, io_i16=io_i16)
        for name in ("detected", "rssi", "timing"):
            np.testing.assert_array_equal(getattr(tw, name).numpy(),
                                          np.asarray(getattr(jw, name)),
                                          err_msg=f"block {k} {name}")
        assert tw.soft_u8.dtype == torch.uint8
        assert_close_int(tw.soft_u8.numpy(), np.asarray(jw.soft_u8),
                         f"block {k} soft bytes")
        want = np.asarray(jtx)
        if io_i16:
            assert ttx.dtype == torch.int16
            assert ttx.shape == (C, SPEC.block_in, 2)
            assert_close_int(ttx.numpy(), want, f"block {k} tx")
        else:
            np.testing.assert_allclose(ttx.numpy(), want,
                                       atol=2e-4 * np.abs(want).max())
        np.testing.assert_allclose(ttail.numpy(), np.asarray(jtail),
                                   atol=1e-5 * np.abs(np.asarray(jtail)).max())
        assert_state(tst, jst)
        det = tw.detected.numpy()
        n_det += int(det.sum())
        n_neg += int((tw.timing.numpy()[det] < 0).sum())
    assert int(tst.fn) == BLOCKS * F
    assert n_det > 0 and n_neg > 0, (n_det, n_neg)


def _check_datagrams(got, want, what):
    """[n, 158(+2)] rows: every byte exact but the soft bytes (±1)."""
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(got[:, :8], want[:, :8],
                                  err_msg=f"{what}: header bytes")
    np.testing.assert_array_equal(got[:, 156:], want[:, 156:],
                                  err_msg=f"{what}: trailer bytes")
    assert_close_int(got[:, 8:156], want[:, 8:156], f"{what}: soft bytes")


def test_duplex_block_packed_matches_jax(scenario):
    """One uint8 buffer each way; fn0 and tx_fn0 decoded on the device:
    the datagrams (negative TOAs among them) and detection bytes as
    above, the DAC bytes as int16 within ±1."""
    windows, dl = scenario
    jst = entry_state()
    tst = convert.state_from_numpy(jst._asdict(), "cpu")
    jtail = jnp.zeros((C, jtrx.TX_TAIL_SYM), jnp.complex64)
    ttail = torch.zeros((C, ttrx.TX_TAIL_SYM), dtype=torch.complex64)
    fn0, tx_fn0 = 2715600, 2715602  # the hyperframe wraps in block 0
    for k in range(BLOCKS):
        bits, valid, atten = dl[k]
        buf = jtrx.pack_dl_buffer(bits, valid, atten, fn0 + k * F,
                                  tx_fn0 + k * F, ul_i16=to_i16(windows[k]))
        jst, jtail, jout = jtrx.duplex_block_packed(
            CFG, SPEC, jst, jnp.asarray(buf), jtail)
        tst, ttail, tout = ttrx.duplex_block_packed(
            tcfg(CFG), TSPEC, tst, t(buf), ttail)
        assert tout.dtype == torch.uint8
        jtx, jp, jd = jtrx.unpack_block_result(np.asarray(jout), C, SPEC)
        ttx, tp, td = ttrx.unpack_block_result(tout.numpy(), C, TSPEC)
        assert_close_int(ttx, jtx, f"block {k} tx")
        np.testing.assert_array_equal(td, jd)
        _check_datagrams(tp.reshape(-1, jtrx.UL_PKT),
                         jp.reshape(-1, jtrx.UL_PKT), f"block {k}")
        assert_state(tst, jst)
        # negative TOAs leave as two's complement, and the hyperframe wraps
        toa = tp[..., 6:8].astype(np.int64)
        toa = ((toa[..., 0] << 8) | toa[..., 1]).astype(np.uint16
                                                          ).view(np.int16)
        assert (toa[td] < 0).any()
    assert int(tst.fn) == (fn0 + BLOCKS * F) % jtrx.HYPERFRAME


def test_duplex_block_compact_matches_jax(scenario):
    """Header bytes (n_det, n_live) exact; only pkt_buf[:n_det] and
    tx_buf[:n_live] are compared (the drop slots are undefined)."""
    windows, dl = scenario
    jst = entry_state()
    tst = convert.state_from_numpy(jst._asdict(), "cpu")
    jtail = jnp.zeros((C, jtrx.TX_TAIL_SYM), jnp.complex64)
    ttail = torch.zeros((C, ttrx.TX_TAIL_SYM), dtype=torch.complex64)
    for k, live in enumerate(([True, True], [False, True], [True, False])):
        bits, valid, atten = dl[k]
        buf = jtrx.pack_dl_buffer_live(bits, valid, atten, 100 + k * F,
                                       102 + k * F, to_i16(windows[k]),
                                       np.asarray(live))
        jst, jtail, jh, jtb, jpb = jtrx.duplex_block_compact(
            CFG, SPEC, jst, jnp.asarray(buf), jtail)
        tst, ttail, th, ttb, tpb = ttrx.duplex_block_compact(
            tcfg(CFG), TSPEC, tst, t(buf), ttail)
        th = th.numpy()
        np.testing.assert_array_equal(th, np.asarray(jh))
        n_det = int.from_bytes(th[:4].tobytes(), "big")
        n_live = int.from_bytes(th[4:].tobytes(), "big")
        assert n_live == sum(live) and n_det > 0
        assert ttb.shape == (C + 1, SPEC.block_in * 4)
        assert tpb.shape == (F * C * 8 + 1, jtrx.UL_PKT_C)
        assert_close_int(ttb[:n_live].numpy().view("<i2"),
                         np.asarray(jtb)[:n_live].view("<i2"),
                         f"block {k} tx rows")
        _check_datagrams(tpb[:n_det].numpy(), np.asarray(jpb)[:n_det],
                         f"block {k}")
        assert_state(tst, jst)


def test_host_buffers_are_byte_identical():
    """pack_dl_buffer(_live) and unpack_block_result: the port's copies
    give the JAX package's bytes."""
    bits, valid, atten = _tx_inputs(9, F)
    gain = atten.astype(np.int64) - 3  # the byte wraps below 0
    rng = np.random.default_rng(9)
    ul = rng.integers(-32767, 32768, (C, SPEC.block_in + 2 * HALO, 2)
                      ).astype(np.int16)
    live = np.array([True, False])
    for args in ((bits, valid, gain, 7, 2715647),
                 (bits, valid, gain, 7, 9)):
        np.testing.assert_array_equal(ttrx.pack_dl_buffer(*args),
                                      jtrx.pack_dl_buffer(*args))
        np.testing.assert_array_equal(
            ttrx.pack_dl_buffer(*args, ul_i16=ul),
            jtrx.pack_dl_buffer(*args, ul_i16=ul))
        np.testing.assert_array_equal(
            ttrx.pack_dl_buffer_live(*args, ul, live),
            jtrx.pack_dl_buffer_live(*args, ul, live))
    n = C * SPEC.block_in * 4 + F * C * 8 * (jtrx.UL_PKT + 1)
    out = rng.integers(0, 256, n).astype(np.uint8)
    for a, b in zip(ttrx.unpack_block_result(out, C, TSPEC),
                    jtrx.unpack_block_result(out, C, SPEC)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (ttrx.DL_ROW, ttrx.UL_PKT, ttrx.UL_PKT_C, ttrx.PACK_HDR,
            ttrx.RX_HALO_DEV, ttrx.TX_TAIL_SYM, ttrx.TX_DELAY_DEV) == (
        jtrx.DL_ROW, jtrx.UL_PKT, jtrx.UL_PKT_C, jtrx.PACK_HDR,
        jtrx.RX_HALO_DEV, jtrx.TX_TAIL_SYM, jtrx.TX_DELAY_DEV)


def test_be32_matches_jax():
    x = np.array([0, 1, 255, 256, 65535, 2715647, 2 ** 31 - 1], np.int32)
    np.testing.assert_array_equal(ttrx._be32(t(x)).numpy(),
                                  np.asarray(jtrx._be32(jnp.asarray(x))))
