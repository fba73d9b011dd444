"""The PyTorch port's ops against the JAX package, on the CPU.

The same numpy inputs, made from seeds, go through each JAX function and
its counterpart in `openbts_ttsou_tpu_torch`. Detection decisions are
compared exactly; floats within the tolerance stated at each check.
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from openbts_ttsou_tpu.ops import correlate as jxc
from openbts_ttsou_tpu.ops import dfe as jdfe
from openbts_ttsou_tpu.ops import fir as jfir
from openbts_ttsou_tpu.ops import gmsk as jgmsk
from openbts_ttsou_tpu.ops.pallas_fir import polyphase_resample_pallas
from openbts_ttsou_tpu.utils import constants as JC
from openbts_ttsou_tpu_torch.ops import correlate as txc
from openbts_ttsou_tpu_torch.ops import cuda_fir
from openbts_ttsou_tpu_torch.ops import dfe as tdfe
from openbts_ttsou_tpu_torch.ops import fir as tfir
from openbts_ttsou_tpu_torch.ops import gmsk as tgmsk
from openbts_ttsou_tpu_torch.utils import constants as TC

torch.set_num_threads(1)

# golden DFE tolerance (tests/test_golden.py:119): float32 recursions in
# another evaluation order agree to this
FTOL = 2e-4

GEOMETRIES = [(65, 96, 961, 24000), (96, 65, 651, 16250)]


def t(x):
    return torch.from_numpy(np.array(x))


def cplx(rng, shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * scale).astype(np.complex64)


# ---- (a) recomputed constants --------------------------------------------

@pytest.mark.parametrize("name", ["TRAINING_SEQUENCE", "RACH_SYNCH_SEQUENCE",
                                  "DUMMY_BURST", "SCH_SYNCH_SEQUENCE",
                                  "INITIAL_ENERGY_THRESHOLD",
                                  "RSSI_FULL_SCALE"])
def test_constants_equal(name):
    np.testing.assert_array_equal(getattr(TC, name), getattr(JC, name))


@pytest.mark.parametrize("p,q,taps,_t", GEOMETRIES)
def test_resampler_design_equal(p, q, taps, _t):
    np.testing.assert_array_equal(tfir.resampler_lpf(p, q, taps),
                                  jfir.resampler_lpf(p, q, taps))
    for a, b in zip(tfir._polyphase_plan(p, q, taps),
                    jfir._polyphase_plan(p, q, taps)):
        np.testing.assert_array_equal(a, b)
    lpf = jfir.resampler_lpf(p, q, taps)
    np.testing.assert_array_equal(tfir._polyphase_filter_bank(p, q, lpf),
                                  jfir._polyphase_filter_bank(p, q, lpf))


@pytest.mark.parametrize("sps", [1, 4])
def test_templates_equal(sps):
    np.testing.assert_array_equal(tgmsk.gsm_pulse(sps), jgmsk.gsm_pulse(sps))
    np.testing.assert_array_equal(tgmsk.rotation(157 * sps, sps),
                                  jgmsk.rotation(157 * sps, sps))
    for a, b in zip(txc.midamble_bank(sps), jxc.midamble_bank(sps)):
        np.testing.assert_array_equal(a, b)
    ta, ja = txc.rach_template(sps), jxc.rach_template(sps)
    np.testing.assert_array_equal(ta.sequence, ja.sequence)
    assert (ta.gain, ta.toa) == (ja.gain, ja.toa)
    bits = np.random.default_rng(sps).integers(0, 2, (3, 148))
    np.testing.assert_array_equal(tgmsk.modulate_burst_np(bits, sps, 9),
                                  jgmsk.modulate_burst_np(bits, sps, 9))


# ---- (b) K1's plain version ----------------------------------------------

# rtol/atol as tests/test_pallas.py:23 holds the Pallas kernel: float32
# accumulation in another order
def _assert_resample_close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=2e-4 * np.abs(want).max())


@pytest.mark.parametrize("p,q,taps,T", GEOMETRIES)
def test_resample_plain_matches_jax(p, q, taps, T):
    x = cplx(np.random.default_rng(p), (2, T))
    lpf = jfir.resampler_lpf(p, q, taps)
    want = np.asarray(jfir.polyphase_resample(x, p, q, lpf))
    got = tfir.polyphase_resample(t(x), p, q, lpf).numpy()
    _assert_resample_close(got, want)


@pytest.mark.parametrize("p,q,taps,T", GEOMETRIES)
def test_resample_plain_matches_pallas_interpret(p, q, taps, T):
    x = cplx(np.random.default_rng(q), (2, T))
    lpf = jfir.resampler_lpf(p, q, taps)
    want = np.asarray(polyphase_resample_pallas(x, p, q, lpf,
                                                interpret=True))
    got = cuda_fir.polyphase_resample_plain(t(x), p, q, lpf).numpy()
    _assert_resample_close(got, want)


@pytest.mark.parametrize("p,q,taps,T", GEOMETRIES + [(3, 200, 31, 1000),
                                                     (7, 2, 50, 300)])
def test_branch_table_computes_the_resampler(p, q, taps, T):
    """The compact per-branch table the CUDA kernel reads, evaluated with
    the kernel's index arithmetic in float64 numpy, equals the plain
    filter-bank form (float32 rounding only)."""
    rng = np.random.default_rng(T)
    x = cplx(rng, (2, T))
    lpf = tfir.resampler_lpf(p, q, taps)
    taps_t, base = cuda_fir.branch_table(p, q, lpf.tobytes())
    n_out = tfir.polyphase_output_len(T, p, q)
    i = np.arange(n_out)
    m, r = i // p, i % p
    src = (m * q + base[r])[:, None] - np.arange(taps_t.shape[1])
    ok = (src >= 0) & (src < T)
    xs = np.where(ok, x[:, np.clip(src, 0, T - 1)], 0)
    want = (xs.astype(np.complex128) * taps_t[r]).sum(-1)
    got = cuda_fir.polyphase_resample_plain(t(x), p, q, lpf).numpy()
    _assert_resample_close(got, want)


# ---- K1's tile plan, evaluated with the kernel's loops ---------------------

def _copy_row(n, gs, dst_par, src_par, t_in):
    """stage_tile's copies of one slab row: n samples from x_row[gs] on to
    row words 0..n-1, whose first word has 16-byte parity dst_par (the
    sample x_row[gs] src_par). Returns, for each word, the sample it gets
    (-1: a zero), after checking each word is written once and each
    16-byte copy is aligned at both ends."""
    got = np.full(n, -2)

    def put(i, s):
        assert got[i] == -2, f"word {i} written twice"
        got[i] = s if 0 <= s < t_in else -1

    def one(i):
        put(i, gs + i)

    if dst_par == src_par:
        h = dst_par
        if h:
            one(0)
        for k in range((n - h) // 2):
            i = h + 2 * k
            s = gs + i
            assert (dst_par + i) % 2 == 0 and (src_par + i) % 2 == 0
            if 0 <= s < t_in:  # a 16-byte copy, src-size 8 past the end
                put(i, s)
                put(i + 1, s + 1)
            else:
                put(i, s)
                one(i + 1)
        if (n - h) % 2:
            one(n - 1)
    else:
        for i in range(n):
            one(i)
    assert (got != -2).all()
    return got


@pytest.mark.parametrize("t_in", [40, 41])
@pytest.mark.parametrize("gs", [-7, -1, 0, 3, 30])
@pytest.mark.parametrize("dst_par,src_par", [(0, 0), (1, 1), (0, 1), (1, 0)])
def test_slab_row_copies_each_sample_once(t_in, gs, dst_par, src_par):
    got = _copy_row(17, gs, dst_par, src_par, t_in)
    s = gs + np.arange(17)
    np.testing.assert_array_equal(got, np.where((s >= 0) & (s < t_in), s, -1))


def _store_order(n, p, h, nthreads):
    """store_tile's walk over a tile's n outputs: (output, cycle, phase)
    of every store, a lone one first when the row is off the 16-byte grid
    (h = 1), then 16-byte pairs stepped without division, then a lone
    last one."""
    done = [(0, 0, 0)] if h else []
    tid = np.arange(nthreads)
    c = (h + 2 * tid) // p
    r = h + 2 * tid - c * p
    dc, dr = divmod(2 * nthreads, p)
    k = tid.copy()
    pairs = (n - h) // 2
    while (k < pairs).any():
        on = k < pairs
        c1, r1 = c.copy(), r + 1
        c1[r1 == p] += 1
        r1[r1 == p] = 0
        o = h + 2 * k
        done += list(zip(o[on], c[on], r[on]))
        done += list(zip(o[on] + 1, c1[on], r1[on]))
        r, c, k = r + dr, c + dc, k + nthreads
        c[r >= p] += 1
        r[r >= p] -= p
    if (n - h) % 2:
        done.append((n - 1, (n - 1) // p, (n - 1) % p))
    return np.array(done).reshape(-1, 3)


@pytest.mark.parametrize("p,n", [(65, 2080), (96, 3072), (65, 1521), (7, 223)])
@pytest.mark.parametrize("h", [0, 1])
@pytest.mark.parametrize("nthreads", [224, 384])
def test_store_walk_covers_each_output_once(p, n, h, nthreads):
    o, c, r = _store_order(n, p, h, nthreads).T
    np.testing.assert_array_equal(np.sort(o), np.arange(n))
    np.testing.assert_array_equal(c * p + r, o)


def _kernel_in_numpy(x, p, q, lpf):
    """K1 on the CPU in float64, with the kernel's loops over the plan the
    wrapper hands it: tile by tile, each slab row zero-filled outside the
    input, each group's R phases (the last group may be short) from its
    U-column window against its zero-padded taps, outputs stored in the
    kernel's order; every output is checked to be written once."""
    plan = cuda_fir.tile_plan(p, q, lpf.tobytes())
    rows, t_in = x.shape
    n_out = tfir.polyphase_output_len(t_in, p, q)
    tiles = -(-(-(-n_out // p)) // plan.mt)
    s = plan.row_stride
    out = np.zeros((rows, n_out), np.complex128)
    writes = np.zeros((rows, n_out), int)
    for b in range(rows):
        for tile in range(tiles):
            m0 = tile * plan.mt
            src = (m0 * q + plan.slab_start
                   + np.arange(plan.mt)[:, None] * q + np.arange(s))
            ok = (src >= 0) & (src < t_in)
            slab = np.where(ok, x[b, np.clip(src, 0, t_in - 1)], 0)
            stage = np.zeros((plan.mt, plan.out_stride), np.complex128)
            for g in range(plan.groups):
                w0 = int(plan.wb[g])
                assert w0 + plan.u <= s  # the window stays in its row
                win = slab[:, w0: w0 + plan.u].astype(np.complex128)
                acc = win @ plan.taps[g].astype(np.float64).T  # [mt, r]
                nr = min(plan.r, p - g * plan.r)
                stage[:, g * plan.r: g * plan.r + nr] = acc[:, :nr]
            first = m0 * p
            n = min(plan.mt * p, n_out - first)
            h = (b * n_out + first) % 2  # out's base is 16-byte aligned
            for o, c, r in _store_order(n, p, h, plan.threads):
                out[b, first + o] = stage[c, r]
                writes[b, first + o] += 1
    assert (writes == 1).all()
    return out


@pytest.mark.parametrize("p,q,taps,T", GEOMETRIES + [
    (3, 200, 31, 1000),    # runtime width
    (7, 2, 50, 300),       # p not a multiple of R: a short last group
    (7, 2, 50, 301),       # and odd T
    (65, 96, 961, 1000),   # T shorter than one slab
    (65, 96, 961, 5000),   # a partial last tile
    (96, 65, 651, 4001),   # odd T, odd row length out
    (65, 96, 1601, 3001),  # k_max 25: the runtime width at the uplink ratio
    (3, 20962, 31, 62891),  # one cycle a tile: shared memory's limit on q
])
def test_tile_plan_computes_the_resampler(p, q, taps, T):
    """The tile plan the wrapper passes to K1, run through the kernel's
    loops in float64 numpy, equals the plain form and the JAX resampler
    (tests/test_pallas.py:23's bound: float32 sums in another order)."""
    x = cplx(np.random.default_rng(T + p), (2, T))
    lpf = tfir.resampler_lpf(p, q, taps)
    got = _kernel_in_numpy(x, p, q, lpf)
    _assert_resample_close(
        got, cuda_fir.polyphase_resample_plain(t(x), p, q, lpf).numpy())
    _assert_resample_close(got, np.asarray(jfir.polyphase_resample(
        x, p, q, jfir.resampler_lpf(p, q, taps))))


def test_tile_plan_matches_the_kernel_source():
    """The plan's instantiations, lanes and ring depth are the ones the
    CUDA source compiles."""
    src = (Path(__file__).resolve().parents[1] / "openbts_ttsou_tpu_torch"
           / "csrc" / "polyphase_resample.cu").read_text()
    inst = re.findall(r"^\s*INSTANCE\((\d+), (\d+), (\d+)\)$", src, re.M)
    assert tuple(tuple(map(int, i)) for i in inst) == cuda_fir.INSTANCES
    assert f"constexpr int kCycles = {cuda_fir.CYCLES};" in src
    assert f"constexpr int kStages = {cuda_fir.STAGES};" in src
    assert f"constexpr int kLanes = {cuda_fir.LANES};" in src
    assert (f"launch<1, 0, {cuda_fir.RUNTIME_WARPS}, 1>" in src)


@pytest.mark.parametrize("p,q,taps,fits", [
    (3, 20962, 31, True), (3, 20963, 31, False),      # the largest q at p 3
    (13985, 1, 31, True), (13986, 1, 31, False),      # the largest p at q 1
])
def test_tile_plan_stops_where_shared_memory_does(p, q, taps, fits):
    """Two slab rows and two output rows of one cycle must fit a block's
    shared memory (cuda_fir's docstring); one word past that the plan
    raises instead of handing the kernel a tile it cannot hold."""
    lpf = tfir.resampler_lpf(p, q, taps).tobytes()
    if fits:
        plan = cuda_fir.tile_plan(p, q, lpf)
        assert plan.mt == 1
        assert 2 * (plan.row_stride + plan.out_stride) * 8 <= (
            cuda_fir.SMEM_BYTES - 8192)
    else:
        with pytest.raises(ValueError, match="shared memory"):
            cuda_fir.tile_plan(p, q, lpf)


def test_cuda_wrapper_refuses_cpu_tensor():
    x = torch.zeros(2, 960, dtype=torch.complex64)
    with pytest.raises(ValueError):
        cuda_fir.polyphase_resample_cuda(x, 65, 96,
                                         tfir.resampler_lpf(65, 96, 961))


# ---- convolution and GMSK ------------------------------------------------

@pytest.mark.parametrize("mode", ["full", "overlap", "start", "with_tail",
                                  "no_delay", "custom"])
@pytest.mark.parametrize("per_batch", [False, True])
def test_convolve_span_modes(mode, per_batch):
    rng = np.random.default_rng(3)
    a = cplx(rng, (3, 40))
    b = cplx(rng, (3, 7) if per_batch else (7,))
    kw = dict(start=4, length=50) if mode == "custom" else {}
    want = np.asarray(jfir.convolve(a, b, mode, **kw))
    got = tfir.convolve(t(a), t(b), mode, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_delay_vector_and_demodulate():
    rng = np.random.default_rng(4)
    x = cplx(rng, (24, 157), 100.0)
    # fractional and integer delays, incl. the ±40 clamp and |frac| ≤ 1e-2
    delay = np.concatenate([rng.uniform(-6, 6, 18),
                            [0.004, -0.009, 47.3, -55.2, 3.0, -2.0]]
                           ).astype(np.float32)
    want = np.asarray(jax.jit(jgmsk.delay_vector)(x, delay))
    got = tgmsk.delay_vector(t(x), t(delay)).numpy()
    np.testing.assert_allclose(got, want, rtol=FTOL,
                               atol=FTOL * np.abs(want).max())
    amp = cplx(rng, (24,), 50.0)
    want = np.asarray(jax.jit(jgmsk.demodulate_burst, static_argnums=1)(
        x, 1, amp, delay / 10))
    got = tgmsk.demodulate_burst(t(x), 1, t(amp), t(delay / 10)).numpy()
    np.testing.assert_allclose(got, want, atol=FTOL)


# ---- (c) detectors, DFE ----------------------------------------------------

def _burst_batch(seed, n=48):
    """Normal bursts (TSC 2) with random delays, plus RACH bursts, pure
    noise and near-silent rows."""
    rng = np.random.default_rng(seed)
    out = cplx(rng, (n, 157), 20.0)
    for i in range(n):
        kind = i % 4
        if kind == 0:
            bits = rng.integers(0, 2, 148).astype(np.uint8)
            bits[61:87] = JC.TRAINING_SEQUENCE[2]
        elif kind == 1:
            bits = np.zeros(148, np.uint8)
            bits[:8] = [0, 1, 0, 1, 0, 1, 0, 1]
            bits[8:49] = JC.RACH_SYNCH_SEQUENCE
            bits[49:85] = rng.integers(0, 2, 36)
        elif kind == 2:
            continue
        else:
            out[i] *= 1e-3
            continue
        w = 9000.0 * jgmsk.modulate_burst_np(bits[None], 1, guard_len=9)[0]
        d = int(rng.integers(0, 4))
        out[i, d:] += w[: 157 - d]
    return out


def _jit_detect(fn):
    """jax.jit of a function returning (Detection, ...): the Detection
    dataclass is no pytree, so it crosses the jit boundary as a tuple."""
    fields = ("detected", "amplitude", "toa", "peak_to_mean")

    def flat(*a):
        out = fn(*a)
        d, rest = (out[0], out[1:]) if isinstance(out, tuple) else (out, ())
        return tuple(getattr(d, f) for f in fields) + tuple(rest)

    def call(*a):
        out = jax.jit(flat)(*a)
        return (jxc.Detection(*out[:4]),) + tuple(out[4:])
    return call


def _assert_detection(td, jd):
    np.testing.assert_array_equal(td.detected.numpy(),
                                  np.asarray(jd.detected))
    np.testing.assert_allclose(td.toa.numpy(), np.asarray(jd.toa),
                               atol=FTOL)
    ja = np.asarray(jd.amplitude)
    np.testing.assert_allclose(td.amplitude.numpy(), ja, rtol=FTOL,
                               atol=FTOL * np.abs(ja).max())
    jp = np.asarray(jd.peak_to_mean)
    np.testing.assert_allclose(td.peak_to_mean.numpy(), jp, rtol=FTOL)


def test_peak_detect():
    x = _burst_batch(5)
    corr = np.asarray(jxc.fir.correlate(
        x, jxc.rach_template(1).sequence, jfir.NO_DELAY))
    jv, ji, jp = jax.jit(jxc.peak_detect)(corr)
    tv, ti, tp = txc.peak_detect(t(corr))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=FTOL,
                               atol=FTOL * np.abs(np.asarray(jv)).max())
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=FTOL)


def test_detect_rach():
    x = _burst_batch(6)
    _assert_detection(txc.detect_rach(t(x), 1),
                      _jit_detect(lambda b: jxc.detect_rach(b, 1))(x)[0])


@pytest.mark.parametrize("max_toa", [None, 8])
def test_analyze_traffic_burst(max_toa):
    x = _burst_batch(7)
    tsc = np.full(len(x), 2, np.int32)
    tsc[1::5] = 0
    jd, jc, jo = _jit_detect(lambda b, s: jxc.analyze_traffic_burst(
        b, s, 1, estimate_channel=True, max_toa=max_toa))(x, tsc)
    td, tc, to = txc.analyze_traffic_burst(t(x), t(tsc), 1,
                                           estimate_channel=True,
                                           max_toa=max_toa)
    _assert_detection(td, jd)
    jc = np.asarray(jc)
    np.testing.assert_allclose(tc.numpy(), jc, rtol=FTOL,
                               atol=FTOL * np.abs(jc).max())
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    # the static-TSC form and the closed gate
    jd2, = _jit_detect(lambda b: jxc.analyze_traffic_burst(
        b, 2, 1, max_toa=max_toa)[:1])(x)
    td2, tc2, _ = txc.analyze_traffic_burst(t(x), 2, 1,
                                            estimate_channel=True,
                                            max_toa=max_toa,
                                            gate_estimation=False)
    _assert_detection(td2, jd2)
    assert not tc2.abs().any()


def test_design_dfe_and_equalize():
    rng = np.random.default_rng(8)
    n = 32
    chan = cplx(rng, (n, 6), 0.3)
    chan[:, 0] += 1.0
    snr = rng.uniform(1.0, 300.0, n).astype(np.float32)
    jw, jb = jax.jit(jdfe.design_dfe)(chan, jnp.asarray(snr))
    tw, tb = tdfe.design_dfe(t(chan), t(snr))
    jw, jb = np.asarray(jw), np.asarray(jb)
    np.testing.assert_allclose(tw.numpy(), jw, rtol=FTOL,
                               atol=FTOL * np.abs(jw).max())
    np.testing.assert_allclose(tb.numpy(), jb, rtol=FTOL,
                               atol=FTOL * np.abs(jb).max())
    x = _burst_batch(9, n) / 9000.0
    toa = rng.uniform(-2, 2, n).astype(np.float32)
    want = np.asarray(jax.jit(jdfe.equalize_burst, static_argnums=2)(
        x, toa, 1, jw, jb))
    got = tdfe.equalize_burst(t(x), t(toa), 1, t(jw), t(jb)).numpy()
    np.testing.assert_allclose(got, want, atol=FTOL)


# ---- (g) the port imports no JAX -------------------------------------------

def test_port_imports_no_jax():
    code = (
        "import pkgutil, importlib, sys\n"
        "import openbts_ttsou_tpu_torch as p\n"
        "mods = list(pkgutil.walk_packages(p.__path__, p.__name__ + '.'))\n"
        "for m in mods:\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith(('jax.', 'jaxlib', 'openbts_ttsou_tpu.')) or "
        "k == 'openbts_ttsou_tpu')\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 12  # every module was imported
