"""The DFE's feedback recursion (K5) on the CPU: `equalize_burst_plain`
against the JAX package's `equalize_burst` (TOA 0, fractional and
negative; ν of 5 and of 1); the decision rule at s.real = 0; the
dispatch, which takes the plain form on the CPU; the wrapper's refusals,
which need no card; and `equalize_cases`, the rounding model and the
borderline inputs the card tests hold the kernel to. The kernel itself
is held to the plain form on the card (`test_torch_cuda.py`)."""

from fractions import Fraction

import numpy as np
import pytest
import torch

import equalize_cases as E
import jax
import jax.numpy as jnp
from openbts_ttsou_tpu.ops import dfe as jdfe
from openbts_ttsou_tpu_torch.ops import cuda_dfe, dfe, gmsk

# float32 recursions in another evaluation order agree to this
# (tests/test_torch_ops.py, tests/test_golden.py)
FTOL = 2e-4


def _bursts(n: int, nu: int, seed: int):
    """n GMSK bursts of random bits through a random (nu + 1)-tap channel
    with noise, and that channel's DFE from the JAX design: (bursts
    [n, 157] complex64, feedforward [n, 7], feedback [n, nu])."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (n, 148)).astype(np.uint8)
    sig = gmsk.modulate_burst_np(bits, 1, guard_len=9)[:, : E.T]
    chan = (rng.normal(size=(n, nu + 1)) + 1j * rng.normal(size=(n, nu + 1))
            ) * 0.3 * 0.6 ** np.arange(nu + 1)
    chan[:, 0] += 1.0
    x = np.stack([np.convolve(s, c)[: E.T] for s, c in zip(sig, chan)])
    x += 0.05 * (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape))
    w, b = jax.jit(jdfe.design_dfe)(chan.astype(np.complex64),
                                    jnp.full((n,), 400.0, jnp.float32))
    return x.astype(np.complex64), np.array(w), np.array(b)


@pytest.mark.parametrize("toa_kind", ["zero", "fractional", "negative"])
@pytest.mark.parametrize("nu", [5, 1])
def test_plain_form_matches_jax(toa_kind, nu):
    n = 12
    x, w, b = _bursts(n, nu, 100 * nu + len(toa_kind))
    toa = {"zero": np.zeros(n), "fractional": np.linspace(0.05, 0.95, n),
           "negative": -np.linspace(0.2, 2.6, n)}[toa_kind].astype(
        np.float32)
    want = np.asarray(jax.jit(jdfe.equalize_burst, static_argnums=2)(
        x, toa, 1, w, b))
    got = dfe.equalize_burst_plain(torch.from_numpy(x), torch.from_numpy(toa),
                                   1, torch.from_numpy(w),
                                   torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (n, E.T)
    np.testing.assert_allclose(got.numpy(), want, atol=FTOL)
    if toa_kind == "zero":  # the channel is equalized: bits come out hard
        assert float(((got - 0.5).abs() > 0.4).float().mean()) > 0.8


def test_zero_decides_minus_one():
    """s.real = 0 at step 0 decides −1 (strict >), and step 1 shows it:
    its soft bit is ≈ 0, where a +1 decision would give ≈ 1."""
    pf, fb, rot = E.zero_decision_case()
    soft = dfe.feedback_recursion_plain(pf, fb, rot)
    assert float(soft[0, 0]) == 0.5
    assert float(soft[0, 1]) < 1e-6
    model = E.recursion_model(pf.numpy(), fb.numpy(), rot.numpy())
    assert model[0, 0] == 0.5 and model[0, 1] < 1e-6


def test_equalize_burst_takes_the_plain_form_on_the_cpu():
    x, w, b = _bursts(6, 5, 7)
    toa = torch.linspace(-1.5, 1.5, 6)
    args = (torch.from_numpy(x), toa, 1, torch.from_numpy(w),
            torch.from_numpy(b))
    n0 = cuda_dfe.equalize_cuda.launches
    assert torch.equal(dfe.equalize_burst(*args),
                       dfe.equalize_burst_plain(*args))
    assert cuda_dfe.equalize_cuda.launches == n0


def test_equalize_cuda_refuses_bad_input_without_a_card():
    pf, fb, rot = E.signal_inputs(4, E.T, E.NU, 3)
    n0 = cuda_dfe.equalize_cuda.launches
    for args, err in E.refusals(pf, fb, rot):
        with pytest.raises(err):
            cuda_dfe.equalize_cuda(*args)
    with pytest.raises(ValueError, match="CUDA"):  # all well formed
        cuda_dfe.equalize_cuda(pf, fb, rot)
    assert cuda_dfe.equalize_cuda.launches == n0


def test_fma32_rounds_once():
    """`fma32` against exact rational arithmetic, on operands whose sums
    land on and near float32 midpoints."""
    rng = np.random.default_rng(5)
    n = 4000
    a = rng.normal(size=n).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)
    c = (-(a.astype(np.float64) * b)).astype(np.float32)  # cancellation
    c[::3] = rng.normal(size=c[::3].shape).astype(np.float32)
    c[1::5] *= np.float32(1 + 2 ** -23)
    # a·b = 1 + 2^-11 + 2^-24 lies on a float32 midpoint; a c far below
    # float64's ulp leaves the float64 sum there, but not the exact one
    # (double rounding's one wrong case), or is 0 (a tie to even)
    a[:4] = np.float32(1 + 2 ** -12)
    b[:4] = np.float32(1 + 2 ** -12)
    c[:4] = np.array([2.0 ** -80, -2.0 ** -80, 2.0 ** -60, 0.0], np.float32)
    got = E.fma32(a, b, c)
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        assert Fraction(float(g)) == _round32(exact), (x, y, z)


def _round32(q: Fraction) -> Fraction:
    """q rounded to float32, to nearest, ties to even."""
    if q == 0:
        return Fraction(0)
    lo = Fraction(float(np.float32(float(q))))  # within an ulp of q
    cands = sorted({lo, *(Fraction(float(np.nextafter(np.float32(lo), d)))
                          for d in (np.float32(-np.inf),
                                    np.float32(np.inf)))})
    return min(cands, key=lambda v: (
        abs(v - q), int(np.float32(float(v)).view(np.int32)) & 1))


@pytest.mark.parametrize("nu", [1, 2, 3, 4, 5, 6, 7, 8])
def test_sum_orders_sum_every_term(nu):
    rng = np.random.default_rng(nu)
    p = E._c64(rng.integers(-8, 9, (50, nu))
               + 1j * rng.integers(-8, 9, (50, nu)))  # small integers: exact
    for order in E.SUM_ORDERS:
        np.testing.assert_array_equal(E.tree_sum32(p, order), p.sum(-1))


def test_cmul_forms_agree_to_a_rounding():
    rng = np.random.default_rng(6)
    x = E._c64(rng.normal(size=300) + 1j * rng.normal(size=300))
    y = E._c64(rng.normal(size=300) + 1j * rng.normal(size=300))
    exact = x.astype(np.complex128) * y
    for form in E.CMUL_FORMS:
        got = E.cmul32(x, y, form)
        np.testing.assert_allclose(got, exact, rtol=0,
                                   atol=4e-7 * np.abs(exact).max())


def test_recursion_model_matches_the_plain_form():
    """The kernel's arithmetic in numpy against the plain form on the
    CPU, whose products and sums round in other orders: equal decisions
    on signal inputs, so soft bits within float32 rounding."""
    for nu in (5, 1, 8):
        pf, fb, rot = E.signal_inputs(16, E.T, nu, 40 + nu)
        got = E.recursion_model(pf.numpy(), fb.numpy(), rot.numpy())
        want = dfe.feedback_recursion_plain(pf, fb, rot).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_borderline_inputs_sit_on_the_threshold():
    """Most steps of the borderline set end within a few ulps of
    s.real = 0 on the plain form's path, some exactly on it."""
    pf, fb, rot = E.borderline_inputs(16, E.T, E.NU, 9)
    soft = dfe.feedback_recursion_plain(pf, fb, rot)
    near = (soft - 0.5).abs() < 1e-6
    assert float(near.float().mean()) > 0.5
    assert bool((soft == 0.5).any())
    # and the decisions there are not all one way
    assert bool((soft[near] > 0.5).any()) and bool((soft[near] < 0.5).any())
