"""Shared inputs and a numpy model of the float32 rounding of K5, the
DFE's feedback recursion (`csrc/dfe_equalize.cu`).

`signal_inputs` are bursts as the equalizer sees them (±1 symbols
rotated, the feedback's intersymbol interference added, noise);
`borderline_inputs` are built step by step on the plain form's own path
so that most steps end a few ulps from the decision threshold
`s.real = 0`, some exactly on it. `fma32`, `cmul32` and `tree_sum32`
round as float32 hardware does: `tests/test_torch_cuda.py` holds the
eager ops on the card to the forms the kernel copies, and
`tests/test_torch_equalize.py` holds the model to exact arithmetic.
No JAX here: the card tests import this module."""

from __future__ import annotations

import numpy as np
import torch

from openbts_ttsou_tpu_torch.ops import gmsk

T = 157  # steps a burst (one slot window at one sample a symbol)
NU = 5  # feedback taps (CHAN_TAPS - 1)


def _c64(x) -> np.ndarray:
    return np.asarray(x, np.complex64)


def rotation(t: int = T, sps: int = 1, device="cpu") -> torch.Tensor:
    """The GMSK rotation table the equalizer reads, [t] complex64."""
    return torch.from_numpy(gmsk.rotation(t, sps)).to(device)


def feedback_taps(b: int, nu: int, rng) -> np.ndarray:
    """[b, nu] complex64 taps of falling size, as `design_dfe` gives for a
    multipath channel: the first ~0.5, each next about half."""
    scale = 0.5 ** np.arange(1, nu + 1)
    return _c64(scale * (rng.normal(size=(b, nu))
                         + 1j * rng.normal(size=(b, nu))) / np.sqrt(2))


def signal_inputs(b: int, t: int, nu: int, seed: int, device="cpu",
                  sigma: float = 0.4) -> tuple:
    """(pf [b, t], feedback [b, nu], rot [t]): random ±1 symbols rotated,
    less the feedback's interference of the symbols before them (so
    that a right decision cancels it), plus complex noise of `sigma`."""
    rng = np.random.default_rng(seed)
    fb = feedback_taps(b, nu, rng)
    rot = gmsk.rotation(t, 1).astype(np.complex128)
    sym = rng.choice([-1.0, 1.0], size=(b, t)) * rot
    pf = sym + sigma * (rng.normal(size=(b, t))
                        + 1j * rng.normal(size=(b, t))) / np.sqrt(2) * rot
    for j in range(nu):
        pf[:, j + 1:] -= fb[:, j: j + 1] * sym[:, : t - j - 1]
    return (torch.from_numpy(_c64(pf)).to(device),
            torch.from_numpy(fb).to(device), rotation(t, 1, device))


def borderline_inputs(b: int, t: int, nu: int, seed: int, device="cpu",
                      share: float = 0.8, ulps: int = 4) -> tuple:
    """(pf, feedback, rot) as `signal_inputs`, but at a `share` of the
    steps pf is set, on the plain form's own path on `device`, to
    −Σ b·hist + k·u·rot[i] with k a whole number in [−ulps, ulps] and u
    one float32 ulp of |Σ b·hist|: the step's s.real lands within a few
    ulps of 0, or on it (k = 0 gives d = 0). The plain form run on the
    same device retraces the same decisions."""
    rng = np.random.default_rng(seed)
    pf, fb, rot = signal_inputs(b, t, nu, seed, device)
    pick = torch.from_numpy(rng.random((b, t)) < share).to(device)
    k = torch.from_numpy(rng.integers(-ulps, ulps + 1, (b, t)).astype(
        np.float32)).to(device)
    rev = torch.conj_physical(rot)
    hist = torch.zeros((b, nu), dtype=torch.complex64, device=device)
    one = torch.ones((), dtype=torch.complex64, device=device)
    for i in range(t):
        fsum = (fb * hist).sum(-1)
        u = fsum.abs() * 2.0 ** -23
        near = -fsum + (k[:, i] * u).to(torch.complex64) * rot[i]
        pf[:, i] = torch.where(pick[:, i], near, pf[:, i])
        s = (pf[:, i] + fsum) * rev[i]
        dec = torch.where(s.real > 0.0, one, -one)
        hist = torch.cat([(dec * rot[i])[:, None], hist[:, :-1]], 1)
    return pf, fb, rot


def zero_decision_case(device="cpu") -> tuple:
    """(pf, feedback, rot) of one burst with ν = 1 whose step 0 gives
    s = 0 exactly (pf[0] = 0, an empty history) and whose step 1 shows
    that decision: the tap b = conj(rot[0])·rot[1] makes step 1's
    s.real ≈ −dec0, so its soft bit is ≈ 0 for a decision of −1 and
    ≈ 1 for +1."""
    rot = rotation(2, 1, device)
    fb = (torch.conj_physical(rot[0]) * rot[1]).reshape(1, 1)
    pf = torch.zeros((1, 2), dtype=torch.complex64, device=device)
    return pf, fb, rot


def refusals(pf, fb, rot):
    """(arguments, error) pairs that `equalize_cuda` must refuse before
    it launches, made from a well-formed (pf, feedback, rot)."""
    return [
        ((pf.to(torch.complex128), fb, rot), TypeError),
        ((pf, fb.real.contiguous(), rot), TypeError),
        ((pf, fb, rot.to(torch.complex128)), TypeError),
        ((pf[None], fb, rot), ValueError),  # [1, B, T]
        ((pf, fb[:-1], rot), ValueError),  # another B
        ((pf, fb, rot[:-1]), ValueError),  # another T
        ((pf, pf[:, :9].contiguous(), rot), ValueError),  # ν 9
        ((pf, pf[:, :3].contiguous(), rot), ValueError),  # ν 3, not built
        ((pf, fb[:, :0], rot), ValueError),  # ν 0
        ((pf.t().contiguous().t(), fb, rot), ValueError),  # not contiguous
        ((pf, fb.t().contiguous().t(), rot), ValueError)]


# ---- float32 rounding, exactly --------------------------------------------

def fma32(a, b, c) -> np.ndarray:
    """fmaf(a, b, c) in float32, rounded once (to nearest, ties to
    even): the exact product in float64, the sum in float64 with its
    error (TwoSum), and the one case double rounding gets wrong, a
    float64 sum on a float32 midpoint, mended by the error's sign."""
    a, b, c = (np.asarray(v, np.float32).astype(np.float64)
               for v in (a, b, c))
    p = a * b  # exact: two 24-bit significands
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)  # s + e == p + c exactly
    r = s.astype(np.float32)
    rd = r.astype(np.float64)
    other = np.nextafter(r, np.where(s > rd, np.float32(np.inf),
                                     np.float32(-np.inf)))
    od = other.astype(np.float64)
    fix = (s == (rd + od) / 2) & (e != 0) & (np.sign(e) == np.sign(od - rd))
    return np.where(fix, other, r).astype(np.float32)


#: complex product forms (re, im) of (a + ib)(c + id) in float32: no FMA,
#: and the four ways an FMA can take one product of each part
CMUL_FORMS = ("separate", "fma_ac_ad", "fma_bd_bc", "fma_ac_bc",
              "fma_bd_ad")
#: the form of c10::complex's operator* as nvcc contracts it, which the
#: kernel copies
KERNEL_CMUL = "fma_ac_ad"


def cmul32(x, y, form: str = KERNEL_CMUL) -> np.ndarray:
    """x·y for complex64 arrays in one of `CMUL_FORMS`."""
    x, y = _c64(x), _c64(y)
    a, b = x.real, x.imag
    c, d = y.real, y.imag

    def mul(u, v):
        return (u.astype(np.float64) * v).astype(np.float32)

    if form == "separate":
        re, im = mul(a, c) - mul(b, d), mul(a, d) + mul(b, c)
    else:
        fuse_re, fuse_im = form[4:6], form[7:9]
        re = (fma32(a, c, -mul(b, d)) if fuse_re == "ac"
              else fma32(-b, d, mul(a, c)))
        im = (fma32(a, d, mul(b, c)) if fuse_im == "ad"
              else fma32(b, c, mul(a, d)))
    return (re.astype(np.float32) + 1j * im.astype(np.float32)
            ).astype(np.complex64)


#: orders of a sum over a contiguous dimension of nu: left to right, and
#: PyTorch's reduction (lanes of the largest power of two W <= nu, lane k
#: p[k] + p[k + W]) with the lanes paired at rising or falling distance
SUM_ORDERS = ("sequential", "lanes_rising", "lanes_falling")
#: the order the kernel copies: PyTorch's on the card (measured with
#: PyTorch 2.11 on an H100, where every sum at ν 1–8 took it)
KERNEL_SUM = "lanes_falling"


def tree_sum32(p, order: str = KERNEL_SUM) -> np.ndarray:
    """Σ over the last axis of complex64 p [..., nu] in float32, in one
    of `SUM_ORDERS`."""
    p = _c64(p)
    nu = p.shape[-1]
    if order == "sequential":
        acc = p[..., 0]
        for j in range(1, nu):
            acc = (acc + p[..., j]).astype(np.complex64)
        return acc
    w = 1
    while 2 * w <= nu:
        w *= 2
    lane = [p[..., k] + p[..., k + w] if k + w < nu else p[..., k]
            for k in range(w)]
    lane = [x.astype(np.complex64) for x in lane]
    offsets = []
    off = 1
    while off < w:
        offsets.append(off)
        off *= 2
    if order == "lanes_falling":
        offsets = offsets[::-1]
        for off in offsets:
            for k in range(off):
                lane[k] = (lane[k] + lane[k + off]).astype(np.complex64)
        return lane[0]
    for off in offsets:
        for k in range(0, w - off, 2 * off):
            lane[k] = (lane[k] + lane[k + off]).astype(np.complex64)
    return lane[0]


def recursion_model(pf, feedback, rot) -> np.ndarray:
    """The kernel's arithmetic in numpy, a burst per row: `cmul32` and
    `tree_sum32` in the kernel's forms, the decision s.real > 0, the
    history shift, the slicer's two roundings and its clamp."""
    pf, fb, rot = _c64(pf), _c64(feedback), _c64(rot)
    bsz, t = pf.shape
    nu = fb.shape[1]
    hist = np.zeros((bsz, nu), np.complex64)
    soft = np.empty((bsz, t), np.float32)
    for i in range(t):
        d = (pf[:, i] + tree_sum32(cmul32(fb, hist))).astype(np.complex64)
        s = cmul32(d, np.conj(rot[i]))
        hist[:, 1:] = hist[:, :-1]
        hist[:, 0] = np.where(s.real > 0, rot[i], -rot[i])
        u = np.float32(0.5) * (s.real + np.float32(1.0))
        soft[:, i] = np.where(np.isnan(u), u, np.clip(u, 0.0, 1.0))
    return soft
