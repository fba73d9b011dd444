"""The threshold walk (K7) for the tests of `exact_walk`: inputs that
reach its corners, and the walk written per carrier in the order of the
CUDA kernel (`openbts_ttsou_tpu_torch/csrc/exact_walk.cu`), in numpy.

Imports no JAX, so the card tests (`test_torch_cuda.py`) use it too."""

from __future__ import annotations

import numpy as np
import torch

from openbts_ttsou_tpu_torch.trx import engine as eng

HYPERFRAME = 2048 * 26 * 51


def walk_inputs(f: int, c: int, seed: int, device="cpu", wrap: bool = True):
    """(fns, active, is_tsc, energy, detected, det_ok, need_dfe, state)
    for `exact_walk` over f frames and c carriers. The frames cross the
    hyperframe's wrap where `wrap` (f ≥ 2); each carrier's last
    false-detect frame and slots' estimate frames lie behind or ahead of
    the frames (the false-detect frame ahead by at most 8, so that few
    thresholds overflow to inf), or near half a hyperframe away; entry
    thresholds are 0, 1, near 0, negative, moderate or the initial 250;
    energies lie around the squared threshold, some at it exactly, some
    0; need_dfe is mixed across carriers; the flags are random."""
    rng = np.random.default_rng(seed)
    if wrap:
        fn0 = HYPERFRAME - 1 - int(rng.integers(0, max(f - 1, 1)))
    else:
        fn0 = int(rng.integers(0, HYPERFRAME))
    fns = (fn0 + np.arange(f)) % HYPERFRAME

    def frames_near(shape, ahead):
        """Frames behind a frame of the block by 0-200 (ahead by 0-`ahead`
        with chance 0.1), or half a hyperframe away (chance 0.05)."""
        u = rng.random(shape)
        near = np.where(u < 0.1, rng.integers(0, ahead + 1, shape),
                        -rng.integers(0, 201, shape))
        far = (HYPERFRAME // 2 + rng.integers(-3, 4, shape)
               ) * rng.choice([-1, 1], shape)
        off = np.where(u > 0.95, far, near)
        base = fns[rng.integers(0, f, shape)]
        return ((base + off) % HYPERFRAME).astype(np.int32)

    kind = rng.integers(0, 6, c)
    thr = np.select(
        [kind == 0, kind == 1, kind == 2, kind == 3, kind == 4],
        [np.zeros(c), np.ones(c), rng.uniform(0, 1.5, c),
         rng.uniform(-25, 0, c), rng.uniform(2, 60, c)],
        250.0).astype(np.float32)
    scale = np.maximum(thr.astype(np.float64) ** 2, 1.0)
    energy = (scale[None, :, None]
              * np.exp(rng.uniform(-1.5, 1.5, (f, c, 8))))
    energy = np.where(rng.random((f, c, 8)) < 0.05, 0.0, energy)
    energy = energy.astype(np.float32)
    at = rng.random((c, 8)) < 0.2  # frame 0 at the entry threshold squared
    energy[0] = np.where(at, (thr * thr)[:, None], energy[0])

    def flags(p):
        return rng.random((f, c, 8)) < p

    state = eng.init_state(eng.TrxConfig(n_chan=c), device)
    state = state._replace(
        energy_threshold=torch.from_numpy(thr).to(device),
        prev_false_detect_fn=torch.from_numpy(frames_near((c,), 8)).to(device),
        chan_valid=torch.from_numpy(rng.random((c, 8)) < 0.5).to(device),
        chan_estimate_fn=torch.from_numpy(frames_near((c, 8), 200)).to(device))

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (dev(fns.astype(np.int32)), dev(flags(0.85)), dev(flags(0.7)),
            dev(energy), dev(flags(0.6)), dev(flags(0.6)),
            dev(rng.random(c) < 0.5), state)


def _wrap32(v: int) -> int:
    return (v + 2 ** 31) % 2 ** 32 - 2 ** 31


def _c_mod(a: int, b: int) -> int:
    """C's %: the sign of the dividend."""
    r = abs(a) % b
    return -r if a < 0 else r


def fn_delta_c(v1: int, v2: int) -> int:
    """The kernel's fn_delta: an int32 difference, C's % made Python's,
    folded at half a hyperframe."""
    m = _c_mod(_c_mod(_wrap32(v1 - v2), HYPERFRAME) + HYPERFRAME, HYPERFRAME)
    return m - HYPERFRAME if m >= HYPERFRAME // 2 else m


def _exp32(x: np.float32) -> np.float32:
    """exp in float32 as torch computes it on the CPU (numpy's float32
    exp rounds some integers differently)."""
    return np.float32(torch.exp(torch.tensor(float(x), dtype=torch.float32)))


def walk_loop(fns, active, is_tsc, energy, detected, det_ok, need_dfe,
              state) -> tuple:
    """The walk per carrier in the kernel's order: the frame's energy
    gate against the threshold at frame entry, adoption from the frame
    entry's validity and estimate frames, then the slot fold (elapsed
    frames once a slot; quiet, hit, miss). Returns numpy arrays in the
    `ExactWalk` order."""
    fns, active, is_tsc, energy, detected, det_ok, need_dfe = (
        np.asarray(t.cpu()) for t in (fns, active, is_tsc, energy, detected,
                                      det_ok, need_dfe))
    f, c = energy.shape[:2]
    out = (np.zeros((f, c, 8), bool), np.zeros((f, c, 8), bool),
           np.zeros((f, c, 8), np.int32), np.zeros((f, c), np.float32),
           np.zeros(c, np.float32), np.zeros(c, np.int32),
           np.zeros((c, 8), bool), np.zeros((c, 8), np.int32),
           np.zeros((c, 8), np.int32))
    (success, valid_post, last_post, thr_entry, thr_out, pf_out, valid_out,
     est_out, last_out) = out
    thr0, pf0, valid0, est0 = (
        np.asarray(t.cpu()) for t in (state.energy_threshold,
                                      state.prev_false_detect_fn,
                                      state.chan_valid,
                                      state.chan_estimate_fn))
    one, ten, zero = np.float32(1), np.float32(10), np.float32(0)
    with np.errstate(over="ignore"):  # a threshold may reach inf
        for ch in range(c):
            thr, pf = np.float32(thr0[ch]), int(pf0[ch])
            valid = [bool(v) for v in valid0[ch]]
            est = [int(v) for v in est0[ch]]
            last = [-1] * 8
            nd = bool(need_dfe[ch])
            for i in range(f):
                fn = int(fns[i])
                thr_entry[i, ch] = thr
                thr2 = np.float32(thr * thr)
                gate = [bool(energy[i, ch, j] > thr2)
                        and bool(active[i, ch, j]) for j in range(8)]
                succ = [gate[j] and bool(det_ok[i, ch, j]) for j in range(8)]
                for j in range(8):
                    tsc = bool(is_tsc[i, ch, j])
                    want = ((fn_delta_c(fn, est[j]) > 50 or not valid[j])
                            and nd)
                    do_est = want and tsc and succ[j]
                    valid[j] = do_est or (valid[j] and not (
                        not detected[i, ch, j] and tsc and gate[j]))
                    if do_est:
                        est[j], last[j] = fn, i
                for j in range(8):
                    act = bool(active[i, ch, j])
                    elapsed = np.float32(fn_delta_c(fn, pf))
                    if act and not gate[j] and elapsed > 50:
                        thr, pf = np.float32(thr - ten), fn
                    if succ[j]:
                        t = np.float32(thr - one)
                        thr = zero if t < zero else t
                    if act and gate[j] and not succ[j]:
                        thr = np.float32(
                            thr + np.float32(ten * _exp32(-elapsed)))
                        pf = fn
                success[i, ch] = succ
                valid_post[i, ch] = valid
                last_post[i, ch] = last
            thr_out[ch], pf_out[ch] = thr, pf
            valid_out[ch], est_out[ch], last_out[ch] = valid, est, last
    return out
