"""Shared inputs and a numpy model of K8, the Viterbi decoder's CUDA
kernel (`csrc/viterbi.cu`). `viterbi_loop` runs the kernel's per-thread
order (the two soft bits' costs, the four branch metrics, the
add-compare-select with uint32 histories, the tree that finds the first
minimum), vectorised over codewords; `tests/test_torch_viterbi.py`
holds it to `viterbi_decode_plain` on the CPU and
`tests/test_torch_cuda.py` holds the kernel to the same on the card.
No JAX here: the card tests import this module."""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import torch

from openbts_ttsou_tpu_torch.gsm import fec

DEFERRAL = 24
STATES = 16
SOURCE = (Path(__file__).resolve().parents[1] / "openbts_ttsou_tpu_torch"
          / "csrc" / "viterbi.cu")

#: (name, K): the codes the system decodes
CODES = (("xcch", 228), ("rach", 18), ("tch", 189), ("sch", 39))
#: the soft inputs of `soft_inputs`
KINDS = ("clean", "gaussian", "flipped", "erased", "erased_stretch",
         "exact_values")
#: soft bits the decoder's clamps and slicer treat at their edges
EXACT_VALUES = np.array([0.0, 0.01, 0.5, 0.99, 1.0], np.float32)


def source_table(name: str) -> list[int]:
    """The integer literals of the table `name` in the kernel's source."""
    m = re.search(name + r"\[[^\]]*\]\s*=\s*\{([^}]*)\}", SOURCE.read_text())
    assert m, f"no table {name} in {SOURCE.name}"
    return [int(v) for v in m.group(1).replace("\n", " ").split(",")]


def soft_inputs(kind: str, rows: int, k: int, seed: int) -> np.ndarray:
    """[rows, 2K] float32 soft bits of random codewords (zero tails): the
    code clean, with Gaussian noise (clipped to [0, 1]), with 5% of its
    bits flipped, all erased (0.5: every branch ties), erased over a
    stretch, or noisy with a third of its bits set to `EXACT_VALUES`."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (rows, k)).astype(np.uint8)
    u[:, -min(4, k):] = 0
    c = fec.conv_encode(torch.from_numpy(u)).numpy().astype(np.float32)
    if kind == "clean":
        return c
    noisy = np.clip(c + rng.normal(0, 0.3, c.shape), 0, 1).astype(np.float32)
    if kind == "gaussian":
        return noisy
    if kind == "flipped":
        return np.where(rng.random(c.shape) < 0.05, 1 - c, c).astype(
            np.float32)
    if kind == "erased":
        return np.full(c.shape, 0.5, np.float32)
    if kind == "erased_stretch":
        a = int(rng.integers(0, max(1, 2 * k - 40)))
        noisy[:, a: a + min(80, 2 * k)] = 0.5
        return noisy
    if kind == "exact_values":
        pick = rng.random(c.shape) < 1 / 3
        vals = EXACT_VALUES[rng.integers(0, len(EXACT_VALUES), c.shape)]
        return np.where(pick, vals, noisy).astype(np.float32)
    raise ValueError(kind)


def _bit_costs(s: np.ndarray):
    one, floor = np.float32(1), np.float32(0.01)
    with np.errstate(invalid="ignore", divide="ignore"):
        oms = one - s
        p = np.where(s < oms, s, oms)
        p = np.where(p < floor, floor, p)
        ip = one - p
        ip = np.where(ip < floor, floor, ip)
        match = np.float32(0.25) / ip
        mismatch = np.float32(0.25) / p
    hard = s > np.float32(0.5)
    return np.where(hard, mismatch, match), np.where(hard, match, mismatch)


def _emitted(cost, hist) -> np.ndarray:
    c, h = list(cost), list(hist)
    w = 1
    while w < STATES:
        for i in range(0, STATES, 2 * w):
            l, r = c[i], c[i + w]
            with np.errstate(invalid="ignore"):
                right = (r < l) | (np.isnan(r) & ~np.isnan(l))
            c[i] = np.where(right, r, l)
            h[i] = np.where(right, h[i + w], h[i])
        w *= 2
    return ((h[0] >> np.uint32(DEFERRAL)) & np.uint32(1)).astype(np.uint8)


def viterbi_loop(soft: np.ndarray) -> np.ndarray:
    """The kernel's decode of soft [rows, 2K] float32: [rows, K] uint8."""
    soft = np.asarray(soft, np.float32)
    rows, k = soft.shape[0], soft.shape[1] // 2
    prev, code = source_table("kPrev"), source_table("kCode")
    low = source_table("kLow")
    cost = [np.zeros(rows, np.float32) for _ in range(STATES)]
    hist = [np.zeros(rows, np.uint32) for _ in range(STATES)]
    out = np.zeros((rows, k), np.uint8)
    pad = np.ones(rows, np.float32)
    for t in range(k + DEFERRAL):
        if t < k:
            a0, a1 = _bit_costs(soft[:, 2 * t])
            b0, b1 = _bit_costs(soft[:, 2 * t + 1])
            bm = [a0 + b0, a0 + b1, a1 + b0, a1 + b1]
        else:
            bm = [pad] * 4
        nc, nh = [], []
        for ns in range(STATES):
            p0, p1 = prev[ns], prev[STATES + ns]
            c0 = cost[p0] + bm[code[ns]]
            c1 = cost[p1] + bm[code[STATES + ns]]
            with np.errstate(invalid="ignore"):
                take1 = c1 < c0
            nc.append(np.where(take1, c1, c0))
            nh.append((np.where(take1, hist[p1], hist[p0]) << np.uint32(1))
                      | np.uint32(low[ns]))
        cost, hist = nc, nh
        if t >= DEFERRAL:
            out[:, t - DEFERRAL] = _emitted(cost, hist)
    return out
