"""The traffic generators: the same seed gives the same inputs, another
seed other inputs, and every seed the same sizes."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from trxbench import generate
from trxbench.tests.conftest import small_cell

BIG = 2 ** 31 + 12345


def _flat(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, np.ndarray):
        return [torch.from_numpy(x)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _flat(v)]
    return [t for v in x for t in _flat(v)]


def _same(a, b):
    fa, fb = _flat(a), _flat(b)
    return len(fa) == len(fb) and all(torch.equal(x, y)
                                      for x, y in zip(fa, fb))


def _shapes(a):
    return [tuple(t.shape) for t in _flat(a)]


def _make(name, seed, carriers):
    cell = small_cell(name, carriers)
    return cell.generator.make(cell.traffic["params"], cell.config, seed,
                               "cpu")


@pytest.mark.parametrize("name,carriers", [("rxbank512.tsc1", 3),
                                           ("l1res512.coded", 4)])
def test_pool_is_seeded(name, carriers):
    a = _make(name, BIG, carriers)
    assert _same(a, _make(name, BIG, carriers))
    b = _make(name, BIG + 1, carriers)
    assert not _same(a, b) and _shapes(a) == _shapes(b)
    assert not _same(a["items"][0], a["items"][1])  # the items differ


def test_uplink_blocks_and_expectations():
    pool = _make("rxbank512.tsc1", 5, 3)
    assert len(pool["items"]) == 4 and pool["items"][0].shape == (3, 24000)
    detect = pool["expect"][0]["detect"]
    assert detect.shape == (13, 3, 8) and detect[:, :, 1].all()
    assert detect.sum() == 13 * 3


def test_coded_uplink_is_periodic_with_weak_carriers():
    """The last window's right halo is the first window's start; every
    fourth carrier is received near sensitivity."""
    pool = _make("l1res512.coded", 5, 8)
    ul = [it[0] for it in pool["items"]]
    h = generate.RX_HALO_DEV
    assert ul[0].shape == (8, 24192)
    assert torch.equal(ul[-1][:, -2 * h:], ul[0][:, :2 * h])
    assert torch.equal(ul[0][:, -2 * h:], ul[1][:, :2 * h])
    assert pool["expect"]["clean"].tolist() == [True, True, True, False] * 2
    power = ul[0].abs().square().mean(-1)
    assert (power[3] > 1.3 * power[0]).item()  # 3.5 dB of noise added
