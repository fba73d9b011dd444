"""The control on the card: the reference computed in TF32 in the
program's place is not correct at a size a test run holds. The full-size
readings come from `python -m trxbench.control` on the card."""

from __future__ import annotations

import pytest
import torch

from trxbench import control
from trxbench.tests.conftest import small_cell


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rxbank512.tsc1", "l1res512.coded"])
def test_tf32_control_is_not_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("the control's TF32 runs only on a CUDA card")
    from trxbench import run

    cell = small_cell(name, carriers=64)
    out = run.run_cell(cell, 3, 1.0, False, torch.device("cuda", 0))
    assert out["result"]["correct"]
    numbers = control.control_numbers(out["check"])
    assert any(v > cell.limits[k] for k, v in numbers.items()), numbers
