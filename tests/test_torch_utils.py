"""The port's utilities off the main path: the F15.16 fixed-point type
(`utils/f16.py`, the cases of tests/test_utils.py and against the JAX
package's copy) and the `torch.profiler` hooks (`utils/profiling.py`)."""

import json

import pytest
import torch

from openbts_ttsou_tpu.utils.f16 import F16 as JF16
from openbts_ttsou_tpu_torch.utils import profiling
from openbts_ttsou_tpu_torch.utils.f16 import F16


def test_f16_fixed_point():
    assert abs(float(F16(1.5) * F16(2.25)) - 3.375) < 1e-4
    assert abs(float(F16(3.0) / F16(2.0)) - 1.5) < 1e-4
    assert abs(float(F16(1.0) + F16(-0.25)) - 0.75) < 1e-4
    # saturation at the 15.16 rail
    assert float(F16(40000.0) * F16(40000.0)) == (2**31 - 1) / 65536
    assert F16(2.0) > F16(1.0)


@pytest.mark.parametrize("a,b", [(1.5, 2.25), (-3.0, 0.7), (40000.0, -2.0),
                                 (-32768.0, -1.0), (1e-5, 3.0), (0.0, 5.5)])
def test_f16_raw_bits_equal_jax(a, b):
    for op in ("__add__", "__sub__", "__mul__", "__neg__"):
        got = getattr(F16(a), op)(*(() if op == "__neg__" else (F16(b),)))
        want = getattr(JF16(a), op)(*(() if op == "__neg__"
                                      else (JF16(b),)))
        assert got.raw == want.raw, op
    if b:
        assert (F16(a) / F16(b)).raw == (JF16(a) / JF16(b)).raw
    assert (F16(a) < F16(b)) == (JF16(a) < JF16(b))
    assert repr(F16(a)) == repr(JF16(a))


def test_profiling_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")) as prof:
        with profiling.span("resample_region"):
            torch.ones(64).cumsum(0)
    trace = json.loads((tmp_path / "t" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "resample_region" in names
    assert any(e.key == "resample_region" for e in prof.key_averages())


def test_maybe_trace_follows_its_environment(tmp_path, monkeypatch):
    monkeypatch.delenv("OPENBTS_TORCH_TRACE", raising=False)
    with profiling.maybe_trace():
        torch.ones(4).sum()
    assert not list(tmp_path.iterdir())
    monkeypatch.setenv("OPENBTS_TORCH_TRACE", str(tmp_path / "env"))
    with profiling.maybe_trace():
        torch.ones(4).sum()
    assert (tmp_path / "env" / "trace.json").is_file()


def test_a_failing_trace_raises(tmp_path):
    """Unlike the JAX copy, a trace that cannot be written is an error."""
    blocker = tmp_path / "file"
    blocker.write_text("x")
    with pytest.raises(OSError):
        with profiling.trace(str(blocker / "t")):
            pass
