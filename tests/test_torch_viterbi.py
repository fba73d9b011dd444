"""The Viterbi decoder (K8) on the CPU: the decode in the CUDA kernel's
order (`viterbi_cases.viterbi_loop`, numpy) against
`viterbi_decode_plain` at every code the system decodes and on inputs
that reach the ties and the clamps; the kernel's trellis tables against
`gsm/fec.py`'s; the dispatch, the wrapper's refusals, the row views the
kernel reads in place and the `fec.viterbi` span. The kernel itself is
held to `viterbi_decode_plain` on the card (`test_torch_cuda.py`)."""

import collections
import time

import numpy as np
import pytest
import torch

import viterbi_cases as V
from openbts_ttsou_tpu_torch import build
from openbts_ttsou_tpu_torch.gsm import fec
from openbts_ttsou_tpu_torch.models import ResidentL1
from openbts_ttsou_tpu_torch.models import transceiver as T
from openbts_ttsou_tpu_torch.ops import cuda_viterbi
from openbts_ttsou_tpu_torch.trx import engine as eng
from openbts_ttsou_tpu_torch.utils import profiling


@pytest.fixture
def no_library(monkeypatch):
    """Fail any attempt to build or load a kernel library."""
    def refuse(name):
        raise AssertionError(f"loaded the kernel library {name!r}")

    monkeypatch.setattr(build, "load", refuse)


@pytest.mark.parametrize("code,k", V.CODES)
@pytest.mark.parametrize("kind", V.KINDS)
def test_decode_in_the_kernels_order_matches_plain(code, k, kind):
    soft = V.soft_inputs(kind, 7, k, seed=k)
    want = fec.viterbi_decode_plain(torch.from_numpy(soft)).numpy()
    np.testing.assert_array_equal(V.viterbi_loop(soft), want)
    if kind == "clean":  # the code's own bits decode back
        c = fec.conv_encode(torch.from_numpy(want)).numpy()
        np.testing.assert_array_equal(c, soft.astype(np.uint8))
    if kind == "erased":  # every branch ties: the 0-prefix, all zeros
        assert not want.any()


def test_decode_in_the_kernels_order_keeps_nan_and_inf():
    """A NaN soft bit makes NaN costs (torch.argmin then takes the first
    NaN); ±inf clamp like any bit past the edge."""
    soft = V.soft_inputs("gaussian", 6, 39, seed=3)
    soft[0, 10] = np.nan
    soft[1, 3:60] = np.nan
    soft[2, :] = np.nan
    soft[3, 20] = np.inf
    soft[4, 21] = -np.inf
    soft[5, 40:44] = [np.inf, -np.inf, np.nan, 0.5]
    want = fec.viterbi_decode_plain(torch.from_numpy(soft)).numpy()
    np.testing.assert_array_equal(V.viterbi_loop(soft), want)


def test_kernel_tables_are_the_trellis():
    np.testing.assert_array_equal(V.source_table("kPrev"),
                                  fec._viterbi_prev())
    np.testing.assert_array_equal(V.source_table("kCode"),
                                  fec._viterbi_code())
    np.testing.assert_array_equal(V.source_table("kLow"),
                                  fec._viterbi_low_bit())


def test_viterbi_decode_takes_the_plain_form_on_the_cpu(no_library):
    soft = torch.from_numpy(V.soft_inputs("gaussian", 5, 228, seed=1))
    n0 = cuda_viterbi.viterbi_decode_cuda.launches
    got = fec.viterbi_decode(soft.reshape(5, 1, 456))
    assert torch.equal(got.reshape(5, 228), fec.viterbi_decode_plain(soft))
    assert cuda_viterbi.viterbi_decode_cuda.launches == n0


@pytest.mark.parametrize("soft,error", [
    (torch.zeros(4, 456), ValueError),
    (torch.zeros(4, 456, dtype=torch.float64), TypeError),
    (torch.zeros(4, 456, dtype=torch.uint8), TypeError)])
def test_viterbi_kernel_refuses_before_loading(no_library, soft, error):
    n0 = cuda_viterbi.viterbi_decode_cuda.launches
    with pytest.raises(error):
        cuda_viterbi.viterbi_decode_cuda(soft)
    assert cuda_viterbi.viterbi_decode_cuda.launches == n0


def test_codeword_rows_read_slices_in_place():
    """TCH's [..., :378] and RACH's 36 bits of each 148 reach the kernel
    as views at the wider row's stride; a layout with no single row
    stride is copied."""
    c_soft = torch.rand(3, 8, 456)
    tch = fec.codeword_rows(c_soft[..., :378])
    assert tch.shape == (24, 378) and tch.stride() == (456, 1)
    assert tch.data_ptr() == c_soft.data_ptr()
    bursts = torch.rand(13, 4, 8, 148)
    rach = fec.codeword_rows(bursts[..., 49:85])
    assert rach.shape == (13 * 4 * 8, 36) and rach.stride() == (148, 1)
    assert rach.data_ptr() == bursts[..., 49:].data_ptr()
    cols = torch.rand(36, 10).T  # each row's bits 10 apart
    moved = fec.codeword_rows(cols)
    assert moved.is_contiguous() and torch.equal(moved, cols)


def test_decode_block_records_four_viterbi_spans():
    """One `fec.viterbi` span a decoder call, inside `fec.decode`: XCCH,
    RACH, TCH and FACCH, four a window."""
    c = 2
    layer = ResidentL1(eng.TrxConfig(n_chan=c), xcch_tns=(0, 1, 6, 7),
                       tch_tns=(2, 3, 4, 5), device="cpu")
    ul = np.zeros((c, layer.spec.block_in + 2 * T.RX_HALO_DEV),
                  np.complex64)
    content = layer.empty_content(np.zeros((c, 8), bool))
    t0 = time.perf_counter_ns()
    layer.step(ul, content)
    spans = profiling.spans_between(t0, time.perf_counter_ns())
    n = collections.Counter(s[0] for s in spans)
    assert n["fec.viterbi"] == 4 and n["fec.decode"] == 1
    assert {s[3] for s in spans if s[0] == "fec.viterbi"} == {"fec.decode"}
