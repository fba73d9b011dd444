"""The threshold walk (K7) on the CPU: the walk in the CUDA kernel's order
(`walk_cases.walk_loop`, numpy, one carrier at a time) against
`exact_walk_plain` on inputs that reach its corners; the kernel's
frame-number arithmetic against `fn_delta`; the dispatch, the wrapper's
refusal of CPU tensors and the `rx.walk` span. The kernel itself is
held to `exact_walk_plain` on the card (`test_torch_cuda.py`)."""

import collections
import time

import numpy as np
import pytest
import torch

import walk_cases as W
from openbts_ttsou_tpu_torch.models import transceiver as T
from openbts_ttsou_tpu_torch.ops import cuda_walk
from openbts_ttsou_tpu_torch.trx import engine as eng
from openbts_ttsou_tpu_torch.utils import profiling
from openbts_ttsou_tpu_torch.utils.gsm_time import fn_delta


def _equal(got, want):
    for name, g, w in zip(eng.ExactWalk._fields, got, want):
        g = torch.as_tensor(g)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name


@pytest.mark.parametrize("f,c,seed,wrap", [
    (1, 1, 11, True), (1, 37, 12, True), (13, 1, 13, True),
    (13, 37, 14, True), (26, 37, 15, True), (26, 1, 16, True),
    (13, 64, 17, False), (26, 37, 18, False)])
def test_walk_in_the_kernels_order_matches_plain(f, c, seed, wrap):
    args = W.walk_inputs(f, c, seed, wrap=wrap)
    _equal(W.walk_loop(*args), eng.exact_walk_plain(*args))


def test_walk_inputs_reach_the_corners():
    """The cases above move the threshold through 0 and below it, adopt
    channels, clear validity and move the false-detect frame."""
    args = W.walk_inputs(26, 512, 6)
    state = args[7]
    w = eng.exact_walk_plain(*args)
    assert (w.thr_entry == 0).any() and (w.thr_entry < 0).any()
    assert ((w.thr_entry > 0) & (w.thr_entry < 1)).any()
    assert (w.last >= 0).any() and (w.last < 0).any()
    assert (state.chan_valid & ~w.valid).any()
    assert (w.prev_false != state.prev_false_detect_fn).any()
    assert args[6].any() and not args[6].all()
    assert (args[0][1:] < args[0][:-1]).any()  # the hyperframe wraps


def test_kernel_frame_delta_matches_fn_delta():
    h = W.HYPERFRAME
    vals = [0, 1, 50, 51, h // 2 - 1, h // 2, h // 2 + 1, h - 1,
            h - 51, 2 ** 31 - 1, -2 ** 31, -1, -h, 7 * h + 3]
    a = torch.tensor([v1 for v1 in vals for _ in vals], dtype=torch.int32)
    b = torch.tensor([v2 for _ in vals for v2 in vals], dtype=torch.int32)
    want = fn_delta(a, b).tolist()
    got = [W.fn_delta_c(int(x), int(y)) for x, y in zip(a, b)]
    assert got == want


def test_exact_walk_takes_the_plain_form_on_the_cpu():
    args = W.walk_inputs(13, 8, 21)
    n0 = cuda_walk.exact_walk_cuda.launches
    _equal(eng.exact_walk(*args), eng.exact_walk_plain(*args))
    assert cuda_walk.exact_walk_cuda.launches == n0


def test_walk_kernel_refuses_cpu_tensors():
    fns, active, is_tsc, energy, detected, det_ok, need_dfe, st = (
        W.walk_inputs(2, 4, 22))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_walk.exact_walk_cuda(
            fns, active, is_tsc, energy, detected, det_ok, need_dfe,
            st.energy_threshold, st.prev_false_detect_fn, st.chan_valid,
            st.chan_estimate_fn)


def test_block_records_one_walk_span_inside_the_receiver():
    trx = T.Transceiver(eng.TrxConfig(n_chan=2), T.UplinkSpec(), "cpu")
    x = (torch.randn(2, trx.spec.block_in, dtype=torch.complex64,
                     generator=torch.Generator().manual_seed(3)) * 10)
    assert T.exact_schedule(2) == "batched"
    for _ in range(2):
        t0 = time.perf_counter_ns()
        trx.process_uplink(x)
        spans = profiling.spans_between(t0, time.perf_counter_ns())
        n = collections.Counter(s[0] for s in spans)
        assert n["rx.walk"] == 1 and n["rx.exact"] == 1
        assert {s[3] for s in spans if s[0] == "rx.walk"} == {"rx.exact"}
        # the walk waits for nothing: no sync span inside it
        assert "rx.walk" not in {s[3] for s in spans}
