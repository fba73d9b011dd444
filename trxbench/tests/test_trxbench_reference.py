"""The plain reference against the port on the CPU at a few carriers:
bit for bit where the port is, which it is here (its resampler's plain
form is the same product as the benchmark's)."""

from __future__ import annotations

import pytest
import torch

from trxbench import roofline
from trxbench.reference import decode, fir, rx


C = 4


@pytest.mark.parametrize("p,q,taps,t", [(65, 96, 961, 24000),
                                        (96, 65, 651, 16250),
                                        (65, 96, 961, 24192),
                                        (96, 65, 651, 16380)])
def test_resampler_is_the_port_plain_form(p, q, taps, t):
    from openbts_ttsou_tpu_torch.ops import fir as port

    g = torch.Generator().manual_seed(p * q)
    x = torch.complex(torch.randn(3, t, generator=g),
                      torch.randn(3, t, generator=g)) * 100
    ours = fir.resample(x, p, q, fir.resampler_lpf(p, q, taps), rows=2)
    theirs = port.polyphase_resample(x, p, q,
                                     port.resampler_lpf(p, q, taps))
    assert torch.equal(ours, theirs)


@pytest.mark.parametrize("rows,t,p,q,taps", [(512, 24000, 65, 96, 961),
                                             (512, 16250, 96, 65, 651),
                                             (512, 24192, 65, 96, 961),
                                             (512, 16380, 96, 65, 651)])
def test_k1_work_is_the_roofline_tools(rows, t, p, q, taps):
    from openbts_ttsou_tpu_torch.ops import fir as port
    from openbts_ttsou_tpu_torch.tools import roofline as tool

    w = tool.k1_work(rows, t, p, q, port.resampler_lpf(p, q, taps))
    assert roofline.k1_work(rows, t, p, q, taps) == (w.flops, w.bytes)


def test_uplink_reference_is_the_port():
    from openbts_ttsou_tpu_torch.models import transceiver as T
    from openbts_ttsou_tpu_torch.trx import engine as eng
    from trxbench.tests.conftest import small_cell

    cell = small_cell("rxbank512.tsc1", C)
    pool = cell.generator.make(cell.traffic["params"], cell.config, 11,
                               "cpu")["items"]
    slots = [4, 1, 1, 1, 1, 1, 1, 1]
    ours = rx.configured_state(rx.TrxConfig(n_chan=C), slots, 0, 0, "cpu")
    trx = T.Transceiver(eng.TrxConfig(n_chan=C), T.UplinkSpec(), "cpu")
    for ch in range(C):
        for tn, combo in enumerate(slots):
            trx.set_slot(ch, tn, combo)
    for x in pool:
        ours, res = rx.rx_block(rx.TrxConfig(n_chan=C), ours, x)
        theirs = trx.process_uplink(x)
        assert all(torch.equal(a, b) for a, b in zip(res, theirs))
        assert int(res.detected[:, :, 1].sum()) == 13 * C
    assert all(torch.equal(a, b) for a, b in zip(ours, trx.state))


def test_resident_reference_is_the_port():
    """Downlink, decodes and carried state, window by window, with a
    carrier near sensitivity among them."""
    from trxbench.tests.conftest import small_cell

    cell = small_cell("l1res512.coded")
    entry = cell.entry.Entry(cell.config, torch.device("cpu"))
    pool = entry.make_inputs(cell.generator, cell.traffic["params"], 3)
    assert not entry.clean.all()
    first = True
    for item in pool[:3]:
        before = entry.state()
        tx, blocks = entry.call(item)
        after = entry.state()
        ref_after, ref_out = entry.reference(before, item, first)
        found = entry.gaps_of((tx,) + tuple(blocks), after, ref_after,
                              ref_out)
        assert found == {"tx_gap": 0.0, "soft_gap": 0.0, "decode_diffs_per_carrier": 0.0,
                         "state_gap": 0.0}
        first = False


@pytest.mark.parametrize("n", [36, 378, 456])
def test_viterbi_is_the_port(n):
    """The frozen decoder against the port's on noisy soft bits, ties
    included (soft bits of exactly 0.5)."""
    from openbts_ttsou_tpu_torch.gsm import fec

    g = torch.Generator().manual_seed(n)
    soft = torch.rand((64, n), generator=g)
    soft[:, ::7] = 0.5
    soft[:8] = (soft[:8] > 0.5).float()
    assert torch.equal(decode.viterbi_decode(soft), fec.viterbi_decode(soft))


def test_decode_window_is_the_port():
    """The frozen window decoder against the port's `decode_block` with a
    carried prelude, on soft bits of mixed quality, at every phase of
    the 26-multiframe that a 13-frame window can start on."""
    from openbts_ttsou_tpu_torch.models import transceiver as T
    from openbts_ttsou_tpu_torch.trx import engine as eng

    g = torch.Generator().manual_seed(5)
    for fn0 in (0, 13, 26 * 51 - 13, 2 * 26 * 51 + 5):
        soft = torch.rand((13, 2, 8, 148), generator=g)
        soft = torch.where(soft > 0.3, soft.round(), soft)
        prev = torch.rand((8, 2, 8, 148), generator=g).round()
        rach = torch.rand((13, 2, 8), generator=g) > 0.7
        res = eng.RxResult(rach | True, rach, soft,
                           torch.zeros((13, 2, 8), dtype=torch.int32),
                           torch.zeros((13, 2, 8), dtype=torch.int32))
        for valid in (False, True):
            theirs = T.decode_block(res, fn0, 13, 3, prev_soft=prev,
                                    prev_valid=torch.tensor(valid),
                                    xcch_tns=(0, 1, 6, 7),
                                    tch_tns=(2, 3, 4, 5))
            ours = decode.decode_window(soft, rach, fn0, prev, valid, 3,
                                        (0, 1, 6, 7), (2, 3, 4, 5), None)
            assert decode.differences(theirs, ours) == 0
            for a, b in zip(theirs, ours):
                assert a.dtype == b.dtype and torch.equal(a, b)


def test_resident_control_path_runs_on_the_cpu():
    """The control's path (the reference in the program's place),
    compared as the program is: on the CPU, where TF32 does nothing, it
    agrees with the reference exactly."""
    from trxbench import control
    from trxbench.tests.conftest import cpu_run, small_cell

    for name in ("rxbank512.tsc1", "l1res512.coded"):
        out = cpu_run(small_cell(name), seconds=0.2)
        assert all(v == 0 for v in control.control_numbers(
            out["check"]).values())
