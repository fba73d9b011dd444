"""The equalized uplink on the CPU: the port's receiver with a max delay
of 4 symbols (channel estimate, DFE design, equalizer, RACH acceptance)
against the benchmark's plain reference, bit for bit, on the traffic of
the cell `rxbank512dfe.tu_rach` at 4 carriers; that traffic's multipath
and access bursts (`trxbench/generators/multipath.py`); and the spans
`rx.dfe_design` and `rx.equalize` with their readers."""

import collections
import importlib.util
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from openbts_ttsou_tpu_torch.models import transceiver as T
from openbts_ttsou_tpu_torch.trx import engine as eng
from openbts_ttsou_tpu_torch.utils import profiling
from trxbench import generate
from trxbench.generators import multipath
from trxbench.reference import gmsk
from trxbench.reference import rx as ref

ROOT = Path(__file__).resolve().parents[1]
C = 4
SEED = 2 ** 31 + 4242
CONFIG = dict(json.loads(
    (ROOT / "trxbench" / "configs" / "rxbank512dfe.json").read_text()),
    carriers=C)
PARAMS = json.loads(
    (ROOT / "trxbench" / "traffic" / "tu_rach.json").read_text())["params"]


def _transceiver(max_delay: int, rach_slots=(0,)) -> T.Transceiver:
    trx = T.Transceiver(eng.TrxConfig(n_chan=C, rach_slots=rach_slots),
                        T.UplinkSpec(), "cpu")
    for ch in range(C):
        for tn, combo in enumerate(CONFIG["slots"]):
            trx.set_slot(ch, tn, combo)
        trx.set_max_delay(ch, max_delay)
    return trx


@pytest.fixture(scope="module")
def pool():
    return multipath.make(PARAMS, CONFIG, SEED, "cpu")


@pytest.fixture(scope="module")
def received(pool):
    """The port's and the reference's (state, result) after each block of
    the pool, from the configured state."""
    cfg = ref.TrxConfig(n_chan=C, rach_slots=(0,))
    theirs = ref.configured_state(cfg, CONFIG["slots"], CONFIG["tsc"],
                                  CONFIG["max_delay"], "cpu")
    trx = _transceiver(CONFIG["max_delay"])
    out = []
    for x in pool["items"]:
        theirs, res = ref.rx_block(cfg, theirs, x)
        ours = trx.process_uplink(x)
        out.append(((trx.state, ours), (theirs, res)))
    return out


def test_config_is_the_stock_openbts_cell():
    assert CONFIG["max_delay"] == 4 and CONFIG["rach_slots"] == [0]
    assert CONFIG["max_toa"] is None and CONFIG["reduced"] == []
    assert CONFIG["slots"] == [4, 1, 1, 1, 1, 1, 1, 1]
    assert CONFIG["entry"] == "uplink" and len(CONFIG["source"]) <= 200


def test_uplink_with_the_equalizer_is_the_reference(received):
    for (ours_st, ours), (theirs_st, theirs) in received:
        assert all(torch.equal(a, b) for a, b in zip(ours, theirs))
        assert all(torch.equal(a, b) for a, b in zip(ours_st, theirs_st))
    # the equalizer ran: every carrier's TSC slots hold a channel estimate
    assert bool(received[-1][0][0].chan_valid[:, 1:].all())


def test_expected_bursts_are_detected(pool, received):
    for exp, ((_, ours), _) in zip(pool["expect"], received):
        det, rach = ours[0].numpy(), ours[1].numpy()
        assert not (exp["detect"] & ~det).any()
        assert not (exp["rach"] & ~rach).any()
        assert exp["detect"][:, :, 1].all() and not exp["rach"][:, :, 1:].any()
        # RACH is flagged on TS0 alone, which carries no TSC burst
        assert not rach[:, :, 1:].any()
        assert not (det[:, :, 0] & ~rach[:, :, 0]).any()


def test_access_bursts_are_held_to_the_max_delay():
    """At max delay 4 an access burst is flagged up to a TOA of 4
    symbols and rejected above; the reported timing is the burst's TOA
    within a tenth of a symbol."""
    g = generate.generator(SEED, "cpu")
    trx = _transceiver(4)
    ra = PARAMS["rach"]["frames"]
    toas, flags, timing = [], [], []
    for _ in range(2):
        sym, toa = multipath.block(PARAMS, C, g, "cpu")
        res = trx.process_uplink(generate.to_device_rate(sym).contiguous())
        toas.append(toa / multipath.OVERSAMPLE)
        flags.append(res.is_rach[ra, :, 0].numpy())
        timing.append(res.timing[ra, :, 0].numpy() / 256.0)
    toa, flag, timing = (np.concatenate(a) for a in (toas, flags, timing))
    assert flag[toa < 3.9].all() and not flag[toa > 4.1].any()
    assert flag.any() and not flag.all()
    assert np.abs(timing[flag] - toa[flag]).max() < 0.1


def test_tu_taps_have_the_published_delays_and_powers():
    prof = PARAMS["profile"]
    assert prof["delays_us"] == [0.0, 0.2, 0.5, 1.6, 2.3, 5.0]
    assert prof["powers_db"] == [-3.0, 0.0, -2.0, -6.0, -8.0, -10.0]
    # at 16 samples a symbol of 48/13 µs
    assert multipath.tap_delays(prof["delays_us"]) == [0, 1, 2, 7, 10, 22]
    p = multipath.tap_powers(prof["powers_db"])
    assert p.sum() == pytest.approx(1.0, abs=1e-12)
    np.testing.assert_allclose(10 * np.log10(p / p[1]), prof["powers_db"],
                               atol=1e-9)


def test_one_path_at_delay_zero_is_the_bursts_burst():
    """The 16-sample-a-symbol form, one path at delay 0, kept at every
    16th sample: `bursts.py`'s burst, modulated at one sample a
    symbol; a path 16 samples late is the same burst a symbol later."""
    g = torch.Generator().manual_seed(5)
    bits = generate.normal_bursts(6, 0, g, "cpu")
    one = torch.ones((6, 1), dtype=torch.complex64)
    ours = multipath.through_paths(bits, [0], one) * 9000.0
    theirs = gmsk.modulate_burst(bits, 1) * 9000.0
    assert ours.shape == theirs.shape == (6, 148)
    torch.testing.assert_close(ours, theirs, rtol=0, atol=2e-3)
    late = multipath.through_paths(bits, [16], one) * 9000.0
    assert late.shape == (6, 149) and not late[:, 0].abs().any()
    torch.testing.assert_close(late[:, 1:], ours, rtol=0, atol=2e-3)


def test_pool_is_seeded(pool):
    again = multipath.make(PARAMS, CONFIG, SEED, "cpu")
    other = multipath.make(PARAMS, CONFIG, SEED + 1, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(pool["items"],
                                                 again["items"]))
    assert all(np.array_equal(a["rach"], b["rach"])
               for a, b in zip(pool["expect"], again["expect"]))
    assert not any(torch.equal(a, b) for a, b in zip(pool["items"],
                                                     other["items"]))
    assert [x.shape for x in pool["items"]] == [(C, 24000)] * 4
    assert not torch.equal(pool["items"][0], pool["items"][1])


# ---- the equalizer's spans ------------------------------------------------

def _names(fn):
    t0 = time.perf_counter_ns()
    fn()
    return collections.Counter(
        s[0] for s in profiling.spans_between(t0, time.perf_counter_ns()))


@pytest.mark.parametrize("max_delay", [0, 4])
def test_block_records_the_equalizer_spans_once(pool, max_delay):
    """`process_block_exact`: one `rx.dfe_design` and one `rx.equalize` a
    block with the equalizer on, none with it off."""
    trx = _transceiver(max_delay)
    assert T.exact_schedule(C) == "batched"
    for x in pool["items"][:2]:
        n = _names(lambda: trx.process_uplink(x))
        want = 1 if max_delay > 1 else 0
        assert n["trx.uplink"] == 1
        assert n["rx.dfe_design"] == n["rx.equalize"] == want


@pytest.mark.parametrize("max_delay", [0, 4])
def test_frame_step_records_the_equalizer_spans(pool, max_delay):
    """`rx_step`: from the configured state a frame estimates every TSC
    slot and equalizes, one span each; with the equalizer off, none."""
    trx = _transceiver(max_delay)
    lpf = T.fir.resampler_lpf(65, 96, 961)
    sym = T.fir.polyphase_resample(pool["items"][0], 65, 96, lpf)
    wins = T._slot_windows(sym[..., : 13 * 1250], 13)
    n = _names(lambda: eng.rx_step(trx.cfg, trx.state, wins[0]))
    want = 1 if max_delay > 1 else 0
    assert n["rx.dfe_design"] == n["rx.equalize"] == want
    assert n["sync.est_gate"] == n["sync.dfe_gate"] == 1
    assert n["rx.walk"] == 1


def test_frame_after_adoption_designs_no_equalizer():
    """A frame's estimation gate is its own want, not the bound of a
    window (where a TSC burst in an earlier frame keeps it open): once a
    frame has adopted an estimate on every slot (every slot a TCH/F
    carrying a normal burst), the next frame designs no equalizer (no
    `rx.dfe_design`) and still equalizes."""
    g = generate.generator(SEED, "cpu")
    cfg = eng.TrxConfig(n_chan=C)
    state = eng.init_state(cfg, "cpu")._replace(
        chan_type=torch.full((C, 8), eng.ChanType.I, dtype=torch.int32),
        max_expected_delay=torch.full((C,), 4, dtype=torch.int32))

    def frame():
        bits = generate.normal_bursts(C * 8, 0, g, "cpu")
        x = torch.zeros((C * 8, eng.SLOT_SAMPLES), dtype=torch.complex64)
        x[:, :148] = gmsk.modulate_burst(bits, 1) * 9000.0
        return (x + generate.noise((C * 8, eng.SLOT_SAMPLES), 10.0, g, "cpu")
                ).reshape(C, 8, eng.SLOT_SAMPLES)

    out = []
    n = _names(lambda: out.append(eng.rx_step(cfg, state, frame())))
    state, res = out[0]
    assert n["rx.dfe_design"] == 1
    assert bool(res.detected.all()) and bool(state.chan_valid.all())
    n = _names(lambda: eng.rx_step(cfg, state, frame()))
    assert n["rx.dfe_design"] == 0 and n["rx.equalize"] == 1
    assert n["rx.walk"] == n["sync.est_gate"] == 1


def test_equalizer_spans_nest_in_the_receiver(pool):
    trx = _transceiver(4)
    t0 = time.perf_counter_ns()
    trx.process_uplink(pool["items"][0])
    spans = profiling.spans_between(t0, time.perf_counter_ns())
    parents = {s[0]: s[3] for s in spans}
    assert parents["rx.dfe_design"] == parents["rx.equalize"] == "rx.exact"
    # the equalizer's table copy is a sync span inside its span
    assert "rx.equalize" in {s[3] for s in spans if s[0] == "sync.table"}


def _reader(metric: str):
    path = ROOT / "trxbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "test_dfe_reader_" + metric, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("max_delay,metrics", [
    (4, ("dfe_design_ms", "equalize_ms")), (0, ())])
def test_equalizer_readers_read_the_programs_record(pool, max_delay,
                                                    metrics):
    """Both readers read a real window with the equalizer on, and give
    None where its spans do not occur."""
    trx = _transceiver(max_delay)
    calls = []
    for x in pool["items"][:2]:
        t_issue = time.perf_counter()
        trx.process_uplink(x)
        t_done = time.perf_counter()
        calls.append({"issue": t_issue, "ret": t_done, "done": t_done})
    rec = {"calls": calls}
    for metric in ("dfe_design_ms", "equalize_ms"):
        v = _reader(metric)(rec)
        if metric in metrics:
            assert v is not None and 0 < v < 1e3 * (t_done - calls[0]["issue"])
        else:
            assert v is None
