"""The port's L1 channel objects (openbts_ttsou_tpu_torch/gsm/channels.py)
against the JAX package's, bit for bit, on the CPU: the same seeded
numpy input goes through both classes and everything they emit is
compared (downlink bursts with their frame numbers, frames and speech
delivered upward, counters and measurements). Also the frame clock
(utils/gsm_time.py) at the hyperframe wrap.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openbts_ttsou_tpu.gsm import channels as jch
from openbts_ttsou_tpu.gsm import l1fec as jl1
from openbts_ttsou_tpu.gsm import tdma as jtdma
from openbts_ttsou_tpu.gsm import lapdm as jlapdm
from openbts_ttsou_tpu.gsm import transfer as jtr
from openbts_ttsou_tpu.utils import gsm_time as jtime
from openbts_ttsou_tpu_torch.gsm import channels as pch
from openbts_ttsou_tpu_torch.gsm import tdma as ptdma
from openbts_ttsou_tpu_torch.gsm import transfer as ptr
from openbts_ttsou_tpu_torch.utils import gsm_time as ptime

HF = jtime.HYPERFRAME


def both(name, *args, mapping=None, **kw):
    """The JAX and the port's instance of channel class `name`, built as
    name(*args, downlink, uplink, **kw) when `mapping` names a table of
    gsm/tdma.py (and an index in it, or None): a (downlink, uplink) pair,
    or one mapping used both ways. Each package's own table is used."""
    jargs = pargs = args
    if mapping is not None:
        table, i = mapping
        jm, pm = getattr(jtdma, table), getattr(ptdma, table)
        if i is not None:
            jm, pm = jm[i], pm[i]
        if not isinstance(jm, tuple):
            jm, pm = (jm, jm), (pm, pm)
        jargs, pargs = args + tuple(jm), args + tuple(pm)
    return (getattr(jch, name)(*jargs, **kw),
            getattr(pch, name)(*pargs, device="cpu", **kw))


def bursts(q):
    """A tx queue (or list of TxBursts) as comparable tuples."""
    return [(b.fn, b.tn, np.asarray(b.bits, np.uint8).tobytes()) for b in q]


class Upstream:
    """Records the L2 frames an L1 hands up."""

    def __init__(self):
        self.frames = []

    def write_low_side(self, frame):
        self.frames.append(np.asarray(frame.bits, np.uint8).tobytes())


def counters(l1):
    return (l1.good_frames, l1.bad_frames, l1.phy_count, l1.rssi_sum,
            l1.timing_sum)


def noisy(bits, rng, sigma):
    """Soft bits from hard ones: σ = 0 gives clean 0/1 floats."""
    soft = np.asarray(bits, np.float32) + \
        (sigma * rng.standard_normal(np.shape(bits))).astype(np.float32)
    return np.clip(soft, 0.0, 1.0).astype(np.float32)


def feed(pair, softs_fns, tn):
    """The same RxBursts into both channels (each package's class)."""
    for soft, fn, rssi, te in softs_fns:
        pair[0].write_low_side(jtr.RxBurst(soft, fn=fn, tn=tn, rssi=rssi,
                                           timing_error=te))
        pair[1].write_low_side(ptr.RxBurst(soft, fn=fn, tn=tn, rssi=rssi,
                                           timing_error=te))


# ---- the frame clock --------------------------------------------------------

def test_gsm_time_constants_equal():
    for name in ("HYPERFRAME", "SLOT_SAMPLE_PATTERN", "FRAME_SYMBOLS",
                 "SLOTS_PER_FRAME", "SLOT_LEN", "SYMBOL_RATE",
                 "FRAME_SECONDS"):
        assert getattr(ptime, name) == getattr(jtime, name), name


WRAP_FNS = [0, 1, 25, 51, HF // 2 - 1, HF // 2, HF // 2 + 1, HF - 52,
            HF - 2, HF - 1, HF, HF + 3, -1, -HF // 2, 3 * HF + 7]


@pytest.mark.parametrize("v2", [0, 5, HF - 1, HF // 2, 1357])
def test_fn_delta_and_compare_at_the_wrap(v2):
    for v1 in WRAP_FNS:
        assert ptime.fn_delta(v1, v2) == jtime.fn_delta(v1, v2), (v1, v2)
        assert ptime.fn_compare(v1, v2) == jtime.fn_compare(v1, v2)
    v1s = np.asarray(WRAP_FNS, np.int64)
    for dtype in (torch.int32, torch.int64):
        got = ptime.fn_delta(torch.as_tensor(v1s, dtype=dtype), v2)
        want = np.asarray(jtime.fn_delta(jnp.asarray(v1s, jnp.int32), v2))
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            ptime.fn_compare(torch.as_tensor(v1s, dtype=dtype), v2).numpy(),
            np.asarray(jtime.fn_compare(jnp.asarray(v1s, jnp.int32), v2)))


def test_slot_offsets_and_burst_index():
    for tn in range(8):
        assert ptime.slot_sample_offset(tn) == jtime.slot_sample_offset(tn)
    tns = np.arange(8)
    np.testing.assert_array_equal(
        ptime.slot_sample_offset(torch.as_tensor(tns)).numpy(),
        np.asarray(jtime.slot_sample_offset(jnp.asarray(tns))))
    for fn in WRAP_FNS:
        for tn in (0, 7):
            assert ptime.fn_tn_to_index(fn, tn) == \
                jtime.fn_tn_to_index(fn, tn)


def as_tuple(t):
    return (t.fn, t.tn)


@pytest.mark.parametrize("fn", [0, 50, HF - 1, HF - 26, HF + 5, -3])
def test_time_arithmetic_at_the_wrap(fn):
    for tn in (0, 3, 7):
        j, p = jtime.Time(fn, tn), ptime.Time(fn, tn)
        assert as_tuple(p) == as_tuple(j) and repr(p) == repr(j)
        for step in (1, 7, 26, 51, HF - 1, -1, -52):
            assert as_tuple(p + step) == as_tuple(j + step)
            assert as_tuple(p - step) == as_tuple(j - step)
            assert as_tuple(p.inc_tn(step)) == as_tuple(j.inc_tn(step))
            assert as_tuple(p.dec_tn(step)) == as_tuple(j.dec_tn(step))
        for w, mod in ((0, 51), (6, 51), (12, 26), (3, 4)):
            assert as_tuple(p.roll_forward(w, mod)) == \
                as_tuple(j.roll_forward(w, mod))
        for other in (0, 1, HF - 1, HF // 2, fn + 1, fn - 1):
            for otn in (0, tn, 7):
                jo, po = jtime.Time(other, otn), ptime.Time(other, otn)
                assert as_tuple(p + po) == as_tuple(j + jo)
                assert (p - po) == (j - jo)
                assert (p < po, p > po, p <= po, p >= po) == \
                    (j < jo, j > jo, j <= jo, j >= jo)
        assert p.burst_index() == j.burst_index()


def test_z100_timer_deadlines(monkeypatch):
    now = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    jt, pt = jtime.Z100Timer(250), ptime.Z100Timer(250)

    def state():
        return [(t.active(), t.expired(), t.remaining()) for t in (jt, pt)]

    seen = []
    for action, arg in (("check", None), ("set", None), ("advance", 0.1),
                        ("advance", 0.149), ("advance", 0.001),
                        ("set", 4000), ("advance", 3.9995),
                        ("advance", 0.0005), ("reset", None),
                        ("set", None), ("advance", 10.0)):
        if action == "advance":
            now[0] += arg
        elif action == "set":
            jt.set(arg)
            pt.set(arg)
        elif action == "reset":
            jt.reset()
            pt.reset()
        j, p = state()
        assert j == p, (action, arg)
        seen.append(j)
    # running, then expired at its deadline, after a reset inactive
    assert seen[2][:2] == (True, False) and seen[4] == (True, True, 0)
    assert seen[8] == (False, False, 0) and seen[-1] == (True, True, 0)


# ---- XCCH-style channels: SDCCH, SACCH, CCCH --------------------------------

XCCH_KINDS = [("XCCHL1", ("SDCCH_4", 1), 0),
              ("XCCHL1", ("SDCCH_8", 5), 1),
              ("SACCHL1", ("SACCH_C4", 2), 0),
              ("SACCHL1", ("SACCH_C8", 7), 1),
              ("CCCHL1", ("CCCH", 0), 0)]


def make_xcch(name, mapping, tn, tsc):
    return both(name, tn, mapping=mapping, tsc=tsc)


@pytest.mark.parametrize("name,mapping,tn", XCCH_KINDS)
@pytest.mark.parametrize("tsc", [None, 2, 7])
def test_send_l2_bursts_equal(name, mapping, tn, tsc):
    rng = np.random.default_rng(hash((name, tn, tsc)) % 2**32)
    pair = make_xcch(name, mapping, tn, tsc)
    for ch in pair:
        ch.open(40)
    if name == "SACCHL1":
        for ch in pair:
            ch.ordered_ms_power, ch.ordered_ms_timing = 17, 9.6
    for _ in range(3):
        bits = rng.integers(0, 2, 184).astype(np.uint8)
        pair[0].send_l2(jtr.L2Frame(bits))
        pair[1].send_l2(ptr.L2Frame(bits))
    assert pair[1].next_write_fn == pair[0].next_write_fn
    got, want = bursts(pair[1].tx_queue), bursts(pair[0].tx_queue)
    assert len(want) == 12 and got == want


def uplink_blocks(pair, rng, n_blocks, sigma, erase_every=0):
    """n_blocks 4-burst blocks of random L2 content on the channel's
    uplink mapping, coded by the JAX encoder, as (soft, fn, rssi,
    timing) tuples; every `erase_every`-th burst is left out."""
    ul = pair[0].uplink
    fn, out, k = 0, [], 0
    for _ in range(n_blocks):
        bits = rng.integers(0, 2, 184).astype(np.uint8)
        coded = np.asarray(jl1.xcch_encode(
            np.asarray(jl1.lsb8msb(bits))[None]))[0]
        for b in coded:
            fn = ul.next_write_time(fn)
            k += 1
            if not (erase_every and k % erase_every == 0):
                out.append((noisy(b, rng, sigma), fn,
                            float(-rng.integers(40, 90)),
                            float(rng.uniform(-2, 2))))
            fn += 1
    return out


@pytest.mark.parametrize("name,mapping,tn", XCCH_KINDS[1:3])
@pytest.mark.parametrize("sigma,erase", [(0.0, 0), (0.34, 0), (0.25, 3)])
def test_xcch_write_low_side_equal(name, mapping, tn, sigma, erase):
    """Clean blocks, noise (σ 0.34: about half the blocks fail) and
    erased bursts (every third missing, read as 0.5)."""
    rng = np.random.default_rng(int(sigma * 100) + 7 * erase + tn)
    pair = make_xcch(name, mapping, tn, 2)
    ups = (Upstream(), Upstream())
    for ch, up in zip(pair, ups):
        ch.open(0)
        ch.upstream = up
    feed(pair, uplink_blocks(pair, rng, 3, sigma, erase), tn)
    assert ups[1].frames == ups[0].frames
    assert counters(pair[1]) == counters(pair[0])
    if sigma == 0.0 and not erase:
        assert pair[0].good_frames == 3  # clean blocks all decode
    if name == "SACCHL1":
        assert (pair[1].actual_ms_power, pair[1].actual_ms_timing) == \
            (pair[0].actual_ms_power, pair[0].actual_ms_timing)


def test_xcch_noise_gives_failures_on_both():
    """The noisy case above does exercise the failure path."""
    rng = np.random.default_rng(3)
    pair = make_xcch("XCCHL1", ("SDCCH_8", 0), 0, None)
    for ch in pair:
        ch.open(0)
    feed(pair, uplink_blocks(pair, rng, 5, 0.34), 0)
    assert counters(pair[1]) == counters(pair[0])
    assert pair[0].bad_frames > 0 and pair[0].good_frames > 0


def test_sacch_header_round_trip():
    """The SACCH L1 header (power level, TA) the port sends decodes to
    the same power and timing on both decoders."""
    tx = pch.SACCHL1(0, *ptdma.SACCH_C4[0], device="cpu")
    tx.open(0)
    tx.ordered_ms_power, tx.ordered_ms_timing = 21, 13
    tx.send_l2(ptr.L2Frame(np.zeros(184, np.uint8)))
    pair = both("SACCHL1", 0, mapping=("SACCH_C4", 0))
    for ch in pair:
        ch.open(0)
    fn, rx = 0, []
    for b in tx.tx_queue:  # the downlink block on the uplink's frames
        fn = pair[0].uplink.next_write_time(fn)
        rx.append((np.asarray(b.bits, np.float32), fn, -50.0, 0.0))
        fn += 1
    feed(pair, rx, 0)
    for ch in pair:
        assert (ch.actual_ms_power, ch.actual_ms_timing) == \
            (39 - 2 * ((39 - 21) // 2), 13)


# ---- RACH, SCH, FCCH --------------------------------------------------------

@pytest.mark.parametrize("bsic", [2, 63])
def test_rach_decode_and_handler_calls_equal(bsic):
    rng = np.random.default_rng(bsic)
    calls = ([], [])
    pair = (jch.RACHL1(0, bsic, lambda ra, t, r, te: calls[0].append(
                (ra, t.fn, t.tn, r, te))),
            pch.RACHL1(0, bsic, lambda ra, t, r, te: calls[1].append(
                (ra, t.fn, t.tn, r, te)), device="cpu"))
    rx = []
    for k in range(5):
        ra = int(rng.integers(0, 256))
        color = bsic if k % 4 else (bsic + 1) % 64  # the first: wrong BSIC
        coded = np.asarray(jl1.rach_encode(np.asarray([ra]),
                                           np.asarray(color)))[0]
        soft = np.full(148, 0.5, np.float32)
        soft[jl1.RACH_DATA_START: jl1.RACH_DATA_START + 36] = noisy(
            coded, rng, 0.45 if k == 3 else 0.0)
        rx.append((soft, HF - 4 + k, -float(k), 0.25 * k))
    feed(pair, rx, 0)
    assert calls[1] == calls[0]
    assert counters(pair[1]) == counters(pair[0])
    assert len(calls[0]) >= 2 and pair[0].bad_frames >= 1


@pytest.mark.parametrize("fn0", [0, 51 * 26 - 10, HF - 51])
@pytest.mark.parametrize("bsic", [2, 45])
def test_sch_and_fcch_over_a_multiframe(fn0, bsic):
    pairs = (both("SCHL1", bsic), both("FCCHL1"))
    for j, p in pairs:
        jb, pb = [], []
        for fn in range(fn0, fn0 + 51):
            fn %= HF
            jb.append(j.generate(fn))
            pb.append(p.generate(fn))
        assert [b is None for b in pb] == [b is None for b in jb]
        assert bursts([b for b in pb if b]) == bursts([b for b in jb if b])
        assert sum(b is not None for b in jb) == 5


# ---- TCH/FS + FACCH ---------------------------------------------------------

def l2_bits(rng):
    bits = rng.integers(0, 2, 184).astype(np.uint8)
    bits[:8] = [0, 0, 0, 0, 0, 0, 1, 1]
    return bits


@pytest.mark.parametrize("tsc", [None, 2])
@pytest.mark.parametrize("script", ["SFSS_F", "FF_SS_", "S_S_SF"])
def test_tch_dispatch_block_equal(tsc, script):
    """dispatch_block over both diagonal offsets: S a speech frame, F a
    FACCH frame, _ the silence filler; a resync at the clock jump."""
    rng = np.random.default_rng(len(script) + (tsc or 0))
    pair = both("TCHFACCHL1", 3, mapping=("FACCH_TCHF", None), tsc=tsc)
    for ch in pair:
        ch.open(0)
    for k, op in enumerate(script * 2):
        if op == "S":
            payload = rng.integers(0, 2, 260).astype(np.uint8)
            pair[0].send_tch(payload)
            pair[1].send_tch(payload)
        elif op == "F":
            bits = l2_bits(rng)
            pair[0].send_l2(jtr.L2Frame(bits))
            pair[1].send_l2(ptr.L2Frame(bits))
        if k == len(script):  # the clock jumped ahead: resync
            for ch in pair:
                ch.resync(ch.next_write_fn + 200)
        for ch in pair:
            ch.dispatch_block()
        assert pair[1]._offset == pair[0]._offset
        np.testing.assert_array_equal(pair[1]._itx, pair[0]._itx)
    assert bursts(pair[1].tx_queue) == bursts(pair[0].tx_queue)


def facch_u_by_hand(bits):
    """The FACCH coded block as the JAX encoder builds it (channels.py:
    parity_word → conv_encode), for the port's helper."""
    from openbts_ttsou_tpu.gsm import fec as jfec

    b = np.asarray(jl1.lsb8msb(bits))
    p = np.asarray(jfec.parity_word(b[None], jfec.FIRECODE_XCCH))
    u = np.concatenate([b[None], p, np.zeros((1, 4), np.uint8)], -1)
    return np.asarray(jfec.conv_encode(u))[0]


def test_facch_coded_block_equal():
    rng = np.random.default_rng(11)
    for _ in range(4):
        bits = l2_bits(rng)
        got = pch.facch_encode(pch._lsb8msb(bits), torch.device("cpu"))
        np.testing.assert_array_equal(got, facch_u_by_hand(bits))


def tch_uplink(rng, script, sigma_at=None):
    """An MS's TCH/FACCH burst stream from the JAX encoder for `script`
    (S speech, F FACCH, _ filler), soft, with noise on the blocks listed
    in sigma_at {block index: σ}."""
    ms = jch.TCHFACCHL1(2, jtdma.FACCH_TCHF, jtdma.FACCH_TCHF, tsc=2)
    ms.open(0)
    for op in script:
        if op == "S":
            ms.send_tch(rng.integers(0, 2, 260).astype(np.uint8))
        elif op == "F":
            ms.send_l2(jtr.L2Frame(l2_bits(rng)))
        ms.dispatch_block()
    out = []
    for k, b in enumerate(ms.tx_queue):
        sigma = (sigma_at or {}).get(k // 4, 0.0)
        out.append((noisy(b.bits, rng, sigma), b.fn, -55.0 - k, 0.125 * k))
    return out


@pytest.mark.parametrize("script,sigma_at", [
    ("SFS_F_", None),
    ("FSSF_", {1: 0.4, 3: 0.36}),
])
@pytest.mark.parametrize("skip", [0, 4])
def test_tch_write_low_side_equal(script, sigma_at, skip):
    """Speech payloads, FACCH frames and bad frames out of the decoder,
    fed from an 8-burst boundary (skip 0) and from the half-block after
    it (skip 4), so both diagonal offsets decode first."""
    rng = np.random.default_rng(len(script) * 10 + skip)
    rx = tch_uplink(rng, script, sigma_at)[skip:]
    pair = both("TCHFACCHL1", 2, mapping=("FACCH_TCHF", None), tsc=2)
    ups = (Upstream(), Upstream())
    for ch, up in zip(pair, ups):
        ch.open(0)
        ch.upstream = up
    feed(pair, rx, 2)
    jsp = [np.asarray(x, np.uint8).tobytes() for x in pair[0].speech_out]
    psp = [np.asarray(x, np.uint8).tobytes() for x in pair[1].speech_out]
    assert psp == jsp
    assert ups[1].frames == ups[0].frames
    assert counters(pair[1]) == counters(pair[0])
    np.testing.assert_array_equal(pair[1]._iframe, pair[0]._iframe)
    if sigma_at is None and not skip:
        assert len(jsp) == script.count("S")
        assert len(ups[0].frames) == script.count("F")


def test_tch_stealing_flag_picks_the_decoder():
    """`soft[60] > 0.5` decides FACCH or speech on both sides: a speech
    stream with its Hl flags forced to 0.51 is read as FACCH (and fails
    the FIRE check), at 0.5 as speech."""
    rng = np.random.default_rng(5)
    rx = tch_uplink(rng, "SS_")
    for flag, want_speech in ((0.51, False), (0.5, True)):
        pair = both("TCHFACCHL1", 2, mapping=("FACCH_TCHF", None), tsc=2)
        for ch in pair:
            ch.open(0)
        forced = []
        for soft, fn, r, te in rx:
            soft = soft.copy()
            soft[60] = flag
            forced.append((soft, fn, r, te))
        feed(pair, forced, 2)
        assert counters(pair[1]) == counters(pair[0])
        assert (len(pair[1].speech_out) > 0) == want_speech
        assert len(pair[1].speech_out) == len(pair[0].speech_out)


# ---- the logical channel: L1 + SAPMux + LAPDm -------------------------------

def test_logical_channel_with_lapdm_equal():
    """An SDCCH/4 with its SACCH in both packages: an MS's SABM carrying an
    L3 message comes up through FEC and LAPDm, the UA, an I-frame of L3
    data and a SACCH fill go down; every burst and every frame delivered
    is compared."""
    rng = np.random.default_rng(17)
    (jdl, jul), (pdl, pul) = jtdma.SDCCH_4[1], ptdma.SDCCH_4[1]
    (jsdl, jsul), (psdl, psul) = jtdma.SACCH_C4[1], ptdma.SACCH_C4[1]
    jl = jch.LogicalChannel(jch.XCCHL1(0, jdl, jul, tsc=2), sapis=(0, 3),
                            sacch=jch.SACCHL1(0, jsdl, jsul, tsc=2))
    pl = pch.LogicalChannel(
        pch.XCCHL1(0, pdl, pul, tsc=2, device="cpu"), sapis=(0, 3),
        sacch=pch.SACCHL1(0, psdl, psul, tsc=2, device="cpu"))
    fn_now = [0]
    for ch in (jl, pl):
        ch.l1.clock = ch.sacch.clock = lambda: fn_now[0]
        ch.open(0)
    ms = jlapdm.L2LAPDm(c=0, sapi=0)
    payload = rng.integers(0, 2, 80).astype(np.uint8)
    ms._send_u(jtr.FrameType.SABM, True, ms.c, payload)
    fn = 0
    for frame in ms.take_l1_out():
        coded = np.asarray(jl1.xcch_encode(
            np.asarray(jl1.lsb8msb(frame.bits))[None], tsc=2))[0]
        rx = []
        for b in coded:
            fn = jul.next_write_time(fn)
            rx.append((b.astype(np.float32), fn, -60.0, 0.5))
            fn += 1
        fn_now[0] = fn
        feed((jl, pl), rx, 0)
    jr, pr = jl.recv(), pl.recv()
    assert pr.primitive.name == jr.primitive.name
    np.testing.assert_array_equal(pr.bits, jr.bits)
    data = rng.integers(0, 2, 120).astype(np.uint8)
    jl.send(jtr.L3Frame(data, jtr.Primitive.DATA))
    pl.send(ptr.L3Frame(data, ptr.Primitive.DATA))
    fill = rng.integers(0, 2, 144).astype(np.uint8)
    jl.send_sacch(jtr.L3Frame(fill, jtr.Primitive.UNIT_DATA), fill=True)
    pl.send_sacch(ptr.L3Frame(fill, ptr.Primitive.UNIT_DATA), fill=True)
    for _ in range(30):  # T200 on the frame clock: retransmissions too
        fn_now[0] += 20
        jl.pump()
        pl.pump()
    assert bursts(pl.l1.tx_queue) == bursts(jl.l1.tx_queue)
    assert bursts(pl.sacch.tx_queue) == bursts(jl.sacch.tx_queue)
    assert len(jl.l1.tx_queue) >= 8 and len(jl.sacch.tx_queue) == 4
    assert (pl.tx_depth(), pl.tx_drained()) == (jl.tx_depth(),
                                                jl.tx_drained())
    assert pl.l2[0].state.name == jl.l2[0].state.name
