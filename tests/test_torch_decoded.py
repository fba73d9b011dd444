"""The PyTorch port's resident layer 1 against the JAX package, on the CPU.

The same numpy inputs, made from seeds, go through both packages:
`decode_block` on one RxResult at all 26 phases (with and without the
streaming prelude, with the static slot split), the encode leg
`_encode_dl_window` (legacy and streaming layouts), `downlink_block_
encoded`, `downlink_block_tch`, and `duplex_block_decoded` through
`ResidentL1` on 2 windows, with the carry crossing between the packages
through `convert.py` both ways. Port-only: the resident loopback over 6
windows (all four XCCH phases; every frame sent decoded exactly once),
`uplink_block_decoded(_stream)`, ResidentL1 against manual threading
with a checkpoint round trip, and `xcch_group_slots`.

Tolerances, port against JAX:
- DecodedBlocks, coded burst bits, valid planes, carries and the
  TrxState's integer and bool fields: exact;
- float tx: within 2e-4 of the peak (tests/test_torch_duplex.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from openbts_ttsou_tpu.gsm import l1fec as jl1
from openbts_ttsou_tpu.models import resident as jres
from openbts_ttsou_tpu.models import transceiver as jtrx
from openbts_ttsou_tpu.trx import engine as jeng
from openbts_ttsou_tpu_torch import convert
from openbts_ttsou_tpu_torch.gsm import l1fec as tl1
from openbts_ttsou_tpu_torch.gsm.tdma import FACCH_TCHF
from openbts_ttsou_tpu_torch.models import ResidentL1
from openbts_ttsou_tpu_torch.models import transceiver as ttrx
from openbts_ttsou_tpu_torch.trx import engine as teng

torch.set_num_threads(1)

SPEC = jtrx.UplinkSpec()
TSPEC = ttrx.UplinkSpec()
F = SPEC.frames
B_IN = SPEC.block_in
HALO = jtrx.RX_HALO_DEV
# the bench's duplex_decoded split (bench.py:290,326)
XT, TT = (0, 1, 6, 7), (2, 3, 4, 5)
TCH_SLOT, XCCH_SLOT = 2, 6


def t(x) -> torch.Tensor:
    """A writable copy as a tensor (JAX hands out read-only arrays)."""
    return torch.from_numpy(np.array(x))


def tcfg(cfg):
    return teng.TrxConfig(**cfg._asdict())


def eq(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (what, got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


def eq_blocks(tb, jb, what):
    for name in jtrx.DecodedBlocks._fields:
        eq(getattr(tb, name), getattr(jb, name), f"{what}: {name}")


def close_tx(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, atol=2e-4 * np.abs(want).max(),
                               err_msg=what)


def eq_state_ints(tst, jst, what):
    tn = convert.state_to_numpy(tst)
    for name in jst._fields:
        b = np.asarray(getattr(jst, name))
        if b.dtype == bool or np.issubdtype(b.dtype, np.integer):
            eq(tn[name], b, f"{what}: state {name}")


def first_tch_start():
    """The first FN ≡ 0 mod 4 where the TCH/F multiframe starts a
    diagonal (reverse map 0)."""
    fn = int(np.where(FACCH_TCHF.reverse_map() == 0)[0][0])
    while fn % 4:
        fn += 26
    return fn


def window_content(rng, c, off, full=False):
    """One window of downlink content, numpy: speech or FACCH on the TCH
    slot's 3 dispatches, L2 frames on the XCCH slot at the group starts
    inside the window (or, with `full`, everything random and valid on
    every slot). Returns (content 7-tuple, sent)."""
    tch_mask = np.zeros((c, 8), bool)
    tch_mask[:, list(TT) if full else [TCH_SLOT]] = True
    sp = np.zeros((3, c, 8, 260), np.uint8)
    spv = np.zeros((3, c, 8), bool)
    fa = np.zeros((3, c, 8, 184), np.uint8)
    fav = np.zeros((3, c, 8), bool)
    x = np.zeros((4, c, 8, 184), np.uint8)
    xv = np.zeros((4, c, 8), bool)
    sent = {"s": [], "f": [], "x": []}
    if full:
        sp[:] = rng.integers(0, 2, sp.shape)
        spv[:] = True
        fa[:] = rng.integers(0, 2, fa.shape)
        fav[:] = rng.random(fav.shape) < 0.4
        x[:] = rng.integers(0, 2, x.shape)
        xv[:] = True
        return (x, xv, sp, spv, fa, fav, tch_mask), sent
    for ch in range(c):
        for j in range(3):
            if rng.random() < 0.4:
                fa[j, ch, TCH_SLOT] = rng.integers(0, 2, 184)
                fav[j, ch, TCH_SLOT] = True
                sent["f"].append((ch, fa[j, ch, TCH_SLOT].copy()))
            else:
                sp[j, ch, TCH_SLOT] = rng.integers(0, 2, 260)
                spv[j, ch, TCH_SLOT] = True
                sent["s"].append((ch, sp[j, ch, TCH_SLOT].copy()))
        for g in range((12 - off) // 4 + 1):  # starts inside the window
            x[g, ch, XCCH_SLOT] = rng.integers(0, 2, 184)
            xv[g, ch, XCCH_SLOT] = True
            sent["x"].append((ch, x[g, ch, XCCH_SLOT].copy()))
    return (x, xv, sp, spv, fa, fav, tch_mask), sent


def collect(blocks, c):
    """Decoded frames of one window: [(kind, carrier, bits, end fn)]."""
    out = []
    tg, fo = blocks.tch_good.numpy(), blocks.facch_ok.numpy()
    ef = blocks.tch_end_fn.numpy()
    ok = blocks.ok.numpy()
    for ch in range(c):
        for gi in range(tg.shape[0]):
            if tg[gi, ch, TCH_SLOT]:
                out.append(("s", ch, blocks.tch_speech[gi, ch, TCH_SLOT]
                            .numpy(), int(ef[gi])))
            if fo[gi, ch, TCH_SLOT]:
                out.append(("f", ch, blocks.facch_bits[gi, ch, TCH_SLOT]
                            .numpy(), int(ef[gi])))
        for gi in np.flatnonzero(ok[:, ch, XCCH_SLOT]):
            out.append(("x", ch, blocks.bits[gi, ch, XCCH_SLOT].numpy(),
                        int(blocks.first_fn) + 4 * gi))
    return out


def check_each_once(got, sent):
    """Every sent frame decoded exactly once, nothing else decoded."""
    keys = [(k, ch, fn) for k, ch, _, fn in got]
    assert len(keys) == len(set(keys)), "a group decoded twice"
    n_sent = sum(len(v) for v in sent.values())
    assert len(got) == n_sent, (len(got), n_sent)
    for kind, frames in sent.items():
        for ch, bits in frames:
            assert any(k == kind and c == ch and np.array_equal(b, bits)
                       for k, c, b, _ in got), f"{kind} frame lost"


# ---- decode_block -----------------------------------------------------------

DEC_C = 2
DEC_FN = 1004  # the window's first FN; its prelude starts at 996


@pytest.fixture(scope="module")
def dec_stream():
    """21 frames of soft bits [21, DEC_C, 8, 148]: the port's encode leg
    on 2 consecutive windows (TCH/FACCH on TT, XCCH on XT, everything
    valid), sliced to the last 21 frames, as soft bits 0.1/0.9 with
    Gaussian noise σ 0.1 and a few erased bursts; with random detection
    and RACH flags."""
    rng = np.random.default_rng(21)
    cfg = teng.TrxConfig(n_chan=DEC_C)
    st = teng.init_state(cfg, "cpu")
    fn_a = DEC_FN - F  # windows [DEC_FN − 13, DEC_FN) and [DEC_FN, +13)
    carry = (tl1.TchTxCarry.zeros(DEC_C * 8, "cpu"),
             ttrx.XcchTxCarry.zeros(DEC_C, "cpu"))
    bits = []
    for w in range(2):
        fnw = fn_a + F * w
        content, _ = window_content(rng, DEC_C, (-fnw) % 4, full=True)
        b, _, tc, xc = ttrx._encode_dl_window(
            cfg, TSPEC, st, *map(t, content), carry[0],
            torch.tensor(fnw, dtype=torch.int32), xcch_phase=fnw % 4,
            xcch_carry=carry[1])
        carry = (tc, xc)
        bits.append(b.numpy())
    bits = np.concatenate(bits)[-(F + ttrx.DECODE_PRELUDE):]
    soft = np.where(bits > 0, 0.9, 0.1) + rng.normal(0, 0.1, bits.shape)
    soft = np.clip(soft, 0, 1).astype(np.float32)
    soft[rng.random(soft.shape[:3]) < 0.03] = 0.5
    shape = (F, DEC_C, 8)
    return {"soft": soft, "detected": rng.random(shape) < 0.9,
            "is_rach": rng.random(shape) < 0.3,
            "rssi": rng.integers(-100, 0, shape).astype(np.int32),
            "timing": rng.integers(-500, 500, shape).astype(np.int32)}


DEC_VARIANTS = {"plain": dict(prelude=False, xcch_tns=None, tch_tns=None,
                              rach_tns=None),
                "prelude": dict(prelude=True, xcch_tns=None, tch_tns=None,
                                rach_tns=None),
                "prelude_split": dict(prelude=True, xcch_tns=XT, tch_tns=TT,
                                      rach_tns=(0,))}


@pytest.mark.parametrize("variant", sorted(DEC_VARIANTS))
def test_decode_block_matches_jax_all_phases(dec_stream, variant):
    """fn0 at all 26 phases of the TCH multiframe (and so all four FN%4
    phases), the prelude's carry valid at even phases and not at odd;
    every DecodedBlocks field exact. At the stream's own phase the groups
    decode: the check that the comparison is not of garbage alone."""
    v = DEC_VARIANTS[variant]
    s = dec_stream
    p = ttrx.DECODE_PRELUDE if v["prelude"] else 0
    soft = s["soft"][ttrx.DECODE_PRELUDE - p:]
    win = soft[p:]
    jres_ = jeng.RxResult(s["detected"], s["is_rach"], win, s["rssi"],
                          s["timing"])
    tres = teng.RxResult(t(s["detected"]), t(s["is_rach"]), t(win),
                         t(s["rssi"]), t(s["timing"]))
    statics = dict(xcch_tns=v["xcch_tns"], tch_tns=v["tch_tns"],
                   rach_tns=v["rach_tns"])
    jdec = jax.jit(jtrx.decode_block, static_argnums=(2, 3),
                   static_argnames=tuple(statics))
    n_ok = 0
    for k in range(26):
        fn0 = DEC_FN + k
        kw = dict(statics)
        if p:
            pv = k % 2 == 0
            kw_j = dict(kw, prev_soft=soft[:p], prev_valid=np.asarray(pv))
            kw_t = dict(kw, prev_soft=t(soft[:p]),
                        prev_valid=torch.tensor(pv))
        else:
            kw_j = kw_t = kw
        want = jdec(jres_, jnp.asarray(fn0, jnp.int32), F, 7, **kw_j)
        got = ttrx.decode_block(tres, torch.tensor(fn0, dtype=torch.int32),
                                F, 7, **kw_t)
        eq_blocks(got, want, f"{variant} phase {k}")
        if k == 0:
            n_ok = int(got.ok.sum() + got.tch_good.sum() + got.facch_ok.sum())
    assert n_ok >= 3 * DEC_C, n_ok


# ---- the encode leg and the encoding downlinks ------------------------------

ENC_C = 2


def _enc_inputs(seed, legacy):
    rng = np.random.default_rng(seed)
    g = 3 if legacy else 4
    x = rng.integers(0, 2, (g, ENC_C, 8, 184)).astype(np.uint8)
    xv = rng.random((g, ENC_C, 8)) < 0.8
    sp = rng.integers(0, 2, (3, ENC_C, 8, 260)).astype(np.uint8)
    spv = rng.random((3, ENC_C, 8)) < 0.8
    fa = rng.integers(0, 2, (3, ENC_C, 8, 184)).astype(np.uint8)
    fav = rng.random((3, ENC_C, 8)) < 0.3
    tch_mask = np.zeros((ENC_C, 8), bool)
    tch_mask[:, list(TT)] = rng.random((ENC_C, len(TT))) < 0.8
    atten = rng.uniform(0, 9, (F, ENC_C, 8)).astype(np.float32)
    return (x, xv, sp, spv, fa, fav, tch_mask), atten


def _enc_states():
    cfg = jeng.TrxConfig(n_chan=ENC_C)
    jst = jeng.init_state(cfg)._replace(tsc=jnp.asarray([3, 5], jnp.int32))
    return cfg, jst, convert.state_from_numpy(jst._asdict(), "cpu")


@pytest.mark.parametrize("layout", ["legacy", "streaming_split"])
def test_encode_dl_window_matches_jax(layout):
    """Legacy layout (all slots, fn0 FN%4-aligned) on one window; the
    streaming layout with the slot split on 2 windows (two XCCH phases),
    both carries threaded: bits (TSC stamped), valid planes and carries
    exact."""
    cfg, jst, tst = _enc_states()
    legacy = layout == "legacy"
    jcarry = jl1.TchTxCarry.zeros(ENC_C * 8)
    tcarry = tl1.TchTxCarry.zeros(ENC_C * 8, "cpu")
    jx, tx_ = jtrx.XcchTxCarry.zeros(ENC_C), ttrx.XcchTxCarry.zeros(ENC_C,
                                                                     "cpu")
    fn0 = 4 * 27 if legacy else 4 * 27 + 2
    for w in range(1 if legacy else 2):
        content, _ = _enc_inputs(w, legacy)
        fnw = fn0 + F * w
        kw = {} if legacy else dict(xcch_phase=fnw % 4, xcch_tns=XT,
                                    tch_tns=TT)
        jfn = jax.jit(lambda st, c, carry, xc, fn, kw=kw:
                      jtrx._encode_dl_window(cfg, SPEC, st, *c, carry, fn,
                                             xcch_carry=xc, **kw))
        jb, jv, jcarry, jx2 = jfn(jst, tuple(map(jnp.asarray, content)),
                                  jcarry, None if legacy else jx,
                                  jnp.asarray(fnw, jnp.int32))
        tb, tv, tcarry, tx2 = ttrx._encode_dl_window(
            tcfg(cfg), TSPEC, tst, *map(t, content), tcarry,
            torch.tensor(fnw, dtype=torch.int32),
            xcch_carry=None if legacy else tx_, **kw)
        eq(tb, jb, f"{layout} window {w} bits")
        eq(tv, jv, f"{layout} window {w} valid")
        for k, (a, b) in enumerate(zip(tcarry, jcarry)):
            eq(a, b, f"{layout} window {w} tch carry {k}")
        if legacy:
            assert tx2 is None and jx2 is None
        else:
            for k, (a, b) in enumerate(zip(tx2, jx2)):
                eq(a, b, f"{layout} window {w} xcch carry {k}")
            jx, tx_ = jx2, tx2


def test_downlink_block_encoded_matches_jax():
    cfg, jst, tst = _enc_states()
    rng = np.random.default_rng(5)
    x = rng.integers(0, 2, (3, ENC_C, 8, 184)).astype(np.uint8)
    xv = rng.random((3, ENC_C, 8)) < 0.7
    atten = rng.uniform(0, 9, (3, ENC_C, 8)).astype(np.float32)
    want = jtrx.downlink_block_encoded(cfg, SPEC, jst, jnp.asarray(x),
                                       jnp.asarray(xv), jnp.asarray(atten),
                                       jnp.asarray(104, jnp.int32))
    got = ttrx.downlink_block_encoded(tcfg(cfg), TSPEC, tst, t(x), t(xv),
                                      t(atten), torch.tensor(104))
    close_tx(got, want, "downlink_block_encoded")


def test_downlink_block_tch_matches_jax():
    """Two windows, the TCH carry threaded: tx within 2e-4 of the peak,
    the carry exact."""
    cfg, jst, tst = _enc_states()
    jcarry = jl1.TchTxCarry.zeros(ENC_C * 8)
    tcarry = tl1.TchTxCarry.zeros(ENC_C * 8, "cpu")
    for w in range(2):
        content, atten = _enc_inputs(10 + w, True)
        fnw = 4 * 27 + F * w
        want, jcarry = jtrx.downlink_block_tch(
            cfg, SPEC, jst, *map(jnp.asarray, content), jnp.asarray(atten),
            jcarry, jnp.asarray(fnw, jnp.int32))
        got, tcarry = ttrx.downlink_block_tch(
            tcfg(cfg), TSPEC, tst, *map(t, content), t(atten), tcarry,
            torch.tensor(fnw, dtype=torch.int32))
        close_tx(got, want, f"window {w}")
        for k, (a, b) in enumerate(zip(tcarry, jcarry)):
            eq(a, b, f"window {w} carry {k}")


# ---- the resident duplex: loopback, JAX parity, carries ---------------------

LOOP_WIN = 5
LOOP_C = 1


def loop_chan_types() -> np.ndarray:
    ct = np.zeros((LOOP_C, 8), np.int32)
    ct[:, [TCH_SLOT, XCCH_SLOT]] = jeng.ChanType.I
    return ct


@pytest.fixture(scope="module")
def loop():
    """The port-only resident loopback (tests/test_l1fec.py:415's): pass 1
    transmits speech, FACCH and L2 frames over LOOP_WIN windows (and one
    flush window) while the uplink is silent; the tx stream, scaled to
    amplitude 9000, is pass 2's uplink. Windows start at every FN%4
    phase. The bench's slot split."""
    rng = np.random.default_rng(31)
    cfg = teng.TrxConfig(n_chan=LOOP_C)
    fn0 = first_tch_start()
    ct = t(loop_chan_types())
    contents, sent = [], {"s": [], "f": [], "x": []}
    for w in range(LOOP_WIN + 1):
        fnw = fn0 + F * w
        if w < LOOP_WIN:
            c, s = window_content(rng, LOOP_C, (-fnw) % 4)
            for k in sent:
                sent[k] += s[k]
        else:  # the flush window carries nothing new
            c, _ = window_content(rng, LOOP_C, (-fnw) % 4)
            c = tuple(np.zeros_like(a) for a in c[:6]) + (c[6],)
        contents.append(c)

    def drive(uplink):
        r = ResidentL1(cfg, TSPEC, xcch_tns=XT, tch_tns=TT, fn0=fn0,
                       device="cpu")
        r.state = r.state._replace(chan_type=ct)
        out = []
        for w, c in enumerate(contents):
            out.append(r.step(uplink(w), c))
        return out

    silent = np.zeros((LOOP_C, B_IN + 2 * HALO), np.complex64)
    pass1 = drive(lambda w: silent)
    # tx covers device time TX_DELAY_DEV early; with RX_HALO_DEV ==
    # TX_DELAY_DEV the plain concatenation is the halo'd uplink stream
    air = np.concatenate([tx.numpy() / cfg.tx_full_scale * 9000.0
                          for tx, _ in pass1]
                         + [np.zeros((LOOP_C, 2 * HALO), np.complex64)], -1)
    windows = [np.ascontiguousarray(air[:, w * B_IN: (w + 1) * B_IN
                                        + 2 * HALO])
               for w in range(len(contents))]
    pass2 = drive(lambda w: windows[w])
    return {"cfg": cfg, "fn0": fn0, "contents": contents, "sent": sent,
            "windows": windows, "pass2": pass2, "ct": ct}


def test_resident_loopback_decodes_every_frame_once(loop):
    """Every speech, FACCH and XCCH frame sent is decoded exactly once,
    bit-exact, with its ok/tch_good/facch_ok flag, across windows at all
    four FN%4 phases."""
    assert {(loop["fn0"] + F * w) % 4 for w in range(LOOP_WIN)} == \
        {0, 1, 2, 3}
    got = [g for _, blocks in loop["pass2"] for g in collect(blocks, LOOP_C)]
    check_each_once(got, loop["sent"])
    assert all(loop["sent"].values())


def test_uplink_block_decoded_matches_decode_block(loop):
    """uplink_block_decoded(_stream) on the loopback's air (the windows
    without their halos, so the resampler's edges differ from the duplex
    block's): the same frames decode, and the stream form equals
    uplink_block + decode_block with the prelude carried."""
    cfg, fn0 = loop["cfg"], loop["fn0"]
    st = teng.init_state(cfg, "cpu")._replace(chan_type=loop["ct"])
    st_ref = st
    prev = torch.zeros((ttrx.DECODE_PRELUDE, LOOP_C, 8, 148))
    pv = torch.tensor(False)
    got = []
    for w, win in enumerate(loop["windows"]):
        x = t(win[:, HALO: HALO + B_IN])
        fnw = torch.tensor(fn0 + F * w, dtype=torch.int32)
        st = st._replace(fn=fnw)
        st_in = st_ref._replace(fn=fnw)
        st, res, blocks, prev2, pv2 = ttrx.uplink_block_decoded_stream(
            cfg, TSPEC, st, x, 0, prev, pv, XT, TT)
        st_ref, res_ref = ttrx.uplink_block(cfg, TSPEC, st_in, x)
        want = ttrx.decode_block(res_ref, fnw, F, 0, prev_soft=prev,
                                 prev_valid=pv, xcch_tns=XT, tch_tns=TT)
        for name in ttrx.DecodedBlocks._fields:
            assert torch.equal(getattr(blocks, name), getattr(want, name))
        assert torch.equal(prev2, res.soft_bits[-ttrx.DECODE_PRELUDE:])
        assert bool(pv2)
        prev, pv = prev2, pv2
        got += collect(blocks, LOOP_C)
        if w == 1:  # the one-shot form: decode_block with no prelude
            _, _, one = ttrx.uplink_block_decoded(cfg, TSPEC, st_in, x, 0,
                                                  XT, TT)
            plain = ttrx.decode_block(res_ref, fnw, F, 0, xcch_tns=XT,
                                      tch_tns=TT)
            for name in ttrx.DecodedBlocks._fields:
                assert torch.equal(getattr(one, name), getattr(plain, name))
    check_each_once(got, loop["sent"])


@pytest.fixture(scope="module")
def jax_resident(loop):
    """JAX's ResidentL1 on the loopback's first 2 pass-2 windows (two XCCH
    phases) with noise σ 30 added, and its carry after window 0."""
    cfg = jeng.TrxConfig(n_chan=LOOP_C)
    rng = np.random.default_rng(8)
    uls = [(w + (rng.standard_normal(w.shape)
                 + 1j * rng.standard_normal(w.shape)) * 30.0
            ).astype(np.complex64) for w in loop["windows"][:2]]
    st = jeng.init_state(cfg)._replace(
        chan_type=jnp.asarray(loop_chan_types()))
    r = jres.ResidentL1(cfg, SPEC, xcch_tns=XT, tch_tns=TT, state=st,
                        fn0=loop["fn0"])
    outs, carries = [], []
    for w in range(2):
        carries.append(convert.resident_carry_to_numpy(r.carry()))
        tx, blocks = r.step(jnp.asarray(uls[w]),
                            tuple(map(jnp.asarray, loop["contents"][w])))
        outs.append((np.asarray(tx), blocks, r.state))
    return {"uls": uls, "outs": outs, "carries": carries, "resident": r}


def test_duplex_block_decoded_matches_jax(loop, jax_resident):
    """duplex_block_decoded through ResidentL1 on 2 windows, noise plus
    content: DecodedBlocks and integer state exact, tx within 2e-4 of the
    peak, and the frames decode."""
    j = jax_resident
    r = ResidentL1(loop["cfg"], TSPEC, xcch_tns=XT, tch_tns=TT,
                   fn0=loop["fn0"], device="cpu")
    r.state = r.state._replace(chan_type=loop["ct"])
    n_dec = 0
    for w in range(2):
        tx, blocks = r.step(j["uls"][w], loop["contents"][w])
        jtx, jblocks, jst = j["outs"][w]
        eq_blocks(blocks, jblocks, f"window {w}")
        close_tx(tx, jtx, f"window {w} tx")
        eq_state_ints(r.state, jst, f"window {w}")
        n_dec += len(collect(blocks, LOOP_C))
    assert n_dec >= 4


def jax_carry(d):
    """The JAX package's ResidentL1 carry from resident_carry_to_numpy's
    dict."""
    def a(name):
        return jnp.asarray(d[name])

    return {"state": jeng.TrxState(**{k: a(f"state.{k}")
                                      for k in jeng.TrxState._fields}),
            "fn": int(d["fn"]), "tx_tail": a("tx_tail"),
            "tx_carry": (tuple(a(n) for n, _ in convert.TCH_CARRY_FIELDS),
                         tuple(a(n) for n, _ in convert.XCCH_CARRY_FIELDS)),
            "prev_soft": a("prev_soft"), "prev_valid": a("prev_valid")}


def test_resident_carry_crosses_between_packages(loop, jax_resident):
    """JAX's carry after window 0, restored into the port through
    convert.py, gives JAX's window-1 decodes; the port's carry after
    window 0, restored into JAX, gives the port's."""
    j = jax_resident
    d = j["carries"][1]  # JAX's carry after window 0
    r = ResidentL1(loop["cfg"], TSPEC, xcch_tns=XT, tch_tns=TT, fn0=0,
                   device="cpu")
    r.restore(convert.resident_carry_from_numpy(d, "cpu"))
    assert r.fn == loop["fn0"] + F
    tx, blocks = r.step(j["uls"][1], loop["contents"][1])
    jtx, jblocks, _ = j["outs"][1]
    eq_blocks(blocks, jblocks, "JAX carry → port")
    close_tx(tx, jtx, "JAX carry → port tx")

    # the other way: the port's own run from the start, its carry into JAX
    p = ResidentL1(loop["cfg"], TSPEC, xcch_tns=XT, tch_tns=TT,
                   fn0=loop["fn0"], device="cpu")
    p.state = p.state._replace(chan_type=loop["ct"])
    p.step(j["uls"][0], loop["contents"][0])
    d_port = convert.resident_carry_to_numpy(p.carry())
    for name, a in d_port.items():  # the two packages' carries agree
        b = d[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=name)
    jr = j["resident"]
    jr.restore(jax_carry(d_port))
    jtx2, jblocks2 = jr.step(jnp.asarray(j["uls"][1]),
                             tuple(map(jnp.asarray, loop["contents"][1])))
    tx2, blocks2 = p.step(j["uls"][1], loop["contents"][1])
    eq_blocks(blocks2, jblocks2, "port carry → JAX")
    close_tx(tx2, jtx2, "port carry → JAX tx")


def test_resident_l1_matches_manual_threading():
    """ResidentL1 (all slots, no split) against hand-threading the five
    carries and the FN%4 phase through duplex_block_decoded, with a
    carry()/restore() round trip mid-stream through numpy (convert.py)."""
    rng = np.random.default_rng(17)
    c = 1
    cfg = teng.TrxConfig(n_chan=c)
    fn0 = 52
    n_win = 3
    tch_mask = np.zeros((c, 8), bool)
    tch_mask[0, 3] = True
    contents = []
    for _ in range(n_win):
        contents.append(tuple(map(t, (
            rng.integers(0, 2, (4, c, 8, 184)).astype(np.uint8),
            np.ones((4, c, 8), bool),
            rng.integers(0, 2, (3, c, 8, 260)).astype(np.uint8),
            np.ones((3, c, 8), bool), np.zeros((3, c, 8, 184), np.uint8),
            np.zeros((3, c, 8), bool), tch_mask))))
    shape = (c, B_IN + 2 * HALO)
    uls = [t(((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
              * 50.0).astype(np.complex64)) for _ in range(n_win)]
    atten = torch.zeros((F, c, 8))

    st = teng.init_state(cfg, "cpu")
    tail = torch.zeros((c, ttrx.TX_TAIL_SYM), dtype=torch.complex64)
    tc = (tl1.TchTxCarry.zeros(c * 8, "cpu"), ttrx.XcchTxCarry.zeros(c,
                                                                     "cpu"))
    prev = torch.zeros((ttrx.DECODE_PRELUDE, c, 8, 148))
    pv = torch.tensor(False)
    manual = []
    for w in range(n_win):
        fnw = torch.tensor(fn0 + F * w, dtype=torch.int32)
        st = st._replace(fn=fnw)
        st, tx, tail, blocks, tc, prev, pv = ttrx.duplex_block_decoded(
            cfg, TSPEC, st, uls[w], tail, contents[w], atten, tc, fnw,
            prev, pv, 0, (fn0 + F * w) % 4)
        manual.append((tx, blocks))

    r = ResidentL1(cfg, TSPEC, fn0=fn0, device="cpu")
    got = []
    for w in range(n_win):
        if w == 2:  # save/restore mid-stream, through numpy
            snap = convert.resident_carry_to_numpy(r.carry())
            r = ResidentL1(cfg, TSPEC, fn0=0, device="cpu")
            r.restore(convert.resident_carry_from_numpy(snap, "cpu"))
        got.append(r.step(uls[w], contents[w]))
    for (tx_m, bl_m), (tx_w, bl_w) in zip(manual, got):
        assert torch.equal(tx_m, tx_w)
        for name in ttrx.DecodedBlocks._fields:
            assert torch.equal(getattr(bl_m, name), getattr(bl_w, name))
    assert r.fn == fn0 + F * n_win


def test_resident_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this box has a card; the default runs there")
    with pytest.raises(RuntimeError):
        ResidentL1(teng.TrxConfig(n_chan=1))
    with pytest.raises(RuntimeError):
        convert.resident_carry_from_numpy({}, "cuda")


# ---- xcch_group_slots -------------------------------------------------------

def test_xcch_group_slots_each_frame_decoded_once():
    """Fill every group start a window's slot list names, over 8 windows
    of the streaming encode leg (all four FN%4 phases), and decode the
    coded bits with the streaming decoder: with the port's list every
    frame decodes exactly once. With the JAX package's list, which also
    names starts at or past the window's end (up to frames + 2), exactly
    the frames put at those starts are lost (ROADMAP Queue 3)."""
    cfg = teng.TrxConfig(n_chan=1)
    st = teng.init_state(cfg, "cpu")
    fn0 = 1000
    jr = jres.ResidentL1(jeng.TrxConfig(n_chan=1), SPEC, fn0=fn0)
    tr = ResidentL1(cfg, TSPEC, fn0=fn0, device="cpu")
    # no TCH content: the idle window's TCH arrays and mask, which equal
    # the JAX package's
    idle = tr.empty_content(np.zeros((1, 8), bool))
    for a, b in zip(idle, jr.empty_content(np.zeros((1, 8), bool))):
        eq(a, b)
    results = {}
    for name, slots_of in (("port", tr.xcch_group_slots),
                           ("jax", jr.xcch_group_slots)):
        rng = np.random.default_rng(3)
        carry = (tl1.TchTxCarry.zeros(8, "cpu"),
                 ttrx.XcchTxCarry.zeros(1, "cpu"))
        prev = torch.zeros((ttrx.DECODE_PRELUDE, 1, 8, 148))
        pv = torch.tensor(False)
        sent, lost_at_edge, got = [], [], []
        for w in range(9):  # 8 windows of content, one to flush
            fnw = fn0 + F * w
            jr.fn = tr.fn = fnw
            off = (-fnw) % 4
            x = np.zeros((4, 1, 8, 184), np.uint8)
            xv = np.zeros((4, 1, 8), bool)
            if w < 8:
                for start in slots_of():
                    g = (start - off) // 4
                    x[g, 0, XCCH_SLOT] = rng.integers(0, 2, 184)
                    xv[g, 0, XCCH_SLOT] = True
                    sent.append(("x", 0, x[g, 0, XCCH_SLOT].copy()))
                    if start >= F:
                        lost_at_edge.append(x[g, 0, XCCH_SLOT].copy())
            bits, valid, tc, xc = ttrx._encode_dl_window(
                cfg, TSPEC, st, t(x), t(xv), *idle[2:], carry[0],
                torch.tensor(fnw), xcch_phase=fnw % 4, xcch_carry=carry[1])
            carry = (tc, xc)
            # bursts with no content go out as filler: erased here
            soft = torch.where(valid[..., None],
                               torch.where(bits > 0, 0.9, 0.1), 0.5
                               ).to(torch.float32)
            shape = (F, 1, 8)
            res = teng.RxResult(torch.ones(shape, dtype=torch.bool),
                                torch.zeros(shape, dtype=torch.bool), soft,
                                torch.zeros(shape, dtype=torch.int32),
                                torch.zeros(shape, dtype=torch.int32))
            blocks = ttrx.decode_block(res, torch.tensor(fnw), F,
                                       prev_soft=prev, prev_valid=pv)
            prev, pv = soft[-ttrx.DECODE_PRELUDE:], torch.tensor(True)
            got += [g for g in collect(blocks, 1) if g[0] == "x"]
        results[name] = (sent, lost_at_edge, got)

    sent, lost, got = results["port"]
    assert not lost and len(sent) == 26
    check_each_once(got, {"x": [(0, b) for _, _, b in sent]})
    sent, lost, got = results["jax"]
    assert len(lost) == 6  # starts 13, 14 and 15 in 8 windows
    kept = [(0, b) for _, _, b in sent
            if not any(np.array_equal(b, m) for m in lost)]
    check_each_once(got, {"x": kept})
