"""The PyTorch port's FEC (`gsm/fec.py`, `gsm/l1fec.py`, `gsm/tdma.py`)
against the JAX package, on the CPU.

The same numpy inputs, made from seeds, go through both packages. Every
comparison is exact: CRC/Fire parity, syndromes, convolutional code,
Viterbi, interleave and burst maps, every L1 codec and the windowed TCH
downlink encoder are integer functions of their inputs (the Viterbi
costs are float32, computed with the same operations in the same order,
so its decisions agree bit for bit). The JAX references are computed
once per module.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from openbts_ttsou_tpu.gsm import fec as jfec
from openbts_ttsou_tpu.gsm import l1fec as jl1
from openbts_ttsou_tpu.gsm import tdma as jtdma
from openbts_ttsou_tpu_torch.gsm import fec as tfec
from openbts_ttsou_tpu_torch.gsm import l1fec as tl1
from openbts_ttsou_tpu_torch.gsm import tdma as ttdma

torch.set_num_threads(1)

SPECS = {"firecode_xcch": "FIRECODE_XCCH", "rach": "PARITY_RACH",
         "sch": "PARITY_SCH", "tch": "PARITY_TCH"}


def t(x) -> torch.Tensor:
    """A writable copy as a tensor (JAX hands out read-only arrays)."""
    return torch.from_numpy(np.array(x))


def eq(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


# ---- tdma -----------------------------------------------------------------

def _mappings(mod):
    out = {"FCCH": mod.FCCH, "SCH": mod.SCH, "BCCH": mod.BCCH,
           "RACH_C5": mod.RACH_C5, "FACCH_TCHF": mod.FACCH_TCHF,
           "LOOPBACK_TEST_FULL": mod.LOOPBACK_TEST_FULL}
    for i, m in enumerate(mod.CCCH):
        out[f"CCCH{i}"] = m
    for name in ("SDCCH_4", "SACCH_C4", "SDCCH_8", "SACCH_C8"):
        for i, (dl, ul) in enumerate(getattr(mod, name)):
            out[f"{name}_{i}_dl"], out[f"{name}_{i}_ul"] = dl, ul
    for tn, m in enumerate(mod.SACCH_TF):
        out[f"SACCH_TF{tn}"] = m
    return out


def test_tdma_copy_matches_jax():
    """Every mapping row of the port's copy equals the JAX one, and so do
    the reverse maps and the encoder pacing."""
    jm, tm = _mappings(jtdma), _mappings(ttdma)
    assert jm.keys() == tm.keys()
    for name, a in jm.items():
        b = tm[name]
        assert dataclass_fields(a) == dataclass_fields(b), name
        eq(b.reverse_map(), a.reverse_map(), name)
        for fn in (0, 11, 50, 101, 2715647):
            assert b.next_write_time(fn) == a.next_write_time(fn), name
            assert b.reverse(fn) == a.reverse(fn), name


def dataclass_fields(m):
    return (m.type_and_offset, m.downlink, m.uplink, m.allowed_slots,
            m.c0_only, m.repeat_length, m.frame_mapping)


# ---- parity, conv, Viterbi --------------------------------------------------

@pytest.mark.parametrize("name", sorted(SPECS))
def test_parity_and_syndrome_match_jax(name):
    """parity_word both ways, the unit-response matrix, and syndrome_ok on
    good codewords and on codewords with one flipped bit."""
    jspec, tspec = getattr(jfec, SPECS[name]), getattr(tfec, SPECS[name])
    assert jspec == tspec
    poly, p, n = jspec
    rng = np.random.default_rng(p)
    data = rng.integers(0, 2, (6, n - p)).astype(np.uint8)
    for invert in (True, False):
        eq(tfec.parity_word(t(data), tspec, invert),
           jfec.parity_word(jnp.asarray(data), jspec, invert), name)
    eq(tfec._crc_contribution_matrix(poly, p, n, False),
       jfec._crc_contribution_matrix(poly, p, n, False))
    cw = np.concatenate([data, np.asarray(jfec.parity_word(data, jspec))], -1)
    cw[3:, rng.integers(0, n, 3)] ^= 1
    ok = tfec.syndrome_ok(t(cw), tspec)
    eq(ok, jfec.syndrome_ok(jnp.asarray(cw), jspec), name)
    assert ok[:3].all() and not ok[3:].any()


def test_conv_encode_matches_jax():
    bits = np.random.default_rng(1).integers(0, 2, (3, 5, 189)).astype(
        np.uint8)
    eq(tfec.conv_encode(t(bits)), jfec.conv_encode(jnp.asarray(bits)))


def _viterbi_inputs():
    """[4·8, 456] soft inputs of four kinds: clean codewords, Gaussian
    noise (σ 0.25, clipped to [0, 1]), hard bits with 3% flipped, and
    all-0.5 erasures (every branch ties)."""
    rng = np.random.default_rng(7)
    u = rng.integers(0, 2, (8, 228)).astype(np.uint8)
    u[:, -4:] = 0
    c = tfec.conv_encode(t(u)).numpy().astype(np.float32)
    noisy = np.clip(c + rng.normal(0, 0.25, c.shape), 0, 1)
    flips = np.where(rng.random(c.shape) < 0.03, 1 - c, c)
    erased = np.full_like(c, 0.5)
    soft = np.concatenate([c, noisy, flips, erased]).astype(np.float32)
    return u, soft


@pytest.fixture(scope="module")
def viterbi_ref():
    u, soft = _viterbi_inputs()
    return u, soft, np.asarray(jax.jit(jfec.viterbi_decode)(soft))


@pytest.mark.parametrize("kind", ["clean", "gaussian", "flips", "erasure"])
def test_viterbi_matches_jax(viterbi_ref, kind):
    """Bit-exact on each kind; the clean and noisy kinds also decode to
    the sent bits, and the erasures to the 0-prefix (the tie rule)."""
    u, soft, want = viterbi_ref
    k = ["clean", "gaussian", "flips", "erasure"].index(kind)
    rows = slice(8 * k, 8 * k + 8)
    got = tfec.viterbi_decode(t(soft[rows]))
    assert got.dtype == torch.uint8
    eq(got, want[rows], kind)
    if kind != "erasure":
        eq(got, u, kind)
    else:
        assert not got.any()


# ---- interleave and burst maps ---------------------------------------------

def test_interleave_maps_match_jax():
    eq(tfec.xcch_interleave_map(), jfec.xcch_interleave_map())
    for off in range(8):
        eq(tfec.tch_interleave_map(off), jfec.tch_interleave_map(off))
    rng = np.random.default_rng(2)
    c = rng.integers(0, 2, (3, 456)).astype(np.uint8)
    for imap, nb in ((tfec.xcch_interleave_map(), 4),
                     (tfec.tch_interleave_map(0), 8),
                     (tfec.tch_interleave_map(4), 8)):
        i = tfec.interleave(t(c), imap, nb)
        eq(i, jfec.interleave(jnp.asarray(c), imap, nb))
        # the device-table form of the map gives the same scatter
        eq(tfec.interleave(t(c), torch.from_numpy(imap.astype(np.int64)),
                           nb), i)
        eq(tfec.deinterleave(i, imap),
           jfec.deinterleave(jnp.asarray(i.numpy()), imap))
        eq(tfec.deinterleave(i, imap), c)


@pytest.mark.parametrize("stealing,tsc", [((1, 1), None), ((0, 1), 3),
                                          ((1, 0), 7)])
def test_burst_maps_match_jax(stealing, tsc):
    rng = np.random.default_rng(3)
    i = rng.integers(0, 2, (2, 4, 114)).astype(np.uint8)
    b = tfec.map_to_burst(t(i), stealing, tsc=tsc)
    eq(b, jfec.map_to_burst(jnp.asarray(i), stealing, tsc=tsc))
    soft = rng.random((2, 148)).astype(np.float32)
    (tp, (thl, thu)), (jp, (jhl, jhu)) = (tfec.unmap_from_burst(t(soft)),
                                          jfec.unmap_from_burst(soft))
    eq(tp, jp)
    eq(thl, jhl)
    eq(thu, jhu)


# ---- L1 codecs -------------------------------------------------------------

CODECS = ("lsb8msb", "pack_unpack", "xcch_encode", "xcch_decode",
          "xcch_decode_payload", "rach_encode", "rach_decode", "sch_encode",
          "sch_decode", "tch_encode", "tch_decode")


@functools.lru_cache(maxsize=None)
def _codec_inputs():
    """Random frames and fields, and noisy soft codewords of each code
    (σ 0.3, clipped to [0, 1], the first codeword of each erased)."""
    rng = np.random.default_rng(4)
    d = {"frames": rng.integers(0, 2, (3, 2, 184)).astype(np.uint8),
         "bits": rng.integers(0, 2, (4, 27)).astype(np.uint8),
         "ra": rng.integers(0, 256, (5,)).astype(np.int32),
         "bsic": rng.integers(0, 64, (5,)).astype(np.int32),
         "sch": [rng.integers(0, m, (4,)).astype(np.int32)
                 for m in (64, 2048, 32, 8)],
         "speech": rng.integers(0, 2, (3, 260)).astype(np.uint8)}
    # coded with the port's encoders (held to JAX's here too)
    coded = {"xcch": tl1.xcch_encode(t(d["frames"]), tsc=2),
             "rach": tl1.rach_encode(t(d["ra"]), t(d["bsic"])),
             "sch": tl1.sch_encode(*map(t, d["sch"])),
             "tch": tl1.tch_encode(t(d["speech"]))}
    for k, (name, x) in enumerate(coded.items()):
        x = np.asarray(x, np.float32)
        s = np.clip(x + np.random.default_rng(k).normal(0, 0.3, x.shape),
                    0, 1).astype(np.float32)
        s[0] = 0.5
        d["soft_" + name] = s
    xb = d["soft_xcch"]
    d["soft_xcch_payload"] = np.concatenate([xb[..., 3:60], xb[..., 88:145]],
                                            -1)
    return d


def _codec_call(name, m, a):
    """One codec of module m on the inputs, converted by a; a tuple of
    arrays."""
    d = _codec_inputs()
    if name == "lsb8msb":
        return (m.lsb8msb(a(d["bits"])),)
    if name == "pack_unpack":
        return (m.pack_field([a(d["ra"]), a(d["bsic"])], [8, 6]),
                m.unpack_field(a(d["bits"]), 3, 11))
    if name == "xcch_encode":
        return (m.xcch_encode(a(d["frames"]), (1, 0), 5),
                m._facch_coded(a(d["frames"])))
    if name == "xcch_decode":
        return m.xcch_decode(a(d["soft_xcch"]))
    if name == "xcch_decode_payload":
        return m.xcch_decode(a(d["soft_xcch_payload"]))
    if name == "rach_encode":
        return (m.rach_encode(a(d["ra"]), a(d["bsic"])),)
    if name == "rach_decode":
        return m.rach_decode(a(d["soft_rach"]), 17)
    if name == "sch_encode":
        return (m.sch_encode(*map(a, d["sch"])),)
    if name == "sch_decode":
        f, ok = m.sch_decode(a(d["soft_sch"]))
        return f["bsic"], f["t1"], f["t2"], f["t3p"], ok
    if name == "tch_encode":
        return (m.tch_encode(a(d["speech"])),)
    assert name == "tch_decode"
    return m.tch_decode(a(d["soft_tch"]))


@pytest.fixture(scope="module")
def codec_ref():
    """JAX's outputs, each codec as one jitted program (its inputs are
    constants of the program)."""
    return {name: [np.asarray(x) for x in jax.jit(
        lambda name=name: _codec_call(name, jl1, jnp.asarray))()]
            for name in CODECS}


@pytest.mark.parametrize("name", CODECS)
def test_codec_matches_jax(codec_ref, name):
    got = _codec_call(name, tl1, t)
    want = codec_ref[name]
    assert len(got) == len(want)
    for k, (a, b) in enumerate(zip(got, want)):
        eq(a, b, f"{name}[{k}]")


def test_codecs_decode_what_they_encode():
    """The port's round trips on its own: XCCH, RACH, SCH and TCH/FS."""
    rng = np.random.default_rng(9)
    frames = t(rng.integers(0, 2, (4, 184)).astype(np.uint8))
    got, ok = tl1.xcch_decode(tl1.xcch_encode(frames).to(torch.float32))
    assert torch.equal(got, frames) and ok.all()
    ra = t(rng.integers(0, 256, (4,)).astype(np.int32))
    ra2, ok = tl1.rach_decode(tl1.rach_encode(ra, torch.full((4,), 9))
                              .to(torch.float32), 9)
    assert torch.equal(ra2, ra) and ok.all()
    _, ok = tl1.rach_decode(tl1.rach_encode(ra, torch.full((4,), 9))
                            .to(torch.float32), 10)
    assert not ok.any()  # the wrong color code
    speech = t(rng.integers(0, 2, (4, 260)).astype(np.uint8))
    d, good = tl1.tch_decode(tl1.tch_encode(speech).to(torch.float32))
    assert torch.equal(d, speech) and good.all()
    fields, ok = tl1.sch_decode(tl1.sch_encode(
        torch.tensor([5]), torch.tensor([1000]), torch.tensor([17]),
        torch.tensor([3])).to(torch.float32))
    assert ok.all() and [int(fields[k]) for k in ("bsic", "t1", "t2", "t3p")
                         ] == [5, 1000, 17, 3]


# ---- the windowed TCH downlink encoder --------------------------------------

N_LANES = 3
TX_WINDOWS = 3


def _tch_window_inputs(p):
    rng = np.random.default_rng(100 + p)
    out = []
    for _ in range(TX_WINDOWS):
        out.append((rng.integers(0, 2, (3, N_LANES, 260)).astype(np.uint8),
                    rng.random((3, N_LANES)) < 0.7,
                    rng.integers(0, 2, (3, N_LANES, 184)).astype(np.uint8),
                    rng.random((3, N_LANES)) < 0.3))
    return out


@pytest.fixture(scope="module")
def tch_tx_ref():
    """JAX's tch_tx_window over TX_WINDOWS consecutive windows from each
    of the 26 phases, its carry threaded."""
    fn = jax.jit(jl1.tch_tx_window, static_argnums=(6,))
    out = {}
    for p in range(26):
        carry = jl1.TchTxCarry.zeros(N_LANES)
        wins = []
        for w, (sp, spv, fa, fav) in enumerate(_tch_window_inputs(p)):
            bits, isb, hu, carry = fn(sp, spv, fa, fav, carry,
                                      jnp.asarray(p + 13 * w, jnp.int32), 13)
            wins.append(tuple(np.asarray(x) for x in
                              (bits, isb, hu) + tuple(carry)))
        out[p] = wins
    return out


def test_tch_tx_tables_match_jax():
    for frames in (13, 26):
        for a, b in zip(tl1._tch_tx_tables(frames),
                        jl1._tch_tx_tables(frames)):
            eq(a, b)


def test_tch_tx_window_matches_jax_all_phases(tch_tx_ref):
    """Every fn0 % 26 phase, 3 windows each with the carry threaded, on a
    0-d fn0 tensor: bits, is_burst, Hu flags and every carry field exact."""
    for p in range(26):
        carry = tl1.TchTxCarry.zeros(N_LANES, "cpu")
        for w, (sp, spv, fa, fav) in enumerate(_tch_window_inputs(p)):
            bits, isb, hu, carry = tl1.tch_tx_window(
                t(sp), t(spv), t(fa), t(fav), carry,
                torch.tensor(p + 13 * w, dtype=torch.int32), 13)
            for k, (a, b) in enumerate(zip((bits, isb, hu) + tuple(carry),
                                           tch_tx_ref[p][w])):
                eq(a, b, f"phase {p} window {w} output {k}")


def test_tch_tx_window_refuses_too_few_dispatches():
    z = torch.zeros
    with pytest.raises(ValueError):
        tl1.tch_tx_window(z((2, 1, 260), dtype=torch.uint8),
                          z((2, 1), dtype=torch.bool),
                          z((2, 1, 184), dtype=torch.uint8),
                          z((2, 1), dtype=torch.bool),
                          tl1.TchTxCarry.zeros(1, "cpu"),
                          torch.tensor(0), 13)
