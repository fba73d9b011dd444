"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU and skips without one. The
file imports no JAX, so it also runs where JAX is absent:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from openbts_ttsou_tpu_torch.models import transceiver as T
from openbts_ttsou_tpu_torch.ops import cuda_fir
from openbts_ttsou_tpu_torch.ops import fir
from openbts_ttsou_tpu_torch.ops import gmsk
from openbts_ttsou_tpu_torch.trx import engine as eng
from openbts_ttsou_tpu_torch.utils import constants as C

# (p, q, taps, T, leading shape): the two ratios the system runs (the
# templated instantiations) at the uplink's lengths and at the duplex
# block's (the uplink window with its two 96-sample halos, the downlink
# stream with its 130-symbol tail), the small ratios of the
# runtime-width and tail-group paths, one row, more tiles than the
# persistent grid holds (600 rows of one tile), odd T, k_max 25 (the
# runtime instantiation at the uplink ratio), and the largest q at p = 3
# (one cycle a tile)
GEOMETRIES = [(65, 96, 961, 24000, (3, 2)), (96, 65, 651, 16250, (3, 2)),
              (65, 96, 961, 24192, (3,)), (96, 65, 651, 16380, (3,)),
              (3, 200, 31, 1000, (3, 2)), (7, 2, 50, 300, (3, 2)),
              (65, 96, 961, 24000, (1,)), (65, 96, 961, 2000, (600,)),
              (96, 65, 651, 16251, (5,)), (7, 2, 50, 301, (4,)),
              (65, 96, 1601, 24001, (3,)), (3, 20962, 31, 62891, (2,))]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("p,q,taps,T,lead", GEOMETRIES)
def test_resample_kernel_matches_plain(card, p, q, taps, T, lead):
    rng = np.random.default_rng(T)
    shape = lead + (T,)
    x = torch.from_numpy(
        (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
         ).astype(np.complex64)).cuda()
    lpf = fir.resampler_lpf(p, q, taps)
    n0 = cuda_fir.polyphase_resample_cuda.launches
    got = fir.polyphase_resample(x, p, q, lpf)
    assert cuda_fir.polyphase_resample_cuda.launches == n0 + 1
    want = cuda_fir.polyphase_resample_plain(x, p, q, lpf)
    torch.cuda.synchronize()
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert got.shape == want.shape == lead + (fir.polyphase_output_len(T, p, q),)
    # float32 sums in another order (the bound tests/test_pallas.py:23
    # holds the Pallas kernel to)
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=2e-4 * np.abs(want).max())


@pytest.mark.cuda
def test_resample_kernel_refuses_bad_input(card):
    lpf = fir.resampler_lpf(65, 96, 961)
    x = torch.zeros(2, 960, dtype=torch.complex64, device="cuda")
    with pytest.raises(ValueError):
        cuda_fir.polyphase_resample_cuda(x[:, ::2], 65, 96, lpf)
    with pytest.raises(TypeError):
        cuda_fir.polyphase_resample_cuda(x.real.contiguous(), 65, 96, lpf)


@pytest.mark.cuda
@pytest.mark.parametrize("p,q,taps,T", [(65, 96, 961, 24000),
                                        (96, 65, 651, 16250)])
def test_resample_kernel_is_deterministic(card, p, q, taps, T):
    """No atomics and a fixed order of sums: two launches on one input
    give the same bits."""
    rng = np.random.default_rng(p)
    x = torch.from_numpy((rng.standard_normal((64, T))
                          + 1j * rng.standard_normal((64, T))
                          ).astype(np.complex64)).cuda()
    lpf = fir.resampler_lpf(p, q, taps)
    a = cuda_fir.polyphase_resample_cuda(x, p, q, lpf)
    b = cuda_fir.polyphase_resample_cuda(x, p, q, lpf)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_resample_kernel_takes_unaligned_rows(card):
    """A contiguous view that starts one sample into its storage: every
    row start is off the 16-byte grid, so the slab copies and the stores
    take their 8-byte paths."""
    p, q, taps, T = 65, 96, 961, 3001
    rng = np.random.default_rng(7)
    base = torch.from_numpy((rng.standard_normal(4 * T + 1)
                             + 1j * rng.standard_normal(4 * T + 1)
                             ).astype(np.complex64)).cuda()
    x = base[1:].view(4, T)
    lpf = fir.resampler_lpf(p, q, taps)
    got = cuda_fir.polyphase_resample_cuda(x, p, q, lpf)
    want = cuda_fir.polyphase_resample_plain(x, p, q, lpf)
    torch.cuda.synchronize()
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=2e-4 * np.abs(want).max())


def _duplex_inputs(c, rng):
    """One duplex block's io buffer: TSC-2 bursts on slots 1-7 at delays
    of 0-2 symbols and RACH bursts on slot 0 of some frames, in noise, at
    the device rate with the two halos, as int16; a random downlink with
    filler slots, attenuations 0-9 dB and one carrier not live."""
    spec = T.UplinkSpec()
    f, halo = spec.frames, T.RX_HALO_DEV
    offs = np.concatenate([[0], np.cumsum([157, 156, 156, 156] * 2)])[:8]
    sym = (rng.standard_normal((c, (f + 1) * 1250, 2)) * 20.0
           ).astype(np.float32).view(np.complex64)[..., 0]
    for fr in range(f + 1):
        for ch in range(c):
            for tn in range(8):
                bits = rng.integers(0, 2, 148).astype(np.uint8)
                if tn == 0:
                    if fr % 4 != 1:
                        continue
                    bits[:8] = [0, 1, 0, 1, 0, 1, 0, 1]
                    bits[8:49] = C.RACH_SYNCH_SEQUENCE
                    bits[49:85] = rng.integers(0, 2, 36)
                else:
                    bits[61:87] = C.TRAINING_SEQUENCE[2]
                w = 9000.0 * gmsk.modulate_burst_np(bits[None], 1, 9)[0]
                s = fr * 1250 + offs[tn] + int(rng.integers(0, 3))
                e = min(s + len(w), sym.shape[1])
                sym[ch, s:e] += w[: e - s]
    dev = fir.polyphase_resample(torch.from_numpy(sym), 96, 65,
                                 fir.resampler_lpf(96, 65, 651)).numpy()
    dev = np.pad(dev[:, : spec.block_in + halo], ((0, 0), (halo, 0)))
    ul = np.clip(np.stack([dev.real, dev.imag], -1).round(), -32767,
                 32767).astype(np.int16)
    live = np.ones(c, bool)
    live[-1] = False
    return T.pack_dl_buffer_live(
        rng.integers(0, 2, (f, c, 8, 148)).astype(np.uint8),
        rng.random((f, c, 8)) < 0.7, rng.integers(0, 10, (f, c, 8)),
        500, 502, ul, live)


def _close_int(a, b):
    """Within ±1, at most 0.1% off by 1 (float32 sums in another order)."""
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    assert d.max(initial=0) <= 1 and (d > 0).sum() <= 1e-3 * d.size


@pytest.mark.cuda
def test_duplex_block_compact_card_matches_cpu(card):
    """One duplex block on the card (K1 at [C, 24192] 65/96 and [C, 16380]
    96/65) and on the CPU from one entry state: header bytes, detections'
    datagram headers and the integer state exact; soft bytes and DAC
    samples within ±1 (at most 0.1% off); float state within the uplink
    suite's bound (atol 2e-4, rtol 5e-6)."""
    c = 3
    cfg = eng.TrxConfig(n_chan=c, max_toa=8)
    spec = T.UplinkSpec()
    buf = _duplex_inputs(c, np.random.default_rng(12))
    outs = {}
    for dev in ("cuda", "cpu"):
        st = eng.init_state(cfg, dev)._replace(
            chan_type=torch.tensor(
                [[eng.ChanType.IV] + [eng.ChanType.I] * 7] * c,
                dtype=torch.int32, device=dev),
            tsc=torch.full((c,), 2, dtype=torch.int32, device=dev),
            max_expected_delay=torch.tensor([0, 2, 4], dtype=torch.int32,
                                            device=dev))
        tail = torch.zeros((c, T.TX_TAIL_SYM), dtype=torch.complex64,
                           device=dev)
        n0 = cuda_fir.polyphase_resample_cuda.launches
        outs[dev] = T.duplex_block_compact(cfg, spec, st,
                                           torch.from_numpy(buf).to(dev),
                                           tail)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert cuda_fir.polyphase_resample_cuda.launches == n0 + 2
    (sg, tg, hg, txg, pg), (sc, tc, hc, txc, pc) = outs["cuda"], outs["cpu"]
    hg, hc = hg.cpu().numpy(), hc.cpu().numpy()
    np.testing.assert_array_equal(hg, hc)
    n_det = int.from_bytes(hc[:4].tobytes(), "big")
    n_live = int.from_bytes(hc[4:].tobytes(), "big")
    assert n_live == c - 1 and n_det > 0
    _close_int(txg[:n_live].cpu().numpy().view("<i2"),
               txc[:n_live].numpy().view("<i2"))
    pg, pc = pg[:n_det].cpu().numpy(), pc[:n_det].numpy()
    np.testing.assert_array_equal(pg[:, :8], pc[:, :8])
    np.testing.assert_array_equal(pg[:, 156:], pc[:, 156:])
    _close_int(pg[:, 8:156], pc[:, 8:156])
    for name in sc._fields:
        a, b = getattr(sg, name).cpu().numpy(), getattr(sc, name).numpy()
        if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, atol=2e-4, rtol=5e-6,
                                       err_msg=name)
    np.testing.assert_allclose(tg.cpu().numpy(), tc.numpy(),
                               atol=2e-4 * float(tc.abs().max()))


# ---- the resident layer 1: Viterbi, decode leg, duplex ---------------------

@pytest.mark.cuda
def test_viterbi_tie_rule_on_card(card):
    """Erasures (every branch ties) decode to the 0-prefix on the card as
    on the CPU (strict <, first-minimum argmin); codewords with noise,
    flips and erased stretches decode to the CPU's bits exactly."""
    from openbts_ttsou_tpu_torch.gsm import fec

    rng = np.random.default_rng(8)
    u = rng.integers(0, 2, (64, 228)).astype(np.uint8)
    u[:, -4:] = 0
    c = fec.conv_encode(torch.from_numpy(u)).numpy().astype(np.float32)
    soft = np.clip(c + rng.normal(0, 0.3, c.shape), 0, 1).astype(np.float32)
    soft[:16] = 0.5  # all erased
    soft[16:32, 100:180] = 0.5  # erased stretches
    soft[32:48] = np.where(rng.random(c[32:48].shape) < 0.05, 1 - c[32:48],
                           c[32:48])
    x = torch.from_numpy(soft)
    got = fec.viterbi_decode(x.cuda()).cpu()
    want = fec.viterbi_decode(x)
    assert torch.equal(got, want)
    assert not got[:16].any()


def _decode_inputs(c, rng):
    """A random RxResult of one window [13, c, 8] and a prelude: soft bits
    near 0/1 with noise, some erased bursts."""
    f, p = 13, T.DECODE_PRELUDE
    soft = np.clip(rng.integers(0, 2, (p + f, c, 8, 148)) * 0.8 + 0.1
                   + rng.normal(0, 0.15, (p + f, c, 8, 148)), 0, 1)
    soft[rng.random((p + f, c, 8)) < 0.05] = 0.5
    soft = torch.from_numpy(soft.astype(np.float32))
    shape = (f, c, 8)
    res = eng.RxResult(torch.from_numpy(rng.random(shape) < 0.9),
                       torch.from_numpy(rng.random(shape) < 0.3), soft[p:],
                       torch.zeros(shape, dtype=torch.int32),
                       torch.zeros(shape, dtype=torch.int32))
    return res, soft[:p]


@pytest.mark.cuda
def test_decode_block_card_matches_cpu_without_syncs(card):
    """decode_block with the prelude and the bench split at 6 phases:
    every DecodedBlocks field the CPU's; once warm, it runs under sync
    debug mode "error" (no host sync)."""
    res, prev = _decode_inputs(3, np.random.default_rng(9))
    kw = dict(xcch_tns=(0, 1, 6, 7), tch_tns=(2, 3, 4, 5), rach_tns=(0,))
    res_g = eng.RxResult(*(x.cuda() for x in res))
    for k, fn0 in enumerate((1000, 1001, 1007, 1013, 1020, 2715640)):
        pv = torch.tensor(k % 2 == 0)
        want = T.decode_block(res, torch.tensor(fn0, dtype=torch.int32), 13,
                              5, prev_soft=prev, prev_valid=pv, **kw)
        fn_g = torch.tensor(fn0, dtype=torch.int32).cuda()
        pv_g, prev_g = pv.cuda(), prev.cuda()
        got = T.decode_block(res_g, fn_g, 13, 5, prev_soft=prev_g,
                             prev_valid=pv_g, **kw)
        for name in T.DecodedBlocks._fields:
            assert torch.equal(getattr(got, name).cpu(), getattr(want, name))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            T.decode_block(res_g, fn_g, 13, 5, prev_soft=prev_g,
                           prev_valid=pv_g, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)


@pytest.mark.cuda
def test_resident_duplex_card_matches_cpu(card):
    """ResidentL1 on 2 carriers, 2 windows of random content on every
    slot and a noisy uplink, on the card and on the CPU: DecodedBlocks
    exact, tx within 2e-4 of the peak; K1 twice a window on the card."""
    from openbts_ttsou_tpu_torch.models import ResidentL1

    c, fn0 = 2, 52
    rng = np.random.default_rng(10)
    spec = T.UplinkSpec()
    tch_mask = np.zeros((c, 8), bool)
    tch_mask[:, 2:6] = True
    wins = []
    for _ in range(2):
        content = (rng.integers(0, 2, (4, c, 8, 184)).astype(np.uint8),
                   rng.random((4, c, 8)) < 0.8,
                   rng.integers(0, 2, (3, c, 8, 260)).astype(np.uint8),
                   rng.random((3, c, 8)) < 0.8,
                   rng.integers(0, 2, (3, c, 8, 184)).astype(np.uint8),
                   rng.random((3, c, 8)) < 0.3, tch_mask)
        shape = (c, spec.block_in + 2 * T.RX_HALO_DEV)
        ul = ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
              * 100.0).astype(np.complex64)
        wins.append((ul, content))
    outs = {}
    for dev in ("cuda", "cpu"):
        r = ResidentL1(eng.TrxConfig(n_chan=c), spec,
                       xcch_tns=(0, 1, 6, 7), tch_tns=(2, 3, 4, 5),
                       fn0=fn0, device=dev)
        n0 = cuda_fir.polyphase_resample_cuda.launches
        outs[dev] = [r.step(ul, content) for ul, content in wins]
        if dev == "cuda":
            torch.cuda.synchronize()
            assert cuda_fir.polyphase_resample_cuda.launches == n0 + 4
    for (tg, bg), (tc, bc) in zip(outs["cuda"], outs["cpu"]):
        for name in T.DecodedBlocks._fields:
            assert torch.equal(getattr(bg, name).cpu(), getattr(bc, name))
        np.testing.assert_allclose(tg.cpu().numpy(), tc.numpy(),
                                   atol=2e-4 * float(tc.abs().max()))


# ---- the BTS's L1 channels: each FEC call on the card and on the CPU -------

class _Upstream:
    def __init__(self, frames):
        self.frames = frames

    def write_low_side(self, frame):
        self.frames.append(frame.bits)


def _fec_cases():
    """(name, call(device)) for every FEC call of gsm/channels.py, on
    seeded inputs: clean and noisy decodes, both TCH diagonal offsets."""
    from openbts_ttsou_tpu_torch.gsm import channels as ch

    rng = np.random.default_rng(21)
    bits = rng.integers(0, 2, 184).astype(np.uint8)
    coded = ch.xcch_encode_bursts(bits, 2, torch.device("cpu"))
    noisy = np.clip(coded + 0.3 * rng.standard_normal(coded.shape), 0, 1
                    ).astype(np.float32)
    ra_soft = np.clip(rng.integers(0, 2, 36) + 0.2 * rng.standard_normal(36),
                      0, 1).astype(np.float32)
    iframe = np.clip(rng.integers(0, 2, (8, 114))
                     + 0.25 * rng.standard_normal((8, 114)), 0, 1
                     ).astype(np.float32)
    d = rng.integers(0, 2, 260).astype(np.uint8)
    halves = rng.integers(0, 2, (4, 114)).astype(np.uint8)
    return [
        ("xcch_encode", lambda dev: ch.xcch_encode_bursts(bits, 2, dev)),
        ("xcch_encode_no_tsc",
         lambda dev: ch.xcch_encode_bursts(bits, None, dev)),
        ("xcch_decode_clean",
         lambda dev: ch.xcch_decode_block(coded.astype(np.float32), dev)),
        ("xcch_decode_noisy", lambda dev: ch.xcch_decode_block(noisy, dev)),
        ("rach_decode", lambda dev: ch.rach_decode_bits(ra_soft, 21, dev)),
        ("sch_encode", lambda dev: ch.sch_encode_burst(45, 1234, 17, 3, dev)),
        ("facch_encode", lambda dev: ch.facch_encode(bits, dev)),
        ("tch_encode", lambda dev: ch.tch_encode_block(d, dev)),
        ("map_bursts", lambda dev: ch.map_bursts(halves, (1, 0), 2, dev)),
        ("facch_decode_0", lambda dev: ch.facch_decode_frame(iframe, 0, dev)),
        ("facch_decode_4", lambda dev: ch.facch_decode_frame(iframe, 4, dev)),
        ("tch_decode_0", lambda dev: ch.tch_decode_frame(iframe, 0, dev)),
        ("tch_decode_4", lambda dev: ch.tch_decode_frame(iframe, 4, dev)),
    ]


@pytest.mark.cuda
def test_channel_fec_card_matches_cpu(card):
    for name, call in _fec_cases():
        got, want = call(torch.device("cuda")), call(torch.device("cpu"))
        if isinstance(want, tuple):
            assert got[0] == want[0], name
            np.testing.assert_array_equal(got[1], want[1], err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.cuda
def test_sacch_and_tch_channels_card_match_cpu(card):
    """SACCH (its L1 header) and TCH/FACCH both ways as channel objects:
    the card's bursts, frames and speech are the CPU's."""
    from openbts_ttsou_tpu_torch.gsm import channels as ch
    from openbts_ttsou_tpu_torch.gsm import tdma
    from openbts_ttsou_tpu_torch.gsm.transfer import L2Frame, RxBurst

    rng = np.random.default_rng(22)
    frames = [rng.integers(0, 2, 184).astype(np.uint8) for _ in range(3)]
    speech = [rng.integers(0, 2, 260).astype(np.uint8) for _ in range(4)]
    out = {}
    for dev in ("cuda", "cpu"):
        got = []
        sa = ch.SACCHL1(0, *tdma.SACCH_C4[1], tsc=2, device=dev)
        sa.open(0)
        sa.ordered_ms_power, sa.ordered_ms_timing = 15, 7
        up = []
        sa.upstream = _Upstream(up)
        for f in frames:
            sa.send_l2(L2Frame(f))
        fn = 0
        for b in sa.tx_queue:
            fn = sa.uplink.next_write_time(fn)
            sa.write_low_side(RxBurst(b.bits.astype(np.float32), fn=fn, tn=0))
            fn += 1
        got += [b.bits.tobytes() for b in sa.tx_queue]
        got += [np.asarray(x).tobytes() for x in up]
        got.append((sa.actual_ms_power, sa.actual_ms_timing))
        tch = ch.TCHFACCHL1(2, tdma.FACCH_TCHF, tdma.FACCH_TCHF, tsc=2,
                            device=dev)
        tch.open(0)
        tch_up = []
        tch.upstream = _Upstream(tch_up)
        for k, s in enumerate(speech):
            tch.send_tch(s)
            if k == 1:
                tch.send_l2(L2Frame(frames[0]))
        for _ in range(len(speech) + 2):
            tch.dispatch_block()
        for b in list(tch.tx_queue):
            tch.write_low_side(RxBurst(b.bits.astype(np.float32), fn=b.fn,
                                       tn=2))
        got += [b.bits.tobytes() for b in tch.tx_queue]
        got += [np.asarray(x).tobytes() for x in tch.speech_out]
        got += [np.asarray(x).tobytes() for x in tch_up]
        got.append((tch.good_frames, tch.bad_frames))
        out[dev] = got
    assert out["cuda"] == out["cpu"]
    assert len(out["cpu"]) > 40


@pytest.mark.cuda
def test_bts_app_on_card(card):
    """BTSApp(device="cuda") builds, runs its channels' FEC on the card with
    the constant tables there, and generates the CPU's beacon."""
    from openbts_ttsou_tpu_torch.apps.openbts import BTSApp
    from openbts_ttsou_tpu_torch.gsm import fec, l1fec

    beacons = {}
    for dev, port in (("cuda", 53470), ("cpu", 53480)):
        app = BTSApp(trx_base_port=port, device=dev)
        try:
            sent = []
            app.trx.arfcn(0).write_high_side = lambda b, gain_db=0: \
                sent.append((b.fn, b.tn, b.bits.tobytes()))
            for fn in range(102):
                app._generate_downlink(fn)
            beacons[dev] = sent
            if dev == "cuda":
                chans = [app.sch, app.fcch, app.bcch, app.agch, app.pch,
                         app.rach, *(c.l1 for c in app.dcch),
                         *(c.sacch for c in app.dcch),
                         *(t.l1 for t in app.bts.tch_pool)]
                assert all(c.device.type == "cuda" for c in chans)
        finally:
            app.shutdown()
    cuda = torch.device("cuda")
    assert l1fec._xcch_map(cuda).is_cuda
    assert fec.training_sequences_on(cuda).is_cuda
    # 102 frames: FCCH 10, SCH 10, BCCH 2 blocks of 4 (no CCCH traffic)
    assert beacons["cuda"] == beacons["cpu"] and len(beacons["cpu"]) == 28


def _sharded_stream(c, frames, seed):
    """[c, frames·24000/13] device-rate noise with TSC-0 bursts on slot 1
    and RACH bursts on slot 0 of every fourth frame."""
    rng = np.random.default_rng(seed)
    sym = (rng.standard_normal((c, frames * 1250, 2)) * 20.0
           ).astype(np.float32).view(np.complex64)[..., 0]
    for f in range(frames):
        bits = rng.integers(0, 2, 148).astype(np.uint8)
        bits[61:87] = C.TRAINING_SEQUENCE[0]
        w = 9000.0 * gmsk.modulate_burst_np(bits[None], 1, guard_len=9)[0]
        sym[:, f * 1250 + 157: f * 1250 + 157 + len(w)] += w
        if f % 4 == 1:
            rach = np.zeros(148, np.uint8)
            rach[:8] = [0, 1, 0, 1, 0, 1, 0, 1]
            rach[8:49] = C.RACH_SYNCH_SEQUENCE
            rach[49:85] = rng.integers(0, 2, 36)
            w = 9000.0 * gmsk.modulate_burst_np(rach[None], 1,
                                                guard_len=9)[0]
            sym[:, f * 1250: f * 1250 + len(w)] += w
    return fir.polyphase_resample(torch.from_numpy(sym), 96, 65,
                                  fir.resampler_lpf(96, 65, 651))


@pytest.mark.cuda
def test_sharded_uplink_card_matches_cpu(card):
    """The sharded uplink with the state carry at a (2, 2) mesh, 2 steps,
    on cuda:0 and on the CPU: detections, RACH flags, RSSI, timing and
    the integer and bool state equal; K1 launched once a shard a step."""
    from openbts_ttsou_tpu_torch import convert
    from openbts_ttsou_tpu_torch.parallel import make_mesh
    from openbts_ttsou_tpu_torch.parallel import sharded as sh

    c, steps = 4, 2
    cfg = eng.TrxConfig(n_chan=c, rach_slots=(0,))
    spec = sh.ShardedPipelineSpec(n_chan_total=c, frames_per_shard=13)
    x = _sharded_stream(c, steps * 26, 3)
    block = 2 * spec.block_in
    out = {}
    for dev in ("cuda", "cpu"):
        mesh = make_mesh(4, dev)
        step = sh.sharded_uplink_pipeline(mesh, cfg, spec)
        ct = torch.full((c, 8), eng.ChanType.I, dtype=torch.int32)
        ct[:, 0] = eng.ChanType.IV
        st = sh.state_for_shards(eng.init_state(cfg, dev)._replace(
            chan_type=ct.to(dev)), 2)
        n0 = cuda_fir.polyphase_resample_cuda.launches
        res = []
        for k in range(steps):
            st, r, _ = step(st, x[:, k * block: (k + 1) * block].to(dev),
                            k * 26)
            res.append(r)
        if dev == "cuda":
            assert cuda_fir.polyphase_resample_cuda.launches == n0 + 4 * steps
        out[dev] = (convert.state_to_numpy(st), res)
    (sg, rg), (sc, rc) = out["cuda"], out["cpu"]
    for g, h in zip(rg, rc):
        for name in ("detected", "is_rach", "rssi", "timing"):
            assert torch.equal(getattr(g, name).cpu(), getattr(h, name)), name
        assert bool(h.is_rach.any()) and int(h.detected.sum()) >= 4 * 26
    for name, a in sg.items():
        if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(a, sc[name], err_msg=name)


@pytest.mark.cuda
def test_exchange_halo_on_card_equals_full_stream(card):
    """Halos exchanged between four time shards on cuda:0 equal slices of
    the full stream, zeros at its edges."""
    from openbts_ttsou_tpu_torch.parallel import halo, mesh

    m = mesh.Mesh((2, 4), ["cuda"] * 8)
    x = torch.randn(2, 3, 400, dtype=torch.complex64, device="cuda")
    got = halo.exchange_halo(
        m, {s: x[s.chan, :, s.time * 100: (s.time + 1) * 100]
            for s in m.local}, 7, 5)
    pad = torch.nn.functional.pad(x, (7, 5))
    for s in m.local:
        assert got[s].device.type == "cuda"
        assert torch.equal(got[s], pad[s.chan, :, s.time * 100:
                                       s.time * 100 + 112])


# ---- the tools on the card ----------------------------------------------------

@pytest.mark.cuda
def test_kernel_probe_uplink_on_card(card):
    """K1 at the uplink shape against float64: no worse than twice the
    plain form's largest error (both are float32 rounding noise)."""
    from openbts_ttsou_tpu_torch.tools import kernel_probe

    rec = kernel_probe.main(["--shapes", "uplink", "--rows", "16"])
    (row,) = rec["rows"]
    assert rec["ok"] and row["shape"] == "uplink"
    assert row["kernel"]["max_rel_err"] < 1e-6
    assert rec["device"] == torch.cuda.get_device_name(0) and rec["card"]


@pytest.mark.cuda
def test_daemon_soak_on_card_has_no_stale_burst(card):
    """The wire soak at 2 carriers on the card: 4 timed blocks after the
    clock lead has grown to the 26-frame block, nothing late or dumped,
    K1 twice a block."""
    from openbts_ttsou_tpu_torch.tools import daemon_soak

    rec = daemon_soak.main(["--carriers", "2", "--blocks", "4",
                            "--warmup", "6", "--block-frames", "26",
                            "--base-port", "55400"])
    assert rec["stale_dumped"] == 0 and rec["underruns"] == 0
    assert rec["uplink_datagrams"] >= 26 * 2 * 7 * 2
    assert rec["k1_launches"] == 2 * rec["blocks_run"]


# ---- the bench on the card ----------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["exact", "duplex"])
def test_bench_steps_on_card_match_cpu(card, mode):
    """The bench's stimulus and 2 blocks of its step at 8 carriers on the
    card and on the CPU: per-block counts equal, probes within the soft
    bits' 2e-4 (exact) or ±1 a quantized value (duplex), and K1 launched
    once for the stimulus and once (exact) or twice (duplex) a block, each
    launch seen by `common.k1_shapes` at 8 rows."""
    from openbts_ttsou_tpu_torch import bench
    from openbts_ttsou_tpu_torch.tools import common

    c, n = 8, 2
    cfg = eng.TrxConfig(n_chan=c)
    spec = T.UplinkSpec()
    runs = {}
    for dev in ("cuda", "cpu"):
        n0 = cuda_fir.polyphase_resample_cuda.launches
        with common.k1_shapes() as shapes:
            stim = bench.stimulus(c, dev, spec)
            step, carry = bench.make_step(mode, cfg, spec,
                                          bench.bench_state(cfg, dev), stim)
            probes, counts = bench.run_blocks(step, carry, n)
        runs[dev] = (probes.cpu().double(), counts.cpu(),
                     cuda_fir.polyphase_resample_cuda.launches - n0, shapes)
    (pg, cg, kg, sg), (pc, cc, kc, sc) = runs["cuda"], runs["cpu"]
    assert torch.equal(cg, cc) and (cg == 13 * c).all()
    assert kg == 1 + bench.K1_PER_BLOCK[mode] * n and kc == 0
    assert sum(sg.values()) == kg and {k[0] for k in sg} == {c} and sc == {}
    soft = 13 * c * 8
    atol = soft * 2e-4 if mode == "exact" else soft + 2 * c
    assert float((pg - pc).abs().max()) <= atol


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["frames", "batched", "estimate",
                                  "resident"])
def test_every_host_sync_is_inside_a_sync_span(card, monkeypatch, path):
    """One warm call at 4 carriers under `set_sync_debug_mode("warn")`:
    each host sync it makes happens inside a `sync.*` span, and the
    call records as many such spans as it makes syncs. Paths: the
    uplink's frame loop and batched schedule, the frame loop with the
    channel estimate and DFE design open (max delay 5), and the
    resident layer 1."""
    import time
    import warnings

    from openbts_ttsou_tpu_torch.models.resident import ResidentL1
    from openbts_ttsou_tpu_torch.utils import profiling

    c = 4
    torch.manual_seed(0)
    if path == "resident":
        layer = ResidentL1(eng.TrxConfig(n_chan=c), xcch_tns=(0, 1, 6, 7),
                           tch_tns=(2, 3, 4, 5), device="cuda")
        ul = torch.randn((c, layer.spec.block_in + 2 * T.RX_HALO_DEV),
                         dtype=torch.complex64, device="cuda") * 10
        content = layer.empty_content(np.ones((c, 8), bool))

        def call():
            return layer.step(ul, content)
    else:
        monkeypatch.setattr(T, "EXACT_BATCH_MAX_CHAN",
                            c if path == "batched" else 0)
        trx = T.Transceiver(eng.TrxConfig(n_chan=c), T.UplinkSpec(), "cuda")
        for chan in range(c):
            for tn in range(8):
                trx.set_slot(chan, tn, 4 if tn == 0 else 1)
            if path == "estimate":
                trx.set_max_delay(chan, 5)
        x = torch.randn((c, trx.spec.block_in), dtype=torch.complex64,
                        device="cuda") * 10

        def call():
            return trx.process_uplink(x)
    call()  # copies the tables kept on the device
    torch.cuda.synchronize()
    seen, in_call = [], [False]

    def hook(message, *args, **kwargs):
        if in_call[0] and "synchroniz" in str(message):
            frames = profiling.RECORDER._stack.frames
            seen.append(frames[-1][0] if frames and frames[-1] is not None
                        else None)

    t0 = time.perf_counter_ns()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            in_call[0] = True
            call()
            in_call[0] = False
        finally:
            torch.cuda.set_sync_debug_mode(0)
    spans = profiling.spans_between(t0, time.perf_counter_ns())
    outside = [s for s in seen if not (s or "").startswith("sync.")]
    assert seen and not outside, outside
    assert len(seen) == sum(s[0].startswith("sync.") for s in spans)


@pytest.mark.cuda
@pytest.mark.parametrize("max_delay", [0, 5])
def test_exact_schedules_agree_at_512_carriers(card, max_delay):
    """`process_block_exact` and `process_block_frames` from one entry
    state on the bake-off's block at 512 carriers, with the DFE off and
    on (max delay 5: the gated estimate, the DFE design and the
    equalizer): equal detections, RACH flags, RSSI and timing, soft bits
    within 2e-4, an equal integer state and every float state field
    within 1e-6 of its largest value, the benchmark's limits."""
    from openbts_ttsou_tpu_torch.tools import exact_bakeoff

    c = 512
    cfg, st, sym = exact_bakeoff.block(c, 13, torch.device("cuda"),
                                       max_delay)
    a = T.process_block_exact(cfg, 13, st, sym)
    b = T.process_block_frames(cfg, 13, st, sym)
    torch.cuda.synchronize()
    exact_bakeoff.assert_same(a, b, c)
    assert int(b[1].detected.sum()) == 13 * c
    assert bool(b[0].chan_valid[:, 1].all()) == (max_delay > 1)
