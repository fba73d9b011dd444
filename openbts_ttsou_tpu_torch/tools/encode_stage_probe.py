"""Per-stage time of the resident layer 1's window, `duplex_block_decoded`.

At the bench split (XCCH on slots 0, 1, 6, 7; TCH/FS on 2-5; every slot
combination I), times one 13-frame window's stages on their own: the
downlink FEC encode (`xcch_encode` over the window's four group starts,
`tch_tx_window`, and both legs together in `_encode_dl_window`), the
radio tx (modulate, assemble the stream, resample 96/65 with K1), the
exact uplink rx (resample 65/96 with K1, then the exact schedule), the
rx with the streaming FEC decode, and the whole call. Eager PyTorch runs
every op it is given, so no stage's work can be dropped unseen; the
device is synchronized after each call all the same, which waits for
every output the stage produced.

    python -m openbts_ttsou_tpu_torch.tools.encode_stage_probe [--carriers 512]
"""

from __future__ import annotations

import numpy as np
import torch

from openbts_ttsou_tpu_torch.tools import common

TOOL = "encode_stage_probe"
XCCH_TNS, TCH_TNS = (0, 1, 6, 7), (2, 3, 4, 5)


def stages(c: int, dev: torch.device) -> dict:
    """name → a callable running that stage once at c carriers."""
    from openbts_ttsou_tpu_torch.gsm import l1fec
    from openbts_ttsou_tpu_torch.models import transceiver as M
    from openbts_ttsou_tpu_torch.ops import fir
    from openbts_ttsou_tpu_torch.parallel.halo import resample_block
    from openbts_ttsou_tpu_torch.trx import engine as eng

    f = 13
    cfg, spec = eng.TrxConfig(n_chan=c), M.UplinkSpec(frames=f)
    state = eng.init_state(cfg, dev)._replace(chan_type=torch.full(
        (c, 8), eng.ChanType.I, dtype=torch.int32, device=dev))
    rng = np.random.default_rng(0)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    nx, nt, gt = len(XCCH_TNS), len(TCH_TNS), 3
    frames184 = put(rng.integers(0, 2, (4, c, 8, 184)).astype(np.uint8))
    xcch_valid = put(np.ones((4, c, 8), bool))
    speech = put(rng.integers(0, 2, (gt, c, 8, 260)).astype(np.uint8))
    sp_valid = put(np.ones((gt, c, 8), bool))
    facch = put(np.zeros((gt, c, 8, 184), np.uint8))
    fa_valid = put(np.zeros((gt, c, 8), bool))
    tm = np.zeros((c, 8), bool)
    tm[:, list(TCH_TNS)] = True
    tch_mask = put(tm)
    content = (frames184, xcch_valid, speech, sp_valid, facch, fa_valid,
               tch_mask)
    carry = (l1fec.TchTxCarry.zeros(c * 8, dev), M.XcchTxCarry.zeros(c, dev))
    fn0 = torch.zeros((), dtype=torch.int32, device=dev)
    atten = torch.zeros((f, c, 8), device=dev)
    bits = put(rng.integers(0, 2, (f, c, 8, 148)).astype(np.uint8))
    valid = put(np.ones((f, c, 8), bool))
    tail = torch.zeros((c, M.TX_TAIL_SYM), dtype=torch.complex64, device=dev)
    n_ul = M.RX_HALO_DEV * 2 + spec.block_in
    ul_halo = put(((rng.standard_normal((c, n_ul))
                    + 1j * rng.standard_normal((c, n_ul))) * 10
                   ).astype(np.complex64))
    prev_soft = torch.full((M.DECODE_PRELUDE, c, 8, 148), 0.5, device=dev)
    prev_valid = torch.zeros((), dtype=torch.bool, device=dev)
    lpf_tx = fir.resampler_lpf(spec.q, spec.p, 651)
    lpf_rx = fir.resampler_lpf(spec.p, spec.q, spec.taps)
    x_sub = frames184[:, :, list(XCCH_TNS)]
    t_sp = speech[:, :, list(TCH_TNS)].reshape(gt, c * nt, 260)
    t_spv = sp_valid[:, :, list(TCH_TNS)].reshape(gt, c * nt)
    t_fa = facch[:, :, list(TCH_TNS)].reshape(gt, c * nt, 184)
    t_fav = fa_valid[:, :, list(TCH_TNS)].reshape(gt, c * nt)
    t_carry = l1fec.TchTxCarry.zeros(c * nt, dev)

    def radio_tx():
        slots = eng.tx_frames(cfg, state, bits, valid, atten)
        sym = M._assemble_stream(slots)
        return fir.polyphase_resample(torch.cat([tail, sym], -1), spec.q,
                                      spec.p, lpf_tx)

    def exact_rx():
        sym = resample_block(ul_halo, spec.p, spec.q, lpf_rx, M.RX_HALO_DEV,
                             spec.block_in)
        return M._exact_rx(cfg, f, state, sym[..., : spec.block_symbols])

    def rx_decode():
        _, res = exact_rx()
        return M.decode_block(res, fn0, f, 0, prev_soft=prev_soft,
                              prev_valid=prev_valid, xcch_tns=XCCH_TNS,
                              tch_tns=TCH_TNS, rach_tns=cfg.rach_slots)

    return {
        "xcch_encode": lambda: l1fec.xcch_encode(x_sub, tsc=None),
        "tch_tx_window": lambda: l1fec.tch_tx_window(
            t_sp, t_spv, t_fa, t_fav, t_carry, fn0, f),
        "encode_dl_window": lambda: M._encode_dl_window(
            cfg, spec, state, *content, carry[0], fn0, xcch_phase=0,
            xcch_carry=carry[1], xcch_tns=XCCH_TNS, tch_tns=TCH_TNS),
        "radio_tx": radio_tx,
        "uplink_exact_rx": exact_rx,
        "uplink_rx_plus_decode": rx_decode,
        "duplex_decoded_full": lambda: M.duplex_block_decoded(
            cfg, spec, state, ul_halo, tail, content, atten, carry, fn0,
            prev_soft, prev_valid, 0, 0, XCCH_TNS, TCH_TNS),
    }


def main(argv=None) -> dict:
    ap = common.parser(__doc__)
    ap.add_argument("--carriers", type=int, default=512)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    dev = common.device_of(args)
    rows = {}
    for name, fn in stages(args.carriers, dev).items():
        k0 = common.k1_launches()
        rows[name] = common.measure(fn, dev, reps=args.reps)
        rows[name]["k1_launches"] = common.k1_launches() - k0
        rows[name]["wall_ms_per_frame"] = rows[name]["wall_ms"] / 13
        common.log(TOOL, f"{name:24s} {rows[name]['wall_ms']:9.2f} ms wall")
    return common.emit({"tool": TOOL, "carriers": args.carriers,
                        "frames": 13, "xcch_tns": list(XCCH_TNS),
                        "tch_tns": list(TCH_TNS), "stages": rows,
                        **common.card(dev)})


if __name__ == "__main__":
    main()
