"""K1 against a float64 ground truth, on the card.

Runs the hand-written kernel and its plain float32 form
(`cuda_fir.polyphase_resample_plain`) at the uplink shape (65/96, 961
taps, 24000 samples a row) and the downlink shape (96/65, 651 taps,
16250 samples a row) and holds both against the resampler computed in
float64 with numpy. Both sum the same float32 products in different
orders, so their largest errors are rounding noise of one size: the
kernel passes when its largest error is at most twice the plain form's.
On the CPU the port resamples with the plain form, and the record holds
that alone.

    python -m openbts_ttsou_tpu_torch.tools.kernel_probe [--rows 64]
"""

from __future__ import annotations

import numpy as np
import torch

from openbts_ttsou_tpu_torch.tools import common

TOOL = "kernel_probe"
#: (name, p, q, taps, T): the uplink's and the downlink's geometry
SHAPES = (("uplink", 65, 96, 961, 24000), ("downlink", 96, 65, 651, 16250))


def truth(x: np.ndarray, p: int, q: int, lpf: np.ndarray) -> np.ndarray:
    """float64 polyphase resampling of x [rows, T] (the function K1
    computes), cycle by cycle against the dense filter bank."""
    from openbts_ttsou_tpu_torch.ops import fir

    _, _, _, _, k_prime, pad_left = fir._polyphase_plan(p, q, len(lpf))
    bank = fir._polyphase_filter_bank(p, q, np.asarray(lpf))[:, 0, :].T
    n_out = fir.polyphase_output_len(x.shape[-1], p, q)
    m_cycles = -(-n_out // p)
    xp = np.pad(x.astype(np.complex128),
                ((0, 0), (pad_left, m_cycles * q + k_prime)))
    out = np.zeros((x.shape[0], m_cycles * p), np.complex128)
    bank64 = bank.astype(np.float64)
    for m in range(m_cycles):
        out[:, m * p: (m + 1) * p] = xp[:, m * q: m * q + k_prime] @ bank64
    return out[:, :n_out]


def probe(name: str, p: int, q: int, taps: int, t_in: int, rows: int,
          dev: torch.device) -> dict:
    from openbts_ttsou_tpu_torch.ops import cuda_fir, fir

    rng = np.random.default_rng(t_in)
    x = (rng.standard_normal((rows, t_in))
         + 1j * rng.standard_normal((rows, t_in))).astype(np.complex64)
    lpf = fir.resampler_lpf(p, q, taps)
    want = truth(x, p, q, lpf)
    scale = float(np.abs(want).max())
    xd = torch.from_numpy(x).to(dev)
    torch.backends.cuda.matmul.allow_tf32 = False

    def err(y: torch.Tensor) -> dict:
        d = np.abs(y.cpu().numpy().astype(np.complex128) - want)
        return {"max_abs_err": float(d.max()),
                "max_rel_err": float(d.max()) / scale,
                "rms_err": float(np.sqrt(np.mean(d ** 2)))}

    rec = {"shape": name, "geometry": f"{p}/{q} {taps} taps [{rows}, {t_in}]",
           "max_abs_truth": scale,
           "plain": err(cuda_fir.polyphase_resample_plain(xd, p, q, lpf))}
    if dev.type == "cuda":
        rec["kernel"] = err(cuda_fir.polyphase_resample_cuda(xd, p, q, lpf))
        rec["ok"] = (rec["kernel"]["max_abs_err"]
                     <= 2 * rec["plain"]["max_abs_err"])
    else:
        rec["kernel"] = None
    return rec


def main(argv=None) -> dict:
    ap = common.parser(__doc__)
    ap.add_argument("--rows", type=int, default=64)
    ap.add_argument("--shapes", default="uplink,downlink",
                    help="comma-separated subset of uplink,downlink")
    args = ap.parse_args(argv)
    dev = common.device_of(args)
    want = args.shapes.split(",")
    rows = [probe(*s, args.rows, dev) for s in SHAPES if s[0] in want]
    ok = all(r.get("ok", True) for r in rows)
    rec = common.emit({"tool": TOOL, "ok": ok, "rows": rows,
                       **common.card(dev)})
    if not ok:
        raise RuntimeError(f"K1's error exceeds twice the plain form's: "
                           f"{rows}")
    return rec


if __name__ == "__main__":
    main()
