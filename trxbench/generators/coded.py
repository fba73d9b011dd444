"""Coded content both ways: windows for a layer 1 with FEC.

Parameters (`params` of the traffic file):

* `windows`: the period, in 13-frame windows, of both directions'
  content (8 windows are 104 frames, a multiple of 4, 13 and 26 that
  divides the hyperframe, so the stream repeats with every interleaved
  block whole);
* `fn0`: the first window's frame number;
* `facch_share`: the share of TCH dispatches that carry FACCH instead
  of speech;
* `uplink`: `amplitude` and `noise_sigma` of the uplink, and `weak`:
  `{"every": k, "noise_sigma": s}`, every k-th carrier (k − 1, 2k − 1,
  ...) received at noise σ `s` instead, near the receiver's sensitivity,
  where the decoder corrects errors and some frames fail.

The slot split (`xcch_tns`, `tch_tns`), the carriers and the TSC come
from the configuration. Each window's content on each carrier: an L2
frame (184 bits) at every XCCH group start the window holds, on every
XCCH slot; on every TCH slot and dispatch, speech (260 bits) or FACCH
(184 bits). The uplink is the same kind of content, drawn apart, coded
by the reference coder (`trxbench/reference/tx.py`), at `amplitude` over
noise, made periodic by coding two periods from empty carries and
keeping the second, and resampled cyclically.

`make` returns `windows` items (uplink window with its halos [C, 24000 +
2·96] complex64, downlink content 7-tuple) and, as `expect`,
`uplink_content` (the uplink's content a window) and `clean` [C] bool:
the carriers received well above sensitivity, on which every frame sent
is decoded.
"""

from __future__ import annotations

import numpy as np
import torch

from trxbench import generate
from trxbench.reference import coding
from trxbench.reference import tx as reftx


def window_content(par: dict, n_chan: int, fn: int, g: torch.Generator,
                   device) -> tuple:
    """One window's 7-tuple (frames184 [4, C, 8, 184], xcch_valid,
    speech [3, C, 8, 260], sp_valid, facch [3, C, 8, 184], fa_valid,
    tch_mask [C, 8]) for the window starting at frame `fn`."""
    c = n_chan
    xt, tt = list(par["xcch_tns"]), list(par["tch_tns"])
    nd = int(coding._tch_tx_tables(13)[2][fn % 26])
    ng = len(range((-fn) % 4, 13, 4))

    def bits(shape):
        return torch.randint(0, 2, shape, generator=g, device=device,
                             dtype=torch.uint8)

    def lane(shape, n, tns, fill_bits):
        out = torch.zeros(shape, dtype=torch.uint8, device=device)
        out[:n, :, tns] = fill_bits
        return out

    x = lane((4, c, 8, 184), ng, xt, bits((ng, c, len(xt), 184)))
    xv = torch.zeros((4, c, 8), dtype=torch.bool, device=device)
    xv[:ng, :, xt] = True
    use_f = torch.rand((nd, c, len(tt)), generator=g, device=device) \
        < float(par["facch_share"])
    fa = lane((3, c, 8, 184), nd, tt, bits((nd, c, len(tt), 184)))
    sp = lane((3, c, 8, 260), nd, tt, bits((nd, c, len(tt), 260)))
    fav = torch.zeros((3, c, 8), dtype=torch.bool, device=device)
    spv = torch.zeros((3, c, 8), dtype=torch.bool, device=device)
    fav[:nd, :, tt] = use_f
    spv[:nd, :, tt] = ~use_f
    tch_mask = torch.zeros((c, 8), dtype=torch.bool, device=device)
    tch_mask[:, tt] = True
    return (x, xv, sp, spv, fa, fav, tch_mask)


def weak_carriers(par: dict, n_chan: int) -> np.ndarray:
    """[C] bool: the carriers received near sensitivity."""
    weak = par["uplink"].get("weak")
    out = np.zeros(n_chan, bool)
    if weak:
        out[int(weak["every"]) - 1:: int(weak["every"])] = True
    return out


def coded_uplink(par: dict, contents: list, tsc: torch.Tensor,
                 g: torch.Generator, device) -> list[torch.Tensor]:
    """The periodic uplink of `contents` (one a window): each window's
    device-rate samples with RX_HALO_DEV of the cyclic stream a side,
    [C, 24000 + 2·96] complex64."""
    w, c = len(contents), contents[0][0].shape[1]
    xt, tt = tuple(par["xcch_tns"]), tuple(par["tch_tns"])
    fn0 = int(par["fn0"])
    tch = coding.TchTxCarry.zeros(c * 8, device)
    xcch = reftx.xcch_carry_zeros(c, device)
    kept_bits, kept_valid = [], []
    for k in range(2 * w):  # the second period runs from steady carries
        b, v, tch, xcch = reftx.encode_window(
            contents[k % w], tch, xcch, fn0 + 13 * k, tsc, xt, tt)
        if k >= w:
            kept_bits.append(b)
            kept_valid.append(v)
    up = par["uplink"]
    quiet = torch.zeros((c, 8, 157), dtype=torch.complex64, device=device)
    slots = reftx.tx_frames(torch.cat(kept_bits), torch.cat(kept_valid),
                            float(up["amplitude"]), quiet)
    sym = reftx.assemble(slots)  # [C, w·13·1250]
    sigma = np.full(c, float(up["noise_sigma"]), np.float32)
    if up.get("weak"):
        sigma[weak_carriers(par, c)] = float(up["weak"]["noise_sigma"])
    sym = sym + generate.noise(tuple(sym.shape), torch.from_numpy(sigma),
                               g, device)
    stream = generate.to_device_rate_cyclic(sym)
    h = generate.RX_HALO_DEV
    ext = torch.cat([stream[:, -h:], stream, stream[:, :h]], -1)
    block = stream.shape[-1] // w
    return [ext[:, i * block: (i + 1) * block + 2 * h].contiguous()
            for i in range(w)]


def make(par: dict, config: dict, seed: int, device) -> dict:
    """`windows` windows of both directions, made from `seed` on
    `device`."""
    n_chan = int(config["carriers"])
    par = dict(par, xcch_tns=tuple(config["xcch_tns"]),
               tch_tns=tuple(config["tch_tns"]))
    tsc = torch.full((n_chan,), int(config["tsc"]), dtype=torch.int32,
                     device=device)
    g = generate.generator(seed, device)
    w, fn0 = int(par["windows"]), int(par["fn0"])
    dl = [window_content(par, n_chan, fn0 + 13 * k, g, device)
          for k in range(w)]
    ul_content = [window_content(par, n_chan, fn0 + 13 * k, g, device)
                  for k in range(w)]
    ul = coded_uplink(par, ul_content, tsc, g, device)
    return {"items": list(zip(ul, dl)),
            "expect": {"uplink_content": ul_content,
                       "clean": ~weak_carriers(par, n_chan)}}
