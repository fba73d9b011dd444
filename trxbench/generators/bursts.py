"""Normal bursts over noise: blocks of uplink IQ for a receive bank.

Parameters (`params` of the traffic file):

* `pool`: distinct blocks made, cycled by the window;
* `frames`: frames a block (13: one block of 24000 device-rate samples);
* `noise_sigma`: σ of each of I and Q of the complex Gaussian noise at
  the symbol rate;
* `bursts`: a list of normal bursts, each `{"slots": [TN, ...],
  "tsc": n, "amplitude": a, "toa_symbols": d}`: one burst a frame on each
  listed slot of every carrier, its 114 data bits drawn from the seed
  (stealing bits 1), placed `d` symbols after the slot's start.

`make` returns the blocks [C, frames·1250·96/65] complex64 as `items`
and, as `expect`, one dict a block: `detect` [frames, C, 8] bool, the
bursts the receiver has to detect.
"""

from __future__ import annotations

import numpy as np
import torch

from trxbench import generate
from trxbench.reference import gmsk
from trxbench.reference.rx import FRAME_SYMBOLS


def uplink_symbols(par: dict, n_chan: int, g: torch.Generator, device
                   ) -> torch.Tensor:
    """One block at the symbol rate, [C, frames·1250] complex64: noise
    and the listed bursts."""
    frames = int(par["frames"])
    sym = generate.noise((n_chan, frames * FRAME_SYMBOLS),
                         float(par["noise_sigma"]), g, device)
    for b in par["bursts"]:
        slots = [int(t) for t in b["slots"]]
        count = frames * n_chan * len(slots)
        bits = generate.normal_bursts(count, int(b["tsc"]), g, device)
        wave = gmsk.modulate_burst(bits, 1) * float(b["amplitude"])
        wave = wave.reshape(frames, n_chan, len(slots), 148)
        d = int(b.get("toa_symbols", 0))
        for f in range(frames):
            for k, tn in enumerate(slots):
                off = f * FRAME_SYMBOLS + int(generate.SLOT_OFFSETS[tn]) + d
                sym[:, off: off + 148] += wave[f, :, k]
    return sym


def make(par: dict, config: dict, seed: int, device) -> dict:
    """`pool` distinct blocks made from `seed` on `device`."""
    n_chan = int(config["carriers"])
    g = generate.generator(seed, device)
    items = [generate.to_device_rate(uplink_symbols(par, n_chan, g, device))
             .contiguous() for _ in range(int(par["pool"]))]
    detect = np.zeros((int(par["frames"]), n_chan, 8), bool)
    for b in par["bursts"]:
        detect[:, :, [int(t) for t in b["slots"]]] = True
    return {"items": items, "expect": [{"detect": detect}] * len(items)}
