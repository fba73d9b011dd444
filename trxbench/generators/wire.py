"""The served path's traffic: the uplink air a replay radio plays to the
daemon, and the downlink bursts a BTS sends it.

Parameters (`params` of the traffic file):

* `pool`: distinct blocks in the uplink stream's period;
* `frames`: frames a block (the configuration's `frames`);
* `ul_slots`, `tsc`, `amplitude`: a normal burst of that TSC and
  amplitude on each listed slot of every frame of every carrier, its 114
  data bits drawn from the seed;
* `noise_sigma`: σ of each of I and Q of the complex Gaussian noise at
  the symbol rate;
* `dl_frames`: frames of downlink content, keyed by frame number modulo
  `dl_frames` (a divisor of the hyperframe, so the keying holds across
  its wrap): random bits on all 8 slots of every frame of every carrier.

The uplink is one periodic stream of `pool` blocks at the symbol rate,
brought to the device rate by the benchmark's own resampler as one
period of the endless stream, and rounded to the radio's int16 I/Q.
`make` returns, as `items`, one dict a block of the period: `index` and
`ul`, the int16 window [C, 96 + block_in + 96, 2] the radio gives the
daemon for any block of that index modulo `pool`, its halos taken from
the neighbouring blocks as the radio reads them. `expect` holds the
stream on the host (`stream` [C, pool·block_in, 2] int16), the downlink
content on the device (`dl_bits` [dl_frames, C, 8, 148] uint8), the
loaded uplink slots (`ul_slots`) and the uplink datagrams each block
must deliver (`per_block`).
"""

from __future__ import annotations

import torch

from trxbench import generate
from trxbench.generators import bursts
from trxbench.reference.rx import FRAME_SYMBOLS, HYPERFRAME


def block_in(frames: int) -> int:
    """Device-rate samples a carrier in a block of `frames` frames."""
    return frames * FRAME_SYMBOLS * generate.DL_P // generate.DL_Q


def halo_window(stream: torch.Tensor, index: int, frames: int
                ) -> torch.Tensor:
    """The window [C, halo + block_in + halo, 2] the radio reads for block
    `index` of a periodic stream [C, P, 2]."""
    n = block_in(frames)
    h = generate.RX_HALO_DEV
    idx = (index * n - h + torch.arange(n + 2 * h, device=stream.device)
           ) % stream.shape[1]
    return stream[:, idx].contiguous()


def make(par: dict, config: dict, seed: int, device) -> dict:
    """The uplink stream and its blocks, and the downlink content, made
    from `seed` on `device`."""
    n_chan = int(config["carriers"])
    frames = int(par["frames"])
    pool = int(par["pool"])
    dl_frames = int(par["dl_frames"])
    if frames != int(config["frames"]):
        raise ValueError(f"traffic of {frames}-frame blocks for a "
                         f"configuration of {config['frames']}")
    if HYPERFRAME % dl_frames or dl_frames % frames:
        raise ValueError(f"dl_frames {dl_frames}: not a divisor of the "
                         f"hyperframe and a multiple of {frames}")
    g = generate.generator(seed, device)
    slots = [int(t) for t in par["ul_slots"]]
    sym = bursts.uplink_symbols(
        {"frames": pool * frames, "noise_sigma": par["noise_sigma"],
         "bursts": [{"slots": slots, "tsc": int(par["tsc"]),
                     "amplitude": float(par["amplitude"])}]},
        n_chan, g, device)
    dev = generate.to_device_rate_cyclic(sym)
    del sym
    iq = torch.stack([dev.real, dev.imag], -1)
    stream = torch.clamp(torch.round(iq), -32767.0, 32767.0
                         ).to(torch.int16)
    del dev, iq
    items = [{"index": j, "ul": halo_window(stream, j, frames)}
             for j in range(pool)]
    dl_bits = torch.randint(0, 2, (dl_frames, n_chan, 8, 148), generator=g,
                            device=device, dtype=torch.uint8)
    return {"items": items,
            "expect": {"stream": stream.cpu().numpy(), "dl_bits": dl_bits,
                       "ul_slots": slots,
                       "per_block": frames * n_chan * len(slots)}}
