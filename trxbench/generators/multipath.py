"""Normal bursts through a multipath channel, and access bursts: blocks
of uplink IQ for a receive bank whose equalizer and RACH path are on.

Parameters (`params` of the traffic file):

* `pool`: distinct blocks made, cycled by the window;
* `frames`: frames a block (13: one block of 24000 device-rate samples);
* `noise_sigma`: σ of each of I and Q of the complex Gaussian noise at
  the symbol rate;
* `amplitude`: every burst's amplitude, the channel's total power 1;
* `tsc`: the normal bursts' training sequence;
* `los_slots`: slots with one TSC normal burst a frame over one path at
  TOA 0, made by `bursts.py`;
* `multipath_slots`: slots with one TSC normal burst a frame through
  the `profile`: `delays_us` and `powers_db`, one tap each, the powers
  normalised to a total of 1, one phase a tap drawn from the seed for
  each (block, carrier, slot) and held over the block's frames;
* `rach`: `slot`, `frames` (the frames of a block that carry an access
  burst on that slot), `toa_max_symbols` (each burst's TOA uniform in
  0 to it, in 1/16 symbol steps, from the seed) and
  `detect_toa_max_symbols` (the TOA up to which the receiver has to
  detect the burst and flag it as RACH).

Every other burst is modulated at 16 samples a symbol
(`reference/gmsk.modulate_burst`); each path, or an access burst's TOA,
delays it by a whole number of those samples, the paths are summed and
every 16th sample is kept. Scaled so that one path at delay 0 gives the
burst `bursts.py` modulates at one sample a symbol.

`make` returns the blocks [C, frames·1250·96/65] complex64 as `items`
and, as `expect`, one dict a block: `detect` [frames, C, 8] bool (the
line-of-sight bursts and the access bursts with TOA up to
`detect_toa_max_symbols`) and `rach` [frames, C, 8] bool (those access
bursts). The multipath bursts and the later access bursts are held by
the comparison with the reference alone.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from trxbench import generate
from trxbench.generators import bursts
from trxbench.reference import constants as C
from trxbench.reference import gmsk
from trxbench.reference.rx import FRAME_SYMBOLS

#: samples a symbol the paths and TOAs are built at
OVERSAMPLE = 16
#: the GSM symbol period, µs (13/48 MHz)
SYMBOL_US = 48.0 / 13.0
#: bursts modulated at once (the convolution holds [n, 16·148, 33])
CHUNK = 512
#: extended tail bits of an access burst (GSM 05.02 5.2.7)
ACCESS_TAIL = np.array([0, 0, 1, 1, 1, 0, 1, 0], np.uint8)


def tap_delays(delays_us) -> list[int]:
    """Each path's delay in 1/OVERSAMPLE symbol, rounded."""
    return [round(d / SYMBOL_US * OVERSAMPLE) for d in delays_us]


def tap_powers(powers_db) -> np.ndarray:
    """Each path's power, the total 1."""
    p = 10.0 ** (np.asarray(powers_db, np.float64) / 10.0)
    return p / p.sum()


def unit_scale() -> float:
    """What makes a burst modulated at OVERSAMPLE samples a symbol, kept
    at every OVERSAMPLE-th sample, the burst modulated at one: the ratio
    of the two pulses at their centres."""
    return float(gmsk.gsm_pulse(1)[1]) / float(
        gmsk.gsm_pulse(OVERSAMPLE)[OVERSAMPLE])


def through_paths(bits: torch.Tensor, delays: list[int],
                  gains: torch.Tensor) -> torch.Tensor:
    """Bursts' bits [N, B] through the paths: delays (1/OVERSAMPLE
    symbol) and complex gains [N, K] → [N, L] at the symbol rate, L the
    bursts' symbols with the longest delay's. Scaled by `unit_scale`."""
    n, nb = bits.shape
    d_max = max(delays)
    length = -(-(nb * OVERSAMPLE + d_max) // OVERSAMPLE)
    out = torch.zeros((n, length), dtype=torch.complex64, device=bits.device)
    for i in range(0, n, CHUNK):
        wave = gmsk.modulate_burst(bits[i: i + CHUNK], OVERSAMPLE)
        # sample m of the burst at index m + d_max, zeros around it
        padded = torch.zeros((len(wave), d_max + length * OVERSAMPLE),
                             dtype=wave.dtype, device=wave.device)
        padded[:, d_max: d_max + wave.shape[-1]] = wave
        acc = out[i: i + CHUNK]
        for k, d in enumerate(delays):
            kept = padded[:, d_max - d:: OVERSAMPLE][:, :length]
            acc += gains[i: i + CHUNK, k, None] * kept
    return out * unit_scale()


def access_bursts(n: int, g: torch.Generator, device) -> torch.Tensor:
    """n access bursts' bits [n, 88]: extended tail, the synch sequence,
    36 bits from the seed, tail (GSM 05.02 5.2.7)."""
    data = torch.randint(0, 2, (n, 36), generator=g, device=device,
                         dtype=torch.uint8)
    head = torch.from_numpy(np.concatenate(
        [ACCESS_TAIL, C.RACH_SYNCH_SEQUENCE])).to(device)
    z3 = torch.zeros((n, 3), dtype=torch.uint8, device=device)
    return torch.cat([head.expand(n, -1), data, z3], 1)


def _add(sym: torch.Tensor, wave: torch.Tensor, frame: int, tn: int,
         shift: torch.Tensor | None = None) -> None:
    """sym[c, slot start + shift[c] + i] += wave[c, i] (shift 0 where
    None)."""
    base = frame * FRAME_SYMBOLS + int(generate.SLOT_OFFSETS[tn])
    if shift is None:
        sym[:, base: base + wave.shape[-1]] += wave
        return
    idx = base + shift.reshape(-1, 1) + torch.arange(wave.shape[-1],
                                                     device=sym.device)
    # on float planes, each index once a row: exact in any order
    planes = torch.view_as_real(sym)
    planes.scatter_add_(1, idx[..., None].expand(-1, -1, 2),
                        torch.view_as_real(wave))


def block(par: dict, n_chan: int, g: torch.Generator, device
          ) -> tuple[torch.Tensor, np.ndarray]:
    """One block at the symbol rate, [C, frames·1250] complex64, and the
    access bursts' TOAs [len(rach frames), C] in 1/OVERSAMPLE symbol."""
    frames = int(par["frames"])
    amp = float(par["amplitude"])
    tsc = int(par["tsc"])
    # the noise and the line-of-sight bursts as `bursts.py` makes them
    sym = bursts.uplink_symbols(
        {"frames": frames, "noise_sigma": par["noise_sigma"],
         "bursts": [{"slots": par["los_slots"], "tsc": tsc,
                     "amplitude": amp}]}, n_chan, g, device)

    mp = [int(t) for t in par["multipath_slots"]]
    prof = par["profile"]
    delays = tap_delays(prof["delays_us"])
    power = torch.from_numpy(np.sqrt(tap_powers(prof["powers_db"]))
                             .astype(np.float32)).to(device)
    phase = torch.rand((n_chan, len(mp), len(delays)), generator=g,
                       device=device) * (2.0 * math.pi)
    gains = torch.polar(power.expand_as(phase), phase)  # [C, S, K]
    bits = generate.normal_bursts(frames * n_chan * len(mp), tsc, g, device)
    gains = gains.expand(frames, -1, -1, -1).reshape(-1, len(delays))
    wave = through_paths(bits, delays, gains) * amp
    wave = wave.reshape(frames, n_chan, len(mp), -1)
    for f in range(frames):
        for k, tn in enumerate(mp):
            _add(sym, wave[f, :, k], f, tn)

    ra = par["rach"]
    ra_frames = [int(f) for f in ra["frames"]]
    top = int(round(float(ra["toa_max_symbols"]) * OVERSAMPLE))
    toa = torch.randint(0, top + 1, (len(ra_frames), n_chan), generator=g,
                        device=device)
    bits = access_bursts(len(ra_frames) * n_chan, g, device)
    # each burst one path, delayed by its TOA's fraction of a symbol at
    # OVERSAMPLE samples a symbol and placed at its whole symbols
    frac = F.one_hot(toa.reshape(-1) % OVERSAMPLE, OVERSAMPLE)
    wave = through_paths(bits, list(range(OVERSAMPLE)),
                         frac.to(torch.complex64)) * amp
    wave = wave.reshape(len(ra_frames), n_chan, -1)
    for i, f in enumerate(ra_frames):
        _add(sym, wave[i], f, int(ra["slot"]), toa[i] // OVERSAMPLE)
    return sym, toa.cpu().numpy()


def make(par: dict, config: dict, seed: int, device) -> dict:
    """`pool` distinct blocks made from `seed` on `device`."""
    n_chan = int(config["carriers"])
    frames = int(par["frames"])
    g = generate.generator(seed, device)
    ra = par["rach"]
    near = int(round(float(ra["detect_toa_max_symbols"]) * OVERSAMPLE))
    items, expect = [], []
    for _ in range(int(par["pool"])):
        sym, toa = block(par, n_chan, g, device)
        items.append(generate.to_device_rate(sym).contiguous())
        rach = np.zeros((frames, n_chan, 8), bool)
        rach[[int(f) for f in ra["frames"]], :, int(ra["slot"])] = toa <= near
        detect = rach.copy()
        detect[:, :, [int(t) for t in par["los_slots"]]] = True
        expect.append({"detect": detect, "rach": rach})
    return {"items": items, "expect": expect}
