"""What the traffic generators share: the seeded generator on the device,
GSM's normal bursts, and the benchmark's own 96/65 resampler that brings
a symbol-rate stream to the device rate, as the radio's ADC stream would
be. Nothing here imports the program.

A traffic mix is a JSON file `trxbench/traffic/<traffic>.json` with a
`generator` key, the name of a module `trxbench/generators/<name>.py`,
and its `params`. The module's `make(params, config, seed, device)`
makes the cell's pool of inputs on the device from the seed, with
`torch.Generator` on the device and in a few large calls, and returns
`{"items": [...], "expect": ...}`: the inputs the window cycles, and what
the entry adapter's known answer expects of them (see each generator).
A new kind of traffic for an existing entry is a new generator file.
"""

from __future__ import annotations

import numpy as np
import torch

from trxbench.reference import constants as C
from trxbench.reference import fir
from trxbench.reference.rx import SLOT_SAMPLE_PATTERN

#: the device-rate stream: 96/65 of the symbol rate through 651 taps
DL_P, DL_Q, DL_TAPS = 96, 65, 651
SLOT_OFFSETS = np.concatenate([[0], np.cumsum(SLOT_SAMPLE_PATTERN)])[:-1]
#: the uplink receiver's halo a side, in device samples (the port's
#: RX_HALO_DEV: one 96-sample polyphase period)
RX_HALO_DEV = 96


def generator(seed: int, device) -> torch.Generator:
    """A generator on `device` seeded by `seed`, any whole number below
    2**64 (a negative one is taken modulo 2**64)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2 ** 64)
    return g


def normal_bursts(n: int, tsc: int, g: torch.Generator, device
                  ) -> torch.Tensor:
    """n normal bursts' bits [n, 148] uint8: tail, 57 data, steal 1, the
    TSC, steal 1, 57 data, tail (GSM 05.02 5.2.3)."""
    data = torch.randint(0, 2, (n, 114), generator=g, device=device,
                         dtype=torch.uint8)
    seq = torch.from_numpy(C.TRAINING_SEQUENCE[tsc]).to(device)
    z3 = torch.zeros((n, 3), dtype=torch.uint8, device=device)
    one = torch.ones((n, 1), dtype=torch.uint8, device=device)
    return torch.cat([z3, data[:, :57], one, seq.expand(n, -1), one,
                      data[:, 57:], z3], 1)


def noise(shape: tuple, sigma: torch.Tensor | float, g: torch.Generator,
          device) -> torch.Tensor:
    """Complex Gaussian noise of `shape` [C, T], σ (a number, or one a
    carrier [C]) in each of I and Q."""
    n = torch.randn((2,) + tuple(shape), generator=g, device=device)
    s = torch.as_tensor(sigma, dtype=torch.float32, device=device)
    if s.ndim:
        s = s[:, None]
    return torch.complex(n[0] * s, n[1] * s)


def to_device_rate(sym: torch.Tensor) -> torch.Tensor:
    """A symbol-rate stream [C, T] at the device rate, [C, T·96/65]."""
    lpf = fir.resampler_lpf(DL_P, DL_Q, DL_TAPS)
    return fir.resample(sym, DL_P, DL_Q, lpf)[:, : sym.shape[-1] * DL_P
                                              // DL_Q]


def to_device_rate_cyclic(sym: torch.Tensor) -> torch.Tensor:
    """A periodic symbol-rate stream [C, T] at the device rate, resampled
    as one period of the endless stream."""
    k = 2 * DL_Q  # cyclic context a side, a whole number of periods
    wrapped = torch.cat([sym[:, -k:], sym, sym[:, :k]], -1)
    lead = k * DL_P // DL_Q
    n = sym.shape[-1] * DL_P // DL_Q
    lpf = fir.resampler_lpf(DL_P, DL_Q, DL_TAPS)
    return fir.resample(wrapped, DL_P, DL_Q, lpf)[:, lead: lead + n]
