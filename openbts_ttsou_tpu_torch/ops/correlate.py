"""Burst detection: templates, peak detection, RACH/TSC correlators.

Port of `openbts_ttsou_tpu/ops/correlate.py`. Reference behavior:
`Transceiver/sigProcLib.cpp:779-857` (templates), `:663-711`
(peakDetect + early-late sinc interpolation), `:860-932`
(detectRACHBurst, energyDetect), `:935-1037` (analyzeTrafficBurst +
channel estimation); the 52M windowed correlation
(`Transceiver52M/sigProcLib.cpp:983-1000`) through `max_toa`.

Where the JAX version builds windows from one-hot contractions (a TPU
gather workaround), this one indexes directly with `gather`; the
arithmetic on the gathered values is the same.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from openbts_ttsou_tpu_torch.ops import fir, gmsk
from openbts_ttsou_tpu_torch.utils import constants as C
from openbts_ttsou_tpu_torch.utils.tables import copy_table

PEAK_GRID_STEP = 1.0 / 1024.0  # reference precision (sigProcLib.cpp:688)
PEAK_GRID_HALF = 1024  # search ±1 sample around the integer peak
SINC_HALF_WIDTH = 10  # interpolatePoint window (sigProcLib.cpp:643-645)


# ---------------------------------------------------------------------------
# numpy-side template generation (set-up constants, like the reference's
# generateMidamble/generateRACHSequence)
# ---------------------------------------------------------------------------

def _np_modulate(bits: np.ndarray, sps: int, pulse: np.ndarray | None) -> np.ndarray:
    n = len(bits)
    x = np.zeros(sps * n, dtype=np.complex128)
    x[:: sps] = 2.0 * bits - 1.0
    x *= np.exp(1j * (np.pi / 2 / sps) * np.arange(len(x)))
    if pulse is None:
        return x
    full = np.convolve(x, pulse)
    start = len(pulse) // 2 if len(pulse) % 2 else len(pulse) // 2 - 1
    return full[start: start + len(x)]


def _np_peak(x: np.ndarray):
    """Integer+fractional peak of |x|² via dense sinc-grid refinement."""
    p = np.abs(x) ** 2
    i0 = int(np.argmax(p))
    offs = np.arange(-PEAK_GRID_HALF, PEAK_GRID_HALF + 1) * PEAK_GRID_STEP
    vals = np.zeros(len(offs), dtype=np.complex128)
    for k, off in enumerate(offs):
        ix = i0 + off
        lo = max(int(np.floor(ix)) - SINC_HALF_WIDTH, 0)
        hi = min(int(np.floor(ix)) + SINC_HALF_WIDTH + 1, len(x) - 1)
        idx = np.arange(lo, hi)
        vals[k] = np.sum(x[idx] * np.sinc(idx - ix))
    kbest = int(np.argmax(np.abs(vals) ** 2))
    return vals[kbest], i0 + offs[kbest]


@dataclasses.dataclass(frozen=True)
class CorrelationTemplate:
    """A detection template: waveform + autocorrelation gain and TOA
    (CorrelationSequence, sigProcLib.cpp:52-56)."""

    sequence: np.ndarray  # complex64 [L]
    gain: complex
    toa: float


@functools.lru_cache(maxsize=None)
def midamble_template(tsc: int, sps: int) -> CorrelationTemplate:
    """Midamble correlation template for TSC 0-7 (generateMidamble,
    sigProcLib.cpp:779-828): the middle 16 bits of the TSC with a unit
    pulse, scaled by −1; gain/TOA from its correlation against the full
    pulse-shaped midamble scaled by +j."""
    assert 0 <= tsc <= 7
    bits = C.TRAINING_SEQUENCE[tsc].astype(np.float64)
    middle = -1.0 * _np_modulate(bits[5:21], sps, None)
    midamble = 1j * _np_modulate(bits, sps,
                                 gmsk.gsm_pulse(sps).astype(np.float64))
    autocorr = np.convolve(midamble, np.conj(middle[::-1]))
    start = (len(middle) // 2) if len(middle) % 2 else (len(middle) // 2 - 1)
    autocorr = autocorr[start: start + len(midamble)]
    gain, toa = _np_peak(autocorr)
    return CorrelationTemplate(middle.astype(np.complex64), complex(gain),
                               float(toa) - 5 * sps)


@functools.lru_cache(maxsize=None)
def rach_template(sps: int) -> CorrelationTemplate:
    """RACH synch-sequence template (generateRACHSequence,
    sigProcLib.cpp:830-857)."""
    bits = C.RACH_SYNCH_SEQUENCE.astype(np.float64)
    seq = _np_modulate(bits, sps, gmsk.gsm_pulse(sps).astype(np.float64))
    autocorr = np.convolve(seq, np.conj(seq[::-1]))
    start = (len(seq) // 2) if len(seq) % 2 else (len(seq) // 2 - 1)
    autocorr = autocorr[start: start + len(seq)]
    gain, toa = _np_peak(autocorr)
    return CorrelationTemplate(seq.astype(np.complex64), complex(gain),
                               float(toa))


@functools.lru_cache(maxsize=None)
def midamble_bank(sps: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All 8 TSC templates stacked: (sequences [8, 16*sps], gains [8],
    toas [8])."""
    ts = [midamble_template(t, sps) for t in range(8)]
    return (
        np.stack([t.sequence for t in ts]),
        np.array([t.gain for t in ts], np.complex64),
        np.array([t.toa for t in ts], np.float32),
    )


# ---------------------------------------------------------------------------
# batched detectors
# ---------------------------------------------------------------------------

EARLY_LATE_STEPS = 9  # incr 0.5 … 1/512 (the while > 1/1024 loop)
_ELW = 25  # floor(ix) ∈ [i0−2, i0+1] → absolute taps i0−12 … i0+11


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx] along the last axis with zero outside [0, T)."""
    t = x.shape[-1]
    ok = (idx >= 0) & (idx < t)
    v = torch.gather(x, -1, idx.clamp(0, t - 1))
    return torch.where(ok, v, torch.zeros((), dtype=x.dtype, device=x.device))


def _abs2(x: torch.Tensor) -> torch.Tensor:
    """|x|² as the reference computes it: the modulus, squared."""
    return x.abs() ** 2


def peak_detect(x: torch.Tensor):
    """Batched peak detection with fractional refinement.

    x: [..., T] complex. Returns (peak_val complex64 [...], peak_idx
    float32 [...], avg_pwr float32 [...]). peakDetect
    (sigProcLib.cpp:663-711): the first integer argmax of |x|², then the
    reference's early-late sinc-balancing descent to 1/1024 sample as 9
    fixed halving steps with a done-mask for its `break` on e2 == l2.
    Every interpolatePoint (21 taps over [⌊ix⌋−10, min(⌊ix⌋+11, T−1)),
    the upper bound excluding the last sample as the reference does)
    reads one 25-sample window around the argmax, zero outside the burst.
    avg power excludes the interpolated peak.
    """
    t = x.shape[-1]
    xr = x.real.to(torch.float32)
    xi = x.imag.to(torch.float32)
    p = xr * xr + xi * xi
    i0 = torch.argmax(p, dim=-1)  # first maximum
    sum_power = p.sum(-1)

    half = (_ELW - 1) // 2  # 12
    offs = torch.arange(_ELW, device=x.device)
    j_idx = i0[..., None] - half + offs  # [..., 25]
    win_r = _take(xr, j_idx)
    win_i = _take(xi, j_idx)
    j_abs = j_idx.to(torch.float32)

    def interp(ix):
        fl = torch.floor(ix)[..., None]
        lo = torch.clamp(fl - SINC_HALF_WIDTH, min=0.0)
        hi = torch.clamp(fl + SINC_HALF_WIDTH + 1.0, max=float(t - 1))
        taps = torch.sinc(j_abs - ix[..., None])
        taps = torch.where((j_abs >= lo) & (j_abs < hi), taps, 0.0)
        return (win_r * taps).sum(-1), (win_i * taps).sum(-1)

    early = i0.to(torch.float32) - 1.0
    done = torch.zeros(x.shape[:-1], dtype=torch.bool, device=x.device)
    incr = 0.5
    for _ in range(EARLY_LATE_STEPS):
        er, ei = interp(early)
        lr, li = interp(early + 2.0)
        e2 = er * er + ei * ei
        l2 = lr * lr + li * li
        step = torch.where(e2 < l2, incr, -incr)
        done = done | (e2 == l2)  # the reference's `else break`
        early = torch.where(done, early, early + step)
        incr *= 0.5
    peak_idx = early + 1.0
    vr, vi = interp(peak_idx)
    peak_val = torch.complex(vr, vi)
    avg_pwr = (sum_power - (vr * vr + vi * vi)) / (t - 1)
    return peak_val, peak_idx, avg_pwr


def energy_detect(x: torch.Tensor, window: int, threshold):
    """(detected bool [...], avg_pwr f32 [...]): mean power over the first
    `window` samples vs threshold² (energyDetect, sigProcLib.cpp:916-932)."""
    w = min(window, x.shape[-1])
    avg = _abs2(x[..., :w]).mean(-1)
    if isinstance(threshold, torch.Tensor):
        thr = threshold.to(device=x.device, dtype=torch.float32)
    else:
        thr = copy_table(threshold, x.device, torch.float32)
    return avg > thr * thr, avg


@dataclasses.dataclass
class Detection:
    """Batched detection result (all fields [...])."""

    detected: torch.Tensor  # bool
    amplitude: torch.Tensor  # complex64 — peak / template gain
    toa: torch.Tensor  # float32 — samples, template-compensated
    peak_to_mean: torch.Tensor  # float32


def _valley_power(corr: torch.Tensor, peak_int: torch.Tensor,
                  offsets: np.ndarray):
    """Σ|corr[peak+o]|² over the offsets that fall inside the burst, and
    their count. A peak outside [0, T) gives (0, 0), as the reference
    form's position table does."""
    t = corr.shape[-1]
    p2 = _abs2(corr)
    o = copy_table(offsets, corr.device)
    idx = peak_int[..., None].to(torch.int64) + o
    ok = (idx >= 0) & (idx < t)
    inside = ((peak_int >= 0) & (peak_int < t))[..., None]
    ok = ok & inside
    vals = torch.gather(p2, -1, idx.clamp(0, t - 1))
    power = torch.where(ok, vals, 0.0).sum(-1)
    count = ok.sum(-1).to(torch.float32)
    return power, count


def detect_rach(burst: torch.Tensor, sps: int,
                threshold: float = C.RACH_DETECT_THRESHOLD) -> Detection:
    """Batched RACH burst detection (detectRACHBurst,
    sigProcLib.cpp:860-914): correlate against the RACH synch template,
    peak-detect, test peak/RMS over the valley (symbols 57-107 after the
    peak). TOA is compensated by the template TOA + 8 symbols."""
    tmpl = rach_template(sps)
    seq = copy_table(tmpl.sequence, burst.device)
    corr = fir.correlate(burst, seq, fir.NO_DELAY)
    peak_val, peak_idx, _ = peak_detect(corr)
    peak_int = torch.round(peak_idx).to(torch.int32)

    offsets = np.arange(57 * sps, 107 * sps + 1)
    valley, count = _valley_power(corr, peak_int, offsets)
    rms = torch.sqrt(valley / torch.clamp(count, min=1.0)) + 1e-5
    peak_to_mean = peak_val.abs() / rms

    t = corr.shape[-1]
    ok = (peak_idx >= 0) & (peak_idx <= t) & (count >= 2)
    detected = ok & (peak_to_mean > threshold)
    gain = copy_table(tmpl.gain, burst.device, torch.complex64)
    amplitude = torch.where(ok, peak_val / gain, 0.0).to(torch.complex64)
    toa = peak_idx - np.float32(tmpl.toa) - 8 * sps
    return Detection(detected, amplitude, toa, peak_to_mean)


# Normal-burst correlation geometry (analyzeTrafficBurst,
# sigProcLib.cpp:951,1000)
TSC_SEGMENT_START = 56
TSC_SEGMENT_LEN = 36
TSC_SEGMENT_OFFSET = 10  # (66 − 56) symbols
TSC_PEAK_SYMBOL = 8  # the 52M expectedTOAPeak (Transceiver52M/sigProcLib.cpp:992)


def analyze_traffic_burst(burst: torch.Tensor, tsc, sps: int,
                          threshold: float = C.TSC_DETECT_THRESHOLD,
                          estimate_channel: bool = False,
                          chan_taps_symbols: int = 6,
                          max_toa: int | None = None,
                          gate_estimation: bool | None = None):
    """Batched normal-burst midamble detection + channel estimation
    (analyzeTrafficBurst, sigProcLib.cpp:935-1037).

    burst: [..., T] complex; tsc: int or int tensor [...] per burst.
    Returns (Detection, channel_response [..., chan_taps_symbols*sps] or
    None, chan_resp_offset [...] or None).

    max_toa (samples) selects the 52M windowed correlation: the value is
    clamped to ≥3·sps, the segment spans 66±max(maxTOA, 5·sps) symbols
    and only the 2·maxTOA+1 lags around the expected peak are searched.
    None keeps the 64M full-segment geometry (±10-symbol span).

    gate_estimation: when given and False, the channel-estimation tail is
    skipped and zeros returned (the reference estimates only when a slot
    needs a DFE re-estimate, Transceiver.cpp:311-330).
    """
    seqs, gains, toas = midamble_bank(sps)
    dev = burst.device
    lead = burst.shape[:-1]
    if isinstance(tsc, (int, np.integer)):
        seq = copy_table(seqs[tsc], dev).expand(lead + seqs.shape[-1:])
        gain = copy_table(complex(gains[tsc]), dev, torch.complex64)
        tmpl_toa = copy_table(float(toas[tsc]), dev, torch.float32)
    else:
        tsc = tsc.to(torch.int64)
        seq = copy_table(seqs, dev)[tsc]  # [..., L]
        gain = copy_table(gains, dev)[tsc]
        tmpl_toa = copy_table(toas, dev)[tsc]

    if max_toa is None:
        span = TSC_SEGMENT_OFFSET * sps  # the 64M fixed ±10-symbol span
        mt = span
    else:
        # maxTOA < 3*sps → 3*sps; spanTOA ≥ 5*sps
        # (Transceiver52M/sigProcLib.cpp:982-985)
        mt = max(int(max_toa), 3 * sps)
        span = max(mt, 5 * sps)
    seg = burst[..., 66 * sps - span: (66 + 16) * sps + span]
    corr = fir.correlate(seg, seq, fir.NO_DELAY)
    if max_toa is not None:
        center = TSC_PEAK_SYMBOL * sps + span
        corr = corr[..., center - mt: center + mt + 1]
    peak_val, peak_idx, _ = peak_detect(corr)
    peak_int = torch.round(peak_idx).to(torch.int32)

    # Valley: ±(2..5) symbols around the peak (sigProcLib.cpp:970-980).
    offs = np.arange(2 * sps, 5 * sps + 1)
    offsets = np.concatenate([-offs[::-1], offs])
    valley, count = _valley_power(corr, peak_int, offsets)
    rms = torch.sqrt(valley / torch.clamp(count, min=1.0)) + 1e-5
    peak_to_mean = peak_val.abs() / rms

    t = corr.shape[-1]
    ok = (peak_idx >= 0) & (peak_idx <= t) & (count >= 2)
    detected = ok & (peak_to_mean > threshold)
    amplitude = torch.where(ok, peak_val / gain, 0.0).to(torch.complex64)
    if max_toa is None:
        toa = peak_idx - tmpl_toa - span
    else:
        toa = peak_idx - mt - (tmpl_toa - TSC_PEAK_SYMBOL * sps)
    det = Detection(detected, amplitude, toa, peak_to_mean)
    if not estimate_channel:
        return det, None, None

    nw = chan_taps_symbols * sps
    if gate_estimation is not None and not gate_estimation:
        return (det, torch.zeros(lead + (nw,), dtype=torch.complex64,
                                 device=dev),
                torch.zeros(lead, dtype=torch.float32, device=dev))
    if max_toa is None:
        toa_offset = torch.broadcast_to(tmpl_toa + span, lead)
    else:
        # TOAoffset = maxTOA exactly (Transceiver52M/sigProcLib.cpp:1046)
        toa_offset = torch.full(lead, float(mt), dtype=torch.float32,
                                device=dev)
    chan, chan_offset = _estimate_channel(corr, toa, gain, toa_offset, nw,
                                          sps)
    return det, chan, chan_offset


def _estimate_channel(corr, toa, gain, toa_offset, nw, sps):
    """The channel-estimation tail of analyze_traffic_burst
    (sigProcLib.cpp:1005-1031): un-delay the correlation, slide an
    nw-sample window over 7 candidate starts, keep the last window whose
    energy exceeds 95% of the running max."""
    t = corr.shape[-1]
    corr_d = gmsk.delay_vector(corr, -toa)
    # window starts: floor(toa_offset + (i−5)*sps), i = 0..6
    starts = (torch.floor(toa_offset).to(torch.int64)[..., None]
              + (torch.arange(7, device=corr.device) - 5) * sps)
    in_range = (starts >= 0) & (starts + nw <= t)  # [..., 7]
    idx = starts[..., None] + torch.arange(nw, device=corr.device)
    lead = corr_d.shape[:-1]
    wins = _take(corr_d, idx.reshape(lead + (-1,))).reshape(lead + (7, nw))
    energies = torch.where(in_range, _abs2(wins).sum(-1), -torch.inf)

    max_e = torch.full(lead, -torch.inf, device=corr.device)
    max_i = torch.full(lead, -1, dtype=torch.int32, device=corr.device)
    for i in range(7):
        e = energies[..., i]
        take = e > 0.95 * max_e
        max_e = torch.where(take, torch.maximum(e, max_e), max_e)
        max_i = torch.where(take, i, max_i)

    # max_i = −1 (no window in range) picks window 6, offset 5·sps + 1,
    # as the reference's floor-mod indexing does
    pick = (max_i % 7).to(torch.int64)
    chan = torch.gather(wins, -2, pick[..., None, None].expand(
        lead + (1, nw)))[..., 0, :]
    chan = chan / (gain[..., None] if gain.ndim else gain)
    chan_offset = (5 * sps - max_i).to(torch.float32)
    return chan.to(torch.complex64), chan_offset
