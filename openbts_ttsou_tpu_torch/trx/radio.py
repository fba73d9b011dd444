"""Radio device abstraction: loopback and IQ-replay backends.

The reference hides the RF hardware behind `USRPDevice`, with a
compile-time `SWLOOPBACK` fake (Transceiver52M/USRPDevice.h:90-98) that
replaces the USRP with a timestamped memory buffer. Here the radio is a
runtime-pluggable object with the same contract: timestamped sample
reads/writes at the device rate.

`LoopbackRadio` wires Tx to Rx through the native timestamped sample
ring (optionally with a delay and gain), so a full transceiver can run
with no hardware — the moral equivalent of SWLOOPBACK.
`ReplayRadio` plays a recorded IQ capture (BASELINE's "recorded IQ"
parity path).

NumPy only: the port's own copy of `openbts_ttsou_tpu/trx/radio.py`, on
the port's `runtime` and `rfx900`.
"""

from __future__ import annotations

import numpy as np

# Device clocking constants (USRPDevice.cpp:54,151-152): the 52M USRP
# divides a 52 MHz master clock by 192 to hit the GSM symbol rate
# exactly; the 64M classic divides 64 MHz by 160 to 400 kS/s and the
# host resamples 65/96.
MASTER_CLOCK_52M = 52e6
DECIM_52M = 192
MASTER_CLOCK_64M = 64e6
DECIM_64M = 160
DEVICE_RATE_64M = MASTER_CLOCK_64M / DECIM_64M  # 400 kS/s


class Radio:
    """Device contract (subset of USRPDevice's surface,
    Transceiver52M/USRPDevice.h:50-88)."""

    sample_rate: float = 1625e3 / 6.0
    #: Tx→Rx timebase offset in samples, the analogue of the reference's
    #: ping-measured `timestampOffset` (+ the empirical PINGOFFSET=272,
    #: USRPDevice.h:86, USRPDevice.cpp:318-460). Hardware-backed
    #: devices measure it with `update_alignment`.
    timestamp_offset: int = 0

    def start(self) -> bool:
        return True

    def stop(self) -> bool:
        return True

    def read_samples(self, n: int, ts: int) -> np.ndarray:
        """complex64 [n] at timestamp ts."""
        raise NotImplementedError

    def write_samples(self, iq: np.ndarray, ts: int) -> int:
        raise NotImplementedError

    #: Digital mixer shifts left over after the analog frequency plan
    #: (the reference hands `wFreq-actFreq` to the DUC/DDC,
    #: Transceiver/USRPDevice.cpp:527,540). Loopback/replay radios have
    #: no synthesizer, so the base class keeps these 0 and tuning is a
    #: no-op accept; only `SynthRadioMixin` (hardware-plan) backends
    #: compute a plan and record residuals.
    tx_residual_hz: float = 0.0
    rx_residual_hz: float = 0.0

    def set_tx_freq(self, freq: float) -> bool:
        """Tune the transmitter. Hardware-free backends accept any
        frequency and keep the residual 0 (no analog LO exists, so the
        loopback path must not be shifted)."""
        return True

    def set_rx_freq(self, freq: float) -> bool:
        return True

    def update_alignment(self, ts: int = 0, probe_len: int = 256) -> int:
        """Measure the Tx→Rx timestamp offset with an impulse ping and
        record it (USRPDevice::updateAlignment, USRPDevice.cpp:518, and
        the USRPping diagnostic): write a unit impulse at `ts`, read the
        window back, and locate the peak. Returns the measured offset in
        samples (also stored in `timestamp_offset`)."""
        probe = np.zeros(probe_len, np.complex64)
        probe[0] = 1.0 + 0.0j
        self.write_samples(probe, ts)
        echo = self.read_samples(probe_len, ts)
        peak = int(np.argmax(np.abs(echo)))
        if abs(echo[peak]) == 0:
            return self.timestamp_offset  # no loopback path
        self.timestamp_offset = peak
        return peak


class SynthRadioMixin:
    """Tuning policy for radios with a real RFX900-class synthesizer:
    run the integer-N plan (compute_regs analogue) and record the
    residual the DUC/DDC must absorb (the reference's
    `set_tx_freq(0, wFreq-actFreq)`, Transceiver/USRPDevice.cpp:527,540).
    A hardware backend mixes this in front of `Radio` and applies
    `tx_residual_hz`/`rx_residual_hz` in its digital NCO."""

    def set_tx_freq(self, freq: float) -> bool:
        from openbts_ttsou_tpu_torch.trx import rfx900

        try:
            self.tx_residual_hz = rfx900.tune_tx(freq).residual
        except ValueError:
            return False
        return True

    def set_rx_freq(self, freq: float) -> bool:
        from openbts_ttsou_tpu_torch.trx import rfx900

        try:
            self.rx_residual_hz = rfx900.tune_rx(freq).residual
        except ValueError:
            return False
        return True


class LoopbackRadio(Radio):
    """Tx → (delay, gain, noise) → Rx through the native sample ring."""

    def __init__(self, delay_samples: int = 0, gain: float = 1.0,
                 noise_std: float = 0.0, capacity: int = 1 << 21,
                 full_scale: float = 32000.0):
        from openbts_ttsou_tpu_torch.runtime import SampleRing

        self.ring = SampleRing(capacity)
        self.delay = delay_samples
        self.gain = gain
        self.noise_std = noise_std
        self.full_scale = full_scale
        self._rng = np.random.default_rng(0)

    def write_samples(self, iq: np.ndarray, ts: int) -> int:
        iq = np.asarray(iq, np.complex64) * self.gain
        scaled = np.clip(np.stack([iq.real, iq.imag], -1), -32767, 32767)
        return self.ring.write(scaled.astype(np.int16), ts + self.delay)

    def read_samples(self, n: int, ts: int) -> np.ndarray:
        out = self.ring.read_complex(n, ts)
        if self.noise_std > 0:
            noise = (self._rng.normal(0, self.noise_std, n)
                     + 1j * self._rng.normal(0, self.noise_std, n))
            out = out + noise.astype(np.complex64)
        return out


class ReplayRadio(Radio):
    """Replay a recorded IQ capture; Tx is discarded (or captured)."""

    def __init__(self, iq: np.ndarray, capture_tx: bool = False):
        self.iq = np.asarray(iq, np.complex64)
        self.tx_log: list[tuple[int, np.ndarray]] = []
        self.capture_tx = capture_tx

    def read_samples(self, n: int, ts: int) -> np.ndarray:
        out = np.zeros(n, np.complex64)
        lo = max(0, ts)
        hi = min(len(self.iq), ts + n)
        if hi > lo:
            out[lo - ts: hi - ts] = self.iq[lo:hi]
        return out

    def write_samples(self, iq: np.ndarray, ts: int) -> int:
        if self.capture_tx:
            self.tx_log.append((ts, np.asarray(iq, np.complex64).copy()))
        return len(iq)


class BankRadio(Radio):
    """Vectorized multi-carrier radio: one timestamped read/write moves
    all `n_chan` carriers ([C, n] arrays). The block-pipelined daemon's
    I/O surface — where the reference runs one USRPDevice per ARFCN
    process, the block daemon batches carriers and the radio follows."""

    n_chan: int = 1

    def read_bank(self, n: int, ts: int) -> np.ndarray:
        """complex64 [n_chan, n] starting at timestamp ts."""
        raise NotImplementedError

    def write_bank(self, iq: np.ndarray, ts: int) -> int:
        raise NotImplementedError


class MultiRadio(BankRadio):
    """Bank adapter over per-carrier `Radio` objects."""

    def __init__(self, radios: list):
        self.radios = radios
        self.n_chan = len(radios)

    def start(self) -> bool:
        return all(r.start() for r in self.radios)

    def read_bank(self, n: int, ts: int) -> np.ndarray:
        return np.stack([r.read_samples(n, ts) for r in self.radios])

    def write_bank(self, iq: np.ndarray, ts: int) -> int:
        return min(r.write_samples(iq[i], ts)
                   for i, r in enumerate(self.radios))


class ReplayBankRadio(BankRadio):
    """Replays a prepared [C, N] uplink IQ template (tiled along time)
    and captures or discards downlink banks — the vectorized ReplayRadio
    for ≥100-carrier soaks where per-carrier rings would dominate the
    host budget. Samples live as int16 I/Q pairs (the USRP ADC/DAC
    format the reference's ring holds, USRPDevice.h:68-74); the daemon
    moves them to/from the device untouched (`int16_io`)."""

    int16_io = True

    def __init__(self, iq: np.ndarray, capture_tx_blocks: int = 0):
        iq = np.asarray(iq)
        if np.iscomplexobj(iq):
            iq = np.clip(np.stack([iq.real, iq.imag], -1).round(),
                         -32767, 32767)
        self.iq = np.ascontiguousarray(iq, np.int16)  # [C, N, 2]
        self.n_chan = self.iq.shape[0]
        self.capture_tx_blocks = capture_tx_blocks
        self.tx_log: list[tuple[int, np.ndarray]] = []

    def read_bank(self, n: int, ts: int) -> np.ndarray:
        """int16 [C, n, 2] starting at ts (tiled; pre-stream = zeros)."""
        period = self.iq.shape[1]
        idx = (ts + np.arange(n)) % period
        out = self.iq[:, idx]
        if ts < 0:  # before stream start: zeros (cold ring)
            out[:, : min(-ts, n)] = 0
        return out

    def write_bank(self, iq: np.ndarray, ts: int) -> int:
        if len(self.tx_log) < self.capture_tx_blocks:
            self.tx_log.append((ts, np.asarray(iq).copy()))
        return iq.shape[1]


class DuplexLoopbackRadio(Radio):
    """Separate uplink/downlink sample rings for full MS simulation:
    the BTS transceiver writes downlink and reads uplink; a simulated
    MS does the opposite (the two directions of SWLOOPBACK that the
    reference multiplexes through one buffer)."""

    def __init__(self, capacity: int = 1 << 21):
        from openbts_ttsou_tpu_torch.runtime import SampleRing

        self.dl = SampleRing(capacity)
        self.ul = SampleRing(capacity)

    # BTS side (the Radio contract)
    def write_samples(self, iq: np.ndarray, ts: int) -> int:
        iq = np.asarray(iq, np.complex64)
        scaled = np.clip(np.stack([iq.real, iq.imag], -1), -32767, 32767)
        return self.dl.write(scaled.astype(np.int16), ts)

    def read_samples(self, n: int, ts: int) -> np.ndarray:
        return self.ul.read_complex(n, ts)

    # MS side
    def ms_write(self, iq: np.ndarray, ts: int) -> int:
        iq = np.asarray(iq, np.complex64)
        scaled = np.clip(np.stack([iq.real, iq.imag], -1), -32767, 32767)
        return self.ul.write(scaled.astype(np.int16), ts)

    def ms_read(self, n: int, ts: int) -> np.ndarray:
        return self.dl.read_complex(n, ts)
