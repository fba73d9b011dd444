"""RFX900-class daughterboard frequency plan (integer-N PLL) + GSM
band/ARFCN arithmetic.

The reference tunes its RFX900 daughterboard by computing divider and
register words for the board's integer-N synthesizer and shipping them
over SPI (USRPDevice::compute_regs, Transceiver52M/USRPDevice.cpp:56-103;
field constants USRPDevice.h:100-151; tx_setFreq/rx_setFreq
USRPDevice.cpp:106-150).  The synthesizer can only land on multiples of
the phase-detector frequency, so tuning has two halves: the analog plan
(this module) and a digital shift of the residual in the DDC/DUC
(`m_uTx->set_tx_freq(0, wFreq-actFreq)`).  In this framework the
residual shift is `ops.signal.frequency_shift` on the sample stream;
this module owns the plan math so the daemon can report achieved RF
frequencies and feed the residual to the NCO, and so a hardware backend
has the full register recipe.

ARFCN↔frequency arithmetic follows GSM 05.05 (reference:
GSM::uplinkFreqKHz/downlinkFreqKHz, GSM/GSMCommon.cpp:98-135).

Pure Python: the port's own copy of `openbts_ttsou_tpu/trx/rfx900.py`.
"""

from __future__ import annotations

from dataclasses import dataclass

# Master-clock plans of the two reference device generations
# (Transceiver52M/USRPDevice.cpp:53 and Transceiver/USRPDevice.cpp:54).
MASTER_CLOCK_52M = 52e6
MASTER_CLOCK_64M = 64e6

#: LO offset used to keep carrier bleed-through out of band
#: (USRPDevice.cpp:52; policy at setTxFreq/setRxFreq,
#: Transceiver/USRPDevice.cpp:522-542): Tx synthesizes at rf+OFFSET,
#: Rx at rf-2·OFFSET (the doubled Rx offset additionally pushes the
#: BTS's own downlink energy, 45 MHz up, into the anti-alias notch).
LO_OFFSET = 4.0e6

#: Reference divider: phase-detector frequency = master_clock / R_DIV
#: (USRPDevice.h:118).
R_DIV = 16

#: The synthesizer's dual-modulus prescaler counts N = 16·B + A and
#: requires B ≥ A for a realizable plan (compute_regs rejects B < A,
#: USRPDevice.cpp:75-76).
PRESCALER = 16

# SPI register addresses, encoded in the low 2 bits of each 24-bit
# word (tx_setFreq writes (word & ~3) | addr, USRPDevice.cpp:112-117).
ADDR_CONTROL = 0
ADDR_R = 1
ADDR_N = 2


def _r_word() -> int:
    """24-bit R-counter latch: band-select clock divider 8 (BSC=3),
    lock-detect precision on (LDP=1), anti-backlash 3 ns (ABP=0), and
    the reference divider itself (USRPDevice.h:123-128, assembly
    USRPDevice.cpp:77-84)."""
    bsc, ldp = 3, 1
    return (bsc << 20) | (ldp << 18) | (R_DIV << 2)


def _control_word() -> int:
    """24-bit function latch: prescaler select P=1 (32/33) at bit 22,
    charge-pump currents CP1=CP2=7, mute-til-lock-detect, positive
    phase-detector polarity, MUXOUT = digital lock detect, core power
    10 mA (USRPDevice.h:114-147, assembly USRPDevice.cpp:85-97)."""
    p = 1
    cp2, cp1 = 7, 7
    mtld, pdp, muxout, pc = 1, 1, 1, 1
    return ((p << 22) | (cp2 << 17) | (cp1 << 14) | (mtld << 11)
            | (pdp << 8) | (muxout << 5) | (pc << 2))


def _n_word(b: int, a: int, div2: int) -> int:
    """24-bit N-divider latch: B counter, A counter, and the RF
    divide-by-2 select for the low band (USRPDevice.cpp:98-103)."""
    return (div2 << 22) | (b << 8) | (a << 2)


@dataclass(frozen=True)
class SynthPlan:
    """One realizable synthesizer setting."""

    requested: float      # Hz the caller asked the synthesizer for
    actual: float         # Hz the integer-N plan actually produces
    n_divider: int        # total N = 16·B + A
    div2: bool            # low-band RF/2 path engaged
    r_word: int           # 24-bit register words (ADDR_* low bits clear)
    control_word: int
    n_word: int

    @property
    def residual(self) -> float:
        """Hz left for the digital mixer (requested − actual)."""
        return self.requested - self.actual

    def spi_bytes(self) -> list[bytes]:
        """The three 24-bit MSB-first SPI writes in program order
        R → control → N, address in the low 2 bits (the reference's
        write_it framing, USRPDevice.cpp:42-49,110-117)."""
        out = []
        for word, addr in ((self.r_word, ADDR_R),
                           (self.control_word, ADDR_CONTROL),
                           (self.n_word, ADDR_N)):
            v = (word & ~0x3) | addr
            out.append(bytes(((v >> 16) & 0xFF, (v >> 8) & 0xFF,
                              v & 0xFF)))
        return out


def frequency_plan(freq: float,
                   master_clock: float = MASTER_CLOCK_52M) -> SynthPlan:
    """Integer-N plan for `freq` Hz (compute_regs,
    Transceiver52M/USRPDevice.cpp:56-103).

    Below 1.2 GHz the RF divide-by-2 path is used, so the VCO runs at
    2·freq and the achievable grid is half as coarse. Raises ValueError
    when the N split violates the prescaler constraint B ≥ A.
    """
    low_band = freq < 1.2e9
    mult = 2 if low_band else 1
    phase_det = master_clock / R_DIV
    n = int(round(freq * mult / phase_det))
    actual = n * phase_det / mult
    b, a = n // PRESCALER, n % PRESCALER
    if b < a:
        raise ValueError(
            f"unrealizable N={n} (B={b} < A={a}) for {freq/1e6:.3f} MHz")
    return SynthPlan(requested=freq, actual=actual, n_divider=n,
                     div2=low_band, r_word=_r_word(),
                     control_word=_control_word(),
                     n_word=_n_word(b, a, int(low_band)))


def tune_tx(rf_freq: float,
            master_clock: float = MASTER_CLOCK_52M) -> SynthPlan:
    """Transmit plan: synthesize at rf+LO_OFFSET; `plan.requested` is
    restated as the wanted RF carrier so `plan.residual` is exactly the
    DUC shift (setTxFreq, Transceiver/USRPDevice.cpp:521-528)."""
    plan = frequency_plan(rf_freq + LO_OFFSET, master_clock)
    return SynthPlan(requested=rf_freq, actual=plan.actual,
                     n_divider=plan.n_divider, div2=plan.div2,
                     r_word=plan.r_word, control_word=plan.control_word,
                     n_word=plan.n_word)


def tune_rx(rf_freq: float,
            master_clock: float = MASTER_CLOCK_52M) -> SynthPlan:
    """Receive plan: synthesize at rf−2·LO_OFFSET (setRxFreq,
    Transceiver/USRPDevice.cpp:531-542)."""
    plan = frequency_plan(rf_freq - 2 * LO_OFFSET, master_clock)
    return SynthPlan(requested=rf_freq, actual=plan.actual,
                     n_divider=plan.n_divider, div2=plan.div2,
                     r_word=plan.r_word, control_word=plan.control_word,
                     n_word=plan.n_word)


# ---------------------------------------------------------------------------
# GSM 05.05 band plan (GSM::uplinkFreqKHz, GSM/GSMCommon.cpp:98-135)
# ---------------------------------------------------------------------------

GSM850, EGSM900, DCS1800, PCS1900 = 850, 900, 1800, 1900

#: band → (uplink base kHz, base ARFCN, valid ARFCN range(s),
#:         duplex spacing kHz)
#:
#: GSM850 accepts 128–251 per GSM 05.05 §2; this deliberately diverges
#: from the reference's off-by-one assert (ARFCN>129 && ARFCN<252,
#: GSM/GSMCommon.cpp:100), which rejects the spec-valid ARFCN 128-129
#: low edge.
_BAND = {
    GSM850: (824200, 128, [(128, 251)], 45000),
    EGSM900: (890000, 0, [(0, 124), (975, 1023)], 45000),
    DCS1800: (1710200, 512, [(512, 885)], 95000),
    PCS1900: (1850200, 512, [(512, 810)], 80000),
}


def uplink_freq_khz(band: int, arfcn: int) -> int:
    base, base_arfcn, ranges, _ = _BAND[band]
    if not any(lo <= arfcn <= hi for lo, hi in ranges):
        raise ValueError(f"ARFCN {arfcn} out of range for GSM{band}")
    if band == EGSM900 and arfcn >= 975:  # extended band wraps negative
        return base + 200 * (arfcn - 1024)
    return base + 200 * (arfcn - base_arfcn)


def downlink_freq_khz(band: int, arfcn: int) -> int:
    return uplink_freq_khz(band, arfcn) + _BAND[band][3]
