"""Filter design (numpy, built once on the host).

The closed forms are those of ``m17_sdr_tpu.dsp.filters``, including the
+0.0001 rolloff nudge that keeps the RRC denominator off its zero.
"""

from __future__ import annotations

import numpy as np


def rrc_filter(rolloff: float, ntaps: int, samples_per_symbol: float) -> np.ndarray:
    """Root-raised-cosine impulse response."""
    b = rolloff + 0.0001
    ts = float(samples_per_symbol)
    t = -(ntaps - 1) / 2.0 + np.arange(ntaps)
    a = 2.0 * b / (np.pi * np.sqrt(ts))
    num_cos = np.cos((1.0 + b) * np.pi * t / ts)
    with np.errstate(divide="ignore", invalid="ignore"):
        num_sin = np.where(
            t == 0,
            (1.0 - b) * np.pi / (4.0 * b),
            np.sin((1.0 - b) * np.pi * t / ts) / (4.0 * b * t / ts),
        )
    den = 1.0 - (4.0 * b * t / ts) ** 2
    return (a * (num_cos + num_sin) / den).astype(np.float32)


def normalize_gain(h: np.ndarray, gain: float = 1.0) -> np.ndarray:
    """Scale so that the tap sum equals ``gain``."""
    return (h * (gain / h.sum())).astype(np.float32)


def polyphase_rrc_bank(num_phases: int, taps_per_phase: int, rolloff: float = 0.5):
    """Matched-filter bank and circular-difference bank for timing recovery.

    One mother RRC of num_phases*taps_per_phase taps at num_phases*2
    samples/symbol is split into num_phases interleaved sub-filters; the
    derivative bank is the circular first difference of the mother,
    split the same way.  Each matched sub-filter has unit DC gain; the
    derivative bank is left unscaled.

    Returns (mf [num_phases, taps_per_phase], dmf [same]).
    """
    n = num_phases * taps_per_phase
    mother = rrc_filter(rolloff, n, num_phases * 2)
    diff = np.roll(mother, -1) - np.roll(mother, 1)
    mf = np.zeros((num_phases, taps_per_phase), dtype=np.float32)
    dmf = np.zeros((num_phases, taps_per_phase), dtype=np.float32)
    for i in range(num_phases):
        mf[i] = mother[i::num_phases][:taps_per_phase]
        dmf[i] = diff[i::num_phases][:taps_per_phase]
    mf = mf / mf.sum(axis=1, keepdims=True)
    return mf, dmf


def tx_rrc_polyphase(oversample: int, taps_per_phase: int = 31,
                     rolloff: float = 0.5) -> np.ndarray:
    """TX interpolation filter as a [taps_per_phase, oversample] matrix.

    C[j, i] = c[(os-1-i) + j*os], c the mother RRC of taps_per_phase*os
    taps at ``oversample`` samples/symbol with tap sum ``oversample``
    (unit DC gain per branch).  The output for symbol step t, sub-sample
    i is  y[t*os + i] = sum_j x[t-30+j] * C[j, i].
    """
    n = taps_per_phase * oversample
    c = normalize_gain(rrc_filter(rolloff, n, oversample), float(oversample))
    idx = (oversample - 1 - np.arange(oversample))[None, :] + \
        np.arange(taps_per_phase)[:, None] * oversample
    return c[idx].astype(np.float32)
