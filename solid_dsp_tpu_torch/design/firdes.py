"""Kaiser windowed-sinc low-pass and root-raised-cosine design (host,
float64).

Port of ``solid_dsp_tpu/design/firdes.py::kaiser_beta``, ``_check_as``,
``firdes_kaiser`` (reference ``src/filter/firdes/mod.rs``) and
``firdes_rrcos`` (:291).  The Kaiser taps feed the receive chain's
decimating filter (``models/rx_chain.py``) and the channelizer's prototype
(``models/channelizer.py``); the root-raised cosine is the 2x-oversampled
bank's reconstruction prototype.
"""

from __future__ import annotations

import numpy as np

from .specialfn import sinc
from .windows import kaiser as kaiser_window

__all__ = ["kaiser_beta", "firdes_kaiser", "firdes_rrcos"]


def _check_as(stop_band_attenuation: float):
    if stop_band_attenuation <= 0.0:
        raise ValueError("invalid stop band attenuation (0, inf)")


def kaiser_beta(stop_band_attenuation: float) -> float:
    """Kaiser beta from the stop-band attenuation in dB."""
    a = abs(stop_band_attenuation)
    if a > 50.0:
        return 0.1102 * (a - 8.7)
    if a > 21.0:
        return 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    return 0.0


def firdes_kaiser(
    filter_length: int,
    cutoff_frequency: float,
    stop_band_attenuation: float,
    fractional_sample_offset: float = 0.0,
) -> np.ndarray:
    """Windowed-sinc Kaiser low-pass taps (float64)."""
    if not (-0.5 <= fractional_sample_offset <= 0.5):
        raise ValueError("invalid mu range [-0.5, 0.5]")
    if not (0.0 <= cutoff_frequency <= 0.5):
        raise ValueError("invalid bandwidth [0, 0.5]")
    _check_as(stop_band_attenuation)
    beta = kaiser_beta(stop_band_attenuation)
    i = np.arange(filter_length, dtype=np.float64)
    t = i - (filter_length - 1) / 2.0 + fractional_sample_offset
    h1 = sinc(2.0 * cutoff_frequency * t)
    return np.asarray(h1) * kaiser_window(filter_length, beta)


def firdes_rrcos(samples_per_symbol: int, delay_symbols: int,
                 rolloff: float = 0.35) -> np.ndarray:
    """Root-raised-cosine pulse: ntaps = 2*sps*delay + 1, unit energy; the
    t = 0 and t = +-Ts/(4 beta) singularities take their limits."""
    sps = int(samples_per_symbol)
    beta = float(rolloff)
    if not 0.0 < beta <= 1.0:
        raise ValueError("rolloff must be in (0, 1]")
    n = 2 * sps * int(delay_symbols) + 1
    t = (np.arange(n) - (n - 1) / 2.0) / sps  # in symbol periods
    h = np.zeros(n)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-12:
            h[i] = 1.0 - beta + 4.0 * beta / np.pi
        elif abs(abs(ti) - 1.0 / (4.0 * beta)) < 1e-9:
            h[i] = (beta / np.sqrt(2.0)) * (
                (1 + 2 / np.pi) * np.sin(np.pi / (4 * beta))
                + (1 - 2 / np.pi) * np.cos(np.pi / (4 * beta)))
        else:
            num = (np.sin(np.pi * ti * (1 - beta))
                   + 4 * beta * ti * np.cos(np.pi * ti * (1 + beta)))
            den = np.pi * ti * (1 - (4 * beta * ti) ** 2)
            h[i] = num / den
    return h / np.sqrt(np.sum(h ** 2))
