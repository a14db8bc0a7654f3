"""Kaiser windowed-sinc low-pass design (host, float64).

Port of ``solid_dsp_tpu/design/firdes.py::kaiser_beta``, ``_check_as`` and
``firdes_kaiser`` (reference ``src/filter/firdes/mod.rs``).  The taps feed
the receive chain's decimating filter (``models/rx_chain.py``).
"""

from __future__ import annotations

import numpy as np

from .specialfn import sinc
from .windows import kaiser as kaiser_window

__all__ = ["kaiser_beta", "firdes_kaiser"]


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
