"""Complex frequency-response probes (host, float64).

Port of ``solid_dsp_tpu/analysis/freq_response.py`` (reference
``src/filter/fir/mod.rs:263-273``, ``src/filter/iir/mod.rs:336-372``), with
the reference's positive-exponent DTFT probe e^{+j 2 pi f i}.
"""

from __future__ import annotations

import numpy as np

__all__ = ["fir_frequency_response", "iir_frequency_response",
           "frequency_response_band", "iir_frequency_response_band"]


def _dtft_pos(coefs, frequency: float) -> complex:
    c = np.asarray(coefs, dtype=np.complex128)
    i = np.arange(c.size, dtype=np.float64)
    return complex(np.sum(c * np.exp(2j * np.pi * frequency * i)))


def fir_frequency_response(coefficients, frequency: float,
                           scale=1.0) -> complex:
    """scale * sum_i c[i] e^{+j 2 pi f i}."""
    return complex(scale) * _dtft_pos(coefficients, frequency)


def iir_frequency_response(numerator, denominator,
                           frequency: float) -> complex:
    """B(f) / A(f) with positive-exponent probes (pass the coefficient
    slices to probe: the reference's normal form stores a[1:])."""
    return (_dtft_pos(numerator, frequency)
            / _dtft_pos(denominator, frequency))


def frequency_response_band(coefficients, frequencies,
                            scale=1.0) -> np.ndarray:
    """complex128 H[f] = scale * sum_i c[i] e^{+j 2 pi f i} over a grid."""
    c = np.asarray(coefficients, dtype=np.complex128)
    f = np.atleast_1d(np.asarray(frequencies, dtype=np.float64))
    i = np.arange(c.size, dtype=np.float64)
    return complex(scale) * (np.exp(2j * np.pi * np.outer(f, i)) @ c)


def iir_frequency_response_band(numerator, denominator,
                                frequencies) -> np.ndarray:
    """B(f) / A(f) over a frequency grid."""
    return (frequency_response_band(numerator, frequencies)
            / frequency_response_band(denominator, frequencies))
