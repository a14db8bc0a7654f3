"""Group delay of FIR and IIR filters (host, float64).

Port of ``solid_dsp_tpu/analysis/group_delay.py`` (reference
``src/group_delay/mod.rs``: fir_group_delay :51-79, iir_group_delay
:82-129), with the reference's positive-exponent rotation e^{+j 2 pi f i};
the IIR form builds c = corr(conj(a reversed), b) and subtracts
len(a) - 1.  Setup-time analysis, like the port's ``design/``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["fir_group_delay", "iir_group_delay", "fir_group_delay_band"]

_TOLERANCE = 1e-11


def _check_freq(frequency: float):
    if frequency < -0.5 or frequency > 0.5:
        raise ValueError("frequency out of bounds [-0.5, 0.5]")


def fir_group_delay(coefficients, frequency: float) -> float:
    """Group delay (samples) of an FIR filter at a normalized frequency."""
    c = np.asarray(coefficients, dtype=np.complex128)
    if c.size == 0:
        raise ValueError("empty coefficients")
    _check_freq(frequency)
    i = np.arange(c.size, dtype=np.float64)
    rot = np.exp(2j * np.pi * frequency * i)
    return float((np.sum(c * rot * i) / np.sum(c * rot)).real)


def iir_group_delay(numerator, denominator, frequency: float) -> float:
    """Group delay (samples) of an IIR filter at a normalized frequency."""
    b = np.asarray(numerator, dtype=np.complex128)
    a = np.asarray(denominator, dtype=np.complex128)
    if b.size == 0 or a.size == 0:
        raise ValueError("empty coefficients")
    _check_freq(frequency)
    coefs = np.zeros(b.size + a.size - 1, dtype=np.complex128)
    for i in range(a.size):
        for j in range(b.size):
            coefs[i + j] += np.conj(a[a.size - i - 1]) * b[j]
    i = np.arange(coefs.size, dtype=np.float64)
    c0 = coefs * np.exp(2j * np.pi * frequency * i)
    t0 = np.sum(c0 * i)
    t1 = np.sum(c0)
    if np.hypot(t1.real, t1.imag) <= _TOLERANCE:
        raise ZeroDivisionError(
            "denominator coefficients divide numerator by zero")
    return float((t0 / t1).real) - (a.size - 1)


def fir_group_delay_band(coefficients, frequencies) -> np.ndarray:
    """FIR group delay over a frequency grid."""
    c = np.asarray(coefficients, dtype=np.complex128)
    f = np.atleast_1d(np.asarray(frequencies, dtype=np.float64))
    i = np.arange(c.size, dtype=np.float64)
    E = np.exp(2j * np.pi * np.outer(f, i))
    return ((E @ (c * i)) / (E @ c)).real
