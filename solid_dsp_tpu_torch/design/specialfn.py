"""Scalar special functions that the Kaiser window needs (host, float64).

Port of the parts of ``solid_dsp_tpu/design/specialfn.py`` that the Kaiser
window reaches: ``sinc``, and ``besseli`` at order 0 with the ``lngamma``
behind it.  They reproduce the reference's fixed-length series (reference
``src/math/mod.rs``); the filter design golden values depend on those exact
formulas, so the arithmetic is the JAX package's, in the same order.  Other
orders of I_nu are not ported.
"""

from __future__ import annotations

import numpy as np

__all__ = ["sinc", "besseli", "lngamma"]

_BESSEL_ITERATIONS = 64


def sinc(x):
    """sin(pi x)/(pi x); for |x| < 0.01 the reference's cosine-product form
    cos(pi x/2) cos(pi x/4) cos(pi x/8)."""
    x = np.asarray(x, dtype=np.float64)
    small = np.abs(x) < 0.01
    approx = (
        np.cos(np.pi * x / 2.0) * np.cos(np.pi * x / 4.0) * np.cos(np.pi * x / 8.0)
    )
    with np.errstate(divide="ignore", invalid="ignore"):
        exact = np.sin(np.pi * x) / (np.pi * x)
    out = np.where(small, approx, exact)
    return out if out.ndim else float(out)


def lngamma(x):
    """log Gamma(x) for x >= 0: lngamma(x) = lngamma(x+1) - ln(x) up to
    x >= 10, then g = 0.5(ln 2pi - ln x) + x(ln(x + 1/(12x - 0.1/x)) - 1).
    Returns 0.0 for x < 0, as the reference does."""
    x = np.asarray(x, dtype=np.float64)
    scalar = x.ndim == 0
    x = np.atleast_1d(x).astype(np.float64).copy()
    neg = x < 0.0
    acc = np.zeros_like(x)
    xx = np.where(neg, 10.0, x)
    while True:
        small = xx < 10.0
        if not small.any():
            break
        acc = np.where(small, acc - np.log(np.where(small, xx, 1.0)), acc)
        xx = np.where(small, xx + 1.0, xx)
    g = 0.5 * (np.log(2.0 * np.pi) - np.log(xx))
    g = g + xx * (np.log(xx + (1.0 / (12.0 * xx - 0.1 / xx))) - 1.0)
    out = np.where(neg, 0.0, acc + g)
    return float(out[0]) if scalar else out


def besseli(z):
    """Modified Bessel function of the first kind, order 0: 1 at z = 0,
    1 / Gamma(1) below 0.001 in magnitude, else the reference's 64-term
    log-domain series exp(log(sum_k (z/2)^(2k) / (k!)^2))."""
    z = np.asarray(z, dtype=np.float64)
    scalar = z.ndim == 0
    z = np.atleast_1d(z)
    out = np.ones_like(z)
    low = (z != 0.0) & (z < 0.001)
    out[low] = 1.0 / np.exp(lngamma(1.0))
    hi = z >= 0.001
    if hi.any():
        lz = np.log(0.5 * z[hi])
        y = np.zeros_like(lz)
        for k in range(_BESSEL_ITERATIONS):
            y += np.exp(2.0 * k * lz - lngamma(k + 1.0) - lngamma(k + 1.0))
        out[hi] = np.exp(np.log(y))
    return float(out[0]) if scalar else out
