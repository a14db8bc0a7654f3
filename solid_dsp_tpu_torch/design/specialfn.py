"""Scalar special functions that the Kaiser window needs (host, float64).

Port of the parts of ``solid_dsp_tpu/design/specialfn.py`` that the Kaiser
window reaches: ``sinc``, and ``besseli`` at order 0 with the ``lngamma``
behind it; ``gamma``, ``lnbesseli`` (log I_nu of any order) and ``besselj``
(J_nu, which ``firdes_doppler`` needs).  They reproduce the reference's
fixed-length series (reference ``src/math/mod.rs``); the filter design
golden values depend on those exact formulas, so the arithmetic is the JAX
package's, in the same order.  ``besseli`` itself keeps order 0.
``csqrt`` (the complex square root of a real number) serves Bairstow's
root pairs in ``design/polymath.py``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["sinc", "besseli", "lnbesseli", "besselj", "gamma", "lngamma",
           "csqrt"]

_BESSEL_ITERATIONS = 64
_BESSEL_J_ITERATIONS = 128


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


def gamma(x):
    """Gamma(x) = exp(lngamma(x)); the reflection pi / (Gamma(1 - x)
    sin(pi x)) for x < 0 (reference math/mod.rs:156-169)."""
    x = np.asarray(x, dtype=np.float64)
    scalar = x.ndim == 0
    x = np.atleast_1d(x)
    out = np.empty_like(x)
    neg = x < 0.0
    if neg.any():
        out[neg] = np.pi / (gamma(1.0 - x[neg]) * np.sin(np.pi * x[neg]))
    out[~neg] = np.exp(lngamma(x[~neg]))
    return float(out[0]) if scalar else out


def lnbesseli(z, nu: float = 0.0):
    """log I_nu(z): 0 (nu = 0) or -max float64 at z = 0; the closed form
    at nu = 1/2; -Gamma(nu + 1) + nu ln(z/2) below 0.001 sqrt(nu + 1) (the
    reference's formula); else nu ln(z/2) + ln of the 64-term series
    sum_k exp(2k ln(z/2) - lngamma(k + 1) - lngamma(nu + k + 1))
    (reference math/mod.rs:65-100)."""
    z = np.asarray(z, dtype=np.float64)
    scalar = z.ndim == 0
    z = np.atleast_1d(z)
    out = np.empty_like(z)
    zero = z == 0.0
    out[zero] = 0.0 if nu == 0.0 else -np.finfo(np.float64).max
    zr = z[~zero]
    if zr.size:
        if nu == 0.5:
            out[~zero] = 0.5 * np.log(2.0 / (np.pi * zr)) + np.log(np.sinh(zr))
        else:
            low = zr < 0.001 * np.sqrt(nu + 1.0)
            res = np.empty_like(zr)
            if low.any():
                res[low] = -gamma(nu + 1.0) + nu * np.log(0.5 * zr[low])
            if (~low).any():
                zh = zr[~low]
                y = np.zeros_like(zh)
                for k in range(_BESSEL_ITERATIONS):
                    y += np.exp(2.0 * k * np.log(0.5 * zh) - lngamma(k + 1.0)
                                - lngamma(nu + k + 1.0))
                res[~low] = nu * np.log(0.5 * zh) + np.log(y)
            out[~zero] = res
    return float(out[0]) if scalar else out


def besselj(z, nu: float = 0.0):
    """Bessel function of the first kind J_nu(z): 1 (nu = 0) or 0 at z = 0;
    (z/2)^nu / Gamma(nu + 1) below 0.001 sqrt(nu + 1); else the 128-term
    alternating series of exp((2i + |nu|)(ln z - ln 2) - lngamma(i + 1) -
    lngamma(|nu| + i + 1)) (reference math/mod.rs:102-145)."""
    z = np.asarray(z, dtype=np.float64)
    scalar = z.ndim == 0
    z = np.atleast_1d(z)
    out = np.empty_like(z)
    zero = z == 0.0
    out[zero] = 1.0 if nu == 0.0 else 0.0
    zr = z[~zero]
    if zr.size:
        low = zr < 0.001 * np.sqrt(nu + 1.0)
        res = np.empty_like(zr)
        if low.any():
            res[low] = (0.5 * zr[low]) ** nu / gamma(nu + 1.0)
        if (~low).any():
            zh = zr[~low]
            abs_nu = abs(nu)
            J = np.zeros_like(zh)
            ln_z = np.log(zh)
            ln2 = np.log(2.0)
            for i in range(_BESSEL_J_ITERATIONS):
                t0 = 2.0 * i + abs_nu
                term = np.exp(t0 * ln_z - t0 * ln2 - lngamma(i + 1.0)
                              - lngamma(abs_nu + i + 1.0))
                J += term if i % 2 == 0 else -term
            res[~low] = J
        out[~zero] = res
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


def csqrt(a: float) -> complex:
    """Complex square root of a *real* number.

    Parity: ref math/mod.rs:191-224 (csqrtf-style branch structure with b=0).
    """
    a = float(a)
    b = 0.0
    if a == 0.0:
        return complex(a, b)
    if np.isnan(a):
        return complex(a, np.nan)
    if np.isinf(a):
        if a < 0.0:
            return complex(0.0, np.copysign(a, b))
        return complex(a, np.copysign(0.0, b))
    if a >= 0.0:
        t = np.sqrt((a + np.hypot(a, b)) * 0.5)
        return complex(t, b / (2.0 * t))
    # Note: the reference (math/mod.rs:220) computes sqrt((a - hypot)/2) here,
    # which is sqrt of a negative number -> NaN for every a < 0.  That NaN
    # would poison Bairstow's complex-conjugate root pairs, so we use the
    # correct musl-csqrt branch sqrt((-a + hypot)/2); all reference doctest
    # values are unaffected (they only exercise real roots).
    t = np.sqrt((-a + np.hypot(a, b)) * 0.5)
    return complex(abs(b) / (2.0 * t), np.copysign(t, b))
