"""Window taps (host, float64).

Port of ``solid_dsp_tpu/design/windows.py`` (reference ``src/windows/``):
the same formulas in float64, the reference's quirks included (hamming's
0.53836 / 0.46164, rcostaper's ``(pi * i + 0.5) / taper`` argument), the
same names and errors, and :func:`get_window` by name.
"""

from __future__ import annotations

import numpy as np

from .specialfn import besseli

__all__ = ["kaiser", "kaiser_bessel", "hamming", "hann", "blackman_harris",
           "blackman_harris7", "flattop", "triangular", "rcostaper",
           "get_window"]


def _idx(n: int) -> np.ndarray:
    return np.arange(int(n), dtype=np.float64)


def kaiser(n: int, beta: float) -> np.ndarray:
    """Kaiser window of length n."""
    if beta < 0.0:
        raise ValueError("kaiser: beta must be >= 0")
    if n <= 0:
        raise ValueError("kaiser: window length must be > 0")
    t = _idx(n) - (n - 1) / 2.0
    r = 2.0 * t / (n - 1) if n > 1 else np.zeros_like(t)
    a = besseli(beta * np.sqrt(np.maximum(1.0 - r * r, 0.0)))
    b = besseli(beta)
    return np.atleast_1d(a / b)


def kaiser_bessel(n: int, beta: float) -> np.ndarray:
    """Kaiser-Bessel-derived window: the cumulative square root of a
    Kaiser window, mirrored (n even)."""
    n = int(n)
    if n == 0:
        raise ValueError("kaiser_bessel: empty window")
    if n % 2 == 1:
        raise ValueError("kaiser_bessel: window length must be even")
    m = n // 2
    csum = np.cumsum(kaiser(m + 1, beta))
    half = np.sqrt(csum / csum[-1])
    out = np.empty(n, dtype=np.float64)
    out[:m] = half[:m]
    out[m:] = half[:m][::-1]
    return out


def hamming(n: int) -> np.ndarray:
    """Hamming window with the reference's 0.53836 / 0.46164."""
    return 0.53836 - 0.46164 * np.cos(2.0 * np.pi * _idx(n) / (n - 1))


def hann(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * _idx(n) / (n - 1))


def blackman_harris(n: int) -> np.ndarray:
    """4-term Blackman-Harris."""
    a0, a1, a2, a3 = 0.35875, 0.48829, 0.14128, 0.01168
    t = 2.0 * np.pi * _idx(n) / (n - 1)
    return a0 - a1 * np.cos(t) + a2 * np.cos(2 * t) - a3 * np.cos(3 * t)


def blackman_harris7(n: int) -> np.ndarray:
    """7-term Blackman-Harris."""
    a = [0.27105, 0.43329, 0.21812, 0.06592, 0.01081, 0.00077, 0.00001]
    t = 2.0 * np.pi * _idx(n) / (n - 1)
    out = np.full(int(n), a[0], dtype=np.float64)
    for k in range(1, 7):
        out += ((-1) ** k) * a[k] * np.cos(k * t)
    return out


def flattop(n: int) -> np.ndarray:
    a0, a1, a2, a3, a4 = 1.000, 1.930, 1.290, 0.388, 0.028
    t = 2.0 * np.pi * _idx(n) / (n - 1)
    return (a0 - a1 * np.cos(t) + a2 * np.cos(2 * t) - a3 * np.cos(3 * t)
            + a4 * np.cos(4 * t))


def triangular(n: int, sub_length: int) -> np.ndarray:
    """Triangular window with sub_length in {n - 1, n, n + 1}."""
    n = int(n)
    sub_length = int(sub_length)
    if sub_length not in (n - 1, n, n + 1):
        raise ValueError(
            "triangular: sub length must be window length + {-1,0,1}")
    if sub_length == 0:
        raise ValueError("triangular: sub length must not be 0")
    return 1.0 - np.abs((_idx(n) - (n - 1) / 2.0) / (sub_length / 2.0))


def rcostaper(n: int, taper: int) -> np.ndarray:
    """Raised-cosine taper with the reference's ``(pi * i + 0.5) / taper``
    argument."""
    n = int(n)
    taper = int(taper)
    if taper > n // 2:
        raise ValueError(
            "rcostaper: taper must not exceed window length / 2")
    i = np.arange(n)
    ti = np.where(i > n - taper - 1, n - i - 1, i)
    ramp = (0.5 - 0.5 * np.cos((np.pi * ti.astype(np.float64) + 0.5)
                               / float(taper)) if taper > 0 else np.ones(n))
    return np.where(ti < taper, ramp, 1.0)


_WINDOWS = {
    "kaiser": kaiser,
    "kaiser_bessel": kaiser_bessel,
    "hamming": hamming,
    "hann": hann,
    "blackman_harris": blackman_harris,
    "blackman_harris7": blackman_harris7,
    "flattop": flattop,
    "triangular": triangular,
    "rcostaper": rcostaper,
}


def get_window(name: str, n: int, *args, **kwargs) -> np.ndarray:
    """Window by name; extra arguments go to its generator (beta for
    kaiser, sub_length for triangular, taper for rcostaper)."""
    try:
        fn = _WINDOWS[name]
    except KeyError:
        raise ValueError(
            f"unknown window {name!r}; have {sorted(_WINDOWS)}") from None
    return fn(n, *args, **kwargs)
