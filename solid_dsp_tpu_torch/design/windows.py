"""Kaiser window (host, float64).

Port of ``solid_dsp_tpu/design/windows.py::kaiser`` (reference
``src/windows/kaiser.rs``), the only window the receive chain's tap design
needs.
"""

from __future__ import annotations

import numpy as np

from .specialfn import besseli

__all__ = ["kaiser"]


def kaiser(n: int, beta: float) -> np.ndarray:
    """Kaiser window of length n."""
    if beta < 0.0:
        raise ValueError("kaiser: beta must be >= 0")
    if n <= 0:
        raise ValueError("kaiser: window length must be > 0")
    t = np.arange(int(n), dtype=np.float64) - (n - 1) / 2.0
    r = 2.0 * t / (n - 1) if n > 1 else np.zeros_like(t)
    a = besseli(beta * np.sqrt(np.maximum(1.0 - r * r, 0.0)))
    b = besseli(beta)
    return np.atleast_1d(a / b)
