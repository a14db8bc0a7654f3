"""Chirp-Z transform and zoom FFT.

Port of ``solid_dsp_tpu/ops/czt.py``: X[k] = sum_n x[n] a^-n w^(nk),
k = 0..M-1, by Bluestein's identity nk = (n^2 + k^2 - (k-n)^2)/2 as one
power-of-two circular convolution through ``torch.fft`` (the JAX package
takes ``jnp.fft``; no kernel of its own).  The chirp tables are built on the
host in float64 with the quadratic phases reduced mod 2 pi in longdouble
(a bounded ``lru_cache``), then rounded to the working complex type once
per device.  Tensor functions: they run where their input lies.

For |w| != 1 the chirps grow like exp(|log|w|| max(n, m)^2 / 2): keep that
exponent below ~8 in complex64 and ~30 in complex128 (Bluestein's own
limit, scipy.signal.czt's too).  Unit-circle contours (the zoom FFT) have
no such limit.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = ["czt", "zoom_fft", "CZT"]


@lru_cache(maxsize=128)
def _czt_tables(n: int, m: int, w_log_mag: float, w_angle: float,
                a_log_mag: float, a_angle: float):
    """(input chirp (n,), FFT of the convolution kernel (L,), output chirp
    (m,), L) of an n -> m CZT, complex128 on the host."""
    L = max(1 << int(n + m - 2).bit_length(), 1) if n + m > 2 else 1

    def _chirp(idx, log_mag, angle, scale):
        """(mag e^{i angle})^(scale idx^2), the phase reduced mod 2 pi."""
        q = idx.astype(np.longdouble) ** 2 * scale
        ph = np.remainder(q * np.longdouble(angle),
                          2 * np.longdouble(np.pi)).astype(np.float64)
        mag = np.exp(q.astype(np.float64) * log_mag)
        return mag * (np.cos(ph) + 1j * np.sin(ph))

    nn = np.arange(n, dtype=np.int64)
    kk = np.arange(m, dtype=np.int64)
    na = nn.astype(np.longdouble) * np.longdouble(a_angle)
    pa = np.remainder(-na, 2 * np.longdouble(np.pi)).astype(np.float64)
    a_pow = np.exp(-nn.astype(np.float64) * a_log_mag) * (
        np.cos(pa) + 1j * np.sin(pa))
    chirp_in = a_pow * _chirp(nn, w_log_mag, w_angle, 0.5)
    chirp_out = _chirp(kk, w_log_mag, w_angle, 0.5)
    # kernel v[j] = w^(-j^2/2), j = -(n-1) .. m-1, embedded circularly
    v = np.zeros(L, dtype=np.complex128)
    v[:m] = _chirp(np.arange(m, dtype=np.int64), w_log_mag, w_angle, -0.5)
    if n > 1:
        v[L - (n - 1):] = _chirp(np.arange(1, n, dtype=np.int64), w_log_mag,
                                 w_angle, -0.5)[::-1]
    return chirp_in, np.fft.fft(v), chirp_out, L


@lru_cache(maxsize=32)
def _tables_on(n: int, m: int, w_params: tuple, a_params: tuple,
               device: torch.device, dtype: torch.dtype):
    ci, V, co, L = _czt_tables(n, m, *w_params, *a_params)
    return tuple(torch.from_numpy(t).to(device, dtype)
                 for t in (ci, V, co)) + (L,)


def _complex_type(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.complex64)


def _czt_exec(x: torch.Tensor, n: int, m: int, w_params: tuple,
              a_params: tuple) -> torch.Tensor:
    x = x.to(_complex_type(x.dtype))
    ci, V, co, L = _tables_on(n, m, w_params, a_params, x.device, x.dtype)
    Y = torch.fft.fft(x * ci, n=L, dim=-1)
    return torch.fft.ifft(Y * V, dim=-1)[..., :m] * co


def _contour_params(z) -> tuple:
    z = complex(z)
    if z == 0:
        raise ValueError("czt contour parameter must be nonzero")
    return float(np.log(abs(z))), float(np.angle(z))


def _w_params(m: int, w, w_angle) -> tuple:
    if w_angle is not None:
        if w is not None:
            raise ValueError("pass w or w_angle, not both")
        return (0.0, float(w_angle))
    if w is None:
        return (0.0, -2.0 * np.pi / m)
    return _contour_params(w)


def czt(x: torch.Tensor, m: int | None = None, w=None, a=1.0 + 0j,
        *, w_angle: float | None = None) -> torch.Tensor:
    """Chirp-Z transform along the last axis: ``m`` outputs (default N) on
    the contour a w^-k; ``w`` defaults to exp(-2j pi / m) (the DFT), and
    ``w_angle`` gives w = e^{1j w_angle} directly.  czt(x) == fft(x);
    czt(x, m, w, a) matches scipy.signal.czt."""
    x = torch.as_tensor(x)
    n = int(x.shape[-1])
    m = int(m if m is not None else n)
    if m < 1 or n < 1:
        raise ValueError(f"czt needs n >= 1 and m >= 1, got {n=}, {m=}")
    return _czt_exec(x, n, m, _w_params(m, w, w_angle), _contour_params(a))


def zoom_fft(x: torch.Tensor, f1: float, f2: float | None = None,
             m: int | None = None, *, fs: float = 2.0,
             endpoint: bool = False) -> torch.Tensor:
    """``m`` DTFT samples evenly spaced on [f1, f2) ([f1, f2] with
    ``endpoint``), frequencies in units of ``fs`` (default 2: half-cycles a
    sample, as scipy.signal.zoom_fft); one argument f1 means [0, f1)."""
    x = torch.as_tensor(x)
    n = int(x.shape[-1])
    if f2 is None:
        f1, f2 = 0.0, float(f1)
    m = int(m if m is not None else n)
    if m < 1:
        raise ValueError("zoom_fft needs m >= 1")
    span = (f2 - f1) / (m - 1 if (endpoint and m > 1) else m)
    w_angle = -2.0 * np.pi * span / fs
    a_angle = 2.0 * np.pi * f1 / fs
    return _czt_exec(x, n, m, (0.0, w_angle),
                     _contour_params(np.exp(1j * a_angle)))


class CZT:
    """A reusable CZT plan: the contour fixed at construction, then
    ``execute`` on many blocks of n samples (the tables are cached)."""

    def __init__(self, n: int, m: int | None = None, w=None, a=1.0 + 0j,
                 *, w_angle: float | None = None):
        self.n = int(n)
        self.m = int(m if m is not None else n)
        self._w_params = _w_params(self.m, w, w_angle)
        self._a_params = _contour_params(a)

    def execute(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.as_tensor(x)
        if x.shape[-1] != self.n:
            raise ValueError(
                f"CZT plan built for n={self.n}, got {x.shape[-1]}")
        return _czt_exec(x, self.n, self.m, self._w_params, self._a_params)

    def __repr__(self):
        return f"CZT [n={self.n}] [m={self.m}] [w={self._w_params}]"
