"""Discrete wavelet transforms: the Mallat analysis and synthesis cascades.

Port of ``solid_dsp_tpu/ops/wavelet.py``: the orthogonal Daubechies family
(haar = db1, db2, db4) with whole-block periodic extension, each level one
stride-2 correlation (analysis) or two phase correlations interleaved
(synthesis) on ``ops/fir.py::conv1d_mxu``, so the cascade reconstructs
exactly; VisuShrink soft-threshold denoising.  Tensor functions: they run
where their input lies.

The MAD of ``denoise_soft`` is the median of at most ``sigma_samples``
finest-detail magnitudes, by a sort: on an even count it averages the two
middle values, as ``jnp.median`` does (``torch.median`` returns the lower
one).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import device_constant
from .fir import conv1d_mxu

__all__ = ["wavelet_filters", "dwt", "idwt", "wavedec", "waverec",
           "denoise_soft"]

# orthonormal lowpass decomposition filters
_DB = {
    "haar": np.array([1.0, 1.0]) / np.sqrt(2.0),
    "db2": np.array([0.48296291314469025, 0.836516303737469,
                     0.22414386804185735, -0.12940952255092145]),
    "db4": np.array([0.23037781330885523, 0.7148465705525415,
                     0.6308807679295904, -0.02798376941698385,
                     -0.18703481171888114, 0.030841381835986965,
                     0.032883011666982945, -0.010597401784997278]),
}


def wavelet_filters(name: str):
    """(dec_lo, dec_hi, rec_lo, rec_hi) of an orthogonal wavelet, float64:
    g[k] = (-1)^k h[L-1-k], the reconstruction filters time-reversed."""
    if name not in _DB:
        raise ValueError(f"unknown wavelet {name!r}; one of {sorted(_DB)}")
    h = _DB[name]
    g = ((-1.0) ** np.arange(len(h))) * h[::-1]
    return h, g, h[::-1].copy(), g[::-1].copy()


def _taps(taps_np: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """Host taps reversed, in x's real type on x's device."""
    rdt = x.real.dtype if x.is_complex() else x.dtype
    return device_constant(np.asarray(taps_np)[::-1].copy(), x.device, rdt)


def _periodic_conv_down(x: torch.Tensor, taps_np) -> torch.Tensor:
    """y[m] = sum_k taps[k] x[(2m + 1 - k) mod N]: one stride-2 correlation
    on x with its last len(taps) - 2 samples prepended."""
    o = len(taps_np) - 2
    w = torch.cat([x[..., x.shape[-1] - o:], x], dim=-1) if o else x
    return conv1d_mxu(w, _taps(taps_np, x), stride=2)


def _upsample_periodic_conv(c: torch.Tensor, taps_np) -> torch.Tensor:
    """y[n] = sum_k taps[k] u[(n - k) mod 2N], u the zero-stuffed c, as its
    two output phases y[2s + par] = sum_j taps[2j + par] c[(s - j) mod N]
    (two circular correlations), interleaved."""
    tn = np.asarray(taps_np)
    N = c.shape[-1]
    phases = []
    for par in (0, 1):
        tp = tn[par::2]
        o = len(tp) - 1
        w = torch.cat([c[..., N - o:], c], dim=-1) if o else c
        phases.append(conv1d_mxu(w, _taps(tp, c)))
    return torch.stack(phases, dim=-1).reshape(*c.shape[:-1], 2 * N)


def dwt(x: torch.Tensor, wavelet: str = "db4"):
    """One analysis level: x (..., N even) -> (approx, detail), each N/2."""
    h, g, _, _ = wavelet_filters(wavelet)
    x = torch.as_tensor(x)
    return (_periodic_conv_down(x, h[::-1]), _periodic_conv_down(x, g[::-1]))


def idwt(ca: torch.Tensor, cd: torch.Tensor, wavelet: str = "db4"):
    """The inverse of one level: (approx, detail) -> (..., 2 len)."""
    _, _, rl, rh = wavelet_filters(wavelet)
    a = _upsample_periodic_conv(ca, rl[::-1])
    d = _upsample_periodic_conv(cd, rh[::-1])
    # the circular round trip's delay with the odd-phase analysis: L - 2
    return torch.roll(a + d, -(len(rl) - 2), dims=-1)


def wavedec(x: torch.Tensor, wavelet: str = "db4", levels: int = 3):
    """Multi-level analysis: [cA_L, cD_L, ..., cD_1]."""
    coeffs = []
    a = torch.as_tensor(x)
    for _ in range(levels):
        if a.shape[-1] % 2:
            raise ValueError("signal length must be divisible by 2^levels")
        a, d = dwt(a, wavelet)
        coeffs.append(d)
    coeffs.append(a)
    return coeffs[::-1]


def waverec(coeffs, wavelet: str = "db4"):
    """The inverse of :func:`wavedec`."""
    a = coeffs[0]
    for d in coeffs[1:]:
        a = idwt(a, d, wavelet)
    return a


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median along the last axis, keeping it: the two middle values'
    mean on an even count ((lo + hi) * 0.5, ``jnp.median``'s midpoint)."""
    s, _ = torch.sort(x, dim=-1)
    n = s.shape[-1]
    lo, hi = (n - 1) // 2, n // 2
    return ((s[..., lo] + s[..., hi]) * 0.5)[..., None]


def denoise_soft(x: torch.Tensor, wavelet: str = "db4", levels: int = 3,
                 threshold=None, sigma_samples: int | None = 65536):
    """Wavelet soft-threshold denoising (VisuShrink): the threshold defaults
    to sigma sqrt(2 ln N), sigma the finest detail level's median absolute
    value / 0.6745 over its first ``sigma_samples`` coefficients (None: all
    of them)."""
    x = torch.as_tensor(x)
    coeffs = wavedec(x, wavelet, levels)
    d1 = coeffs[-1]
    if threshold is None:
        if sigma_samples is not None and d1.shape[-1] > sigma_samples:
            d1 = d1[..., :sigma_samples]
        sigma = _median(torch.abs(d1)) / 0.6745
        threshold = sigma * np.sqrt(2.0 * np.log(x.shape[-1]))
    thr = torch.as_tensor(threshold, device=x.device)
    out = [coeffs[0]]
    for d in coeffs[1:]:
        out.append(torch.sgn(d) * torch.clamp(torch.abs(d) - thr, min=0.0))
    return waverec(out, wavelet)
