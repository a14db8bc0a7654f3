"""Pulse-compression radar: LFM chirps, matched filtering, range-Doppler
maps and cell-averaging CFAR.

Port of ``solid_dsp_tpu/models/radar.py``.  The matched filter is
``ops/fir.py::conv1d_mxu`` with the conjugate pulse, the Doppler map a
windowed FFT across pulses, fftshifted.

``cfar_ca`` meets the reference's fault F7: JAX forms every training
window's sum as the difference of one float32 running sum over the whole
row, whose rounding grows with the row (at 2^22 cells of unit mean its
ulp is 0.5, against window sums of ~32: thresholds off by up to ~4.5 %).
Here each window's sum is a box sum of ``train`` cells, one sliding
correlation with ones over the zero-padded row (``conv1d_mxu``, full
float32 on the card), so its error is that of a sum of ``train`` values
whatever the row's length.  The zero padding gives JAX's clipped edge
windows; the per-cell training counts and their exact multipliers are
JAX's.  The functions run where their input lies.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..ops.fir import conv1d_mxu

__all__ = ["lfm_chirp", "pulse_compress", "range_doppler_map", "cfar_ca",
           "cfar_threshold_factor"]


def lfm_chirp(n: int, bandwidth: float = 0.8) -> np.ndarray:
    """Unit-amplitude linear-FM pulse sweeping ``bandwidth`` of the sample
    rate, from -bw/2 to +bw/2 cycles a sample (complex64 numpy)."""
    t = np.arange(n, dtype=np.float64)
    phase = np.pi * bandwidth * (t * t / n - t)
    return np.exp(1j * phase).astype(np.complex64)


def pulse_compress(x, pulse) -> torch.Tensor:
    """Matched filter y[t] = sum_k conj(pulse[k]) x[t + k], the valid part
    zero-padded back to len(x) at the tail."""
    x = torch.as_tensor(x)
    p = torch.conj(torch.as_tensor(pulse, device=x.device)).to(x.dtype)
    y = conv1d_mxu(x, p)
    pad = x.shape[-1] - y.shape[-1]
    if pad > 0:
        y = torch.cat([y, y.new_zeros((*y.shape[:-1], pad))], -1)
    return y


def range_doppler_map(X, window: str = "hann") -> torch.Tensor:
    """(n_pulses, n_range) compressed CPI -> its power map with the
    Doppler (slow-time) FFT centred (fftshift along the pulse axis)."""
    X = torch.as_tensor(X)
    n_pulses = X.shape[-2]
    if window == "rect":
        w = np.ones(n_pulses)
    elif window == "hann":
        w = np.hanning(n_pulses)
    else:
        raise ValueError(f"unknown window {window!r}")
    w = torch.as_tensor(w, device=X.device).to(X.real.dtype)
    D = torch.fft.fftshift(torch.fft.fft(X * w[:, None].to(X.dtype), dim=-2),
                           dim=-2)
    return (D * torch.conj(D)).real


def cfar_threshold_factor(pfa: float, n_train: int) -> float:
    """Exact CA-CFAR multiplier for exponential noise power:
    alpha = N (Pfa^(-1/N) - 1), N = total training cells."""
    return float(n_train * (pfa ** (-1.0 / n_train) - 1.0))


@lru_cache(maxsize=4)
def _cfar_constants(N: int, guard: int, train: int, pfa: float, dtype,
                    device):
    """The per-cell training counts and their exact multipliers (JAX's
    trace-time constants), on ``device`` once per shape."""
    i = np.arange(N)
    left_n = np.clip(i - guard, 0, N) - np.clip(i - guard - train, 0, N)
    right_n = (np.clip(i + 1 + guard + train, 0, N)
               - np.clip(i + 1 + guard, 0, N))
    count = np.maximum(left_n + right_n, 1).astype(np.float64)
    alpha = count * (pfa ** (-1.0 / count) - 1.0)
    return (torch.as_tensor(count, device=device).to(dtype),
            torch.as_tensor(alpha, device=device).to(dtype))


def cfar_ca(power, guard: int = 2, train: int = 8, pfa: float = 1e-4):
    """Cell-averaging CFAR along the last axis of (..., N) nonnegative
    power.  Returns (detections bool (..., N), threshold (..., N)).  Edge
    cells with an incomplete training window use the cells they have."""
    p = torch.as_tensor(power)
    N = p.shape[-1]
    G = guard + train
    # box[k] = sum of train cells from k of the row zero-padded by G
    pz = torch.cat([p.new_zeros((*p.shape[:-1], G)), p,
                    p.new_zeros((*p.shape[:-1], G))], -1)
    box = conv1d_mxu(pz, torch.ones(train, dtype=p.dtype, device=p.device))
    left_sum = box[..., :N]                          # cells i-G .. i-guard-1
    right_sum = box[..., G + guard + 1: G + guard + 1 + N]
    count, alpha = _cfar_constants(N, int(guard), int(train), float(pfa),
                                   p.dtype, p.device)
    thr = alpha * ((left_sum + right_sum) / count)
    return p > thr, thr
