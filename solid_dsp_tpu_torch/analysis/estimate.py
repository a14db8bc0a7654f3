"""Parameter estimation: tone frequency, phase and amplitude, and the time
difference of arrival (GCC-PHAT).

Port of ``solid_dsp_tpu/analysis/estimate.py``: Kay's weighted
phase-difference estimator; the padded-periodogram argmax refined by
Newton steps on the exact periodogram (JAX's 2-step ``lax.scan``, a loop
here); the ML phase and amplitude at a known frequency; GCC-PHAT with a
parabolic sub-sample peak.  Single-block functions of x (N,), run where
their input lies; the time indices are float32, as JAX's are.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["tone_freq_kay", "tone_freq_fft", "tone_phase",
           "tone_amplitude", "tdoa_gcc_phat"]


def _ramp(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.float32, device=device)


def tone_freq_kay(x: torch.Tensor) -> torch.Tensor:
    """Kay's estimator of a single complex tone's frequency (cycles a
    sample, in (-0.5, 0.5)): the parabolic weights on the angles of the
    phase increments, de-rotated first by their summed angle."""
    x = torch.as_tensor(x)
    n = x.shape[-1]
    d = x[1:] * torch.conj(x[:-1])
    k = _ramp(n - 1, x.device)
    w = 1.5 * n / (n * n - 1.0) * (1.0 - ((2 * k - (n - 2)) / n) ** 2)
    coarse = torch.angle(torch.sum(d))
    ang = coarse + torch.sum(w * torch.angle(d * torch.exp(-1j * coarse)))
    ang = (ang + np.pi) % (2 * np.pi) - np.pi
    return ang / (2 * np.pi)


def tone_freq_fft(x: torch.Tensor, pad: int = 4, newton_iters: int = 2
                  ) -> torch.Tensor:
    """ML single-tone frequency in [-0.5, 0.5): the argmax of the periodogram
    zero-padded ``pad`` times, then ``newton_iters`` Newton steps on P(f) =
    |sum x_n e^{-j 2 pi f n}|^2, each clipped to half a padded bin."""
    x = torch.as_tensor(x)
    n = x.shape[-1]
    m = pad * n
    k = torch.argmax(torch.abs(torch.fft.fft(x, m)))
    f = k.to(torch.float32) / m
    idx = _ramp(n, x.device)
    half_step = 0.5 / m
    c = -2 * np.pi
    for _ in range(newton_iters):
        e = torch.exp(-2j * np.pi * f * idx).to(x.dtype)
        s0 = torch.sum(x * e)
        s1 = torch.sum(idx * x * e)
        s2 = torch.sum(idx * idx * x * e)
        # P' = 2 Re[S' conj(S)],  P'' = 2 Re[S'' conj(S)] + 2 |S'|^2
        d1 = 2 * torch.real(1j * c * s1 * torch.conj(s0))
        d2 = (2 * torch.real(-(c ** 2) * s2 * torch.conj(s0))
              + 2 * torch.abs(1j * c * s1) ** 2)
        step = torch.where(d2 < 0, -d1 / d2, torch.zeros_like(d1))
        f = f + torch.clamp(step, -half_step, half_step)
    return torch.where(f >= 0.5, f - 1.0, f)


def _probe(x: torch.Tensor, f) -> torch.Tensor:
    n = _ramp(x.shape[-1], x.device)
    return torch.sum(x * torch.exp(-2j * np.pi * f * n))


def tone_phase(x: torch.Tensor, f) -> torch.Tensor:
    """ML phase (radians at sample 0) of a tone at the known frequency f."""
    return torch.angle(_probe(torch.as_tensor(x), f))


def tone_amplitude(x: torch.Tensor, f) -> torch.Tensor:
    """ML amplitude of a complex tone at the known frequency f."""
    x = torch.as_tensor(x)
    return torch.abs(_probe(x, f)) / x.shape[-1]


def tdoa_gcc_phat(x: torch.Tensor, y: torch.Tensor, max_lag: int):
    """GCC-PHAT delay of y relative to x (positive: y lags): (tau, the
    sub-sample estimate clipped to [-max_lag, max_lag], float32; corr, the
    (2 max_lag + 1,) PHAT correlation around lag 0)."""
    x = torch.as_tensor(x)
    y = torch.as_tensor(y, device=x.device)
    nfft = 2 * x.shape[-1]
    S = torch.fft.fft(y, nfft) * torch.conj(torch.fft.fft(x, nfft))
    S = S / (torch.abs(S) + 1e-12)
    cc = torch.fft.ifft(S)
    idx = torch.arange(-max_lag, max_lag + 1, device=x.device) % nfft
    c = torch.abs(cc[idx]) if x.is_complex() else torch.real(cc[idx])
    k = torch.argmax(c)
    cm = c[torch.clamp(k - 1, 0, 2 * max_lag)]
    c0 = c[k]
    cp = c[torch.clamp(k + 1, 0, 2 * max_lag)]
    den = cm - 2 * c0 + cp
    delta = torch.where(torch.abs(den) < 1e-12, torch.zeros_like(den),
                        0.5 * (cm - cp) / den)
    delta = torch.clamp(delta, -0.5, 0.5)
    tau = (k - max_lag).to(torch.float32) + delta
    return tau, c
