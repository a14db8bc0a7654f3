"""Front-end impairment estimation and correction: DC offset, IQ imbalance,
impulse blanking.

Port of ``solid_dsp_tpu/models/impairments.py`` (:36-172).  Model: the
received r = dc + alpha s + beta conj(s) for a proper signal s
(E[s^2] = 0), so dc = E[r], and with r0 = r - dc the blind ratio
k = beta / conj(alpha) ~= E[r0^2] / (2 E[|r0|^2]); the correction
y = r0 - k conj(r0) suppresses the image to second order.  Every estimator
is a reduction over the block.  The receive chain's ``impairment_bw`` stage
runs :func:`ema_correct` per block, with (dc, k, primed) in its state.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["noise_blanker", "estimate_dc", "estimate_iq_imbalance",
           "correct", "apply_iq_imbalance", "image_rejection_db",
           "ema_correct", "ImpairmentCorrector"]


def estimate_dc(x: torch.Tensor) -> torch.Tensor:
    """LO-leakage estimate: the complex mean over the block."""
    return torch.mean(x, dim=-1)


def estimate_iq_imbalance(x: torch.Tensor) -> torch.Tensor:
    """Blind imbalance ratio k such that y = x0 - k conj(x0), x0 = x - dc,
    suppresses the image: 0.5 E[x0^2] / E[|x0|^2]."""
    x0 = x - torch.mean(x, dim=-1, keepdim=True)
    c2 = torch.mean(x0 * x0, dim=-1)
    p = torch.mean(x0 * x0.conj(), dim=-1).real
    return 0.5 * c2 / (p + 1e-30)


def correct(x: torch.Tensor, dc, k) -> torch.Tensor:
    """DC removal and image cancellation: (x - dc) - k conj(x - dc)."""
    dc = torch.as_tensor(dc, device=x.device)
    k = torch.as_tensor(k, device=x.device)
    x0 = x - (dc[..., None] if dc.dim() else dc)
    return x0 - (k[..., None] if k.dim() else k) * x0.conj()


def apply_iq_imbalance(s, gain_db: float, phase_deg: float, dc=0.0):
    """An impaired signal (tests, simulation): dc + alpha s + beta conj(s),
    alpha = (1 + g e^{-j phi}) / 2, beta = (1 - g e^{+j phi}) / 2,
    g = 10^(gain_db / 20), phi in radians; complex128, as the JAX package's
    numpy-scalar coefficients make it."""
    g = 10.0 ** (gain_db / 20.0)
    phi = np.deg2rad(phase_deg)
    alpha = complex(0.5 * (1.0 + g * np.exp(-1j * phi)))
    beta = complex(0.5 * (1.0 - g * np.exp(1j * phi)))
    s = (s if isinstance(s, torch.Tensor)
         else torch.from_numpy(np.array(s, copy=True))).to(torch.complex128)
    return dc + alpha * s + beta * s.conj()


def image_rejection_db(x) -> float:
    """IRR: the power of the proper part over the improper part, in dB."""
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x
    x0 = np.asarray(x) - np.mean(np.asarray(x))
    c2 = abs(np.mean(x0 * x0))
    p = float(np.mean(np.abs(x0) ** 2))
    return float(10.0 * np.log10(p / (c2 + 1e-30)))


def ema_correct(x: torch.Tensor, dc_prev: torch.Tensor, k_prev: torch.Tensor,
                bandwidth, primed):
    """Estimate, blend into the carried estimates (an EMA of weight
    ``bandwidth`` a block once ``primed``, else the block's own), correct.
    ``bandwidth`` is a Python float or a tensor (the chain passes one of its
    complex type); ``primed`` a bool or a bool tensor.  Returns
    (y, dc, k)."""
    dc_new = estimate_dc(x)
    k_new = estimate_iq_imbalance(x).to(dc_prev.dtype)
    b = bandwidth
    use = torch.as_tensor(primed, device=x.device)
    dc = torch.where(use, (1.0 - b) * dc_prev + b * dc_new, dc_new)
    k = torch.where(use, (1.0 - b) * k_prev + b * k_new, k_new)
    return correct(x, dc, k), dc, k


class ImpairmentCorrector:
    """Streaming corrector with EMA-tracked estimates (bandwidth per block),
    its estimates on ``device`` (the card unless told otherwise)."""

    def __init__(self, bandwidth: float = 0.1, dtype=torch.complex64,
                 device=None):
        if not (0.0 < bandwidth <= 1.0):
            raise ValueError("bandwidth in (0, 1]")
        self.bandwidth = float(bandwidth)
        self.device = resolve_device(device)
        self._dc = torch.zeros((), dtype=dtype, device=self.device)
        self._k = torch.zeros((), dtype=dtype, device=self.device)
        self._primed = False

    @property
    def dc(self) -> complex:
        return complex(self._dc)

    @property
    def k(self) -> complex:
        return complex(self._k)

    def execute_block(self, x):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x, copy=True))
        x = x.to(device=self.device, dtype=self._dc.dtype)
        y, self._dc, self._k = ema_correct(x, self._dc, self._k,
                                           self.bandwidth, self._primed)
        self._primed = True
        return y

    def reset(self):
        self._dc = torch.zeros_like(self._dc)
        self._k = torch.zeros_like(self._k)
        self._primed = False

    def __repr__(self):
        return (f"ImpairmentCorrector [dc={self.dc:.2g}] [k={self.k:.2g}] "
                f"[bw={self.bandwidth}]")


def noise_blanker(x: torch.Tensor, k: float = 6.0):
    """Impulse-noise blanker: zero the samples whose envelope exceeds k
    times the median envelope (the midpoint of the two middle values for an
    even length, as ``jnp.median``).  Returns (cleaned, blanked_fraction)."""
    r = torch.abs(x)
    n = r.shape[-1]
    s = torch.sort(r, dim=-1).values
    scale = ((s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5)[..., None]
    keep = r <= k * torch.clamp(scale, min=1e-30)
    y = torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))
    return y, 1.0 - torch.mean(keep.to(torch.float32), dim=-1)
