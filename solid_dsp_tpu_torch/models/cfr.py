"""Crest-factor reduction by iterative clipping and filtering.

Port of ``solid_dsp_tpu/models/cfr.py``: PAPR, the polar envelope clip,
the in-band FFT mask and ICF (clip, keep only the in-band part of the
clipping error, add it back; JAX's ``lax.scan`` over iterations is a loop
here).  The FFTs are ``torch.fft`` (cuFFT on the card).  The functions
run where their input lies.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["papr_db", "clip_envelope", "cfr_icf", "band_mask"]


def papr_db(x: torch.Tensor) -> torch.Tensor:
    """Peak-to-average power ratio of a block along the last axis, dB."""
    x = torch.as_tensor(x)
    p = (x * torch.conj(x)).real
    return 10.0 * torch.log10(torch.amax(p, dim=-1) / torch.clamp(
        torch.mean(p, dim=-1), min=1e-30))


def clip_envelope(x: torch.Tensor, threshold) -> torch.Tensor:
    """Polar clip: magnitudes above ``threshold`` pulled onto the circle
    |x| = threshold, phases kept."""
    x = torch.as_tensor(x)
    r = torch.abs(x)
    scale = torch.clamp(threshold / torch.clamp(r, min=1e-30), max=1.0)
    return x * scale.to(x.dtype)


def band_mask(n: int, occupied: float) -> np.ndarray:
    """0/1 FFT-bin mask keeping the centred ``occupied`` fraction of the
    band (two-sided, FFT order)."""
    m = np.zeros(n, np.float32)
    half = max(1, int(round(n * occupied / 2)))
    m[:half] = 1.0
    m[-half:] = 1.0
    return m


def cfr_icf(x: torch.Tensor, threshold, mask, iters: int = 4):
    """Iterative clipping and filtering: ``iters`` times, the clipping
    error c = clip(y) - y is confined in band by ``mask`` (FFT order) and
    added, y <- y + ifft(fft(c) mask)."""
    y = torch.as_tensor(x)
    mask = torch.as_tensor(mask, device=y.device)
    for _ in range(int(iters)):
        c = clip_envelope(y, threshold) - y
        C = torch.fft.fft(c, dim=-1) * mask.to(c.dtype)
        y = y + torch.fft.ifft(C, dim=-1).to(y.dtype)
    return y
