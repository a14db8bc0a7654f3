"""Signal-quality estimates: blind M2M4 SNR, EVM, noise floor, tone SNR.

Port of ``solid_dsp_tpu/analysis/snr.py``: one-pass reductions over the
last axis, run where their input lies.  The medians (``noise_floor`` and
the non-peak bins of ``tone_snr``) average the two middle values on an
even count, as ``jnp.median`` and ``jnp.nanmedian`` do.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["snr_m2m4", "evm", "noise_floor", "tone_snr"]


def snr_m2m4(x: torch.Tensor, kurtosis: float = 1.0) -> torch.Tensor:
    """Blind M2M4 moment SNR (linear) of a modulated signal in complex
    AWGN: with M2 = E|x|^2 and M4 = E|x|^4, S = sqrt((M4 - 2 M2^2) / (ka -
    2)), N = M2 - S, ka the constellation's kurtosis (1 for constant
    modulus, 1.32 for 16-QAM; 2 is not identifiable and raises).  Returns
    S/N clamped at >= 0."""
    ka = float(kurtosis)
    if abs(ka - 2.0) < 1e-9:
        raise ValueError("kurtosis 2.0 (Gaussian-like signal) is not "
                         "identifiable by the M2M4 estimator")
    x = torch.as_tensor(x)
    ax2 = torch.real(x * torch.conj(x))
    m2 = torch.mean(ax2, dim=-1)
    m4 = torch.mean(ax2 * ax2, dim=-1)
    s = torch.sqrt(torch.clamp((m4 - 2.0 * m2 * m2) / (ka - 2.0), min=0.0))
    n = torch.clamp(m2 - s, min=1e-30)
    return torch.clamp(s, min=0.0) / n


def evm(y: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """RMS error-vector magnitude of symbols y against ``ref`` (same
    shape), over the reference's RMS power: the linear fraction."""
    y = torch.as_tensor(y)
    ref = torch.as_tensor(ref, device=y.device)
    e = y - ref.to(y.dtype)
    num = torch.mean(torch.real(e * torch.conj(e)), dim=-1)
    den = torch.clamp(torch.mean(torch.real(ref * torch.conj(ref)), dim=-1),
                      min=1e-30)
    return torch.sqrt(num / den)


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median along the last axis: (lo + hi) * 0.5 of the sorted middle."""
    s, _ = torch.sort(x, dim=-1)
    n = s.shape[-1]
    return (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5


def noise_floor(psd: torch.Tensor, averages: int = 0) -> torch.Tensor:
    """The median bin power of a PSD, corrected for the chi-square median
    bias of ``averages`` averaged periodograms: ln 2 for one, the
    Wilson-Hilferty (1 - 1/(9F))^3 for F > 1, none for 0 (well averaged)."""
    med = _median(torch.real(torch.as_tensor(psd)))
    if averages <= 0:
        return med
    if averages == 1:
        return med / float(np.log(2.0))
    return med / float((1.0 - 1.0 / (9.0 * averages)) ** 3)


def tone_snr(x: torch.Tensor, guard: int = 2):
    """SNR of the strongest tone of a block: its FFT bin and ``guard`` bins
    to either side against the median of the other bins (bias-corrected by
    ln 2).  Returns (snr linear, frequency in cycles a sample, float32)."""
    x = torch.as_tensor(x)
    n = x.shape[-1]
    X = torch.fft.fft(x, dim=-1)
    p = torch.real(X * torch.conj(X))
    k0 = torch.argmax(p, dim=-1, keepdim=True)
    idx = torch.arange(n, device=x.device)
    d = torch.abs((idx - k0 + n // 2) % n - n // 2)
    in_peak = d <= guard
    sig = torch.sum(torch.where(in_peak, p, 0.0), dim=-1)
    # the non-peak bins' median: the peak's 2 guard + 1 bins sorted last
    rest, _ = torch.sort(torch.where(in_peak, torch.inf, p), dim=-1)
    cnt = n - (2 * guard + 1)
    floor = (rest[..., (cnt - 1) // 2] + rest[..., cnt // 2]) * 0.5 / float(
        np.log(2.0))
    snr = torch.clamp(sig - floor * (2 * guard + 1), min=0.0) / torch.clamp(
        floor * n, min=1e-30)
    freq = k0[..., 0].to(torch.float32) / n
    return snr, torch.where(freq > 0.5, freq - 1.0, freq)
