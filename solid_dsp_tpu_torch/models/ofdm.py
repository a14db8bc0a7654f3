"""CP-OFDM modem: modulation, Schmidl-Cox sync, CFO estimate, one-tap EQ.

Port of ``solid_dsp_tpu/models/ofdm.py``: ``nfft`` subcarriers,
``n_active`` centred around DC (DC unused), a cyclic prefix of ``cp``
samples, unit average power.  Modulation is one batched inverse FFT and
demodulation one FFT (``torch.fft``); the Schmidl-Cox moving sums are
ones-kernel correlations through ``ops/fir.py::conv1d_mxu``.  The preamble
is the JAX package's host numpy (the same seed).  The functions run where
their input lies and take leading axes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import device_constant
from ..ops.fir import conv1d_mxu

__all__ = [
    "active_carrier_indices",
    "ofdm_modulate",
    "ofdm_demodulate",
    "schmidl_cox_preamble",
    "schmidl_cox_metric",
    "schmidl_cox_sync",
    "estimate_channel",
    "equalize",
]


def active_carrier_indices(nfft: int, n_active: int) -> np.ndarray:
    """FFT-bin indices of the n_active used subcarriers (centred, no DC):
    +1 .. +half, then -half .. -1."""
    if n_active >= nfft or n_active % 2:
        raise ValueError("n_active must be even and < nfft")
    half = n_active // 2
    return np.concatenate([np.arange(1, half + 1),
                           np.arange(nfft - half, nfft)])


def ofdm_modulate(symbols, nfft: int, cp: int, n_active: int):
    """Frequency-domain symbols (..., T, n_active) -> serialised time stream
    (..., T (nfft + cp)) with cyclic prefix, unit average power."""
    symbols = torch.as_tensor(symbols)
    idx = device_constant(active_carrier_indices(nfft, n_active),
                          symbols.device, torch.long)
    X = symbols.new_zeros((*symbols.shape[:-1], nfft))
    X[..., idx] = symbols
    x = torch.fft.ifft(X, dim=-1) * (nfft / np.sqrt(n_active))
    x = torch.cat([x[..., nfft - cp:], x], -1)
    return x.reshape(*x.shape[:-2], -1)


def ofdm_demodulate(x, nfft: int, cp: int, n_active: int):
    """Serialised symbol-aligned stream (..., T (nfft + cp)) -> the active
    carriers of each symbol (..., T, n_active)."""
    x = torch.as_tensor(x)
    sym_len = nfft + cp
    T = x.shape[-1] // sym_len
    blocks = x[..., : T * sym_len].reshape(*x.shape[:-1], T, sym_len)
    X = torch.fft.fft(blocks[..., cp:], dim=-1) * (np.sqrt(n_active) / nfft)
    idx = device_constant(active_carrier_indices(nfft, n_active), x.device,
                          torch.long)
    return X[..., idx]


def schmidl_cox_preamble(nfft: int, cp: int, seed: int = 7) -> np.ndarray:
    """Preamble with two identical time halves (QPSK on even carriers),
    unit average power, complex64 numpy (the JAX package's draw)."""
    rng = np.random.default_rng(seed)
    X = np.zeros(nfft, np.complex128)
    even = np.arange(2, nfft, 2)
    X[even] = np.exp(1j * 0.5 * np.pi * rng.integers(0, 4, len(even)))
    x = np.fft.ifft(X) * (nfft / np.sqrt(len(even)))
    return np.concatenate([x[nfft - cp:], x]).astype(np.complex64)


def schmidl_cox_metric(x, nfft: int):
    """Sliding Schmidl-Cox metric M(d) = |P(d)|^2 / R(d)^2, P(d) =
    sum_m conj(x[d+m]) x[d+m+N/2], R(d) the second half's energy, gated to
    0 where R is below a quarter of its mean.  Returns (M, P)."""
    x = torch.as_tensor(x)
    half = nfft // 2
    prod = torch.conj(x[..., :-half]) * x[..., half:]
    ones = torch.ones(half, dtype=torch.float32, device=x.device)
    P = conv1d_mxu(prod, ones)
    e2 = torch.abs(x[..., half:]) ** 2
    R = conv1d_mxu(e2, ones.to(e2.dtype))
    floor = 0.25 * torch.mean(R, -1, keepdim=True)
    M = torch.where(R > floor,
                    torch.abs(P) ** 2 / torch.clamp(R * R, min=1e-12),
                    torch.zeros_like(R))
    return M, P


def schmidl_cox_sync(x, nfft: int, cp: int):
    """Locate the preamble and estimate the CFO: (start, cfo), ``start``
    the first sample of the preamble's body, ``cfo`` in cycles a sample.
    The plateau midpoint of the above-90%-of-peak region within +-nfft of
    the first maximum."""
    M, P = schmidl_cox_metric(x, nfft)
    d_star = torch.argmax(M, dim=-1)
    peak = torch.gather(M, -1, d_star[..., None])
    idxs = torch.arange(M.shape[-1], device=M.device)
    above = (M > 0.9 * peak) & (torch.abs(idxs - d_star[..., None]) <= nfft)
    mid = (torch.sum(torch.where(above, idxs, 0), -1).to(torch.float64)
           / torch.clamp(torch.sum(above, -1), min=1).to(torch.float64))
    start = mid.to(torch.int32)
    Pd = torch.gather(P, -1, start[..., None].long())[..., 0]
    cfo = torch.angle(Pd) / (np.pi * nfft)
    return start + cp // 2, cfo


def estimate_channel(rx_pilot, tx_pilot):
    """One-shot least-squares channel estimate per active carrier."""
    return torch.as_tensor(rx_pilot) / torch.as_tensor(tx_pilot)


def equalize(symbols, H):
    """One-tap zero-forcing equalization."""
    return torch.as_tensor(symbols) / torch.as_tensor(H)
