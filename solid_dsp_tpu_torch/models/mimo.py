"""MIMO detection and space-time coding.

Port of ``solid_dsp_tpu/models/mimo.py``: spatial-multiplexing detectors for
y = H s + n (zero forcing, LMMSE by ``torch.linalg.solve``, exact ML by
enumerating the M^T hypotheses as one batched product and an argmin), the
Alamouti 2x1 space-time block code and the MIMO capacity
(``torch.linalg.slogdet``).  Everything is batched small-matrix algebra
over the leading axes; the products run under ``device.fp32_exact``, so
TF32 never rounds a complex64 product on the card.

Conventions: H[..., r, t] is the gain from TX antenna t to RX antenna r;
noise_var is per receive antenna (complex total).  The functions run where
their input lies.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..device import fp32_exact

__all__ = ["zf_detect", "mmse_detect", "ml_detect", "slice_nearest",
           "alamouti_encode", "alamouti_decode", "mimo_capacity"]


def _solve(H, y, noise_var=None):
    """(H^H H + noise_var I)^-1 H^H y (no loading where noise_var is
    None)."""
    H = torch.as_tensor(H)
    y = torch.as_tensor(y)
    Hh = torch.conj(H.transpose(-1, -2))
    with fp32_exact():
        A = Hh @ H
        b = torch.einsum("...tr,...r->...t", Hh, y)
    if noise_var is not None:
        T = H.shape[-1]
        A = A + torch.as_tensor(noise_var, device=H.device).to(H.dtype) \
            * torch.eye(T, dtype=H.dtype, device=H.device)
    return torch.linalg.solve(A, b[..., None])[..., 0]


def zf_detect(H, y):
    """Zero forcing: s_hat = (H^H H)^-1 H^H y; H (..., R, T), R >= T,
    y (..., R) -> (..., T)."""
    return _solve(H, y)


def mmse_detect(H, y, noise_var=0.0):
    """LMMSE: s_hat = (H^H H + sigma^2 I)^-1 H^H y."""
    return _solve(H, y, noise_var)


def slice_nearest(s_soft, constellation):
    """Nearest-point hard decision: (indices, points)."""
    s_soft = torch.as_tensor(s_soft)
    c = torch.as_tensor(constellation).to(s_soft.device)
    d = torch.abs(s_soft[..., None] - c) ** 2
    idx = torch.argmin(d, dim=-1)
    return idx, c[idx]


def ml_detect(H, y, constellation):
    """Exact maximum-likelihood joint detection over all M^T transmit
    vectors: ||y - H s||^2 for every hypothesis as one batched product
    (..., R, M^T), then the first minimum.  Returns (indices (..., T),
    points (..., T)); meant for small M^T (2x2 QPSK 16 ... 4x4 QPSK 256)."""
    H = torch.as_tensor(H)
    y = torch.as_tensor(y)
    c = torch.as_tensor(constellation).to(H.device)
    M = c.shape[0]
    T = H.shape[-1]
    # hypothesis h = digits of h base M, first antenna most significant
    grid = np.array(list(itertools.product(range(M), repeat=T)),
                    np.int64).T                                  # (T, M^T)
    idx_all = torch.from_numpy(grid).to(H.device)
    S_all = c[idx_all].to(H.dtype)
    with fp32_exact():
        Hs = H @ S_all                                      # (..., R, M^T)
    d = torch.sum(torch.abs(y[..., :, None] - Hs) ** 2, dim=-2)
    best = torch.argmin(d, dim=-1)
    idx = idx_all[:, best]                                       # (T, ...)
    idx = torch.movedim(idx, 0, -1)
    return idx, c[idx]


def alamouti_encode(s):
    """Alamouti 2x1 STBC: s (..., N), N even -> tx (..., N, 2): slot 2k
    sends [s0, s1], slot 2k+1 sends [-conj(s1), conj(s0)]."""
    s = torch.as_tensor(s)
    s0, s1 = s[..., 0::2], s[..., 1::2]
    slot0 = torch.stack([s0, s1], -1)
    slot1 = torch.stack([-torch.conj(s1), torch.conj(s0)], -1)
    tx = torch.stack([slot0, slot1], -2)                 # (..., N/2, 2, 2)
    return tx.reshape(*s.shape[:-1], s.shape[-1], 2)


def alamouti_decode(y, h):
    """Alamouti combining for one receive antenna: y (..., N), h (..., 2)
    or (..., N/2, 2).  Returns (s_hat (..., N), gain (..., N)) with the
    per-symbol diversity gain |h0|^2 + |h1|^2."""
    y = torch.as_tensor(y)
    h = torch.as_tensor(h)
    y0, y1 = y[..., 0::2], y[..., 1::2]
    if h.dim() == y.dim() and h.shape[-1] == 2 and \
            tuple(h.shape) != tuple(y0.shape) + (2,):
        h = h[..., None, :].expand(*y0.shape, 2)
    h0, h1 = h[..., 0], h[..., 1]
    g = (torch.abs(h0) ** 2 + torch.abs(h1) ** 2).to(y.real.dtype)
    s0 = torch.conj(h0) * y0 + h1 * torch.conj(y1)
    s1 = torch.conj(h1) * y0 - h0 * torch.conj(y1)
    s_hat = torch.stack([s0, s1], -1).reshape(*y.shape[:-1], y.shape[-1])
    gain = torch.stack([g, g], -1).reshape(*y.shape[:-1], y.shape[-1])
    return s_hat, gain


def mimo_capacity(H, snr):
    """Capacity log2 det(I + snr / T H H^H) in bits a use."""
    H = torch.as_tensor(H)
    R, T = H.shape[-2], H.shape[-1]
    with fp32_exact():
        G = H @ torch.conj(H.transpose(-1, -2))
    A = torch.eye(R, dtype=H.dtype, device=H.device) + (
        torch.as_tensor(snr, device=H.device) / T).to(H.dtype) * G
    _, logdet = torch.linalg.slogdet(A)
    return logdet.real / np.log(2.0)
