"""Pilot-aided OFDM: comb pilots, LS channel estimation, CPE tracking.

Port of ``solid_dsp_tpu/models/ofdm_pilots.py``.  The pilot layout, the
pilot values and the interpolation matrix W are the JAX package's host
numpy; pilot insertion and extraction index by them; the LS estimates at
the pilots reach every carrier through one (T, P) @ (P, K) product with W
(under ``device.fp32_exact``, so TF32 never rounds it); the common phase is
a per-symbol pilot correlation.  The functions run where their input lies.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import device_constant, fp32_exact

__all__ = [
    "active_carrier_coords",
    "comb_pilot_indices",
    "pilot_values",
    "insert_pilots",
    "interp_matrix",
    "ls_channel_estimate",
    "common_phase_error",
    "equalize_mmse",
    "ofdm_pilot_receive",
]


def active_carrier_coords(nfft: int, n_active: int) -> np.ndarray:
    """Signed carrier frequencies aligned to ``models/ofdm.py``'s active
    vector (+1..+half, -half..-1): interpolate in this space, never across
    the mid-vector wrap."""
    from .ofdm import active_carrier_indices

    idx = active_carrier_indices(nfft, n_active).astype(np.int64)
    return np.where(idx <= nfft // 2, idx, idx - nfft)


def comb_pilot_indices(n_active: int, spacing: int, offset: int = 0,
                       coords: np.ndarray | None = None
                       ) -> tuple[np.ndarray, np.ndarray]:
    """(pilot_idx, data_idx) within the active-carrier vector: every
    ``spacing``-th carrier in frequency order (``coords``; vector order if
    None) from ``offset``, both band edges pinned as pilots."""
    if not 0 <= offset < spacing:
        raise ValueError("offset must be in [0, spacing)")
    if spacing < 2 or spacing >= n_active:
        raise ValueError("spacing must be in [2, n_active)")
    order = (np.argsort(np.asarray(coords)) if coords is not None
             else np.arange(n_active))
    sel = np.zeros(n_active, bool)
    sel[np.arange(offset, n_active, spacing)] = True
    sel[0] = sel[n_active - 1] = True
    pil = np.sort(order[sel])
    data = np.setdiff1d(np.arange(n_active), pil)
    return pil.astype(np.int32), data.astype(np.int32)


def pilot_values(n_pilots: int, seed: int = 11) -> np.ndarray:
    """Deterministic unit-modulus QPSK pilot sequence (complex64 numpy)."""
    rng = np.random.default_rng(seed)
    return np.exp(1j * 0.5 * np.pi * rng.integers(0, 4, n_pilots)
                  ).astype(np.complex64)


def _index(idx, dev) -> torch.Tensor:
    if isinstance(idx, torch.Tensor):
        return idx.to(dev, torch.long)
    return device_constant(np.asarray(idx, np.int64), dev, torch.long)


def insert_pilots(data_syms, pilots, pilot_idx, data_idx, n_active: int):
    """Data (..., T, D) and pilots (P,) -> active-carrier grid
    (..., T, n_active)."""
    data_syms = torch.as_tensor(data_syms)
    dev = data_syms.device
    X = data_syms.new_zeros((*data_syms.shape[:-1], n_active))
    X[..., _index(data_idx, dev)] = data_syms
    p = torch.as_tensor(pilots).to(dev, data_syms.dtype)
    X[..., _index(pilot_idx, dev)] = p.expand(*X.shape[:-1], p.shape[-1])
    return X


def interp_matrix(pilot_idx: np.ndarray, n_active: int,
                  coords: np.ndarray | None = None) -> np.ndarray:
    """(n_active, P) float32 linear-interpolation matrix W, H_full =
    H_pilots @ W.T, along ``coords`` (vector index if None); rows at pilots
    one-hot, outside the pilot span clamped to the nearest pilot."""
    pil = np.asarray(pilot_idx, np.int64)
    P = pil.size
    c = (np.asarray(coords, np.float64) if coords is not None
         else np.arange(n_active, dtype=np.float64))
    order = np.argsort(c[pil])
    pc = c[pil[order]]
    W = np.zeros((n_active, P), np.float32)
    seg = np.clip(np.searchsorted(pc, c, side="right") - 1, 0, P - 2)
    lo, hi = pc[seg], pc[seg + 1]
    t = np.clip((c - lo) / np.maximum(hi - lo, 1e-12), 0.0, 1.0)
    W[np.arange(n_active), order[seg]] = 1.0 - t
    np.add.at(W, (np.arange(n_active), order[seg + 1]), t)
    return W


def ls_channel_estimate(rx_grid, pilots, pilot_idx, W):
    """LS estimate at the pilots, linearly interpolated to every carrier:
    rx_grid (..., T, K) -> H (..., T, K)."""
    rx_grid = torch.as_tensor(rx_grid)
    dev = rx_grid.device
    Hp = rx_grid[..., _index(pilot_idx, dev)] / torch.as_tensor(
        pilots).to(dev)
    Wt = torch.as_tensor(W).to(dev).T.to(Hp.dtype)
    with fp32_exact():
        return Hp @ Wt


def common_phase_error(rx_grid, H, pilots, pilot_idx):
    """Per-symbol residual common phase (..., T) in radians:
    angle(sum_p conj(H_p a_p) y_p)."""
    rx_grid = torch.as_tensor(rx_grid)
    idx = _index(pilot_idx, rx_grid.device)
    y = rx_grid[..., idx]
    ref = torch.as_tensor(H)[..., idx] * torch.as_tensor(pilots).to(
        rx_grid.device)
    return torch.angle(torch.sum(y * torch.conj(ref), -1))


def equalize_mmse(symbols, H, snr_linear):
    """One-tap MMSE conj(H) / (|H|^2 + 1 / snr) (ZF as snr -> inf)."""
    symbols, H = torch.as_tensor(symbols), torch.as_tensor(H)
    H2 = (H * torch.conj(H)).real
    return symbols * torch.conj(H) / (H2 + 1.0 / snr_linear).to(H.dtype)


def ofdm_pilot_receive(rx_grid, pilots, pilot_idx, data_idx, W,
                       snr_linear: float = 1e4, cpe_track: bool = True):
    """Pilot-aided receive: LS + interpolation channel, optional CPE
    removal, MMSE equalisation.  Returns (data_syms, H, cpe_phase)."""
    rx_grid = torch.as_tensor(rx_grid)
    H = ls_channel_estimate(rx_grid, pilots, pilot_idx, W)
    if cpe_track:
        ph = common_phase_error(rx_grid, H, pilots, pilot_idx)
        rx_grid = rx_grid * torch.exp(-1j * ph)[..., None].to(rx_grid.dtype)
    else:
        ph = torch.zeros(rx_grid.shape[:-1], dtype=torch.float32,
                         device=rx_grid.device)
    eq = equalize_mmse(rx_grid, H, snr_linear)
    return eq[..., _index(data_idx, rx_grid.device)], H, ph
