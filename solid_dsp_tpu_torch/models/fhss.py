"""Frequency-hopping spread spectrum (FHSS).

Port of ``solid_dsp_tpu/models/fhss.py``: the carrier hops over
``n_channels`` sub-bands on a pseudo-random schedule, one hop per
``dwell`` samples.  Hopping is a closed-form rotation: the block reshaped
to (hops, dwell) times exp(+-j phase) with each dwell's phase ramp from a
host float64 table (``_hop_phases``, rounded to the data's real type as in
JAX), so hop and dehop are exact conjugates.  Schedules take
log2(n_channels) chips at a time of an m-sequence
(``utils/sequences.m_sequence``).  ``FHSS`` runs on ``device`` (the card
by default).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import bind_device
from ..utils.sequences import m_sequence

__all__ = ["hop_schedule", "FHSS"]


def hop_schedule(n_channels: int, n_hops: int, seed: int = 1) -> np.ndarray:
    """Pseudo-random channel indices (n_hops,) int32 in [0, n_channels),
    from consecutive log2(n_channels) chips of an m-sequence (host);
    n_channels a power of two."""
    if n_channels < 2 or n_channels & (n_channels - 1):
        raise ValueError("n_channels must be a power of two >= 2")
    k = int(np.log2(n_channels))
    nbits = max(k + 1, 10)
    seq = np.asarray(m_sequence(nbits, seed=seed), np.int64)
    need = n_hops * k
    reps = -(-need // len(seq))
    chips = np.tile(seq, reps)[:need].reshape(n_hops, k)
    return (chips << np.arange(k - 1, -1, -1)).sum(axis=1).astype(np.int32)


def _hop_phases(schedule: np.ndarray, n_channels: int, dwell: int,
                bandwidth: float) -> np.ndarray:
    """(n_hops, dwell) float64 phase table, host side."""
    freqs = (np.asarray(schedule, np.float64) / n_channels - 0.5) * bandwidth
    t = np.arange(dwell, dtype=np.float64)
    return 2.0 * np.pi * freqs[:, None] * t[None, :]


def _apply_hops(x: torch.Tensor, phases: np.ndarray, dwell: int,
                conj: bool) -> torch.Tensor:
    n_hops = x.shape[-1] // dwell
    xb = x[..., : n_hops * dwell].reshape(*x.shape[:-1], n_hops, dwell)
    ph = torch.from_numpy(phases).to(x.device, xb.real.dtype)
    rot = torch.exp((-1j if conj else 1j) * ph).to(xb.dtype)
    return (xb * rot).reshape(*x.shape[:-1], n_hops * dwell)


class FHSS:
    """Hop and dehop a baseband stream over a pseudo-random channel plan:
    ``n_channels`` (a power of two) sub-bands across ``bandwidth`` cycles a
    sample, ``dwell`` samples a hop; the signal must fit in one sub-band.
    Runs on ``device`` (the card unless told otherwise)."""

    def __init__(self, n_channels: int = 16, dwell: int = 256,
                 bandwidth: float = 0.9, seed: int = 1, device=None):
        if dwell < 1:
            raise ValueError("dwell must be >= 1")
        if not (0.0 < bandwidth <= 1.0):
            raise ValueError("bandwidth in (0, 1] cycles/sample")
        if n_channels < 2 or n_channels & (n_channels - 1):
            raise ValueError("n_channels must be a power of two >= 2")
        self.n_channels = int(n_channels)
        self.dwell = int(dwell)
        self.bandwidth = float(bandwidth)
        self.seed = int(seed)
        self.device = bind_device(device)

    def schedule(self, n_hops: int) -> np.ndarray:
        return hop_schedule(self.n_channels, n_hops, self.seed)

    def _run(self, x, conj: bool) -> torch.Tensor:
        x = torch.as_tensor(x).to(self.device)
        if x.shape[-1] % self.dwell:
            raise ValueError("length must be a multiple of the dwell")
        sched = self.schedule(x.shape[-1] // self.dwell)
        return _apply_hops(x, _hop_phases(sched, self.n_channels, self.dwell,
                                          self.bandwidth), self.dwell, conj)

    def hop(self, x) -> torch.Tensor:
        """Spread: each dwell mixed up to its scheduled sub-band."""
        return self._run(x, False)

    def dehop(self, x) -> torch.Tensor:
        """Despread with the same schedule (the exact inverse of hop)."""
        return self._run(x, True)

    def __repr__(self):
        return (f"FHSS [channels={self.n_channels}] [dwell={self.dwell}]"
                f" [bw={self.bandwidth}]")
