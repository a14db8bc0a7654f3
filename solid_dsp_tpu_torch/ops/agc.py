"""AGC carry and the block-mode gain update.

Port of ``solid_dsp_tpu/ops/agc.py::agc_init`` and ``block_gain_update``
(reference ``src/auto_gain_control/mod.rs``).  Block mode applies one gain
per block and updates it from the block's mean energy; the exact per-sample
and parallel modes are not ported yet (ROADMAP queue 1).
"""

from __future__ import annotations

import torch

__all__ = ["SquelchMode", "agc_init", "block_gain_update"]


class SquelchMode:
    UNKNOWN = 0
    ENABLED = 1
    RISE = 2
    SIGNALHI = 3
    FALL = 4
    SIGNALLO = 5
    TIMEOUT = 6
    DISABLED = 7


def agc_init(dtype=torch.float32, device=None) -> dict:
    """Initial AGC carry: gain, energy, lock, squelch mode and timer, as
    0-d tensors with the JAX package's dtypes."""
    return {
        "gain": torch.ones((), dtype=dtype, device=device),
        "energy": torch.ones((), dtype=dtype, device=device),
        "lock": torch.zeros((), dtype=torch.bool, device=device),
        "mode": torch.full((), SquelchMode.DISABLED, dtype=torch.int32,
                           device=device),
        "timer": torch.zeros((), dtype=torch.int32, device=device),
    }


def block_gain_update(state: dict, ee: torch.Tensor, alpha: float, T: int):
    """One block's gain/energy update from ``ee``, the mean |out|^2 over the
    T-sample block: energy tracks ee with the block's combined EMA weight
    1 - (1 - alpha)^T, and the gain is rescaled by energy^-1/2 (capped at
    1e6) when the energy is above 1e-6."""
    gain = state["gain"]
    beta = 1.0 - (1.0 - alpha) ** T
    energy = (1.0 - beta) * state["energy"] + beta * ee
    gain = torch.where(energy > 1e-6,
                       gain * torch.exp(-0.5 * torch.log(energy)), gain)
    gain = torch.clamp(gain, max=1e6)
    return {**state, "gain": gain, "energy": energy}
