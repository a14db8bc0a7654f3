"""AGC carry, the block-mode gain update and the block-mode AGC.

Port of ``solid_dsp_tpu/ops/agc.py::agc_init`` (:51-72),
``block_gain_update`` (:374-387) and ``agc_apply_block_mode`` (:390-402)
(reference ``src/auto_gain_control/mod.rs``).  Block mode applies one gain
per block and updates it from the block's mean energy; a carry with a
batch shape holds one gain per leading index of the block (one per channel
of a channel bank).  The exact per-sample and parallel modes are not ported
yet (ROADMAP queue 1).
"""

from __future__ import annotations

import torch

from ..device import resolve_device

__all__ = ["SquelchMode", "agc_init", "block_gain_update",
           "agc_apply_block_mode"]


class SquelchMode:
    UNKNOWN = 0
    ENABLED = 1
    RISE = 2
    SIGNALHI = 3
    FALL = 4
    SIGNALLO = 5
    TIMEOUT = 6
    DISABLED = 7


def agc_init(dtype=torch.float32, device=None, batch_shape: tuple = ()
             ) -> dict:
    """Initial AGC carry: gain, energy, lock, squelch mode and timer, each
    of shape ``batch_shape`` with the JAX package's dtypes, on ``device``
    (the card unless told otherwise)."""
    device = resolve_device(device)
    shape = tuple(batch_shape)
    return {
        "gain": torch.ones(shape, dtype=dtype, device=device),
        "energy": torch.ones(shape, dtype=dtype, device=device),
        "lock": torch.zeros(shape, dtype=torch.bool, device=device),
        "mode": torch.full(shape, SquelchMode.DISABLED, dtype=torch.int32,
                           device=device),
        "timer": torch.zeros(shape, dtype=torch.int32, device=device),
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


def agc_apply_block_mode(state: dict, x: torch.Tensor, alpha: float):
    """Block-mode AGC: scale the block by the carried gain, then update the
    gain from the mean |out|^2 of the scaled block.  A gain with a batch
    shape scales the matching leading dims of x (..., T), one gain per row.
    Returns (out, state)."""
    gain = state["gain"].to(x.dtype)
    out = x * (gain[..., None] if gain.dim() else gain)
    ee = torch.mean((out * out.conj()).real, dim=-1)
    return out, block_gain_update(state, ee, alpha, x.shape[-1])
