"""Energy burst detection: sliding power and the hysteresis gate.

Port of ``solid_dsp_tpu/models/detect.py::sliding_energy_db`` and
``hysteresis_gate`` (:33-73), the pieces ``ChannelBank``'s squelch runs.
The sliding energy is a float32 cumsum difference, as in the JAX package
(so the two agree to its rounding).  The gate, a per-sample state machine,
is "the last non-HOLD classification": each sample is ON (above high), OFF
(below low) or HOLD, and the JAX package's associative scan becomes a
running maximum (``cummax``) over the indices of the non-HOLD samples and
one gather; no Python loop over time.
"""

from __future__ import annotations

import torch

__all__ = ["sliding_energy_db", "hysteresis_gate"]

_HOLD = -1


def sliding_energy_db(x: torch.Tensor, tail: torch.Tensor, window: int):
    """Moving-average power in dB over ``window`` samples along the last
    axis.  tail: the previous block's last ``window`` samples (zeros at the
    start).  Returns (e_db (..., T), new_tail)."""
    e2 = (x * x.conj()).real
    t2 = (tail * tail.conj()).real
    c = torch.cumsum(torch.cat([t2, e2], dim=-1), dim=-1)
    mean = (c[..., window:] - c[..., :-window]) / window
    mean = mean[..., mean.shape[-1] - x.shape[-1]:]
    ext = torch.cat([tail.to(x.dtype), x], dim=-1)
    return 10.0 * torch.log10(mean + 1e-30), ext[..., ext.shape[-1] - window:]


def hysteresis_gate(e_db: torch.Tensor, high_db, low_db, init_on):
    """Two-threshold gate: ON once e rises above high_db, until it falls
    below low_db; leading axes batch.  e_db (..., T), init_on (...,) bool.
    Returns (gate bool (..., T), final (...,) bool)."""
    raw = torch.where(e_db > high_db, 1,
                      torch.where(e_db < low_db, 0, _HOLD)).to(torch.int32)
    init = torch.as_tensor(init_on, device=e_db.device).to(torch.int32)
    init = init.expand(raw.shape[:-1])
    seq = torch.cat([init[..., None], raw], dim=-1)      # seq[..., 0] != HOLD
    idx = torch.arange(seq.shape[-1], device=seq.device).expand(seq.shape)
    last = torch.cummax(torch.where(seq != _HOLD, idx, 0), dim=-1).values
    st = torch.gather(seq, -1, last)[..., 1:]
    return st == 1, st[..., -1] == 1
