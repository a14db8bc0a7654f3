"""Energy burst detection: sliding power, the hysteresis gate and burst
edges.

Port of ``solid_dsp_tpu/models/detect.py``: ``sliding_energy_db`` and
``hysteresis_gate`` (:33-73), the pieces ``ChannelBank``'s squelch runs,
and ``burst_edges``, ``_detector_block`` and the streaming
``BurstDetector`` (:77-140).
The sliding energy is a float32 cumsum difference, as in the JAX package
(so the two agree to its rounding).  The gate, a per-sample state machine,
is "the last non-HOLD classification": each sample is ON (above high), OFF
(below low) or HOLD, and the JAX package's associative scan becomes a
running maximum (``cummax``) over the indices of the non-HOLD samples and
one gather; no Python loop over time.  The edge lists keep JAX's fixed
length (``jnp.nonzero(size=k, fill_value=-1)``): each edge's rank is a
cumsum and the first k are scattered into a row of -1, on the card and
without a host sync.  ``BurstDetector`` keeps its state (the energy tail
and the gate latch) on its device; ``state`` reads and sets it as
``{"tail", "on"}``, the JAX object's attribute names.
"""

from __future__ import annotations

import torch

from ..device import bind_device

__all__ = ["sliding_energy_db", "hysteresis_gate", "burst_edges",
           "BurstDetector"]

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


def _first_indices(mask: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the first k True entries of a 1-D mask, padded with
    -1 to length k (int32), on the mask's device without a host sync."""
    T = mask.shape[-1]
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    slot = torch.where(mask & (rank < k), rank, k)
    out = torch.full((k + 1,), -1, dtype=torch.int64, device=mask.device)
    out.scatter_(0, slot, torch.arange(T, device=mask.device))
    return out[:k].to(torch.int32)


def burst_edges(gate: torch.Tensor, prev_last, max_bursts: int):
    """Rising and falling edge indices of a 1-D gate, each an int32 row of
    length ``max_bursts`` padded with -1.  ``prev_last`` is the previous
    block's final gate value, so a burst spanning a block boundary does
    not count its rise twice.  Returns (rises, falls)."""
    prev = torch.as_tensor(prev_last, device=gate.device).to(torch.bool)
    prev = torch.cat([prev.reshape(1), gate[:-1]])
    return (_first_indices(gate & ~prev, max_bursts),
            _first_indices(~gate & prev, max_bursts))


def _detector_block(x, tail, on, window: int, high_db, low_db,
                    max_bursts: int):
    """A detector block: the energy, the gate and the edges.  Returns
    (dict(gate, e_db, rises, falls), new_tail, new_on)."""
    e_db, new_tail = sliding_energy_db(x, tail, window)
    gate, on_new = hysteresis_gate(e_db, high_db, low_db, on)
    rises, falls = burst_edges(gate, on, max_bursts)
    return ({"gate": gate, "e_db": e_db, "rises": rises, "falls": falls},
            new_tail, on_new)


class BurstDetector:
    """Streaming burst detector: ``execute_block(x)`` -> dict(gate, e_db,
    rises, falls); the energy tail and the gate latch carry across blocks,
    on ``device`` (the card unless told otherwise)."""

    def __init__(self, window: int = 64, high_db: float = -20.0,
                 low_db: float | None = None, max_bursts: int = 64,
                 dtype=torch.complex64, device=None):
        if low_db is None:
            low_db = high_db - 3.0
        if low_db > high_db:
            raise ValueError("low_db must not exceed high_db")
        self.window = int(window)
        self.high_db = float(high_db)
        self.low_db = float(low_db)
        self.max_bursts = int(max_bursts)
        self.device = bind_device(device)
        self._tail = torch.zeros(self.window, dtype=dtype, device=self.device)
        self._on = torch.zeros((), dtype=torch.bool, device=self.device)

    def execute_block(self, x) -> dict:
        x = torch.as_tensor(x).to(self.device, self._tail.dtype)
        out, self._tail, self._on = _detector_block(
            x, self._tail, self._on, self.window, self.high_db, self.low_db,
            self.max_bursts)
        return out

    def reset(self):
        self._tail = torch.zeros_like(self._tail)
        self._on = torch.zeros_like(self._on)

    @property
    def state(self) -> dict:
        """{"tail": the last ``window`` samples, "on": the gate latch}."""
        return {"tail": self._tail, "on": self._on}

    @state.setter
    def state(self, value):
        self._tail = torch.as_tensor(value["tail"]).to(self.device,
                                                       self._tail.dtype)
        self._on = torch.as_tensor(value["on"]).to(self.device, torch.bool)

    def __repr__(self):
        return (f"BurstDetector [window={self.window}] "
                f"[high={self.high_db:.1f}dB] [low={self.low_db:.1f}dB]")
