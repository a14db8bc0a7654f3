"""SpectrumMonitor: wideband occupancy tracking over a channel grid.

Port of ``solid_dsp_tpu/models/monitor.py`` (:29-143).  Each block is
channelized (the commutator form, or the fused kernel K4 at precision
"fast" for ``backend="fused"``, as in the JAX package), reduced on the
device to one mean power per channel, and brought to the host; the power
EMA, the noise floor (median across channels), the hysteresis occupancy
decision and the event list are host numpy, as in the JAX package.
Events are ``{"channel", "start_block", "end_block", "peak_rel_db"}``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import bind_device
from .channelizer import (PolyphaseChannelizer, channelizer_apply,
                          channelizer_init, channelizer_taps)

__all__ = ["SpectrumMonitor"]


class SpectrumMonitor:
    """Streaming occupancy monitor over ``num_channels`` sub-bands.

    high_db / low_db: hysteresis thresholds relative to the tracked noise
    floor; alpha: the per-block EMA coefficient of the channel powers.
    ``device``: the card unless told otherwise; ``engine`` as in
    :class:`~solid_dsp_tpu_torch.models.channelizer.PolyphaseChannelizer`.
    Completed events accumulate in ``.events``; channels in progress are
    ``.active``.
    """

    def __init__(self, num_channels: int = 64, taps_per_branch: int = 8,
                 high_db: float = 10.0, low_db: float = 6.0,
                 alpha: float = 0.9, dtype=torch.complex64,
                 backend: str = "xla", device=None, engine: str = "auto"):
        if not (low_db < high_db):
            raise ValueError("need low_db < high_db (hysteresis)")
        if not (0.0 < alpha <= 1.0):
            raise ValueError("alpha in (0, 1]")
        self.M = int(num_channels)
        self.high_db = float(high_db)
        self.low_db = float(low_db)
        self.alpha = float(alpha)
        self.dtype = dtype
        self.backend = backend
        self.device = bind_device(device)
        self._taps = torch.as_tensor(
            channelizer_taps(self.M, taps_per_branch).astype(np.complex64),
            device=self.device)
        if backend == "fused":
            # bf16 branch products are plenty for dB-scale powers
            self._chan = PolyphaseChannelizer(
                self.M, taps_per_branch, backend="fused", precision="fast",
                device=self.device, engine=engine)
        else:
            self._chan = None
        self._state = channelizer_init(self.M, taps_per_branch, dtype,
                                       device=self.device)
        self._p_ema = None          # (M,) linear power EMA
        self._on = np.zeros(self.M, bool)
        self._start = np.zeros(self.M, np.int64)
        self._peak = np.full(self.M, -np.inf)
        self._block = 0
        self._on_blocks = np.zeros(self.M, np.int64)
        self.events: list[dict] = []

    def execute_block(self, x) -> np.ndarray:
        """Process one block (length divisible by num_channels).  Returns
        the per-channel power EMA in dB relative to the current noise floor
        (the quantity the thresholds act on)."""
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        if x.shape[-1] % self.M:
            raise ValueError(f"block length must be a multiple of {self.M}")
        if self._chan is not None:
            Y = self._chan.execute_block(x)
        else:
            Y, self._state = channelizer_apply(self._taps, self._state, x,
                                               self.M)
        p = torch.mean((Y * Y.conj()).real, dim=-2)          # (M,)
        p = p.cpu().numpy().astype(np.float64)
        if self._p_ema is None:
            self._p_ema = p
        else:
            self._p_ema = ((1.0 - self.alpha) * self._p_ema
                           + self.alpha * p)
        floor = float(np.median(self._p_ema)) + 1e-30
        rel_db = 10.0 * np.log10(self._p_ema / floor + 1e-30)

        rising = (~self._on) & (rel_db > self.high_db)
        falling = self._on & (rel_db < self.low_db)
        self._start[rising] = self._block
        self._peak[rising] = rel_db[rising]
        hold = self._on & ~falling
        self._peak[hold] = np.maximum(self._peak[hold], rel_db[hold])
        for ch in np.nonzero(falling)[0]:
            self.events.append({
                "channel": int(ch),
                "start_block": int(self._start[ch]),
                "end_block": int(self._block),
                "peak_rel_db": round(float(self._peak[ch]), 2),
            })
        self._on = (self._on | rising) & ~falling
        self._on_blocks += self._on
        self._block += 1
        return rel_db

    @property
    def active(self) -> list:
        """Channels currently above threshold (in-progress events)."""
        return [int(c) for c in np.nonzero(self._on)[0]]

    def summary(self) -> dict:
        """Running occupancy report: duty cycle per busy channel."""
        total = max(self._block, 1)
        duty = {int(c): round(float(self._on_blocks[c]) / total, 4)
                for c in np.nonzero(self._on_blocks)[0]}
        return {"blocks": self._block, "events": len(self.events),
                "active": self.active, "duty_cycle": duty}

    def __repr__(self):
        return (f"SpectrumMonitor [M={self.M}] "
                f"[thresh={self.high_db}/{self.low_db} dB] "
                f"[{len(self.events)} events]")
