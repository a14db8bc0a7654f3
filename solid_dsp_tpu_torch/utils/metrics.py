"""Per-block stream metrics (the observability layer).

Port of ``solid_dsp_tpu/utils/metrics.py``: every block through a chain can
emit a structured record (RSSI, AGC gain and lock, block energy,
throughput) for logging, dashboards, or squelch-style decisions on the
host.  ``MetricsCollector.measure`` waits for the block's device
(``torch.cuda.synchronize`` on a CUDA output; it copies nothing back) and
reads the chain state's ``agc`` carry (``ops/agc.py::agc_init``'s
``gain``, ``lock`` and ``energy``).
"""

from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from .profiling import _block

__all__ = ["BlockMetrics", "MetricsCollector", "rssi_db"]


def rssi_db(gain: float) -> float:
    """RSSI estimate from the AGC gain: -20 log10(gain)."""
    g = float(gain)
    if g <= 0.0:
        return float("inf")
    return -20.0 * math.log10(g)


@dataclass
class BlockMetrics:
    """One block's observables."""

    block_index: int
    n_samples: int
    seconds: float
    rssi_db: float | None = None
    agc_gain: float | None = None
    agc_locked: bool | None = None
    energy: float | None = None

    @property
    def msps(self) -> float:
        return self.n_samples / max(self.seconds, 1e-12) / 1e6

    def to_json(self) -> str:
        d = {k: v for k, v in self.__dict__.items() if v is not None}
        d["msps"] = round(self.msps, 3)
        return json.dumps(d)


def _first(v) -> np.ndarray:
    """A state leaf (tensor or array) flattened on the host."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v).reshape(-1)


@dataclass
class MetricsCollector:
    """Wraps a chain's ``execute_block`` with per-block metric capture.

    ``sink`` is called with each BlockMetrics (default: keep history only).

    Usage::

        mc = MetricsCollector(sink=lambda m: print(m.to_json()))
        out = mc.measure(chain, block)      # chain.execute_block(block)
        mc.history[-1].rssi_db
    """

    sink: Callable[[BlockMetrics], None] | None = None
    history: list[BlockMetrics] = field(default_factory=list)
    _index: int = 0

    def measure(self, chain, block):
        t0 = time.perf_counter()
        out = chain.execute_block(block)
        _block(out)  # device sync
        dt = time.perf_counter() - t0

        m = BlockMetrics(
            block_index=self._index,
            n_samples=int(np.shape(block)[-1]),
            seconds=dt,
        )
        state = getattr(chain, "state", None)
        agc = None
        if state is not None:
            try:
                agc = state["agc"]
            except (KeyError, TypeError):
                agc = None
        if agc is not None:
            gain = float(_first(agc["gain"])[0])
            m.agc_gain = gain
            m.rssi_db = rssi_db(gain)
            lock = _first(agc.get("lock", False))
            m.agc_locked = bool(lock[0]) if lock.size else None
            energy = agc.get("energy")
            if energy is not None:
                m.energy = float(_first(energy)[0])
        self._index += 1
        self.history.append(m)
        if self.sink is not None:
            self.sink(m)
        return out
