"""Halfband filters and multistage power-of-two decimation.

Port of ``solid_dsp_tpu/ops/halfband.py``.  A halfband lowpass has every
second tap zero but the 0.5 centre, so a decimate-by-2 stage costs half the
taps, and a 2^k cascade runs each stage at half the rate before it with a
wider transition (fewer taps) early on.  Each stage is one stride-2
``conv1d_mxu`` over [tail | x] (the zero taps multiplied, as in the JAX
package, whose dense strided form avoids a stride-2 gather).  Streaming with
the tail carried; ``state`` reads and sets it (``interop.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..design.firdes import estimate_required_filter_length, firdes_kaiser
from ..device import resolve_device
from .fir import _ingest, conv1d_mxu

__all__ = ["firdes_halfband", "halfband_decimate", "HalfbandDecimator",
           "MultistageDecimator"]


def firdes_halfband(semi_length: int, stop_band_attenuation: float = 60.0
                    ) -> np.ndarray:
    """Kaiser-windowed halfband lowpass of length 4 semi_length - 1: cutoff
    0.25, the taps at even offsets from the centre set to exactly 0, unit
    DC gain (the centre then 0.5 by symmetry, to ~1e-4)."""
    if semi_length < 1:
        raise ValueError("semi_length must be >= 1")
    n = 4 * semi_length - 1
    h = firdes_kaiser(n, 0.25, stop_band_attenuation, 0.0)
    c = (n - 1) // 2
    idx = np.arange(n)
    h = np.where((idx != c) & ((idx - c) % 2 == 0), 0.0, h)
    return h / h.sum()


def halfband_decimate(taps, tail, x):
    """Decimate by 2: y[k] = sum_i h[i] x_ext[2k + i], one stride-2
    correlation over x_ext = [tail | x].  len(x) must be even.  Returns (y,
    new_tail)."""
    n = int(taps.shape[-1])
    if x.shape[-1] % 2:
        raise ValueError("block length must be even")
    x_ext = torch.cat([tail, x], dim=-1)
    y = conv1d_mxu(x_ext, taps, stride=2)
    return y, x_ext[..., x_ext.shape[-1] - (n - 1):]


class HalfbandDecimator:
    """Stateful decimate-by-2 stage, float32 taps as the JAX package's,
    its tail carried on ``device`` (the card unless told otherwise)."""

    def __init__(self, semi_length: int = 8,
                 stop_band_attenuation: float = 60.0, dtype=torch.complex64,
                 device=None):
        self.taps_np = firdes_halfband(semi_length, stop_band_attenuation)
        self.device = resolve_device(device)
        self._taps = torch.from_numpy(self.taps_np.astype(np.float32)).to(
            self.device)
        self._dtype = dtype
        self.reset()

    def reset(self):
        self._tail = torch.zeros(len(self.taps_np) - 1, dtype=self._dtype,
                                 device=self.device)

    @property
    def state(self) -> dict:
        """{"tail"}: the JAX object's ``_tail``."""
        return {"tail": self._tail}

    @state.setter
    def state(self, st: dict):
        self._tail = st["tail"].to(self.device)

    def execute_block(self, x):
        x = _ingest(x, self.device)
        self._tail = self._tail.to(torch.promote_types(self._tail.dtype,
                                                       x.dtype))
        y, self._tail = halfband_decimate(self._taps, self._tail,
                                          x.to(self._tail.dtype))
        return y


def _halfband_stage_semilen(fpass_out: float, stages_after: int,
                            as_db: float) -> int:
    """Semi-length of one halfband stage: the passband edge at this stage's
    input rate is fpass_out / 2^(stages_after + 1), the transition
    0.5 - 2 fpass_stage wide."""
    fpass_stage = fpass_out / (2.0 ** (stages_after + 1))
    df = 0.5 - 2.0 * fpass_stage
    n = estimate_required_filter_length(max(min(df, 0.45), 0.05), as_db)
    return max(1, int(np.ceil((n + 1) / 4.0)))


class MultistageDecimator:
    """Decimate by R = 2^k r: a halfband cascade, then a Kaiser FIR stage
    (``DecimatingFIRFilter``) for an odd residual r > 1.  ``fpass`` is the
    passband edge as a fraction of the output rate (< 0.5)."""

    def __init__(self, decimation: int, fpass: float = 0.4,
                 stop_band_attenuation: float = 60.0, dtype=torch.complex64,
                 device=None):
        if decimation < 2:
            raise ValueError("decimation must be >= 2")
        if not (0.0 < fpass < 0.5):
            raise ValueError("fpass in (0, 0.5) of the output rate")
        self.device = resolve_device(device)
        R = int(decimation)
        k = 0
        while R % 2 == 0:
            R //= 2
            k += 1
        self.n_halfband = k
        self.residual = R
        self.decimation = int(decimation)
        self.stages = []
        for s in range(k):
            # a residual stage tightens what the last halfband sees
            eff_after = (k - 1 - s) + (0 if R == 1 else np.log2(R))
            m = _halfband_stage_semilen(fpass, float(eff_after),
                                        stop_band_attenuation)
            self.stages.append(HalfbandDecimator(
                m, stop_band_attenuation, dtype=dtype, device=self.device))
        if R > 1:
            from .fir import DecimatingFIRFilter
            # input-rate units: passband fpass / R, stopband (1 - fpass) / R
            df = (1.0 - 2.0 * fpass) / R
            n = estimate_required_filter_length(max(min(df, 0.45), 0.01),
                                                stop_band_attenuation)
            taps = firdes_kaiser(int(n) | 1, 0.5 / R, stop_band_attenuation,
                                 0.0)
            self.final = DecimatingFIRFilter(taps / taps.sum(), 1.0, R,
                                             dtype=dtype, device=self.device)
        else:
            self.final = None

    @property
    def state(self) -> dict:
        """{"stages": [each halfband's tail], "final": {"tail", "phase"}}
        (the JAX object's stages' ``_tail``, its final FIR's ``_tail`` and
        ``_phase``)."""
        st = {"stages": [s._tail for s in self.stages]}
        if self.final is not None:
            st["final"] = {"tail": self.final._tail,
                           "phase": torch.tensor(self.final._phase)}
        return st

    @state.setter
    def state(self, st: dict):
        for s, t in zip(self.stages, st["stages"]):
            s._tail = t.to(self.device)
        if self.final is not None:
            self.final._tail = st["final"]["tail"].to(self.device)
            self.final._phase = int(st["final"]["phase"])

    def execute_block(self, x):
        y = _ingest(x, self.device)
        for st in self.stages:
            y = st.execute_block(y)
        if self.final is not None:
            y = self.final.execute_block(y)
        return y

    def reset(self):
        for st in self.stages:
            st.reset()
        if self.final is not None:
            self.final._tail = torch.zeros_like(self.final._tail)

    @property
    def total_taps(self) -> int:
        """Nonzero multiplies a structure output (the cost metric)."""
        n = sum(int(np.count_nonzero(s.taps_np)) for s in self.stages)
        if self.final is not None:
            n += len(self.final)
        return n
