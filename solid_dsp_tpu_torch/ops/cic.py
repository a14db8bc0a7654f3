"""CIC (cascaded integrator-comb) decimators and interpolators.

Port of ``solid_dsp_tpu/ops/cic.py``.  A CIC with N stages, rate R and
differential delay M is exactly the FIR ``boxcar(RM)`` convolved with
itself N times, followed (decimator) or preceded (interpolator) by the rate
change, so it runs as that FIR: the decimator through ``fir_decim_apply``
(the strided product with its phase carried), the interpolator as a
zero-stuff and one ``conv1d_mxu``.  No unbounded integrator accumulates, so
floats reproduce the two's-complement hardware form over any stream.  The
DC gain (RM)^N (decimator) or (RM)^N / R (interpolator) is scaled out with
``normalize=True``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from . import fir as fir_ops
from .fir import _ingest

__all__ = ["cic_kernel", "cic_frequency_response", "CICDecimator",
           "CICInterpolator"]


def _real_np(dtype: torch.dtype):
    """The numpy type of ``dtype``'s real part: the taps are real, so a
    complex block runs real taps (the same sums as JAX's complex taps with
    zero imaginary parts, half the products)."""
    return torch.empty(0, dtype=dtype).real.numpy().dtype


def cic_kernel(rate: int, stages: int, diff_delay: int = 1) -> np.ndarray:
    """The equivalent FIR: boxcar(rate * diff_delay) self-convolved
    ``stages`` times; length N (RM - 1) + 1, DC gain (RM)^N."""
    if rate < 1 or stages < 1 or diff_delay < 1:
        raise ValueError("rate, stages, diff_delay must be >= 1")
    box = np.ones(rate * diff_delay, dtype=np.float64)
    h = box
    for _ in range(stages - 1):
        h = np.convolve(h, box)
    return h


def cic_frequency_response(f, rate: int, stages: int,
                           diff_delay: int = 1) -> np.ndarray:
    """|H| at input-rate frequency f (cycles/sample): |sin(pi f R M) /
    sin(pi f)|^N, with the f -> 0 limit (RM)^N."""
    f = np.asarray(f, dtype=np.float64)
    rm = rate * diff_delay
    num = np.sin(np.pi * f * rm)
    den = np.sin(np.pi * f)
    with np.errstate(divide="ignore", invalid="ignore"):
        h = np.where(np.abs(den) < 1e-12, float(rm), num / den)
    return np.abs(h) ** stages


class CICDecimator:
    """N-stage CIC decimator by R, streaming: the block length must be a
    multiple of R (``fir_decim_apply``).  ``state``: {"tail", "phase"}, the
    JAX object's ``_tail`` and ``_phase``."""

    def __init__(self, rate: int, stages: int = 4, diff_delay: int = 1,
                 normalize: bool = True, dtype=torch.complex64, device=None):
        self.R = int(rate)
        self.N = int(stages)
        self.M = int(diff_delay)
        self.device = resolve_device(device)
        h = cic_kernel(self.R, self.N, self.M)
        self.scale = float(1.0 / np.sum(h)) if normalize else 1.0
        self._dtype = dtype
        self._taps_np = h.astype(_real_np(dtype))     # the product's banks
        self.reset()

    def reset(self):
        self._tail = fir_ops.fir_init(len(self._taps_np), self._dtype,
                                      device=self.device)
        self._phase = torch.zeros((), dtype=torch.int32, device=self.device)

    @property
    def state(self) -> dict:
        return {"tail": self._tail, "phase": self._phase}

    @state.setter
    def state(self, st: dict):
        self._tail = st["tail"].to(self.device)
        self._phase = st["phase"].to(self.device, torch.int32)

    def execute_block(self, x):
        x = _ingest(x, self.device).to(self._dtype)
        y, self._tail, self._phase = fir_ops.fir_decim_apply(
            self._taps_np, self._tail, self._phase, x,
            torch.tensor(self.scale, dtype=self._dtype), self.R)
        return y

    def frequency_response(self, f: float) -> float:
        return float(cic_frequency_response(f, self.R, self.N, self.M)
                     * self.scale)

    def __repr__(self):
        return f"CICDecimator [R={self.R}] [N={self.N}] [M={self.M}]"


class CICInterpolator:
    """N-stage CIC interpolator by R: zero-stuff, then the boxcar^N FIR.
    ``state``: {"tail"}, the JAX object's ``_tail``."""

    def __init__(self, rate: int, stages: int = 4, diff_delay: int = 1,
                 normalize: bool = True, dtype=torch.complex64, device=None):
        self.R = int(rate)
        self.N = int(stages)
        self.M = int(diff_delay)
        self.device = resolve_device(device)
        h = cic_kernel(self.R, self.N, self.M)
        # zero-stuffing keeps 1 of R samples: unity DC gain at the output
        # rate needs sum(h) / R scaled out
        self.scale = float(self.R / np.sum(h)) if normalize else 1.0
        self._dtype = dtype
        self._taps = torch.from_numpy(h.astype(_real_np(dtype))).to(
            self.device)
        self.reset()

    def reset(self):
        self._tail = torch.zeros(self._taps.shape[-1] - 1, dtype=self._dtype,
                                 device=self.device)

    @property
    def state(self) -> dict:
        return {"tail": self._tail}

    @state.setter
    def state(self, st: dict):
        self._tail = st["tail"].to(self.device)

    def execute_block(self, x):
        x = _ingest(x, self.device).to(self._dtype)
        up = torch.zeros(x.shape[-1] * self.R, dtype=x.dtype,
                         device=x.device)
        up[::self.R] = x
        ext = torch.cat([self._tail, up])
        y = fir_ops.conv1d_mxu(ext, self._taps) * torch.tensor(
            self.scale, dtype=self._dtype)
        self._tail = ext[ext.shape[-1] - (self._taps.shape[-1] - 1):]
        return y

    def frequency_response(self, f: float) -> float:
        return float(cic_frequency_response(f, self.R, self.N, self.M)
                     * self.scale)

    def __repr__(self):
        return f"CICInterpolator [R={self.R}] [N={self.N}] [M={self.M}]"
