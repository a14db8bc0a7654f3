"""AutoCorrelator: the windowed delay-conjugate-multiply correlator.

Port of ``solid_dsp_tpu/ops/autocorr.py`` (reference
``src/filter/auto_correlator/mod.rs``).  With window W and delay D the
output after pushing x[n] is

    y[n] = sum_{k=0}^{W-1-D} x[n-k] conj(x[n-D-k])

(the delayed window's last D slots are never written by the reference, so
for D >= W the output is identically 0), and the energy is the W-long moving
sum of |x|^2.  A block is z[n] = x[n] conj(x[n-D]) and two moving sums, each
one ones-kernel ``conv1d_mxu``.  The carry is the x history (W - 1 + D) and
the |x|^2 history (W - 1).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .fir import _ingest, conv1d_mxu

__all__ = ["autocorr_init", "autocorr_apply", "AutoCorrelator"]


def autocorr_init(window_size: int, delay: int, dtype=torch.complex64,
                  batch_shape: tuple = (), device=None) -> dict:
    """Zero carry on ``device`` (the card unless told otherwise): x_tail
    (W - 1 + D) in ``dtype``, e_tail (W - 1) in its real type."""
    device = resolve_device(device)
    hist = max(window_size - 1 + delay, 0)
    return {
        "x_tail": torch.zeros((*batch_shape, hist), dtype=dtype,
                              device=device),
        "e_tail": torch.zeros((*batch_shape, max(window_size - 1, 0)),
                              dtype=dtype.to_real(), device=device),
    }


def autocorr_apply(state: dict, x: torch.Tensor, window_size: int,
                   delay: int):
    """(y, energy, new_state): y[n] and energy[n] after pushing x[n]."""
    W, D = int(window_size), int(delay)
    x_ext = torch.cat([state["x_tail"].to(x.dtype), x], dim=-1)
    terms = W - D
    if terms <= 0:
        y = torch.zeros_like(x)
    else:
        # z[m] = x_ext[m + D] conj(x_ext[m]); y[n] is the `terms`-long
        # moving sum of z ending at x[n]: one ones-kernel correlation
        n_ext = x_ext.shape[-1]
        z = x_ext[..., D:] * torch.conj(x_ext[..., : n_ext - D])
        ones = torch.ones(terms, dtype=z.real.dtype, device=x.device)
        y = conv1d_mxu(z[..., D:], ones)
    e2_ext = torch.cat([state["e_tail"], (x * torch.conj(x)).real], dim=-1)
    energy = conv1d_mxu(e2_ext, torch.ones(W, dtype=e2_ext.dtype,
                                           device=x.device))
    hist = state["x_tail"].shape[-1]
    new_state = {
        "x_tail": x_ext[..., x_ext.shape[-1] - hist:],
        "e_tail": e2_ext[..., e2_ext.shape[-1] - (W - 1):] if W > 1
        else e2_ext[..., :0],
    }
    return y, energy, new_state


class AutoCorrelator:
    """The reference's API shape over :func:`autocorr_apply`, its carry on
    ``device`` (the card unless told otherwise); ``state`` holds the
    x_tail and e_tail (the JAX object's ``_st``) and the last energy."""

    def __init__(self, window_size: int, delay: int,
                 dtype=torch.complex64, device=None):
        self.window_size = int(window_size)
        self.delay = int(delay)
        self.device = resolve_device(device)
        self._dtype = dtype
        self.reset()

    def reset(self) -> None:
        self._st = autocorr_init(self.window_size, self.delay, self._dtype,
                                 device=self.device)
        self._energy = 0.0

    @property
    def state(self) -> dict:
        return {**self._st, "energy": torch.tensor(self._energy)}

    @state.setter
    def state(self, st: dict):
        self._st = {k: st[k].to(self.device) for k in ("x_tail", "e_tail")}
        self._energy = float(st["energy"])

    def push(self, sample) -> None:
        self.execute_block(np.asarray([sample]))

    def write(self, samples) -> None:
        self.execute_block(samples)

    def execute_block(self, samples):
        x = _ingest(samples, self.device).to(self._dtype)
        y, energy, self._st = autocorr_apply(self._st, x, self.window_size,
                                             self.delay)
        if energy.shape[-1]:
            self._energy = float(energy[..., -1])
        return y

    def execute(self):
        """The correlation at the current state, without pushing (ref
        execute :156-163), from the stored tail."""
        W, D = self.window_size, self.delay
        tail = self._st["x_tail"].cpu().numpy()
        terms = W - D
        if terms <= 0 or tail.size == 0:
            return 0j
        acc = 0j
        for k in range(terms):
            a = tail[-1 - k] if k < tail.size else 0.0
            bidx = -1 - k - D
            b = tail[bidx] if -bidx <= tail.size else 0.0
            acc += a * np.conj(b)
        return acc

    def get_energy(self) -> float:
        return self._energy

    def __repr__(self) -> str:
        dt = str(self._dtype).replace("torch.", "")
        return (f"AutoCorrelator<{dt}> [Size={self.window_size}] "
                f"[Delay={self.delay}] [Energy={self._energy}]")
