"""FM demodulation: the phase-difference discriminator.

Port of ``solid_dsp_tpu/models/fm.py::fm_demodulate``, which the receive
chain runs on its rotated, gained output (``epilogue="rotate"``).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["fm_demodulate"]


def fm_demodulate(state: torch.Tensor, x: torch.Tensor, kf: float):
    """y[n] = arg(x[n] conj(x[n-1])) / (2 pi kf) over the last axis, x[-1]
    the carried ``state`` (one per leading index); returns
    (y, new_state = x[..., -1])."""
    prev = torch.cat([state.to(x.dtype)[..., None], x[..., :-1]], dim=-1)
    dt = np.float64 if x.dtype == torch.complex128 else np.float32
    return (torch.angle(x * prev.conj()) / float(dt(2.0 * np.pi * kf)),
            x[..., -1])
