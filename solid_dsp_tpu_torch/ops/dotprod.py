"""DotProduct: the coefficient store and multiply-accumulate.

Port of ``solid_dsp_tpu/ops/dotprod.py`` (:22-74; reference
``src/dot_product/mod.rs``): ``dot`` multiplies over min(len(coefs),
len(samples)) terms, ``dot_block`` takes many sample windows at once as one
matrix-vector product, and ``DotProduct`` stores FORWARD or REVERSE
coefficients, reporting them in stored order as the reference does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import fp32_exact, resolve_device

__all__ = ["Direction", "DotProduct", "dot", "dot_block"]


class Direction:
    FORWARD = "forward"
    REVERSE = "reverse"


def dot(coefs: torch.Tensor, samples: torch.Tensor) -> torch.Tensor:
    """sum_i coefs[i] * samples[i] over min(len) terms."""
    n = min(coefs.shape[-1], samples.shape[-1])
    dt = torch.promote_types(coefs.dtype, samples.dtype)
    return torch.sum(coefs[..., :n].to(dt) * samples[..., :n].to(dt), dim=-1)


def dot_block(coefs: torch.Tensor, windows: torch.Tensor) -> torch.Tensor:
    """Batched MAC: windows (..., T, n) x coefs (n,) -> (..., T), in full
    float32 (or float64) whatever the caller's TF32 settings."""
    n = coefs.shape[-1]
    dt = torch.promote_types(coefs.dtype, windows.dtype)
    with fp32_exact():
        return torch.matmul(windows[..., :n].to(dt), coefs.to(dt))


class DotProduct:
    """Coefficient store with FORWARD/REVERSE direction on ``device`` (the
    card unless told otherwise).  ``coefficients()`` returns the stored
    order: for REVERSE the reversed input."""

    def __init__(self, coefficients, direction: str = Direction.FORWARD,
                 dtype=None, device=None):
        c = np.asarray(coefficients)
        if direction == Direction.REVERSE:
            c = c[::-1]
        self._coefs = torch.as_tensor(c.copy(), device=resolve_device(device))
        if dtype is not None:
            self._coefs = self._coefs.to(dtype)
        self.direction = direction

    def coefficients(self) -> torch.Tensor:
        return self._coefs

    def __len__(self) -> int:
        return int(self._coefs.shape[-1])

    def is_empty(self) -> bool:
        return len(self) == 0

    def execute(self, samples):
        """One MAC against a sample window (newest first, as the
        reference's Window::to_vec gives it)."""
        return dot(self._coefs, torch.as_tensor(samples,
                                                device=self._coefs.device))

    def execute_block(self, windows):
        """Batched MAC against stacked windows (..., T, n)."""
        return dot_block(self._coefs, torch.as_tensor(
            windows, device=self._coefs.device))

    def __repr__(self) -> str:
        dt = str(self._coefs.dtype).replace("torch.", "")
        return f"DotProduct<{dt}> [Size={len(self)}]"
