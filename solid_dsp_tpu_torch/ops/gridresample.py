"""Arbitrary-ratio resampling grid: exact int32 fixed-point positions.

Port of ``solid_dsp_tpu/ops/gridresample.py``.  The ratio (input samples
per output) is quantized once to R / 2^FB with FB = 20 (< 0.5 ppm); output
k of a block sits at t_k = t0 + k R, computed in int32 with k split into
10-bit digits and host-precomputed carry/residue pairs of R << 10 l, so
every intermediate stays below 2^31.  Positions follow the quantized ratio
exactly for ever, bit-reproducible and block-size invariant.  The carried
state is one int32 t0 in [0, R): n_valid = q0 + (t0 < r0) and
t0' = t0 - r0 + (t0 < r0) R with q0, r0 = divmod(L << FB, R).

The same digit arithmetic runs in ``csrc/farrow.cu`` (K8); the tests hold
``base`` and ``mu`` bit-equal to the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["FB", "GridPlan", "plan_ratio", "grid_positions", "grid_n_valid",
           "grid_advance"]

FB = 20
_MASK = (1 << FB) - 1


@dataclass(frozen=True)
class GridPlan:
    """Host constants of one quantized ratio and block length."""

    R: int               # round(ratio * 2^FB)
    L: int               # input block length (samples)
    q0: int              # (L << FB) // R, the fewest outputs a block
    r0: int              # (L << FB) % R
    C: tuple             # carry of R << 10 l, l = 0, 1, 2
    D: tuple             # residue of R << 10 l

    @property
    def ratio(self) -> float:
        """The exact ratio this plan resamples by (R / 2^FB)."""
        return self.R / float(1 << FB)

    @property
    def n_pad(self) -> int:
        """Output buffer length (the most outputs a block)."""
        return self.q0 + 1


def plan_ratio(ratio: float, L: int) -> GridPlan:
    """Quantize ``ratio`` for blocks of L samples: ratio in [1/16, 32] and
    L <= 2^24 (the int32 headroom)."""
    if not (1.0 / 16.0 <= ratio <= 32.0):
        raise ValueError("plan_ratio supports ratio in [1/16, 32]")
    if not (0 < L <= 1 << 24):
        raise ValueError("plan_ratio supports L <= 2^24")
    R = int(round(ratio * (1 << FB)))
    if R <= 0:
        raise ValueError("ratio too small")
    q0, r0 = divmod(L << FB, R)
    C = tuple((R << (10 * lv)) >> FB for lv in range(3))
    D = tuple((R << (10 * lv)) & _MASK for lv in range(3))
    return GridPlan(R=R, L=int(L), q0=int(q0), r0=int(r0), C=C, D=D)


def _as_t0(t0, device=None) -> torch.Tensor:
    return torch.as_tensor(t0, dtype=torch.int32, device=device)


def grid_positions(plan: GridPlan, t0, n: int):
    """(base (n,) int32, mu (n,) float32): t_k = t0 + k R for k < n, with
    base = floor(t_k 2^-FB) in input samples and mu in [0, 1).  ``t0`` is
    the carried int32 (a 0-d tensor on the device the positions go to, or
    an int for the CPU)."""
    t0 = _as_t0(t0)
    k = torch.arange(n, dtype=torch.int32, device=t0.device)
    k0 = k & 1023
    k1 = (k >> 10) & 1023
    k2 = k >> 20
    e0 = k0 * plan.D[0]
    e1 = k1 * plan.D[1]
    e2 = k2 * plan.D[2]
    lo_sum = (t0 & _MASK) + (e0 & _MASK) + (e1 & _MASK) + (e2 & _MASK)
    base = ((t0 >> FB) + k0 * plan.C[0] + k1 * plan.C[1] + k2 * plan.C[2]
            + (e0 >> FB) + (e1 >> FB) + (e2 >> FB) + (lo_sum >> FB))
    mu = (lo_sum & _MASK).to(torch.float32) * (2.0 ** -FB)
    return base.to(torch.int32), mu


def grid_n_valid(plan: GridPlan, t0) -> torch.Tensor:
    """Outputs of the block (q0 or q0 + 1), an int32 0-d tensor."""
    t0 = _as_t0(t0)
    return plan.q0 + (t0 < plan.r0).to(torch.int32)


def grid_advance(plan: GridPlan, t0) -> torch.Tensor:
    """The next block's t0' in [0, R), exact, an int32 0-d tensor."""
    t0 = _as_t0(t0)
    return t0 - plan.r0 + (t0 < plan.r0).to(torch.int32) * plan.R
