"""NCO phase words and the exact-mode mixer.

Port of ``solid_dsp_tpu/ops/nco.py``: ``constrain`` (design time, numpy),
``nco_phases``, ``nco_complex_exponential`` in its ``fast`` and ``exact``
modes and the exact-mode ``mix_down_block`` (reference
``src/nco/mod.rs``).  The phase sequence is closed-form,
theta[k] = theta0 + k * dtheta (mod 2^32), so a whole block is one
vectorized expression.

torch has no general uint32 arithmetic, so phase words are int64 tensors
kept in [0, 2^32) by masking with ``& 0xFFFFFFFF`` after every operation
(exact: the products stay below 2^63 for any block a chain can hold).
numpy ``uint32`` appears only at the state boundary
(``streaming/state.py``).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["constrain", "nco_phases", "phase_to_rad",
           "nco_complex_exponential", "mix_down_block", "U32_MASK", "TWO_PI",
           "U32"]

TWO_PI = 2.0 * np.pi
U32 = 4294967296.0
U32_MASK = 0xFFFFFFFF


def constrain(theta: float) -> np.uint32:
    """radians -> u32 phase word: frac(theta / 2pi), made positive, times
    0xffffffff (not 2^32), truncated toward zero."""
    frac = np.float64(theta) / TWO_PI
    frac = frac - np.trunc(frac)
    if frac < 0.0:
        frac += 1.0
    return np.uint32(np.trunc(frac * np.float64(0xFFFFFFFF)))


def nco_phases(theta0: torch.Tensor, delta_theta: int, n: int) -> torch.Tensor:
    """Phase words theta0 + k*dtheta (mod 2^32), k = 0..n-1, as int64."""
    k = torch.arange(n, dtype=torch.int64, device=theta0.device)
    return (theta0 + k * int(delta_theta)) & U32_MASK


def phase_to_rad(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Phase word -> radians in ``dtype``: the word is rounded to ``dtype``
    first and then scaled, as the JAX package does for u32 words."""
    step = np.float32(TWO_PI / U32) if dtype == torch.float32 else TWO_PI / U32
    return w.to(dtype) * float(step)


def _nco_cexp_fast(theta0: torch.Tensor, delta_theta: int,
                   n: int) -> torch.Tensor:
    """Factorized oscillator block e^{j(theta0 + k d)}, k = 0..n-1, complex64.

    With V = 128 when n is a multiple of 128, k = uV + v and e^{j theta_k}
    is the outer product of e^{j(theta0 + uVd)} and e^{jvd}: n/V + V
    sin/cos instead of n.  Otherwise every sample takes its own sin/cos.
    Phase words wrap as u32, and each becomes radians as the JAX package
    does it: word -> float32 -> times 2 pi / 2^32.
    """
    d = int(np.uint32(delta_theta))
    V = 128 if n % 128 == 0 and n >= 128 else 1
    if V == 1:
        ph = phase_to_rad(nco_phases(theta0, d, n), torch.float32)
        return torch.complex(torch.cos(ph), torch.sin(ph))
    pc = phase_to_rad(nco_phases(theta0, (V * d) & U32_MASK, n // V),
                      torch.float32)
    pf = phase_to_rad(nco_phases(torch.zeros_like(theta0), d, V),
                      torch.float32)
    ec = torch.complex(torch.cos(pc), torch.sin(pc))
    ef = torch.complex(torch.cos(pf), torch.sin(pf))
    return (ec[:, None] * ef[None, :]).reshape(n)


def nco_complex_exponential(theta0: torch.Tensor, delta_theta: int, n: int,
                            mode: str = "exact") -> torch.Tensor:
    """Block of e^{+j theta_k}, k = 0..n-1: ``"fast"`` is the factorized
    complex64 oscillator; ``"exact"`` takes sin/cos of every phase in
    float64 (complex128), as the JAX package does with x64 enabled."""
    if mode == "fast":
        return _nco_cexp_fast(theta0, delta_theta, n)
    if mode == "exact":
        ph = phase_to_rad(nco_phases(theta0, delta_theta, n), torch.float64)
        return torch.complex(torch.cos(ph), torch.sin(ph))
    raise NotImplementedError(
        f"nco mode {mode!r} is not ported to solid_dsp_tpu_torch yet: see "
        "ROADMAP.md queue 1 item 7 (the LUT oscillator)")


def mix_down_block(x: torch.Tensor, theta0: torch.Tensor, delta_theta: int):
    """y[k] = e^{-j theta_k} x[k] with exact sin/cos of the u32 phase
    (nco_mode="exact", phases evaluated in float64); returns
    (y, theta_after_block)."""
    n = x.shape[-1]
    ph = phase_to_rad(nco_phases(theta0, delta_theta, n), torch.float64)
    rot = torch.polar(torch.ones_like(ph), -ph).to(x.dtype)
    theta_end = (theta0 + n * int(delta_theta)) & U32_MASK
    return x * rot, theta_end
