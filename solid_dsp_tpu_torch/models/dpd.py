"""Digital predistortion: memory-polynomial PA linearisation.

Port of ``solid_dsp_tpu/models/dpd.py``.  The memory polynomial
y[n] = sum_k sum_q c[k, q] x[n-q] |x[n-q]|^(2k) is a (T, K Q) basis matrix
times a coefficient vector; fitting solves the ridge-regularised (K Q,
K Q) normal equations once.  Learning is indirect: a postdistorter fitted
from the gain-normalised PA output back to its input is copied in front
of the PA.  ``saleh_pa`` is the Saleh AM/AM + AM/PM model.

The basis products, the normal equations and the application run under
``device.fp32_exact``, so complex64 products stay full float32 on the card
(cuBLAS would otherwise take TF32 where the caller allowed it).  The
functions run where their input lies; :class:`Predistorter` holds its
coefficients and delay-line tail on its device (the card unless told
otherwise), its carry as ``state`` (keys ``c`` and ``tail``, the JAX
object's attributes without the underscore).
"""

from __future__ import annotations

import torch

from ..device import bind_device, fp32_exact

__all__ = ["mp_basis", "mp_fit", "mp_apply", "dpd_learn", "saleh_pa",
           "Predistorter"]


def mp_basis(x: torch.Tensor, order: int, memory: int) -> torch.Tensor:
    """Memory-polynomial basis Phi (..., T, order memory): column q order
    + k is x[n-q] |x[n-q]|^(2k), delays zero-padded at the block head."""
    x = torch.as_tensor(x)
    T = x.shape[-1]
    ax = torch.abs(x)
    powers = [x]
    for _ in range(1, order):
        powers.append(powers[-1] * (ax * ax).to(x.dtype))
    cols = []
    for q in range(memory):
        cols.extend(powers if q == 0 else [
            torch.cat([x.new_zeros((*x.shape[:-1], q)), p[..., : T - q]], -1)
            for p in powers])
    return torch.stack(cols, dim=-1)


def mp_fit(x: torch.Tensor, y: torch.Tensor, order: int, memory: int,
           ridge: float = 1e-6) -> torch.Tensor:
    """Least-squares coefficients c with mp_apply(c, x) ~= y: solves
    (Phi^H Phi + ridge tr/N I) c = Phi^H y."""
    Phi = mp_basis(x, order, memory)
    with fp32_exact():
        A = torch.conj(Phi).T @ Phi
        n = A.shape[-1]
        A = A + (ridge * torch.trace(A).real / n) * torch.eye(
            n, dtype=A.dtype, device=A.device)
        b = torch.conj(Phi).T @ torch.as_tensor(y).to(Phi.dtype)
        return torch.linalg.solve_ex(A, b)[0]


def mp_apply(coefs: torch.Tensor, x: torch.Tensor, order: int,
             memory: int) -> torch.Tensor:
    """Apply a memory polynomial: one (T, K Q) @ (K Q,) product."""
    with fp32_exact():
        return mp_basis(x, order, memory) @ coefs


def saleh_pa(x, alpha_a: float = 2.1587, beta_a: float = 1.1517,
             alpha_p: float = 4.0033, beta_p: float = 9.1040):
    """Saleh PA: AM/AM A(r) = aa r / (1 + ba r^2), AM/PM
    P(r) = ap r^2 / (1 + bp r^2) radians (memoryless)."""
    x = torch.as_tensor(x)
    r = torch.abs(x)
    r2 = r * r
    gain = alpha_a / (1.0 + beta_a * r2)
    phase = alpha_p * r2 / (1.0 + beta_p * r2)
    return x * (gain * torch.exp(1j * phase)).to(x.dtype)


def dpd_learn(pa_fn, x, order: int = 5, memory: int = 3,
              iters: int = 3, ridge: float = 1e-6):
    """Indirect-learning DPD: (coefs, linear_gain).  Each iteration drives
    the PA with the current predistorted signal, normalises its output by
    the small-signal gain g (from the lowest-envelope decile, estimated
    once) and fits the postdistorter y / g -> PA input."""
    x = torch.as_tensor(x)
    order, memory = int(order), int(memory)
    coefs = x.new_zeros(order * memory)
    coefs[0] = 1.0
    g = None
    for _ in range(max(1, int(iters))):
        u = mp_apply(coefs, x, order, memory)
        y = pa_fn(u)
        if g is None:
            r = torch.abs(u)
            small = (r <= torch.quantile(r, 0.1)).to(u.dtype)
            g = (torch.sum(y * torch.conj(u) * small)
                 / torch.clamp(torch.sum(r * r * small.real), min=1e-30))
        coefs = mp_fit(y / g, u, order, memory, ridge)
    return coefs, g


class Predistorter:
    """Stateful block predistorter (carries the delay-line tail) on
    ``device`` (the card unless told otherwise)."""

    def __init__(self, coefs, order: int, memory: int,
                 dtype=torch.complex64, device=None):
        self.order, self.memory = int(order), int(memory)
        dev = bind_device(device)
        self._c = torch.as_tensor(coefs).to(dev, dtype)
        self._tail = torch.zeros(max(self.memory - 1, 0), dtype=dtype,
                                 device=dev)

    @property
    def state(self) -> dict:
        return {"c": self._c, "tail": self._tail}

    @state.setter
    def state(self, st):
        self._c = st["c"].to(self._c.device, self._c.dtype)
        self._tail = st["tail"].to(self._c.device, self._c.dtype)

    def execute_block(self, x):
        x = torch.as_tensor(x).to(self._c.device, self._c.dtype)
        ext = torch.cat([self._tail, x], -1)
        y = mp_apply(self._c, ext, self.order, self.memory)
        if self.memory > 1:
            self._tail = ext[..., -(self.memory - 1):]
            return y[..., self.memory - 1:]
        return y

    def reset(self):
        self._tail = torch.zeros_like(self._tail)

    def __repr__(self):
        return (f"Predistorter [order={self.order}] "
                f"[memory={self.memory}]")
