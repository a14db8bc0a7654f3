"""Adaptive FIR equalisation: block LMS / NLMS / CMA / decision-directed
LMS, block RLS, gradient training, and the frequency-domain adaptive
filter.

Port of ``solid_dsp_tpu/models/equalizer.py``.  Filtering and the
error-input correlations are ``ops/fir.py::conv1d_mxu`` (full float32 on
the card); RLS accumulates its exponentially weighted normal equations per
block and solves them once (the JAX package's block formulation, its
matmuls under ``device.fp32_exact``; ``solve_ex``, which like
``jnp.linalg.solve`` checks nothing, so a block makes no host sync);
FDAF's sub-block ``lax.scan`` is a loop over sub-blocks of m here.

**The trainer.**  ``make_equalizer_trainer`` takes one gradient step of
L = mean |y - d|^2 on the taps a block.  PyTorch's ``.grad`` of a real
loss in a complex leaf is the conjugate of JAX's ``grad``, which is what
the JAX trainer hands optax after its ``jnp.conj(g)`` (dL/dw*), so the
port takes ``.grad`` as it is.  The default optimiser is Adam with optax's
complex semantics (``optax.adam(3e-2)``: a real second moment |g|^2, kept
in a complex array as optax keeps it, b1 0.9, b2 0.999, eps 1e-8 outside
the root, the bias corrections in float64 as JAX computes them under
64-bit mode); ``torch.optim.Adam`` would keep a second moment per real
component.  A caller may pass ``optimizer``, a function from the list of
taps to a ``torch.optim.Optimizer``, instead.

Every state is built on ``device`` (the card unless told otherwise); the
functions run where their input lies.  The classes' carries are their
``state`` (mappings keyed by the JAX objects' attribute names without the
underscore: ``taps``/``tail``, ``R``/``p``/``tail``, FDAF's ``state``
(W, x_prev, P) with its host buffers ``xbuf``/``dbuf``), which
``interop.tensors_from_numpy`` and ``tensors_to_numpy`` move.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..device import bind_device, fp32_exact, resolve_device
from ..ops.fir import conv1d_mxu
from ..streaming.framing import extend_with_tail, frame_windows, split_tail
from .linear_mod import slice_symbols

__all__ = ["eq_init", "eq_apply", "lms_step", "nlms_step", "cma_step",
           "dd_lms_step", "make_rls", "make_equalizer_trainer",
           "adam_init", "adam_update",
           "LMSEqualizer", "RLSEqualizer", "CMAEqualizer",
           "fdaf_init", "fdaf_step", "FDAFCanceller"]


def eq_init(ntaps: int, dtype=torch.complex64, device=None):
    """(taps, tail): centre-spike taps and zero input history."""
    dev = resolve_device(device)
    taps = torch.zeros(ntaps, dtype=dtype, device=dev)
    taps[ntaps // 2] = 1.0
    return taps, torch.zeros(max(ntaps - 1, 0), dtype=dtype, device=dev)


def eq_apply(taps, tail, x):
    """Filter a block: y[t] = sum_i taps[i] x_ext[t+i]; returns (y, tail)."""
    x_ext = extend_with_tail(tail, x)
    return conv1d_mxu(x_ext, taps), split_tail(x_ext, taps.shape[-1] - 1)


def _filter_and_grad(taps, tail, x, err_fn):
    """(y, grad, x_ext): grad[i] = mean_t e[t] conj(x_ext[t + i]) with
    e = err_fn(y), a sliding correlation of the error against the input."""
    x_ext = extend_with_tail(tail, x)
    y = conv1d_mxu(x_ext, taps)
    e = err_fn(y)
    n = taps.shape[-1]
    grad = conv1d_mxu(torch.conj(x_ext), e)[..., :n] / x.shape[-1]
    return y, grad, x_ext


def lms_step(taps, tail, x, desired, mu=0.05):
    """One block-LMS step: (y, new_taps, new_tail), e = d - y,
    w += mu mean_t(e[t] W[t]^*)."""
    y, grad, x_ext = _filter_and_grad(
        taps, tail, x, lambda y: desired.to(y.dtype) - y)
    return (y, taps + mu * grad.to(taps.dtype),
            split_tail(x_ext, taps.shape[-1] - 1))


def nlms_step(taps, tail, x, desired, mu=0.5, eps=1e-8):
    """One block-NLMS step: LMS with the step normalised by the mean
    tap-window input energy n mean |x|^2."""
    n = taps.shape[-1]
    y, grad, x_ext = _filter_and_grad(
        taps, tail, x, lambda y: desired.to(y.dtype) - y)
    energy = n * torch.mean(torch.abs(x_ext) ** 2)
    return (y, taps + (mu / (eps + energy)) * grad.to(taps.dtype),
            split_tail(x_ext, n - 1))


def cma_step(taps, tail, x, mu=0.2, r2=1.0):
    """One block constant-modulus (Godard p = 2) step, blind:
    dJ/dw* = E[y (|y|^2 - r2) x*]."""
    y, grad, x_ext = _filter_and_grad(
        taps, tail, x, lambda y: y * (torch.abs(y) ** 2 - r2).to(y.dtype))
    return (y, taps - mu * grad.to(taps.dtype),
            split_tail(x_ext, taps.shape[-1] - 1))


def dd_lms_step(taps, tail, x, points, mu=0.05):
    """Decision-directed block LMS: desired = the nearest constellation
    point of the current output."""
    def err(y):
        c = torch.as_tensor(points, device=y.device).to(y.dtype)
        return c[slice_symbols(y, c).long()] - y
    y, grad, x_ext = _filter_and_grad(taps, tail, x, err)
    return (y, taps + mu * grad.to(taps.dtype),
            split_tail(x_ext, taps.shape[-1] - 1))


@lru_cache(maxsize=8)
def _forget_weights(T: int, lam: float, dtype, device) -> torch.Tensor:
    """lam^(T-1-t), newest sample weight 1, built in float64 once per
    (T, lam) and rounded to ``dtype``."""
    w = np.power(lam, np.arange(T - 1, -1, -1, dtype=np.float64))
    return torch.as_tensor(w, device=device).to(dtype)


def make_rls(ntaps: int, lam: float = 0.999, delta: float = 1e-2,
             dtype=torch.complex64, device=None):
    """Exponentially weighted RLS in block normal-equation form:
    ``(init, step)``, ``init() -> (R, p, tail)`` on ``device`` and
    ``step(R, p, tail, x, d) -> (y, R, p, tail)``.  After blocks totalling
    T samples the taps solve min_w sum_t lam^(T-1-t) |d_t - X[t] w|^2 +
    lam^T delta ||w||^2; ``y`` is filtered with the a-posteriori taps."""
    n = int(ntaps)
    lam = float(lam)
    dev = resolve_device(device)
    rdtype = torch.float32 if dtype == torch.complex64 else torch.float64

    def init():
        return (delta * torch.eye(n, dtype=dtype, device=dev),
                torch.zeros(n, dtype=dtype, device=dev),
                torch.zeros(max(n - 1, 0), dtype=dtype, device=dev))

    def step(R, p, tail, x, d):
        T = x.shape[-1]
        x_ext = extend_with_tail(tail, x)
        X = frame_windows(x_ext, n)                          # (T, n)
        wts = _forget_weights(T, lam, rdtype, X.device)
        Xw = X * wts[:, None].to(X.dtype)
        Xh = torch.conj(X).T
        with fp32_exact():
            R2 = (lam ** T) * R + Xh @ Xw
            p2 = (lam ** T) * p + Xh @ (wts.to(X.dtype) * d.to(X.dtype))
            w = torch.linalg.solve_ex(R2, p2)[0]
            y = X @ w
        return y, R2, p2, split_tail(x_ext, n - 1)

    return init, step


def adam_init(taps: torch.Tensor) -> dict:
    """optax ``scale_by_adam``'s state for the taps: count (int32), mu and
    nu (the taps' type; nu holds |g|^2 in its real part)."""
    return {"count": torch.zeros((), dtype=torch.int32, device=taps.device),
            "mu": torch.zeros_like(taps), "nu": torch.zeros_like(taps)}


def adam_update(g: torch.Tensor, state: dict, lr: float = 3e-2,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                eps_root: float = 0.0):
    """``optax.adam(lr)``'s update of the gradient g (dL/dw*) in optax's
    order: (updates, new_state); the step is ``taps + updates``."""
    mu = (1 - b1) * g + b1 * state["mu"]
    nu = (1 - b2) * (torch.conj(g) * g).real + b2 * state["nu"]
    count = state["count"] + 1
    c64 = count.to(torch.float64)
    mu_hat = mu / (1 - torch.pow(b1, c64)).to(mu.dtype)
    nu_hat = nu / (1 - torch.pow(b2, c64)).to(nu.dtype)
    updates = -lr * (mu_hat / (torch.sqrt(nu_hat + eps_root) + eps))
    return updates, {"count": count.to(torch.int32), "mu": mu, "nu": nu}


def make_equalizer_trainer(ntaps: int, optimizer=None,
                           dtype=torch.complex64, device=None):
    """Gradient-descent equalizer training: (init, train_step).

    ``init() -> (taps, opt_state, tail)``;
    ``train_step(taps, opt_state, tail, x, d) -> (y, taps, opt_state, tail,
    loss)``: one optimiser step on L = mean |y - d|^2.  With ``optimizer``
    None the step is :func:`adam_update` (optax's ``adam(3e-2)``) and
    opt_state its dict; otherwise ``optimizer([taps])`` builds a
    ``torch.optim.Optimizer``, which is the opt_state and updates the
    taps (a leaf that requires grad) in place."""
    dev = resolve_device(device)

    def init():
        taps, tail = eq_init(ntaps, dtype, dev)
        if optimizer is None:
            return taps, adam_init(taps), tail
        taps.requires_grad_(True)
        return taps, optimizer([taps]), tail

    def train_step(taps, opt_state, tail, x, d):
        x_ext = extend_with_tail(tail, x)
        w = taps if taps.requires_grad else taps.detach().requires_grad_(True)
        w.grad = None
        with fp32_exact(), torch.enable_grad():
            y = conv1d_mxu(x_ext, w)
            r = y - d.to(y.dtype)
            loss = torch.mean((r * torch.conj(r)).real)
            loss.backward()
        if optimizer is None:
            updates, opt_state = adam_update(w.grad, opt_state)
            new_taps = (taps + updates).to(taps.dtype)
        else:
            opt_state.step()
            new_taps = w
        return (y.detach(), new_taps, opt_state,
                split_tail(x_ext, ntaps - 1), loss.detach())

    return init, train_step


class _TapsEqualizer:
    """The taps and input tail that LMSEqualizer and CMAEqualizer carry,
    centre-spike initialised on ``device`` (the card unless told
    otherwise)."""

    def __init__(self, ntaps: int, dtype, device):
        self.ntaps = int(ntaps)
        self._taps, self._tail = eq_init(self.ntaps, dtype,
                                         bind_device(device))

    @property
    def taps(self) -> np.ndarray:
        return self._taps.cpu().numpy()

    @property
    def state(self) -> dict:
        return {"taps": self._taps, "tail": self._tail}

    @state.setter
    def state(self, st):
        self._taps, self._tail = (st[k].to(self._taps.device,
                                           self._taps.dtype)
                                  for k in ("taps", "tail"))

    def _input(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self._taps.device, self._taps.dtype)

    def reset(self):
        self._taps, self._tail = eq_init(self.ntaps, self._taps.dtype,
                                         self._taps.device)


class LMSEqualizer(_TapsEqualizer):
    """Stateful block-LMS equalizer on ``device`` (the card unless told
    otherwise)."""

    def __init__(self, ntaps: int, mu: float = 0.05, dtype=torch.complex64,
                 device=None):
        super().__init__(ntaps, dtype, device)
        self.mu = float(mu)

    def execute_block(self, x, desired=None):
        """Filter a block; adapts the taps when ``desired`` is given."""
        x = self._input(x)
        if desired is None:
            y, self._tail = eq_apply(self._taps, self._tail, x)
            return y
        y, self._taps, self._tail = lms_step(self._taps, self._tail, x,
                                             self._input(desired), self.mu)
        return y

    def __repr__(self):
        return f"LMSEqualizer [ntaps={self.ntaps}] [mu={self.mu}]"


class RLSEqualizer:
    """Stateful block-RLS equalizer (see :func:`make_rls`) on ``device``
    (the card unless told otherwise)."""

    def __init__(self, ntaps: int, lam: float = 0.999, delta: float = 1e-2,
                 dtype=torch.complex64, device=None):
        self.ntaps = int(ntaps)
        self.lam = float(lam)
        self._init, self._step = make_rls(ntaps, lam, delta, dtype,
                                          bind_device(device))
        self._R, self._p, self._tail = self._init()

    @property
    def taps(self) -> np.ndarray:
        with fp32_exact():
            return torch.linalg.solve_ex(self._R, self._p)[0].cpu().numpy()

    @property
    def state(self) -> dict:
        return {"R": self._R, "p": self._p, "tail": self._tail}

    @state.setter
    def state(self, st):
        self._R, self._p, self._tail = (st[k].to(self._p.device,
                                                 self._p.dtype)
                                        for k in ("R", "p", "tail"))

    def execute_block(self, x, desired):
        x = torch.as_tensor(x).to(self._p.device, self._p.dtype)
        d = torch.as_tensor(desired).to(self._p.device, self._p.dtype)
        y, self._R, self._p, self._tail = self._step(self._R, self._p,
                                                     self._tail, x, d)
        return y

    def reset(self):
        self._R, self._p, self._tail = self._init()

    def __repr__(self):
        return f"RLSEqualizer [ntaps={self.ntaps}] [lambda={self.lam}]"


class CMAEqualizer(_TapsEqualizer):
    """Stateful blind constant-modulus equalizer with decision-directed
    refinement once the eye is open, on ``device`` (the card unless told
    otherwise)."""

    def __init__(self, ntaps: int, mu: float = 0.2, r2: float = 1.0,
                 dtype=torch.complex64, device=None):
        super().__init__(ntaps, dtype, device)
        self.mu = float(mu)
        self.r2 = float(r2)

    def execute_block(self, x, points=None, mu_dd: float = 0.05):
        """One blind CMA block; with ``points`` (a constellation), one
        decision-directed LMS block instead."""
        x = self._input(x)
        if points is None:
            y, self._taps, self._tail = cma_step(self._taps, self._tail, x,
                                                 self.mu, self.r2)
        else:
            y, self._taps, self._tail = dd_lms_step(self._taps, self._tail,
                                                    x, points, mu_dd)
        return y

    def __repr__(self):
        return (f"CMAEqualizer [ntaps={self.ntaps}] [mu={self.mu}] "
                f"[r2={self.r2}]")


# ------------------------------------------- frequency-domain (FDAF)

def fdaf_init(m: int, dtype=torch.complex64, device=None):
    """(W (2m,) frequency weights, x_prev (m,) previous input block,
    P (2m,) float32 per-bin input-power average) for an FFT size of 2m."""
    dev = resolve_device(device)
    return (torch.zeros(2 * m, dtype=dtype, device=dev),
            torch.zeros(m, dtype=dtype, device=dev),
            torch.full((2 * m,), 1e-3, dtype=torch.float32, device=dev))


def fdaf_step(state, x, d, mu: float = 0.5, p_beta: float = 0.9,
              eps: float = 1e-6, constrained: bool = True):
    """Constrained fast-block NLMS over sub-blocks of m (overlap-save,
    per-bin power normalisation, the gradient's acausal half zeroed).
    x, d: (T,), T a multiple of m.  Returns (y (T,), e (T,), new_state)."""
    W, x_prev, P = state
    m = x_prev.shape[-1]
    ys, es = [], []
    for xm, dm in zip(x.reshape(-1, m), d.reshape(-1, m)):
        seg = torch.cat([x_prev, xm])
        Xf = torch.fft.fft(seg)
        y = torch.fft.ifft(Xf * W)[m:].to(seg.dtype)
        e = dm - y
        Ef = torch.fft.fft(torch.cat([e.new_zeros(m), e]))
        ax = torch.abs(Xf).to(P.dtype)
        P = p_beta * P + (1.0 - p_beta) * (ax * ax)
        G = torch.conj(Xf) * Ef / (P + eps).to(Xf.dtype)
        if constrained:
            g = torch.fft.ifft(G)
            G = torch.fft.fft(torch.cat([g[:m], g.new_zeros(m)]))
        W = W + mu * G.to(W.dtype)
        x_prev = xm
        ys.append(y)
        es.append(e)
    if not ys:
        return x[:0], d[:0], (W, x_prev, P)
    return torch.cat(ys), torch.cat(es), (W, x_prev, P)


class FDAFCanceller:
    """Streaming frequency-domain adaptive canceller / channel identifier
    on ``device`` (the card unless told otherwise): ``execute_block(x, d)``
    returns e = d - y; blocks of any length are buffered on the host to
    multiples of m, as in JAX."""

    def __init__(self, m: int = 256, mu: float = 0.5,
                 dtype=torch.complex64, device=None):
        if m < 1:
            raise ValueError("m must be >= 1")
        self.m = int(m)
        self.mu = float(mu)
        self._dtype = dtype
        self._device = bind_device(device)
        self._state = fdaf_init(self.m, dtype, self._device)
        self._xbuf = np.zeros(0, np.complex128)
        self._dbuf = np.zeros(0, np.complex128)

    @property
    def taps(self) -> np.ndarray:
        return np.fft.ifft(self._state[0].cpu().numpy())[: self.m]

    @property
    def state(self) -> dict:
        return {"state": self._state,
                "xbuf": torch.from_numpy(self._xbuf.copy()),
                "dbuf": torch.from_numpy(self._dbuf.copy())}

    @state.setter
    def state(self, st):
        W, x_prev, P = st["state"]
        self._state = (W.to(self._device, self._dtype),
                       x_prev.to(self._device, self._dtype),
                       P.to(self._device, torch.float32))
        self._xbuf, self._dbuf = (np.asarray(
            v.cpu().numpy() if isinstance(v, torch.Tensor) else v,
            np.complex128) for v in (st["xbuf"], st["dbuf"]))

    def execute_block(self, x, d):
        def host(v):
            return np.asarray(v.cpu().numpy() if isinstance(v, torch.Tensor)
                              else v)
        self._xbuf = np.concatenate([self._xbuf, host(x)])
        self._dbuf = np.concatenate([self._dbuf, host(d)])
        t = (len(self._xbuf) // self.m) * self.m
        if t == 0:
            return torch.zeros(0, dtype=self._dtype, device=self._device)
        xs = torch.as_tensor(self._xbuf[:t]).to(self._device, self._dtype)
        ds = torch.as_tensor(self._dbuf[:t]).to(self._device, self._dtype)
        self._xbuf = self._xbuf[t:]
        self._dbuf = self._dbuf[t:]
        _, e, self._state = fdaf_step(self._state, xs, ds, self.mu)
        return e

    def reset(self):
        self._state = fdaf_init(self.m, self._dtype, self._device)
        self._xbuf = np.zeros(0, np.complex128)
        self._dbuf = np.zeros(0, np.complex128)

    def __repr__(self):
        return f"FDAFCanceller [m={self.m}] [mu={self.mu}]"
