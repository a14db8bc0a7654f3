"""Kalman filtering, the RTS smoother and steady-state trackers.

Port of ``solid_dsp_tpu/ops/kalman.py``:

* ``kalman_apply``: the full time-varying filter (predict/update with the
  Riccati recursion carried), sequential;
* ``rts_smooth``: that filter forward, then the Rauch-Tung-Striebel pass
  backward;
* ``steady_state_gain``: the asymptotic gain on the host (numpy float64);
* ``kalman_lti_apply``: the steady-state filter x_k = F x_{k-1} + K z_k,
  ``"scan"`` (sequential) or ``"parallel"`` (``linrec.affine_scan`` in
  torch ops);
* ``make_kalman_lti``: the same filter by modal decomposition, n scalar
  recurrences on ``linrec.chunked_first_order`` and full-float32 products;
* ``cv_model``, ``alpha_beta_gains`` and ``AlphaBetaTracker``.

The per-step recursions are S4, CUDA kernels of ``csrc/track_scan.cu``
(``ops/cuda_track.py``): on a CUDA tensor the filter's walk, the smoother's
backward walk and the ``"scan"`` route launch them; a CPU tensor takes the
plain versions here (:func:`kalman_walk_plain`, :func:`rts_backward_plain`,
:func:`lti_walk_plain`), the same recursions as torch loops.  The kernels
take n <= 8 states and m <= 8 measurements (``cuda_track.fits``); a CUDA
tensor of a larger model takes the plain version on the card, counted on
the wrapper's ``plain_routes``.

F3 (the JAX package's ``make_kalman_lti`` transposes any (1, m) gain, which
is wrong for a one-state system with several measurements) is met here:
the gain is oriented by F, transposed only where K.shape[1] == F.shape[0]
!= K.shape[0], and anything else raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import fp32_exact, resolve_device
from . import cuda_track
from .cuda_build import use_kernel
from .linrec import affine_scan, chunked_first_order

__all__ = ["kalman_init", "kalman_apply", "rts_smooth",
           "steady_state_gain", "kalman_lti_apply", "make_kalman_lti",
           "alpha_beta_gains", "AlphaBetaTracker", "cv_model",
           "kalman_walk_plain", "rts_backward_plain", "lti_walk_plain"]


def kalman_init(x0, P0, device=None):
    """The carry (x (n,), P (n, n)) as tensors on ``device`` (the card by
    default), in the inputs' types."""
    dev = resolve_device(device)
    return (torch.as_tensor(x0, device=dev), torch.as_tensor(P0, device=dev))


def _model(Z, x, A, C, Q, R):
    """The model as tensors on Z's device in the working type (that of x,
    P and Z together); Z as (T, m)."""
    Z = torch.as_tensor(Z)
    dt = torch.promote_types(x.dtype, Z.dtype)

    def on(a, two_d=False):
        t = torch.as_tensor(a, device=Z.device, dtype=dt)
        return t.reshape(1, -1) if two_d and t.dim() < 2 else t
    Z2 = Z[:, None] if Z.dim() == 1 else Z
    return Z2.to(dt), on(A), on(C, True), on(Q), on(R, True), dt


def _predict_update(x, P, z, A, C, Q, R, eye):
    """One predict/update, as JAX's ``_kf_predict_update`` writes it:
    (x2, P2, xp, Pp)."""
    xp = A @ x
    Pp = A @ P @ A.T + Q
    S = C @ Pp @ C.T + R
    K = torch.linalg.solve(S.T, (Pp @ C.T).T).T
    x2 = xp + K @ (z - C @ xp)
    P2 = (eye - K @ C) @ Pp
    return x2, P2, xp, Pp


def kalman_walk_plain(x, P, Z, A, C, Q, R, keep: bool = False):
    """The filter's walk as a torch loop over Z (T, m): (X (T, n), x_T,
    P_T) and, with ``keep``, also (Pf (T, n, n), Xp (T, n), Pp (T, n, n)),
    the filtered covariances and the predictions RTS needs."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    cols = ([], [], [], [])
    with fp32_exact():
        for t in range(Z.shape[0]):
            x, P, xp, Pp = _predict_update(x, P, Z[t], A, C, Q, R, eye)
            for c, v in zip(cols, (x, P, xp, Pp) if keep else (x,)):
                c.append(v)
    X, Pf, Xp, Pp = (torch.stack(c) if c else Z.new_zeros((0,) + shape)
                     for c, shape in zip(cols, ((n,), (n, n), (n,), (n, n))))
    return (X, x, P) + ((Pf, Xp, Pp) if keep else ())


def _use_s4(t: torch.Tensor, n: int, m: int, counter) -> bool:
    """Whether S4 runs: a CUDA tensor of a model that fits the kernel; a
    CUDA tensor of a larger model adds one to ``counter.plain_routes``."""
    if not use_kernel("auto", t):
        return False
    if cuda_track.fits(n, m):
        return True
    counter.plain_routes += 1
    return False


def kalman_apply(state, Z, A, C, Q, R):
    """The full Kalman filter over a block: state (x (n,), P (n, n)), Z
    (T, m) or (T,) -> (X_est (T, n), new state).  x- = A x, P- = A P A' +
    Q, S = C P- C' + R, K = P- C' S^-1, x = x- + K (z - C x-), P = (I - K
    C) P-.  S4's forward entry on a CUDA tensor."""
    x, P = state
    Z2, A, C, Q, R, dt = _model(Z, x, A, C, Q, R)
    x, P = x.to(Z2.device, dt), P.to(Z2.device, dt)
    if _use_s4(Z2, A.shape[-1], C.shape[0], cuda_track.kalman_filter_cuda):
        X, x, P = cuda_track.kalman_filter_cuda(x, P, Z2, A, C, Q, R)
        return X, (x, P)
    X, x, P = kalman_walk_plain(x, P, Z2, A, C, Q, R)
    return X, (x, P)


def rts_backward_plain(Xf, Pf, Xp, Pp, A):
    """The RTS pass as a torch loop, t = T-2 .. 0: G = P_t A' (P-_{t+1})^-1,
    x^_t = x_t + G (x^_{t+1} - x-_{t+1}), P^_t = P_t + G (P^_{t+1} -
    P-_{t+1}) G'.  (Xs (T, n), Ps (T, n, n)); the last step is the
    filter's."""
    xs, Ps = Xf[-1], Pf[-1]
    out_x, out_P = [xs], [Ps]
    with fp32_exact():
        for t in range(Xf.shape[0] - 2, -1, -1):
            G = torch.linalg.solve(Pp[t + 1].T, (Pf[t] @ A.T).T).T
            xs = Xf[t] + G @ (xs - Xp[t + 1])
            Ps = Pf[t] + G @ (Ps - Pp[t + 1]) @ G.T
            out_x.append(xs)
            out_P.append(Ps)
    return torch.stack(out_x[::-1]), torch.stack(out_P[::-1])


def rts_smooth(state, Z, A, C, Q, R):
    """Rauch-Tung-Striebel fixed-interval smoother over a block: the
    forward filter (``kalman_apply``'s model arguments), then the backward
    pass.  Returns (Xs (T, n), Ps (T, n, n)), every step smoothed by all T
    measurements.  Both passes are S4 on a CUDA tensor."""
    x, P = state
    Z2, A, C, Q, R, dt = _model(Z, x, A, C, Q, R)
    x, P = x.to(Z2.device, dt), P.to(Z2.device, dt)
    if _use_s4(Z2, A.shape[-1], C.shape[0], cuda_track.kalman_filter_cuda):
        Xf, _, _, Pf, Xp, Pp = cuda_track.kalman_filter_cuda(
            x, P, Z2, A, C, Q, R, keep=True)
        return cuda_track.rts_backward_cuda(Xf, Pf, Xp, Pp, A)
    Xf, _, _, Pf, Xp, Pp = kalman_walk_plain(x, P, Z2, A, C, Q, R, keep=True)
    return rts_backward_plain(Xf, Pf, Xp, Pp, A)


def steady_state_gain(A, C, Q, R, iters: int = 10_000, tol: float = 1e-12):
    """The asymptotic gain K by iterating the discrete Riccati equation to a
    fixed point (host numpy float64): (K, F), F = (I - K C) A."""
    A = np.asarray(A, np.float64)
    C = np.atleast_2d(np.asarray(C, np.float64))
    Q = np.asarray(Q, np.float64)
    R = np.atleast_2d(np.asarray(R, np.float64))
    n = A.shape[0]
    P = np.eye(n)
    for _ in range(iters):
        Pp = A @ P @ A.T + Q
        S = C @ Pp @ C.T + R
        K = Pp @ C.T @ np.linalg.inv(S)
        P2 = (np.eye(n) - K @ C) @ Pp
        if np.max(np.abs(P2 - P)) < tol:
            P = P2
            break
        P = P2
    Pp = A @ P @ A.T + Q
    S = C @ Pp @ C.T + R
    K = Pp @ C.T @ np.linalg.inv(S)
    F = (np.eye(n) - K @ C) @ A
    return K, F


def lti_walk_plain(x, B, F):
    """x_t = F x_{t-1} + b_t as a torch loop over B (T, n): (X, x_T)."""
    outs = []
    with fp32_exact():
        for t in range(B.shape[0]):
            x = F @ x + B[t]
            outs.append(x)
    return (torch.stack(outs) if outs else B.new_zeros(B.shape)), x


def kalman_lti_apply(x0, Z, K, F, method: str = "parallel"):
    """The steady-state (LTI) filter x_k = F x_{k-1} + K z_k: x0 (n,), Z
    (T, m) or (T,) -> (X (T, n), x_T).  ``"parallel"``: the affine
    recurrence by ``linrec.affine_scan`` (log-depth, torch ops);
    ``"scan"``: sequential, S4's LTI entry on a CUDA tensor."""
    Z = torch.as_tensor(Z)
    x0 = torch.as_tensor(x0, device=Z.device)
    dt = torch.promote_types(Z.dtype, x0.dtype)
    F = torch.as_tensor(F, device=Z.device, dtype=dt)
    K = torch.as_tensor(K, device=Z.device, dtype=dt)
    if K.dim() == 1:
        K = K[:, None]
    Z2 = (Z[:, None] if Z.dim() == 1 else Z).to(dt)
    x0 = x0.to(dt)
    with fp32_exact():
        B = Z2 @ K.T                                     # (T, n): K z_k
    if method == "scan":
        if _use_s4(B, F.shape[-1], 1, cuda_track.kalman_lti_cuda):
            return cuda_track.kalman_lti_cuda(x0, B, F)
        return lti_walk_plain(x0, B, F)
    T = B.shape[0]
    Fs = F.expand(T, *F.shape)
    with fp32_exact():
        B0 = torch.cat([B[:1] + (F @ x0)[None], B[1:]])
    X = affine_scan(Fs, B0)
    return X, X[-1]


def _oriented_gain(K, n: int) -> np.ndarray:
    """K as (n, m), oriented by F's n: transposed only where K.shape[1] ==
    n != K.shape[0] (F3); any other shape raises."""
    K = np.atleast_2d(np.asarray(K, np.float64))
    if K.shape[0] == n:
        return K
    if K.shape[1] == n:
        return K.T
    raise ValueError(f"gain of shape {K.shape} fits no orientation of a "
                     f"{n}-state F")


def make_kalman_lti(K, F, chunk: int = 256):
    """A steady-state tracker ``apply(x0, Z) -> (X, x_T)`` by modal
    decomposition: F = V diag(lam) V^-1 turns the filter into n scalar
    recurrences on the modal inputs u = V^-1 K z (plus V^-1 F x0 at t = 0),
    each by ``linrec.chunked_first_order``; X = Re(V s).  ``K`` (n, m) and
    ``F`` (n, n) are host arrays (the gain oriented by F: F3).  A defective
    F (cond(V) > 1e8) takes ``kalman_lti_apply(method="parallel")`` with K
    and F rounded to float32, as the JAX package does.  The products run at
    full float32; ``apply`` runs where Z lies."""
    F = np.asarray(F, np.float64)
    n = F.shape[0]
    K = _oriented_gain(K, n)
    lam, V = np.linalg.eig(F)
    if np.linalg.cond(V) > 1e8:
        K32, F32 = K.astype(np.float32), F.astype(np.float32)

        def apply_fallback(x0, Z):
            return kalman_lti_apply(x0, Z, K32, F32, method="parallel")
        return apply_fallback
    Vinv = np.linalg.inv(V)
    real_modes = not np.iscomplexobj(lam) or np.max(np.abs(lam.imag)) == 0.0
    if real_modes:
        lam, V, Vinv = lam.real, V.real, Vinv.real
    G = Vinv @ K                                  # (n, m) modal gains
    G0 = Vinv @ F                                 # folds x0 into u[:, 0]

    def const(a, dtype, device):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

    def modal_inputs(Z2, x0, part):
        rdt, dev = Z2.dtype, Z2.device
        U = (Z2 @ const(part(G).T, rdt, dev)).T.clone()     # (n, T)
        U[:, 0] += const(part(G0), rdt, dev) @ x0
        return U

    def apply(x0, Z):
        Z = torch.as_tensor(Z)
        Z2 = Z[:, None] if Z.dim() == 1 else Z
        rdt, dev = Z2.dtype, Z2.device
        x0 = torch.as_tensor(x0, device=dev, dtype=rdt)
        with fp32_exact():
            Ur = modal_inputs(Z2, x0, np.real)
            if real_modes:
                S = chunked_first_order(lam, Ur, chunk=chunk)
                X = S.T @ const(V.T, rdt, dev).to(S.dtype)
            else:
                Ui = modal_inputs(Z2, x0, np.imag)
                S = chunked_first_order(lam, torch.complex(Ur, Ui),
                                        chunk=chunk)
                Sr, Si = S.real, S.imag
                X = (Sr.T @ const(np.real(V).T, rdt, dev).to(Sr.dtype)
                     - Si.T @ const(np.imag(V).T, rdt, dev).to(Si.dtype))
        X = X.to(rdt)
        return X, X[-1]

    return apply


def cv_model(dt: float, sigma_a: float, sigma_z: float):
    """The constant-velocity model (position measured, white acceleration
    of std ``sigma_a``): (A, C, Q, R), numpy float64."""
    A = np.array([[1.0, dt], [0.0, 1.0]])
    C = np.array([[1.0, 0.0]])
    Q = sigma_a**2 * np.array([[dt**4 / 4, dt**3 / 2],
                               [dt**3 / 2, dt**2]])
    R = np.array([[sigma_z**2]])
    return A, C, Q, R


def alpha_beta_gains(tracking_index: float) -> tuple:
    """Kalata's steady-state gains (alpha, beta) of the constant-velocity
    tracker for the tracking index sigma_a dt^2 / sigma_z."""
    L = float(tracking_index)
    r = (4 + L - np.sqrt(8 * L + L * L)) / 4
    alpha = 1 - r * r
    beta = 2 * (2 - alpha) - 4 * np.sqrt(1 - alpha)
    return float(alpha), float(beta)


class AlphaBetaTracker:
    """Streaming constant-velocity tracker: positions in, [position,
    velocity] estimates out, the state carried between blocks.  The
    steady-state filter of ``cv_model`` with K = [alpha, beta / dt].  Runs
    on ``device`` (the card by default)."""

    def __init__(self, alpha: float, beta: float, dt: float = 1.0,
                 dtype=torch.float32, device=None):
        self.alpha, self.beta, self.dt = float(alpha), float(beta), float(dt)
        dev = resolve_device(device)
        A = np.array([[1.0, self.dt], [0.0, 1.0]])
        K = np.array([[self.alpha], [self.beta / self.dt]])
        C = np.array([[1.0, 0.0]])
        F = (np.eye(2) - K @ C) @ A
        self._F = torch.as_tensor(F, dtype=dtype, device=dev)
        self._K = torch.as_tensor(K, dtype=dtype, device=dev)
        self._x = torch.zeros(2, dtype=dtype, device=dev)

    def execute_block(self, z, method: str = "parallel"):
        """z (T,) positions -> (T, 2) [position, velocity] estimates."""
        z = torch.as_tensor(z).to(self._F.device, self._F.dtype)
        X, self._x = kalman_lti_apply(self._x, z, self._K, self._F,
                                      method=method)
        return X

    def reset(self):
        self._x = torch.zeros_like(self._x)

    def __repr__(self):
        return (f"AlphaBetaTracker [alpha={self.alpha:.4f}] "
                f"[beta={self.beta:.4f}] [dt={self.dt}]")
