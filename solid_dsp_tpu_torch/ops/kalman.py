"""Kalman filtering, the RTS smoother and steady-state trackers.

Port of ``solid_dsp_tpu/ops/kalman.py``:

* ``kalman_apply``: the full time-varying filter (predict/update with the
  Riccati recursion carried);
* ``rts_smooth``: that filter forward, then the Rauch-Tung-Striebel pass
  backward;
* ``steady_state_gain``: the asymptotic gain on the host (numpy float64);
* ``kalman_lti_apply``: the steady-state filter x_k = F x_{k-1} + K z_k,
  ``"scan"`` (sequential) or ``"parallel"`` (``linrec.affine_scan`` in
  torch ops) on a CPU tensor, both S4's LTI entry on a CUDA tensor;
* ``make_kalman_lti``: the same filter by modal decomposition, n scalar
  recurrences on ``linrec.chunked_first_order`` and full-float32 products
  (on a CUDA tensor, S4's LTI entry);
* ``cv_model``, ``alpha_beta_gains`` and ``AlphaBetaTracker``.

The recursions are S4, CUDA kernels (``ops/cuda_track.py``), time-parallel
chunk-and-join kernels that a CUDA tensor launches: the filter's forward
walk (``csrc/track_forward.cu``, Sarkka and Garcia-Fernandez's filtering
elements joined in float64), the smoother's backward walk and both routes
of ``kalman_lti_apply`` and of ``make_kalman_lti``'s apply
(``csrc/track_chunks.cu``).  A CPU tensor takes the plain versions here:
the sequential walks :func:`kalman_walk_plain`, :func:`rts_backward_plain`
and :func:`lti_walk_plain` (``"scan"``), or ``affine_scan``
(``"parallel"``), and the modal route, so that each route is held against
JAX's route of the same name.  :func:`kalman_forward_chunked_torch`,
:func:`lti_chunked_torch` and :func:`rts_backward_chunked_torch` are the
kernels' association in torch ops (vectorised over chunks, each chunk's
steps in the kernels' order of operations), against which the card tests
and ``chip_smoke.py`` hold the kernels; nothing on the card's main path
runs them.  The kernels take n <= 8 states and m <= 8 measurements
(``cuda_track.fits``); a CUDA tensor of a larger model takes the plain
version on the card, counted on the wrapper's ``plain_routes``.

F3 (the JAX package's ``make_kalman_lti`` transposes any (1, m) gain, which
is wrong for a one-state system with several measurements) is met here:
the gain is oriented by F, transposed only where K.shape[1] == F.shape[0]
!= K.shape[0], and anything else raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import fp32_exact, resolve_device
from . import cuda_track, linrec
from .cuda_build import use_kernel
from .linrec import affine_scan, associative_scan, chunked_first_order

__all__ = ["kalman_init", "kalman_apply", "rts_smooth",
           "steady_state_gain", "kalman_lti_apply", "make_kalman_lti",
           "alpha_beta_gains", "AlphaBetaTracker", "cv_model",
           "kalman_walk_plain", "rts_backward_plain", "lti_walk_plain",
           "lti_chunked_torch", "rts_backward_chunked_torch",
           "kalman_forward_chunked_torch"]


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


def _kf_step(x, P, z, A, C, Q, R):
    """One predict/update in the forward kernel's order (each sum left to
    right, every product and sum rounded on its own, the gain by
    :func:`_solve_in_order`) for states x (..., n), P (..., n, n) and
    measurements z (..., m): (x, P, xp, Pp)."""
    n = A.shape[-1]
    xp = _seq_dot(A, x[..., None, :])
    AP = _seq_dot(A[:, None, :], P.transpose(-1, -2)[..., None, :, :])
    Pp = _seq_dot(AP[..., :, None, :], A) + Q
    Y = _seq_dot(Pp[..., None, :, :], C[:, None, :])        # (P- C')'
    St = _seq_dot(C, Y[..., :, None, :]) + R.T              # (C P- C' + R)'
    Kt = _solve_in_order(St, Y).transpose(-1, -2)           # K (..., n, m)
    v = z - _seq_dot(C, xp[..., None, :])
    x2 = xp + _seq_dot(Kt, v[..., None, :])
    IKC = (torch.eye(n, dtype=A.dtype, device=A.device)
           - _seq_dot(Kt[..., :, None, :], C.T))
    P2 = _seq_dot(IKC[..., :, None, :], Pp.transpose(-1, -2)[..., None, :, :])
    return x2, P2, xp, Pp


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _element_after(earlier, later):
    """Two filtering elements (A, b, C, eta, J) composed in float64,
    ``earlier`` applied first (Sarkka and Garcia-Fernandez's combination):
    W = (I + C1 J2)^-1, A = A2 W A1, b = A2 W (b1 + C1 eta2) + b2, C = A2 W
    C1 A2' + C2, eta = A1' W' (eta2 - J2 b1) + eta1, J = A1' W' J2 A1 +
    J1."""
    A1, b1, C1, e1, J1 = earlier
    A2, b2, C2, e2, J2 = later
    eye = torch.eye(A1.shape[-1], dtype=A1.dtype, device=A1.device)
    W = torch.linalg.inv(eye + C1 @ J2)
    T1 = A2 @ W
    U = A1.transpose(-1, -2) @ W.transpose(-1, -2)
    return (T1 @ A1, _mv(T1, b1 + _mv(C1, e2)) + b2,
            T1 @ C1 @ A2.transpose(-1, -2) + C2,
            _mv(U, e2 - _mv(J2, b1)) + e1, U @ J2 @ A1 + J1)


def _element_apply(el, x, P):
    """The state (x, P) before an element's first step carried through it:
    W = (I + P J)^-1, x = A W (x + P eta) + b, P = A W P A' + C."""
    A, b, C, e, J = el
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    T1 = A @ torch.linalg.inv(eye + P @ J)
    return (_mv(T1, x + _mv(P, e)) + b,
            T1 @ P @ A.transpose(-1, -2) + C)


def kalman_forward_chunked_torch(x, P, Z, A, C, Q, R, keep: bool = False,
                                 chunk: int | None = None):
    """The forward kernel's association of the filter's walk in torch ops,
    the same arguments and results as :func:`kalman_walk_plain` (model
    tensors of Z's type, T >= 1), with an optional leading lane axis on x, P
    and Z.  The T steps are cut into chunks of ``chunk`` steps
    (``cuda_track.FWD_CHUNK``); each full chunk's filtering element is its
    (A, C, J) parts from ``cuda_track.forward_tables`` and its (b, eta)
    summed from its measurements in float64; the chunks' starts (x, P) are
    joined in float64 from the carried state (a doubling scan of the
    elements); each chunk is walked again from its start rounded once to the
    working type, in the kernel's order of operations (:func:`_kf_step`).
    It differs from the kernel only by the order of the float64 sums."""
    dt = Z.dtype
    T, m = (int(v) for v in Z.shape[-2:])
    n = A.shape[-1]
    lead = tuple(Z.shape[:-2])
    x, P = x.to(Z.device, dt), P.to(Z.device, dt)
    Lc = chunk or cuda_track.FWD_CHUNK
    nc = -(-T // Lc)
    xs, Ps = x[None], P[None]
    if nc > 1:
        f64 = dict(dtype=torch.float64, device=Z.device)
        vals = [linrec.rounded(linrec.host_values(a), dt).reshape(a.shape)
                for a in (A, C, Q, R)]
        Ac, Cc, Jc, Wb, We = (torch.from_numpy(t).to(**f64) for t in
                              cuda_track.forward_tables(*vals, Lc))
        zc = Z[..., :(nc - 1) * Lc, :].to(torch.float64).reshape(
            *lead, nc - 1, Lc, m).movedim(len(lead), 0)
        mats = [t.expand(nc - 1, *lead, n, n) for t in (Ac, Cc, Jc)]
        pre = linrec.associative_scan(_element_after, (
            mats[0], torch.einsum("inj,...ij->...n", Wb, zc), mats[1],
            torch.einsum("inj,...ij->...n", We, zc), mats[2]))
        xj, Pj = _element_apply(pre, x.to(torch.float64),
                                P.to(torch.float64))
        xs, Ps = torch.cat([xs, xj.to(dt)]), torch.cat([Ps, Pj.to(dt)])
    zp = torch.cat([Z, Z.new_zeros(lead + (nc * Lc - T, m))], dim=-2)
    zp = zp.reshape(*lead, nc, Lc, m).movedim(len(lead), 0)
    ops = [a.to(Z.device, dt) for a in (A, C, Q, R)]
    outs = []
    for i in range(Lc):
        xs, Ps, xp, Pp = _kf_step(xs, Ps, zp[..., i, :], *ops)
        outs.append((xs, Ps, xp, Pp) if keep else (xs, Ps))
    k = len(lead)

    def time_order(vs):
        """Per-step outputs (each (nc, *lead, ...)) as (*lead, T, ...)."""
        v = torch.stack(vs, 1 + k).movedim(0, k)
        return v.flatten(k, k + 1).narrow(k, 0, T)
    cols = [time_order(c) for c in zip(*outs)]
    X, Pf = cols[0], cols[1]
    return (X, X[..., -1, :], Pf[..., -1, :, :]) + (
        (Pf, cols[2], cols[3]) if keep else ())


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
    C) P-.  S4's forward entry (time-parallel) on a CUDA tensor."""
    x, P = state
    host = (A, C, Q, R)
    Z2, A, C, Q, R, dt = _model(Z, x, A, C, Q, R)
    x, P = x.to(Z2.device, dt), P.to(Z2.device, dt)
    if _use_s4(Z2, A.shape[-1], C.shape[0], cuda_track.kalman_filter_cuda):
        X, x, P = cuda_track.kalman_filter_cuda(x, P, Z2, A, C, Q, R,
                                                host=host)
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


def _seq_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_k a[..., k] b[..., k] taken left to right, each product and sum
    rounded on its own (the chunk-and-join kernels' order)."""
    a, b = torch.broadcast_tensors(a, b)
    acc = a[..., 0] * b[..., 0]
    for k in range(1, a.shape[-1]):
        acc = acc + a[..., k] * b[..., k]
    return acc


def _solve_in_order(M, Y):
    """M^-1 Y for M (..., k, k) symmetric positive definite and Y (..., k,
    c): elimination without pivoting, then back substitution, every
    operation rounded on its own (the kernels' ``spd_solve`` order)."""
    M, Y = M.clone(), Y.clone()
    n = M.shape[-1]
    for k in range(n):
        inv = torch.ones_like(M[..., k, k]) / M[..., k, k]
        for i in range(k + 1, n):
            f = (M[..., i, k] * inv)[..., None]
            M[..., i, k:] = M[..., i, k:] - f * M[..., k, k:]
            Y[..., i, :] = Y[..., i, :] - f * Y[..., k, :]
    for k in range(n - 1, -1, -1):
        s = Y[..., k, :]
        for j in range(k + 1, n):
            s = s - M[..., k, j, None] * Y[..., j, :]
        Y[..., k, :] = s / M[..., k, k, None]
    return Y


def _rts_gain(Pf, Pp, A):
    """The backward kernel's gain as Y = G' (Y[j, c] = G[c, j]) for steps
    Pf, Pp (..., n, n): Y = (P_t A')' by sequential sums, then solved
    against (P-_{t+1})' (:func:`_solve_in_order`)."""
    Y = _seq_dot(Pf[..., None, :, :], A[:, None, :])
    return _solve_in_order(Pp.transpose(-1, -2), Y)


def _rts_step(Y, xf, Pf, xp, Pp, x, P):
    """The plain step with the gain Y = G' in the kernels' order: x_t + G
    (x - x-), P_t + (G (P - P-)) G'."""
    Yt = Y.transpose(-1, -2)
    x2 = xf + _seq_dot(Yt, (x - xp)[..., None, :])
    GD = _seq_dot(Yt[..., :, None, :], (P - Pp).transpose(-1, -2)[..., None,
                                                                  :, :])
    return x2, Pf + _seq_dot(GD[..., :, None, :], Yt[..., None, :, :])


def _map_after(earlier, later):
    """Two chunk maps (M, e, E) composed, ``earlier`` applied first."""
    M1, e1, E1 = earlier
    M2, e2, E2 = later
    return (M2 @ M1, (M2 @ e1[..., None])[..., 0] + e2,
            M2 @ E1 @ M2.transpose(-1, -2) + E2)


def rts_backward_chunked_torch(Xf, Pf, Xp, Pp, A, chunk: int | None = None):
    """The backward kernel's association of the RTS pass in torch ops, the
    same arguments and results as :func:`rts_backward_plain` (with
    optional leading lane axes): the T - 1 steps (t = T-2 .. 0) cut into
    chunks of ``chunk`` steps (``cuda_track.RTS_CHUNK``); every step's gain
    at once in the kernel's order; each chunk's steps composed in float64
    into one map x -> M x + e, P -> M P M' + E ((e, E) the chunk walked from
    zero); the chunks' starts joined in float64 from the filter's last step
    (a doubling scan of the maps); each chunk walked again from its start
    rounded once to the working type, in the kernel's order of operations.
    It differs from the kernel only by the order of the float64 sums."""
    T = int(Xf.shape[-2])
    if T <= 1:
        return Xf.clone(), Pf.clone()
    Lc = chunk or cuda_track.RTS_CHUNK
    S = T - 1
    nc = -(-S // Lc)
    pad = nc * Lc - S
    n = Xf.shape[-1]
    A = A.to(Xf.dtype)

    def walk_order(t, lo, tail, fill):
        """Steps s = 0 .. S-1 (t = T-2-s) of t[..., lo:lo+S, *tail] on axis
        0, padded to nc Lc steps with ``fill``, as (nc, Lc, ...)."""
        v = t.narrow(-1 - len(tail), lo, S).flip(-1 - len(tail))
        v = v.movedim(-1 - len(tail), 0)
        if pad:
            v = torch.cat([v, fill.expand(pad, *v.shape[1:]).to(v)])
        return v.reshape(nc, Lc, *v.shape[1:])

    zero = Xf.new_zeros(())
    xf = walk_order(Xf, 0, (n,), zero)
    pf = walk_order(Pf, 0, (n, n), zero)
    xp = walk_order(Xp, 1, (n,), zero)
    pp = walk_order(Pp, 1, (n, n), torch.eye(n, dtype=Xf.dtype,
                                               device=Xf.device))
    Y = _rts_gain(pf, pp, A)                     # (nc, Lc, ..., n, n)
    w = [v.to(torch.float64) for v in (Y, xf, pf, xp, pp)]
    M = torch.eye(n, dtype=torch.float64, device=Xf.device).expand(
        nc, *Y.shape[2:]).clone()
    e = torch.zeros((nc, *xf.shape[2:]), dtype=torch.float64,
                    device=Xf.device)
    E = torch.zeros_like(M)
    for i in range(Lc):
        e, E = _rts_step(*(v[:, i] for v in w), e, E)
        M = w[0][:, i].transpose(-1, -2) @ M
    last_x, last_P = Xf[..., -1, :], Pf[..., -1, :, :]
    x, P = last_x[None], last_P[None]
    if nc > 1:
        pM, pe, pE = associative_scan(_map_after, (M[:-1], e[:-1], E[:-1]))
        x0w, P0w = last_x.to(torch.float64), last_P.to(torch.float64)
        xs = (pM @ x0w[..., None])[..., 0] + pe
        Ps = pM @ P0w @ pM.transpose(-1, -2) + pE
        x = torch.cat([x, xs.to(Xf.dtype)])
        P = torch.cat([P, Ps.to(Xf.dtype)])
    out_x, out_P = [], []
    for i in range(Lc):
        x, P = _rts_step(Y[:, i], xf[:, i], pf[:, i], xp[:, i], pp[:, i],
                         x, P)
        out_x.append(x)
        out_P.append(P)

    lead = Xf.dim() - 2

    def time_order(outs, last):
        """Walk-order outputs (each (nc, ...)) back in time order, the
        filter's last step after them."""
        v = torch.stack(outs, 1).reshape(nc * Lc, *outs[0].shape[1:])[:S]
        v = v.flip(0).movedim(0, lead)
        return torch.cat([v, last.unsqueeze(lead)], dim=lead)
    return time_order(out_x, last_x), time_order(out_P, last_P)


def rts_smooth(state, Z, A, C, Q, R):
    """Rauch-Tung-Striebel fixed-interval smoother over a block: the
    forward filter (``kalman_apply``'s model arguments), then the backward
    pass.  Returns (Xs (T, n), Ps (T, n, n)), every step smoothed by all T
    measurements.  Both passes are S4 on a CUDA tensor, each
    time-parallel."""
    x, P = state
    host = (A, C, Q, R)
    Z2, A, C, Q, R, dt = _model(Z, x, A, C, Q, R)
    x, P = x.to(Z2.device, dt), P.to(Z2.device, dt)
    if _use_s4(Z2, A.shape[-1], C.shape[0], cuda_track.kalman_filter_cuda):
        Xf, _, _, Pf, Xp, Pp = cuda_track.kalman_filter_cuda(
            x, P, Z2, A, C, Q, R, keep=True, host=host)
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


def _lti_rows(F, x, rows):
    """x_t = F x_{t-1} + b_t over rows (K, ..., n) from x (..., n), each
    row's sum left to right, every operation rounded (the LTI kernel's
    order): (X (K, ..., n), x_K)."""
    outs = []
    for b in rows:
        acc = F[:, 0] * x[..., :1]
        for j in range(1, F.shape[-1]):
            acc = acc + F[:, j] * x[..., j:j + 1]
        x = acc + b
        outs.append(x)
    return (torch.stack(outs) if outs else rows.clone()), x


def lti_chunked_torch(x0, B, F, chunk: int | None = None):
    """The LTI kernel's association in torch ops: x_t = F x_{t-1} + b_t
    over B ([L,] T, n) from x0 ([L,] n) -> (X, x_T), F rounded to B's
    dtype.  Chunks of ``chunk`` steps (by default ``cuda_track.lti_chunk``
    of F, as the kernel takes) walked from a zero state in the kernel's order
    (:func:`_lti_rows`), their ends joined in float64 through powers of F
    (``linrec.join_tables``), each chunk walked again from its start
    rounded once to B's dtype.  It differs from the kernel only by the order
    of the float64 join's sums."""
    dt = B.dtype
    Fr = linrec.rounded(linrec.host_values(F), dt)
    Ft = torch.from_numpy(Fr).to(B.device, dt)
    x0 = x0.to(B.device, dt)
    if B.shape[-2] == 0:
        return B.clone(), x0.clone()
    rows = B if B.dim() == 2 else B.movedim(-2, 0)
    X, xT = linrec.chunked_walk(
        lambda h, r: _lti_rows(Ft, h, r), Fr,
        chunk or cuda_track.lti_chunk(Fr, dt), x0, rows, linrec.WIDE[dt])
    return (X if B.dim() == 2 else X.movedim(0, -2)), xT


def kalman_lti_apply(x0, Z, K, F, method: str = "parallel"):
    """The steady-state (LTI) filter x_k = F x_{k-1} + K z_k: x0 (n,), Z
    (T, m) or (T,) -> (X (T, n), x_T).  On a CUDA tensor both routes are
    S4's LTI entry (time-parallel chunk-and-join).  On a CPU tensor
    ``"parallel"`` is the affine recurrence by ``linrec.affine_scan``
    (log-depth, torch ops) and ``"scan"`` the sequential walk."""
    Z = torch.as_tensor(Z)
    x0 = torch.as_tensor(x0, device=Z.device)
    dt = torch.promote_types(Z.dtype, x0.dtype)
    F_host = F          # its values for the LTI kernel, read from the caller's
    F = torch.as_tensor(F, device=Z.device, dtype=dt)
    K = torch.as_tensor(K, device=Z.device, dtype=dt)
    if K.dim() == 1:
        K = K[:, None]
    Z2 = (Z[:, None] if Z.dim() == 1 else Z).to(dt)
    x0 = x0.to(dt)
    # (T, n): K z_k; one measurement is one product a value, the same as
    # the matmul's (whose k = 1 product ran 0.78 ms at 2^22 on the card)
    if K.shape[1] == 1:
        B = Z2 * K.T
    else:
        with fp32_exact():
            B = Z2 @ K.T
    if _use_s4(B, F.shape[-1], 1, cuda_track.kalman_lti_cuda):
        return cuda_track.kalman_lti_cuda(x0, B, F, F_host,
                                          parallel=method != "scan")
    if method == "scan":
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
    full float32; ``apply`` runs where Z lies: on a CUDA tensor it is S4's
    LTI entry (``kalman_lti_apply`` with K and F rounded to Z's type), the
    same filter walked time-parallel, where the modal route takes ~20-30 ms
    of torch ops at 2^22 on an H100."""
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
        if use_kernel("auto", Z):
            return kalman_lti_apply(
                torch.as_tensor(x0, device=Z.device, dtype=Z.dtype), Z, K, F)
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
