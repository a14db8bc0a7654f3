"""Port vs JAX package: ops/kalman.py and S4's plain versions.

The same seeded numpy inputs go through both packages on the CPU (a CPU
tensor takes S4's plain versions: ``kalman_walk_plain``,
``rts_backward_plain``, ``lti_walk_plain``).  Gates: the filter and the
smoother in float64 within rtol 1e-8 of JAX's (tests/test_kalman.py:45-56's
tolerance against its numpy filter) and of an independent numpy walk; the
steady-state forms ("scan", "parallel", make_kalman_lti's modal route) in
float64 within 1e-9 of JAX's; float32 within 1e-4 relative of the float64
walk; block continuity (two half blocks equal one) to 1e-12 in float64;
the host designs (steady_state_gain, alpha_beta_gains, cv_model) equal.
F3: for one state and three measurements the port's make_kalman_lti is the
literal float64 recurrence x = F x + K z, where JAX's is not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.ops import kalman as jk
from solid_dsp_tpu_torch.ops import cuda_track
from solid_dsp_tpu_torch.ops import kalman as tk


def _sim_cv(T=300, sigma_a=0.05, sigma_z=1.0, seed=0):
    rng = np.random.default_rng(seed)
    vel = 0.7 + np.cumsum(sigma_a * rng.standard_normal(T))
    pos = np.cumsum(vel)
    return (pos + sigma_z * rng.standard_normal(T))[:, None]


def _np_walk(x, P, Z, A, C, Q, R):
    out = []
    for z in Z:
        xp = A @ x
        Pp = A @ P @ A.T + Q
        S = C @ Pp @ C.T + R
        K = Pp @ C.T @ np.linalg.inv(S)
        x = xp + K @ (z - C @ xp)
        P = (np.eye(len(x)) - K @ C) @ Pp
        out.append(x)
    return np.array(out), x, P


def _model4(seed=5):
    """A 4-state, 2-measurement model (two coupled oscillators)."""
    rng = np.random.default_rng(seed)
    A = np.eye(4) + 0.05 * rng.standard_normal((4, 4))
    C = rng.standard_normal((2, 4))
    Q = 0.01 * np.eye(4)
    R = np.diag([0.5, 0.3])
    return A, C, Q, R


def _close(got, ref, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("model", ["cv", "four_state"])
def test_kalman_apply_matches_jax_and_numpy(model):
    if model == "cv":
        A, C, Q, R = tk.cv_model(1.0, 0.05, 1.0)
        Z = _sim_cv()
    else:
        A, C, Q, R = _model4()
        Z = np.random.default_rng(2).standard_normal((200, 2))
    n = A.shape[0]
    x0, P0 = np.zeros(n), 10.0 * np.eye(n)
    X_np, xf_np, Pf_np = _np_walk(x0, P0, Z, A, C, Q, R)
    X, (xf, Pf) = tk.kalman_apply(tk.kalman_init(x0, P0, device="cpu"),
                                  torch.from_numpy(Z), A, C, Q, R)
    Xj, (xj, Pj) = jk.kalman_apply(jk.kalman_init(jnp.asarray(x0),
                                                  jnp.asarray(P0)),
                                   jnp.asarray(Z), A, C, Q, R)
    assert X.dtype == torch.float64 and X.shape == (Z.shape[0], n)
    _close(X, Xj, 1e-8, 1e-10)
    _close(X, X_np, 1e-8, 1e-10)
    _close(xf, xj, 1e-8)
    _close(Pf, Pj, 1e-8, 1e-12)


def test_kalman_apply_float32_and_1d_measurements():
    A, C, Q, R = tk.cv_model(1.0, 0.05, 1.0)
    Z = _sim_cv(seed=4)
    X64, _ = tk.kalman_apply(tk.kalman_init(np.zeros(2), 10 * np.eye(2),
                                            device="cpu"),
                             torch.from_numpy(Z[:, 0]), A, C, Q, R)
    st32 = tk.kalman_init(np.zeros(2, np.float32),
                          10 * np.eye(2, dtype=np.float32), device="cpu")
    X32, _ = tk.kalman_apply(st32, torch.from_numpy(Z[:, 0].astype(
        np.float32)), A, C, Q, R)
    assert X32.dtype == torch.float32
    scale = float(X64.abs().max())
    assert float((X32.double() - X64).abs().max()) <= 1e-4 * scale


def test_kalman_block_continuity():
    """Two half blocks == one full block (the carry is exact)."""
    A, C, Q, R = tk.cv_model(1.0, 0.05, 1.0)
    Z = torch.from_numpy(_sim_cv(seed=3))
    st = tk.kalman_init(np.zeros(2), 10.0 * np.eye(2), device="cpu")
    Xa, st2 = tk.kalman_apply(st, Z[:150], A, C, Q, R)
    Xb, st3 = tk.kalman_apply(st2, Z[150:], A, C, Q, R)
    Xf, stf = tk.kalman_apply(st, Z, A, C, Q, R)
    _close(torch.cat([Xa, Xb]), Xf, 1e-12, 1e-12)
    _close(st3[1], stf[1], 1e-12, 1e-14)


@pytest.mark.parametrize("model", ["cv", "four_state"])
def test_rts_smooth_matches_jax(model):
    if model == "cv":
        A, C, Q, R = tk.cv_model(1.0, 0.05, 1.0)
        Z = _sim_cv(T=200, seed=7)
    else:
        A, C, Q, R = _model4(8)
        Z = np.random.default_rng(9).standard_normal((150, 2))
    n = A.shape[0]
    x0, P0 = np.zeros(n), 10.0 * np.eye(n)
    Xs, Ps = tk.rts_smooth(tk.kalman_init(x0, P0, device="cpu"),
                           torch.from_numpy(Z), A, C, Q, R)
    Xj, Pj = jk.rts_smooth(jk.kalman_init(jnp.asarray(x0), jnp.asarray(P0)),
                           jnp.asarray(Z), A, C, Q, R)
    _close(Xs, Xj, 1e-8, 1e-10)
    _close(Ps, Pj, 1e-8, 1e-12)
    # the last step is the filter's
    Xk, (xk, Pk) = tk.kalman_apply(tk.kalman_init(x0, P0, device="cpu"),
                                   torch.from_numpy(Z), A, C, Q, R)
    _close(Xs[-1], xk, 1e-12)
    _close(Ps[-1], Pk, 1e-12, 1e-14)


def test_host_designs_equal_jax():
    for args in ((1.0, 0.05, 1.0), (0.5, 0.2, 3.0)):
        for a, b in zip(tk.cv_model(*args), jk.cv_model(*args)):
            np.testing.assert_array_equal(a, b)
    A, C, Q, R = tk.cv_model(1.0, 0.05, 1.0)
    for a, b in zip(tk.steady_state_gain(A, C, Q, R),
                    jk.steady_state_gain(A, C, Q, R)):
        np.testing.assert_array_equal(a, b)
    for lam in (0.01, 0.3, 2.0):
        assert tk.alpha_beta_gains(lam) == jk.alpha_beta_gains(lam)


@pytest.mark.parametrize("method", ["scan", "parallel"])
def test_kalman_lti_apply_matches_jax(method):
    A, C, Q, R = tk.cv_model(1.0, 0.05, 1.0)
    K, F = tk.steady_state_gain(A, C, Q, R)
    Z = _sim_cv(T=333, seed=11)
    x0 = np.array([0.5, -0.2])
    X, xT = tk.kalman_lti_apply(torch.from_numpy(x0), torch.from_numpy(Z),
                                K, F, method=method)
    Xj, xj = jk.kalman_lti_apply(jnp.asarray(x0), jnp.asarray(Z),
                                 jnp.asarray(K), jnp.asarray(F),
                                 method=method)
    _close(X, Xj, 1e-9, 1e-9)
    _close(xT, xj, 1e-9, 1e-9)
    # a (n,) gain is one measurement, as in JAX
    X1, _ = tk.kalman_lti_apply(torch.from_numpy(x0),
                                torch.from_numpy(Z[:, 0]), K[:, 0], F,
                                method=method)
    _close(X1, X, 1e-12, 1e-12)


def test_lti_walk_plain_is_the_recurrence():
    rng = np.random.default_rng(12)
    for n in (1, 3, 8):
        F = 0.9 * np.eye(n) + 0.05 * rng.standard_normal((n, n))
        B = rng.standard_normal((64, n))
        x = rng.standard_normal(n)
        X, xT = tk.lti_walk_plain(torch.from_numpy(x), torch.from_numpy(B),
                                  torch.from_numpy(F))
        ref = []
        for b in B:
            x = F @ x + b
            ref.append(x)
        _close(X, np.array(ref), 1e-12, 1e-12)
        _close(xT, x, 1e-12, 1e-12)


@pytest.mark.parametrize("case", ["real_modes", "complex_modes"])
def test_make_kalman_lti_matches_jax(case):
    if case == "real_modes":
        A, C, Q, R = tk.cv_model(1.0, 0.05, 1.0)
        K, F = tk.steady_state_gain(A, C, Q, R)
    else:
        th = 0.3
        F = 0.95 * np.array([[np.cos(th), -np.sin(th)],
                             [np.sin(th), np.cos(th)]])
        K = np.array([[0.2], [0.1]])
    Z = _sim_cv(T=1000, seed=13)
    x0 = np.array([1.0, 0.1])
    X, xT = tk.make_kalman_lti(K, F, chunk=64)(torch.from_numpy(x0),
                                               torch.from_numpy(Z))
    Xj, _ = jk.make_kalman_lti(K, F, chunk=64)(jnp.asarray(x0),
                                               jnp.asarray(Z))
    scale = np.abs(np.asarray(Xj)).max()
    _close(X, Xj, 1e-9, 1e-9 * scale)
    Xs, _ = tk.kalman_lti_apply(torch.from_numpy(x0), torch.from_numpy(Z), K,
                                F, method="scan")
    _close(X, Xs, 1e-9, 1e-9 * scale)
    _close(xT, X[-1], 0)


def test_make_kalman_lti_defective_f_takes_parallel_route():
    """A defective F takes the parallel route with K and F rounded to
    float32, as in JAX: the literal float64 recurrence of the rounded model
    within 1e-9; JAX's within 1e-5 relative (JAX composes the float32 F's
    powers in float32, the port in the working float64)."""
    F = np.array([[1.0, 1.0], [0.0, 1.0]]) * 0.9       # a Jordan block
    K = np.array([[0.3], [0.1]])
    Z = np.random.default_rng(14).standard_normal((200, 1))
    x0 = np.zeros(2)
    X, _ = tk.make_kalman_lti(K, F)(torch.from_numpy(x0), torch.from_numpy(Z))
    F32, K32 = (a.astype(np.float32).astype(np.float64) for a in (F, K))
    x, ref = x0, []
    for z in Z:
        x = F32 @ x + K32 @ z
        ref.append(x)
    _close(X, np.array(ref), 1e-9, 1e-9)
    Xj, _ = jk.make_kalman_lti(K, F)(jnp.asarray(x0), jnp.asarray(Z))
    _close(X, Xj, 1e-5, 1e-5 * np.abs(np.asarray(Xj)).max())


def test_f3_one_state_three_measurements_is_the_literal_recurrence():
    """F3: a one-state tracker with m = 3 measurements.  The port orients
    K (1, 3) by F (1, 1) and keeps it; the JAX package transposes it to
    (3, 1) and its modal input map is wrong."""
    rng = np.random.default_rng(15)
    F = np.array([[0.97]])
    K = np.array([[0.2, 0.05, -0.1]])
    Z = rng.standard_normal((500, 3))
    x = np.array([0.4])
    ref = []
    for z in Z:
        x = F @ x + K @ z
        ref.append(x)
    ref = np.array(ref)
    X, _ = tk.make_kalman_lti(K, F)(torch.from_numpy(np.array([0.4])),
                                    torch.from_numpy(Z))
    _close(X, ref, 1e-9, 1e-12)
    try:
        Xj = np.asarray(jk.make_kalman_lti(K, F)(jnp.asarray([0.4]),
                                                 jnp.asarray(Z))[0])
        jax_right = Xj.shape == ref.shape and np.allclose(Xj, ref, atol=1e-6)
    except (TypeError, ValueError):
        jax_right = False
    assert not jax_right
    # the gain in the other orientation is transposed to (1, 3); a gain of
    # no orientation raises
    X2, _ = tk.make_kalman_lti(K.T, F)(torch.from_numpy(np.array([0.4])),
                                       torch.from_numpy(Z))
    _close(X2, ref, 1e-9, 1e-12)
    with pytest.raises(ValueError, match="orientation"):
        tk.make_kalman_lti(np.ones((2, 3)), F)


def test_alpha_beta_tracker_matches_jax_and_carries():
    a, b = tk.alpha_beta_gains(0.1)
    Z = _sim_cv(T=400, seed=16)[:, 0]
    for method in ("parallel", "scan"):
        trk = tk.AlphaBetaTracker(a, b, dt=1.0, dtype=torch.float64,
                                  device="cpu")
        jtr = jk.AlphaBetaTracker(a, b, dt=1.0, dtype=jnp.float64)
        X1 = trk.execute_block(torch.from_numpy(Z[:123]), method=method)
        X2 = trk.execute_block(torch.from_numpy(Z[123:]), method=method)
        Xj = np.concatenate([
            np.asarray(jtr.execute_block(jnp.asarray(Z[:123]), method=method)),
            np.asarray(jtr.execute_block(jnp.asarray(Z[123:]),
                                         method=method))])
        whole = tk.AlphaBetaTracker(a, b, dtype=torch.float64, device="cpu")
        Xw = whole.execute_block(torch.from_numpy(Z), method=method)
        _close(torch.cat([X1, X2]), Xj, 1e-9, 1e-9)
        _close(torch.cat([X1, X2]), Xw, 1e-10, 1e-10)
    trk.reset()
    assert float(trk._x.abs().max()) == 0.0
    assert repr(trk) == repr(jtr)


def test_s4_routing_predicate():
    assert cuda_track.fits(1, 1) and cuda_track.fits(8, 8)
    assert not cuda_track.fits(9, 1) and not cuda_track.fits(2, 9)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_track.kalman_filter_cuda(*(torch.zeros(2, 2) for _ in range(7)))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_track.kalman_lti_cuda(torch.zeros(2), torch.zeros(4, 2),
                                   torch.zeros(2, 2))


@pytest.mark.parametrize("n,m", [(3, 3), (1, 3), (5, 2)])
def test_s4_padding_to_register_buckets_is_exact(n, m):
    """S4's wrappers pad n and m to the kernels' buckets (zero rows and
    columns, R and the backward entry's P- with 1 on the padded diagonal):
    the plain walks on the padded operands, cut back, equal the unpadded
    walks (1e-12 in float64), and the padded entries stay 0."""
    rng = np.random.default_rng(20 + n)
    A = np.eye(n) + 0.05 * rng.standard_normal((n, n))
    C = rng.standard_normal((m, n))
    Q, R = 0.01 * np.eye(n), np.diag(rng.uniform(0.2, 1.0, m))
    Z = torch.from_numpy(rng.standard_normal((60, m)))
    ops = [torch.from_numpy(a) for a in (A, C, Q, R)]
    x0, P0 = torch.zeros(n, dtype=torch.float64), 10 * torch.eye(
        n, dtype=torch.float64)
    ref = tk.kalman_walk_plain(x0, P0, Z, *ops, keep=True)
    N, M = cuda_track.bucket(n), cuda_track.bucket(m)
    pad = cuda_track._pad
    got = tk.kalman_walk_plain(pad(x0, (N,)), pad(P0, (N, N)),
                               pad(Z, (60, M)), pad(ops[0], (N, N)),
                               pad(ops[1], (M, N)), pad(ops[2], (N, N)),
                               pad(ops[3], (M, M), diag=True), keep=True)
    shapes = [(60, n), (n,), (n, n), (60, n, n), (60, n), (60, n, n)]
    for g, r, shape in zip(got, ref, shapes):
        _close(cuda_track._cut(g, shape), r, 1e-12, 1e-12)
        rest = g.clone()
        rest[tuple(slice(0, d) for d in shape)] = 0
        assert float(rest.abs().max()) == 0.0
    Xf, _, _, Pf, Xp, Pp = got
    Xs, Ps = tk.rts_backward_plain(Xf, Pf, Xp, pad(ref[5], (60, N, N),
                                                   diag=True),
                                   pad(ops[0], (N, N)))
    Xs_r, Ps_r = tk.rts_backward_plain(ref[0], *ref[3:], ops[0])
    _close(cuda_track._cut(Xs, (60, n)), Xs_r, 1e-12, 1e-12)
    _close(cuda_track._cut(Ps, (60, n, n)), Ps_r, 1e-12, 1e-12)
    assert [cuda_track.bucket(v) for v in range(1, 9)] == [1, 2, 4, 4, 8,
                                                           8, 8, 8]


def test_s5_zero_padded_stages_leave_the_lattice_as_it_is():
    """S5's wrapper pads the order to its register bucket with k = 0: the
    plain walk with the padded k is bit-equal to the unpadded one."""
    import importlib
    lpc = importlib.import_module("solid_dsp_tpu_torch.analysis.lpc")
    rng = np.random.default_rng(30)
    for p, P in ((5, 8), (13, 16), (33, 64)):
        k = torch.from_numpy(0.5 * rng.uniform(-1, 1, (2, p)))
        y = torch.from_numpy(rng.standard_normal((2, 80)))
        assert torch.equal(lpc.lattice_iir_plain(y, cuda_track._pad(k, (2, P))),
                           lpc.lattice_iir_plain(y, k))
