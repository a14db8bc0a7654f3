"""S4's chunk-and-join association (csrc/track_chunks.cu) in torch ops
against the JAX package, on the CPU.

``lti_chunked_torch`` and ``rts_backward_chunked_torch`` are the LTI and
backward kernels' plain versions: chunks walked from a zero state in the
kernels' order of operations, joined in float64, each chunk walked again
from its start rounded once (tests/test_torch_cuda.py holds the kernels
against them on the card).  Here the same seeded numpy inputs go through
them and through JAX's ``kalman_lti_apply`` ("scan" and "parallel") and
``rts_smooth``.  Gates: the LTI in float64 within 1e-9 of JAX's
(tests/test_torch_kalman.py's gate for both routes), in float32 within
1e-4 x max of the float64 walk, and two blocks with the state carried
equal one block to 1e-12; the backward pass in float64 within rtol 1e-8
of JAX's (atol 1e-10 on the states, 1e-12 on the covariances, as
test_rts_smooth_matches_jax), its last step the filter's exactly, float32
within 1e-4 x max of float64; ``linrec.join_tables`` of a near-defective F
against float64 matrix powers within 1e-12 x the largest power's norm.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.ops import kalman as jk
from solid_dsp_tpu_torch.ops import cuda_track, linrec
from solid_dsp_tpu_torch.ops import kalman as tk

LC = 16                      # chunk length of these tests
# T: one step, a chunk less one, one chunk, a chunk and one, several groups
# of 128 chunks and a ragged end
LTI_T = [1, LC - 1, LC, LC + 1, 2 * 128 * LC + 37]


def _close(got, ref, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol)


def _lti_model(n, seed):
    rng = np.random.default_rng(seed)
    if n == 2:
        A, C, Q, R = tk.cv_model(1.0, 0.05, 1.0)
        K, F = tk.steady_state_gain(A, C, Q, R)
    else:
        F = 0.9 * np.eye(n) + 0.05 * rng.standard_normal((n, n))
        K = rng.standard_normal((n, 1))
    return K, F, rng


def _inputs(K, Z, dtype):
    """B = Z K' as kalman_lti_apply forms it."""
    Zt = torch.from_numpy(Z).to(dtype)
    return Zt @ torch.from_numpy(K.T).to(dtype)


@pytest.mark.parametrize("method", ["scan", "parallel"])
@pytest.mark.parametrize("T", LTI_T)
@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_lti_chunked_matches_jax(n, T, method):
    K, F, rng = _lti_model(n, 40 + n)
    Z = rng.standard_normal((T, 1))
    x0 = rng.standard_normal(n)
    X, xT = tk.lti_chunked_torch(torch.from_numpy(x0),
                                 _inputs(K, Z, torch.float64),
                                 torch.from_numpy(F), chunk=LC)
    Xj, xj = jk.kalman_lti_apply(jnp.asarray(x0), jnp.asarray(Z),
                                 jnp.asarray(K), jnp.asarray(F),
                                 method=method)
    assert X.shape == (T, n) and X.dtype == torch.float64
    _close(X, Xj, 1e-9, 1e-9)
    _close(xT, xj, 1e-9, 1e-9)


@pytest.mark.parametrize("T", LTI_T)
@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_lti_chunked_float32_within_1e4_of_float64(n, T):
    K, F, rng = _lti_model(n, 50 + n)
    Z = rng.standard_normal((T, 1))
    x0 = rng.standard_normal(n)
    X32, x32 = tk.lti_chunked_torch(
        torch.from_numpy(x0).float(), _inputs(K, Z, torch.float32),
        torch.from_numpy(F).float(), chunk=LC)
    X64, x64 = tk.lti_walk_plain(torch.from_numpy(x0),
                                 _inputs(K, Z, torch.float64),
                                 torch.from_numpy(F))
    scale = float(X64.abs().max())
    assert X32.dtype == torch.float32
    _close(X32.double(), X64, 0, 1e-4 * scale)
    _close(x32.double(), x64, 0, 1e-4 * scale)


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_lti_chunked_state_carried_across_blocks(n):
    """Two blocks with x_T carried equal one block, and lanes equal their
    own walks."""
    K, F, rng = _lti_model(n, 60 + n)
    T = 3 * 128 * LC + 11
    B = _inputs(K, rng.standard_normal((T, 1)), torch.float64)
    x0 = torch.from_numpy(rng.standard_normal(n))
    Ft = torch.from_numpy(F)
    X, xT = tk.lti_chunked_torch(x0, B, Ft, chunk=LC)
    h = 5 * LC + 3
    Xa, xa = tk.lti_chunked_torch(x0, B[:h], Ft, chunk=LC)
    Xb, xb = tk.lti_chunked_torch(xa, B[h:], Ft, chunk=LC)
    _close(torch.cat([Xa, Xb]), X, 1e-12, 1e-12)
    _close(xb, xT, 1e-12, 1e-12)
    lanes = torch.stack([B, 0.5 * B, -B])
    x0s = torch.stack([x0, 2 * x0, x0])
    XL, xL = tk.lti_chunked_torch(x0s, lanes, Ft, chunk=LC)
    for i in range(3):
        Xi, xi = tk.lti_chunked_torch(x0s[i], lanes[i], Ft, chunk=LC)
        _close(XL[i], Xi, 1e-12, 1e-12)
        _close(xL[i], xi, 1e-12, 1e-12)


def test_lti_chunked_takes_the_kernels_chunk_rule():
    """Without a chunk the plain version takes cuda_track.lti_chunk of F,
    as the kernel's wrapper does: linrec.chunk_rows, 64 rows or 16 in
    float32 for a large transient gain (a near-defective F), where a
    float32 chunk's own walk amplifies its rounding; at least the kernel's
    sub-batch of 32 / N rows."""
    F = np.array([[0.97, 10.0], [0.0, 0.97]])
    assert cuda_track.lti_chunk(F, torch.float32) == linrec.S3_SHORT_CHUNK
    assert cuda_track.lti_chunk(F, torch.float64) == linrec.S3_CHUNK
    assert cuda_track.lti_chunk(np.array([[1.1]]), torch.float32) == 32
    rng = np.random.default_rng(70)
    B = torch.from_numpy(rng.standard_normal((1000, 2)))
    x0 = torch.zeros(2, dtype=torch.float64)
    for dt in (torch.float32, torch.float64):
        got, _ = tk.lti_chunked_torch(x0.to(dt), B.to(dt),
                                      torch.from_numpy(F).to(dt))
        want, _ = tk.lti_chunked_torch(x0.to(dt), B.to(dt),
                                       torch.from_numpy(F).to(dt),
                                       chunk=cuda_track.lti_chunk(F, dt))
        assert torch.equal(got, want)


def _rts_case(model, T, seed):
    if model == "cv":
        A, C, Q, R = tk.cv_model(1.0, 0.05, 1.0)
        rng = np.random.default_rng(seed)
        vel = 0.7 + np.cumsum(0.05 * rng.standard_normal(T))
        Z = (np.cumsum(vel) + rng.standard_normal(T))[:, None]
    else:
        rng = np.random.default_rng(seed)
        A = np.eye(4) + 0.05 * rng.standard_normal((4, 4))
        C = rng.standard_normal((2, 4))
        Q = 0.01 * np.eye(4)
        R = np.diag([0.5, 0.3])
        Z = rng.standard_normal((T, 2))
    return A, C, Q, R, Z


def _filtered(A, C, Q, R, Z, dtype=torch.float64):
    n = A.shape[0]
    ops = [torch.from_numpy(np.atleast_2d(a)).to(dtype) for a in (A, C, Q, R)]
    out = tk.kalman_walk_plain(torch.zeros(n, dtype=dtype),
                               10.0 * torch.eye(n, dtype=dtype),
                               torch.from_numpy(Z).to(dtype), *ops,
                               keep=True)
    return out, ops[0]


# T: one step, two, a chunk and one (two chunks), several groups of 128
# chunks and a ragged end
RTS_T = [1, 2, LC + 1, 2 * 128 * LC + 21]


@pytest.mark.parametrize("T", RTS_T)
@pytest.mark.parametrize("model", ["cv", "four_state"])
def test_rts_backward_chunked_matches_jax(model, T):
    A, C, Q, R, Z = _rts_case(model, T, 7 + T)
    n = A.shape[0]
    (Xf, xT, PT, Pf, Xp, Pp), At = _filtered(A, C, Q, R, Z)
    Xs, Ps = tk.rts_backward_chunked_torch(Xf, Pf, Xp, Pp, At, chunk=LC)
    x0, P0 = np.zeros(n), 10.0 * np.eye(n)
    Xj, Pj = jk.rts_smooth(jk.kalman_init(jnp.asarray(x0), jnp.asarray(P0)),
                           jnp.asarray(Z), A, C, Q, R)
    assert Xs.shape == (T, n) and Ps.shape == (T, n, n)
    _close(Xs, Xj, 1e-8, 1e-10)
    _close(Ps, Pj, 1e-8, 1e-12)
    # the last step is the filter's, bit for bit
    assert torch.equal(Xs[-1], xT) and torch.equal(Ps[-1], PT)


@pytest.mark.parametrize("model", ["cv", "four_state"])
def test_rts_backward_chunked_float32_and_lanes(model):
    """float32 within 1e-4 x max of the float64 pass; lanes (a leading
    axis) equal their own passes."""
    T = 3 * 128 * LC + 5
    A, C, Q, R, Z = _rts_case(model, T, 80)
    out64, A64 = _filtered(A, C, Q, R, Z)
    out32, A32 = _filtered(A, C, Q, R, Z, torch.float32)
    X64, P64 = tk.rts_backward_plain(out64[0], *out64[3:], A64)
    X32, P32 = tk.rts_backward_chunked_torch(out32[0], *out32[3:], A32,
                                             chunk=LC)
    assert X32.dtype == torch.float32
    _close(X32.double(), X64, 0, 1e-4 * float(X64.abs().max()))
    _close(P32.double(), P64, 0, 1e-4 * float(P64.abs().max()))
    Xf, _, _, Pf, Xp, Pp = out64
    lanes = [torch.stack([v, v.flip(0)]) for v in (Xf, Pf, Xp, Pp)]
    XL, PL = tk.rts_backward_chunked_torch(*lanes, A64, chunk=LC)
    for i in range(2):
        Xi, Pi = tk.rts_backward_chunked_torch(*(v[i] for v in lanes), A64,
                                               chunk=LC)
        _close(XL[i], Xi, 1e-12, 1e-12)
        _close(PL[i], Pi, 1e-12, 1e-14)


@pytest.mark.parametrize("chunk", [1, 4, cuda_track.RTS_CHUNK, 256])
def test_rts_backward_chunked_at_every_chunk_length_is_the_walk(chunk):
    """Any chunk length gives the sequential walk to float64 rounding; one
    chunk covering every step is the walk in the kernels' order."""
    A, C, Q, R, Z = _rts_case("cv", 300, 90)
    (Xf, _, _, Pf, Xp, Pp), At = _filtered(A, C, Q, R, Z)
    Xw, Pw = tk.rts_backward_plain(Xf, Pf, Xp, Pp, At)
    Xs, Ps = tk.rts_backward_chunked_torch(Xf, Pf, Xp, Pp, At, chunk=chunk)
    _close(Xs, Xw, 1e-10, 1e-10)
    _close(Ps, Pw, 1e-10, 1e-12)


def test_join_tables_of_a_near_defective_f_are_its_powers():
    """linrec.join_tables(F, chunk, cb, D) for a near-defective F (a double
    pole at 0.97, split by 1e-7, coupled by 10): Phi^j = F^(chunk j) for j = 1 .. cb, then
    Phi^(cb 2^d), against float64 matrix powers; F's transient gain (its
    powers grow before they decay) takes the short chunk in float32."""
    F = np.array([[0.97, 10.0], [0.0, 0.97 + 1e-7]])
    assert linrec.transient_gain(F) > linrec.S3_GAIN_LIMIT
    chunk, cb, D = 16, 8, 4
    tabs = linrec.join_tables(F, chunk, cb, D)
    want = ([np.linalg.matrix_power(F, chunk * j) for j in range(1, cb + 1)]
            + [np.linalg.matrix_power(F, chunk * cb * 2 ** d)
               for d in range(D)])
    assert tabs.shape == (cb + D, 2, 2) and tabs.dtype == np.float64
    scale = max(np.abs(w).max() for w in want)
    _close(tabs, np.stack(want), 0, 1e-12 * scale)


def test_chunk_geometry_covers_every_chunk():
    """The kernels' launch shapes: every chunk in a group, the groups'
    starts in pass 2's runs, the join tables pass 2 reads."""
    for T in (1, 15, 16, 17, 128 * 64, 128 * 64 + 1, 1 << 22, (1 << 24) + 7):
        for chunk in (16, 64):
            nc, ng, tl, rl, D = cuda_track.lti_geometry(T, chunk)
            assert nc * chunk >= T > (nc - 1) * chunk
            assert ng * cuda_track.LTI_THREADS >= nc
            assert (1 << tl) <= 256 and (1 << (tl + rl)) >= max(ng - 1, 1)
            assert D == tl + rl + 1
    for T in (1, 2, 33, 1 << 20):
        for N in (1, 2, 4, 8):
            nc, ng, tl, rl = cuda_track.rts_geometry(T, N, 32)
            cb = 128 if N <= 4 else 32
            assert nc >= 1 and nc * 32 >= T - 1
            assert ng * cb >= nc and (1 << (tl + rl)) >= max(ng - 1, 1)


# S4's forward entry (csrc/track_forward.cu): kalman_forward_chunked_torch,
# its association (filtering elements of full chunks joined in float64,
# each chunk walked again from its start rounded once), against JAX's
# kalman_apply and rts_smooth.  Gates: float64 within 1e-9 x max of each
# output of JAX's; float32 within 1e-4 x max of the float64 walk; lanes and
# two blocks with the state carried equal their own runs to 1e-12 x max.

def _fwd_model(name):
    """(A, C, Q, R, x0, P0) of a forward case: the constant-velocity model,
    random models of n states and m measurements, a singular A (a zero
    row), an unobserved random walk (P grows without bound) and P0 far from
    steady state."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "cv":
        A, C, Q, R = tk.cv_model(1.0, 0.05, 1.0)
        return A, C, Q, R, np.zeros(2), 10.0 * np.eye(2)
    if name == "walk":
        A = np.eye(2)
        C = np.array([[1.0, 0.0]])
        return A, C, 0.1 * np.eye(2), np.array([[0.5]]), np.zeros(2), np.eye(2)
    n, m = {"n1m1": (1, 1), "n3m2": (3, 2), "n8m3": (8, 3), "singular": (3, 3),
            "p0_large": (2, 2), "p0_small": (2, 1)}[name]
    A = 0.95 * np.eye(n) + 0.05 * rng.standard_normal((n, n))
    if name == "singular":
        A[1] = 0.0
    C = rng.standard_normal((m, n))
    Q = 0.01 * np.eye(n)
    R = np.diag(rng.uniform(0.2, 1.0, m))
    P0 = {"p0_large": 10.0, "p0_small": 1e-6}.get(name, 1.0) * np.eye(n)
    return A, C, Q, R, rng.standard_normal(n), P0


FWD_MODELS = ["cv", "n1m1", "n3m2", "n8m3", "singular", "walk", "p0_large",
              "p0_small"]
FWD_T = 301                       # a multiple of no chunk below but 1


def _fwd_inputs(name, T, dtype=torch.float64, seed=0):
    A, C, Q, R, x0, P0 = _fwd_model(name)
    Z = np.random.default_rng(seed + T).standard_normal((T, C.shape[0]))
    ops = [torch.from_numpy(a).to(dtype) for a in (A, C, Q, R)]
    return (A, C, Q, R, x0, P0, Z, ops,
            torch.from_numpy(x0).to(dtype), torch.from_numpy(P0).to(dtype))


def _rel_close(got, ref, rtol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


@pytest.mark.parametrize("chunk", [1, 3, 16, 64, 512])
@pytest.mark.parametrize("model", FWD_MODELS)
def test_forward_chunked_matches_jax(model, chunk):
    """kalman_forward_chunked_torch in float64 against JAX's kalman_apply
    (X and the carried state) and rts_smooth's forward pass (the kept
    covariances and predictions, against kalman_walk_plain, which the
    JAX parity tests hold), at chunks of 1, 3, 16, 64 steps and one chunk
    longer than T."""
    A, C, Q, R, x0, P0, Z, ops, xt, Pt = _fwd_inputs(model, FWD_T)
    X, xT, PT, Pf, Xp, Pp = tk.kalman_forward_chunked_torch(
        xt, Pt, torch.from_numpy(Z), *ops, keep=True, chunk=chunk)
    Xj, (xj, Pj) = jk.kalman_apply(jk.kalman_init(jnp.asarray(x0),
                                                  jnp.asarray(P0)),
                                   jnp.asarray(Z), A, C, Q, R)
    for got, ref in ((X, Xj), (xT, xj), (PT, Pj)):
        _rel_close(got, ref, 1e-9)
    want = tk.kalman_walk_plain(xt, Pt, torch.from_numpy(Z), *ops, keep=True)
    for got, ref in zip((Pf, Xp, Pp), want[3:]):
        _rel_close(got, ref, 1e-9)


@pytest.mark.parametrize("T", [1, 15, 16, 17, 2 * 128 * 16 + 5])
@pytest.mark.parametrize("model", ["cv", "n3m2", "walk"])
def test_forward_chunked_at_any_t_matches_jax(model, T):
    """T of one step, a chunk less one, one chunk, a chunk and one, and
    several groups of 128 chunks of 16 with a ragged end."""
    A, C, Q, R, x0, P0, Z, ops, xt, Pt = _fwd_inputs(model, T)
    X, xT, PT = tk.kalman_forward_chunked_torch(xt, Pt, torch.from_numpy(Z),
                                                *ops, chunk=16)
    Xj, (xj, Pj) = jk.kalman_apply(jk.kalman_init(jnp.asarray(x0),
                                                  jnp.asarray(P0)),
                                   jnp.asarray(Z), A, C, Q, R)
    assert X.shape == (T, A.shape[0])
    for got, ref in ((X, Xj), (xT, xj), (PT, Pj)):
        _rel_close(got, ref, 1e-9)


@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("model", FWD_MODELS)
def test_forward_chunked_float32_within_1e4_of_float64(model, chunk):
    A, C, Q, R, x0, P0, Z, ops, xt, Pt = _fwd_inputs(model, 2 * 128 * 16 + 5)
    ops32 = [o.float() for o in ops]
    got = tk.kalman_forward_chunked_torch(
        xt.float(), Pt.float(), torch.from_numpy(Z).float(), *ops32,
        keep=True, chunk=chunk)
    want = tk.kalman_walk_plain(xt, Pt, torch.from_numpy(Z), *ops, keep=True)
    assert got[0].dtype == torch.float32
    for g, w in zip(got, want):
        _rel_close(g.double(), w, 1e-4)


@pytest.mark.parametrize("model", ["cv", "n3m2", "n8m3", "walk"])
def test_forward_chunked_lanes_and_carried_state(model):
    """Two lanes (their own measurements and carried states) equal their
    own runs, and two blocks with (x_T, P_T) carried equal one block."""
    A, C, Q, R, x0, P0, Z, ops, xt, Pt = _fwd_inputs(model, 700)
    Zt = torch.from_numpy(Z)
    lanes = torch.stack([Zt, -0.5 * Zt])
    x0s = torch.stack([xt, 2 * xt + 1])
    P0s = torch.stack([Pt, 3 * Pt])
    got = tk.kalman_forward_chunked_torch(x0s, P0s, lanes, *ops, keep=True,
                                          chunk=16)
    for i in range(2):
        own = tk.kalman_forward_chunked_torch(x0s[i], P0s[i], lanes[i], *ops,
                                              keep=True, chunk=16)
        for g, w in zip(got, own):
            _rel_close(g[i], w, 1e-12)
    X, xT, PT = tk.kalman_forward_chunked_torch(xt, Pt, Zt, *ops, chunk=16)
    h = 16 * 5 + 3
    Xa, xa, Pa = tk.kalman_forward_chunked_torch(xt, Pt, Zt[:h], *ops,
                                                 chunk=16)
    Xb, xb, Pb = tk.kalman_forward_chunked_torch(xa, Pa, Zt[h:], *ops,
                                                 chunk=16)
    _rel_close(torch.cat([Xa, Xb]), X, 1e-12)
    _rel_close(xb, xT, 1e-12)
    _rel_close(Pb, PT, 1e-12)


@pytest.mark.parametrize("model", ["cv", "n3m2", "singular", "walk"])
def test_forward_then_backward_chunked_matches_jax_rts(model):
    """rts_backward_chunked_torch on kalman_forward_chunked_torch's kept
    outputs equals JAX's rts_smooth (float64, rtol 1e-8 with atol 1e-10
    on the states and 1e-12 on the covariances, as
    test_rts_backward_chunked_matches_jax)."""
    A, C, Q, R, x0, P0, Z, ops, xt, Pt = _fwd_inputs(model, 2 * 128 * 16 + 5)
    X, _, _, Pf, Xp, Pp = tk.kalman_forward_chunked_torch(
        xt, Pt, torch.from_numpy(Z), *ops, keep=True)
    Xs, Ps = tk.rts_backward_chunked_torch(X, Pf, Xp, Pp, ops[0], chunk=LC)
    Xj, Pj = jk.rts_smooth(jk.kalman_init(jnp.asarray(x0), jnp.asarray(P0)),
                           jnp.asarray(Z), A, C, Q, R)
    scale_x = float(np.abs(np.asarray(Xj)).max())
    scale_p = float(np.abs(np.asarray(Pj)).max())
    _close(Xs, Xj, 1e-8, 1e-10 * max(1.0, scale_x))
    _close(Ps, Pj, 1e-8, 1e-12 * max(1.0, scale_p))


def test_forward_tables_are_the_composed_steps():
    """cuda_track.forward_tables' chunk element applied to a state equals
    the filter walked over that chunk (float64), for the measurements as
    the coefficients Wb, We weigh them."""
    A, C, Q, R, x0, P0, Z, ops, xt, Pt = _fwd_inputs("n3m2", 24)
    Ac, Cc, Jc, Wb, We = cuda_track.forward_tables(A, C, Q, R, 24)
    assert Wb.shape == We.shape == (24, 3, 2)
    el = tuple(torch.from_numpy(a) for a in (
        Ac, np.einsum("inj,ij->n", Wb, Z), Cc, np.einsum("inj,ij->n", We, Z),
        Jc))
    x, P = tk._element_apply(el, xt, Pt)
    _, xw, Pw = tk.kalman_walk_plain(xt, Pt, torch.from_numpy(Z), *ops)
    _rel_close(x, xw, 1e-12)
    _rel_close(P, Pw, 1e-12)


def test_forward_geometry_covers_every_chunk():
    """The forward kernel's launch shapes: every chunk in a group, the
    groups' starts in pass 2's runs; the sub-batch the wrapper's chunk
    must be a multiple of."""
    for T in (1, 15, 16, 17, 128 * 32, 128 * 32 + 1, 1 << 20, (1 << 24) + 7):
        for N in (1, 2, 4, 8):
            for chunk in (16, 32, 64):
                nc, ng, tl, rl = cuda_track.fwd_geometry(T, N, chunk)
                cb = 128 if N <= 4 else 32
                join = 256 if N <= 2 else 64 if N == 4 else 16
                assert nc * chunk >= T > (nc - 1) * chunk
                assert ng * cb >= nc > (ng - 1) * cb
                assert (1 << tl) <= join and (1 << (tl + rl)) >= max(ng - 1, 1)
    assert cuda_track.fwd_sub(torch.float32, 2, 1, False) == 16
    assert cuda_track.fwd_sub(torch.float32, 2, 1, True) == 4
    assert cuda_track.fwd_sub(torch.float64, 8, 8, True) == 1
    for dt in (torch.float32, torch.float64):
        for N in (1, 2, 4, 8):
            for M in (1, 2, 4, 8):
                assert (cuda_track.fwd_sub(dt, N, M, False)
                        >= cuda_track.fwd_sub(dt, N, M, True))
                assert cuda_track.FWD_CHUNK % cuda_track.fwd_sub(
                    dt, N, M, False) == 0
