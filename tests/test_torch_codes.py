"""Port vs JAX package: models/ldpc.py, models/polar.py and
models/turbo.py on the CPU, and S6's arithmetic emulated.

The same seeded numpy LLRs go through both packages (LDPC 648 at a few
iterations, polar N <= 64, turbo K <= 128; the JAX decoders are compiled
once per shape in module-scoped fixtures).  Gates: the host tables
(parity-check layout, RREF, frozen sets, QPP permutations, trellis)
equal; encoders bit-equal; LDPC hard bits and syndrome flags equal (the
port's gather-and-sum routing adds the same messages in another order than
JAX's one-hot matmuls); polar u_hat, x_hat and ok equal; the turbo
decoder's a-posteriori LLRs within 1e-5 x max of JAX's vmapped decode (the
plain walk is JAX's radix-8 scan in JAX's order) and its bits equal.  S6
(``csrc/bcjr_scan.cu``) walks step by step and renormalises once a chunk
of 16 steps (the backward walk's chunks start after the tail's 3
steps): that arithmetic, emulated here in float32 numpy, agrees with the
plain version within S6's card gate, |dLLR| <= 1e-4 max(1, max|LLR|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.models import ldpc as jldpc
from solid_dsp_tpu.models import polar as jpolar
from solid_dsp_tpu.models import turbo as jturbo
from solid_dsp_tpu_torch.models import ldpc as tldpc
from solid_dsp_tpu_torch.models import polar as tpolar
from solid_dsp_tpu_torch.models import turbo as tturbo
from solid_dsp_tpu_torch.ops import cuda_bcjr

CPU = "cpu"


def _np(t):
    return t.detach().cpu().numpy()


# ------------------------------------------------------------------ LDPC

@pytest.fixture(scope="module")
def wifi():
    return tldpc.wifi_ldpc_648(CPU), jldpc.wifi_ldpc_648()


def test_ldpc_layout_equals_jax(wifi):
    t, j = wifi
    lt, lj = t._lay, j._lay
    np.testing.assert_array_equal(lt.H, lj.H)
    np.testing.assert_array_equal(lt.F, lj.F)
    np.testing.assert_array_equal(lt.pivot_cols, lj.pivot_cols)
    np.testing.assert_array_equal(lt.vmat, lj.vmat)
    np.testing.assert_array_equal(lt.mask, lj.mask)
    # the per-variable slot table lists exactly the one-hot matrix's edges
    for v in range(lt.N):
        slots = lt.vslots[v][lt.vslots[v] < lt.C * lt.d_max]
        np.testing.assert_array_equal(slots, np.nonzero(lj.A[:, v])[0])
    assert (t.n, t.k, t.rate, repr(t)) == (j.n, j.k, j.rate, repr(j))


def test_ldpc_encode_and_extract_equal_jax(wifi):
    t, j = wifi
    rng = np.random.default_rng(0)
    info = rng.integers(0, 2, (5, t.k)).astype(np.int32)
    cw_t = t.encode(info)
    cw_j = np.asarray(j.encode(info))
    assert cw_t.dtype == torch.int32
    np.testing.assert_array_equal(_np(cw_t), cw_j)
    assert not (t.H.astype(int) @ _np(cw_t).T % 2).any()
    np.testing.assert_array_equal(
        _np(tldpc.ldpc_extract_info(cw_t, t.H)), info)
    with pytest.raises(ValueError):
        t.encode(info[:, :10])


@pytest.mark.parametrize("snr_scale,n_iters,ties", [(3.0, 5, False),
                                                   (1.2, 8, False),
                                                   (2.0, 6, True)])
def test_ldpc_decode_equals_jax(wifi, snr_scale, n_iters, ties):
    """``ties``: LLRs rounded to integers, so a check's magnitudes tie
    often and the first-minimum rule (argmin here, JAX's cumsum-gated
    mask) decides which slot takes min2."""
    t, j = wifi
    rng = np.random.default_rng(int(10 * snr_scale))
    info = rng.integers(0, 2, (6, t.k))
    cw = np.asarray(j.encode(info))
    llr = ((1 - 2.0 * cw) * snr_scale
           + rng.standard_normal(cw.shape)).astype(np.float32)
    if ties:
        llr = np.round(llr)
    bits_t, ok_t = tldpc.ldpc_decode(torch.from_numpy(llr), t.H, n_iters)
    bits_j, ok_j = jldpc.ldpc_decode(jnp.asarray(llr), j.H, n_iters)
    np.testing.assert_array_equal(_np(bits_t), np.asarray(bits_j))
    np.testing.assert_array_equal(_np(ok_t), np.asarray(ok_j))
    info_t, okc = t.decode(llr, n_iters)
    np.testing.assert_array_equal(_np(info_t),
                                  np.asarray(j.decode(jnp.asarray(llr),
                                                      n_iters)[0]))
    if snr_scale > 2:
        assert bool(okc.all()) and (_np(info_t) == info).all()


def test_ldpc_custom_h_and_rank_check():
    rng = np.random.default_rng(1)
    H = (rng.random((12, 24)) < 0.3).astype(np.int8)
    H[:, 12:] |= np.eye(12, dtype=np.int8)
    ct = tldpc.LDPCCode(H, device=CPU)
    cj = jldpc.LDPCCode(H)
    info = rng.integers(0, 2, (3, ct.k))
    np.testing.assert_array_equal(_np(ct.encode(info)),
                                  np.asarray(cj.encode(info)))
    np.testing.assert_array_equal(tldpc.qc_expand([[0, None], [1, 2]], 3),
                                  jldpc.qc_expand([[0, None], [1, 2]], 3))
    with pytest.raises(ValueError, match="rank"):
        tldpc.LDPCCode(np.vstack([H, H[:1]]), device=CPU)


# ----------------------------------------------------------------- polar

@pytest.mark.parametrize("n,k", [(16, 8), (64, 32)])
def test_polar_construct_and_encode_equal_jax(n, k):
    info_set = tpolar.polar_construct(n, k, 1.5)
    np.testing.assert_array_equal(info_set,
                                  jpolar.polar_construct(n, k, 1.5))
    rng = np.random.default_rng(n)
    bits = rng.integers(0, 2, (4, k)).astype(np.int32)
    np.testing.assert_array_equal(
        _np(tpolar.polar_encode(torch.from_numpy(bits), info_set, n)),
        np.asarray(jpolar.polar_encode(bits, info_set, n)))
    with pytest.raises(ValueError):
        tpolar.polar_construct(24, 8)


@pytest.mark.parametrize("n,k,n_iters", [(16, 8, 6), (64, 32, 8)])
def test_polar_decode_bp_equals_jax(n, k, n_iters):
    tc = tpolar.PolarCode(n, k, n_iters=n_iters, device=CPU)
    jc = jpolar.PolarCode(n, k, n_iters=n_iters)
    rng = np.random.default_rng(k)
    bits = rng.integers(0, 2, (8, k))
    x = np.asarray(jc.encode(bits))
    llr = ((1 - 2.0 * x) * 2.0 + rng.standard_normal(x.shape)).astype(
        np.float32)
    out_t = tpolar.polar_decode_bp(torch.from_numpy(llr), tc.frozen_mask,
                                   n_iters)
    out_j = jpolar.polar_decode_bp(jnp.asarray(llr), jc.frozen_mask, n_iters)
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    info_t, ok_t = tc.decode(llr)
    info_j, ok_j = jc.decode(jnp.asarray(llr))
    np.testing.assert_array_equal(_np(info_t), np.asarray(info_j))
    np.testing.assert_array_equal(_np(ok_t), np.asarray(ok_j))
    assert repr(tc) == repr(jc)


# ----------------------------------------------------------------- turbo

@pytest.mark.parametrize("K", [40, 48, 64, 104, 128])
def test_qpp_and_trellis_equal_jax(K):
    np.testing.assert_array_equal(tturbo.qpp_permutation(K),
                                  jturbo.qpp_permutation(K))
    for a, b in zip(tturbo._rsc_tables(0o15, 0o13, 3),
                    jturbo._rsc_tables(0o15, 0o13, 3)):
        np.testing.assert_array_equal(a, b)


def test_qpp_rejects_non_bijection():
    with pytest.raises(ValueError):
        tturbo.qpp_permutation(40, 2, 10)


@pytest.mark.parametrize("K", [40, 64])
def test_turbo_encode_is_batched_jax_encode(K):
    perm = tturbo.qpp_permutation(K)
    rng = np.random.default_rng(K)
    bits = rng.integers(0, 2, (3, K)).astype(np.int32)
    got = tturbo.turbo_encode(torch.from_numpy(bits), perm)
    want = np.stack([np.asarray(jturbo.turbo_encode(b, perm)) for b in bits])
    assert got.dtype == torch.int32 and got.shape == (3, 3 * K + 12)
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(
        _np(tturbo.turbo_encode(torch.from_numpy(bits[0]), perm)), want[0])


@pytest.fixture(scope="module")
def turbo_case():
    """B = 4 codewords of K = 64 at Eb/N0 ~ 1 dB, three iterations:
    the port's batched decode and JAX's vmapped one."""
    K, n_iter = 64, 3
    perm = jturbo.qpp_permutation(K)
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (4, K))
    cw = np.stack([np.asarray(jturbo.turbo_encode(b, perm)) for b in bits])
    llr = ((1 - 2.0 * cw) * 1.5 + rng.standard_normal(cw.shape)).astype(
        np.float32)
    bj, lj = jax.vmap(lambda l: jturbo.turbo_decode(l, perm, n_iter))(
        jnp.asarray(llr))
    return K, n_iter, perm, bits, llr, np.asarray(bj), np.asarray(lj)


def test_turbo_decode_batched_equals_vmapped_jax(turbo_case):
    K, n_iter, perm, bits, llr, bj, lj = turbo_case
    bt, lt = tturbo.turbo_decode(torch.from_numpy(llr), perm, n_iter)
    assert bt.shape == (4, K) and lt.dtype == torch.float32
    np.testing.assert_allclose(_np(lt), lj, rtol=0,
                               atol=1e-5 * np.abs(lj).max())
    np.testing.assert_array_equal(_np(bt), bj)
    assert (_np(bt) == bits).mean() > 0.95
    # one codeword without a batch axis, and the class
    b1, l1 = tturbo.turbo_decode(torch.from_numpy(llr[1]), perm, n_iter)
    assert b1.shape == (K,)
    np.testing.assert_allclose(_np(l1), lj[1], rtol=0,
                               atol=1e-5 * np.abs(lj).max())
    tc = tturbo.TurboCode(K, n_iter=n_iter, device=CPU)
    jc = jturbo.TurboCode(K, n_iter=n_iter)
    np.testing.assert_array_equal(_np(tc.decode(llr)[0]), bj)
    np.testing.assert_array_equal(_np(tc.encode(bits[0])),
                                  np.asarray(jc.encode(bits[0])))
    assert repr(tc) == repr(jc) and tc.rate == jc.rate
    with pytest.raises(ValueError):
        tturbo.turbo_decode(torch.from_numpy(llr[:, :-1]), perm, 1)


def test_turbo_noiseless_roundtrip_odd_sizes():
    """K = 48 (the QPP search) and 104: every bit back after one
    iteration from clean LLRs; T + m not a multiple of the radix."""
    for K in (48, 104):
        tc = tturbo.TurboCode(K, n_iter=1, device=CPU)
        bits = np.random.default_rng(K).integers(0, 2, (2, K))
        llr = (1 - 2.0 * _np(tc.encode(bits))) * 4.0
        np.testing.assert_array_equal(_np(tc.decode(llr)[0]), bits)


def _s6_emulated(ls, lp, T, chunk=16):
    """csrc/bcjr_scan.cu's arithmetic in float32 numpy: the forward walk
    storing alpha before each step, renormalised by the max after every
    chunk of ``chunk`` steps; the backward walk's m tail steps, then its T
    information steps with the LLRs, renormalised after every chunk of
    them."""
    f = np.float32
    ns, p, prev, prev_u, _ = tturbo._rsc_tables(0o15, 0o13, 3)
    prev_p = p[prev, prev_u]
    su, sq, sp = (1 - 2 * prev_u).astype(f), (1 - 2 * prev_p).astype(f), (
        1 - 2 * p).astype(f)
    B, Tm = ls.shape
    alpha = np.full((B, 8), -1e9, f)
    alpha[:, 0] = 0
    A = np.zeros((B, Tm, 8), f)
    for t in range(Tm):
        A[:, t] = alpha
        g = f(0.5) * (su * ls[:, t, None, None] + sq * lp[:, t, None, None])
        alpha = np.maximum(g[..., 0] + alpha[:, prev[:, 0]],
                           g[..., 1] + alpha[:, prev[:, 1]])
        if (t + 1) % chunk == 0 or t == Tm - 1:
            alpha = alpha - alpha.max(1, keepdims=True)
    beta = np.full((B, 8), -1e9, f)
    beta[:, 0] = 0
    out = np.zeros((B, T), f)
    for k in range(Tm):
        t = Tm - 1 - k
        b0, b1 = beta[:, ns[:, 0]], beta[:, ns[:, 1]]
        g0 = f(0.5) * (ls[:, t, None] + sp[:, 0] * lp[:, t, None])
        g1 = f(0.5) * (sp[:, 1] * lp[:, t, None] - ls[:, t, None])
        if t < T:
            out[:, t] = (((A[:, t] + g0) + b0).max(1)
                         - ((A[:, t] + g1) + b1).max(1))
        beta = np.maximum(g0 + b0, g1 + b1)
        j = k - (Tm - T)                  # the information steps' count
        if j >= 0 and ((j + 1) % chunk == 0 or j == T - 1):
            beta = beta - beta.max(1, keepdims=True)
    return out


@pytest.mark.parametrize("T,scale", [(40, 2.0), (61, 6.0), (128, 20.0)])
def test_s6_arithmetic_emulated_matches_plain(T, scale):
    """The kernel's step-by-step order against the plain radix-8 walk: the
    card gate |dLLR| <= 1e-4 max(1, max|LLR|), hard bits equal where |LLR|
    is above it; T + 3 steps, odd T included."""
    rng = np.random.default_rng(T)
    ls = (scale * rng.standard_normal((5, T + 3))).astype(np.float32)
    lp = (scale * rng.standard_normal((5, T + 3))).astype(np.float32)
    want = _np(tturbo.bcjr_maxlog_plain(torch.from_numpy(ls),
                                        torch.from_numpy(lp), T))
    got = _s6_emulated(ls, lp, T)
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= tol
    sure = np.abs(want) > tol
    np.testing.assert_array_equal((got < 0)[sure], (want < 0)[sure])


def test_s6_wrapper_refuses_cpu_tensors_and_other_trellises():
    ls = torch.zeros((2, 43))
    ns, p, prev, prev_u, _ = tturbo._rsc_tables(0o15, 0o13, 3)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_bcjr.bcjr_maxlog_cuda(ls, ls, 40, ns, p, prev, prev_u)
    with pytest.raises(ValueError, match="CUDA"):
        tturbo.bcjr_maxlog(ls, ls, 40, engine="cuda")
    tabs = cuda_bcjr._tables(*(np.asarray(a, np.int64).tobytes()
                               for a in (ns, p, prev, prev_u)))
    flat = np.array(list(tabs)).reshape(5, 8, 2)
    # the kernel's tables: the trellis of _rsc_tables (JAX's), and the
    # parity of each incoming transition prev[n, c] -> n
    for got, want in zip(flat, (ns, p, prev, prev_u)):
        np.testing.assert_array_equal(got, want)
    for n in range(8):
        for c in range(2):
            assert ns[prev[n, c], prev_u[n, c]] == n
            assert flat[4, n, c] == p[prev[n, c], prev_u[n, c]]
