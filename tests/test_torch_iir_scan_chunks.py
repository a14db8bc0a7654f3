"""S3's chunk-and-join association on the CPU: the plain versions of the
card kernel (``csrc/iir_scan.cu``) against the sequential walk and the JAX
package.

``ops/iir.py::iir_chunked_torch`` runs the blocks of ``S3_CHUNK`` rows from
a zero state, joins their ends in float64 through powers of the companion
matrix (``ops/linrec.py::join_tables``, built in extended precision and
rounded once) and reruns each block from its start rounded to the working
type; ``sos_cascade_chunked_torch`` does the same for a biquad cascade with
K6's step.  Gates: float64 and complex128 within 1e-10 max|w| of the
sequential walk (``iir_scan_torch``) and of JAX's ``_w_recurrence_scan``;
float32 and complex64 >= 90 dB against the float64 walk of the same
float32-rounded filter at pole radius 0.99 (orders 1-3) and 0.9 (order 8,
whose companion matrix amplifies any rounding at 0.99 beyond what float32
keeps, in the sequential walk too), the risky pole >= 80 dB.  The kernel's
own schedule (groups of blocks joined by a Kogge-Stone scan, runs of groups,
the tables' indices) is emulated here in float64 against the walk, since the
kernel itself runs only on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from solid_dsp_tpu.ops import iir as jiir
from solid_dsp_tpu_torch.design import iirdes
from solid_dsp_tpu_torch.ops import cuda_scan, iir, linrec

LC = linrec.S3_CHUNK
TYPES = [torch.float32, torch.float64, torch.complex64, torch.complex128]
WIDE = {torch.float32: torch.float64, torch.float64: torch.float64,
        torch.complex64: torch.complex128, torch.complex128: torch.complex128}


def _case(dt, k, lanes, T, seed):
    """An order-k recurrence (poles at radius 0.99 for k <= 3, 0.9 above;
    real ones for a real type), its input and a random history."""
    rng = np.random.default_rng(seed)
    r = 0.99 if k <= 3 else 0.9
    if dt.is_complex:
        a = np.poly(r * np.exp(2j * np.pi * rng.random(k)))[1:]
    else:
        a = np.poly(r * np.cos(2 * np.pi * rng.random(k)))[1:]
    x = rng.standard_normal((T, *lanes))
    if dt.is_complex:
        x = x + 1j * rng.standard_normal((T, *lanes))
    h0 = rng.standard_normal((*lanes, k))
    if dt.is_complex:
        h0 = h0 + 1j * rng.standard_normal((*lanes, k))
    return (torch.from_numpy(a).to(dt), torch.from_numpy(x).to(dt),
            torch.from_numpy(h0).to(dt))


def _snr_db(got, ref) -> float:
    num = float((ref.abs() ** 2).sum())
    den = float(((got.to(ref.dtype) - ref).abs() ** 2).sum())
    return float("inf") if den == 0 else 10 * np.log10(num / den)


def _cat(*ts):
    """w and the state as one vector: the state alone (k values) is too
    few samples for a ratio of powers."""
    return torch.cat([t.reshape(-1) for t in ts])


def _check(dt, got, want_wide, walk=None):
    """The gates of the module note: got in dt against a walk in float64.
    32-bit: >= 90 dB, or, where the sequential walk in dt (``walk``) itself
    keeps less than 93 dB of the filter (a large gain), within 3 dB of it."""
    assert got.dtype == dt and got.shape == want_wide.shape
    if want_wide.numel() == 0:
        return
    if dt in (torch.float64, torch.complex128):
        scale = max(float(want_wide.abs().max()), 1e-300)
        assert float((got - want_wide).abs().max()) <= 1e-10 * scale
    else:
        gate = 90.0 if walk is None else min(90.0,
                                             _snr_db(walk, want_wide) - 3.0)
        assert _snr_db(got, want_wide) >= gate


T_CASES = [0, 1, LC - 1, LC, LC + 1, 5 * LC + 3]
SHAPES = ([((), T) for T in T_CASES + [1 << 14]]
          + [((256,), T) for T in T_CASES])


@pytest.mark.parametrize("dt", TYPES)
@pytest.mark.parametrize("k", [1, 2, 3, 8])
@pytest.mark.parametrize("lanes,T", SHAPES)
def test_chunked_matches_sequential_walk(dt, k, lanes, T):
    """iir_chunked_torch against iir_scan_torch: w and the carried state,
    the 32-bit types against the float64 walk of the rounded filter; 2^14
    rows on one lane (the walks are Python loops over time)."""
    a, x, h0 = _case(dt, k, lanes, T, seed=k + T)
    w, h = iir.iir_chunked_torch(a, h0, x)
    wide = WIDE[dt]
    ww, hw = iir.iir_scan_torch(a.to(wide), h0.to(wide), x.to(wide))
    wp, hp = iir.iir_scan_torch(a, h0, x)
    assert w.shape == x.shape and h.shape == (*lanes, k)
    _check(dt, _cat(w, h), _cat(ww, hw), _cat(wp, hp))
    lc = linrec.chunk_rows(linrec.companion(a.to(wide).numpy()), dt)
    if T <= lc:                       # one chunk: the walk itself
        assert torch.equal(w, wp) and torch.equal(h, hp)


@pytest.mark.parametrize("dt", TYPES)
@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_chunked_matches_jax_scan(dt, k):
    """iir_chunked_torch against JAX's _w_recurrence_scan (its
    iir_apply(method="scan") recurrence) on 4 lanes of 5 Lc + 3 rows, in
    float64 or complex128 for the 64-bit types, and against JAX's float64
    scan of the float32-rounded filter for the 32-bit ones (the relative
    gate against the port's own float32 walk: JAX's CPU scan rounds its
    float32 sums in another order)."""
    a, x, h0 = _case(dt, k, (4,), 5 * LC + 3, seed=40 + k)
    w, h = iir.iir_chunked_torch(a, h0, x)

    wide = WIDE[dt]
    wj, hj = jiir._w_recurrence_scan(*(jnp.asarray(v.to(wide).numpy())
                                       for v in (a, h0, x)))
    wp, hp = iir.iir_scan_torch(a, h0, x)
    _check(dt, _cat(w, h), _cat(torch.from_numpy(np.array(wj)),
                                torch.from_numpy(np.array(hj))),
           _cat(wp, hp))


@pytest.mark.parametrize("dt", TYPES)
@pytest.mark.parametrize("k", [2, 8])
def test_two_blocks_carried_equal_one(dt, k):
    """Two blocks with the state carried against one block."""
    a, x, h0 = _case(dt, k, (3,), 3000, seed=7 + k)
    w1, h1 = iir.iir_chunked_torch(a, h0, x[:1234])
    w2, h2 = iir.iir_chunked_torch(a, h1, x[1234:])
    w, h = iir.iir_chunked_torch(a, h0, x)
    _check(dt, _cat(w1, w2, h2), _cat(w, h).to(WIDE[dt]))


def test_risky_pole_float32():
    """tests/test_iir.py:210-223's pole (radius 0.9999) in float32 through
    the chunked association: >= 80 dB against the float64 walk."""
    a = np.array([1.0, -2 * 0.9999 * np.cos(0.3), 0.9999 ** 2])
    x = np.random.default_rng(3).standard_normal(1 << 14)
    at = torch.from_numpy(a[1:])
    w, _ = iir.iir_chunked_torch(at.float(), torch.zeros(2),
                                 torch.from_numpy(x).float())
    want, _ = iir.iir_scan_torch(at, torch.zeros(2, dtype=torch.float64),
                                 torch.from_numpy(x))
    assert _snr_db(w, want) >= 80.0


def test_short_chunks_for_a_large_transient_gain():
    """chunk_rows: 64 rows for the filters the port runs (the elliptic
    cascade, its sections, the risky pole, the de-emphasis) and in 64
    bits, 16 in 32 bits for a direct form whose companion matrix grows
    above 100 within 64 steps (the elliptic-8 as one recurrence; order 11,
    poles at radius 0.9 on the real axis).  There the float32 association
    keeps 5 dB more of the filter (6-14 dB measured) than the sequential
    walk and than chunks of 64, over two blocks with a random history,
    against the float64 walk of the same float32 coefficients."""
    f32 = torch.float32
    sos = iirdes.iirdes_sos("elliptic", 8, 0.05)
    coef = np.concatenate([sos[:, :3], sos[:, 4:]], axis=1)
    assert linrec.chunk_rows(linrec.cascade_matrix(coef), f32) == LC
    for a in [s[4:] for s in sos] + [
            np.array([-2 * 0.9999 * np.cos(0.3), 0.9999 ** 2]),
            np.array([-np.exp(-1 / (75e-6 * 48000))])]:
        assert linrec.chunk_rows(linrec.companion(a), f32) == LC
    _, fb = iirdes.sos_to_iir_coeffs(sos)
    A8 = linrec.companion(np.asarray(fb[1:]) / fb[0])
    assert linrec.chunk_rows(A8, f32) == linrec.S3_SHORT_CHUNK
    assert linrec.chunk_rows(A8, torch.float64) == LC
    for seed in (11, 12, 13, 14):
        rng = np.random.default_rng(seed)
        a = np.poly(0.9 * np.cos(2 * np.pi * rng.random(11)))[1:]
        x = torch.from_numpy(rng.standard_normal((700, 256)))
        h0 = torch.from_numpy(rng.standard_normal((256, 11)))
        at = torch.from_numpy(a).float().double()    # the float32 filter
        assert linrec.chunk_rows(linrec.companion(a), f32) == 16
        wt, _ = iir.iir_scan_torch(at, h0, x)
        ws, _ = iir.iir_scan_torch(at.float(), h0.float(), x.float())
        runs = {}
        for lc in (None, LC):         # the rule's 16 rows, and 64
            w1, h1 = iir.iir_chunked_torch(at.float(), h0.float(),
                                           x[:301].float(), chunk=lc)
            w2, _ = iir.iir_chunked_torch(at.float(), h1, x[301:].float(),
                                          chunk=lc)
            runs[lc] = _snr_db(torch.cat([w1, w2]), wt)
        assert runs[None] >= _snr_db(ws, wt) + 5.0
        assert runs[None] >= runs[LC] + 5.0


@pytest.mark.parametrize("k,r", [(1, 0.9), (2, 0.99), (3, 0.999), (8, 0.9)])
@pytest.mark.parametrize("cplx", [False, True])
def test_join_tables_against_float64_matrix_power(k, r, cplx):
    """join_tables: Phi^j (j = 1 .. cb) and Phi^(cb 2^d) of A^Lc against
    numpy's float64 matrix power and its extended-precision one.  The
    errors are absolute, against max(1, the power's largest entry): a
    chunk start's error is a table's error times the state, and the powers
    decay far below the products they are made of.  Within 1e-9 of the
    float64 power (its squarings lose digits on a companion matrix) and
    within 64 float64 ulps of the extended-precision one."""
    rng = np.random.default_rng(k)
    z = np.exp(2j * np.pi * rng.random(k)) if cplx else np.cos(
        2 * np.pi * rng.random(k))
    a = np.poly(r * z)[1:]
    A = linrec.companion(a)
    cb, D = 4, 5
    tabs = linrec.join_tables(A, LC, cb, D)
    assert tabs.shape == (cb + D, k, k)
    assert tabs.dtype == (np.complex128 if cplx else np.float64)
    wide = A.astype(np.clongdouble if cplx else np.longdouble)
    exps = [LC * j for j in range(1, cb + 1)] + [LC * cb * 2 ** d
                                                 for d in range(D)]
    for t, e in zip(tabs, exps):
        ref = np.linalg.matrix_power(A, e)
        assert np.abs(t - ref).max() <= 1e-9 * max(1.0, np.abs(ref).max())
        exact = np.linalg.matrix_power(wide, e)
        assert np.abs(t - exact).max() <= 64 * np.finfo(np.float64).eps * max(
            1.0, float(np.abs(exact).max()))


def test_companion_and_cascade_maps():
    """The one-step maps: the companion matrix steps the history as the
    walk does; the cascade's map steps its state as K6's step does."""
    a = np.array([0.3, -0.2, 0.1])
    h = np.array([1.0, 2.0, -1.0])
    _, hw = iir.iir_scan_torch(torch.from_numpy(a), torch.from_numpy(h),
                               torch.zeros(1, dtype=torch.float64))
    np.testing.assert_allclose(linrec.companion(a) @ h, hw.numpy(),
                               rtol=1e-15)
    sos = iirdes.iirdes_sos("elliptic", 8, 0.05)
    coef = np.concatenate([sos[:, :3], sos[:, 4:]], axis=1)
    st = np.random.default_rng(1).standard_normal(8)
    _, hs = iir._cascade_walk(torch.from_numpy(coef), torch.from_numpy(st),
                              torch.zeros(1, dtype=torch.float64))
    np.testing.assert_allclose(linrec.cascade_matrix(coef) @ st,
                               hs.numpy(), rtol=1e-13, atol=1e-15)


# ------------------------------------------- the kernel's schedule, emulated

def _emulate_kernel(a, h0, x, chunk=LC, join_threads=cuda_scan.JOIN_THREADS):
    """csrc/iir_scan.cu's three passes for S3 in float64/complex128 torch:
    the geometry and tables of chunk_geometry and join_tables, pass 1's
    Kogge-Stone over the CB chunks of a group, pass 2's runs of R groups
    and Kogge-Stone over the runs, pass 3's start Phi^j G_m + loc_{j-1}."""
    T, B = x.shape
    k = a.shape[0]
    lb, cb, nc, ng, jl, tl, rl, D = cuda_scan.chunk_geometry(
        B, T, k, 16, k > 8, chunk, join_threads)
    tabs = torch.from_numpy(linrec.join_tables(
        linrec.companion(a.numpy()), chunk, cb, D)).to(x.dtype)

    def mv(P, v):
        return torch.einsum("ij,bj->bi", P, v)

    ends = torch.zeros((ng * cb, B, k), dtype=x.dtype)
    for c in range(nc):
        _, ends[c] = iir.iir_scan_torch(a, torch.zeros(B, k, dtype=x.dtype),
                                        x[c * chunk:(c + 1) * chunk])
    loc = ends.clone()
    for m in range(ng):
        v = [ends[m * cb + j] for j in range(cb)]
        off = 1
        while off < cb:
            v = [v[j] + mv(tabs[off - 1], v[j - off]) if j >= off else v[j]
                 for j in range(cb)]
            off *= 2
        loc[m * cb:(m + 1) * cb] = torch.stack(v)
    G = {0: h0}
    if ng > 1:
        nj, TJ, R = ng - 1, 1 << tl, 1 << rl
        P1 = tabs[cb]

        def run(v, t, write):
            for m in range(t * R, min(t * R + R, nj)):
                v = mv(P1, v) + loc[m * cb + cb - 1]
                if write:
                    G[m + 1] = v
            return v
        V = [run(h0 if t == 0 else torch.zeros_like(h0), t, False)
             for t in range(TJ)]
        off, d = 1, 0
        while off < TJ:
            V = [V[t] + mv(tabs[cb + rl + d], V[t - off]) if t >= off
                 else V[t] for t in range(TJ)]
            off, d = 2 * off, d + 1
        for t in range(TJ):
            run(h0 if t == 0 else V[t - 1], t, True)
    outs = []
    for c in range(nc):
        m, j = divmod(c, cb)
        st = G[m] if j == 0 else mv(tabs[j - 1], G[m]) + loc[c - 1]
        w, h = iir.iir_scan_torch(a, st, x[c * chunk:(c + 1) * chunk])
        outs.append(w)
    return torch.cat(outs), h


@pytest.mark.parametrize("B,k,T", [(1, 2, 1), (1, 2, LC + 1),
                                   (1, 1, 130 * LC + 5), (1, 3, 300 * LC),
                                   (3, 2, 70 * LC + 9), (40, 8, 9 * LC + 1),
                                   (256, 2, 33 * LC), (3, 11, 40 * LC + 3)])
def test_kernel_schedule_emulated(B, k, T):
    """The kernel's schedule in complex128 against the sequential walk
    within 1e-10 max|w|: groups of 128 chunks on one lane (several runs of
    groups a join thread at 300 chunks), 4 on 256 lanes, single chunks at
    order 11 (the generic path)."""
    a, x, h0 = _case(torch.complex128, k, (B,), T, seed=B + k)
    w, h = _emulate_kernel(a, h0, x)
    ww, hw = iir.iir_scan_torch(a, h0, x)
    _check(torch.complex128, w, ww)
    _check(torch.complex128, h, hw)


def test_chunk_geometry():
    """One lane: groups of 128 chunks; 256 lanes: 32-lane blocks of 4
    chunks; order > 8: single-chunk groups; the join's shared memory (two
    N-vectors a thread in float64) within its limit."""
    lb, cb, nc, ng, jl, tl, rl, D = cuda_scan.chunk_geometry(
        1, 1 << 22, 2, 16, False)
    assert (lb, cb, nc, ng) == (0, 128, 65536, 512)
    assert (1 << tl) * (1 << rl) >= ng - 1 and D == rl + tl + 1
    lb, cb, nc, ng, *_ = cuda_scan.chunk_geometry(256, 1 << 16, 2, 16, False)
    assert (lb, cb, nc, ng) == (5, 4, 1024, 256)
    assert cuda_scan.chunk_geometry(3, 700, 11, 16, True)[:4] == (2, 1, 11, 11)
    for N in (1, 8, 16, 100, 2000):
        jl = cuda_scan.chunk_geometry(5, 1 << 20, N, 16, N > 8)[4]
        assert 2 * N * (1 << jl) * 16 <= 200 * 1024 or jl == 0


# ----------------------------------------------------- the fused cascade

@pytest.mark.parametrize("dt", TYPES)
@pytest.mark.parametrize("T,lanes", [(1, ()), (LC + 1, ()), (5000, ()),
                                     (700, (3,))])
def test_fused_cascade_plain_matches_sections(dt, T, lanes):
    """sos_cascade_chunked_torch on the elliptic-8 design against
    sos_cascade_apply (one iir_apply a section) in the same type, the state
    carried in: 64-bit within 1e-10 max|y|, 32-bit (float32 coefficients)
    >= 90 dB against the float64 cascade of the rounded coefficients."""
    rng = np.random.default_rng(T)
    sos = iirdes.iirdes_sos("elliptic", 8, 0.05)
    rdt = torch.empty(0, dtype=dt).real.dtype
    sb = torch.from_numpy(sos[:, :3]).to(rdt)
    sa = torch.from_numpy(sos[:, 4:]).to(rdt)
    x = rng.standard_normal((T, *lanes))
    st = 0.1 * rng.standard_normal((4, *lanes, 2))
    if dt.is_complex:
        x = x + 1j * rng.standard_normal(x.shape)
    x, st = torch.from_numpy(x).to(dt), torch.from_numpy(st).to(dt)
    y, s = iir.sos_cascade_chunked_torch(sb, sa, st, x)
    wide = WIDE[dt]
    yw, sw = iir.sos_cascade_apply(sb.double(), sa.double(), st.to(wide),
                                   x.to(wide), "scan")
    assert y.shape == x.shape and s.shape == (4, *lanes, 2)
    _check(dt, _cat(y, s), _cat(yw, sw))


def test_fused_cascade_plain_matches_jax():
    """The fused plain cascade against JAX's sos_cascade_apply (scan) on
    the elliptic-8 design, complex128, 2 Lc + 7 samples: 1e-10 max|y|."""
    rng = np.random.default_rng(11)
    sos = iirdes.iirdes_sos("elliptic", 8, 0.05)
    x = rng.standard_normal(2 * LC + 7) + 1j * rng.standard_normal(
        2 * LC + 7)
    st = np.zeros((4, 2), np.complex128)
    y, s = iir.sos_cascade_chunked_torch(
        torch.from_numpy(sos[:, :3]), torch.from_numpy(sos[:, 4:]),
        torch.from_numpy(st), torch.from_numpy(x))
    yj, sj = jiir.sos_cascade_apply(jnp.asarray(sos[:, :3]),
                                    jnp.asarray(sos[:, 4:]),
                                    jnp.asarray(st), jnp.asarray(x),
                                    method="scan")
    _check(torch.complex128, y, torch.from_numpy(np.asarray(yj)))
    _check(torch.complex128, s, torch.from_numpy(np.asarray(sj)))


def test_fused_cascade_two_blocks_equal_one():
    sos = iirdes.iirdes_sos("butterworth", 6, 0.1)
    sb, sa = torch.from_numpy(sos[:, :3]), torch.from_numpy(sos[:, 4:])
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(1000))
    s0 = torch.zeros(3, 2, dtype=torch.float64)
    y1, s1 = iir.sos_cascade_chunked_torch(sb, sa, s0, x[:333])
    y2, s2 = iir.sos_cascade_chunked_torch(sb, sa, s1, x[333:])
    y, s = iir.sos_cascade_chunked_torch(sb, sa, s0, x)
    _check(torch.float64, _cat(y1, y2, s2), _cat(y, s))
