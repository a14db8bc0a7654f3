"""Parallel linear recurrences.

Port of ``solid_dsp_tpu/ops/linrec.py`` (:18-113): the block-parallel
evaluation of s[t] = A[t] s[t-1] + v[t] as an O(log T)-depth scan over
affine maps (``affine_combine``, ``affine_scan``) and the chunked scalar
recurrence ``chunked_first_order``.  JAX's ``lax.associative_scan`` is
XLA-level; here :func:`associative_scan` is a Hillis-Steele doubling in
torch ops (log2 T levels, each one combine over the shifted sequence), which
``ops/agc.py::agc_apply_parallel`` also uses for its scalar affine scan and
its 2x2 Newton combine.  Sums associate in another order than JAX's
odd/even scan, so results agree to rounding.  The port adds the host's side
of the chunk-and-join evaluation that S3 (``ops/cuda_scan.py``), S4's LTI
entry (``ops/cuda_track.py``) and their plain versions (``ops/iir.py``,
``ops/kalman.py``) share: the one-step maps, the chunk rule, the float64
join tables and the chunked association in torch ops.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import fp32_exact

__all__ = ["associative_scan", "affine_combine", "affine_scan",
           "chunked_first_order", "host_values", "rounded", "companion",
           "cascade_matrix", "transient_gain", "chunk_rows", "join_tables",
           "join_chunks", "chunked_walk", "S3_CHUNK", "S3_SHORT_CHUNK", "S3_GAIN_LIMIT", "WIDE"]


def associative_scan(combine, elems, dim: int = 0):
    """Inclusive scan of the tuple of tensors ``elems`` along ``dim`` under
    an associative ``combine(left, right)`` (left the earlier element, each
    a tuple like ``elems``): out[i] = elems[0] o ... o elems[i]."""
    elems = tuple(elems)
    T = int(elems[0].shape[dim])
    k = 1
    while k < T:
        left = tuple(e.narrow(dim, 0, T - k) for e in elems)
        right = tuple(e.narrow(dim, k, T - k) for e in elems)
        comb = combine(left, right)
        elems = tuple(torch.cat([e.narrow(dim, 0, k), c], dim=dim)
                      for e, c in zip(elems, comb))
        k *= 2
    return elems


def affine_combine(left, right):
    """Compose affine maps: (A2, v2) o (A1, v1) = (A2 A1, A2 v1 + v2)."""
    A1, v1 = left
    A2, v2 = right
    with fp32_exact():
        return (torch.matmul(A2, A1),
                torch.einsum("...ij,...j->...i", A2, v1) + v2)


def affine_scan(As: torch.Tensor, vs: torch.Tensor) -> torch.Tensor:
    """Prefix evaluation of s[t] = A[t] s[t-1] + v[t] (s[-1] folded into
    v[0] by the caller).  As (T, n, n), vs (T, n) -> s (T, n)."""
    _, s = associative_scan(affine_combine, (As, vs))
    return s


def chunked_first_order(lams, u: torch.Tensor, chunk: int = 256):
    """Scalar LTI recurrences s[m, t] = lam[m] s[m, t-1] + u[m, t]
    (s[m, -1] = 0) as products instead of a scan.

    ``lams``: host (m,) decay factors, real or complex; ``u``: (..., m, T).
    Within chunks of ``chunk`` samples the prefix is one product with the
    lower-triangular power matrix LT[m, i', i] = lam[m]^(i - i'); the
    carries across the T / chunk boundaries obey a first-order recurrence
    with factor lam^chunk, taken by :func:`associative_scan`.  Complex
    products run as real-plane products."""
    lams = np.atleast_1d(np.asarray(lams))
    T = u.shape[-1]
    B = int(min(chunk, max(T, 1)))
    F = -(-T // B)
    pad = F * B - T
    if pad:
        u = torch.nn.functional.pad(u, (0, pad))
    d = np.arange(B)[None, :] - np.arange(B)[:, None]
    with np.errstate(invalid="ignore"):
        LT = np.where(d >= 0, lams[:, None, None].astype(np.complex128)
                      ** np.maximum(d, 0)[None], 0.0)
    cplx_l = np.iscomplexobj(lams)
    if not cplx_l:
        LT = LT.real
    l_dt = torch.complex128 if cplx_l else torch.float64
    cdt = torch.promote_types(torch.promote_types(u.dtype, l_dt),
                              torch.float32)
    uc = u.reshape(*u.shape[:-2], lams.shape[0], F, B).to(cdt)
    rdt = torch.empty(0, dtype=cdt).real.dtype

    def mm(a, M_np):
        Mt = torch.from_numpy(np.array(M_np, copy=True)).to(
            device=a.device, dtype=rdt)
        with fp32_exact():
            return torch.einsum("...mfi,mij->...mfj", a, Mt)

    if cdt.is_complex:
        ur, ui = uc.real, uc.imag
        LTr, LTi = LT.real, LT.imag
        s_loc = torch.complex(mm(ur, LTr) - mm(ui, LTi),
                              mm(ur, LTi) + mm(ui, LTr)).to(cdt)
    else:
        s_loc = mm(uc, LT).to(cdt)
    c = s_loc[..., B - 1]                                    # (..., m, F)
    aB = (lams.astype(np.complex128) ** B if cplx_l
          else lams.astype(np.float64) ** B)
    a_el = torch.from_numpy(np.asarray(aB)).to(device=u.device, dtype=cdt)
    a_el = a_el[:, None].expand(c.shape).contiguous()

    def comb(left, right):
        a1, v1 = left
        a2, v2 = right
        return a1 * a2, a2 * v1 + v2

    _, g = associative_scan(comb, (a_el, c), dim=c.dim() - 1)
    g_prev = torch.cat([torch.zeros_like(g[..., :1]), g[..., :-1]], dim=-1)
    powv = (lams.astype(np.complex128)[:, None]
            ** (np.arange(B) + 1)[None, :])
    if not cplx_l:
        powv = powv.real
    pw = torch.from_numpy(np.asarray(powv)).to(device=u.device, dtype=cdt)
    s = s_loc + g_prev[..., None] * pw[:, None, :]
    return s.reshape(*s.shape[:-2], F * B)[..., :T]


# ---------------------------------------------------------------------------
# the host's side of the chunk-and-join evaluation of a linear recurrence
# (S3, ops/iir.py's plain versions and csrc/iir_scan.cu): one-step maps,
# the chunk rule and the join tables, built in float64 or wider
# ---------------------------------------------------------------------------

S3_CHUNK = 64            # rows a chunk (torch_kernel_sweep.py s3)
S3_SHORT_CHUNK = 16      # rows a chunk where the transient gain
S3_GAIN_LIMIT = 100.0    # max_{n <= S3_CHUNK} ||A^n||_2 exceeds this
# the join's type of a working type
WIDE = {torch.float32: torch.float64, torch.float64: torch.float64,
        torch.complex64: torch.complex128, torch.complex128: torch.complex128}


def host_values(t) -> np.ndarray:
    """The values of a coefficient tensor (or array) on the host, float64 or
    complex128.  A tensor on the card is read once (one host sync) and the
    values kept on it until it is changed in place; a view of a contiguous
    tensor on the card (``a[..., 1:]``, ``sos_a[s]``, made anew at each
    call) is cut from its base's values, so the base too is read once."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t, dtype=np.complex128 if np.iscomplexobj(t)
                          else np.float64)
    if not t.is_cuda:
        v = t.detach().numpy()
        return v.astype(np.complex128 if v.dtype.kind == "c" else np.float64)
    base = t._base
    if base is not None and base.dtype == t.dtype and base.is_contiguous():
        return torch.from_numpy(host_values(base)).as_strided(
            t.shape, t.stride(),
            t.storage_offset() - base.storage_offset()).numpy().copy()
    hit = getattr(t, "_host_values", None)
    if hit is None or hit[0] != t._version:
        hit = (t._version, host_values(t.detach().cpu()))
        t._host_values = hit
    return hit[1]


def rounded(values: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """Host coefficients rounded to ``dtype`` as the card rounds them,
    back in float64 (complex128 for a complex dtype)."""
    t = torch.from_numpy(np.ascontiguousarray(values)).to(dtype)
    return t.to(WIDE[dtype]).numpy()


def companion(a: np.ndarray) -> np.ndarray:
    """S3's one-step map A of the state [w[n-1], ..., w[n-k]]: w[n] =
    -a . state (+ x[n]), then the shift."""
    k = len(a)
    A = np.zeros((k, k), dtype=a.dtype)
    A[0, :] = -a
    A[np.arange(1, k), np.arange(k - 1)] = 1.0
    return A


def cascade_matrix(coef: np.ndarray) -> np.ndarray:
    """The biquad cascade's one-step map of the state [w1_0, w2_0, w1_1,
    ...] at zero input, coef (S, 5) [b0 b1 b2 a1 a2]: each unit state run
    through K6's step (``ops/iir.py::_cascade_walk``) in float64."""
    S = coef.shape[0]
    N = 2 * S
    out = np.zeros((N, N))
    for j in range(N):
        st = np.eye(N)[j]
        new = st.copy()
        v = 0.0
        for s in range(S):
            b0, b1, b2, a1, a2 = coef[s]
            w1, w2 = st[2 * s], st[2 * s + 1]
            w0 = v - (a1 * w1 + a2 * w2)
            v = b0 * w0 + (b1 * w1 + b2 * w2)
            new[2 * s], new[2 * s + 1] = w0, w1
        out[:, j] = new
    return out


@functools.lru_cache(maxsize=64)
def _gain(a_bytes: bytes, cplx: bool, shape: tuple) -> float:
    A = np.frombuffer(a_bytes, np.complex128 if cplx
                      else np.float64).reshape(shape)
    p, gain = np.eye(A.shape[0]), 0.0
    for _ in range(S3_CHUNK):
        p = A @ p
        gain = max(gain, float(np.linalg.norm(p, 2)))
    return gain


def transient_gain(A: np.ndarray) -> float:
    """max_{1 <= n <= S3_CHUNK} ||A^n||_2 of a one-step map A (float64 on
    the host, cached): how far a chunk's walk can amplify an error in its
    start, e.g. the rounding of a start joined in another order."""
    A = np.ascontiguousarray(A)
    return _gain(A.tobytes(), np.iscomplexobj(A), A.shape)


def chunk_rows(A: np.ndarray, dtype: torch.dtype) -> int:
    """Rows a chunk for the one-step map A in the working type ``dtype``:
    :data:`S3_CHUNK`, or in 32 bits :data:`S3_SHORT_CHUNK` where A's
    :func:`transient_gain` exceeds :data:`S3_GAIN_LIMIT` (a direct form of
    high order with clustered poles): there a chunk's walk amplifies its
    own rounding, and shorter chunks, each started from the join's float64
    state, keep more of the filter than the sequential walk does
    (tests/test_torch_iir_scan_chunks.py).  64-bit walks keep far more than
    any gate: they take S3_CHUNK."""
    if dtype in (torch.float64, torch.complex128):
        return S3_CHUNK
    return S3_CHUNK if transient_gain(A) <= S3_GAIN_LIMIT else S3_SHORT_CHUNK


def join_tables(A: np.ndarray, chunk: int, cb: int, D: int) -> np.ndarray:
    """The kernel's join tables for the one-step map A (N, N): Phi^j for
    j = 1 .. cb, then Phi^(cb 2^d) for d = 0 .. D - 1, Phi = A^chunk, as
    (cb + D, N, N) float64 (complex128).  Built in the host's extended
    precision (numpy longdouble): Phi step by step from A, as the
    recurrence takes it, then the products; each rounded once to float64
    (a companion matrix is far from normal, and squarings in float64 cost
    up to four digits at order 8 with poles near the unit circle)."""
    wide = np.clongdouble if np.iscomplexobj(A) else np.longdouble
    Aw = A.astype(wide)
    with np.errstate(over="ignore", invalid="ignore"):
        phi = np.eye(A.shape[0], dtype=wide)
        for _ in range(chunk):
            phi = Aw @ phi
        out, p = [], phi
        for _ in range(cb):
            out.append(p)
            p = p @ phi
        p = out[-1]
        for _ in range(D):
            out.append(p)
            p = p @ p
    return np.stack(out).astype(np.complex128 if np.iscomplexobj(A)
                                else np.float64)


def join_chunks(A: np.ndarray, chunk: int, h0: torch.Tensor,
                ends: torch.Tensor) -> torch.Tensor:
    """The chunks' true starts in float64 (complex128): S_0 = h0 and
    S_{c+1} = Phi S_c + ends[c], Phi = A^chunk, by a doubling scan through
    Phi^(2^d) (:func:`join_tables`, the kernels' tables).  h0 (*lanes, N),
    ends (nc - 1, *lanes, N), both already wide; returns (nc, *lanes,
    N)."""
    n = ends.shape[0]
    tabs = torch.from_numpy(join_tables(
        A, chunk, 1, max(1, (n - 1).bit_length()))).to(ends.device)
    v = ends.clone()
    v[0] = v[0] + torch.einsum("ij,...j->...i", tabs[0], h0)
    d, off = 0, 1
    while off < n:
        v = torch.cat([v[:off], v[off:] + torch.einsum(
            "ij,...j->...i", tabs[1 + d], v[:-off])])
        d, off = d + 1, 2 * off
    return torch.cat([h0[None], v])


def chunked_walk(walk, A: np.ndarray, chunk: int, h0: torch.Tensor,
                 x: torch.Tensor, wide: torch.dtype):
    """The chunk-and-join kernels' association of a linear recurrence with
    the one-step map A over x (T, *lanes) from the state h0: every chunk of
    ``chunk`` rows from a zero state (``walk(h, rows) -> (out, h_end)``,
    h of h0's shape with a leading chunk axis where rows has one), the ends
    joined in ``wide`` (:func:`join_chunks`), every chunk again from its
    start rounded once to h0's type."""
    T = int(x.shape[0])
    nc = -(-T // chunk)
    if nc <= 1:
        return walk(h0, x)
    lanes = tuple(x.shape[1:])
    full = (nc - 1) * chunk
    xs = x[:full].reshape(nc - 1, chunk, *lanes).movedim(0, 1)
    _, ends = walk(torch.zeros((nc - 1, *h0.shape), dtype=h0.dtype,
                               device=h0.device), xs)
    starts = join_chunks(A, chunk, h0.to(wide), ends.to(wide)).to(h0.dtype)
    out, _ = walk(starts[:-1], xs)
    tail, h_end = walk(starts[-1], x[full:])
    return torch.cat([out.movedim(1, 0).reshape(full, *out.shape[2:]),
                      tail]), h_end
