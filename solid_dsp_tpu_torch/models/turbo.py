"""Turbo codes: parallel-concatenated RSC encoders and iterative max-log
BCJR decoding.

Port of ``solid_dsp_tpu/models/turbo.py``: LTE's rate-1/3 construction,
two (1, g1/g0) RSC constituents (g0 = 1 + D^2 + D^3, g1 = 1 + D + D^3,
m = 3, both tail-terminated) with a QPP interleaver, decoded by iterating
two max-log BCJR constituents that exchange extrinsic LLRs.  The QPP and
trellis tables are the JAX package's host numpy.  LLRs: positive favours
bit 0.  Flat codeword layout (length 3T + 4m):
``[sys | par1 | par2 | tail_sys1 | tail_par1 | tail_sys2 | tail_par2]``.

**A batch axis.**  JAX encodes and decodes one codeword and batches with
``jax.vmap``; here :func:`turbo_encode`, :func:`turbo_decode` and
:class:`TurboCode` take any leading axes natively ((..., T) bits,
(..., 3T + 4m) LLRs), and a 1-D input is one codeword.

**The walk.**  Each half-iteration's forward (alpha) and backward (beta)
recurrences and the a-posteriori LLRs of one constituent over (B, T + m)
rows are :func:`bcjr_maxlog`.  Max-log BCJR is linear in the max-plus
semiring (alpha_{t+1} = M_t (x) alpha_t, beta_t = N_t (x) beta_{t+1},
(A (x) x)[n] = max_j A[n, j] + x[j]), so on the card the hand-written
Hopper kernel S6 (``ops/cuda_bcjr.py``, ``csrc/bcjr_scan.cu``) walks it as
a time-parallel chunk-and-join: each chunk of :data:`CHUNK` steps
composes its 8 x 8 step matrices, a float64 join carries alpha and beta
over the chunks' boundaries, and each chunk is walked again from exact
boundary metrics with its LLRs.  :func:`bcjr_maxlog_chunked_torch` holds
that geometry and order of operations in torch ops (the card's kernels
are bit-equal to it).  A CPU tensor takes :func:`bcjr_maxlog_plain`, the
torch-ops port of JAX's radix-8 blocked max-plus scan in JAX's order of
operations (``_bcjr_extrinsic``, JAX ``models/turbo.py:195-324``), which
the CPU tests hold against JAX.  The RSC encoder's walk runs as torch ops
over the rows, a step at a time.

**The decode.**  On a CUDA tensor :func:`turbo_decode` runs every
iteration of both constituents in one launch of S6's fused entry
(``cuda_bcjr.turbo_decode_cuda``: a thread block a codeword, its rows in
shared memory), where the codeword fits the block's shared memory (K up
to 7,133 on an H100, LTE's 6144 included); a longer codeword takes two
launches of the walk an iteration (``cuda_bcjr.bcjr_maxlog_cuda``), a
route by shape.
:func:`turbo_decode_chunked_torch` is the fused decode's counterpart in
torch ops.

The functions run where their input lies; :class:`TurboCode` moves its
inputs to its device (the card unless told otherwise).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..device import bind_device, device_constant
from ..ops import cuda_bcjr
from ..ops.cuda_build import use_kernel

__all__ = ["qpp_permutation", "turbo_encode", "turbo_decode",
           "turbo_decode_chunked_torch", "bcjr_maxlog", "bcjr_maxlog_plain",
           "bcjr_maxlog_chunked_torch", "TurboCode", "LTE_QPP", "CHUNK",
           "RENORM"]

# natural bit order (bit j = coefficient of D^j): LTE's "13/15" (3GPP TS
# 36.212 5.1.3.2), feedback 0o15 = 1 + D^2 + D^3, feedforward 0o13
DEFAULT_FB = 0o15
DEFAULT_FF = 0o13
DEFAULT_M = 3

# 3GPP TS 36.212 Table 5.1.3-3 QPP parameters (a subset), re-validated on use
LTE_QPP = {
    40: (3, 10), 64: (7, 16), 80: (11, 20), 104: (7, 26),
    128: (15, 32), 160: (21, 120), 256: (15, 32), 320: (21, 120),
    512: (31, 64), 1024: (31, 64), 2048: (31, 64), 6144: (263, 480),
}

NEG = -1e9               # log-metric of an unreachable state
RADIX = 8                # the plain version's block of steps (JAX's R)
CHUNK = 32               # S6's chunk of steps (csrc/bcjr_scan.cu's LC)
RENORM = 16              # S6's renormalisation period in a chunk (RN)


def qpp_permutation(K: int, f1: int | None = None,
                    f2: int | None = None) -> np.ndarray:
    """QPP interleaver pi(i) = (f1 i + f2 i^2) mod K, validated; (f1, f2)
    from ``LTE_QPP`` or, for other K, the JAX package's deterministic
    search.  Raises ValueError if it is not a bijection on [0, K)."""
    if f1 is None or f2 is None:
        if K in LTE_QPP:
            f1, f2 = LTE_QPP[K]
        else:
            f1, f2 = _qpp_search(K)
    i = np.arange(K, dtype=np.int64)
    pi = (f1 * i + f2 * i * i) % K
    if np.unique(pi).size != K:
        raise ValueError(f"QPP({f1},{f2}) mod {K} is not a permutation")
    return pi.astype(np.int32)


def _qpp_search(K: int) -> tuple:
    """First (f1, f2) giving a bijective QPP mod K, f1 from near sqrt(K)."""
    i = np.arange(K, dtype=np.int64)
    start = max(3, int(np.sqrt(K)) | 1)
    for f2 in range(2, 20 * K, 2):
        for f1 in range(start, start + 2 * K, 2):
            if np.gcd(f1, K) != 1:
                continue
            pi = (f1 * i + f2 * i * i) % K
            if np.unique(pi).size == K:
                return int(f1), int(f2)
    raise ValueError(f"no QPP parameters found for K={K}")


def _masks(fb: int, ff: int, m: int):
    """Register masks with D^1 at the MSB .. D^m at the LSB."""
    fbm = ffm = 0
    for j in range(1, m + 1):
        if (fb >> j) & 1:
            fbm |= 1 << (m - j)
        if (ff >> j) & 1:
            ffm |= 1 << (m - j)
    return fbm, ffm, ff & 1


def _par(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    for sh in (16, 8, 4, 2, 1):
        x ^= x >> sh
    return (x & 1).astype(np.int32)


@lru_cache(maxsize=8)
def _rsc_tables(fb: int, ff: int, m: int):
    """(ns, p, prev, prev_u, tail_u): next state and parity (S, 2) for
    (state, input), the two predecessors of each state and the input on
    each incoming transition (S, 2), the terminating input (S,)."""
    S = 1 << m
    fbm, ffm, ff0 = _masks(fb, ff, m)
    s = np.arange(S)[:, None]
    u = np.arange(2)[None, :]
    a = u ^ _par(s & fbm)
    p = (ff0 * a) ^ _par(s & ffm)
    ns = (a << (m - 1)) | (s >> 1)
    prev = np.empty((S, 2), np.int32)
    prev_u = np.empty((S, 2), np.int32)
    n = np.arange(S)
    a_of_n = n >> (m - 1)
    low = (n & ((1 << (m - 1)) - 1)) << 1
    for c in (0, 1):
        sp = low | c
        prev[:, c] = sp
        prev_u[:, c] = a_of_n ^ _par(sp & fbm)
    tail_u = _par(np.arange(S) & fbm)
    return (ns.astype(np.int32), p.astype(np.int32), prev, prev_u,
            tail_u.astype(np.int32))


def _rsc_encode(bits: torch.Tensor, fb: int, ff: int, m: int):
    """One RSC constituent over (B, T) bits: (parity (B, T), tail_sys
    (B, m), tail_par (B, m)), a step at a time over the rows."""
    ns_t, p_t, _, _, tail_t = _rsc_tables(fb, ff, m)
    dev = bits.device
    ns = device_constant(ns_t, dev, torch.long)
    p = device_constant(p_t, dev, torch.int32)
    tail = device_constant(tail_t, dev, torch.long)
    s = torch.zeros(bits.shape[0], dtype=torch.long, device=dev)
    u_all = bits.long()
    par = []
    for t in range(bits.shape[-1]):
        u = u_all[:, t]
        par.append(p[s, u])
        s = ns[s, u]
    tsys, tpar = [], []
    for _ in range(m):
        u = tail[s]
        tsys.append(u.to(torch.int32))
        tpar.append(p[s, u])
        s = ns[s, u]
    empty = bits.new_zeros((bits.shape[0], 0))
    return (torch.stack(par, -1) if par else empty, torch.stack(tsys, -1),
            torch.stack(tpar, -1))


def turbo_encode(bits, perm, fb: int = DEFAULT_FB, ff: int = DEFAULT_FF,
                 m: int = DEFAULT_M) -> torch.Tensor:
    """Encode (..., T) information bits into (..., 3T + 4m) int32
    codewords; ``perm`` is the interleaver (len T)."""
    bits = torch.as_tensor(bits).to(torch.int32)
    perm = np.asarray(perm)
    if perm.shape[0] != bits.shape[-1]:
        raise ValueError("interleaver length != block length")
    lead = bits.shape[:-1]
    rows = bits.reshape(-1, bits.shape[-1])
    pj = device_constant(perm.astype(np.int64), bits.device, torch.long)
    par1, ts1, tp1 = _rsc_encode(rows, fb, ff, m)
    par2, ts2, tp2 = _rsc_encode(rows[:, pj], fb, ff, m)
    out = torch.cat([rows, par1, par2, ts1, tp1, ts2, tp2], -1)
    return out.reshape(*lead, out.shape[-1])


def _mp(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Max-plus product C[..., i, j] = max_k A[..., i, k] + B[..., k, j]."""
    return torch.amax(A[..., :, :, None] + B[..., None, :, :], dim=-2)


def _transition_matrices(lsp, lpp, mask_np, sgn_a, sgn_b):
    """(B, T', S, S) matrices max_c mask * 0.5 (sgn_a ls + sgn_b lp), NEG off
    the trellis; sgn_a, sgn_b broadcast to (S, 2) per (row index, c)."""
    dev = lsp.device
    g = 0.5 * (sgn_a * lsp[..., :, None, None]
               + sgn_b * lpp[..., :, None, None])              # (B, T', S, 2)
    mask = device_constant(mask_np, dev, torch.bool)           # (S, S, 2)
    neg = torch.tensor(NEG, dtype=torch.float32, device=dev)
    return torch.amax(torch.where(mask, g[..., :, :, None, :], neg), dim=-1)


def bcjr_maxlog_plain(ls: torch.Tensor, lp: torch.Tensor, T: int,
                      fb: int = DEFAULT_FB, ff: int = DEFAULT_FF,
                      m: int = DEFAULT_M) -> torch.Tensor:
    """S6's plain version: the max-log BCJR of one terminated constituent
    over rows ``ls = l_sys + l_apr`` and ``lp`` (B, T + m) float32 with the
    tails appended -> the (B, T) a-posteriori LLRs.  JAX's radix-8 blocked
    max-plus scan, batched: per-step (S, S) transition matrices, their
    within-block prefix (forward) and suffix (backward) products, and one
    sequential step a block of 8, renormalised by the max at each block's
    end; the padded steps are the max-plus identity."""
    ns_t, p_t, prev_t, prev_u_t, _ = _rsc_tables(fb, ff, m)
    S = ns_t.shape[0]
    R = RADIX
    dev = ls.device
    B, Tm = ls.shape
    f32 = torch.float32
    sgn_p = device_constant(1.0 - 2.0 * p_t, dev, f32)          # (S, 2)
    prev_p = p_t[prev_t, prev_u_t]
    pad = (-Tm) % R
    lsp = torch.cat([ls, ls.new_zeros((B, pad))], -1)
    lpp = torch.cat([lp, lp.new_zeros((B, pad))], -1)
    TB = (Tm + pad) // R
    ident = torch.where(torch.eye(S, dtype=torch.bool, device=dev),
                        torch.tensor(0.0, device=dev),
                        torch.tensor(NEG, dtype=f32, device=dev))

    # forward matrices M[t, n, s'] = gamma(s' -> n at t)
    in_mask = np.zeros((S, S, 2), bool)                        # [n, s', c]
    for n in range(S):
        for c in range(2):
            in_mask[n, prev_t[n, c], c] = True
    M = _transition_matrices(
        lsp, lpp, in_mask, device_constant(1.0 - 2.0 * prev_u_t, dev, f32),
        device_constant(1.0 - 2.0 * prev_p, dev, f32))
    if pad:
        M[:, Tm:] = ident
    Mb = M.reshape(B, TB, R, S, S)
    prefixes = [Mb[:, :, 0]]
    for i in range(1, R):
        prefixes.append(_mp(Mb[:, :, i], prefixes[-1]))
    Pstack = torch.stack(prefixes, dim=2)                      # (B,TB,R,S,S)

    alpha = torch.full((B, S), NEG, dtype=f32, device=dev)
    alpha[:, 0] = 0.0
    alphas = []
    for j in range(TB):
        a_all = torch.amax(Pstack[:, j] + alpha[:, None, None, :], dim=-1)
        alphas += [alpha[:, None], a_all[:, :-1]]
        a_next = a_all[:, -1]
        alpha = a_next - torch.amax(a_next, dim=-1, keepdim=True)
    alphas = torch.cat(alphas, 1)[:, :Tm]                      # (B, Tm, S)

    # backward matrices N[t, s, n] = gamma(s -> n at t)
    sgn_u = torch.tensor([1.0, -1.0], dtype=f32, device=dev)   # u = 0, 1
    out_mask = np.zeros((S, S, 2), bool)                       # [s, n, c]
    for s in range(S):
        for u in range(2):
            out_mask[s, ns_t[s, u], u] = True
    N = _transition_matrices(lsp, lpp, out_mask, sgn_u, sgn_p)
    if pad:
        N[:, Tm:] = ident
    Nb = N.reshape(B, TB, R, S, S)
    sufs = [Nb[:, :, R - 1]]
    for i in range(R - 2, -1, -1):
        sufs.append(_mp(Nb[:, :, i], sufs[-1]))
    Sstack = torch.stack(sufs[::-1], dim=2)                    # (B,TB,R,S,S)

    beta = torch.full((B, S), NEG, dtype=f32, device=dev)      # terminated
    beta[:, 0] = 0.0
    betas = [None] * TB
    for j in range(TB - 1, -1, -1):
        b_all = torch.amax(Sstack[:, j] + beta[:, None, None, :], dim=-1)
        betas[j] = torch.cat([b_all[:, 1:], beta[:, None]], 1)
        b_start = b_all[:, 0]
        beta = b_start - torch.amax(b_start, dim=-1, keepdim=True)
    betas_next = torch.cat(betas, 1)[:, :Tm]                   # (B, Tm, S)

    # a-posteriori LLR a step: max over u = 0 transitions minus u = 1
    g_out = 0.5 * (sgn_u * ls[..., :, None, None]
                   + sgn_p * lp[..., :, None, None])           # (B, Tm, S, 2)
    ns = device_constant(ns_t, dev, torch.long)
    metric = alphas[..., None] + g_out + betas_next[..., ns]
    llr = (torch.amax(metric[..., 0], dim=-1)
           - torch.amax(metric[..., 1], dim=-1))
    return llr[:, :T]


@lru_cache(maxsize=8)
def _walk_tables(fb: int, ff: int, m: int):
    """S6's tables, per direction (0: the forward walk's incoming
    transitions, 1: the backward walk's outgoing ones) and state x: the
    states ``src`` (2, S, 2) whose metrics x's two branches read, and the
    signs ``su``, ``sp`` (2, S, 2) of the branches' input and parity, so
    that a branch's gamma is 0.5 (su ls + sp lp)."""
    ns, p, prev, prev_u, _ = _rsc_tables(fb, ff, m)
    prev_p = p[prev, prev_u]
    src = np.stack([prev, ns]).astype(np.int64)
    su = np.stack([1 - 2 * prev_u, np.broadcast_to([1, -1], ns.shape)])
    sp = np.stack([1 - 2 * prev_p, 1 - 2 * p])
    return src, su.astype(np.float32), sp.astype(np.float32)


def _gammas(ls, lp, su, sp):
    """0.5 (su ls + sp lp) a step and branch: rows (N,) -> (N, S, 2); the
    products are exact (signs), the sum rounds once, the half is exact."""
    return 0.5 * (su * ls[:, None, None] + sp * lp[:, None, None])


def _chunk_matrices(ls, lp, length: int, src, su, sp, forward: bool):
    """S6's pass 1 on tasks of ``length`` steps, rows ls, lp (N, length):
    each chunk's max-plus product of its step matrices, (N, S, S) float32
    (forward: P = M_last (x) ... (x) M_first, row n the paths that end in
    state n; backward: Q = N_first (x) ... (x) N_last).  From the identity,
    step k (k = 0 .. CHUNK - 1; the step at position k forward, CHUNK - 1 -
    k backward, positions past ``length`` skipped) is X'[x, j] = max_c
    (g(x, c) + X[src[x, c], j]); after step k with (k + 1) % RENORM == 0
    and k + 1 < CHUNK the matrix drops its largest entry (a constant that
    the join's renormalisation cancels)."""
    N, S = ls.shape[0], src.shape[0]
    X = torch.full((N, S, S), NEG, dtype=torch.float32, device=ls.device)
    X[:, torch.arange(S), torch.arange(S)] = 0.0
    for k in range(CHUNK):
        i = k if forward else CHUNK - 1 - k
        if i >= length:
            continue
        g = _gammas(ls[:, i], lp[:, i], su, sp)
        X = torch.maximum(g[:, :, 0, None] + X[:, src[:, 0]],
                          g[:, :, 1, None] + X[:, src[:, 1]])
        if (k + 1) % RENORM == 0 and k + 1 < CHUNK:
            X = X - X.amax(dim=(1, 2), keepdim=True)
    return X


def _join(mats: torch.Tensor) -> list:
    """S6's join over one row's chunk matrices in the order of the walk,
    (B, n, S, S) float32: from e_0 (0 in state 0, NEG elsewhere) the
    float64 vector v_{r+1} = mats_r (x) v_r, not renormalised along the
    way; each boundary renormalised by its max and rounded to float32
    once.  Returns the n + 1 boundary vectors (B, S), e_0 first."""
    B, n, S = mats.shape[:3]
    a = torch.full((B, S), NEG, dtype=torch.float64, device=mats.device)
    a[:, 0] = 0.0
    out = [a.float()]
    for r in range(n):
        a = (mats[:, r].double() + a[:, None, :]).amax(-1)
        out.append((a - a.amax(-1, keepdim=True)).float())
    return out


def _chunk_llrs(ls, lp, length: int, alpha, beta, src, su, sp):
    """S6's pass 3 on tasks of ``length`` steps, rows ls, lp (N, length),
    from the boundary metrics alpha (before the first step) and beta
    (after the last), (N, S) float32: the forward walk stores alpha before
    each step, renormalised by its max after the update that gives the
    alpha at position i + 1 when (i + 1) % RENORM == 0; the backward walk
    gives each step's LLR, max_s (alpha + g0) + beta[ns[s, 0]] - max_s
    (alpha + g1) + beta[ns[s, 1]], then beta at position i, renormalised
    when i % RENORM == 0.  Returns the (N, length) LLRs."""
    fsrc, bsrc = src
    alphas = []
    for i in range(length):
        alphas.append(alpha)
        if i + 1 < length:
            g = _gammas(ls[:, i], lp[:, i], su[0], sp[0])
            alpha = torch.maximum(g[..., 0] + alpha[:, fsrc[:, 0]],
                                  g[..., 1] + alpha[:, fsrc[:, 1]])
            if (i + 1) % RENORM == 0:
                alpha = alpha - alpha.amax(-1, keepdim=True)
    out = [None] * length
    for i in range(length - 1, -1, -1):
        g = _gammas(ls[:, i], lp[:, i], su[1], sp[1])
        b0, b1 = beta[:, bsrc[:, 0]], beta[:, bsrc[:, 1]]
        out[i] = (((alphas[i] + g[..., 0]) + b0).amax(-1)
                  - ((alphas[i] + g[..., 1]) + b1).amax(-1))
        if i > 0:
            beta = torch.maximum(g[..., 0] + b0, g[..., 1] + b1)
            if i % RENORM == 0:
                beta = beta - beta.amax(-1, keepdim=True)
    return torch.stack(out, 1)


def bcjr_maxlog_chunked_torch(ls: torch.Tensor, lp: torch.Tensor, T: int,
                              fb: int = DEFAULT_FB, ff: int = DEFAULT_FF,
                              m: int = DEFAULT_M) -> torch.Tensor:
    """S6's chunk-and-join in torch ops: the (B, T) a-posteriori LLRs of
    one terminated constituent over rows ``ls = l_sys + l_apr`` and ``lp``
    (B, T + m) float32 with the tails appended, in the kernel's geometry
    and order of operations (``csrc/bcjr_scan.cu``, bit-equal to it).

    The T + m steps are cut into chunks of :data:`CHUNK` (the last one
    ragged, any length 1 .. CHUNK).  Pass 1: the forward product of every
    chunk but the last and the backward product of every chunk but the
    first (:func:`_chunk_matrices`).  Join: alpha from state 0 over the
    chunks' starts and beta, terminated in state 0 after the tail's m
    steps, over their ends, in float64 (:func:`_join`).  Pass 3: each
    chunk walked from its boundary metrics with its LLRs
    (:func:`_chunk_llrs`).  The geometry depends on T + m only.  Against
    the plain version the values differ by float32 association and where
    the renormalisations fall, within S6's gate."""
    src_np, su_np, sp_np = _walk_tables(fb, ff, m)
    dev = ls.device
    src = device_constant(src_np, dev, torch.long)
    su = device_constant(su_np, dev, torch.float32)
    sp = device_constant(sp_np, dev, torch.float32)
    S = src.shape[1]
    B, Tm = ls.shape
    L = CHUNK
    C = -(-Tm // L)
    last = Tm - (C - 1) * L

    def tasks(x, c0, c1):                 # chunks c0 .. c1 - 1, all full
        return x[:, c0 * L:c1 * L].reshape(B * (c1 - c0), L)

    def matrices(c0, c1, forward):        # chunks c0 .. c1 - 1, (B, n, S, S)
        d = 0 if forward else 1
        full = c1 if (c1 < C or last == L) else c1 - 1
        parts = []
        if full > c0:
            parts.append(_chunk_matrices(
                tasks(ls, c0, full), tasks(lp, c0, full), L, src[d], su[d],
                sp[d], forward).reshape(B, full - c0, S, S))
        if full < c1:
            parts.append(_chunk_matrices(ls[:, full * L:], lp[:, full * L:],
                                         last, src[d], su[d], sp[d],
                                         forward)[:, None])
        return torch.cat(parts, 1)

    if C > 1:
        starts = _join(matrices(0, C - 1, True))
        ends = _join(matrices(1, C, False).flip(1))[::-1]
    else:
        starts = ends = _join(ls.new_zeros((B, 0, S, S)))
    starts, ends = torch.stack(starts, 1), torch.stack(ends, 1)   # (B, C, S)
    full = C if last == L else C - 1
    out = []
    if full:
        out.append(_chunk_llrs(
            tasks(ls, 0, full), tasks(lp, 0, full), L,
            starts[:, :full].reshape(-1, S), ends[:, :full].reshape(-1, S),
            src, su, sp).reshape(B, full * L))
    if full < C:
        out.append(_chunk_llrs(ls[:, full * L:], lp[:, full * L:], last,
                               starts[:, -1], ends[:, -1], src, su, sp))
    return torch.cat(out, 1)[:, :T]


def bcjr_maxlog(ls: torch.Tensor, lp: torch.Tensor, T: int,
                fb: int = DEFAULT_FB, ff: int = DEFAULT_FF,
                m: int = DEFAULT_M, engine: str = "auto") -> torch.Tensor:
    """The (B, T) a-posteriori LLRs of one constituent over (B, T + m)
    rows: S6's walk on a CUDA tensor (``engine`` "auto" or "cuda", one
    launch), the plain version on a CPU tensor or with ``engine="torch"``."""
    if use_kernel(engine, ls):
        return cuda_bcjr.bcjr_maxlog_cuda(ls, lp, T,
                                          *_rsc_tables(fb, ff, m)[:4])
    return bcjr_maxlog_plain(ls, lp, T, fb, ff, m)


def _decode_rows(rows, perm, n_iter: int, walk, m: int):
    """The iterations of :func:`turbo_decode` over (B, 3T + 4m) rows, each
    half-iteration one ``walk(ls, lp, T)``: JAX's ``_turbo_decode_perm``
    (``ls = l_sys + l_apr``, the extrinsic ``(llr - l_sys) - l_apr``, the
    QPP gathers) with a batch axis.  Returns the final LLRs (B, T)."""
    T = perm.size
    inv = np.empty_like(perm)
    inv[perm] = np.arange(T)
    pj = device_constant(perm, rows.device, torch.long)
    ij = device_constant(inv, rows.device, torch.long)
    ls = rows[:, :T]
    t = rows[:, 3 * T:].reshape(-1, 4, m)
    # the parity rows with their tails, the same every iteration
    lp1 = torch.cat([rows[:, T:2 * T], t[:, 1]], -1)
    lp2 = torch.cat([rows[:, 2 * T:3 * T], t[:, 3]], -1)
    ls2 = ls[:, pj]

    def extrinsic(l_sys, lp, l_apr, t_sys):
        llr = walk(torch.cat([l_sys + l_apr, t_sys], -1), lp, T)
        return llr - l_sys - l_apr, llr

    apr1 = torch.zeros_like(ls)
    llr = ls
    for _ in range(int(n_iter)):
        ext1, _ = extrinsic(ls, lp1, apr1, t[:, 0])
        ext2, llr2 = extrinsic(ls2, lp2, ext1[:, pj], t[:, 2])
        apr1 = ext2[:, ij]
        llr = llr2[:, ij]
    return llr


def _as_rows(rx_llr, perm, m: int):
    rx = torch.as_tensor(rx_llr).to(torch.float32)
    perm = np.asarray(perm, np.int64)
    T = perm.size
    if rx.shape[-1] != 3 * T + 4 * m:
        raise ValueError(f"expected {3 * T + 4 * m} LLRs a codeword, got "
                         f"{rx.shape[-1]}")
    return rx.shape[:-1], rx.reshape(-1, rx.shape[-1]), perm


def turbo_decode(rx_llr, perm, n_iter: int = 8, fb: int = DEFAULT_FB,
                 ff: int = DEFAULT_FF, m: int = DEFAULT_M,
                 engine: str = "auto"):
    """Iteratively decode (..., 3T + 4m) LLRs in the :func:`turbo_encode`
    layout (positive favours 0).  Returns (bits (..., T) int32, llr
    (..., T) float32), the hard decisions and the final a-posteriori LLRs.
    Any leading axes are a batch (JAX vmaps instead).

    On a CUDA tensor (``engine`` "auto" or "cuda") the decode is S6 on the
    8-state trellis: the whole decode, every iteration of both
    constituents, in one launch of ``cuda_bcjr.turbo_decode_cuda`` where
    the codeword fits a thread block's shared memory
    (``cuda_bcjr.fused_fits``: K up to 7,133 on an H100; the kernel
    returns the bits too); a longer codeword takes two launches of the walk
    (``bcjr_maxlog_cuda``) an iteration, a route by shape.  Both are
    bit-equal to :func:`turbo_decode_chunked_torch`.  A CPU tensor, or
    ``engine="torch"``, takes the plain walks (:func:`bcjr_maxlog_plain`,
    JAX's order)."""
    lead, rows, perm = _as_rows(rx_llr, perm, m)
    T = perm.size
    if n_iter >= 1 and use_kernel(engine, rows):
        tabs = _rsc_tables(fb, ff, m)[:4]
        if cuda_bcjr.fused_fits(T, rows.device):
            bits, llr = cuda_bcjr.turbo_decode_cuda(rows, perm, n_iter, *tabs)
            return bits.reshape(*lead, T), llr.reshape(*lead, T)
        llr = _decode_rows(rows, perm, n_iter, lambda a, b, n: (
            cuda_bcjr.bcjr_maxlog_cuda(a, b, n, *tabs)), m)
    elif n_iter >= 1:
        llr = _decode_rows(rows, perm, n_iter, lambda a, b, n: (
            bcjr_maxlog_plain(a, b, n, fb, ff, m)), m)
    else:
        llr = rows[:, :T]
    llr = llr.reshape(*lead, T)
    return (llr < 0).to(torch.int32), llr


def turbo_decode_chunked_torch(rx_llr, perm, n_iter: int = 8,
                               fb: int = DEFAULT_FB, ff: int = DEFAULT_FF,
                               m: int = DEFAULT_M):
    """:func:`turbo_decode` with each walk :func:`bcjr_maxlog_chunked_torch`,
    in torch ops where the input lies: the counterpart of S6's fused
    decode (and of its half-iteration route), bit-equal to both on the
    card.  Returns (bits, llr) as :func:`turbo_decode` does."""
    lead, rows, perm = _as_rows(rx_llr, perm, m)
    T = perm.size
    llr = rows[:, :T] if n_iter < 1 else _decode_rows(
        rows, perm, n_iter, lambda a, b, n: bcjr_maxlog_chunked_torch(
            a, b, n, fb, ff, m), m)
    llr = llr.reshape(*lead, T)
    return (llr < 0).to(torch.int32), llr


class TurboCode:
    """Turbo code of block size K with its QPP interleaver, on ``device``
    (the card unless told otherwise); ``decode`` takes a batch axis."""

    def __init__(self, K: int, f1: int | None = None,
                 f2: int | None = None, n_iter: int = 8, device=None):
        self.K = int(K)
        self.perm = qpp_permutation(self.K, f1, f2)
        self.n_iter = int(n_iter)
        self.m = DEFAULT_M
        self.n_coded = 3 * self.K + 4 * self.m
        self.device = bind_device(device)

    @property
    def rate(self) -> float:
        return self.K / self.n_coded

    def encode(self, bits) -> torch.Tensor:
        return turbo_encode(torch.as_tensor(bits).to(self.device), self.perm)

    def decode(self, rx_llr, n_iter: int | None = None):
        return turbo_decode(torch.as_tensor(rx_llr).to(self.device),
                            self.perm,
                            self.n_iter if n_iter is None else n_iter)

    def __repr__(self):
        return (f"TurboCode [K={self.K}] [rate={self.rate:.3f}] "
                f"[iters={self.n_iter}]")
