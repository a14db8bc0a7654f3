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
recurrences and the a-posteriori LLRs are one call of
:func:`bcjr_maxlog` over the (B, T + m) rows: on a CUDA tensor the
hand-written Hopper kernel S6 (``ops/cuda_bcjr.py``,
``csrc/bcjr_scan.cu``: one lane a trellis state, a step at a time), on a
CPU tensor its plain version :func:`bcjr_maxlog_plain`, the torch-ops
port of JAX's radix-8 blocked max-plus scan in JAX's order of operations
(``_bcjr_extrinsic``, JAX ``models/turbo.py:195-324``), which the CPU
tests hold against JAX.  The RSC encoder's walk runs as torch ops over
the rows, a step at a time.

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
           "bcjr_maxlog", "bcjr_maxlog_plain", "TurboCode", "LTE_QPP"]

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


def bcjr_maxlog(ls: torch.Tensor, lp: torch.Tensor, T: int,
                fb: int = DEFAULT_FB, ff: int = DEFAULT_FF,
                m: int = DEFAULT_M, engine: str = "auto") -> torch.Tensor:
    """The (B, T) a-posteriori LLRs of one constituent over (B, T + m)
    rows: S6 on a CUDA tensor (``engine`` "auto" or "cuda"), the plain
    version on a CPU tensor or with ``engine="torch"``."""
    if use_kernel(engine, ls):
        return cuda_bcjr.bcjr_maxlog_cuda(ls, lp, T,
                                          *_rsc_tables(fb, ff, m)[:4])
    return bcjr_maxlog_plain(ls, lp, T, fb, ff, m)


def _bcjr_extrinsic(l_sys, lp, l_apr, t_sys, fb, ff, m, engine):
    """Rows (B, T) of channel systematic and a-priori LLRs, the (B, m)
    systematic tail and the parity rows lp (B, T + m), tail appended ->
    (extrinsic, a-posteriori) LLRs (B, T)."""
    ls = torch.cat([l_sys + l_apr, t_sys], -1)
    llr = bcjr_maxlog(ls, lp, l_sys.shape[-1], fb, ff, m, engine)
    return llr - l_sys - l_apr, llr


def turbo_decode(rx_llr, perm, n_iter: int = 8, fb: int = DEFAULT_FB,
                 ff: int = DEFAULT_FF, m: int = DEFAULT_M,
                 engine: str = "auto"):
    """Iteratively decode (..., 3T + 4m) LLRs in the :func:`turbo_encode`
    layout (positive favours 0).  Returns (bits (..., T) int32, llr
    (..., T) float32), the hard decisions and the final a-posteriori LLRs.
    Any leading axes are a batch (JAX vmaps instead); each iteration runs
    two walks (``bcjr_maxlog``: S6 on the card)."""
    rx = torch.as_tensor(rx_llr).to(torch.float32)
    perm = np.asarray(perm, np.int64)
    T = perm.size
    if rx.shape[-1] != 3 * T + 4 * m:
        raise ValueError(f"expected {3 * T + 4 * m} LLRs a codeword, got "
                         f"{rx.shape[-1]}")
    inv = np.empty_like(perm)
    inv[perm] = np.arange(T)
    lead = rx.shape[:-1]
    rows = rx.reshape(-1, rx.shape[-1])
    pj = device_constant(perm, rows.device, torch.long)
    ij = device_constant(inv, rows.device, torch.long)
    ls = rows[:, :T]
    t = rows[:, 3 * T:].reshape(-1, 4, m)
    # the parity rows with their tails, the same every iteration
    lp1 = torch.cat([rows[:, T:2 * T], t[:, 1]], -1)
    lp2 = torch.cat([rows[:, 2 * T:3 * T], t[:, 3]], -1)
    ls2 = ls[:, pj]
    apr1 = torch.zeros_like(ls)
    llr = ls
    for _ in range(int(n_iter)):
        ext1, _ = _bcjr_extrinsic(ls, lp1, apr1, t[:, 0], fb, ff, m, engine)
        ext2, llr2 = _bcjr_extrinsic(ls2, lp2, ext1[:, pj], t[:, 2], fb, ff,
                                     m, engine)
        apr1 = ext2[:, ij]
        llr = llr2[:, ij]
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
