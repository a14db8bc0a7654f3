"""Parallel linear recurrences.

Port of ``solid_dsp_tpu/ops/linrec.py`` (:18-113): the block-parallel
evaluation of s[t] = A[t] s[t-1] + v[t] as an O(log T)-depth scan over
affine maps (``affine_combine``, ``affine_scan``) and the chunked scalar
recurrence ``chunked_first_order``.  JAX's ``lax.associative_scan`` is
XLA-level; here :func:`associative_scan` is a Hillis-Steele doubling in
torch ops (log2 T levels, each one combine over the shifted sequence), which
``ops/agc.py::agc_apply_parallel`` also uses for its scalar affine scan and
its 2x2 Newton combine.  Sums associate in another order than JAX's
odd/even scan, so results agree to rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import fp32_exact

__all__ = ["associative_scan", "affine_combine", "affine_scan",
           "chunked_first_order"]


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
