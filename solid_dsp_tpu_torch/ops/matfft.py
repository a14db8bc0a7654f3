"""Batched DFT as planar matrix products (Bailey four-step).

Port of ``solid_dsp_tpu/ops/matfft.py``.  A DFT of composite size
N = N1 N2 is two batched products against small DFT matrices, one twiddle
pass and one transpose:

    x[n1 N2 + n2]  --(contract n1 with F_N1)-->  B[n2, k1]
    C = B * W_N^(n2 k1)
    C  --(DFT over n2, direct or recursive)-->   D[k1, k2]
    X[k1 + N1 k2] = D[k1, k2]

Everything is planar real arithmetic: a complex product is one real product
a plane against an (n, 2k) [Re F | Im F] bank and a combine of four block
slices.  Primes above ``DIRECT_MAX`` go through Bluestein with the pow2
convolution's transforms done the same way.  The products are plain
``torch.matmul`` (the JAX package leaves them to XLA outside any kernel).

Precision (``ops/fir.py::_resolve_precision`` of the JAX package):
``None``, ``"highest"`` and ``"x3"`` are full FP32 (float64 for float64
planes): :func:`dft_mx_planar` runs under ``device.fp32_exact``, so cuBLAS
keeps TF32 off whatever the caller set; ``"default"`` rounds both operands
to bf16 and accumulates in the planes' type (one bf16 pass, ~45 dB).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..device import fp32_exact

__all__ = ["DIRECT_MAX", "dft_mx_planar", "fft_mx", "ifft_mx"]

DIRECT_MAX = 256
_PRECISIONS = (None, "highest", "x3", "default")


def _resolve_precision(precision) -> str:
    """"highest" (full precision of the planes' type) or "default" (bf16
    operands)."""
    if precision not in _PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    return "default" if precision == "default" else "highest"


@lru_cache(maxsize=512)
def _dft_bank_np(n: int, sign: int, dtype: str):
    """(n, 2n) real bank [Re F | Im F] of F[j, k] = exp(sign 2 pi i j k / n),
    built in float64 with the phase reduced exactly mod n."""
    j = np.arange(n, dtype=np.int64)
    ph = (j[:, None] * j[None, :]) % n
    f = np.exp(sign * 2j * np.pi * ph / n)
    return np.concatenate([f.real, f.imag], axis=1).astype(dtype)


@lru_cache(maxsize=512)
def _twiddle_np(n1: int, n2: int, sign: int, dtype: str):
    """Twiddle planes (2, n2, k1): W[n2, k1] = exp(sign 2 pi i n2 k1 / n)."""
    n = n1 * n2
    a = np.arange(n2, dtype=np.int64)[:, None]
    b = np.arange(n1, dtype=np.int64)[None, :]
    w = np.exp(sign * 2j * np.pi * ((a * b) % n) / n)
    return np.stack([w.real, w.imag]).astype(dtype)


@lru_cache(maxsize=512)
def _split(n: int) -> int:
    """n1 | n: the divisor <= DIRECT_MAX closest to sqrt(n) from below, or
    one just above it if that is more balanced."""
    best = 1
    d = 1
    while d * d <= n:
        if n % d == 0 and d <= DIRECT_MAX:
            best = d
        d += 1
    for cand in range(int(np.sqrt(n)), min(DIRECT_MAX, n) + 1):
        if cand > 1 and n % cand == 0:
            if min(cand, n // cand) > min(best, n // best):
                best = cand
            break
    return best


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(a).to(like.device)


def _mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "default":
        a = a.to(torch.bfloat16).to(a.dtype)
        b = b.to(torch.bfloat16).to(b.dtype)
    return torch.matmul(a, b)


def _cdot(pr, pi, bank, k: int, prec: str):
    """(pr + i pi) @ (Fr + i Fi) over the last axis with an (n, 2k) bank:
    (re, im), each (..., k)."""
    a = _mm(pr, bank, prec)
    b = _mm(pi, bank, prec)
    return a[..., :k] - b[..., k:], a[..., k:] + b[..., :k]


def _bank(n: int, sign: int, like: torch.Tensor) -> torch.Tensor:
    return _const(_dft_bank_np(n, sign, str(like.dtype).split(".")[-1]),
                  like)


def _core(pr, pi, n: int, sign: int, prec: str):
    """Unnormalized DFT of size n over the last axis of (pr, pi); n is
    <= DIRECT_MAX or composite."""
    if n <= DIRECT_MAX:
        return _cdot(pr, pi, _bank(n, sign, pr), n, prec)
    n1 = _split(n)
    if n1 == 1:
        raise ValueError(
            f"size {n} is prime and exceeds DIRECT_MAX={DIRECT_MAX}; "
            "route primes through the Bluestein wrapper (fft_mx)")
    n2 = n // n1
    batch = pr.shape[:-1]
    # stage A: contract n1 (axis -2 of the (n1, n2) view) -> (..., n2, k1)
    ar = pr.reshape(*batch, n1, n2).transpose(-1, -2)
    ai = pi.reshape(*batch, n1, n2).transpose(-1, -2)
    br, bi = _cdot(ar, ai, _bank(n1, sign, pr), n1, prec)
    # stage B: twiddle W_N^{n2 k1}
    tw = _const(_twiddle_np(n1, n2, sign, str(pr.dtype).split(".")[-1]), pr)
    cr = br * tw[0] - bi * tw[1]
    ci = br * tw[1] + bi * tw[0]
    # stage C: DFT of size n2 over axis -2 -> (..., k1, k2)
    if n2 <= DIRECT_MAX:
        dr, di = _cdot(cr.transpose(-1, -2), ci.transpose(-1, -2),
                       _bank(n2, sign, pr), n2, prec)
    else:
        dr, di = _core(cr.transpose(-1, -2), ci.transpose(-1, -2), n2, sign,
                       prec)
    # stage D: X[k1 + n1 k2] -> flat order (k2 major, k1 minor)
    dr = dr.transpose(-1, -2).reshape(*batch, n)
    di = di.transpose(-1, -2).reshape(*batch, n)
    return dr, di


@fp32_exact()
def dft_mx_planar(pr: torch.Tensor, pi: torch.Tensor, sign: int = -1,
                  precision=None):
    """Unnormalized DFT over the last axis of the real planes (pr, pi):
    (re, im).  Primes above DIRECT_MAX take Bluestein."""
    prec = _resolve_precision(precision)
    n = pr.shape[-1]
    if n <= DIRECT_MAX or _split(n) > 1:
        return _core(pr, pi, n, sign, prec)
    return _bluestein_mx(pr, pi, n, sign, prec)


def _bluestein_mx(pr, pi, n: int, sign: int, prec: str):
    """Prime-size planar DFT: chirp-z through a pow2 circular convolution
    whose transforms are four-step products."""
    from .fft import _bluestein_tables

    c, B, L = _bluestein_tables(n, float(sign))
    rd = str(pr.dtype).split(".")[-1]
    cr = _const(c.real.astype(rd), pr)
    ci = _const(c.imag.astype(rd), pr)
    ar = pr * cr - pi * ci
    ai = pr * ci + pi * cr
    pad = (0, L - n)
    fr, fi = _core(torch.nn.functional.pad(ar, pad),
                   torch.nn.functional.pad(ai, pad), L, -1, prec)
    Br = _const(B.real.astype(rd), pr)
    Bi = _const(B.imag.astype(rd), pr)
    gr = fr * Br - fi * Bi
    gi = fr * Bi + fi * Br
    hr, hi = _core(gr, gi, L, +1, prec)      # unnormalized inverse
    hr = hr[..., :n] / L
    hi = hi[..., :n] / L
    return hr * cr - hi * ci, hr * ci + hi * cr


def _dft_mx(x, nfft, sign: int, precision) -> torch.Tensor:
    x = torch.as_tensor(x)
    cdtype = torch.promote_types(x.dtype, torch.complex64)
    x = x.to(cdtype)
    n = int(nfft or x.shape[-1])
    if x.shape[-1] < n:
        x = torch.nn.functional.pad(x, (0, n - x.shape[-1]))
    elif x.shape[-1] > n:
        x = x[..., :n]
    re, im = dft_mx_planar(x.real.contiguous(), x.imag.contiguous(), sign,
                           precision)
    return torch.complex(re, im).to(cdtype)


def fft_mx(x, nfft: int | None = None, precision=None) -> torch.Tensor:
    """Unnormalized forward DFT along the last axis as matrix products (the
    contract of ``ops/fft.py::fft``)."""
    return _dft_mx(x, nfft, -1, precision)


def ifft_mx(x, nfft: int | None = None, precision=None) -> torch.Tensor:
    """Unnormalized inverse DFT (no 1/N, the reference's convention)."""
    return _dft_mx(x, nfft, +1, precision)
