"""Linear prediction and parametric (AR) spectral estimation.

Port of ``solid_dsp_tpu/analysis/lpc.py``: the biased autocorrelation,
Levinson-Durbin, autocorrelation-method LPC, Burg's method, AR power
spectra, the step-up recursion and the analysis (FIR) and synthesis (IIR)
lattices.  Conventions: A(z) = 1 + a_1 z^-1 + ... + a_p z^-p is the
prediction-error filter, the model sigma^2 / |A|^2, the Hermitian
convention for complex signals.  Everything batches over leading axes and
runs where its input lies.

The order recursions (JAX's ``fori_loop`` over p) are Python loops of p
vectorised steps; ``lattice_fir`` is p elementwise passes over the block.
``lattice_iir`` is the one per-sample recurrence (the p backward errors
carried): S5, a CUDA kernel of ``csrc/track_scan.cu``
(``ops/cuda_track.py::lattice_iir_cuda``) on a CUDA tensor; a CPU tensor
takes :func:`lattice_iir_plain`, the same walk as a torch loop over time.
"""

from __future__ import annotations

import torch

from ..ops import cuda_track
from ..ops.cuda_build import use_kernel

__all__ = ["acf", "levinson", "lpc", "burg", "ar_psd",
           "lattice_fir", "lattice_iir", "reflection_to_poly",
           "lattice_iir_plain"]


def acf(x: torch.Tensor, order: int, normalize: bool = True
        ) -> torch.Tensor:
    """Biased sample autocorrelation r[0..order] along the last axis,
    r[k] = (1/N) sum_n x[n+k] conj(x[n]): (..., N) -> (..., order+1)."""
    x = torch.as_tensor(x)
    n = x.shape[-1]
    if order >= n:
        raise ValueError(f"order {order} needs at least order+1 samples, "
                         f"got {n}")
    r = torch.stack([torch.sum(x[..., k:] * torch.conj(x[..., : n - k]),
                               dim=-1) for k in range(order + 1)], dim=-1)
    return r / n if normalize else r


def _tiny(e: torch.Tensor) -> torch.Tensor:
    return torch.clamp(e, min=torch.finfo(e.dtype).tiny)


def _step_up(a: torch.Tensor, km: torch.Tensor, m: int) -> torch.Tensor:
    """a <- a + km J conj(a) on entries 1..m (J reverses the first m+1)."""
    a = a.clone()
    a[..., 1:m + 1] = a[..., 1:m + 1] + km[..., None] * torch.conj(
        a[..., :m]).flip(-1)
    return a


def _unit_poly(shape, p: int, dtype, device) -> torch.Tensor:
    a = torch.zeros(tuple(shape) + (p + 1,), dtype=dtype, device=device)
    a[..., 0] = 1.0
    return a


def levinson(r: torch.Tensor):
    """Levinson-Durbin on autocorrelations r (..., p+1): (a (..., p+1) with
    a[..., 0] = 1, k (..., p) the reflection coefficients, e (...,) the
    final prediction error power, real)."""
    r = torch.as_tensor(r)
    p = r.shape[-1] - 1
    a = _unit_poly(r.shape[:-1], p, r.dtype, r.device)
    e = torch.real(r[..., 0])
    ks = []
    for m in range(1, p + 1):
        acc = torch.sum(a[..., :m] * r[..., 1:m + 1].flip(-1), dim=-1)
        km = (-acc / _tiny(e)).to(r.dtype)
        a = _step_up(a, km, m)
        e = e * (1.0 - torch.abs(km) ** 2)
        ks.append(km)
    k = torch.stack(ks, -1) if ks else r.new_zeros(r.shape[:-1] + (0,))
    return a, k, e


def lpc(x: torch.Tensor, order: int):
    """Autocorrelation-method LPC: (a, k, e) of x (..., N); e is the
    prediction error power a sample (the model is ar_psd(a, e))."""
    return levinson(acf(x, order))


def burg(x: torch.Tensor, order: int):
    """Burg's method: the reflection coefficients from the data, each order
    minimising the forward and backward errors together; x (..., N) ->
    (a (..., p+1), k (..., p), e (...,))."""
    x = torch.as_tensor(x)
    n = x.shape[-1]
    p = int(order)
    if p >= n:
        raise ValueError(f"order {p} needs more than order samples, got {n}")
    f = b = x
    a = _unit_poly(x.shape[:-1], p, x.dtype, x.device)
    e = torch.real(torch.sum(x * torch.conj(x), dim=-1)) / n
    ks = []
    for m in range(1, p + 1):
        b1 = torch.roll(b, 1, dims=-1)
        fv, bv = f[..., m:], b1[..., m:]
        num = torch.sum(fv * torch.conj(bv), dim=-1)
        den = torch.sum(torch.abs(fv) ** 2 + torch.abs(bv) ** 2, dim=-1)
        km = (-2.0 * num / _tiny(den)).to(x.dtype)
        f, b = f + km[..., None] * b1, b1 + torch.conj(km)[..., None] * f
        a = _step_up(a, km, m)
        e = e * (1.0 - torch.abs(km) ** 2)
        ks.append(km)
    k = torch.stack(ks, -1) if ks else x.new_zeros(x.shape[:-1] + (0,))
    return a, k, e


def ar_psd(a: torch.Tensor, sigma2, nfft: int = 1024) -> torch.Tensor:
    """sigma2 / |A(e^{j 2 pi f})|^2 at f = k/nfft in [0, 1): a (..., p+1),
    sigma2 (...,) -> (..., nfft)."""
    a = torch.as_tensor(a)
    A = torch.fft.fft(a, n=nfft, dim=-1)
    P = torch.abs(A) ** 2
    sig = torch.as_tensor(sigma2, device=a.device)
    return sig[..., None] / torch.clamp(P, min=torch.finfo(P.dtype).tiny)


def reflection_to_poly(k: torch.Tensor) -> torch.Tensor:
    """Reflection coefficients (..., p) -> prediction-error polynomial
    (..., p+1): the step-up recursion."""
    k = torch.as_tensor(k)
    p = k.shape[-1]
    a = _unit_poly(k.shape[:-1], p, k.dtype, k.device)
    for m in range(1, p + 1):
        a = _step_up(a, k[..., m - 1], m)
    return a


def lattice_fir(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The analysis (prediction-error) lattice with reflection coefficients
    k (..., p) over x (..., N), zero initial state: x convolved with
    reflection_to_poly(k), cut to N.  p elementwise passes."""
    x = torch.as_tensor(x)
    k = torch.as_tensor(k, device=x.device)
    f = b = x
    for m in range(k.shape[-1]):
        km = k[..., m][..., None]
        b1 = torch.roll(b, 1, dims=-1)
        b1[..., 0] = 0.0
        f, b = f + km * b1, b1 + torch.conj(km) * f
    return f


def _lattice_operands(y, k):
    y = torch.as_tensor(y)
    k = torch.as_tensor(k, device=y.device)
    dt = torch.promote_types(y.dtype, k.dtype)
    return y.to(dt), k.to(dt)


def lattice_iir_plain(y: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """S5's plain version: the synthesis lattice as a torch loop over time.
    Each step descends f_p = y[n], f_{m-1} = f_m - k_m b_{m-1}[n-1] to
    x[n] = f_0, then ascends b_m[n] = b_{m-1}[n-1] + conj(k_m) f_{m-1}[n]."""
    y, k = _lattice_operands(y, k)
    p = k.shape[-1]
    b = [torch.zeros(y.shape[:-1], dtype=y.dtype, device=y.device)
         for _ in range(p)]
    kc = torch.conj(k)
    xs = []
    for n in range(y.shape[-1]):
        f = y[..., n]
        fs = [None] * p
        for m in range(p - 1, -1, -1):
            f = f - k[..., m] * b[m]
            fs[m] = f
        b = [f] + [b[m - 1] + kc[..., m - 1] * fs[m - 1] for m in range(1, p)]
        xs.append(f)
    if not xs:
        return y.clone()
    return torch.stack(xs, dim=-1)


def lattice_iir(y: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The synthesis (all-pole) lattice, the inverse of ``lattice_fir``: y
    (..., N), k (..., p) -> x with lattice_fir(x, k) == y.  S5 on a CUDA
    tensor (orders up to 64 in registers, above it the kernel's generic
    path)."""
    y, k = _lattice_operands(y, k)
    if use_kernel("auto", y):
        return cuda_track.lattice_iir_cuda(y, k)
    return lattice_iir_plain(y, k)
