"""FIR building blocks: the carried tail, the sliding correlation, and the
host-side banded-Toeplitz banks.

Port of ``solid_dsp_tpu/ops/fir.py``: ``fir_init`` and ``conv1d_mxu``
(:58-133; XLA-level in JAX, a ``torch.nn.functional.conv1d`` here), and
``_banks_np`` and ``_bank_rem_np``, whose banks the plain versions of the
DDC bodies (``ops/cuda_ddc.py``, ``ops/ddc.py``) multiply input frames by.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import fp32_exact, resolve_device

__all__ = ["fir_init", "conv1d_mxu"]


def fir_init(ntaps: int, dtype=torch.complex64, batch_shape: tuple = (),
             device=None) -> torch.Tensor:
    """Zero tail of length ntaps - 1 (the reference's zeroed Window), on
    ``device``: the card unless told otherwise."""
    return torch.zeros((*batch_shape, max(ntaps - 1, 0)), dtype=dtype,
                       device=resolve_device(device))


def conv1d_mxu(x: torch.Tensor, taps: torch.Tensor, stride: int = 1,
               precision=None) -> torch.Tensor:
    """Strided sliding correlation
    ``y[..., t(, o)] = sum_i taps[i(, o)] * x[..., t*stride + i]`` for
    taps (n,) or (n, O), over the valid outputs only.

    Complex data or taps run as a 2-channel real convolution, out_re =
    xr*kr - xi*ki and out_im = xr*ki + xi*kr, as in JAX.  ``precision``:
    None or "highest" computes in the working float type: the convolution
    runs under :func:`~solid_dsp_tpu_torch.device.fp32_exact`, so cuDNN's
    TF32 stays off whatever the caller set; "default" rounds both operands
    to bf16 first, the single-pass bf16 the JAX package names so.
    """
    if precision not in (None, "highest", "default"):
        raise ValueError(f"unknown precision {precision!r}")
    vec = taps.dim() == 1
    taps2 = taps[:, None] if vec else taps
    n, O = taps2.shape
    lead = x.shape[:-1]
    L = x.shape[-1]
    T = (L - n) // stride + 1
    cplx = x.is_complex() or taps2.is_complex()
    if cplx:
        cd = torch.promote_types(torch.promote_types(x.dtype, taps2.dtype),
                                 torch.complex64)
        xb = torch.view_as_real(x.reshape(-1, L).to(cd)).transpose(1, 2)
        k = taps2.to(cd)
        kr, ki = k.real.T, k.imag.T                           # (O, n)
        w = torch.cat([torch.stack([kr, -ki], dim=1),
                       torch.stack([ki, kr], dim=1)])         # (2O, 2, n)
    else:
        xb = x.reshape(-1, 1, L)
        w = taps2.to(x.dtype).T[:, None, :]                   # (O, 1, n)
    if precision == "default":
        xb = xb.to(torch.bfloat16).to(xb.dtype)
        w = w.to(torch.bfloat16).to(w.dtype)
    with fp32_exact():
        y = torch.nn.functional.conv1d(xb.contiguous(), w.contiguous(),
                                       stride=stride)         # (B, C_out, T)
    if cplx:
        y = torch.complex(y[:, :O], y[:, O:])
    y = y.transpose(1, 2).reshape(*lead, T, O)
    return y[..., 0] if vec else y


def _banks_np(taps2: np.ndarray, P: int, stride: int):
    """Body (hop, P*O) and head (n-1, P*O) rows of the banded-Toeplitz bank
    H[j, p*O + o] = taps2[j - p*stride, o], hop = P*stride: output p of a
    frame reads frame-local input rows [p*stride, p*stride + n)."""
    n, O = taps2.shape
    hop = P * stride
    H = np.zeros((hop + n - 1, P * O), taps2.dtype)
    for p in range(P):
        H[p * stride : p * stride + n, p * O : (p + 1) * O] = taps2
    return H[:hop], H[hop:]


def _bank_rem_np(taps2: np.ndarray, Tr: int, stride: int):
    """Bank (width_r, Tr*O) of Tr outputs over the (Tr-1)*stride + n input
    samples they read: the head and straggler pieces of a block."""
    n, O = taps2.shape
    wr = (Tr - 1) * stride + n
    H = np.zeros((wr, Tr * O), taps2.dtype)
    for p in range(Tr):
        H[p * stride : p * stride + n, p * O : (p + 1) * O] = taps2
    return H
