"""Real trigonometric transforms: DCT and DST types 1-4 (FFTW's REDFT and
RODFT, unnormalized) and the lapped MDCT / IMDCT.

Port of ``solid_dsp_tpu/ops/trig_transforms.py``, with its routes: DCT-I,
DCT-II and DST-I embed into a real FFT (``torch.fft.rfft``) unless
``backend="matmul"``; the other kinds, and those three under "matmul",
are one product with a cosine or sine matrix built on the host in float64
(cached) and rounded to the input's type.  The products run at full float32
on the card (:func:`~solid_dsp_tpu_torch.device.fp32_exact`), as JAX runs
them at ``precision="highest"``.  Tensor functions: they run where their
input lies.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..device import device_constant, fp32_exact

__all__ = ["dct", "dst", "mdct", "imdct", "mdct_window"]


@lru_cache(maxsize=64)
def _trig_matrix(kind: str, n: int) -> np.ndarray:
    """The (n, n) float64 matrix of ``kind`` (output index by input index)."""
    k = np.arange(n)[:, None].astype(np.float64)
    m = np.arange(n)[None, :].astype(np.float64)
    if kind == "dct1":
        M = 2.0 * np.cos(np.pi * m * k / (n - 1))
        M[:, 0] = 1.0
        M[:, -1] = (-1.0) ** k[:, 0]
        return M
    if kind == "dct2":
        return 2.0 * np.cos(np.pi * (m + 0.5) * k / n)
    if kind == "dct3":
        M = 2.0 * np.cos(np.pi * m * (k + 0.5) / n)
        M[:, 0] = 1.0
        return M
    if kind == "dct4":
        return 2.0 * np.cos(np.pi * (m + 0.5) * (k + 0.5) / n)
    if kind == "dst1":
        return 2.0 * np.sin(np.pi * (m + 1.0) * (k + 1.0) / (n + 1))
    if kind == "dst2":
        return 2.0 * np.sin(np.pi * (m + 0.5) * (k + 1.0) / n)
    if kind == "dst3":
        M = 2.0 * np.sin(np.pi * (m + 1.0) * (k + 0.5) / n)
        M[:, -1] = (-1.0) ** k[:, 0]
        return M
    if kind == "dst4":
        return 2.0 * np.sin(np.pi * (m + 0.5) * (k + 0.5) / n)
    raise ValueError(kind)


@lru_cache(maxsize=32)
def _matrix_t(kind: str, n: int, device: torch.device, dtype: torch.dtype
              ) -> torch.Tensor:
    """M.T of ``kind`` ("dct1".."dst4", "mdct", "imdct") rounded to
    ``dtype`` on ``device``, built once."""
    if kind == "mdct":
        M = _mdct_matrix(n)
    elif kind == "imdct":
        M = _mdct_matrix(n).T * (2.0 / n)
    else:
        M = _trig_matrix(kind, n)
    return torch.from_numpy(np.ascontiguousarray(M.T)).to(device, dtype)


def _matmul_transform(kind: str, x: torch.Tensor, n: int | None = None
                      ) -> torch.Tensor:
    """x @ M.T at full float32."""
    Mt = _matrix_t(kind, x.shape[-1] if n is None else n, x.device, x.dtype)
    with fp32_exact():
        return torch.matmul(x, Mt)


def _dct1_fft(x):
    # symmetric extension of length 2(n-1): [x0 .. x_{n-1}, x_{n-2} .. x1]
    ext = torch.cat([x, x[..., 1:-1].flip(-1)], dim=-1)
    return torch.fft.rfft(ext, dim=-1).real


def _dct2_fft(x):
    n = x.shape[-1]
    F = torch.fft.rfft(torch.cat([x, x.flip(-1)], dim=-1), dim=-1)[..., :n]
    tw = device_constant(np.exp(-1j * np.pi * np.arange(n) / (2 * n)),
                         x.device, F.dtype)
    return (F * tw).real


def _dst1_fft(x):
    n = x.shape[-1]
    z = torch.zeros_like(x[..., :1])
    ext = torch.cat([z, x, z, -x.flip(-1)], dim=-1)       # length 2(n+1)
    return -torch.fft.rfft(ext, dim=-1).imag[..., 1: n + 1]


def dct(x: torch.Tensor, type: int = 2, backend: str = "auto"
        ) -> torch.Tensor:
    """REDFT (FFTW's convention, unnormalized) DCT along the last axis."""
    x = torch.as_tensor(x)
    if type == 1:
        if x.shape[-1] < 2:
            raise ValueError("DCT-I requires n >= 2")
        return (_dct1_fft(x) if backend != "matmul"
                else _matmul_transform("dct1", x))
    if type == 2:
        return (_dct2_fft(x) if backend != "matmul"
                else _matmul_transform("dct2", x))
    if type in (3, 4):
        return _matmul_transform(f"dct{type}", x)
    raise ValueError("DCT type must be 1..4")


def dst(x: torch.Tensor, type: int = 2, backend: str = "auto"
        ) -> torch.Tensor:
    """RODFT (FFTW's convention, unnormalized) DST along the last axis."""
    x = torch.as_tensor(x)
    if type == 1:
        return (_dst1_fft(x) if backend != "matmul"
                else _matmul_transform("dst1", x))
    if type in (2, 3, 4):
        return _matmul_transform(f"dst{type}", x)
    raise ValueError("DST type must be 1..4")


def mdct_window(n: int) -> np.ndarray:
    """Sine window w[j] = sin(pi/(2N) (j + 1/2)) over 2N points (TDAC)."""
    j = np.arange(2 * n)
    return np.sin(np.pi / (2 * n) * (j + 0.5))


@lru_cache(maxsize=32)
def _mdct_matrix(n: int) -> np.ndarray:
    """(N, 2N): cos(pi/N (j + 1/2 + N/2)(k + 1/2))."""
    j = np.arange(2 * n)[None, :].astype(np.float64)
    k = np.arange(n)[:, None].astype(np.float64)
    return np.cos(np.pi / n * (j + 0.5 + n / 2.0) * (k + 0.5))


def mdct(x: torch.Tensor, window: np.ndarray | None = None) -> torch.Tensor:
    """Lapped MDCT along the last axis: 2N (windowed) inputs -> N
    coefficients, X[k] = sum_j w[j] x[j] cos(pi/N (j + 1/2 + N/2)(k + 1/2))."""
    x = torch.as_tensor(x)
    n2 = x.shape[-1]
    if n2 % 2:
        raise ValueError("MDCT input length must be even (2N)")
    if window is not None:
        x = x * device_constant(np.asarray(window), x.device, x.dtype)
    return _matmul_transform("mdct", x, n2 // 2)


def imdct(X: torch.Tensor, window: np.ndarray | None = None) -> torch.Tensor:
    """Inverse MDCT: N coefficients -> 2N aliased samples,
    y[j] = (2/N) sum_k X[k] cos(pi/N (j + 1/2 + N/2)(k + 1/2)); windowed
    frames overlap-added at hop N reconstruct the input (TDAC)."""
    y = _matmul_transform("imdct", torch.as_tensor(X))
    if window is not None:
        y = y * device_constant(np.asarray(window), y.device, y.dtype)
    return y
