"""The windowed 4096-point FFT on Hopper (K7): wrappers and plain version.

Port of ``solid_dsp_tpu/ops/pallas_fft.py::make_fused_windowed_fft``
(:165-233) and ``fused_windowed_fft`` (:236-244): F frames of N = 4096
points, each multiplied by a window and transformed (unnormalized, natural
bin order, ``sign`` -1 forward or +1 inverse).  Two layouts:

* planar, the contract of ``make_fused_windowed_fft``'s ``apply``:
  x2 (2, F, N) f32 re/im planes -> Y2 (F, 2N) f32 [Re | Im] rows;
* complex, for ``ops/fft.py::windowed_fft``: x (F, N) complex64 ->
  (F, N) complex64, with no split or merge pass around the kernel.

:func:`windowed_fft_cuda` launches ``csrc/windowed_fft.cu`` (persistent
blocks, frames brought in and written out by TMA bulk copies, three
radix-16 Stockham passes a frame in shared memory; the source has the
design) and counts ``windowed_fft_cuda.launches``.  :func:`windowed_fft_plain` is its
plain version: the TPU kernel's four-step (window, stage-A bank product over
n1, twiddle, stage-C bank product over n2, reorder to k1 + 32 k2) in torch
ops, with banks and twiddles built in float64 and cast to the input's type.
A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises (``engine="torch"`` runs the plain version on any device).

Modes: "x3" and "fast" both compute in FP32 here (the transform is bound
by bytes on the card); the JAX package's "fast" is one bf16 pass, so the
port's "fast" is the more accurate result of the same function.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..device import fp32_exact, resolve_device
from .cuda_build import check_launch, launcher, stream_of, use_kernel

__all__ = ["N_FFT", "N1", "N2", "MODES", "twiddle_table_np",
           "windowed_fft_cuda", "windowed_fft_plain", "windowed_fft_frames",
           "make_fused_windowed_fft", "fused_windowed_fft"]

N_FFT = 4096
N1, N2 = 32, 128          # the plain version's four-step split
MODES = ("x3", "fast")
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = (_P,) * 4 + (_LL, _I, _I, _I, _P)


@functools.lru_cache(maxsize=4)
def twiddle_table_np(sign: int) -> np.ndarray:
    """(N, 2) f32 table e^{sign 2 pi i m / N}, m = 0..N-1, built in float64
    from the exact integer m and rounded once (the kernel's only
    twiddles)."""
    m = np.arange(N_FFT, dtype=np.int64)
    t = np.exp(sign * 2j * np.pi * m / N_FFT)
    return np.stack([t.real, t.imag], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _four_step_np(sign: int):
    """Float64 banks of the plain version: F_N1 (N1, N1), F_N2 (N2, N2) and
    the twiddle W[k1, n2] = e^{sign 2 pi i k1 n2 / N} (N1, N2), phases
    reduced exactly in integers."""
    def dft(n):
        j = np.arange(n, dtype=np.int64)
        return np.exp(sign * 2j * np.pi * ((j[:, None] * j[None, :]) % n) / n)

    k1 = np.arange(N1, dtype=np.int64)[:, None]
    n2 = np.arange(N2, dtype=np.int64)[None, :]
    tw = np.exp(sign * 2j * np.pi * ((k1 * n2) % N_FFT) / N_FFT)
    return dft(N1), dft(N2), tw


def _check(x: torch.Tensor, w: torch.Tensor, planar: bool) -> int:
    if planar:
        if x.dim() != 3 or x.shape[0] != 2 or x.shape[2] != N_FFT:
            raise ValueError(f"planar frames must be (2, F, {N_FFT}), got "
                             f"{tuple(x.shape)}")
        F = int(x.shape[1])
    else:
        if x.dim() != 2 or x.shape[1] != N_FFT:
            raise ValueError(f"frames must be (F, {N_FFT}), got "
                             f"{tuple(x.shape)}")
        F = int(x.shape[0])
    if F == 0:
        raise ValueError("no frames")
    if tuple(w.shape) != (N_FFT,):
        raise ValueError(f"window must be ({N_FFT},), got {tuple(w.shape)}")
    return F


@fp32_exact()
def windowed_fft_plain(x: torch.Tensor, w: torch.Tensor, sign: int = -1,
                       planar: bool = True) -> torch.Tensor:
    """Plain version of K7: the four-step N = 32 x 128 of the TPU kernel in
    torch ops, in the input's real type (float32, or float64 for a
    reference), its products with TF32 off (``device.fp32_exact``).  ``planar``: x (2, F, N) real -> (F, 2N); else x (F, N)
    complex -> (F, N) complex."""
    F = _check(x, w, planar)
    if planar:
        xr, xi = x[0], x[1]
    else:
        xr, xi = x.real, x.imag
    rd = xr.dtype
    fa, fc, tw = (torch.from_numpy(a).to(x.device) for a in _four_step_np(
        int(sign)))
    far, fai = fa.real.to(rd), fa.imag.to(rd)
    fcr, fci = fc.real.to(rd), fc.imag.to(rd)
    twr, twi = tw.real.to(rd), tw.imag.to(rd)
    wv = w.to(rd)
    ar = (xr * wv).reshape(F, N1, N2)
    ai = (xi * wv).reshape(F, N1, N2)
    # stage A over n1: B[k1, n2] = sum_n1 F_N1[k1, n1] x[n1, n2]
    br = torch.matmul(far, ar) - torch.matmul(fai, ai)
    bi = torch.matmul(far, ai) + torch.matmul(fai, ar)
    # twiddle W_N^{k1 n2}
    cr = br * twr - bi * twi
    ci = br * twi + bi * twr
    # stage C over n2: D[k1, k2] = sum_n2 C[k1, n2] F_N2[n2, k2]
    dr = torch.matmul(cr, fcr) - torch.matmul(ci, fci)
    di = torch.matmul(cr, fci) + torch.matmul(ci, fcr)
    # X[k1 + N1 k2] = D[k1, k2]
    yr = dr.transpose(-1, -2).reshape(F, N_FFT)
    yi = di.transpose(-1, -2).reshape(F, N_FFT)
    if planar:
        return torch.cat([yr, yi], dim=1)
    return torch.complex(yr, yi)


def windowed_fft_cuda(x: torch.Tensor, w: torch.Tensor, tw: torch.Tensor,
                      sign: int = -1, planar: bool = True) -> torch.Tensor:
    """Launch K7 (``csrc/windowed_fft.cu``): planar x (2, F, N) f32 ->
    (F, 2N) f32, or complex64 x (F, N) -> (F, N) complex64.  ``w`` (N,)
    f32 window, ``tw`` (N, 2) f32 :func:`twiddle_table_np` of the same
    ``sign``; contiguous, on one card, x 16-byte aligned (the kernel's bulk
    copies need it); raises on anything else.  Adds one to
    ``windowed_fft_cuda.launches``."""
    F = _check(x, w, planar)
    if sign not in (-1, 1):
        raise ValueError("sign must be -1 or +1")
    if not (x.is_cuda and w.device == x.device and tw.device == x.device):
        raise ValueError("windowed_fft_cuda needs x, the window and the "
                         "table on one CUDA device; CPU tensors take "
                         "windowed_fft_plain")
    want = torch.float32 if planar else torch.complex64
    if (x.dtype != want or w.dtype != torch.float32
            or tw.dtype != torch.float32):
        raise TypeError(f"windowed_fft_cuda takes {want} frames and float32 "
                        "window and table")
    if tuple(tw.shape) != (N_FFT, 2):
        raise ValueError(f"the twiddle table must be ({N_FFT}, 2)")
    if not (x.is_contiguous() and w.is_contiguous() and tw.is_contiguous()):
        raise ValueError("windowed_fft_cuda needs contiguous tensors")
    if x.data_ptr() % 16:
        raise ValueError("windowed_fft_cuda needs 16-byte-aligned frames "
                         "(TMA bulk copies); windowed_fft_frames copies "
                         "misaligned ones")
    shape = (F, 2 * N_FFT) if planar else (F, N_FFT)
    y = torch.empty(shape, dtype=want, device=x.device)
    fn = launcher("windowed_fft.cu", "windowed_fft_launch", _ARGS)
    check_launch(fn(x.data_ptr(), w.data_ptr(), tw.data_ptr(), y.data_ptr(),
                    F, int(planar), int(sign), x.device.index, stream_of(x)),
                 "windowed_fft_cuda")
    windowed_fft_cuda.launches += 1
    return y


windowed_fft_cuda.launches = 0


@functools.lru_cache(maxsize=16)
def _tables(window_bytes: bytes | None, sign: int, device: torch.device):
    """(window (N,) f32, twiddle table (N, 2) f32) on ``device``; keyed
    without the frame count, which the kernel needs no constant for."""
    w = (np.ones(N_FFT, np.float32) if window_bytes is None
         else np.frombuffer(window_bytes, np.float32))
    return (torch.tensor(w, device=device),
            torch.from_numpy(twiddle_table_np(sign)).to(device))


def windowed_fft_frames(x: torch.Tensor, window=None, sign: int = -1,
                        planar: bool = True,
                        engine: str = "auto") -> torch.Tensor:
    """K7 on frames, the kernel for a CUDA tensor under ``"auto"``:
    ``window`` (N,) numpy or None (rectangular), rounded to f32."""
    wb = (None if window is None
          else np.ascontiguousarray(np.asarray(window, np.float32)).tobytes())
    w, tw = _tables(wb, int(sign), x.device)
    if use_kernel(engine, x):
        x = x.contiguous()
        if x.data_ptr() % 16:       # a view at an odd offset: an aligned copy
            x = x.clone()
        return windowed_fft_cuda(x, w, tw, sign, planar)
    return windowed_fft_plain(x, w, sign, planar)


def make_fused_windowed_fft(N: int, n_frames: int, window=None, TF: int = 16,
                            mode: str = "x3", sign: int = -1,
                            engine: str = "auto"):
    """``apply(x2) -> Y2``: (2, F, N) f32 planes -> (F, 2N) f32 [Re | Im]
    of the windowed, unnormalized N-point DFTs in natural bin order, as the
    JAX package's.  N must be 4096 and ``n_frames`` a multiple of ``TF``
    (the JAX contract; the kernel itself takes any F)."""
    if N != N_FFT:
        raise ValueError("fused windowed FFT currently supports N = 4096")
    F = int(n_frames)
    if F % TF:
        raise ValueError("n_frames must be a multiple of TF")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if sign not in (-1, 1):
        raise ValueError("sign must be -1 or +1")

    def apply(x2: torch.Tensor) -> torch.Tensor:
        if x2.dim() != 3 or int(x2.shape[1]) != F:
            raise ValueError(f"apply takes (2, {F}, {N}) planes")
        return windowed_fft_frames(x2.to(torch.float32), window, sign,
                                   planar=True, engine=engine)

    return apply


def fused_windowed_fft(x, window=None, TF: int = 16, mode: str = "x3",
                       device=None, engine: str = "auto") -> torch.Tensor:
    """Complex wrapper: x (F, N) complex -> (F, N) complex64 spectra of
    ``fft(x * window)`` through K7's complex layout (numpy input goes to
    ``device``, the card unless told otherwise)."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x), device=resolve_device(device))
    F, N = int(x.shape[0]), int(x.shape[-1])
    if N != N_FFT:
        raise ValueError("fused windowed FFT currently supports N = 4096")
    if F % TF:
        raise ValueError("n_frames must be a multiple of TF")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    return windowed_fft_frames(x.to(torch.complex64), window, -1,
                               planar=False, engine=engine)
