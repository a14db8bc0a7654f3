"""The polyphase channelizer kernels on Hopper: wrappers and plain versions.

Ports of two TPU kernels of ``solid_dsp_tpu/ops/pallas_kernels.py``, both
built from ``csrc/channelizer.cu``:

* K5, ``pfb_frontend`` (:55-137, with ``pfb_frontend_taps`` and
  ``channelizer_apply_pallas`` :140-156): the branch products z (U, M)
  complex64 of one block x (L,) complex64 and the (K, M) tail rows; the
  channels are ``torch.fft.fft(z)``.  :func:`pfb_frontend_cuda` launches
  the kernel, :func:`pfb_frontend_torch` is its plain version.
* K4, ``make_pallas_channelizer`` (:318-460, with ``CHAN_HALO``,
  ``_chan_banks_np`` and ``_chan_hp2_np``): the fused channelizer, the
  same branch filter on planar frame rows xf (2, U, M) with the (2, 8, M)
  carried tail rows, then the forward DFT bank, written as Y2 (U, 2M)
  [Re | Im].  :class:`ChanBody` holds its constants; :func:`chan_fused_cuda`
  launches the kernel, :func:`chan_fused_torch` is its plain version
  (a shifted multiply-add per tap, then two matmuls).

With the prototype H[k, r] = h[k M + r], the permuted (K+1)-tap filter
Hp2 (:func:`chan_hp2_np`) gives zp[u, q] = sum_k Hp2[k, q] x[u - k, q] on
frame rows x[u, q] = x[u M + q], and the channel outputs are the plain
forward DFT Y[u, m] = sum_q zp[u, q] e^{-2 pi i q m / M} (the TPU module's
docstring has the derivation).

A wrapper takes its plain version only for CPU tensors (``engine="auto"``);
for CUDA tensors it launches its kernel or raises.  ``engine="torch"``
runs the plain version on any device (the reference on the card).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from .cuda_build import ENGINES, check_launch, launcher, stream_of, use_kernel

__all__ = ["CHAN_HALO", "pfb_frontend_taps", "chan_hp2_np", "chan_banks_np",
           "pfb_frontend", "pfb_frontend_torch", "pfb_frontend_cuda",
           "channelizer_apply_pallas", "ChanBody", "make_chan_body",
           "chan_fused_torch", "chan_fused_cuda", "ENGINES"]

CHAN_HALO = 8           # carried tail rows of the fused channelizer
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FRONTEND_ARGS = (_P,) * 4 + (_LL, _I, _I, _I, _P)
_FUSED_ARGS = (_P,) * 5 + (_LL, _I, _I, _I, _I, _P)


def pfb_frontend_taps(taps: np.ndarray, num_channels: int) -> np.ndarray:
    """Prototype taps -> the permuted bank Hp2 with each branch lane q
    duplicated onto the interleaved re/im lanes (2q, 2q+1): float32
    (K+1, 2M) (``pallas_kernels.py:55-69``)."""
    hp2, _ = chan_hp2_np(taps, num_channels)
    return np.repeat(hp2, 2, axis=1)


def chan_hp2_np(taps: np.ndarray, num_channels: int):
    """(K+1, M) float32 permuted per-lane filter and K: lane 0 takes H[:, 0]
    unshifted, lane q > 0 takes H[:, M - q] one row later
    (``pallas_kernels.py:334-345``)."""
    M = int(num_channels)
    h = np.asarray(taps, dtype=np.float64).real
    K = len(h) // M
    H = h[: K * M].reshape(K, M)
    Hp2 = np.zeros((K + 1, M), np.float64)
    Hp2[:K, 0] = H[:, 0]
    Hp2[1:, 1:] = H[:, :0:-1]
    return Hp2.astype(np.float32), K


def chan_banks_np(num_channels: int):
    """Folded DFT banks (M, 2M) float32: out_r = [C | S], out_i = [-S | C]
    with C + iS = e^{-2 pi i q m / M}, so that
    Y2 = zr @ out_r + zi @ out_i (``pallas_kernels.py:321-331``)."""
    M = num_channels
    q = np.arange(M)[:, None]
    m = np.arange(M)[None, :]
    B = np.exp(-2j * np.pi * q * m / M)
    out_r = np.concatenate([B.real, B.imag], axis=1).astype(np.float32)
    out_i = np.concatenate([-B.imag, B.real], axis=1).astype(np.float32)
    return out_r, out_i


# ------------------------------------------------------------- K5 front end

def _check_frontend(x, h_il, tail_rows, M: int, K: int) -> int:
    L = int(x.shape[-1])
    if x.dim() != 1 or L % M or L == 0:
        raise ValueError("block length must be a positive multiple of M")
    if tuple(h_il.shape) != (K + 1, 2 * M):
        raise ValueError(f"h_il must be ({K + 1}, {2 * M}), got "
                         f"{tuple(h_il.shape)}")
    if tuple(tail_rows.shape) != (K, M):
        raise ValueError(f"tail_rows must be ({K}, {M}), got "
                         f"{tuple(tail_rows.shape)}")
    return L // M


def pfb_frontend_torch(x: torch.Tensor, h_il: torch.Tensor,
                       tail_rows: torch.Tensor, num_channels: int,
                       taps_per_branch: int) -> torch.Tensor:
    """Plain version of K5: z (U, M) complex64 from x (L,) complex64, h_il
    (K+1, 2M) f32 and tail_rows (K, M) complex64, on the interleaved
    float lanes as the TPU kernel reads them."""
    M, K = num_channels, taps_per_branch
    U = _check_frontend(x, h_il, tail_rows, M, K)
    x2 = torch.view_as_real(x).reshape(U, 2 * M)
    t2 = torch.view_as_real(tail_rows).reshape(K, 2 * M)
    xp = torch.cat([t2, x2], dim=0)                     # (U + K, 2M)
    acc = xp[K: K + U] * h_il[0]
    for kp in range(1, K + 1):
        acc = acc + xp[K - kp: K - kp + U] * h_il[kp]
    return torch.view_as_complex(acc.reshape(U, M, 2).contiguous())


def pfb_frontend_cuda(x: torch.Tensor, h_il: torch.Tensor,
                      tail_rows: torch.Tensor, num_channels: int,
                      taps_per_branch: int) -> torch.Tensor:
    """Launch K5 (``csrc/channelizer.cu``): z (U, M) complex64.  Takes
    contiguous complex64 x and tail rows and f32 h_il on one card, raises
    on anything else.  Adds one to ``pfb_frontend_cuda.launches``."""
    M, K = num_channels, taps_per_branch
    U = _check_frontend(x, h_il, tail_rows, M, K)
    if not (x.is_cuda and h_il.device == x.device
            and tail_rows.device == x.device):
        raise ValueError("pfb_frontend_cuda needs x, h_il and tail_rows on "
                         "one CUDA device; CPU tensors take "
                         "pfb_frontend_torch")
    if (x.dtype != torch.complex64 or tail_rows.dtype != torch.complex64
            or h_il.dtype != torch.float32):
        raise TypeError("pfb_frontend_cuda takes complex64 x and tail rows "
                        "and float32 taps")
    if not (x.is_contiguous() and h_il.is_contiguous()
            and tail_rows.is_contiguous()):
        raise ValueError("pfb_frontend_cuda needs contiguous tensors")
    z = torch.empty((U, M), dtype=torch.complex64, device=x.device)
    fn = launcher("channelizer.cu", "pfb_frontend_launch", _FRONTEND_ARGS)
    check_launch(fn(x.data_ptr(), tail_rows.data_ptr(), h_il.data_ptr(),
                    z.data_ptr(), U, M, K, x.device.index, stream_of(x)),
                 "pfb_frontend_cuda")
    pfb_frontend_cuda.launches += 1
    return z


pfb_frontend_cuda.launches = 0


def pfb_frontend(x, h_il, tail_rows, num_channels: int, taps_per_branch: int,
                 engine: str = "auto"):
    """Branch products of one block (``pallas_kernels.py:88-137``):
    (z (U, M) complex64, new_tail_rows (K, M)), with ``fft(z, dim=-1)``
    the M channel outputs."""
    M, K = num_channels, taps_per_branch
    if use_kernel(engine, x):
        z = pfb_frontend_cuda(x, h_il, tail_rows, M, K)
    else:
        z = pfb_frontend_torch(x, h_il, tail_rows, M, K)
    U = z.shape[0]
    if U >= K:
        new_tail = x[(U - K) * M:].reshape(K, M).clone()
    else:
        new_tail = torch.cat([tail_rows[U:], x.reshape(U, M)], dim=0)
    return z, new_tail


def channelizer_apply_pallas(taps_h_il, tail_rows, x, num_channels: int,
                             taps_per_branch: int, engine: str = "auto"):
    """One channelizer block through K5 and ``torch.fft.fft``
    (``pallas_kernels.py:140-156``): (Y (U, M) complex64, new_tail_rows)."""
    z, new_tail = pfb_frontend(x, taps_h_il, tail_rows, num_channels,
                               taps_per_branch, engine)
    return torch.fft.fft(z, dim=-1), new_tail


# ------------------------------------------------------- K4 fused channelizer

@dataclass(frozen=True, eq=False)
class ChanBody:
    """Constants of one fused channelizer, on one device in one dtype."""

    M: int
    K: int
    mode: str                # "x3" (FP32) | "fast" (bf16 z and bank)
    hp: torch.Tensor         # (K+1, M) permuted branch filter
    bank_r: torch.Tensor     # (M, 2M) [C | S], bf16-rounded for "fast"
    bank_i: torch.Tensor     # (M, 2M) [-S | C], the plain version's

    def __call__(self, xf: torch.Tensor, tail_rows: torch.Tensor,
                 engine: str = "auto") -> torch.Tensor:
        """Y2 (U, 2M) of the frame rows xf (2, U, M) and the carried tail
        rows (2, 8, M): the kernel for CUDA tensors under ``"auto"``."""
        if use_kernel(engine, xf):
            return chan_fused_cuda(self, xf, tail_rows)
        return chan_fused_torch(self, xf, tail_rows)


@functools.lru_cache(maxsize=16)
def _chan_body_np(taps_bytes: bytes, M: int, mode: str):
    hp2, K = chan_hp2_np(np.frombuffer(taps_bytes, np.float64), M)
    out_r, out_i = chan_banks_np(M)
    if mode == "fast":
        out_r, out_i = (torch.from_numpy(b).to(torch.bfloat16).float()
                        .numpy() for b in (out_r, out_i))
    return hp2, K, out_r, out_i


def make_chan_body(taps: np.ndarray, num_channels: int, mode: str = "fast",
                   device=None, dtype: torch.dtype = torch.float32
                   ) -> ChanBody:
    """Design-time constants of the fused channelizer on ``device`` (the
    card unless told otherwise): ``mode`` "x3" or "fast", K <= CHAN_HALO
    (``pallas_kernels.py:384-400``)."""
    if mode not in ("x3", "fast"):
        raise ValueError(f"unknown mode {mode!r}")
    M = int(num_channels)
    device = resolve_device(device)
    h = np.ascontiguousarray(np.asarray(taps).real, np.float64)
    hp2, K, out_r, out_i = _chan_body_np(h.tobytes(), M, mode)
    if K > CHAN_HALO:
        raise ValueError(f"taps_per_branch must be <= {CHAN_HALO}")

    def dev(a):     # float64 holds the float32 constants exactly
        return torch.tensor(a, dtype=dtype, device=device)

    return ChanBody(M=M, K=K, mode=mode, hp=dev(hp2), bank_r=dev(out_r),
                    bank_i=dev(out_i))


def _check_fused(body: ChanBody, xf, tail_rows) -> int:
    if xf.dim() != 3 or xf.shape[0] != 2 or xf.shape[2] != body.M:
        raise ValueError(f"xf must be (2, U, {body.M}), got "
                         f"{tuple(xf.shape)}")
    if tuple(tail_rows.shape) != (2, CHAN_HALO, body.M):
        raise ValueError(f"tail_rows must be (2, {CHAN_HALO}, {body.M}), "
                         f"got {tuple(tail_rows.shape)}")
    return int(xf.shape[1])


def chan_fused_torch(body: ChanBody, xf: torch.Tensor,
                     tail_rows: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: the (K+1)-tap filter as shifted multiply-adds
    over the frame rows, then zr @ [C | S] + zi @ [-S | C] (z rounded to
    bf16 first in "fast"); float32 or float64 as the body."""
    U = _check_fused(body, xf, tail_rows)
    xcat = torch.cat([tail_rows, xf], dim=1)           # (2, 8 + U, M)
    H = CHAN_HALO
    acc = body.hp[0] * xcat[:, H: H + U]
    for kp in range(1, body.K + 1):
        acc = acc + body.hp[kp] * xcat[:, H - kp: H - kp + U]
    if body.mode == "fast":
        acc = acc.to(torch.bfloat16).to(body.bank_r.dtype)
    return torch.matmul(acc[0], body.bank_r) + torch.matmul(acc[1],
                                                            body.bank_i)


def chan_fused_cuda(body: ChanBody, xf: torch.Tensor,
                    tail_rows: torch.Tensor) -> torch.Tensor:
    """Launch K4 (``csrc/channelizer.cu``): Y2 (U, 2M) f32.  Takes
    contiguous f32 CUDA tensors on the body's card and raises on anything
    else.  Adds one to ``chan_fused_cuda.launches``."""
    U = _check_fused(body, xf, tail_rows)
    if not (xf.is_cuda and tail_rows.device == xf.device
            and body.hp.device == xf.device):
        raise ValueError("chan_fused_cuda needs xf, tail_rows and the body "
                         "on one CUDA device; CPU tensors take "
                         "chan_fused_torch")
    if (xf.dtype != torch.float32 or tail_rows.dtype != torch.float32
            or body.hp.dtype != torch.float32):
        raise TypeError("chan_fused_cuda computes in float32")
    if not (xf.is_contiguous() and tail_rows.is_contiguous()):
        raise ValueError("chan_fused_cuda needs contiguous xf and tail_rows")
    y = torch.empty((U, 2 * body.M), dtype=torch.float32, device=xf.device)
    fn = launcher("channelizer.cu", "chan_fused_launch", _FUSED_ARGS)
    check_launch(fn(xf.data_ptr(), tail_rows.data_ptr(), body.hp.data_ptr(),
                    body.bank_r.data_ptr(), y.data_ptr(), U, body.M, body.K,
                    int(body.mode == "fast"), xf.device.index, stream_of(xf)),
                 "chan_fused_cuda")
    chan_fused_cuda.launches += 1
    return y


chan_fused_cuda.launches = 0
