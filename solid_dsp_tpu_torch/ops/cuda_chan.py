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
  same branch filter on frame rows with the (2, 8, M) carried tail rows,
  then the forward DFT bank: planar xf (2, U, M) -> Y2 (U, 2M) [Re | Im],
  the JAX contract, or complex64 x (U, M) -> Y (U, M).  :class:`ChanBody`
  holds its constants, the bf16 hi/lo banks packed for the tensor cores
  among them (:func:`chan_bank_tiles`); :func:`chan_fused_cuda` launches
  the kernel, :func:`chan_fused_torch` is its plain version (a shifted
  multiply-add per tap, then two matmuls).

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

from ..device import fp32_exact, resolve_device
from .cuda_build import ENGINES, check_launch, launcher, stream_of, use_kernel

__all__ = ["CHAN_HALO", "pfb_frontend_taps", "chan_hp2_np", "chan_banks_np",
           "chan_split_np", "chan_bank_tiles",
           "pfb_frontend", "pfb_frontend_torch", "pfb_frontend_cuda",
           "channelizer_apply_pallas", "ChanBody", "make_chan_body",
           "chan_fused_torch", "chan_fused_cuda", "ENGINES"]

CHAN_HALO = 8           # carried tail rows of the fused channelizer
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FRONTEND_ARGS = (_P,) * 4 + (_LL, _I, _I, _I, _P)
_FUSED_ARGS = (_P,) * 5 + (_LL, _I, _I, _I, _I, _I, _P)


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

TILE_COLS, TILE_DEPTH = 256, 32      # the kernel's output and depth tiles


def chan_split_np(num_channels: int, mode: str):
    """The bf16 banks of one mode as JAX's ``make_pallas_channelizer``
    builds them (:401-416), as uint16 bit patterns: x3 (brh, brl, bih, bil)
    with hi = bf16(a) and lo = bf16(a - hi), fast (br, bi) = bf16(a); each
    (M, 2M), rounded to nearest even."""
    def bf16_bits(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            torch.bfloat16).view(torch.int16).numpy().view(np.uint16)

    def value(bits):
        return (bits.astype(np.uint32) << 16).view(np.float32)

    out = []
    for b in chan_banks_np(num_channels):
        hi = bf16_bits(b)
        out += [hi, bf16_bits(b - value(hi))] if mode == "x3" else [hi]
    return tuple(out)


def _chunk_lanes(M: int):
    """(plane, lane) of each depth index of the kernel's product: chunk c
    is plane c & 1 (zr, zi) of lanes (c >> 1) * 32 .. +31, lane -1 past
    M."""
    n_chunks = 2 * (-(-M // TILE_DEPTH))
    c, ql = np.divmod(np.arange(n_chunks * TILE_DEPTH), TILE_DEPTH)
    q = (c >> 1) * TILE_DEPTH + ql
    return c & 1, np.where(q < M, q, -1), n_chunks


def chan_bank_tiles(num_channels: int, mode: str) -> np.ndarray:
    """The kernel's B operand: the split banks of :func:`chan_split_np` as
    (column tile, chunk, hi | lo, 8192) uint16, each tile 256 columns n =
    2m + (0 re | 1 im) by 32 depth indices in wgmma's K-major core-matrix
    layout, [k // 8][n // 8][n % 8][k % 8]; zero past M and 2M."""
    M = int(num_channels)
    banks = chan_split_np(M, mode)
    hl = len(banks) // 2                        # 2 for x3, 1 for fast
    plane, q, n_chunks = _chunk_lanes(M)
    n_tiles = -(-2 * M // TILE_COLS)
    B = np.zeros((hl, n_tiles * TILE_COLS, n_chunks * TILE_DEPTH), np.uint16)
    ok = q >= 0
    m = np.arange(M)
    for h in range(hl):
        for p in (0, 1):
            bank = banks[p * hl + h]            # (M, 2M): [q, m] re, [q, M+m] im
            cols = np.flatnonzero(ok & (plane == p))
            B[h, 2 * m[:, None], cols[None, :]] = bank[q[cols]][:, :M].T
            B[h, 2 * m[:, None] + 1, cols[None, :]] = bank[q[cols]][:, M:].T
    t = B.reshape(hl, n_tiles, TILE_COLS // 8, 8, n_chunks, TILE_DEPTH // 8, 8)
    #            h   nt       ng               n8 c         kg                k8
    t = t.transpose(1, 4, 0, 5, 2, 3, 6)
    return np.ascontiguousarray(t).reshape(n_tiles, n_chunks, hl, -1)


@dataclass(frozen=True, eq=False)
class ChanBody:
    """Constants of one fused channelizer, on one device in one dtype."""

    M: int
    K: int
    mode: str                # "x3" (three bf16 passes) | "fast" (one)
    hp: torch.Tensor         # (K+1, M) permuted branch filter
    bank_r: torch.Tensor     # (M, 2M) [C | S], bf16-rounded for "fast"
    bank_i: torch.Tensor     # (M, 2M) [-S | C], the plain version's
    tiles: torch.Tensor      # the kernel's packed bf16 banks (chan_bank_tiles)

    def __call__(self, x: torch.Tensor, tail_rows: torch.Tensor,
                 engine: str = "auto") -> torch.Tensor:
        """The channels of frame rows x, planar (2, U, M) f32 -> Y2 (U, 2M)
        [Re | Im] or complex64 (U, M) -> Y (U, M), with the carried tail
        rows (2, 8, M): the kernel for CUDA tensors under ``"auto"``."""
        if use_kernel(engine, x):
            return chan_fused_cuda(self, x, tail_rows)
        return chan_fused_torch(self, x, tail_rows)


@functools.lru_cache(maxsize=16)
def _chan_body_np(taps_bytes: bytes, M: int, mode: str):
    hp2, K = chan_hp2_np(np.frombuffer(taps_bytes, np.float64), M)
    out_r, out_i = chan_banks_np(M)
    if mode == "fast":
        out_r, out_i = (torch.from_numpy(b).to(torch.bfloat16).float()
                        .numpy() for b in (out_r, out_i))
    return hp2, K, out_r, out_i, chan_bank_tiles(M, mode)


def make_chan_body(taps: np.ndarray, num_channels: int, mode: str = "fast",
                   device=None, dtype: torch.dtype = torch.float32
                   ) -> ChanBody:
    """Design-time constants of the fused channelizer on ``device`` (the
    card unless told otherwise): ``mode`` "x3" or "fast", K <= CHAN_HALO
    (``pallas_kernels.py:384-416``, the bf16 banks split on the host as
    there)."""
    if mode not in ("x3", "fast"):
        raise ValueError(f"unknown mode {mode!r}")
    M = int(num_channels)
    device = resolve_device(device)
    h = np.ascontiguousarray(np.asarray(taps).real, np.float64)
    hp2, K, out_r, out_i, tiles = _chan_body_np(h.tobytes(), M, mode)
    if K > CHAN_HALO:
        raise ValueError(f"taps_per_branch must be <= {CHAN_HALO}")

    def dev(a):     # float64 holds the float32 constants exactly
        return torch.tensor(a, dtype=dtype, device=device)

    return ChanBody(M=M, K=K, mode=mode, hp=dev(hp2), bank_r=dev(out_r),
                    bank_i=dev(out_i),
                    tiles=torch.from_numpy(tiles.view(np.int16)).to(device))


def _check_fused(body: ChanBody, x, tail_rows) -> tuple:
    """(U, complex layout?) of frame rows x: (2, U, M) or (U, M) complex."""
    if x.is_complex():
        if x.dim() != 2 or x.shape[1] != body.M:
            raise ValueError(f"complex x must be (U, {body.M}), got "
                             f"{tuple(x.shape)}")
    elif x.dim() != 3 or x.shape[0] != 2 or x.shape[2] != body.M:
        raise ValueError(f"xf must be (2, U, {body.M}), got "
                         f"{tuple(x.shape)}")
    if tuple(tail_rows.shape) != (2, CHAN_HALO, body.M):
        raise ValueError(f"tail_rows must be (2, {CHAN_HALO}, {body.M}), "
                         f"got {tuple(tail_rows.shape)}")
    return int(x.shape[-2]), x.is_complex()


@fp32_exact()
def chan_fused_torch(body: ChanBody, x: torch.Tensor,
                     tail_rows: torch.Tensor) -> torch.Tensor:
    """Plain version of K4, both modes and both layouts: the (K+1)-tap
    filter as shifted multiply-adds over the frame rows, then zr @ [C | S]
    + zi @ [-S | C] (z rounded to bf16 first in "fast"); float32 or
    float64 as the body.  Complex x (U, M) is split into planes and Y2
    merged, so the two layouts give the same values bit for bit."""
    U, cplx = _check_fused(body, x, tail_rows)
    xf = torch.stack([x.real, x.imag]) if cplx else x
    xcat = torch.cat([tail_rows, xf], dim=1)           # (2, 8 + U, M)
    H = CHAN_HALO
    acc = body.hp[0] * xcat[:, H: H + U]
    for kp in range(1, body.K + 1):
        acc = acc + body.hp[kp] * xcat[:, H - kp: H - kp + U]
    if body.mode == "fast":
        acc = acc.to(torch.bfloat16).to(body.bank_r.dtype)
    y2 = torch.matmul(acc[0], body.bank_r) + torch.matmul(acc[1], body.bank_i)
    return torch.complex(y2[:, :body.M], y2[:, body.M:]) if cplx else y2


def chan_fused_cuda(body: ChanBody, x: torch.Tensor,
                    tail_rows: torch.Tensor) -> torch.Tensor:
    """Launch K4 (``csrc/channelizer.cu``): planar xf (2, U, M) f32 ->
    Y2 (U, 2M) f32, or complex64 x (U, M) -> Y (U, M) complex64.  Takes
    contiguous f32 (complex64) CUDA tensors on the body's card and raises
    on anything else.  Adds one to ``chan_fused_cuda.launches`` (and to
    ``chan_fused_cuda.complex_launches`` on the complex layout)."""
    U, cplx = _check_fused(body, x, tail_rows)
    if not (x.is_cuda and tail_rows.device == x.device
            and body.hp.device == x.device):
        raise ValueError("chan_fused_cuda needs x, tail_rows and the body "
                         "on one CUDA device; CPU tensors take "
                         "chan_fused_torch")
    if (x.dtype != (torch.complex64 if cplx else torch.float32)
            or tail_rows.dtype != torch.float32
            or body.hp.dtype != torch.float32):
        raise TypeError("chan_fused_cuda computes in float32 (complex64 "
                        "frame rows, float32 planes and tail rows)")
    if not (x.is_contiguous() and tail_rows.is_contiguous()):
        raise ValueError("chan_fused_cuda needs contiguous x and tail_rows")
    shape = (U, body.M) if cplx else (U, 2 * body.M)
    y = torch.empty(shape, dtype=x.dtype, device=x.device)
    fn = launcher("channelizer.cu", "chan_fused_launch", _FUSED_ARGS)
    check_launch(fn(x.data_ptr(), tail_rows.data_ptr(), body.hp.data_ptr(),
                    body.tiles.data_ptr(), y.data_ptr(), U, body.M, body.K,
                    int(body.mode == "x3"), int(cplx), x.device.index,
                    stream_of(x)), "chan_fused_cuda")
    chan_fused_cuda.launches += 1
    chan_fused_cuda.complex_launches += int(cplx)
    return y


chan_fused_cuda.launches = 0
chan_fused_cuda.complex_launches = 0     # of them, on the complex layout
