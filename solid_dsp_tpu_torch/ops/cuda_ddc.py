"""Fused DDC + FM discriminator body: the Hopper kernel and its plain version.

Port of ``solid_dsp_tpu/ops/pallas_ddc.py::make_pallas_ddc_fm`` (K1) with
its bank builders ``_banks_full_cached`` and ``_seam_bank_cached``.  For a
planar block x (2, L) and the carried tail x[-D .. -1] (D = n - M) it
computes, for every decimated output t = 0 .. T-1 (T = L / M),

    z[t]     = sum_i h_bp[i] x[tM - D + i]
    audio[t] = atan2(z[t] conj(z[t-1]) e^{-j rad(dw)}) / (2 pi kf)

and the stats [sum |z|^2, z[T-1].re, z[T-1].im, z[0].re, z[0].im].  As in
K1, z[-1] is computed from a window one sample short (x[-n] is read as 0),
so audio[0] is left for the caller to overwrite (``ops/ddc.py``).

Two implementations of that one function:

* :func:`ddc_fm_cuda` launches ``csrc/ddc_fm.cu`` (direct-form FIR in FP32
  FMA with the input staged in shared memory, discriminator and energy in
  the same pass).  The extension is built from the repository's sources
  with ``torch.utils.cpp_extension.load`` at its first call, into
  ``solid_dsp_tpu_torch/_build/``.
* :func:`ddc_fm_torch` is the plain PyTorch version: matmuls of the frame
  view (2, F, 64*M) against folded banded-Toeplitz banks, then the
  discriminator in torch ops.  CPU tensors take it under ``engine="auto"``;
  on the card it is the reference and the timing baseline.

Calling a :class:`DdcFmBody` picks between them from the tensor's device
alone; a build or launch failure propagates.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from .ddc import _fold_banks, ddc_taps
from .fir import _banks_np
from .nco import TWO_PI, U32, U32_MASK

__all__ = ["DdcFmBody", "make_ddc_fm", "fm_supported", "ddc_fm_cuda",
           "ddc_fm_torch", "build", "launch_geometry", "DEFAULT_P"]

DEFAULT_P = 64          # outputs per frame: the block length quantum is P*M
_PKG = Path(__file__).resolve().parent.parent
_SOURCES = (_PKG / "csrc" / "ddc_fm.cu", _PKG / "csrc" / "ddc_fm_binding.cpp")
_BUILD_DIR = _PKG / "_build"
_OUTPUTS_PER_THREAD = 4          # kOutputsPerThread in csrc/ddc_fm.cu
_SMEM_LIMIT = 227 * 1024         # shared memory one block may use on sm_90


def fm_supported(n_taps: int, M: int, P: int = DEFAULT_P) -> bool:
    """K1's geometry: the backward reach D = n - M and the tap window both
    fit one frame of P*M samples."""
    return 0 < n_taps - M <= P * M and n_taps <= P * M


@functools.lru_cache(maxsize=16)
def _banks_full(h_bytes: bytes, n: int, M: int, P: int, bank_dt):
    """Folded banks of the backward formulation: output p of a frame reads
    frame-local rows [p*M - D, p*M - D + n).  Returns the body bank
    (2, hop, 2P) over the frame itself and the bank (2, D, 2P) over the
    previous frame's last D samples."""
    h_bp = np.frombuffer(h_bytes, np.complex128).reshape(n)
    hr2 = h_bp.real.astype(bank_dt)[:, None]
    hi2 = h_bp.imag.astype(bank_dt)[:, None]
    hop = P * M
    D = n - M
    Hf_r = np.concatenate(_banks_np(hr2, P, M), axis=0)   # (hop + n-1, P)
    Hf_i = np.concatenate(_banks_np(hi2, P, M), axis=0)
    body = _fold_banks(Hf_r[D : D + hop], Hf_i[D : D + hop], bank_dt)
    prev = _fold_banks(Hf_r[:D], Hf_i[:D], bank_dt)
    return body, prev


@functools.lru_cache(maxsize=16)
def _seam_bank(h_bytes: bytes, n: int, bank_dt):
    """Folded bank (2, n, 2) of one output over an n-sample window: the
    previous frame's last output."""
    h_bp = np.frombuffer(h_bytes, np.complex128).reshape(n)
    return _fold_banks(h_bp.real.astype(bank_dt)[:, None],
                       h_bp.imag.astype(bank_dt)[:, None], bank_dt)


@dataclass(frozen=True, eq=False)
class DdcFmBody:
    """Constants of one fused DDC + FM body, on one device in one dtype."""

    n: int                   # taps
    M: int                   # decimation
    P: int                   # outputs per frame of the plain version
    dtheta: int              # NCO phase increment (u32 word)
    dw: int                  # M * dtheta mod 2^32: the rotation per output
    kf: float
    cd: float                # cos(rad(dw))
    sd: float                # -sin(rad(dw))
    scale: float             # 1 / (2 pi kf)
    taps: torch.Tensor       # (2, n) [re; im] of h_bp: the kernel's taps
    bank: torch.Tensor       # (2, P*M, 2P) body bank
    prev_bank: torch.Tensor  # (2, n-M, 2P) previous-frame bank
    seam_bank: torch.Tensor  # (2, n, 2)

    def __call__(self, x2: torch.Tensor, tail: torch.Tensor,
                 engine: str = "auto"):
        """Run the body on x2 (2, L) and tail (2, n-M): ``"auto"`` launches
        the kernel for CUDA tensors and takes the plain version for CPU
        tensors; ``"cuda"`` always launches (and raises on CPU tensors);
        ``"torch"`` always takes the plain version."""
        if engine == "torch" or (engine == "auto" and not x2.is_cuda):
            return ddc_fm_torch(self, x2, tail)
        if engine in ("auto", "cuda"):
            return ddc_fm_cuda(self, x2, tail)
        raise ValueError(f"unknown ddc_engine {engine!r}")


def make_ddc_fm(taps: np.ndarray, dtheta, M: int, kf: float, device,
                dtype: torch.dtype = torch.float32) -> DdcFmBody:
    """Design-time constants for real prototype taps, NCO word dtheta,
    decimation M and FM index kf (numpy on the host, then one copy to
    ``device``)."""
    taps = np.asarray(taps)
    n = len(taps)
    if not fm_supported(n, M):
        raise ValueError(f"fused FM body needs 0 < n-M <= {DEFAULT_P}*M and "
                         f"n <= {DEFAULT_P}*M (n={n}, M={M})")
    d = int(np.uint32(dtheta))
    dw = (M * d) & U32_MASK
    drad = float(np.float64(dw) * (TWO_PI / U32))
    h_bp = np.ascontiguousarray(ddc_taps(taps, np.uint32(d)))
    bank_dt = np.float64 if dtype == torch.float64 else np.float32
    body, prev = _banks_full(h_bp.tobytes(), n, M, DEFAULT_P, bank_dt)
    seam = _seam_bank(h_bp.tobytes(), n, bank_dt)

    def dev(a):
        return torch.tensor(a, dtype=dtype, device=device)

    return DdcFmBody(
        n=n, M=M, P=DEFAULT_P, dtheta=d, dw=dw, kf=float(kf),
        cd=float(np.cos(drad)), sd=float(-np.sin(drad)),
        scale=1.0 / (2.0 * np.pi * float(kf)),
        taps=dev(np.stack([h_bp.real, h_bp.imag]).astype(bank_dt)),
        bank=dev(body), prev_bank=dev(prev), seam_bank=dev(seam))


def _check_block(body: DdcFmBody, x2: torch.Tensor, tail: torch.Tensor):
    L = int(x2.shape[-1])
    if x2.dim() != 2 or x2.shape[0] != 2 or L % (body.P * body.M) or L == 0:
        raise ValueError(f"x2 must be (2, L) with L a positive multiple of "
                         f"{body.P * body.M}, got {tuple(x2.shape)}")
    if tuple(tail.shape) != (2, body.n - body.M):
        raise ValueError(f"tail must be (2, {body.n - body.M}), "
                         f"got {tuple(tail.shape)}")


def ddc_fm_torch(body: DdcFmBody, x2: torch.Tensor, tail: torch.Tensor):
    """Plain PyTorch version of the body: returns (audio (T,), stats (5,))."""
    _check_block(body, x2, tail)
    P, M, n = body.P, body.M, body.n
    hop = P * M
    D = n - M
    xf = x2.reshape(2, -1, hop)                                  # (2, F, hop)
    prev = torch.cat([tail[:, None, :], xf[:, :-1, hop - D:]], dim=1)
    y = (torch.matmul(xf[0], body.bank[0]) + torch.matmul(xf[1], body.bank[1])
         + torch.matmul(prev[0], body.prev_bank[0])
         + torch.matmul(prev[1], body.prev_bank[1]))             # (F, 2P)
    zr = y[:, :P].reshape(-1)
    zi = y[:, P:].reshape(-1)
    # z[-1] from the n-sample window [0]*M + tail: the M samples before the
    # tail are read as 0, as K1 reads them (the glue overwrites audio[0])
    win = torch.cat([tail.new_zeros((2, M)), tail], dim=1)
    seam = (torch.matmul(win[0], body.seam_bank[0])
            + torch.matmul(win[1], body.seam_bank[1]))           # (2,)
    pr = torch.cat([seam[:1], zr[:-1]])
    pi = torch.cat([seam[1:], zi[:-1]])
    ure = zr * pr + zi * pi
    uim = zi * pr - zr * pi
    audio = torch.atan2(uim * body.cd + ure * body.sd,
                        ure * body.cd - uim * body.sd) * body.scale
    stats = torch.stack([torch.sum(y * y), zr[-1], zi[-1], zr[0], zi[0]])
    return audio, stats


def launch_geometry(n: int, M: int):
    """(threads, outputs per block, shared-memory bytes) of one kernel
    launch: the largest block of threads whose staged input span fits the
    shared memory of one block (same formula as ddc_fm_smem_bytes in
    csrc/ddc_fm.cu)."""
    for threads in (256, 128, 64, 32):
        tbo = threads * _OUTPUTS_PER_THREAD
        U = tbo + -(-n // M)
        smem = 4 * (2 * M * U + 2 * n + 2 * (tbo + 1) + threads // 32)
        if smem <= _SMEM_LIMIT:
            return threads, tbo, smem
    raise ValueError(f"decimation {M} with {n} taps does not fit the "
                     "kernel's shared-memory tile")


@functools.cache
def build():
    """Build (once per process) and load the CUDA extension from
    ``csrc/``; needs ``nvcc`` and a CUDA build of PyTorch."""
    from torch.utils.cpp_extension import load

    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return load(
        name="solid_dsp_tpu_torch_ddc_fm",
        sources=[str(s) for s in _SOURCES],
        build_directory=str(_BUILD_DIR),
        extra_cflags=["-O3"],
        extra_cuda_cflags=["-O3", "-gencode=arch=compute_90a,code=sm_90a"],
        verbose=False,
    )


def ddc_fm_cuda(body: DdcFmBody, x2: torch.Tensor, tail: torch.Tensor):
    """Launch the Hopper kernel: returns (audio (T,), stats (5,)).

    Takes f32 CUDA tensors only (x2 contiguous) and raises on anything
    else.  Adds one to ``ddc_fm_cuda.launches`` per launch.
    """
    _check_block(body, x2, tail)
    if not (x2.is_cuda and tail.is_cuda and body.taps.is_cuda):
        raise ValueError("ddc_fm_cuda needs CUDA tensors (x2, tail and the "
                         "body's taps); CPU tensors take ddc_fm_torch")
    if x2.dtype != torch.float32 or body.taps.dtype != torch.float32:
        raise TypeError("ddc_fm_cuda computes in float32")
    if not x2.is_contiguous():
        raise ValueError("ddc_fm_cuda needs a contiguous (2, L) block")
    ext = build()
    threads, tbo, _ = launch_geometry(body.n, body.M)
    T = x2.shape[-1] // body.M
    audio = torch.empty(T, dtype=torch.float32, device=x2.device)
    energy = torch.empty(-(-T // tbo), dtype=torch.float32, device=x2.device)
    edges = torch.empty(4, dtype=torch.float32, device=x2.device)
    ext.ddc_fm(x2, tail.contiguous(), body.taps, audio, energy, edges,
               body.n, body.M, threads, body.cd, body.sd, body.scale)
    ddc_fm_cuda.launches += 1
    return audio, torch.cat([energy.sum().reshape(1), edges])


ddc_fm_cuda.launches = 0

