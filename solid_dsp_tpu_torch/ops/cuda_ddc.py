"""The DDC bodies on Hopper: the kernels, their wrappers and plain versions.

Ports of the three TPU kernels of ``solid_dsp_tpu/ops/pallas_ddc.py``:

* the fused DDC + FM body (K1, ``make_pallas_ddc_fm`` with its bank
  constructors ``_banks_full_cached`` and ``_seam_bank_cached``):
  :class:`DdcFmBody`, ``csrc/ddc_fm.cu``;
* the unrotated DDC body (K2 ``make_pallas_ddc_full`` on blocks that are
  a multiple of 64*M, K3 ``make_pallas_ddc_body`` on the others):
  :class:`DdcBody`, ``csrc/ddc_body.cu``, one kernel counted apart on the
  two routes by :func:`ddc_body_cuda` and :func:`ddc_body_unaligned_cuda`.
  For the block x (2, L), L any multiple of M, and the carried tail
  x[-D .. -1] (D = n - M) it computes z[t] = sum_i h_bp[i] x[tM - D + i],
  (2, T) f32, as a banded-Toeplitz frame product on the tensor cores in
  TF32 x3 (the frame width and bank layout: :func:`body_tc_geometry`,
  :func:`body_tc_bank`); its plain version is ``ops/ddc.py::ddc_body_torch``.

For a planar block x (2, L) and the carried tail x[-D .. -1] K1 computes,
for every decimated output t = 0 .. T-1 (T = L / M),

    z[t]     = sum_i h_bp[i] x[tM - D + i]
    audio[t] = atan2(z[t] conj(z[t-1]) e^{-j rad(dw)}) / (2 pi kf)

and the stats [sum |z|^2, z[T-1].re, z[T-1].im, z[0].re, z[0].im].  As in
K1, z[-1] is computed from a window one sample short (x[-n] is read as 0),
so audio[0] is left for the caller to overwrite (``ops/ddc.py``).

Two implementations of K1's function:

* :func:`ddc_fm_cuda` launches ``csrc/ddc_fm.cu`` (direct-form FIR in FP32
  FMA with the input staged in shared memory, discriminator and energy in
  the same pass).
* :func:`ddc_fm_torch` is the plain PyTorch version: matmuls of the frame
  view (2, F, 64*M) against folded banded-Toeplitz banks, then the
  discriminator in torch ops.  CPU tensors take it under ``engine="auto"``;
  on the card it is the reference and the timing baseline.

Both kernels are built from the repository's sources by ``nvcc`` at the
first launch, into ``solid_dsp_tpu_torch/_build/``, and called through
ctypes (``ops/cuda_build.py``).  Calling a :class:`DdcFmBody` or a
:class:`DdcBody` picks the kernel or the plain version from the tensor's
device alone; a build or launch failure propagates.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import fp32_exact
from .cuda_build import check_launch, launcher, stream_of
from .ddc import _fold_banks, ddc_body_torch, ddc_taps
from .fir import _banks_np
from .nco import TWO_PI, U32, U32_MASK

__all__ = ["DdcFmBody", "make_ddc_fm", "fm_supported", "ddc_fm_cuda",
           "ddc_fm_torch", "DdcBody", "make_ddc_body", "ddc_body_cuda",
           "ddc_body_unaligned_cuda", "launch_geometry", "body_tc_geometry",
           "body_tc_bank", "tf32_round", "DEFAULT_P"]

DEFAULT_P = 64          # outputs per frame: the block length quantum is P*M
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_DDC_FM_ARGS = (_P,) * 6 + (_LL, _I, _I, _I, _F, _F, _F, _I, _P)
_DDC_BODY_ARGS = (_P,) * 4 + (_LL,) + (_I,) * 9 + (_P,)
_OUTPUTS_PER_THREAD = 4          # kOutputsPerThread in csrc/ddc_fm.cu
_SMEM_LIMIT = 227 * 1024         # shared memory one block may use on sm_90
_TC_FRAMES = 64                  # kFrames in csrc/ddc_body.cu: wgmma's rows


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


@fp32_exact()
def ddc_fm_torch(body: DdcFmBody, x2: torch.Tensor, tail: torch.Tensor):
    """Plain PyTorch version of the body: returns (audio (T,), stats (5,));
    its matmuls in full float32 (``device.fp32_exact``)."""
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
    """(threads, outputs per block, shared-memory bytes) of one K1 launch:
    the largest block of threads whose staged input span fits the shared
    memory of one block (the formula of ddc_fm_smem_bytes in
    csrc/ddc_fm.cu)."""
    for threads in (256, 128, 64, 32):
        tbo = threads * _OUTPUTS_PER_THREAD
        U = tbo + -(-n // M)
        smem = 4 * (2 * M * U + 2 * n + 2 * (tbo + 1) + threads // 32)
        if smem <= _SMEM_LIMIT:
            return threads, tbo, smem
    raise ValueError(f"decimation {M} with {n} taps does not fit the "
                     "kernel's shared-memory tile")


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
    if tail.dtype != torch.float32 or tail.device != x2.device:
        raise TypeError("ddc_fm_cuda needs a float32 tail on the block's card")
    threads, tbo, _ = launch_geometry(body.n, body.M)
    T = x2.shape[-1] // body.M
    tail = tail.contiguous()
    audio = torch.empty(T, dtype=torch.float32, device=x2.device)
    energy = torch.empty(-(-T // tbo), dtype=torch.float32, device=x2.device)
    edges = torch.empty(4, dtype=torch.float32, device=x2.device)
    fn = launcher("ddc_fm.cu", "ddc_fm_launch", _DDC_FM_ARGS)
    check_launch(fn(x2.data_ptr(), tail.data_ptr(), body.taps.data_ptr(),
                    audio.data_ptr(), energy.data_ptr(), edges.data_ptr(),
                    x2.shape[-1], body.n, body.M, threads, body.cd, body.sd,
                    body.scale, x2.device.index, stream_of(x2)), "ddc_fm_cuda")
    ddc_fm_cuda.launches += 1
    return audio, torch.cat([energy.sum().reshape(1), edges])


ddc_fm_cuda.launches = 0


@dataclass(frozen=True, eq=False)
class DdcBody:
    """Constants of one unrotated DDC body, on one device in one dtype."""

    n: int                   # taps
    M: int                   # decimation
    P: int                   # outputs per frame: blocks of P*M samples are K2's
    dtheta: int              # NCO phase increment (u32 word)
    dw: int                  # M * dtheta mod 2^32: the rotation per output
    taps: torch.Tensor       # (2, n) [re; im] of h_bp
    h_bp: np.ndarray = field(repr=False)   # (n,) complex128: the kernel's bank
    # the plain version's folded banks and the kernel's packed TF32 bank on
    # the device, built at first use
    banks: dict = field(default_factory=dict, repr=False)

    def __call__(self, x2: torch.Tensor, tail: torch.Tensor,
                 engine: str = "auto") -> torch.Tensor:
        """z (2, L / M) of x2 (2, L) and tail (2, n-M): ``"auto"`` launches
        the kernel for CUDA tensors (on K2's route when L is a multiple of
        P*M, on K3's otherwise) and takes the plain version for CPU
        tensors; ``"cuda"`` always launches; ``"torch"`` always takes the
        plain version."""
        if engine == "torch" or (engine == "auto" and not x2.is_cuda):
            return ddc_body_torch(self, x2, tail)
        if engine in ("auto", "cuda"):
            if x2.shape[-1] % (self.P * self.M) == 0:
                return ddc_body_cuda(self, x2, tail)
            return ddc_body_unaligned_cuda(self, x2, tail)
        raise ValueError(f"unknown ddc_engine {engine!r}")


def make_ddc_body(taps: np.ndarray, dtheta, M: int, device,
                  dtype: torch.dtype = torch.float32) -> DdcBody:
    """Design-time constants for real prototype taps, NCO word dtheta and
    decimation M (numpy on the host, then one copy to ``device``)."""
    taps = np.asarray(taps)
    n = len(taps)
    if n <= M:
        raise ValueError(f"the DDC body needs more taps than the decimation "
                         f"(n={n}, M={M})")
    d = int(np.uint32(dtheta))
    h_bp = ddc_taps(taps, np.uint32(d))
    bank_dt = np.float64 if dtype == torch.float64 else np.float32
    return DdcBody(
        n=n, M=M, P=DEFAULT_P, dtheta=d, dw=(M * d) & U32_MASK,
        taps=torch.tensor(np.stack([h_bp.real, h_bp.imag]).astype(bank_dt),
                          dtype=dtype, device=device), h_bp=h_bp)


def body_tc_geometry(n: int, M: int):
    """(P, hpad, KP, wgs, stages, smem) of the tensor-core body kernel for n
    taps
    and decimation M: frames of P outputs (hop = P*M samples), each read
    through the window of KP samples that starts hpad before the frame
    (hpad = D = n - M rounded up to 4, KP = hpad + hop rounded up to 32);
    wgs warpgroups a block, ``stages`` span buffers a warpgroup and smem
    bytes of shared memory (the bank, the stages, the barriers).  P is the
    smallest power of two >= 4 with hop >= 64, halved while the bank and
    stages do not fit one block's shared memory (two warpgroups of two
    stages, else one of two, else one of one); raises ValueError when even
    P = 4 does not fit."""
    D = n - M
    hpad = -(-D // 4) * 4
    P = 4
    while P * M < 64 and P < 64:
        P *= 2
    while P >= 4:
        hop = P * M
        KP = -(-(hpad + hop) // 32) * 32
        SP = -(-((_TC_FRAMES - 1) * hop + KP + 4) // 4) * 4
        bank = 2 * (KP // 4) * 32 * 2 * P
        for wgs, stages in ((2, 2), (1, 2), (1, 1)):
            smem = (bank + wgs * stages * 2 * SP * 4
                    + (1 + stages * wgs) * 8)
            if smem <= _SMEM_LIMIT:
                return P, hpad, KP, wgs, stages, smem
        P //= 2
    raise ValueError(f"the DDC body kernel's bank and spans do not fit "
                     f"shared memory at {n} taps and decimation {M}")


def tf32_round(a: np.ndarray) -> np.ndarray:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero): what ``cvt.rna.tf32.f32`` gives, as float32."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def body_tc_bank(h_bp: np.ndarray, n: int, M: int, P: int, hpad: int,
                 KP: int) -> np.ndarray:
    """The tensor-core kernel's bank, float32 (2 * KP / 4 k-steps of 8 x 2P):
    the hi k-steps of both planes, then the lo ones.  Bank B (2, KP, 2P) in
    float64: plane 0 multiplies the real samples, plane 1 the imaginary
    ones, columns [re | im] of the P outputs; output p of a frame reads
    window rows hpad - D + p M + i for tap i.  hi = tf32(B), lo = tf32(B -
    hi).  K-step 2j + e of a plane holds window samples 16 j + 4 kk + 2 e +
    kc at (core column kc, K index kk), each step stored as wgmma's K-major
    core matrices [kc][column group][8 columns][4 K] (csrc/ddc_body.cu)."""
    h = np.asarray(h_bp, np.complex128)
    D, N = n - M, 2 * P
    B = np.zeros((2, KP, N))
    for p in range(P):
        k0 = hpad - D + p * M
        B[0, k0:k0 + n, p] = h.real
        B[0, k0:k0 + n, P + p] = h.imag
        B[1, k0:k0 + n, p] = -h.imag
        B[1, k0:k0 + n, P + p] = h.real
    ks = np.arange(KP // 8)
    k_idx = (16 * (ks // 2)[:, None, None] + 4 * np.arange(4)[None, None, :]
             + 2 * (ks % 2)[:, None, None] + np.arange(2)[None, :, None])
    packed = B[:, k_idx, :].reshape(2, KP // 8, 2, 4, N // 8, 8)
    packed = packed.transpose(0, 1, 2, 4, 5, 3)   # [plane][step][kc][grp][col][kk]
    hi = tf32_round(packed.astype(np.float32))
    lo = tf32_round((packed - hi).astype(np.float32))
    return np.concatenate([hi.reshape(-1), lo.reshape(-1)])


def _tc_bank(body: DdcBody, P: int, hpad: int, KP: int) -> torch.Tensor:
    """The packed bank on the body's device, built at first use from the
    float64 taps."""
    key = ("tf32", P, hpad, KP)
    bank = body.banks.get(key)
    if bank is None:
        bank = torch.from_numpy(body_tc_bank(body.h_bp, body.n, body.M, P,
                                             hpad, KP)).to(body.taps.device)
        body.banks[key] = bank
    return bank


def _launch_body(body: DdcBody, x2: torch.Tensor, tail: torch.Tensor,
                 name: str) -> torch.Tensor:
    if not (x2.is_cuda and tail.is_cuda and body.taps.is_cuda):
        raise ValueError(f"{name} needs CUDA tensors (x2, tail and the body's "
                         "taps); CPU tensors take ddc_body_torch")
    if x2.dtype != torch.float32 or body.taps.dtype != torch.float32:
        raise TypeError(f"{name} computes in float32")
    if not x2.is_contiguous():
        raise ValueError(f"{name} needs a contiguous (2, L) block")
    if tuple(tail.shape) != (2, body.n - body.M):
        raise ValueError(f"tail must be (2, {body.n - body.M}), "
                         f"got {tuple(tail.shape)}")
    if tail.dtype != torch.float32 or tail.device != x2.device:
        raise TypeError(f"{name} needs a float32 tail on the block's card")
    P, hpad, KP, wgs, stages, smem = body_tc_geometry(body.n, body.M)
    bank = _tc_bank(body, P, hpad, KP)
    tail = tail.contiguous()
    z = torch.empty((2, x2.shape[-1] // body.M), dtype=torch.float32,
                    device=x2.device)
    fn = launcher("ddc_body.cu", "ddc_body_launch", _DDC_BODY_ARGS)
    check_launch(fn(x2.data_ptr(), tail.data_ptr(), bank.data_ptr(),
                    z.data_ptr(), x2.shape[-1], body.n, body.M, P, hpad, KP,
                    wgs, stages, smem, x2.device.index, stream_of(x2)), name)
    return z


def _check_route(body: DdcBody, x2: torch.Tensor, aligned: bool, name: str):
    L = int(x2.shape[-1])
    hop = body.P * body.M
    if x2.dim() != 2 or x2.shape[0] != 2 or L == 0 or L % body.M:
        raise ValueError(f"x2 must be (2, L) with L a positive multiple of "
                         f"{body.M}, got {tuple(x2.shape)}")
    if (L % hop == 0) != aligned:
        raise ValueError(f"{name} takes blocks whose length is "
                         f"{'' if aligned else 'not '}a multiple of {hop}; "
                         f"got L = {L}")


def ddc_body_cuda(body: DdcBody, x2: torch.Tensor,
                  tail: torch.Tensor) -> torch.Tensor:
    """K2's route: launch ``csrc/ddc_body.cu`` on a block whose length is a
    multiple of P*M; returns z (2, L / M).  Takes f32 CUDA tensors only and
    raises on anything else.  Adds one to ``ddc_body_cuda.launches``."""
    _check_route(body, x2, True, "ddc_body_cuda")
    z = _launch_body(body, x2, tail, "ddc_body_cuda")
    ddc_body_cuda.launches += 1
    return z


def ddc_body_unaligned_cuda(body: DdcBody, x2: torch.Tensor,
                            tail: torch.Tensor) -> torch.Tensor:
    """K3's route: the same kernel on a block whose length is a multiple of
    M but not of P*M.  Adds one to ``ddc_body_unaligned_cuda.launches``."""
    _check_route(body, x2, False, "ddc_body_unaligned_cuda")
    z = _launch_body(body, x2, tail, "ddc_body_unaligned_cuda")
    ddc_body_unaligned_cuda.launches += 1
    return z


ddc_body_cuda.launches = 0
ddc_body_unaligned_cuda.launches = 0
