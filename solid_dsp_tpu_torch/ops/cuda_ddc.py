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
  x[-D .. -1] (D = n - M, none for n <= M) it computes
  z[t] = sum_i h_bp[i] x[tM - D + i], (2, T) f32, as a banded-Toeplitz
  frame product on the tensor cores (the frame width and bank layout:
  :func:`body_tc_geometry`, :func:`body_tc_bank`), or where its bank and
  spans do not fit shared memory (M >~ 100) as a direct-form FIR, a warp
  an output (the route from (n, M) alone: :func:`body_geometry`); its
  plain version is ``ops/ddc.py::ddc_body_torch``.

Each body has a ``mode``, the TPU kernels' two: ``"x3"`` (TF32 x3, ~f32
accuracy, for ``fir_precision`` "highest"/"x3") or ``"fast"`` (their
single bf16 pass, for "default": samples and bank rounded to bf16 to
nearest even, the bank from its float32 values as the TPU kernel builds
it, products exact, f32 sums, ~52 dB against float64).  A float64 body
computes in float64 (the JAX package keeps float64 off its kernels).  The
kernels are the TPU kernels' counterparts where the JAX package's
predicates take them (:func:`full_supported`, :func:`body_supported`,
:func:`fm_supported`); elsewhere the JAX package runs XLA, and the port
its plain version on every device.

For a planar block x (2, L) and the carried tail x[-D .. -1] K1 computes,
for every decimated output t = 0 .. T-1 (T = L / M),

    z[t]     = sum_i h_bp[i] x[tM - D + i]
    audio[t] = atan2(z[t] conj(z[t-1]) e^{-j rad(dw)}) / (2 pi kf)

and the stats [sum |z|^2, z[T-1].re, z[T-1].im, z[0].re, z[0].im].  As in
K1, z[-1] is computed from a window one sample short (x[-n] is read as 0),
so audio[0] is left for the caller to overwrite (``ops/ddc.py``).

Two implementations of K1's function:

* :func:`ddc_fm_cuda` launches ``csrc/ddc_fm.cu`` on one of two routes
  chosen from (n, M) alone (:func:`fm_geometry`): the body's tensor-core
  product (``csrc/ddc_tc.cuh``, ``wgmma`` in the body's mode) with the
  discriminator, energy and edges in its epilogue, wherever its bank and
  spans fit one block's shared memory (counted by ``ddc_fm_cuda.launches``
  in x3, ``.fast_launches`` in fast mode); else the direct-form FIR, a warp
  a run of outputs in FP32 FMA with the body's direct-route dot
  (``csrc/ddc_direct.cuh``; ``.direct_launches``, ``.direct_fast_launches``),
  which takes every (n, M) of :func:`fm_supported`.  Both write the
  five stats themselves, the energy summed in a fixed order.  In fast mode
  the output before each TPU tile (:func:`fm_seam_frames`) stays an f32
  dot of the unrounded samples, as the TPU kernel's seam.
* :func:`ddc_fm_torch` is the plain PyTorch version: matmuls of the frame
  view (2, F, 64*M) against folded banded-Toeplitz banks (operands rounded
  to bf16 in fast mode), then the discriminator in torch ops.  CPU tensors
  take it under ``engine="auto"``; on the card it is the reference and the
  timing baseline.

Every kernel also reads the raw interleaved int16 block of a ci16
recording, (L, 2) contiguous, in place of the planes: the tensor-core
routes bring it into shared memory by TMA at 4 bytes a sample (both
planes), the direct routes read it as 4-byte words, and each converts a
sample in registers (the magic-number add, then one rounded multiply by
``ops/ddc.py::ci16_scale``), so an int16 launch gives the bits of the
float32 launch on the planes the chain's conversion makes.  Such a launch
counts on its route's counter and, beside it, on the same counter named
with ``i16_`` in front (``ddc_fm_cuda.i16_launches``, ...).

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
from .ddc import (_bf16, _check_x2, _fold_banks, _is_ci16, block_len,
                  ci16_planes, ddc_body_torch, ddc_taps)
from .fir import _banks_np
from .nco import TWO_PI, U32, U32_MASK

__all__ = ["DdcFmBody", "make_ddc_fm", "fm_supported", "full_supported",
           "body_supported", "fm_seam_frames", "ddc_fm_cuda",
           "ddc_fm_torch", "DdcBody", "make_ddc_body", "ddc_body_cuda",
           "ddc_body_unaligned_cuda", "launch_geometry", "body_tc_geometry",
           "body_geometry", "fm_tc_geometry", "fm_geometry", "fm_columns",
           "body_tc_bank", "tf32_round", "bf16_round", "DEFAULT_P", "MODES"]

DEFAULT_P = 64          # outputs per frame: the block length quantum is P*M
MODES = ("x3", "fast")  # the TPU kernels' modes (pallas_ddc.py mode=)
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_DDC_FM_ARGS = ((_P,) * 8 + (_LL,) + (_I,) * 10 + (_F,) * 3
                + (_I, _LL, _I, _P))
_DDC_FM_DIRECT_ARGS = ((_P,) * 7 + (_LL,) + (_I,) * 5 + (_F,) * 3
                       + (_I, _LL, _I, _P))
_DDC_BODY_ARGS = (_P,) * 4 + (_LL,) + (_I,) * 10 + (_P,)
_DDC_BODY_DIRECT_ARGS = (_P,) * 4 + (_LL,) + (_I,) * 4 + (_P,)
# K1's direct route (csrc/ddc_fm.cu): outputs a warp's run (R) and warps a
# block, from torch_kernel_sweep.py k1-direct
FM_DIRECT_RUN = 8
FM_DIRECT_WARPS = 4
_SMEM_LIMIT = 227 * 1024         # shared memory one block may use on sm_90
_TC_FRAMES = 64                  # kFrames in csrc/ddc_tc.cuh: wgmma's rows
_FM_EXTRA = 64                   # kFmExtra in csrc/ddc_fm.cu: the stats' words


def full_supported(n_taps: int, M: int, P: int = DEFAULT_P) -> bool:
    """K2's geometry, the JAX package's ``pallas_full_supported``: the
    backward reach D = n - M fits one frame of P*M samples, 0 < D."""
    return 0 < n_taps - M <= P * M


def body_supported(n_taps: int, M: int, P: int = DEFAULT_P) -> bool:
    """K3's geometry, the JAX package's ``pallas_body_supported``: the
    frame's head reaches at most one frame ahead, 0 < n - 1 <= P*M."""
    return 0 < n_taps - 1 <= P * M


def fm_supported(n_taps: int, M: int, P: int = DEFAULT_P) -> bool:
    """K1's geometry, the JAX package's ``pallas_fm_supported``: the
    backward reach D = n - M and the tap window both fit one frame of P*M
    samples."""
    return full_supported(n_taps, M, P) and n_taps <= P * M


def fm_seam_frames(F: int) -> int:
    """Frames of P outputs a TPU tile of K1 holds for a block of F frames
    (the JAX package's tile choice in ``ops/ddc.py::ddc_fm_fused``): in
    fast mode the output before each such tile is the tile's f32 seam."""
    for cand in (1024, 512, 256):
        if F // cand >= 4:
            return cand
    return 128


def _check_mode(mode: str, dtype: torch.dtype):
    if mode not in MODES:
        raise ValueError(f"unknown DDC body mode {mode!r}")
    if mode == "fast" and dtype != torch.float32:
        raise ValueError("the fast mode rounds float32 operands to bf16; a "
                         "float64 body computes in float64")


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
    h_bp: np.ndarray = field(repr=False)   # (n,) complex128: the kernel's bank
    mode: str = "x3"         # "x3" | "fast" (MODES)
    # the kernel's packed bank, its stats ticket on the device and the
    # plain version's bf16 banks, built at first use
    banks: dict = field(default_factory=dict, repr=False)

    def __call__(self, x2: torch.Tensor, tail: torch.Tensor,
                 engine: str = "auto"):
        """Run the body on x2 (2, L) planes or (L, 2) raw int16 and tail
        (2, n-M): ``"auto"`` launches
        the kernel for CUDA tensors and takes the plain version for CPU
        tensors; ``"cuda"`` always launches (and raises on CPU tensors);
        ``"torch"`` always takes the plain version."""
        if engine == "torch" or (engine == "auto" and not x2.is_cuda):
            return ddc_fm_torch(self, x2, tail)
        if engine in ("auto", "cuda"):
            return ddc_fm_cuda(self, x2, tail)
        raise ValueError(f"unknown ddc_engine {engine!r}")


def make_ddc_fm(taps: np.ndarray, dtheta, M: int, kf: float, device,
                dtype: torch.dtype = torch.float32,
                mode: str = "x3") -> DdcFmBody:
    """Design-time constants for real prototype taps, NCO word dtheta,
    decimation M, FM index kf and ``mode`` (numpy on the host, then one
    copy to ``device``)."""
    _check_mode(mode, dtype)
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
        bank=dev(body), prev_bank=dev(prev), seam_bank=dev(seam), h_bp=h_bp,
        mode=mode)


def _check_block(body: DdcFmBody, x2: torch.Tensor, tail: torch.Tensor):
    _check_x2(x2, body.P * body.M)
    if tuple(tail.shape) != (2, body.n - body.M):
        raise ValueError(f"tail must be (2, {body.n - body.M}), "
                         f"got {tuple(tail.shape)}")


@fp32_exact()
def ddc_fm_torch(body: DdcFmBody, x2: torch.Tensor, tail: torch.Tensor):
    """Plain PyTorch version of the body: returns (audio (T,), stats (5,));
    its matmuls in full float32 (``device.fp32_exact``).  Fast mode rounds
    the frames, the previous frames' rows, the tail and the banks to bf16
    first; the seams, the output before each TPU tile of
    :func:`fm_seam_frames` frames, stay f32 dots of the unrounded samples,
    as in the TPU kernel.  A raw int16 block (L, 2) is converted once by
    ``ops/ddc.py::ci16_planes`` (the frames read every sample)."""
    _check_block(body, x2, tail)
    if _is_ci16(x2):
        x2 = ci16_planes(x2, body.taps.dtype)
    P, M, n = body.P, body.M, body.n
    hop = P * M
    D = n - M
    fast = body.mode == "fast"
    if fast:
        banks = body.banks.get("bf16_plain")
        if banks is None:
            banks = body.banks["bf16_plain"] = (_bf16(body.bank),
                                                _bf16(body.prev_bank))
        bank, prev_bank = banks
        xq, tq = _bf16(x2), _bf16(tail)
    else:
        bank, prev_bank, xq, tq = body.bank, body.prev_bank, x2, tail
    xf = xq.reshape(2, -1, hop)                                  # (2, F, hop)
    F = xf.shape[1]
    prev = torch.cat([tq[:, None, :], xf[:, :-1, hop - D:]], dim=1)
    y = (torch.matmul(xf[0], bank[0]) + torch.matmul(xf[1], bank[1])
         + torch.matmul(prev[0], prev_bank[0])
         + torch.matmul(prev[1], prev_bank[1]))                  # (F, 2P)
    zr = y[:, :P].reshape(-1)
    zi = y[:, P:].reshape(-1)
    # z[-1] from the n-sample window [0]*M + tail: the M samples before the
    # tail are read as 0, as K1 reads them (the glue overwrites audio[0]);
    # fast mode: then the last output of each frame before a TPU tile
    win = torch.cat([tail.new_zeros((2, M)), tail], dim=1)[:, None, :]
    if fast:
        TF = fm_seam_frames(F)
        fs = torch.tensor(range(TF, F, TF), dtype=torch.int64,
                          device=x2.device)
        win = torch.cat([win, x2.reshape(2, F, hop)[:, fs - 1, hop - n:]],
                        dim=1)
    seam = (torch.matmul(win[0], body.seam_bank[0])
            + torch.matmul(win[1], body.seam_bank[1]))           # (S, 2)
    pr = torch.cat([seam[:1, 0], zr[:-1]])
    pi = torch.cat([seam[:1, 1], zi[:-1]])
    if fast:
        pr[fs * P] = seam[1:, 0]
        pi[fs * P] = seam[1:, 1]
    ure = zr * pr + zi * pi
    uim = zi * pr - zr * pi
    audio = torch.atan2(uim * body.cd + ure * body.sd,
                        ure * body.cd - uim * body.sd) * body.scale
    stats = torch.stack([torch.sum(y * y), zr[-1], zi[-1], zr[0], zi[0]])
    return audio, stats


def launch_geometry(n: int, M: int):
    """(R, warps) of K1's direct route: a warp a run of R consecutive
    outputs, ``warps`` warps a block (:data:`FM_DIRECT_RUN`,
    :data:`FM_DIRECT_WARPS`).  The route stages nothing in shared memory,
    so every (n, M) with n > M (K1's backward reach D = n - M > 0) takes
    it; raises ValueError for n <= M, which K1 does not compute."""
    if not 0 < M < n:
        raise ValueError(f"K1 needs more taps than its decimation, got "
                         f"{n} taps at decimation {M}")
    return FM_DIRECT_RUN, FM_DIRECT_WARPS


@functools.lru_cache(maxsize=None)
def fm_geometry(n: int, M: int, fast: bool = False, ci16: bool = False):
    """K1's route for n taps and decimation M in a mode (``fast``), from
    (n, M) alone: ``("tc", fm_tc_geometry(n, M, fast=fast))`` where the
    tensor-core kernel's bank and spans fit one block's shared memory, else
    ``("direct", launch_geometry(n, M))``, which takes every (n, M) that
    :func:`fm_supported` accepts.  ``ci16``: the geometry of a raw int16
    block, on the route and frame width of the planes (so its sums are
    theirs) with the int16 stages' shared memory."""
    try:
        geo = fm_tc_geometry(n, M, fast=fast)
    except ValueError:
        return "direct", launch_geometry(n, M)
    if ci16:
        geo = fm_tc_geometry(n, M, P=geo[0], fast=fast, ci16=True)
    return "tc", geo


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _fm_ticket(body: DdcFmBody, device: torch.device) -> torch.Tensor:
    """The stats' ticket on ``device``: one word, zero before the first
    launch, left zero by every launch.  Launches of one body on one card
    share it, so they run one at a time (one stream, as the chain does)."""
    key = ("ticket", device.index)
    ticket = body.banks.get(key)
    if ticket is None:
        ticket = torch.zeros(1, dtype=torch.int32, device=device)
        body.banks[key] = ticket
    return ticket


def ddc_fm_cuda(body: DdcFmBody, x2: torch.Tensor, tail: torch.Tensor):
    """Launch the Hopper kernel: returns (audio (T,), stats (5,)), both
    written by the kernel.

    Takes CUDA tensors only, x2 contiguous f32 planes (2, L) or raw int16
    (L, 2), and raises on anything else.  The route comes from (n, M) alone
    (:func:`fm_geometry`); adds one per launch to ``ddc_fm_cuda.launches``
    (tensor-core route, x3), ``.fast_launches`` (tensor-core route, fast),
    ``.direct_launches`` (direct route, x3) or ``.direct_fast_launches``
    (direct route, fast), and for int16 also to ``.i16_launches``,
    ``.i16_fast_launches``, ``.i16_direct_launches`` or
    ``.i16_direct_fast_launches``.
    """
    _check_block(body, x2, tail)
    if not (x2.is_cuda and tail.is_cuda and body.taps.is_cuda):
        raise ValueError("ddc_fm_cuda needs CUDA tensors (x2, tail and the "
                         "body's taps); CPU tensors take ddc_fm_torch")
    _check_kernel_input(x2, tail, body, "ddc_fm_cuda")
    fast = body.mode == "fast"
    ci16 = _is_ci16(x2)
    route, geo = fm_geometry(body.n, body.M, fast, ci16)
    out = _launch_fm(body, x2, tail, route, geo)
    _count(ddc_fm_cuda, body, route, ci16)
    return out


def _check_kernel_input(x2, tail, body, name: str, D=None):
    """TypeError or ValueError unless x2 is a contiguous float32 (2, L) or
    int16 (L, 2) block, 4-byte aligned, with a float32 tail (2, D) on its
    card and float32 taps: what the kernels read."""
    if x2.dtype not in (torch.float32, torch.int16) or (
            body.taps.dtype != torch.float32):
        raise TypeError(f"{name} computes in float32 on float32 planes or "
                        f"raw int16")
    if not x2.is_contiguous() or x2.data_ptr() % 4:
        raise ValueError(f"{name} needs a contiguous, 4-byte aligned block")
    if D is not None and tuple(tail.shape) != (2, D):
        raise ValueError(f"tail must be (2, {D}), got {tuple(tail.shape)}")
    if tail.dtype != torch.float32 or tail.device != x2.device:
        raise TypeError(f"{name} needs a float32 tail on the block's card")


def _launch_fm(body: DdcFmBody, x2: torch.Tensor, tail: torch.Tensor,
               route: str, geo):
    """One launch of K1 on ``route`` with its geometry ``geo``
    (:func:`fm_geometry`); the block, planes or raw int16, already
    checked."""
    L = block_len(x2)
    sfx = "_i16" if _is_ci16(x2) else ""
    T = L // body.M
    dev = x2.device
    tail = tail.contiguous()
    ticket = _fm_ticket(body, dev)
    audio = torch.empty(T, dtype=torch.float32, device=dev)
    fast = int(body.mode == "fast")
    seam_period = fm_seam_frames(L // (body.P * body.M)) * body.P
    if route == "tc":
        P, hpad, KP, pre, wgs, stages, smem = geo
        bank = _tc_bank(body, P, hpad, KP, fm=True)
        blocks = _sm_count(dev.index)
        # [stats (5) | one partial energy a block]
        scratch = torch.empty(5 + blocks, dtype=torch.float32, device=dev)
        fn = launcher("ddc_fm.cu", f"ddc_fm_launch{sfx}", _DDC_FM_ARGS)
        check_launch(fn(x2.data_ptr(), tail.data_ptr(), bank.data_ptr(),
                        body.taps.data_ptr(), audio.data_ptr(),
                        scratch.data_ptr(), scratch.data_ptr() + 20,
                        ticket.data_ptr(), L, body.n, body.M, P, hpad, KP,
                        pre, wgs, stages, smem, blocks, body.cd, body.sd,
                        body.scale, fast, seam_period, dev.index,
                        stream_of(x2)), "ddc_fm_cuda")
    else:
        R, warps = geo
        # warps walk the runs of R outputs; at most 64 warps an SM
        blocks = min(-(-T // (R * warps)),
                     _sm_count(dev.index) * max(1, 64 // warps))
        scratch = torch.empty(5 + blocks, dtype=torch.float32, device=dev)
        fn = launcher("ddc_fm.cu", f"ddc_fm_direct_launch{sfx}",
                      _DDC_FM_DIRECT_ARGS)
        check_launch(fn(x2.data_ptr(), tail.data_ptr(), body.taps.data_ptr(),
                        audio.data_ptr(), scratch.data_ptr(),
                        scratch.data_ptr() + 20, ticket.data_ptr(), L, body.n,
                        body.M, R, warps, blocks, body.cd, body.sd,
                        body.scale, fast, seam_period, dev.index,
                        stream_of(x2)), "ddc_fm_cuda")
    return audio, scratch[:5]


COUNTERS = ("launches", "fast_launches", "direct_launches",
            "direct_fast_launches")
I16_COUNTERS = tuple("i16_" + c for c in COUNTERS)
for _c in COUNTERS + I16_COUNTERS:
    setattr(ddc_fm_cuda, _c, 0)


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
    mode: str = "x3"         # "x3" | "fast" (MODES)
    # the plain version's folded banks and the kernel's packed bank on the
    # device, built at first use
    banks: dict = field(default_factory=dict, repr=False)

    def route(self, L: int):
        """The kernel the JAX package's routing gives a block of L samples:
        K2's route (:func:`ddc_body_cuda`) for L a multiple of P*M where
        :func:`full_supported` holds, else K3's
        (:func:`ddc_body_unaligned_cuda`) where :func:`body_supported`
        holds; None where the JAX package runs XLA (neither holds, or a
        float64 body), whose counterpart is the plain version."""
        if self.taps.dtype != torch.float32:
            return None
        if L % (self.P * self.M) == 0 and full_supported(self.n, self.M):
            return ddc_body_cuda
        if body_supported(self.n, self.M):
            return ddc_body_unaligned_cuda
        return None

    def __call__(self, x2: torch.Tensor, tail: torch.Tensor,
                 engine: str = "auto") -> torch.Tensor:
        """z (2, L / M) of x2 (2, L) planes or (L, 2) raw int16 and tail
        (2, max(n-M, 0)): ``"auto"``
        launches the kernel :meth:`route` gives for CUDA tensors and takes
        the plain version for CPU tensors and where the JAX package runs
        XLA; ``"cuda"`` always launches (and raises where no kernel takes
        the block); ``"torch"`` always takes the plain version."""
        if engine not in ("auto", "cuda", "torch"):
            raise ValueError(f"unknown ddc_engine {engine!r}")
        kernel = self.route(block_len(x2))
        if engine == "torch" or (engine == "auto"
                                 and (not x2.is_cuda or kernel is None)):
            return ddc_body_torch(self, x2, tail)
        if kernel is None:
            raise ValueError(
                f"no DDC body kernel takes {self.n} taps at decimation "
                f"{self.M} in {self.taps.dtype} (the JAX package runs XLA "
                f"there): ddc_engine 'auto' or 'torch' takes the plain body")
        return kernel(self, x2, tail)


def make_ddc_body(taps: np.ndarray, dtheta, M: int, device,
                  dtype: torch.dtype = torch.float32,
                  mode: str = "x3") -> DdcBody:
    """Design-time constants for real prototype taps, NCO word dtheta,
    decimation M and ``mode`` (numpy on the host, then one copy to
    ``device``); any tap count, n <= M included."""
    _check_mode(mode, dtype)
    taps = np.asarray(taps)
    n = len(taps)
    if n < 1:
        raise ValueError("the DDC body needs at least one tap")
    d = int(np.uint32(dtheta))
    h_bp = ddc_taps(taps, np.uint32(d))
    bank_dt = np.float64 if dtype == torch.float64 else np.float32
    return DdcBody(
        n=n, M=M, P=DEFAULT_P, dtheta=d, dw=(M * d) & U32_MASK,
        taps=torch.tensor(np.stack([h_bp.real, h_bp.imag]).astype(bank_dt),
                          dtype=dtype, device=device), h_bp=h_bp, mode=mode)


def _tc_geometry(n: int, M: int, pre: int = 0, extra: int = 0, P=None,
                 wgs=None, fast: bool = False, ci16: bool = False):
    """(P, hpad, KP, wgs, stages, smem) of the tensor-core product
    (csrc/ddc_tc.cuh) in x3 or (``fast``) bf16 with spans starting ``pre``
    samples early and ``extra`` bytes of shared memory for the epilogue; P
    and wgs are chosen unless given.  A stage holds the span's two float32
    planes, or (``ci16``) its interleaved int16, one 4-byte word a
    sample."""
    hpad = -(-max(n - M, 0) // 4) * 4
    if P is None:
        P = 4
        while P * M < 64 and P < 64:
            P *= 2
        widths = []
        while P >= 4:
            widths.append(P)
            P //= 2
    else:
        widths = [P]
    for P in widths:
        hop = P * M
        KP = -(-(hpad + hop) // 32) * 32
        SP = -(-(pre + (_TC_FRAMES - 1) * hop + KP + 4) // 4) * 4
        bank = (KP // 8 if fast else 2 * (KP // 4)) * 32 * 2 * P
        for w, stages in ((2, 2), (1, 2), (1, 1)):
            if wgs is not None and w != wgs:
                continue
            smem = (bank + w * stages * (1 if ci16 else 2) * SP * 4
                    + (1 + stages * w) * 8 + extra)
            if smem <= _SMEM_LIMIT:
                return P, hpad, KP, w, stages, smem
    raise ValueError(f"the DDC tensor-core kernel's bank and spans do not "
                     f"fit shared memory at {n} taps and decimation {M}")


def body_tc_geometry(n: int, M: int, fast: bool = False, P=None,
                     ci16: bool = False):
    """(P, hpad, KP, wgs, stages, smem) of the tensor-core body kernel for n
    taps, decimation M and its mode (``fast``: the bf16 bank, a quarter of
    x3's shared memory): frames of P outputs (hop = P*M samples), each read
    through the window of KP samples that starts hpad before the frame
    (hpad = D = n - M rounded up to 4, 0 for n <= M; KP = hpad + hop
    rounded up to 32);
    wgs warpgroups a block, ``stages`` span buffers a warpgroup and smem
    bytes of shared memory (the bank, the stages, the barriers).  P is the
    smallest power of two >= 4 with hop >= 64, halved while the bank and
    stages do not fit one block's shared memory (two warpgroups of two
    stages, else one of two, else one of one); raises ValueError when even
    P = 4 does not fit.  ``P`` pins the frame width; ``ci16``: stages of
    raw int16 (:func:`_tc_geometry`)."""
    return _tc_geometry(n, M, P=P, fast=fast, ci16=ci16)


@functools.lru_cache(maxsize=None)
def body_geometry(n: int, M: int, fast: bool = False, ci16: bool = False):
    """The body's route for n taps and decimation M in a mode (``fast``),
    from (n, M) alone, as :func:`fm_geometry` picks K1's: ``("tc",
    body_tc_geometry(n, M, fast))`` where the tensor-core kernel's bank and
    spans fit one block's shared memory, else ``("direct", None)``, the
    direct-form FIR of ``csrc/ddc_body.cu`` (a warp an output, FP32 FMA;
    fast: bf16 operands), which takes every (n, M).  ``ci16``: a raw int16
    block's, on the planes' route and frame width."""
    try:
        geo = body_tc_geometry(n, M, fast=fast)
    except ValueError:
        return "direct", None
    if ci16:
        geo = body_tc_geometry(n, M, fast=fast, P=geo[0], ci16=True)
    return "tc", geo


@functools.lru_cache(maxsize=None)
def fm_tc_geometry(n: int, M: int, P=None, wgs=None, fast: bool = False,
                   ci16: bool = False):
    """(P, hpad, KP, pre, wgs, stages, smem) of K1's tensor-core route: the
    body's geometry (:func:`body_tc_geometry`) with spans starting ``pre``
    samples early (n - hpad rounded up to 4: every warp reads the window of
    the output before its rows there) and the stats' shared words.  ``P``
    and ``wgs`` pin the frame width and warpgroups a block (the sweep of
    torch_kernel_sweep.py); ``ci16``: stages of raw int16; raises
    ValueError where it does not fit."""
    hpad = -(-(n - M) // 4) * 4
    pre = -(-max(n - hpad, 0) // 4) * 4
    P, hpad, KP, wgs, stages, smem = _tc_geometry(n, M, pre, _FM_EXTRA, P,
                                                  wgs, fast, ci16)
    return P, hpad, KP, pre, wgs, stages, smem


def bf16_round(a: np.ndarray) -> np.ndarray:
    """float32 -> the nearest bf16 value (8 mantissa bits, ties to even),
    as float32: what ``cvt.rn.bf16.f32`` and ``astype(bfloat16)`` give for
    finite values."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    bits = (bits + np.uint32(0x7FFF) + ((bits >> np.uint32(16))
                                        & np.uint32(1)))
    return (bits & np.uint32(0xFFFF0000)).view(np.float32)


def tf32_round(a: np.ndarray) -> np.ndarray:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero): what ``cvt.rna.tf32.f32`` gives, as float32."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def fm_columns(P: int) -> np.ndarray:
    """K1's column order: column 8 j + 2 c + e of its bank holds column
    e P + c P/4 + j of the body's [re | im] order (part e of output
    c P/4 + j), so the thread of accumulator column pair c holds P/4
    consecutive complex outputs of each of its rows (csrc/ddc_fm.cu)."""
    Q = P // 4
    return np.array([e * P + c * Q + j for j in range(Q) for c in range(4)
                     for e in range(2)])


def body_tc_bank(h_bp: np.ndarray, n: int, M: int, P: int, hpad: int,
                 KP: int, fm: bool = False, fast: bool = False) -> np.ndarray:
    """The tensor-core kernel's bank as float32 values.  Bank B (2, KP, 2P)
    in float64: plane 0 multiplies the real samples, plane 1 the imaginary
    ones, columns [re | im] of the P outputs (``fm``: in K1's order,
    :func:`fm_columns`); output p of a frame reads window rows
    hpad - D + p M + i for tap i (D = n - M; n <= M: rows M - n + p M + i).

    x3: 2 * KP / 4 k-steps of 8 x 2P, the hi k-steps of both planes, then
    the lo ones, hi = tf32(B), lo = tf32(B - hi).  K-step 2j + e of a plane
    holds window samples 16 j + 4 kk + 2 e + kc at (core column kc, K index
    kk), each step stored as wgmma's K-major core matrices [kc][column
    group][8 columns][4 K] (csrc/ddc_tc.cuh).

    fast: KP / 8 k-steps of 16 x 2P, bf16(float32(B)) (the TPU kernel's
    bank: float64 -> float32 -> bf16), exact in float32 and sent to the card
    as bf16.  K-step j of a plane holds window samples
    16 j + 4 (kk // 2) + 2 kc + kk % 2 at (core column kc, K index kk), so
    thread c's bf16 A fragment (K indices 2c, 2c+1, 2c+8, 2c+9) is its four
    consecutive samples 4c .. 4c+3; each step is stored as wgmma's K-major
    core matrices [kc][column group][8 columns][8 K]."""
    h = np.asarray(h_bp, np.complex128)
    D, N = n - M, 2 * P
    B = np.zeros((2, KP, N))
    for p in range(P):
        k0 = hpad - D + p * M
        B[0, k0:k0 + n, p] = h.real
        B[0, k0:k0 + n, P + p] = h.imag
        B[1, k0:k0 + n, p] = -h.imag
        B[1, k0:k0 + n, P + p] = h.real
    if fm:
        B = B[:, :, fm_columns(P)]
    if fast:
        kk = np.arange(8)
        k_idx = (16 * np.arange(KP // 16)[:, None, None]
                 + 4 * (kk // 2)[None, None, :]
                 + 2 * np.arange(2)[None, :, None] + (kk % 2)[None, None, :])
        packed = B[:, k_idx, :].reshape(2, KP // 16, 2, 8, N // 8, 8)
        packed = packed.transpose(0, 1, 2, 4, 5, 3)   # [plane][step][kc][grp][col][kk]
        return bf16_round(packed.astype(np.float32)).reshape(-1)
    ks = np.arange(KP // 8)
    k_idx = (16 * (ks // 2)[:, None, None] + 4 * np.arange(4)[None, None, :]
             + 2 * (ks % 2)[:, None, None] + np.arange(2)[None, :, None])
    packed = B[:, k_idx, :].reshape(2, KP // 8, 2, 4, N // 8, 8)
    packed = packed.transpose(0, 1, 2, 4, 5, 3)   # [plane][step][kc][grp][col][kk]
    hi = tf32_round(packed.astype(np.float32))
    lo = tf32_round((packed - hi).astype(np.float32))
    return np.concatenate([hi.reshape(-1), lo.reshape(-1)])


def _tc_bank(body, P: int, hpad: int, KP: int,
             fm: bool = False) -> torch.Tensor:
    """The packed bank of a :class:`DdcBody` or (``fm``) a
    :class:`DdcFmBody` in its mode on its device (float32 tf32 hi/lo, or
    bf16), built at first use from the float64 taps."""
    fast = body.mode == "fast"
    key = ("bf16" if fast else "tf32", P, hpad, KP, fm)
    bank = body.banks.get(key)
    if bank is None:
        bank = torch.from_numpy(body_tc_bank(body.h_bp, body.n, body.M, P,
                                             hpad, KP, fm, fast))
        if fast:
            bank = bank.to(torch.bfloat16)       # exact: bf16 values
        bank = bank.to(body.taps.device)
        body.banks[key] = bank
    return bank


def _launch_body(body: DdcBody, x2: torch.Tensor, tail: torch.Tensor,
                 name: str) -> torch.Tensor:
    if not (x2.is_cuda and tail.is_cuda and body.taps.is_cuda):
        raise ValueError(f"{name} needs CUDA tensors (x2, tail and the body's "
                         "taps); CPU tensors take ddc_body_torch")
    _check_kernel_input(x2, tail, body, name, max(body.n - body.M, 0))
    fast = body.mode == "fast"
    ci16 = _is_ci16(x2)
    sfx = "_i16" if ci16 else ""
    L = block_len(x2)
    route, geo = body_geometry(body.n, body.M, fast, ci16)
    tail = tail.contiguous()
    z = torch.empty((2, L // body.M), dtype=torch.float32, device=x2.device)
    if route == "tc":
        P, hpad, KP, wgs, stages, smem = geo
        bank = _tc_bank(body, P, hpad, KP)
        fn = launcher("ddc_body.cu", f"ddc_body_launch{sfx}",
                      _DDC_BODY_ARGS)
        check_launch(fn(x2.data_ptr(), tail.data_ptr(), bank.data_ptr(),
                        z.data_ptr(), L, body.n, body.M, P, hpad, KP, wgs,
                        stages, smem, int(fast), x2.device.index,
                        stream_of(x2)), name)
    else:
        fn = launcher("ddc_body.cu", f"ddc_body_direct_launch{sfx}",
                      _DDC_BODY_DIRECT_ARGS)
        check_launch(fn(x2.data_ptr(), tail.data_ptr(), body.taps.data_ptr(),
                        z.data_ptr(), L, body.n, body.M, int(fast),
                        x2.device.index, stream_of(x2)), name)
    return z, route


def _check_route(body: DdcBody, x2: torch.Tensor, fn, name: str):
    _check_x2(x2, body.M)
    L = block_len(x2)
    if body.route(L) is not fn:
        hop = body.P * body.M
        raise ValueError(
            f"{name} does not take a block of {L} samples at {body.n} taps "
            f"and decimation {body.M} (DdcBody.route): K2's route takes "
            f"lengths that are a multiple of {hop} where 0 < n - M <= {hop}, "
            f"K3's the others where 0 < n - 1 <= {hop}")


def _count(fn, body, route: str, ci16: bool):
    """One launch more on ``fn.launches`` (x3) or ``fn.fast_launches``, or
    on the direct route ``fn.direct_launches`` or
    ``fn.direct_fast_launches``; a raw int16 block's also on the same name
    with ``i16_`` in front."""
    name = ("direct_" if route == "direct" else "") + (
        "fast_launches" if body.mode == "fast" else "launches")
    for c in (name, "i16_" + name) if ci16 else (name,):
        setattr(fn, c, getattr(fn, c) + 1)


def ddc_body_cuda(body: DdcBody, x2: torch.Tensor,
                  tail: torch.Tensor) -> torch.Tensor:
    """K2's route: launch ``csrc/ddc_body.cu`` on a block whose length is a
    multiple of P*M, where :func:`full_supported` holds; returns z
    (2, L / M).  Takes CUDA tensors only (f32 planes or raw int16 (L, 2))
    and raises on anything else.
    The kernel's route comes from (n, M) alone (:func:`body_geometry`).
    Adds one to ``ddc_body_cuda.launches`` (x3) or ``.fast_launches`` on
    the tensor-core route, ``.direct_launches`` or
    ``.direct_fast_launches`` on the direct one, and for int16 also on the
    ``i16_`` counter of the same name."""
    _check_route(body, x2, ddc_body_cuda, "ddc_body_cuda")
    z, route = _launch_body(body, x2, tail, "ddc_body_cuda")
    _count(ddc_body_cuda, body, route, _is_ci16(x2))
    return z


def ddc_body_unaligned_cuda(body: DdcBody, x2: torch.Tensor,
                            tail: torch.Tensor) -> torch.Tensor:
    """K3's route: the same kernel on a block K2's route does not take (a
    length that is a multiple of M but not of P*M, or n <= M), where
    :func:`body_supported` holds.  Adds one to
    ``ddc_body_unaligned_cuda.launches`` (x3) or ``.fast_launches``, or on
    the direct route ``.direct_launches`` or ``.direct_fast_launches``, and
    for int16 also on the ``i16_`` counter of the same name."""
    _check_route(body, x2, ddc_body_unaligned_cuda,
                 "ddc_body_unaligned_cuda")
    z, route = _launch_body(body, x2, tail, "ddc_body_unaligned_cuda")
    _count(ddc_body_unaligned_cuda, body, route, _is_ci16(x2))
    return z


for _c in COUNTERS + I16_COUNTERS:
    setattr(ddc_body_cuda, _c, 0)
    setattr(ddc_body_unaligned_cuda, _c, 0)
