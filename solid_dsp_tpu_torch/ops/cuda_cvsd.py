"""The CVSD codec's walk on Hopper (S8): the wrapper of
``csrc/cvsd_scan.cu``.

S8 runs ``models/cvsd.py``'s encoder (x -> bits) and decoder (bits -> the
reference trajectory).  It replaces no TPU kernel: in the JAX package each
direction is a ``lax.scan`` (``solid_dsp_tpu/models/cvsd.py:86`` and
``:119``).  The source has the design and its bounds.

* Encode is one launch: one thread a lane (a row of the flattened leading
  axes), a warp 32 lanes, each chunk of 32 samples staged through shared
  memory a chunk ahead of the walk; both outcomes of a sample's bit are
  computed before the compare, which only selects; where the parameters
  lie outside ``params_proved``'s range it keeps every clamp of the walk
  (a second instantiation).  Bit-equal to the plain walk
  ``models/cvsd.py::cvsd_walk_plain``.
* Decode is a time-parallel chunk-and-join of clamped affine maps over
  chunks of ``DECODE_CHUNK`` samples, five launches whatever N: the flags
  and each chunk's step map, the step maps' join, each chunk's reference
  map, their join, and the walk from each chunk's start.  Bit-equal in float32 to its plain version
  ``models/cvsd.py::cvsd_decode_chunked_torch`` (the same operations in
  the same order, the joins' tree included), and within
  ``models/cvsd.py::CHUNKED_ATOL`` of the sequential walk.

The wrapper takes CUDA tensors only, checks types, shapes and limits,
allocates the output and the decoder's scratch (flags, chunk maps, chunk
starts) with ``torch.empty``, launches on the current stream, raises if a
launch fails (``cuda_build.check_launch``), and adds one to ``launches``
a call (and, for a decode, one to ``decode_launches`` and its kernels'
count to ``pass_launches``).  Limits: float32 only; ``n_history`` <= 32
(the history is one 32-bit word, and agreement reads the 31 samples
before); decode only where 0 < beta <= 1, 0 < leak <= 1 and 0 <=
delta_min <= delta_max in float32 (its maps compose there; encode takes
any).  Past any of them it raises a ``ValueError`` that names it, and the
plain version (``engine="torch"``) takes the rest.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .cuda_build import check_launch, launcher, stream_of

__all__ = ["cvsd_cuda", "decode_launch", "MAX_HISTORY", "DECODE_CHUNK",
           "JOIN_THREADS", "DECODE_PASSES", "join_geometry", "map_powers",
           "check_limits", "params_proved", "check_params"]

MAX_HISTORY = 32
# Samples a chunk (Lc) of the decoder: csrc/cvsd_scan.cu's LC.  On an H100
# at 1024 lanes x 2^16, Lc 128 ran 0.3389 ms and 64 0.3503 (3 % apart), but
# at one lane 128 ran 0.0359 ms and 64 0.0258 (the chunk walks are the
# serial depth, 3 Lc); Lc 32 ran 0.4254 / 0.0247 (torch_kernel_sweep.py s8).
DECODE_CHUNK = 64
JOIN_THREADS = 256              # threads of a lane's join, at most
DECODE_PASSES = 5               # kernels a decode launches

_P, _I, _L, _F, _U, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float, ctypes.c_uint, ctypes.c_double)
_ENC_ARGS = (_P, _P, _I, _L, _F, _F, _F, _F, _F, _U, _I, _P)
_DEC_ARGS = (_P, _P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _F, _F, _F, _F, _F,
             _D, _D, _D, _D, _I, _P)


def join_geometry(C: int) -> tuple:
    """(T, R) of a lane's join over C chunk maps: T threads (a power of
    two, at most JOIN_THREADS), each composing a run of R chunks."""
    T = min(JOIN_THREADS, 1 << max(0, (C - 1).bit_length()))
    return T, -(-C // T)


def map_powers(a: float, chunk: int, N: int) -> tuple:
    """(a^Lc, a^len of the last chunk) in float64 from a's float32 value,
    each a product taken one factor at a time (the chunk maps' slope)."""
    a64 = float(np.float32(a))
    full = tail = 1.0
    last = N - (-(-N // chunk) - 1) * chunk
    for k in range(chunk):
        full *= a64
        if k < last:
            tail *= a64
    return full, tail


def check_limits(v: torch.Tensor, decode: bool, n_history: int):
    """Raise ValueError where S8 cannot walk ``v`` (float32 samples to
    encode, int32 words to decode; n_history <= 32)."""
    if not 1 <= n_history <= MAX_HISTORY:
        raise ValueError(f"S8 keeps at most {MAX_HISTORY} history bits (one "
                         f"word), got n_history={n_history}; the plain "
                         "version (engine='torch') takes any")
    want = torch.int32 if decode else torch.float32
    if v.dtype != want:
        what = "decodes int32 words" if decode else "encodes float32 only"
        raise ValueError(f"S8 {what}, got {v.dtype}; the plain version "
                         "(engine='torch') takes float64")


def params_proved(beta: float, delta_min: float, delta_max: float,
                  leak: float) -> bool:
    """Whether 0 < beta <= 1, 0 < leak <= 1 and 0 <= delta_min <= delta_max
    in float32: where the decoder's maps compose and the encoder's dropped
    clamps cannot bind."""
    b, lo, hi, lk = (np.float32(v) for v in (beta, delta_min, delta_max,
                                             leak))
    return bool(0 < b <= 1 and 0 < lk <= 1 and 0 <= lo <= hi)


def check_params(beta: float, delta_min: float, delta_max: float,
                 leak: float):
    """Raise ValueError outside the decoder's parameters
    (``params_proved``)."""
    if not params_proved(beta, delta_min, delta_max, leak):
        raise ValueError("S8's decoder takes 0 < beta <= 1, 0 < leak <= 1 "
                         "and 0 <= delta_min <= delta_max (its maps compose "
                         f"only there), got beta={beta}, leak={leak}, delta=("
                         f"{delta_min}, {delta_max}); the plain version "
                         "(engine='torch') takes any")


def decode_launch(fn, words: torch.Tensor, y: torch.Tensor, chunk: int,
                  beta: float, gamma: float, delta_min: float,
                  delta_max: float, n_history: int, leak: float) -> int:
    """Launch the decoder ``fn`` (a library's ``cvsd_decode_f32``, built
    with chunks of ``chunk`` samples) on words (B, N) int32 (contiguous,
    B, N > 0) into y (B, N) float32 on the current stream, its scratch from
    ``torch.empty``; returns the launcher's CUDA error (0 if none)."""
    B, N = int(words.shape[0]), int(words.shape[1])
    C = -(-N // chunk)
    T, R = join_geometry(C)
    dev = words.device
    flags = torch.empty((B, C * chunk // 32, 2), dtype=torch.int32,
                        device=dev)
    # a chunk map: its offset (float64) and its two bounds (float32)
    smap = torch.empty((B, C, 2), dtype=torch.float64, device=dev)
    rmap = torch.empty((B, C, 2), dtype=torch.float64, device=dev)
    sstart = torch.empty((B, C), dtype=torch.float32, device=dev)
    rstart = torch.empty((B, C), dtype=torch.float32, device=dev)
    f32 = np.float32
    return fn(words.data_ptr(), y.data_ptr(), flags.data_ptr(),
              smap.data_ptr(), sstart.data_ptr(), rmap.data_ptr(),
              rstart.data_ptr(), B, N, T, R, f32(beta), f32(gamma),
              f32(delta_min), f32(delta_max), f32(leak),
              *map_powers(beta, chunk, N), *map_powers(leak, chunk, N),
              n_history - 1, stream_of(words))


def cvsd_cuda(v: torch.Tensor, decode: bool, beta: float, gamma: float,
              delta_min: float, delta_max: float, n_history: int,
              leak: float) -> torch.Tensor:
    """S8 over lanes v (B, N) on one card: encode float32 samples to int32
    bits, or (``decode``) int32 words to the float32 trajectory (a word
    signs the step when it is 1; the history compares the raw words).
    Adds one to ``launches`` (and, decoding, to ``decode_launches``, and
    the five kernels to ``pass_launches``)."""
    name = "cvsd_cuda"
    if not v.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors; CPU tensors take the "
                         "plain version")
    check_limits(v, decode, n_history)
    if decode:
        check_params(beta, delta_min, delta_max, leak)
    if v.dim() != 2:
        raise ValueError(f"{name} takes lanes (B, N)")
    B, N = int(v.shape[0]), int(v.shape[1])
    out = torch.empty((B, N), dtype=torch.float32 if decode else torch.int32,
                      device=v.device)
    if B == 0 or N == 0:
        return out
    vc = v.contiguous()
    if not decode:
        f32 = np.float32
        fn = launcher("cvsd_scan.cu", "cvsd_encode_f32", _ENC_ARGS)
        check_launch(fn(vc.data_ptr(), out.data_ptr(), B, N, f32(beta),
                        f32(gamma), f32(delta_min), f32(delta_max),
                        f32(leak), (1 << n_history) - 1,
                        int(not params_proved(beta, delta_min, delta_max,
                                              leak)), stream_of(v)), name)
        cvsd_cuda.launches += 1
        return out
    fn = launcher("cvsd_scan.cu", "cvsd_decode_f32", _DEC_ARGS)
    check_launch(decode_launch(fn, vc, out, DECODE_CHUNK, beta, gamma,
                               delta_min, delta_max, n_history, leak), name)
    cvsd_cuda.launches += 1
    cvsd_cuda.decode_launches += 1
    cvsd_cuda.pass_launches += DECODE_PASSES
    return out


cvsd_cuda.launches = 0
cvsd_cuda.decode_launches = 0
cvsd_cuda.pass_launches = 0
