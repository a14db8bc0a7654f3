"""The CVSD codec's walk on Hopper (S8): the wrapper of
``csrc/cvsd_scan.cu``.

S8 runs ``models/cvsd.py``'s encoder (x -> bits) and decoder (bits -> the
reference trajectory), one thread a lane (a row of the flattened leading
axes), a warp 32 lanes, each chunk of 32 samples staged through shared
memory with coalesced loads a chunk ahead of the walk.  It replaces no TPU
kernel: in the JAX package each direction is a ``lax.scan``
(``solid_dsp_tpu/models/cvsd.py:86`` and ``:119``).  The source has the
design and its bound.  Its plain version is
``models/cvsd.py::cvsd_walk_plain``, which a CPU tensor takes; S8 is
bit-equal to it (bits and trajectory).

The wrapper takes CUDA tensors only, checks types, shapes and limits,
allocates the output, launches on the current stream, raises if the launch
fails (``cuda_build.check_launch``) and adds one to ``launches`` (and, for
a decode, to ``decode_launches``).  Limits:
float32 only, and ``n_history`` <= 32 (the history is one 32-bit word);
past either it raises a ``ValueError`` that names it, and the plain version
(``engine="torch"``) takes the rest.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .cuda_build import check_launch, launcher, stream_of

__all__ = ["cvsd_cuda", "MAX_HISTORY"]

MAX_HISTORY = 32
_P, _I, _L, _F, _U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float, ctypes.c_uint)
_ARGS = (_P, _P, _I, _L, _F, _F, _F, _F, _F, _U, _P)


def check_limits(v: torch.Tensor, decode: bool, n_history: int):
    """Raise ValueError where S8 cannot walk ``v`` (float32 samples to
    encode, int32 bits to decode; n_history <= 32)."""
    if not 1 <= n_history <= MAX_HISTORY:
        raise ValueError(f"S8 keeps at most {MAX_HISTORY} history bits (one "
                         f"word), got n_history={n_history}; the plain "
                         "version (engine='torch') takes any")
    want = torch.int32 if decode else torch.float32
    if v.dtype != want:
        what = "decodes int32 bits" if decode else "encodes float32 only"
        raise ValueError(f"S8 {what}, got {v.dtype}; the plain version "
                         "(engine='torch') takes float64")


def cvsd_cuda(v: torch.Tensor, decode: bool, beta: float, gamma: float,
              delta_min: float, delta_max: float, n_history: int,
              leak: float) -> torch.Tensor:
    """S8 over lanes v (B, N) on one card: encode float32 samples to int32
    bits, or (``decode``) int32 0/1 bits to the float32 trajectory.  Adds
    one to ``launches`` (and to ``decode_launches`` for a decode)."""
    name = "cvsd_cuda"
    if not v.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors; CPU tensors take the "
                         "plain version")
    check_limits(v, decode, n_history)
    if v.dim() != 2:
        raise ValueError(f"{name} takes lanes (B, N)")
    B, N = int(v.shape[0]), int(v.shape[1])
    out = torch.empty((B, N), dtype=torch.float32 if decode else torch.int32,
                      device=v.device)
    if B == 0 or N == 0:
        return out
    vc = v.contiguous()
    f32 = np.float32
    mask = (1 << n_history) - 1
    fn = launcher("cvsd_scan.cu",
                  "cvsd_decode_f32" if decode else "cvsd_encode_f32", _ARGS)
    check_launch(fn(vc.data_ptr(), out.data_ptr(), B, N, f32(beta),
                    f32(gamma), f32(delta_min), f32(delta_max), f32(leak),
                    mask, stream_of(v)), name)
    cvsd_cuda.launches += 1
    cvsd_cuda.decode_launches += int(decode)
    return out


cvsd_cuda.launches = 0
cvsd_cuda.decode_launches = 0
