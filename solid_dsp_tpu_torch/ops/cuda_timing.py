"""The Gardner timing loop on Hopper (S9): the wrapper of
``csrc/gardner_scan.cu``.

S9 runs ``models/timing.py::gardner_scan`` on one complex64 stream: one
block a stream, lane 0 of one warp walking the symbols (two cubic Farrow
interpolations and the loop filter a symbol), a second warp staging x
through shared memory as a sliding window a chunk ahead.  It replaces no
TPU kernel: in the JAX package the loop is a ``lax.scan``
(``solid_dsp_tpu/models/timing.py:124``).  The source has the design, its
bound and F8's repair (the strobe's whole part kept as an integer).  Its
plain version is ``models/timing.py::gardner_walk_plain``, which a CPU
tensor takes; S9 is bit-equal to it.

The wrapper takes CUDA tensors only, checks type, shape and limits,
allocates the outputs, launches on the current stream, raises if the launch
fails (``cuda_build.check_launch``) and adds one to ``launches``.  Limits:
complex64 only, 1 <= sps <= 64 (the windows' shared memory) and fewer than
2^31 samples (32-bit indices); past one it raises a ``ValueError`` naming
it, and the plain version (``engine="torch"``) takes the rest.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .cuda_build import check_launch, launcher, stream_of

__all__ = ["gardner_cuda", "MAX_SPS"]

MAX_SPS = 64
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = (_P, _I, _I, _I, _F, _F, _F, _P, _P, _P)


def check_limits(x: torch.Tensor, sps: int):
    """Raise ValueError where S9 cannot walk ``x`` at ``sps``."""
    if x.dtype != torch.complex64:
        raise ValueError(f"S9 walks complex64 streams only, got {x.dtype}; "
                         "the plain version (engine='torch') takes "
                         "complex128")
    if not 1 <= sps <= MAX_SPS:
        raise ValueError(f"S9 takes 1 <= sps <= {MAX_SPS} (its windows in "
                         f"shared memory), got {sps}; the plain version "
                         "(engine='torch') takes any")
    if x.dim() != 1 or x.shape[0] >= 2 ** 31:
        raise ValueError("S9 takes one stream (n,) of fewer than 2^31 "
                         "samples")


def gardner_cuda(x: torch.Tensor, sps: int, alpha: float, beta: float,
                 mu0: float, n_sym: int):
    """S9 over the stream x (n,) complex64 on one card: (symbols (n_sym,)
    complex64, final mu (float32, 0-d)).  Adds one to ``launches``."""
    name = "gardner_cuda"
    if not x.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors; CPU tensors take the "
                         "plain version")
    check_limits(x, sps)
    n = int(x.shape[0])
    syms = torch.empty(max(n_sym, 0), dtype=torch.complex64, device=x.device)
    mu = torch.empty((), dtype=torch.float32, device=x.device)
    xc = x.contiguous()
    f32 = np.float32
    fn = launcher("gardner_scan.cu", "gardner_scan_c64", _ARGS)
    check_launch(fn(xc.data_ptr(), n, int(sps), max(int(n_sym), 0), f32(mu0),
                    f32(alpha), f32(beta), syms.data_ptr(), mu.data_ptr(),
                    stream_of(x)), name)
    gardner_cuda.launches += 1
    return syms, mu


gardner_cuda.launches = 0
