"""CVSD: the continuously variable slope delta 1-bit voice codec.

Port of ``solid_dsp_tpu/models/cvsd.py`` (MIL-STD-188-113, Bluetooth SCO):
each sample is one bit, the sign of the prediction error; the step size
adapts through a syllabic filter, a leaky integrator boosted by ``gamma``
whenever the last ``n_history`` bits agree (slope overload) and decaying by
``beta`` toward ``delta_min``; the reconstruction accumulator leaks
(``leak``), so a channel bit error is forgotten geometrically.  The decoder
is the encoder's reconstruction loop, so decode(encode(x)) is the encoder's
reference trajectory.  Run it at 2-8x the audio Nyquist rate.

The recursion is per sample (the step feeds back through the comparator):
JAX runs it as ``lax.scan`` (:86 encode, :119 decode); here a CUDA tensor
goes through S8 (``ops/cuda_cvsd.py``, ``csrc/cvsd_scan.cu``: a thread a
lane, chunks staged through shared memory), a CPU tensor through the plain
version :func:`cvsd_walk_plain`, JAX's step as torch ops in JAX's order of
float operations; S8 makes the same operations in the same order
(bit-equal).  The history starts as zeros, as JAX's does.  S8 takes float32
and n_history <= 32; the plain version (``engine="torch"``) any
n_history and float64.  Both directions batch over the leading axes; the
functions run where their input lies, ``CVSD`` on ``device`` (the card by
default).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import bind_device
from ..ops.cuda_build import use_kernel

__all__ = ["cvsd_encode", "cvsd_decode", "cvsd_walk_plain", "CVSD"]

_BETA, _GAMMA, _DMIN, _DMAX, _LEAK = 0.9, 0.01, 0.001, 0.2, 0.98


def cvsd_walk_plain(v: torch.Tensor, decode: bool, beta: float, gamma: float,
                    delta_min: float, delta_max: float, n_history: int,
                    leak: float) -> torch.Tensor:
    """The walk over lanes v (B, N) in torch ops, a step at a time: encode
    (v real samples -> int32 bits) or decode (v int32 bits -> the
    trajectory, float32).  The state runs in v's type when encoding,
    float32 when decoding.  Per step: step = clip(beta step + (agree ?
    gamma : 0), delta_min, delta_max), ref = clip(leak ref + (bit ? step :
    -step), -1, 1)."""
    B, N = v.shape
    dt = torch.float32 if decode else v.dtype
    dev = v.device
    ref = torch.zeros(B, dtype=dt, device=dev)
    step = torch.full((B,), delta_min, dtype=dt, device=dev)
    hist = torch.zeros((B, n_history), dtype=torch.int32, device=dev)
    g = torch.tensor(gamma, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    out = []
    for n in range(N):
        bit = v[:, n] if decode else (v[:, n] >= ref).to(torch.int32)
        hist = torch.cat([hist[:, 1:], bit[:, None]], dim=1)
        agree = torch.all(hist == hist[:, :1], dim=1)
        step = torch.clamp(beta * step + torch.where(agree, g, zero),
                           delta_min, delta_max)
        ref = torch.clamp(leak * ref + torch.where(bit == 1, step, -step),
                          -1.0, 1.0)
        out.append(ref if decode else bit)
    if not out:
        return torch.empty((B, 0), dtype=dt if decode else torch.int32,
                           device=dev)
    return torch.stack(out, dim=1)


def _run(v, decode: bool, beta, gamma, delta_min, delta_max, n_history,
         leak, engine: str) -> torch.Tensor:
    if n_history < 1:
        raise ValueError("n_history must be >= 1")
    lead, N = v.shape[:-1], v.shape[-1]
    lanes = v.reshape(int(np.prod(lead, dtype=np.int64)), N)
    if use_kernel(engine, lanes):
        from ..ops.cuda_cvsd import cvsd_cuda

        out = cvsd_cuda(lanes, decode, beta, gamma, delta_min, delta_max,
                        n_history, leak)
    else:
        out = cvsd_walk_plain(lanes, decode, beta, gamma, delta_min,
                              delta_max, n_history, leak)
    return out.reshape(*lead, N)


def cvsd_encode(x, beta: float = _BETA, gamma: float = _GAMMA,
                delta_min: float = _DMIN, delta_max: float = _DMAX,
                n_history: int = 3, leak: float = _LEAK,
                engine: str = "auto") -> torch.Tensor:
    """Encode real samples (..., N) in [-1, 1] to bits (..., N) int32
    {0, 1}: S8 on a CUDA tensor, the plain walk on a CPU tensor or with
    ``engine="torch"``.  Non-float input is taken as float32."""
    x = torch.as_tensor(x)
    if not x.is_floating_point():
        x = x.to(torch.float32)
    return _run(x, False, beta, gamma, delta_min, delta_max, n_history,
                leak, engine)


def cvsd_decode(bits, beta: float = _BETA, gamma: float = _GAMMA,
                delta_min: float = _DMIN, delta_max: float = _DMAX,
                n_history: int = 3, leak: float = _LEAK,
                engine: str = "auto") -> torch.Tensor:
    """Decode bits (..., N) {0, 1} to samples (..., N) float32: the
    encoder's reference trajectory (follow with a lowpass at the audio
    bandwidth).  S8 on a CUDA tensor, the plain walk otherwise."""
    bits = torch.as_tensor(bits).to(torch.int32)
    return _run(bits, True, beta, gamma, delta_min, delta_max, n_history,
                leak, engine)


class CVSD:
    """Block codec (whole utterances) with fixed parameters on ``device``
    (the card unless told otherwise)."""

    def __init__(self, beta: float = _BETA, gamma: float = _GAMMA,
                 delta_min: float = _DMIN, delta_max: float = _DMAX,
                 n_history: int = 3, leak: float = _LEAK, device=None):
        if not (0.0 < beta < 1.0):
            raise ValueError("beta in (0, 1)")
        if gamma <= 0.0:
            raise ValueError("gamma must be > 0")
        if not (0.0 < delta_min <= delta_max):
            raise ValueError("need 0 < delta_min <= delta_max")
        if not (0.0 < leak <= 1.0):
            raise ValueError("leak in (0, 1]")
        if n_history < 1:
            raise ValueError("n_history must be >= 1")
        self.beta = float(beta)
        self.gamma = float(gamma)
        self.delta_min = float(delta_min)
        self.delta_max = float(delta_max)
        self.n_history = int(n_history)
        self.leak = float(leak)
        self.device = bind_device(device)

    def _args(self):
        return (self.beta, self.gamma, self.delta_min, self.delta_max,
                self.n_history, self.leak)

    def encode(self, x) -> torch.Tensor:
        return cvsd_encode(torch.as_tensor(x).to(self.device), *self._args())

    def decode(self, bits) -> torch.Tensor:
        return cvsd_decode(torch.as_tensor(bits).to(self.device),
                           *self._args())

    def __repr__(self):
        return (f"CVSD [beta={self.beta}] [gamma={self.gamma}] "
                f"[delta=({self.delta_min},{self.delta_max})] "
                f"[history={self.n_history}]")
