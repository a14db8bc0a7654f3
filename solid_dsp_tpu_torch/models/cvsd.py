"""CVSD: the continuously variable slope delta 1-bit voice codec.

Port of ``solid_dsp_tpu/models/cvsd.py`` (MIL-STD-188-113, Bluetooth SCO):
each sample is one bit, the sign of the prediction error; the step size
adapts through a syllabic filter, a leaky integrator boosted by ``gamma``
whenever the last ``n_history`` bits agree (slope overload) and decaying by
``beta`` toward ``delta_min``; the reconstruction accumulator leaks
(``leak``), so a channel bit error is forgotten geometrically.  The decoder
is the encoder's reconstruction loop, so decode(encode(x)) is the encoder's
reference trajectory.  Run it at 2-8x the audio Nyquist rate.  As JAX's
decoder does, the decoder's history holds the raw int32 words (zeros
before the start) and a word signs the step when it equals 1.

The recursion is per sample: JAX runs it as ``lax.scan`` (:86 encode, :119
decode).  Here a CUDA tensor goes through S8 (``ops/cuda_cvsd.py``,
``csrc/cvsd_scan.cu``), a CPU tensor through the plain version
:func:`cvsd_walk_plain`, JAX's step as torch ops in JAX's order of float
operations.  S8's encoder makes the walk's operations in its order
(bit-equal).  Its decoder is time-parallel: the words fix every sample's
step boost and sign before the walk, so each update is a clamped affine
map x -> clip(a x + b, lo, hi) (a > 0), and such maps compose into maps of
the same form; :func:`cvsd_decode_chunked_torch` is that association in
torch ops, bit-equal to the kernel and within :data:`CHUNKED_ATOL` of the
walk.  The history starts as zeros, as JAX's does.  S8 takes float32 and
n_history <= 32; the plain version (``engine="torch"``) any n_history and
float64.  Both directions batch over the leading axes; the functions run
where their input lies, ``CVSD`` on ``device`` (the card by default).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import bind_device
from ..ops import cuda_cvsd
from ..ops.cuda_build import use_kernel

__all__ = ["cvsd_encode", "cvsd_decode", "cvsd_walk_plain",
           "cvsd_decode_chunked_torch", "CHUNKED_ATOL", "CVSD"]

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


# The chunked decoder against the walk at the codec's defaults (beta 0.9,
# leak 0.98), any length: the chunk starts come from the float64 join (the
# walk's own carry its float32 roundings), and a start's difference fades
# as beta and leak contract it (measured up to 7.8e-7 over 1024 lanes of
# 2^12 on an H100).  As leak nears 1 the walk's roundings drift further
# (leak 1: 1.5e-5 from float64 over 2^15 samples, the chunked form 4.2e-6).
CHUNKED_ATOL = 1e-6


def _flags(words: torch.Tensor, n_history: int):
    """(one, agree) of each sample of lanes (B, N): its word is 1; its last
    n_history words (zeros before the start) are all equal."""
    B, N = words.shape
    wp = torch.cat([words.new_zeros((B, n_history - 1)), words], dim=1)
    eq = wp[:, 1:] == wp[:, :-1]
    agree = torch.ones((B, N), dtype=torch.bool, device=words.device)
    for i in range(n_history - 1):
        agree &= eq[:, i:i + N]
    return words == 1, agree


def _map_after(e, m):
    """Clamped affine maps (A, B, L, H): x -> clip(A x + B, L, H), float64,
    composed with ``e`` applied first (S8's join: each product and sum
    rounded once, the clip as max then min)."""
    a, b, lo, hi = m
    return (a * e[0], a * e[1] + b,
            torch.minimum(torch.maximum(a * e[2] + b, lo), hi),
            torch.minimum(torch.maximum(a * e[3] + b, lo), hi))


def _map_apply(m, x):
    return torch.minimum(torch.maximum(m[0] * x + m[1], m[2]), m[3])


def _fold(a32, lo, hi, b32, valid, a_full, a_tail):
    """Each chunk's map, its samples' maps x -> clip(fl(fl(a x) + b_k), lo,
    hi) composed left to right: the offset in float64, the bounds by the
    walk's float32 operations from the first sample's (lo, hi).  b32 (B,
    C, Lc) float32; valid (C, Lc); the slopes a_full / a_tail (the last
    chunk) from ``cuda_cvsd.map_powers``."""
    a64 = a32.double()
    Bm = b32[..., 0].double()
    L = lo.expand(Bm.shape).clone()
    H = hi.expand(Bm.shape).clone()
    for j in range(1, b32.shape[-1]):
        b = b32[..., j]
        on = valid[:, j]
        Bm = torch.where(on, Bm * a64 + b.double(), Bm)
        L = torch.where(on, torch.clamp(L * a32 + b, lo, hi), L)
        H = torch.where(on, torch.clamp(H * a32 + b, lo, hi), H)
    A = torch.full_like(Bm, a_full)
    A[:, -1] = a_tail
    return A, Bm, L.double(), H.double()


def _join(maps, x0: float):
    """Each chunk's start (B, C) float32 from the chunk maps (B, C): S8's
    join of a lane, T threads (``cuda_cvsd.join_geometry``) each composing
    a run of R chunks left to right, a Kogge-Stone scan over the runs,
    then each run walked again from its true start x0 or
    apply(scan of the runs before it, x0), each start rounded once."""
    Bl, C = maps[0].shape
    T, R = cuda_cvsd.join_geometry(C)
    runs = [torch.nn.functional.pad(m, (0, T * R - C)).view(Bl, T, R)
            for m in maps]
    first = torch.arange(T, device=maps[0].device) * R
    M = tuple(r[..., 0] for r in runs)
    for k in range(1, R):
        nxt = _map_after(M, tuple(r[..., k] for r in runs))
        on = first + k < C
        M = tuple(torch.where(on, n, m) for n, m in zip(nxt, M))
    t = torch.arange(T, device=maps[0].device)
    o = 1
    while o < T:
        both = _map_after(tuple(m.roll(o, 1) for m in M), M)
        M = tuple(torch.where(t >= o, n, m) for n, m in zip(both, M))
        o *= 2
    x = torch.full((Bl, T), x0, dtype=torch.float64, device=maps[0].device)
    v = torch.where(t > 0, _map_apply(tuple(m.roll(1, 1) for m in M), x), x)
    starts = []
    for k in range(R):
        starts.append(v.float())
        v = _map_apply(tuple(r[..., k] for r in runs), v)
    return torch.stack(starts, -1).reshape(Bl, T * R)[:, :C]


def cvsd_decode_chunked_torch(bits, beta: float = _BETA,
                              gamma: float = _GAMMA,
                              delta_min: float = _DMIN,
                              delta_max: float = _DMAX, n_history: int = 3,
                              leak: float = _LEAK,
                              chunk: int | None = None) -> torch.Tensor:
    """S8's decoder in torch ops over lanes (B, N) of int words -> (B, N)
    float32, the kernel's association: chunks of ``chunk`` samples
    (``cuda_cvsd.DECODE_CHUNK``); each chunk's step map folded, the maps
    joined (float64) into each chunk's starting step; each chunk's steps
    walked from it and its reference maps folded and joined into its
    starting reference; each chunk walked from its start in the walk's
    float32 operations.  Bit-equal to S8's decoder at the same chunk
    length, within CHUNKED_ATOL of :func:`cvsd_walk_plain`."""
    words = torch.as_tensor(bits).to(torch.int32)
    B, N = words.shape
    if B == 0 or N == 0:
        return torch.zeros((B, N), dtype=torch.float32, device=words.device)
    Lc = chunk or cuda_cvsd.DECODE_CHUNK
    C = -(-N // Lc)
    dev = words.device
    one, agree = _flags(words, n_history)
    pad = C * Lc - N
    one = torch.nn.functional.pad(one, (0, pad)).view(B, C, Lc)
    agree = torch.nn.functional.pad(agree, (0, pad)).view(B, C, Lc)
    valid = (torch.arange(C * Lc, device=dev) < N).view(C, Lc)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)
    be, ga, dmn, dmx, lk = map(f32, (beta, gamma, delta_min, delta_max,
                                     leak))
    lo_r, hi_r = f32(-1.0), f32(1.0)
    g = torch.where(agree, ga, f32(0.0))
    smaps = _fold(be, dmn, dmx, g, valid,
                  *cuda_cvsd.map_powers(beta, Lc, N))
    step0 = _join(smaps, float(dmn))
    step = step0
    signed = []
    for j in range(Lc):
        step = torch.clamp(step * be + g[..., j], dmn, dmx)
        signed.append(torch.where(one[..., j], step, -step))
    signed = torch.stack(signed, -1)
    rmaps = _fold(lk, lo_r, hi_r, signed, valid,
                  *cuda_cvsd.map_powers(leak, Lc, N))
    ref = _join(rmaps, 0.0)
    step = step0
    y = []
    for j in range(Lc):
        step = torch.clamp(step * be + g[..., j], dmn, dmx)
        ref = torch.clamp(ref * lk + torch.where(one[..., j], step, -step),
                          lo_r, hi_r)
        y.append(ref)
    return torch.stack(y, -1).reshape(B, C * Lc)[:, :N]


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
    bandwidth).  Other int words decode as JAX's decoder takes them: the
    history compares the raw words, and a word signs the step when it is
    1.  S8 (time-parallel, within CHUNKED_ATOL of the walk) on a CUDA
    tensor, the plain walk otherwise."""
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
