"""The tracking and prediction recurrences on Hopper (S4, S5): wrappers of
``csrc/track_scan.cu``.

S4 is the Kalman filter's walk (``ops/kalman.py``, JAX
``ops/kalman.py:43-124, 172-177``) in three entries:
:func:`kalman_filter_cuda` (the predict/update walk, serving
``kalman_apply`` and ``rts_smooth``'s forward pass, which also keeps the
filtered covariances and the predictions), :func:`rts_backward_cuda` (the
smoother's backward walk) and :func:`kalman_lti_cuda` (the steady-state
x = F x + b, ``kalman_lti_apply(method="scan")``).  S5 is the all-pole
lattice (``analysis/lpc.py::lattice_iir``, JAX ``analysis/lpc.py:233-262``):
:func:`lattice_iir_cuda`.  None replaces a TPU kernel: in the JAX package
each is a ``lax.scan``.  One thread walks one sequence; the source has the
design and its bound.

Each wrapper takes CUDA tensors only, checks types and shapes, launches on
the current stream, raises if the launch fails (``cuda_build.check_launch``)
and adds one to its ``launches`` count.  The kernels run fixed register
buckets: the wrappers pad n and m to 1, 2, 4 or 8 (:func:`bucket`; zero
rows and columns, R and the backward entry's P- with 1 on the padded
diagonal, which leaves every real entry's arithmetic as it is) and the
lattice's order to 4, 8, 16, 32 or 64 (zero reflection coefficients: a
stage that leaves its error as it is), and cut the outputs back.  The
Kalman kernels take n <= 8 states and m <= 8 measurements (:func:`fits`);
``ops/kalman.py`` routes a larger model on the card to the plain version
and counts it on the wrapper's ``plain_routes``.  The plain versions are
``ops/kalman.py::kalman_walk_plain``, ``rts_backward_plain`` and
``lti_walk_plain`` and ``analysis/lpc.py::lattice_iir_plain``; a CPU
tensor takes them.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import check_launch, launcher, stream_of

__all__ = ["kalman_filter_cuda", "rts_backward_cuda", "kalman_lti_cuda",
           "lattice_iir_cuda", "fits", "bucket", "MAX_STATES",
           "LATTICE_ORDERS"]

MAX_STATES = 8           # n and m a Kalman kernel takes
# the lattice's register buckets; orders above the last run the generic
# loop with the errors in a scratch tensor
LATTICE_ORDERS = (4, 8, 16, 32, 64)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_KF_ARGS = (_P,) * 11 + (_I, _LL, _I, _I, _I, _P)
_RTS_ARGS = (_P,) * 7 + (_I, _LL, _I, _I, _P)
_LTI_ARGS = (_P,) * 4 + (_I, _LL, _I, _I, _P)
_LAT_ARGS = (_P,) * 4 + (_I, _LL, _I, _I, _P)
_REAL = {torch.float32: "f32", torch.float64: "f64"}
_LAT = {torch.float32: "f32", torch.float64: "f64", torch.complex64: "c64",
        torch.complex128: "c128"}


def fits(n: int, m: int) -> bool:
    """Whether a model of n states and m measurements fits the Kalman
    kernels (register buckets up to ``MAX_STATES``)."""
    return 1 <= n <= MAX_STATES and 1 <= m <= MAX_STATES


def bucket(v: int) -> int:
    """The Kalman kernels' register bucket of a size 1..8: 1, 2, 4 or 8."""
    return 1 << max(0, int(v - 1).bit_length())


def _pad(t: torch.Tensor, shape: tuple, diag: bool = False) -> torch.Tensor:
    """A contiguous copy of t zero-padded at the end of each axis to
    ``shape``; ``diag``: 1 on the padded diagonal of the last two axes."""
    out = t.new_zeros(shape)
    out[tuple(slice(0, s) for s in t.shape)] = t
    if diag and shape[-1] > t.shape[-1]:
        out.diagonal(dim1=-2, dim2=-1)[..., t.shape[-1]:].fill_(1)
    return out


def _cut(t: torch.Tensor, shape: tuple) -> torch.Tensor:
    """The leading ``shape`` corner of a padded output (t itself unpadded)."""
    if tuple(t.shape) == tuple(shape):
        return t
    return t[tuple(slice(0, s) for s in shape)].contiguous()


def _check(name: str, types: dict, *ts: torch.Tensor):
    t0 = ts[0]
    if not t0.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors; CPU tensors take the "
                         "plain version")
    if t0.dtype not in types:
        raise TypeError(f"{name} takes {tuple(types)}, got {t0.dtype}")
    for t in ts[1:]:
        if t.dtype != t0.dtype or t.device != t0.device:
            raise TypeError(f"{name}: every operand must be {t0.dtype} on "
                            f"{t0.device}")


def _shape(name: str, t: torch.Tensor, shape: tuple, what: str):
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: {what} must be {shape}, got "
                         f"{tuple(t.shape)}")


def kalman_filter_cuda(x: torch.Tensor, P: torch.Tensor, Z: torch.Tensor,
                       A: torch.Tensor, C: torch.Tensor, Q: torch.Tensor,
                       R: torch.Tensor, keep: bool = False):
    """S4's forward entry over Z (T, m) on one card, float32 or float64: x
    (n,), P (n, n), A (n, n), C (m, n), Q (n, n), R (m, m), n and m at most
    ``MAX_STATES``.  Returns (X (T, n), x_T, P_T) and, with ``keep``, also
    (Pf (T, n, n), Xp (T, n), Pp (T, n, n)); adds one to ``launches``."""
    name = "kalman_filter_cuda"
    _check(name, _REAL, Z, x, P, A, C, Q, R)
    T, m = (int(s) for s in Z.shape)
    n = int(A.shape[0])
    if not fits(n, m) or T < 1:
        raise ValueError(f"{name} takes 1 <= n, m <= {MAX_STATES} and T >= "
                         f"1, got n={n}, m={m}, T={T}")
    for t, shape, what in ((x, (n,), "x"), (P, (n, n), "P"),
                           (A, (n, n), "A"), (C, (m, n), "C"),
                           (Q, (n, n), "Q"), (R, (m, m), "R")):
        _shape(name, t, shape, what)
    dev = Z.device
    N, M = bucket(n), bucket(m)
    x1 = _pad(x, (N,))
    P1 = _pad(P, (N, N))
    X = torch.empty((T, N), dtype=Z.dtype, device=dev)
    kept = ((torch.empty((T, N, N), dtype=Z.dtype, device=dev),
             torch.empty((T, N), dtype=Z.dtype, device=dev),
             torch.empty((T, N, N), dtype=Z.dtype, device=dev))
            if keep else ())
    ptrs = [t.data_ptr() for t in kept] or [None] * 3
    ops = [_pad(Z, (T, M)), _pad(A, (N, N)), _pad(C, (M, N)),
           _pad(Q, (N, N)), _pad(R, (M, M), diag=True)]
    fn = launcher("track_scan.cu", f"kf_forward_{_REAL[Z.dtype]}", _KF_ARGS)
    check_launch(fn(*(t.data_ptr() for t in ops), x1.data_ptr(),
                    P1.data_ptr(), X.data_ptr(), *ptrs, 1, T, N, M,
                    dev.index, stream_of(Z)), name)
    kalman_filter_cuda.launches += 1
    outs = [_cut(X, (T, n)), _cut(x1, (n,)), _cut(P1, (n, n))]
    if keep:
        Pf, Xp, Pp = kept
        outs += [_cut(Pf, (T, n, n)), _cut(Xp, (T, n)), _cut(Pp, (T, n, n))]
    return tuple(outs)


kalman_filter_cuda.launches = 0
kalman_filter_cuda.plain_routes = 0


def rts_backward_cuda(Xf: torch.Tensor, Pf: torch.Tensor, Xp: torch.Tensor,
                      Pp: torch.Tensor, A: torch.Tensor):
    """S4's backward entry (the RTS pass) on one card: Xf, Xp (T, n), Pf, Pp
    (T, n, n) from :func:`kalman_filter_cuda` with ``keep``, A (n, n) ->
    (Xs (T, n), Ps (T, n, n)); adds one to ``launches``."""
    name = "rts_backward_cuda"
    _check(name, _REAL, Xf, Pf, Xp, Pp, A)
    T, n = (int(s) for s in Xf.shape)
    if not 1 <= n <= MAX_STATES or T < 1:
        raise ValueError(f"{name} takes 1 <= n <= {MAX_STATES} and T >= 1")
    for t, shape, what in ((Pf, (T, n, n), "Pf"), (Xp, (T, n), "Xp"),
                           (Pp, (T, n, n), "Pp"), (A, (n, n), "A")):
        _shape(name, t, shape, what)
    N = bucket(n)
    ops = [_pad(Xf, (T, N)), _pad(Pf, (T, N, N)), _pad(Xp, (T, N)),
           _pad(Pp, (T, N, N), diag=True), _pad(A, (N, N))]
    Xs = torch.empty_like(ops[0])
    Ps = torch.empty_like(ops[1])
    fn = launcher("track_scan.cu", f"rts_backward_{_REAL[Xf.dtype]}",
                  _RTS_ARGS)
    check_launch(fn(*(t.data_ptr() for t in ops), Xs.data_ptr(),
                    Ps.data_ptr(), 1, T, N, Xf.device.index,
                    stream_of(Xf)), name)
    rts_backward_cuda.launches += 1
    return _cut(Xs, (T, n)), _cut(Ps, (T, n, n))


rts_backward_cuda.launches = 0


def kalman_lti_cuda(x0: torch.Tensor, B: torch.Tensor, F: torch.Tensor):
    """S4's LTI entry on one card: x_t = F x_{t-1} + b_t over B (T, n),
    float32 or float64, n <= ``MAX_STATES`` -> (X (T, n), x_T); adds one
    to ``launches``."""
    name = "kalman_lti_cuda"
    _check(name, _REAL, B, x0, F)
    T, n = (int(s) for s in B.shape)
    if not 1 <= n <= MAX_STATES or T < 1:
        raise ValueError(f"{name} takes 1 <= n <= {MAX_STATES} and T >= 1")
    _shape(name, x0, (n,), "x0")
    _shape(name, F, (n, n), "F")
    N = bucket(n)
    x1 = _pad(x0, (N,))
    Bp, Fp = _pad(B, (T, N)), _pad(F, (N, N))
    X = torch.empty((T, N), dtype=B.dtype, device=B.device)
    fn = launcher("track_scan.cu", f"kf_lti_{_REAL[B.dtype]}", _LTI_ARGS)
    check_launch(fn(Bp.data_ptr(), Fp.data_ptr(), x1.data_ptr(),
                    X.data_ptr(), 1, T, N, B.device.index, stream_of(B)),
                 name)
    kalman_lti_cuda.launches += 1
    return _cut(X, (T, n)), _cut(x1, (n,))


kalman_lti_cuda.launches = 0
kalman_lti_cuda.plain_routes = 0


def lattice_iir_cuda(y: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """S5 over y (..., N) on one card, float32, float64, complex64 or
    complex128, with reflection coefficients k (..., p) of y's type (its
    leading shape broadcast to y's): x (..., N), each leading index its own
    lattice.  Orders up to 64 run in the smallest register bucket of
    ``LATTICE_ORDERS`` at or above them (k zero-padded), orders above it
    keep the backward errors in a scratch tensor.  Adds one to
    ``launches``; an empty block launches nothing."""
    name = "lattice_iir_cuda"
    _check(name, _LAT, y, k)
    if y.dim() == 0 or k.dim() == 0 or k.shape[-1] < 1:
        raise ValueError(f"{name} takes y (..., N) and k (..., p), p >= 1")
    lead = tuple(y.shape[:-1])
    N, p = int(y.shape[-1]), int(k.shape[-1])
    if N == 0:
        return y.clone()
    B = max(1, int(torch.Size(lead).numel()))
    yc = y.contiguous()
    P = next((b for b in LATTICE_ORDERS if b >= p), p)
    kc = _pad(k.expand(*lead, p).reshape(B, p), (B, P))
    x = torch.empty_like(yc)
    scratch = (torch.empty((B, P), dtype=y.dtype, device=y.device)
               if P > LATTICE_ORDERS[-1] else None)
    fn = launcher("track_scan.cu", f"lattice_iir_{_LAT[y.dtype]}", _LAT_ARGS)
    check_launch(fn(yc.data_ptr(), kc.data_ptr(), x.data_ptr(),
                    None if scratch is None else scratch.data_ptr(), B, N, P,
                    y.device.index, stream_of(y)), name)
    lattice_iir_cuda.launches += 1
    return x


lattice_iir_cuda.launches = 0
