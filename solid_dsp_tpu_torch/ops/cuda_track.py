"""The tracking and prediction recurrences on Hopper (S4, S5): wrappers of
``csrc/track_forward.cu``, ``csrc/track_chunks.cu`` and
``csrc/track_scan.cu``.

S4 is the Kalman filter's walk (``ops/kalman.py``, JAX
``ops/kalman.py:43-124, 156-183``) in three entries, each a time-parallel
chunk-and-join kernel of three launches: :func:`kalman_filter_cuda` (the
predict/update walk, serving ``kalman_apply`` and ``rts_smooth``'s forward
pass, which also keeps the filtered covariances and the predictions;
``track_forward.cu``: each chunk's filtering element, whose data-free
parts :func:`forward_tables` builds on the host, joined in float64 on the
card), :func:`rts_backward_cuda` (the smoother's backward walk) and
:func:`kalman_lti_cuda` (the steady-state x = F x + b, both of
``kalman_lti_apply``'s routes), the last two in ``track_chunks.cu``: chunks
walked from a zero state, joined in float64 (the LTI entry through powers
of F built on the host, ``linrec.join_tables``; the backward entry through
the chunks' own maps x -> M x + e, P -> M P M' + E, composed on the card).
Each entry walks every chunk again from its true start.  S5 is the
all-pole lattice (``analysis/lpc.py::lattice_iir``, JAX
``analysis/lpc.py:233-262``): :func:`lattice_iir_cuda`, one thread a
lattice (``track_scan.cu``).  None replaces a TPU kernel: in the JAX
package each is a ``lax.scan`` or an associative scan.  The sources have
the designs and their bounds.

Each wrapper takes CUDA tensors only, checks types and shapes, launches on
the current stream, raises if the launch fails (``cuda_build.check_launch``)
and adds one to its ``launches`` count (``kalman_lti_cuda.parallel_launches``
counts those of ``kalman_lti_apply``'s ``"parallel"`` route).  The kernels
run fixed register buckets: the wrappers pad n and m to 1, 2, 4 or 8
(:func:`bucket`; zero rows and columns, R and the backward entry's P- with
1 on the padded diagonal, which leaves every real entry's arithmetic as it
is) and the lattice's order to 4, 8, 16, 32 or 64 (zero reflection
coefficients: a stage that leaves its error as it is), and cut the outputs
back.  The Kalman kernels take n <= 8 states and m <= 8 measurements
(:func:`fits`); ``ops/kalman.py`` routes a larger model on the card to the
plain version and counts it on the wrapper's ``plain_routes``.  The plain
versions are ``ops/kalman.py::kalman_walk_plain``, ``rts_backward_plain``
and ``lti_walk_plain`` (the sequential walks a CPU tensor takes),
``kalman_forward_chunked_torch``, ``rts_backward_chunked_torch`` and
``lti_chunked_torch`` (the chunk-and-join kernels' association in torch
ops, against which the card tests hold them) and
``analysis/lpc.py::lattice_iir_plain``.
"""

from __future__ import annotations

import ctypes

import functools

import numpy as np
import torch

from .cuda_build import check_launch, launcher, stream_of
from .linrec import chunk_rows, host_values, join_tables, rounded

__all__ = ["kalman_filter_cuda", "rts_backward_cuda", "kalman_lti_cuda",
           "lattice_iir_cuda", "fits", "bucket", "lti_chunk", "lti_geometry",
           "rts_geometry", "rts_min_chunk", "forward_tables", "fwd_sub",
           "fwd_geometry", "MAX_STATES", "LATTICE_ORDERS", "LTI_THREADS",
           "RTS_CHUNK", "FWD_CHUNK"]

MAX_STATES = 8           # n and m a Kalman kernel takes
# the lattice's register buckets; orders above the last run the generic
# loop with the errors in a scratch tensor
LATTICE_ORDERS = (4, 8, 16, 32, 64)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the forward entry: pointers, lanes, T, N, M, Lc, tl, rl, device, stream
_FWD_ARGS = (_P,) * 16 + (_I, _LL) + (_I,) * 6 + (_P,)
# the chunk-and-join entries: pointers, lanes, T, N, Lc, tl, rl, device,
# stream
_LTI_ARGS = (_P,) * 8 + (_I, _LL) + (_I,) * 5 + (_P,)
_RTS_ARGS = (_P,) * 9 + (_I, _LL) + (_I,) * 5 + (_P,)
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


def _operand(t: torch.Tensor, shape: tuple, diag: bool = False) -> torch.Tensor:
    """A read-only kernel operand: t itself (made contiguous) where it has
    ``shape`` already, else :func:`_pad`'s copy."""
    if tuple(t.shape) == tuple(shape):
        return t.contiguous()
    return _pad(t, shape, diag)


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


# csrc/track_chunks.cu's geometry: chunks a block of the LTI entry's
# passes 1 and 3 (kLtiThreads) and its pass 2's threads at most (kJoin);
# the backward entry's chunk length (torch_kernel_sweep.py s4)
LTI_THREADS = 128
_LTI_JOIN = 256
RTS_CHUNK = 16


def _pow2_log(n: int) -> int:
    """log2 of the smallest power of two >= n (n >= 1)."""
    return max(0, int(n - 1).bit_length())


def _runs(nj: int, join_max: int):
    """(tl, rl): 2^tl threads of pass 2, at most ``join_max``, each a run of
    2^rl of the ``nj`` group starts."""
    tl = min(_pow2_log(join_max), _pow2_log(nj))
    return tl, _pow2_log(-(-nj // (1 << tl)))


def lti_chunk(F: np.ndarray, dtype: torch.dtype) -> int:
    """The LTI entry's chunk length for the one-step map F (n, n) in the
    working type ``dtype``: ``linrec.chunk_rows`` of F, and at least one
    sub-batch of the kernel's staging, 32 / N rows (N = bucket(n))."""
    return max(chunk_rows(F, dtype), 32 // bucket(F.shape[-1]))


def lti_geometry(T: int, chunk: int):
    """(nc, ng, tl, rl, D) of one LTI launch over T steps: nc chunks of
    ``chunk`` steps in ng groups of ``LTI_THREADS``, pass 2's 2^tl threads a
    lane each a run of 2^rl groups, and D join tables Phi^(CB 2^d)."""
    nc = -(-T // chunk)
    ng = -(-nc // LTI_THREADS)
    tl, rl = _runs(max(ng - 1, 1), _LTI_JOIN)
    return nc, ng, tl, rl, rl + tl + 1


def rts_min_chunk(dtype: torch.dtype, N: int) -> int:
    """The backward entry's shortest chunk at the padded size N in
    ``dtype``: its staging's sub-batch, the power of two (at most 32) of
    steps whose 2N + 2N^2 inputs fill ~192 bytes (track_chunks.cu's
    rts_sub)."""
    per = (192 // torch.empty(0, dtype=dtype).element_size()) // (
        2 * N + 2 * N * N)
    return 1 << min(5, max(0, per.bit_length() - 1))


def rts_geometry(T: int, N: int, chunk: int):
    """(nc, ng, tl, rl) of one backward launch over T steps (T - 1 steps of
    the walk) at the padded size N: nc chunks of ``chunk`` steps (at least
    one) in ng groups of 128 chunks (32 at N = 8, where a chunk's map of 2N^2
    + N float64 values would overflow a block's shared memory), pass 2's
    2^tl threads a lane (at most 256, 128 at N = 4, 32 at N = 8) each a run
    of 2^rl groups."""
    nc = max(1, -(-(T - 1) // chunk))
    ng = -(-nc // (128 if N <= 4 else 32))
    tl, rl = _runs(max(ng - 1, 1), 256 if N <= 2 else 128 if N == 4 else 32)
    return nc, ng, tl, rl


def _lanes(name: str, t: torch.Tensor, tail: int):
    """(L, leading shape) of t (*lanes, ...) with ``tail`` trailing axes:
    no leading axis or one."""
    if t.dim() not in (tail, tail + 1):
        raise ValueError(f"{name} takes one sequence or a leading lane axis")
    lead = tuple(t.shape[:t.dim() - tail])
    L = lead[0] if lead else 1
    if not 1 <= L <= 65535:
        raise ValueError(f"{name} takes 1 to 65535 lanes, got {L}")
    return L, lead


def rts_backward_cuda(Xf: torch.Tensor, Pf: torch.Tensor, Xp: torch.Tensor,
                      Pp: torch.Tensor, A: torch.Tensor,
                      chunk: int = RTS_CHUNK):
    """S4's backward entry (the RTS pass) on one card, float32 or float64:
    Xf, Xp ([L,] T, n), Pf, Pp ([L,] T, n, n) from :func:`kalman_filter_cuda`
    with ``keep`` (L lanes, each its own sequence), A (n, n) -> (Xs ([L,] T,
    n), Ps ([L,] T, n, n)); the last step is the filter's.  Chunks of
    ``chunk`` steps (a power of two, at least :func:`rts_min_chunk`); adds
    one to ``launches``."""
    name = "rts_backward_cuda"
    _check(name, _REAL, Xf, Pf, Xp, Pp, A)
    L, lead = _lanes(name, Xf, 2)
    T, n = (int(s) for s in Xf.shape[-2:])
    if not 1 <= n <= MAX_STATES or T < 1:
        raise ValueError(f"{name} takes 1 <= n <= {MAX_STATES} and T >= 1")
    for t, shape, what in ((Pf, lead + (T, n, n), "Pf"),
                           (Xp, lead + (T, n), "Xp"),
                           (Pp, lead + (T, n, n), "Pp"), (A, (n, n), "A")):
        _shape(name, t, shape, what)
    N = bucket(n)
    least = rts_min_chunk(Xf.dtype, N)
    if chunk < least or chunk & (chunk - 1):
        raise ValueError(f"{name}: chunk must be a power of two of at least "
                         f"{least} steps")
    ops = [_operand(Xf.reshape(L, T, n), (L, T, N)),
           _operand(Pf.reshape(L, T, n, n), (L, T, N, N)),
           _operand(Xp.reshape(L, T, n), (L, T, N)),
           _operand(Pp.reshape(L, T, n, n), (L, T, N, N), diag=True),
           _operand(A, (N, N))]
    Xs = torch.empty_like(ops[0])
    Ps = torch.empty_like(ops[1])
    nc, ng, tl, rl = rts_geometry(T, N, chunk)
    f64 = dict(dtype=torch.float64, device=Xf.device)
    maps = torch.empty(L * nc * (2 * N * N + N), **f64)
    starts = torch.empty(L * max(ng - 1, 1) * (N * N + N), **f64)
    fn = launcher("track_chunks.cu", f"rts_chunked_{_REAL[Xf.dtype]}",
                  _RTS_ARGS)
    check_launch(fn(*(t.data_ptr() for t in ops), Xs.data_ptr(),
                    Ps.data_ptr(), maps.data_ptr(), starts.data_ptr(), L, T,
                    N, chunk, tl, rl, Xf.device.index, stream_of(Xf)), name)
    rts_backward_cuda.launches += 1
    return (_cut(Xs, (L, T, n)).reshape(*lead, T, n),
            _cut(Ps, (L, T, n, n)).reshape(*lead, T, n, n))


rts_backward_cuda.launches = 0


def forward_tables(A: np.ndarray, C: np.ndarray, Q: np.ndarray,
                   R: np.ndarray, chunk: int):
    """The forward entry's tables for a model (numpy float64: A (n, n), C
    (m, n), Q (n, n), R (m, m)) and a chunk of ``chunk`` steps.  Step t's
    filtering element (Sarkka and Garcia-Fernandez's: the conditional
    x_t | x_{t-1}, z_t = N(As x_{t-1} + K z_t, Cs) and the likelihood of z_t
    in information form over x_{t-1}, eta = G z_t, Js) has S = C Q C' + R,
    K = Q C' S^-1, As = (I - K C) A, Cs = (I - K C) Q, G = A' C' S^-1 and
    Js = G C A; only (b, eta) depend on z.  Composing ``chunk`` such steps
    gives a chunk's element, whose (A, C, J) parts are the same for every
    full chunk and whose (b, eta) are sums of its measurements: b = sum_i
    Wb[i] z_i, eta = sum_i We[i] z_i.  Returns (Ac, Cc, Jc, Wb, We), Wb and
    We (chunk, n, m).  No inverse of A is taken: each composition solves
    I + C J, whose eigenvalues are at least 1."""
    n = A.shape[0]
    eye = np.eye(n)
    S = C @ Q @ C.T + R
    K = np.linalg.solve(S.T, C @ Q.T).T
    G = np.linalg.solve(S.T, C @ A).T
    As = (eye - K @ C) @ A
    Cs = (eye - K @ C) @ Q
    Cs = (Cs + Cs.T) / 2
    Js = G @ C @ A
    Js = (Js + Js.T) / 2
    Ae, Ce, Je, Wb, We = As, Cs, Js, K[None], G[None]
    for _ in range(1, chunk):
        W = np.linalg.inv(eye + Ce @ Js)
        T1 = As @ W
        U = Ae.T @ W.T
        We = np.concatenate([We - U @ Js @ Wb, (U @ G)[None]])
        Wb = np.concatenate([T1 @ Wb, (T1 @ Ce @ G + K)[None]])
        Ae, Ce, Je = T1 @ Ae, T1 @ Ce @ As.T + Cs, U @ Js @ Ae + Je
    return Ae, Ce, Je, Wb, We


# csrc/track_forward.cu's geometry: the chunk length (torch_kernel_sweep.py
# s4) and the sub-batch budget of its staging, bytes a chunk
FWD_CHUNK = 32
_FWD_TILE_BYTES = 384


def fwd_sub(dtype: torch.dtype, N: int, M: int, keep: bool) -> int:
    """The forward entry's staging sub-batch at the padded sizes N, M: the
    power of two (at most 32) of steps whose two buffers of measurements
    (M values a step) and outputs (X, and with ``keep`` Pf, Xp and Pp) fill
    ~384 bytes a chunk (track_forward.cu's fwd_sub)."""
    size = torch.empty(0, dtype=dtype).element_size()
    per = (_FWD_TILE_BYTES // size) // (
        2 * M + N + (2 * N * N + N if keep else 0))
    return 1 << min(5, max(0, per.bit_length() - 1))


def fwd_geometry(T: int, N: int, chunk: int):
    """(nc, ng, tl, rl) of one forward launch over T steps at the padded
    size N: nc chunks of ``chunk`` steps in ng groups of 128 (32 at N = 8,
    where a chunk's element of 3N^2 + 2N float64 values would overflow a
    block's shared memory), pass 2's 2^tl threads a lane (at most 256, 64
    at N = 4, 16 at N = 8) each a run of 2^rl groups."""
    nc = -(-T // chunk)
    ng = -(-nc // (128 if N <= 4 else 32))
    tl, rl = _runs(max(ng - 1, 1), 256 if N <= 2 else 64 if N == 4 else 16)
    return nc, ng, tl, rl


@functools.lru_cache(maxsize=64)
def _fwd_tables(model: bytes, n: int, m: int, N: int, M: int, chunk: int,
                device: torch.device) -> torch.Tensor:
    """:func:`forward_tables` of the model whose float64 values (A, C, Q, R,
    already rounded to the working type) are ``model``, padded to N, M and
    laid out as the kernel reads them (Ac, Cc, Jc (N, N), Wb, We (chunk, N,
    M)), on ``device``; built once per model, chunk and device."""
    v = np.frombuffer(model, np.float64)
    sizes = (n * n, m * n, n * n, m * m)
    A, C, Q, R = (a.reshape(s) for a, s in zip(
        np.split(v, np.cumsum(sizes)[:-1]), ((n, n), (m, n), (n, n), (m, m))))
    Ac, Cc, Jc, Wb, We = forward_tables(A, C, Q, R, chunk)
    mats = np.zeros((3, N, N))
    mats[:, :n, :n] = (Ac, Cc, Jc)
    W = np.zeros((2, chunk, N, M))
    W[:, :, :n, :m] = (Wb, We)
    return torch.from_numpy(np.concatenate([mats.ravel(), W.ravel()])).to(
        device)


def kalman_filter_cuda(x: torch.Tensor, P: torch.Tensor, Z: torch.Tensor,
                       A: torch.Tensor, C: torch.Tensor, Q: torch.Tensor,
                       R: torch.Tensor, keep: bool = False,
                       chunk: int = FWD_CHUNK, host=None):
    """S4's forward entry over Z ([L,] T, m) on one card, float32 or
    float64: x ([L,] n), P ([L,] n, n), A (n, n), C (m, n), Q (n, n), R (m,
    m), n and m at most ``MAX_STATES``, L lanes each its own sequence.
    Returns (X ([L,] T, n), x_T, P_T) and, with ``keep``, also (Pf ([L,] T,
    n, n), Xp ([L,] T, n), Pp ([L,] T, n, n)).  Chunks of ``chunk`` steps (a
    power of two; at least the kernel's sub-batch, :func:`fwd_sub` without
    ``keep``); ``host``, where given, holds the model's values (numpy, or
    the tensors they came from; else ``linrec.host_values`` reads A, C, Q,
    R once per tensor) for the tables of :func:`forward_tables`.  Adds one
    to ``launches``."""
    name = "kalman_filter_cuda"
    _check(name, _REAL, Z, x, P, A, C, Q, R)
    L, lead = _lanes(name, Z, 2)
    T, m = (int(s) for s in Z.shape[-2:])
    n = int(A.shape[0])
    if not fits(n, m) or T < 1:
        raise ValueError(f"{name} takes 1 <= n, m <= {MAX_STATES} and T >= "
                         f"1, got n={n}, m={m}, T={T}")
    for t, shape, what in ((x, lead + (n,), "x"), (P, lead + (n, n), "P"),
                           (A, (n, n), "A"), (C, (m, n), "C"),
                           (Q, (n, n), "Q"), (R, (m, m), "R")):
        _shape(name, t, shape, what)
    dev, dt = Z.device, Z.dtype
    N, M = bucket(n), bucket(m)
    least = fwd_sub(dt, N, M, False)
    if chunk < least or chunk & (chunk - 1):
        raise ValueError(f"{name}: chunk must be a power of two of at least "
                         f"{least} steps")
    nc, ng, tl, rl = fwd_geometry(T, N, chunk)
    tabs = None
    if nc > 1:
        model = np.concatenate([host_values(h).ravel()
                                for h in host or (A, C, Q, R)])
        tabs = _fwd_tables(rounded(model, dt).tobytes(), n, m, N, M, chunk,
                           dev)
    ops = [_operand(Z.reshape(L, T, m), (L, T, M)), _operand(A, (N, N)),
           _operand(C, (M, N)), _operand(Q, (N, N)),
           _operand(R, (M, M), diag=True), _operand(x.reshape(L, n), (L, N)),
           _operand(P.reshape(L, n, n), (L, N, N))]
    X = torch.empty((L, T, N), dtype=dt, device=dev)
    xo = torch.empty((L, N), dtype=dt, device=dev)
    Po = torch.empty((L, N, N), dtype=dt, device=dev)
    kept = ((torch.empty((L, T, N, N), dtype=dt, device=dev),
             torch.empty((L, T, N), dtype=dt, device=dev),
             torch.empty((L, T, N, N), dtype=dt, device=dev))
            if keep else ())
    f64 = dict(dtype=torch.float64, device=dev)
    elems = torch.empty(L * nc * (3 * N * N + 2 * N), **f64)
    starts = torch.empty(L * max(ng - 1, 1) * (N * N + N), **f64)
    fn = launcher("track_forward.cu", f"kf_forward_chunked_{_REAL[dt]}",
                  _FWD_ARGS)
    check_launch(fn(*(t.data_ptr() for t in ops), X.data_ptr(),
                    xo.data_ptr(), Po.data_ptr(),
                    *([t.data_ptr() for t in kept] or [None] * 3),
                    None if tabs is None else tabs.data_ptr(),
                    elems.data_ptr(), starts.data_ptr(), L, T, N, M, chunk,
                    tl, rl, dev.index, stream_of(Z)), name)
    kalman_filter_cuda.launches += 1
    outs = [_cut(X, (L, T, n)).reshape(*lead, T, n),
            _cut(xo, (L, n)).reshape(*lead, n),
            _cut(Po, (L, n, n)).reshape(*lead, n, n)]
    if keep:
        Pf, Xp, Pp = kept
        outs += [_cut(Pf, (L, T, n, n)).reshape(*lead, T, n, n),
                 _cut(Xp, (L, T, n)).reshape(*lead, T, n),
                 _cut(Pp, (L, T, n, n)).reshape(*lead, T, n, n)]
    return tuple(outs)


kalman_filter_cuda.launches = 0
kalman_filter_cuda.plain_routes = 0


@functools.lru_cache(maxsize=64)
def _lti_tables(f_bytes: bytes, N: int, dtype: torch.dtype, chunk: int,
                D: int, device: torch.device):
    """(join tables, F in ``dtype``) on ``device`` for the padded F (N, N)
    of these float64 values (already rounded to ``dtype``), built once per
    F and geometry."""
    F = np.frombuffer(f_bytes, np.float64).reshape(N, N)
    return (torch.from_numpy(join_tables(F, chunk, LTI_THREADS, D)).to(device),
            torch.from_numpy(F.copy()).to(device, dtype))


def kalman_lti_cuda(x0: torch.Tensor, B: torch.Tensor, F: torch.Tensor,
                    F_host=None, parallel: bool = False,
                    chunk: int | None = None):
    """S4's LTI entry on one card: x_t = F x_{t-1} + b_t over B ([L,] T, n),
    float32 or float64, n <= ``MAX_STATES``, from x0 ([L,] n) -> (X ([L,] T,
    n), x_T ([L,] n)).  F (n, n) is rounded to B's dtype; ``F_host``, where
    given, holds its values (numpy, or the tensor it came from; else
    ``linrec.host_values`` reads F once per tensor).  Chunks of ``chunk``
    steps (a power of two, at least 32 / bucket(n); by default
    :func:`lti_chunk` of F).  Adds one
    to ``launches``, and to ``parallel_launches`` for the ``"parallel"``
    route (``parallel``); an empty block launches nothing."""
    name = "kalman_lti_cuda"
    _check(name, _REAL, B, x0, F)
    L, lead = _lanes(name, B, 2)
    T, n = (int(s) for s in B.shape[-2:])
    if not 1 <= n <= MAX_STATES:
        raise ValueError(f"{name} takes 1 <= n <= {MAX_STATES}")
    _shape(name, x0, lead + (n,), "x0")
    _shape(name, F, (n, n), "F")
    if T == 0:
        return B.clone(), x0.clone()
    N = bucket(n)
    Fr = np.zeros((N, N))
    Fr[:n, :n] = rounded(host_values(F if F_host is None else F_host),
                         B.dtype)
    if chunk is None:
        chunk = lti_chunk(Fr[:n, :n], B.dtype)
    if chunk < 32 // N or chunk & (chunk - 1):
        raise ValueError(f"{name}: chunk must be a power of two of at least "
                         f"{32 // N} steps")
    nc, ng, tl, rl, D = lti_geometry(T, chunk)
    tabs, Fd = _lti_tables(Fr.tobytes(), N, B.dtype, chunk, D, B.device)
    Bp = _operand(B.reshape(L, T, n), (L, T, N))
    st = _operand(x0.reshape(L, n), (L, N))
    X = torch.empty_like(Bp)
    st_out = torch.empty_like(st)
    f64 = dict(dtype=torch.float64, device=B.device)
    loc = torch.empty(L * nc * N, **f64)
    G = torch.empty(L * max(ng - 1, 1) * N, **f64)
    fn = launcher("track_chunks.cu", f"kf_lti_chunked_{_REAL[B.dtype]}",
                  _LTI_ARGS)
    check_launch(fn(Bp.data_ptr(), X.data_ptr(), Fd.data_ptr(),
                    st.data_ptr(), st_out.data_ptr(), tabs.data_ptr(),
                    loc.data_ptr(), G.data_ptr(), L, T, N, chunk, tl, rl,
                    B.device.index, stream_of(B)), name)
    kalman_lti_cuda.launches += 1
    if parallel:
        kalman_lti_cuda.parallel_launches += 1
    return (_cut(X, (L, T, n)).reshape(B.shape),
            _cut(st_out, (L, n)).reshape(x0.shape))


kalman_lti_cuda.launches = 0
kalman_lti_cuda.parallel_launches = 0
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
