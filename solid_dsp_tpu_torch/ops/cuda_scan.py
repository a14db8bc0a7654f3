"""The scans on Hopper (S1, S2, S3): wrappers of ``csrc/seq_scan.cu`` and
``csrc/iir_scan.cu``.

S1 is the exact per-sample AGC (``ops/agc.py::_agc_scan``, JAX
``ops/agc.py:108-149``) with a second entry point that runs the squelch FSM
alone over a given rssi track; S2 is the decision-directed QPSK Costas loop
(``models/qpsk.py::qpsk_carrier_pll``, JAX ``models/qpsk.py:101-126``).
Both are nonlinear: one thread walks one sequence (a leading index) in
time order.  The FSM entry (JAX ``ops/agc.py:333-343``) is exactly
time-parallel: chunks summarised by their finite maps, the summaries
joined, each chunk walked again from its entry (:func:`squelch_fsm_cuda`).  S3 is the IIR filters' direct-form-II w-recurrence
(``ops/iir.py``'s ``"scan"`` and ``"parallel"`` routes, JAX
``ops/iir.py:117-153``), linear, so time-parallel: chunks of
``linrec.chunk_rows`` rows run from a zero state, their ends joined through
float64 powers of the companion matrix (``linrec.join_tables``), each chunk
rerun from its true start; :func:`sos_cascade_cuda` runs a biquad cascade
the same way in one pipeline.  The host's side of that evaluation (the
one-step maps, the tables, the chunk rule, the coefficients' host values)
lives in ``ops/linrec.py``, shared with the plain versions.  None replaces a TPU kernel: in the JAX
package each is a ``lax.scan`` (or an associative scan), and a per-sample
recurrence in eager torch ops would cost ~15-20 launches a sample.  The
sources have the designs.

Each wrapper takes CUDA tensors only, checks types and shapes, launches the
kernel on the current stream, raises if the launch fails
(``cuda_build.check_launch``) and adds one to its ``launches`` count.  The
plain versions are ``ops/agc.py::agc_scan_plain`` and
``squelch_fsm_plain`` (and ``squelch_fsm_chunked_torch``, the FSM entry's
three passes), ``models/qpsk.py::costas_pll_plain``,
``ops/iir.py::iir_chunked_torch`` and ``sos_cascade_chunked_torch``; the
dispatchers there take the plain versions (for S3, the sequential walk
``iir_scan_torch`` or the doubling scan of ``ops/linrec.py``) for CPU
tensors only.  ``agc_scan_cuda.fallback_launches`` counts the S1 launches
made with ``fallback=True``, as ``agc_apply_parallel``'s fall-back makes
them (they count on ``launches`` too); ``iir_scan_cuda.parallel_launches``
the S3 launches of the ``"parallel"`` route.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .cuda_build import check_launch, launcher, stream_of
from .linrec import S3_CHUNK, WIDE, cascade_matrix, chunk_rows, companion, \
    host_values, join_tables, rounded

__all__ = ["agc_scan_cuda", "squelch_fsm_cuda", "costas_pll_cuda",
           "FSM_CHUNK", "FSM_THREADS", "FSM_SMALL", "fsm_geometry",
           "iir_scan_cuda", "sos_cascade_cuda", "chunk_geometry",
           "JOIN_THREADS"]

_P, _I, _LL, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_double
_AGC_ARGS = (_P,) * 7 + (_I, _LL) + (_D,) * 5 + (_I, _I, _P)
_FSM_ARGS = (_P,) * 4 + (_I, _LL, _D, _I, _I, _I) + (_P,) * 4 + (_I, _P)
# S1's FSM entry: steps a chunk (a multiple of 32) and chunks a block, and
# up to how many steps in all the smallest blocks are taken
# (torch_kernel_sweep.py fsm); a chunk's summary is 11 int32
# (fsm::Summary in csrc/seq_scan.cu)
FSM_CHUNK = 64
FSM_THREADS = 128
FSM_SMALL = (32, 32, 1 << 17)
_SUMMARY_INTS = 11
_SMEM_LIMIT = 227 * 1024     # shared memory one block may use on sm_90
_PLL_ARGS = (_P,) * 4 + (_I, _LL) + (_D,) * 3 + (_I, _P)
_S3_SUFFIX = {torch.float32: "f32", torch.float64: "f64",
              torch.complex64: "c64", torch.complex128: "c128"}
_SUFFIX = {torch.complex64: "f32", torch.complex128: "f64",
           torch.float32: "f32", torch.float64: "f64"}
_REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}


def _check(x: torch.Tensor, name: str, complex_in: bool = True):
    if not x.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors; CPU tensors take the "
                         "plain version")
    ok = (torch.complex64, torch.complex128) if complex_in else (
        torch.float32, torch.float64)
    if x.dtype not in ok:
        raise TypeError(f"{name} takes {ok}, got {x.dtype}")
    if x.dim() == 0 or x.shape[-1] == 0:
        raise ValueError(f"{name} needs a non-empty time axis")


def _rows(t: torch.Tensor, lead: tuple, dtype, device) -> torch.Tensor:
    """A state leaf as a contiguous (B,) tensor of ``dtype`` (broadcast to
    the block's leading shape), a copy the kernel updates in place."""
    return (t.to(device=device, dtype=dtype).expand(lead).reshape(-1)
            .clone(memory_format=torch.contiguous_format))


def agc_scan_cuda(state: dict, x: torch.Tensor, c1: float, c2: float,
                  c3: float, scale: float, thr: float, timeout: int,
                  fallback: bool = False):
    """S1 over x (..., T) complex64 or complex128 on one card, each leading
    index its own carry: (y, new_state).  ``c1, c2, c3`` are the update's
    constants (1 - alpha, alpha, -alpha / 2) in the working real type, as
    ``ops/agc.py::agc_scan_consts`` makes them; ``scale`` is real.
    ``fallback``: the launch is a fall-back of the Newton solve (counted on
    ``fallback_launches`` as well)."""
    _check(x, "agc_scan_cuda")
    rdt = _REAL[x.dtype]
    lead = tuple(x.shape[:-1])
    T = int(x.shape[-1])
    B = max(1, int(torch.Size(lead).numel()))
    xc = x.contiguous()
    y = torch.empty_like(xc)
    gain = _rows(state["gain"], lead, rdt, x.device)
    energy = _rows(state["energy"], lead, rdt, x.device)
    lock = _rows(state["lock"], lead, torch.uint8, x.device)
    mode = _rows(state["mode"], lead, torch.int32, x.device)
    timer = _rows(state["timer"], lead, torch.int32, x.device)
    fn = launcher("seq_scan.cu", f"agc_scan_{_SUFFIX[x.dtype]}", _AGC_ARGS)
    check_launch(fn(xc.data_ptr(), y.data_ptr(), gain.data_ptr(),
                    energy.data_ptr(), lock.data_ptr(), mode.data_ptr(),
                    timer.data_ptr(), B, T, float(c1), float(c2), float(c3),
                    float(scale), float(thr), int(timeout), x.device.index,
                    stream_of(x)), "agc_scan_cuda")
    agc_scan_cuda.launches += 1
    if fallback:
        agc_scan_cuda.fallback_launches += 1
    out_state = {"gain": gain.reshape(lead).to(state["gain"].dtype),
                 "energy": energy.reshape(lead).to(state["energy"].dtype),
                 "lock": state["lock"].to(x.device).expand(lead).clone(),
                 "mode": mode.reshape(lead), "timer": timer.reshape(lead)}
    return y, out_state


agc_scan_cuda.launches = 0
agc_scan_cuda.fallback_launches = 0


def fsm_geometry(B: int, T: int):
    """(steps a chunk, chunks a block) of S1's FSM entry for B lanes of T
    steps: (FSM_CHUNK, FSM_THREADS), or the smallest blocks (FSM_SMALL)
    where B T is at most FSM_SMALL[2] steps, so that a short track still
    spreads over many SMs."""
    if B * T <= FSM_SMALL[2]:
        return FSM_SMALL[:2]
    return FSM_CHUNK, FSM_THREADS


def squelch_fsm_cuda(rssi: torch.Tensor, mode: torch.Tensor,
                     timer: torch.Tensor, thr: float, timeout: int,
                     chunk: int | None = None, threads: int | None = None):
    """S1's FSM alone over rssi (..., T) float32 or float64 on one card:
    (modes (..., T) int32, final mode, final timer).  Time-parallel in three
    launches (csrc/seq_scan.cu's fsm namespace): chunks of ``chunk`` steps
    (a multiple of 32) summarised ``threads`` to a block (both from
    :func:`fsm_geometry` unless given), joined, walked again; the plain
    version of the same passes is ``ops/agc.py::squelch_fsm_chunked_torch``."""
    _check(rssi, "squelch_fsm_cuda", complex_in=False)
    lead = tuple(rssi.shape[:-1])
    T = int(rssi.shape[-1])
    B = max(1, int(torch.Size(lead).numel()))
    rs = rssi.contiguous()
    dev = rs.device
    modes = torch.empty(rs.shape, dtype=torch.int32, device=dev)
    m = _rows(mode, lead, torch.int32, dev)
    t = _rows(timer, lead, torch.int32, dev)
    if chunk is None or threads is None:
        chunk, threads = fsm_geometry(B, T)
    if chunk % 32 or not 32 <= threads <= 1024 or threads % 32:
        raise ValueError("squelch_fsm_cuda takes chunks of a multiple of 32 "
                         "steps and 32 to 1024 chunks a block, a multiple of "
                         "32")
    # pass 3 stages a block's modes: its bits and NT rows of C + 1 words
    if threads * chunk // 8 + threads * (chunk + 1) * 4 > _SMEM_LIMIT:
        raise ValueError(f"{threads} chunks of {chunk} steps a block do not "
                         "fit one block's shared memory")
    nb = -(-T // (threads * chunk))
    # scratch: the chunks' in-block prefixes and the blocks' totals (a
    # summary each), the blocks' entry states, the steps' bits
    incl = torch.empty(B * nb * threads * _SUMMARY_INTS, dtype=torch.int32,
                       device=dev)
    totals = torch.empty(B * nb * _SUMMARY_INTS, dtype=torch.int32,
                         device=dev)
    starts = torch.empty(B * nb * 2, dtype=torch.int32, device=dev)
    bits = torch.empty(B * nb * threads * chunk // 32, dtype=torch.int32,
                       device=dev)
    fn = launcher("seq_scan.cu", f"squelch_fsm_{_SUFFIX[rs.dtype]}",
                  _FSM_ARGS)
    check_launch(fn(rs.data_ptr(), modes.data_ptr(), m.data_ptr(),
                    t.data_ptr(), B, T, float(thr), int(timeout), int(chunk),
                    int(threads), incl.data_ptr(), totals.data_ptr(),
                    starts.data_ptr(), bits.data_ptr(), dev.index,
                    stream_of(rs)),
                 "squelch_fsm_cuda")
    squelch_fsm_cuda.launches += 1
    return modes, m.reshape(lead), t.reshape(lead)


squelch_fsm_cuda.launches = 0


def costas_pll_cuda(x: torch.Tensor, alpha: float, beta: float, h: float,
                    theta0: torch.Tensor, dtheta0: torch.Tensor):
    """S2 over x (..., T) complex64 or complex128 on one card, each leading
    index its own loop: (y, theta_end, dtheta_end).  ``alpha``, ``beta``
    and the constellation's half-side ``h`` are rounded to the working real
    type by the kernel."""
    _check(x, "costas_pll_cuda")
    rdt = _REAL[x.dtype]
    lead = tuple(x.shape[:-1])
    T = int(x.shape[-1])
    B = max(1, int(torch.Size(lead).numel()))
    xc = x.contiguous()
    y = torch.empty_like(xc)
    th = _rows(theta0, lead, rdt, x.device)
    dth = _rows(dtheta0, lead, rdt, x.device)
    fn = launcher("seq_scan.cu", f"costas_pll_{_SUFFIX[x.dtype]}", _PLL_ARGS)
    check_launch(fn(xc.data_ptr(), y.data_ptr(), th.data_ptr(),
                    dth.data_ptr(), B, T, float(alpha), float(beta), float(h),
                    x.device.index, stream_of(x)), "costas_pll_cuda")
    costas_pll_cuda.launches += 1
    return y, th.reshape(lead), dth.reshape(lead)


costas_pll_cuda.launches = 0


# ---------------------------------------------------------------------------
# S3 and the fused biquad cascade: the chunk-and-join kernel of
# csrc/iir_scan.cu
# ---------------------------------------------------------------------------

JOIN_THREADS = 256       # threads a block of the join (pass 2), at most
_PASS_THREADS = 128      # kThreads in csrc/iir_scan.cu
_JOIN_SMEM = 200 * 1024  # the join's shared memory, at most
_CHUNKED_ARGS = (_P,) * 8 + (_I, _LL) + (_I,) * 7 + (_I, _P)


@functools.lru_cache(maxsize=64)
def _tables(kind: str, coef_bytes: bytes, cplx: bool, shape: tuple,
            dtype: torch.dtype, chunk: int, cb: int, D: int,
            device: torch.device):
    """(join tables, coefficients in ``dtype``) on ``device``, built once
    per coefficient set and geometry."""
    coef = np.frombuffer(coef_bytes, np.complex128 if cplx
                         else np.float64).reshape(shape)
    A = companion(coef) if kind == "s3" else cascade_matrix(coef)
    return (torch.from_numpy(join_tables(A, chunk, cb, D)).to(device),
            torch.from_numpy(coef.copy()).to(device, dtype))


def _pow2_log(n: int) -> int:
    """log2 of the smallest power of two >= n (n >= 1)."""
    return max(0, int(n - 1).bit_length())


def chunk_geometry(B: int, T: int, N: int, acc_bytes: int, cb_one: bool,
                   chunk: int = S3_CHUNK, join_threads: int = JOIN_THREADS):
    """(lb, cb, nc, ng, jl, tl, rl, D) of one launch (csrc/iir_scan.cu):
    blocks of 2^lb lanes (B rounded up to a power of two, at most 32) x cb
    chunks (128 / 2^lb, or 1 for S3 of order > 8), nc chunks of ``chunk``
    rows in ng groups; the join's blocks of 2^jl threads (at most
    ``join_threads``, fewer where its two N-vectors a thread in float64
    exceed its shared memory), 2^tl runs a lane of 2^rl groups; D join
    tables Phi^(cb 2^d)."""
    lb = min(_pow2_log(B), 5)
    cb = 1 if cb_one else _PASS_THREADS >> lb
    nc = -(-T // chunk)
    ng = -(-nc // cb)
    nj = max(ng - 1, 1)
    jl = _pow2_log(join_threads)
    while jl > 0 and 2 * N * (1 << jl) * acc_bytes > _JOIN_SMEM:
        jl -= 1
    tl = min(jl, _pow2_log(nj))
    rl = _pow2_log(-(-nj // (1 << tl)))
    return lb, cb, nc, ng, jl, tl, rl, rl + tl + 1


def _chunked_launch(entry: str, kind: str, x: torch.Tensor, coef: np.ndarray,
                    cdt: torch.dtype, st_in: torch.Tensor, B: int, N: int,
                    n_arg: int, cb_one: bool, chunk: int | None = None,
                    join_threads: int = JOIN_THREADS):
    """One call of the chunk-and-join kernel over x (T, B) of its working
    type with the host coefficients ``coef`` (their values in ``cdt``) and
    the state (N, B): (y, new state (N, B)).  ``chunk`` None takes
    ``linrec.chunk_rows`` of the one-step map."""
    T = int(x.shape[0])
    acc = WIDE[x.dtype] if kind == "s3" else torch.float64
    acc_bytes = torch.empty(0, dtype=acc).element_size()
    if chunk is None:
        chunk = chunk_rows(companion(coef) if kind == "s3"
                           else cascade_matrix(coef), x.dtype)
    lb, cb, nc, ng, jl, tl, rl, D = chunk_geometry(B, T, N, acc_bytes, cb_one,
                                                    chunk, join_threads)
    tabs, coef_dev = _tables(kind, np.ascontiguousarray(coef).tobytes(),
                             np.iscomplexobj(coef), coef.shape, cdt, chunk,
                             cb, D, x.device)
    loc = torch.empty(nc * N * B, dtype=acc, device=x.device)
    G = torch.empty(max(ng - 1, 1) * N * B, dtype=acc, device=x.device)
    y = torch.empty_like(x)
    st_out = torch.empty_like(st_in)
    fn = launcher("iir_scan.cu", entry, _CHUNKED_ARGS)
    check_launch(fn(x.data_ptr(), y.data_ptr(), coef_dev.data_ptr(),
                    st_in.data_ptr(), st_out.data_ptr(), tabs.data_ptr(),
                    loc.data_ptr(), G.data_ptr(), B, T, n_arg, chunk, lb, cb,
                    jl, tl, rl, x.device.index, stream_of(x)), entry)
    return y, st_out


def iir_scan_cuda(a_tail: torch.Tensor, w_state: torch.Tensor,
                  x: torch.Tensor, a_host=None, parallel: bool = False,
                  chunk: int | None = None,
                  join_threads: int = JOIN_THREADS):
    """S3 over x (T, *lanes) on one card, float32, float64, complex64 or
    complex128: w[n] = x[n] - sum_i a_tail[i] w[n-1-i] for each lane, the
    history ``w_state`` (*lanes, k) = [w[-1], ..., w[-k]] carried in.
    ``a_tail`` (k,), k >= 1, is rounded to x's dtype; ``a_host``, where
    given, holds its values (or is the tensor it was converted from; else
    ``linrec.host_values`` reads ``a_tail`` once per tensor).  Returns (w (T, *lanes), new w_state (*lanes,
    k)), in x's dtype.  Launches csrc/iir_scan.cu (chunks of ``chunk`` rows,
    by default ``linrec.chunk_rows`` of the companion matrix; the join's
    blocks of at most ``join_threads``) and adds one to
    ``iir_scan_cuda.launches``, and to ``.parallel_launches`` for the
    ``"parallel"`` route (``parallel``); an empty block launches nothing."""
    if not x.is_cuda:
        raise ValueError("iir_scan_cuda needs CUDA tensors; CPU tensors take "
                         "the plain version")
    if x.dtype not in _S3_SUFFIX:
        raise TypeError(f"iir_scan_cuda takes {tuple(_S3_SUFFIX)}, got "
                        f"{x.dtype}")
    if x.dim() == 0:
        raise ValueError("iir_scan_cuda needs a time axis (axis 0)")
    k = int(a_tail.shape[-1])
    if a_tail.dim() != 1 or k < 1:
        raise ValueError("iir_scan_cuda takes a_tail of shape (k,), k >= 1")
    lanes = tuple(x.shape[1:])
    T = int(x.shape[0])
    B = max(1, int(torch.Size(lanes).numel()))
    state = (w_state.to(device=x.device, dtype=x.dtype)
             .expand(*lanes, k).reshape(B, k))
    if T == 0:
        return x.clone(), state.clone().reshape(*lanes, k)
    a = rounded(host_values(a_tail if a_host is None else a_host), x.dtype)
    w, st = _chunked_launch(
        f"iir_chunked_{_S3_SUFFIX[x.dtype]}", "s3", x.contiguous(), a,
        x.dtype, state.t().contiguous(), B, k, k, k > 8, chunk, join_threads)
    iir_scan_cuda.launches += 1
    if parallel:
        iir_scan_cuda.parallel_launches += 1
    return w, st.t().reshape(*lanes, k)


iir_scan_cuda.launches = 0
iir_scan_cuda.parallel_launches = 0


def sos_cascade_cuda(sos_b, sos_a_tail, state: torch.Tensor,
                     x: torch.Tensor, coef_host=None):
    """A biquad cascade over x (T, *lanes) on one card in one pipeline of
    launches (csrc/iir_scan.cu): sos_b (S, 3) and sos_a_tail (S, 2) real
    a0-normalised coefficients, 1 <= S <= 8, rounded to x's real type;
    state (S, *lanes, 2) (or (S, 2), broadcast) of per-section [w[n-1],
    w[n-2]] in x's dtype (float32, float64, complex64 or complex128).
    ``coef_host``: the (S, 5) [b0 b1 b2 a1 a2] values on the host where the
    caller has them.  Each row runs K6's step (csrc/iir_bank.cu), so y
    agrees with one :func:`iir_apply` a section to rounding, not bit for
    bit.  Returns (y (T, *lanes), new state (S, *lanes, 2)); adds one to
    ``sos_cascade_cuda.launches``."""
    if not x.is_cuda:
        raise ValueError("sos_cascade_cuda needs CUDA tensors")
    if x.dtype not in _S3_SUFFIX:
        raise TypeError(f"sos_cascade_cuda takes {tuple(_S3_SUFFIX)}, got "
                        f"{x.dtype}")
    S = int(sos_b.shape[0])
    if not 1 <= S <= 8 or tuple(sos_b.shape) != (S, 3) or tuple(
            sos_a_tail.shape) != (S, 2):
        raise ValueError("sos_cascade_cuda takes 1 to 8 sections, sos_b "
                         "(S, 3) and sos_a_tail (S, 2)")
    if coef_host is None:
        coef_host = np.concatenate([host_values(sos_b),
                                    host_values(sos_a_tail)], axis=1)
    if np.any(np.imag(coef_host)):
        raise TypeError("sos_cascade_cuda takes real coefficients")
    rdt = _REAL.get(x.dtype, x.dtype)
    coef = rounded(np.real(coef_host), rdt)
    lanes = tuple(x.shape[1:])
    T = int(x.shape[0])
    state = state.to(device=x.device, dtype=x.dtype)
    st = state.reshape(S, *(1,) * (len(lanes) + 2 - state.dim()),
                       *state.shape[1:]).expand(S, *lanes, 2)
    if T == 0:
        return x.clone(), st.clone()
    # real lanes: a complex lane is two (re, im), the state rows
    # [w1_0, w2_0, w1_1, ...] = (S, 2, lanes)
    xr = torch.view_as_real(x) if x.is_complex() else x
    B = max(1, int(torch.Size(xr.shape[1:]).numel()))
    st_r = torch.view_as_real(st) if x.is_complex() else st
    st_r = st_r.movedim(-1 if not x.is_complex() else -2, 1).reshape(2 * S, B)
    y, st_o = _chunked_launch(
        f"sos_chunked_{_S3_SUFFIX[rdt]}", "sos", xr.contiguous().reshape(T, B),
        coef, rdt, st_r.contiguous(), B, 2 * S, S, False)
    sos_cascade_cuda.launches += 1
    st_o = st_o.reshape(S, 2, *xr.shape[1:]).movedim(1, -1 if not
                                                     x.is_complex() else -2)
    if x.is_complex():
        return (torch.view_as_complex(y.reshape(xr.shape)),
                torch.view_as_complex(st_o.contiguous()))
    return y.reshape(x.shape), st_o


sos_cascade_cuda.launches = 0
