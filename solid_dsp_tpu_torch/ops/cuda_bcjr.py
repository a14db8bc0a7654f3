"""Turbo decoding's max-log BCJR walk on Hopper (S6): the wrappers of
``csrc/bcjr_scan.cu``.

S6 walks a terminated RSC constituent as a time-parallel chunk-and-join in
the max-plus semiring (the source has the design, its precision argument
and its bound): chunks of 32 steps compose their 8 x 8 step
matrices, a float64 join carries alpha and beta over the chunks'
boundaries, and each chunk is walked again from them with its LLRs, a
thread block a row.  It replaces no TPU kernel: in the JAX package the
walk is two ``lax.scan``s (``solid_dsp_tpu/models/turbo.py:276`` and
``:312``) and the a-posteriori step ``:318-324``, and the decode the loop
of ``_turbo_decode_perm`` (``:326-344``).  Two entries:

* :func:`bcjr_maxlog_cuda`, one constituent's LLRs over (B, T + m) rows,
  one launch (``.launches``);
* :func:`turbo_decode_cuda`, the whole iterative decode, one launch
  (``.launches``), where :func:`fused_fits` says the codeword fits a
  block's shared memory.

Their torch-ops counterparts are ``models/turbo.py::
bcjr_maxlog_chunked_torch`` and ``turbo_decode_chunked_torch`` (the
kernels are bit-equal to them); a CPU tensor takes the plain version
``bcjr_maxlog_plain``.  The wrappers take CUDA tensors only, check types,
shapes and the 8-state trellis (m = 3, the LTE constituent), allocate the
outputs and scratch, launch on the current stream, raise if the launch
fails (``cuda_build.check_launch``) and add one to their count.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..device import device_constant
from .cuda_build import check_launch, launcher, stream_of

__all__ = ["bcjr_maxlog_cuda", "turbo_decode_cuda", "fused_fits",
           "shift_layout", "STATES"]

STATES = 8
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = (_P,) * 5 + (_I, _I, _I, _I, _P)
_DECODE_ARGS = (_P,) * 5 + (_I, _I, _I, _I, _P)


@functools.lru_cache(maxsize=8)
def _tables(ns_bytes: bytes, p_bytes: bytes, prev_bytes: bytes,
            prev_u_bytes: bytes):
    """The kernel's host tables, 5 x (8, 2) ints: next state, parity, the
    two predecessors of each state, the input on each incoming transition
    (``models/turbo.py::_rsc_tables``) and its parity, p[prev, prev_u]."""
    ns, p, prev, prev_u = (np.frombuffer(b, np.int64).reshape(STATES, 2)
                           for b in (ns_bytes, p_bytes, prev_bytes,
                                     prev_u_bytes))
    flat = np.concatenate([a.reshape(-1) for a in (ns, p, prev, prev_u,
                                                   p[prev, prev_u])])
    return (ctypes.c_int * flat.size)(*flat.tolist())


def _trellis(name: str, tables) -> ctypes.Array:
    tabs = [np.asarray(a, np.int64) for a in tables]
    if any(a.shape != (STATES, 2) for a in tabs):
        raise ValueError(f"{name} takes the {STATES}-state trellis (m = 3)")
    return _tables(*(a.tobytes() for a in tabs))


def _require_cuda(name: str, t: torch.Tensor):
    if not t.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors; CPU tensors take the "
                         "plain version")


def _int(fn: str, restype=ctypes.c_longlong):
    f = launcher("bcjr_scan.cu", fn, (ctypes.c_int,))
    f.restype = restype
    return f


def shift_layout(ns, parity, prev, prev_u) -> bool:
    """Whether S6's pass 1 takes its shift-register layout (a lane a
    column, no shuffles) for these (8, 2) tables, as for the trellises of
    ``models/turbo.py::_rsc_tables`` whose feedforward has the D^m tap (LTE's
    among them), or its generic one."""
    fn = launcher("bcjr_scan.cu", "bcjr_trellis_shift", (_P,))
    got = fn(ctypes.addressof(_trellis("shift_layout",
                                       (ns, parity, prev, prev_u))))
    if got < 0:
        raise ValueError("shift_layout: trellis tables out of range")
    return bool(got)


@functools.lru_cache(maxsize=64)
def fused_fits(K: int, device) -> bool:
    """Whether the fused decode of a K-bit codeword fits one thread
    block's shared memory on ``device`` (``turbo_decode_smem`` against the
    card's opt-in limit): K <= 7,133 on an H100.  A CPU device raises."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("turbo_decode_cuda needs CUDA tensors; CPU tensors "
                         "take the plain version")
    index = torch.cuda.current_device() if device.index is None else (
        device.index)
    limit = _int("turbo_decode_max_smem", ctypes.c_int)(index)
    return 0 < _int("turbo_decode_smem")(int(K)) <= limit


def bcjr_maxlog_cuda(ls: torch.Tensor, lp: torch.Tensor, T: int,
                     ns, parity, prev, prev_u) -> torch.Tensor:
    """S6's walk over rows ls = l_sys + l_apr and lp, (B, T + m) float32
    on one card with the tails appended, and the host (8, 2) trellis tables
    of ``models/turbo.py::_rsc_tables`` (next state, parity, predecessors
    and their inputs) -> the (B, T) a-posteriori LLRs (positive favours
    0), bit-equal to ``bcjr_maxlog_chunked_torch``.  Adds one to
    ``launches``."""
    name = "bcjr_maxlog_cuda"
    _require_cuda(name, ls)
    if ls.dtype != torch.float32 or lp.dtype != torch.float32 or (
            lp.device != ls.device):
        raise TypeError(f"{name} takes float32 rows on one card")
    tabs = _trellis(name, (ns, parity, prev, prev_u))
    if ls.dim() != 2 or tuple(lp.shape) != tuple(ls.shape):
        raise ValueError(f"{name} takes ls and lp of one shape (B, T + m)")
    B, Tm = (int(v) for v in ls.shape)
    T = int(T)
    if B < 1 or not 0 <= T <= Tm:
        raise ValueError(f"{name}: need B >= 1 and 0 <= T <= T + m, got "
                         f"B={B}, T={T}, T + m={Tm}")
    lsc, lpc = ls.contiguous(), lp.contiguous()
    llr = torch.empty((B, T), dtype=torch.float32, device=ls.device)
    scratch = torch.empty((B, int(_int("bcjr_scratch_floats")(Tm))),
                          dtype=torch.float32, device=ls.device)
    fn = launcher("bcjr_scan.cu", "bcjr_maxlog_f32", _ARGS)
    check_launch(fn(lsc.data_ptr(), lpc.data_ptr(), llr.data_ptr(),
                    scratch.data_ptr(), ctypes.addressof(tabs), B, Tm, T,
                    ls.device.index, stream_of(ls)), name)
    bcjr_maxlog_cuda.launches += 1
    return llr


bcjr_maxlog_cuda.launches = 0


@functools.lru_cache(maxsize=8)
def _is_permutation(perm_bytes: bytes) -> bool:
    perm = np.frombuffer(perm_bytes, np.int64)
    return bool(np.array_equal(np.sort(perm), np.arange(perm.size)))


def turbo_decode_cuda(rows: torch.Tensor, perm, n_iter: int,
                      ns, parity, prev, prev_u):
    """S6's fused decode: ``n_iter`` iterations of both constituents over
    (B, 3K + 12) float32 codewords in the ``turbo_encode`` layout on one
    card, the interleaver ``perm`` (K,) a permutation, and the host (8, 2)
    trellis tables -> (bits (B, K) int32, the final a-posteriori LLRs (B,
    K) float32), bit-equal to ``turbo_decode_chunked_torch``, in one launch
    (a thread block a codeword); K must fit (:func:`fused_fits`).  Adds one
    to ``launches``."""
    name = "turbo_decode_cuda"
    _require_cuda(name, rows)
    if rows.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 codewords")
    tabs = _trellis(name, (ns, parity, prev, prev_u))
    perm = np.asarray(perm, np.int64).reshape(-1)
    K, n_iter = perm.size, int(n_iter)
    if rows.dim() != 2 or rows.shape[1] != 3 * K + 12 or rows.shape[0] < 1:
        raise ValueError(f"{name} takes (B, 3K + 12) rows, K = {K}, got "
                         f"{tuple(rows.shape)}")
    if n_iter < 1 or not _is_permutation(perm.tobytes()):
        raise ValueError(f"{name} takes n_iter >= 1 and a permutation")
    if not fused_fits(K, rows.device):
        raise ValueError(f"{name}: a {K}-bit codeword does not fit a thread "
                         "block's shared memory (bcjr_maxlog_cuda takes it)")
    B = int(rows.shape[0])
    rc = rows.contiguous()
    pj = device_constant(perm.astype(np.int32), rows.device, torch.int32)
    llr = torch.empty((B, K), dtype=torch.float32, device=rows.device)
    bits = torch.empty((B, K), dtype=torch.int32, device=rows.device)
    fn = launcher("bcjr_scan.cu", "turbo_decode_f32", _DECODE_ARGS)
    check_launch(fn(rc.data_ptr(), pj.data_ptr(), llr.data_ptr(),
                    bits.data_ptr(), ctypes.addressof(tabs), B, K, n_iter,
                    rows.device.index, stream_of(rows)), name)
    turbo_decode_cuda.launches += 1
    return bits, llr


turbo_decode_cuda.launches = 0
