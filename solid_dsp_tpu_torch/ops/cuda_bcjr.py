"""Turbo decoding's max-log BCJR walk on Hopper (S6): the wrapper of
``csrc/bcjr_scan.cu``.

S6 runs one terminated RSC constituent's forward and backward walks and
its a-posteriori LLRs over a batch of rows, one launch a half-iteration of
``models/turbo.py::turbo_decode``.  It replaces no TPU kernel: in the JAX
package the walk is two ``lax.scan``s (``solid_dsp_tpu/models/turbo.py:276``
and ``:312``) and the a-posteriori step ``:318-324``.  One lane walks one
trellis state (8 a row); the source has the design and its bound.  Its
plain version is ``models/turbo.py::bcjr_maxlog_plain``, which a CPU
tensor takes.

The wrapper takes CUDA tensors only, checks types and shapes, allocates the
output and the forward walk's (B, T + m, 8) scratch, launches on the
current stream, raises if the launch fails
(``cuda_build.check_launch``) and adds one to ``launches``.  The kernel
takes the 8-state trellis (m = 3, the LTE constituent) only.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .cuda_build import check_launch, launcher, stream_of

__all__ = ["bcjr_maxlog_cuda", "STATES"]

STATES = 8
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = (_P,) * 5 + (_I, _I, _I, _I, _P)


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


def bcjr_maxlog_cuda(ls: torch.Tensor, lp: torch.Tensor, T: int,
                     ns, parity, prev, prev_u) -> torch.Tensor:
    """S6 over rows ls = l_sys + l_apr and lp, (B, T + m) float32 on one
    card with the tails appended, and the host (8, 2) trellis tables of
    ``models/turbo.py::_rsc_tables`` (next state, parity, predecessors and
    their inputs) -> the (B, T) a-posteriori LLRs (positive favours 0).
    Adds one to ``launches``."""
    name = "bcjr_maxlog_cuda"
    if not ls.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors; CPU tensors take the "
                         "plain version")
    if ls.dtype != torch.float32 or lp.dtype != torch.float32 or (
            lp.device != ls.device):
        raise TypeError(f"{name} takes float32 rows on one card")
    tabs = [np.asarray(a, np.int64) for a in (ns, parity, prev, prev_u)]
    if any(a.shape != (STATES, 2) for a in tabs):
        raise ValueError(f"{name} takes the {STATES}-state trellis (m = 3)")
    if ls.dim() != 2 or tuple(lp.shape) != tuple(ls.shape):
        raise ValueError(f"{name} takes ls and lp of one shape (B, T + m)")
    B, Tm = (int(v) for v in ls.shape)
    T = int(T)
    if B < 1 or not 0 <= T <= Tm:
        raise ValueError(f"{name}: need B >= 1 and 0 <= T <= T + m, got "
                         f"B={B}, T={T}, T + m={Tm}")
    lsc, lpc = ls.contiguous(), lp.contiguous()
    llr = torch.empty((B, T), dtype=torch.float32, device=ls.device)
    alphas = torch.empty((B, Tm, STATES), dtype=torch.float32,
                         device=ls.device)
    fn = launcher("bcjr_scan.cu", "bcjr_maxlog_f32", _ARGS)
    check_launch(fn(lsc.data_ptr(), lpc.data_ptr(), llr.data_ptr(),
                    alphas.data_ptr(), ctypes.addressof(_tables(
                        *(a.tobytes() for a in tabs))),
                    B, Tm, T, ls.device.index, stream_of(ls)), name)
    bcjr_maxlog_cuda.launches += 1
    return llr


bcjr_maxlog_cuda.launches = 0
