"""The Viterbi decoder's add-compare-select walk and traceback on Hopper
(S7): the wrapper of ``csrc/viterbi_scan.cu``.

S7 runs the ACS recurrence of a tail-terminated rate-1/n convolutional
code over a batch of rows, and the traceback from state 0, in one launch
(``models/fec.py::viterbi_decode``).  It replaces no TPU kernel: in the
JAX package the walk is two ``lax.scan``s
(``solid_dsp_tpu/models/fec.py:143`` and ``:152``).  One warp walks a row
of up to 64 states with the metrics in registers, one block (a thread a
state) a row of more; the source has the design and its bound.
Its plain version is ``models/fec.py::viterbi_plain``, which a CPU tensor
takes; the metrics and the decisions are bit-equal to it.

The wrapper takes CUDA tensors only, checks types and shapes, allocates
the outputs and the (B, T, max(1, S / 32)) decision words, launches on the
current stream, raises if the launch fails (``cuda_build.check_launch``)
and adds one to ``launches``.  The kernel takes S = 2^(K-1) <= 1024 states
(K <= 11) and n <= 32 outputs a step, with the predecessors of a shift
register (``pred[ns] = (ns >> 1, (ns >> 1) | S / 2)``, as
``viterbi_decode`` builds them).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..device import device_constant
from .cuda_build import check_launch, launcher, stream_of

__all__ = ["viterbi_cuda", "MAX_STATES", "MAX_OUTPUTS"]

MAX_STATES = 1024
MAX_OUTPUTS = 32
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = (_P, _I) + (_P,) * 4 + (_I,) * 5 + (_P,)


@functools.lru_cache(maxsize=16)
def _masks(out_bytes: bytes, S: int, n: int) -> np.ndarray:
    """(S, 2) uint32: bit k = output k of the branch (previous state, input
    bit), from the (S, 2, n) output table."""
    out = np.frombuffer(out_bytes, np.int64).reshape(S, 2, n)
    return (out.astype(np.uint64) << np.arange(n, dtype=np.uint64)).sum(
        -1).astype(np.uint32)


def check_trellis(out_tab, pred) -> tuple:
    """(S, n) of the output table (S, 2, n) and the predecessor table
    (S, 2); raises ValueError where S7 cannot walk them."""
    out = np.asarray(out_tab)
    S = out.shape[0]
    if out.ndim != 3 or out.shape[1] != 2 or S < 1 or S & (S - 1):
        raise ValueError("viterbi_cuda takes an (S, 2, n) output table, S a "
                         "power of two")
    n = out.shape[2]
    if S > MAX_STATES:
        raise ValueError(f"viterbi_cuda walks at most {MAX_STATES} states "
                         f"(K <= 11), got {S}; the plain version "
                         "(engine='torch') takes any K")
    if not 1 <= n <= MAX_OUTPUTS:
        raise ValueError(f"viterbi_cuda takes 1 to {MAX_OUTPUTS} outputs a "
                         f"step, got {n}")
    ns = np.arange(S)
    want = np.stack([ns >> 1, (ns >> 1) | (S >> 1)], -1)
    if not np.array_equal(np.asarray(pred), want):
        raise ValueError("viterbi_cuda takes a shift register's "
                         "predecessors (ns >> 1, (ns >> 1) | S / 2)")
    return S, n


def viterbi_cuda(r: torch.Tensor, soft: bool, out_tab, pred):
    """S7 over rows r (B, T, n) on one card: float32 LLRs (``soft``,
    positive favours 0) or int32 hard bits, and the host tables of
    ``models/fec.py::_tables`` (outputs (S, 2, n)) and the predecessors
    (S, 2).  Returns (bits (B, T) int32, the decoded bit of every step;
    final path metrics (B, S) float32).  Adds one to ``launches``."""
    name = "viterbi_cuda"
    if not r.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors; CPU tensors take the "
                         "plain version")
    want = torch.float32 if soft else torch.int32
    if r.dtype != want:
        raise TypeError(f"{name} takes {want} rows "
                        f"({'soft' if soft else 'hard'} decisions)")
    S, n = check_trellis(out_tab, pred)
    if r.dim() != 3 or r.shape[-1] != n:
        raise ValueError(f"{name} takes rows (B, T, {n})")
    B, T = int(r.shape[0]), int(r.shape[1])
    dev = r.device
    bits = torch.empty((B, T), dtype=torch.int32, device=dev)
    pm = torch.empty((B, S), dtype=torch.float32, device=dev)
    if B == 0:
        return bits, pm
    rc = r.contiguous()
    words = max(1, S // 32)
    dec = torch.empty((B, T, words), dtype=torch.int32, device=dev)
    masks = device_constant(_masks(np.asarray(out_tab, np.int64).tobytes(),
                                   S, n).view(np.int32), dev, torch.int32)
    fn = launcher("viterbi_scan.cu", "viterbi_acs", _ARGS)
    check_launch(fn(rc.data_ptr(), int(bool(soft)), masks.data_ptr(),
                    bits.data_ptr(), pm.data_ptr(), dec.data_ptr(), B, T, n,
                    S, dev.index, stream_of(r)), name)
    viterbi_cuda.launches += 1
    return bits, pm


viterbi_cuda.launches = 0
