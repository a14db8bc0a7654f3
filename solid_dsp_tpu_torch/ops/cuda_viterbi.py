"""The Viterbi decoder's add-compare-select walk and traceback on Hopper
(S7): the wrapper of ``csrc/viterbi_scan.cu``.

S7 runs the ACS recurrence of a tail-terminated rate-1/n convolutional
code over a batch of rows, and the traceback from state 0
(``models/fec.py::viterbi_decode``).  It replaces no TPU kernel: in the
JAX package the walk is two ``lax.scan``s
(``solid_dsp_tpu/models/fec.py:143`` and ``:152``).  The walk is cut in
time: chunks started from all-zero metrics a warm-up of W steps before
their seam, checked bit for bit against the true vector at every seam and
walked again where the check fails; then the row cut again into pieces of
``TRACE_PIECE`` steps, each traced back from D =
``TRACE_AHEAD_PER_MEMORY`` (K - 1) steps past its end, each seam's state
checked and the piece traced again where it differs (three launches; the
source has the design and its bound).  Its plain version is
``models/fec.py::viterbi_plain``, which a CPU tensor takes; the metrics and
the decisions are bit-equal to it whatever the input.
``models/fec.py::viterbi_chunked_torch`` is the kernel's passes in torch
ops, with the same counts of re-walked chunks and re-traced pieces.

The wrapper takes CUDA tensors only, checks types and shapes, allocates
the outputs and the scratch, launches on the current stream, raises if a
launch fails (``cuda_build.check_launch``) and adds one to ``launches``.
The re-walked chunks and the re-traced pieces are added on the card to
``fixups`` (two int64 on the card of the last call, made at the first;
nothing on the path reads it).
The kernel takes S = 2^(K-1) <= 1024 states (K <= 11) and n <= 32 outputs
a step, with the predecessors of a shift register (``pred[ns] = (ns >> 1,
(ns >> 1) | S / 2)``, as ``viterbi_decode`` builds them).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..device import device_constant
from .cuda_build import check_launch, launcher, stream_of

__all__ = ["viterbi_cuda", "chunk_plan", "chunk_layout", "seams",
           "trace_ahead", "MAX_STATES", "MAX_OUTPUTS", "TRACE_PIECE"]

MAX_STATES = 1024
MAX_OUTPUTS = 32
# The chunk rule (chunk_plan), from torch_kernel_sweep.py s7 on an NVIDIA
# H100 80GB HBM3 at 700 W (K = 7, soft).  W = WARMUP_PER_MEMORY (K - 1)
# steps of warm-up: 96 re-walked no chunk of 1024 rows of packets at Eb/N0
# = 4 dB but 7 of the 1984 seams of 64 CCSDS rows at 2.8 dB in chunks of
# 256 (each a sequential re-walk in pass 2: 0.1032 ms a call against 0.0763
# at W = 128), and 128 none.  The chunks a row give the card about
# TARGET_WARPS warps, each chunk at least MIN_CHUNK steps: at W = 128, 1024
# x 550 took 0.0609 ms in 2 chunks a row, 0.0693 in 3 and 0.0744 in 4;
# 64 x 8166 0.0763 ms in 32 (2048 warps), 0.0787 in 21, 0.0865 in 42 and
# 0.0908 in 63.
WARMUP_PER_MEMORY = 22
TARGET_WARPS = 2048
MIN_CHUNK = 32
# The traceback's pieces (pass 3): a thread a piece of TRACE_PIECE steps,
# traced from D = TRACE_AHEAD_PER_MEMORY (K - 1) steps past its end (the
# sweep, K = 7: D = 66 re-traced 4 of the 4032 seams of 64 CCSDS rows at
# 2.8 dB, pass 3 0.0272 ms; 96 none, 0.0245; at 1024 x 550 D = 48-96 cost
# pass 3 0.0120-0.0141 ms with no re-trace; 32 re-traced 10).
TRACE_PIECE = 64
TRACE_AHEAD_PER_MEMORY = 16
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = (_P, _I) + (_P,) * 8 + (_I,) * 10 + (_P,)


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


def chunk_layout(T: int, L: int, W: int) -> tuple:
    """(F, C): a row of T steps cut into a first chunk of F = L + W steps
    (so that every chunk walks L + W steps, and no warm-up reaches back
    past step 0) and chunks of L steps after it, the last one ragged; C the
    chunk count (1 where T <= F)."""
    L, W = int(L), int(W)
    if L < 1 or W < 0:
        raise ValueError(f"chunks of L >= 1 steps and a warm-up W >= 0, got "
                         f"{L}, {W}")
    F = L + W
    return F, (1 if T <= F else 1 + -(-(T - F) // L))


def seams(T: int, L: int, F: int, C: int) -> list:
    """[t_0, ..., t_C]: the first step of every chunk, and T."""
    return [0] + [min(T, F + (c - 1) * L) for c in range(1, C + 1)]


def chunk_plan(B: int, T: int, S: int, warmup: int | None = None) -> tuple:
    """(L, W, F, C) for B rows of T steps of an S-state code: the warm-up
    W = WARMUP_PER_MEMORY (K - 1) (``warmup`` overrides it) and chunks of L
    steps that give the card about TARGET_WARPS warps (a chunk is a warp up
    to 64 states, S / 32 warps above), at least MIN_CHUNK steps each."""
    K = int(S).bit_length()
    W = WARMUP_PER_MEMORY * (K - 1) if warmup is None else int(warmup)
    warps = 1 if S <= 64 else S // 32              # a chunk's
    want = max(1, TARGET_WARPS // (max(1, B) * warps))
    L = max(MIN_CHUNK, -(-max(1, T - W) // want))
    F, C = chunk_layout(T, L, W)
    return L, W, F, C


def trace_ahead(S: int) -> int:
    """D, the steps past a piece's end its trace starts from (pass 3)."""
    return TRACE_AHEAD_PER_MEMORY * (int(S).bit_length() - 1)


def viterbi_cuda(r: torch.Tensor, soft: bool, out_tab, pred,
                 warmup: int | None = None):
    """S7 over rows r (B, T, n) on one card: float32 LLRs (``soft``,
    positive favours 0) or int32 hard bits, and the host tables of
    ``models/fec.py::_tables`` (outputs (S, 2, n)) and the predecessors
    (S, 2).  ``warmup`` overrides :func:`chunk_plan`'s W (the result is
    the same; the time and the re-walks are not).  Returns (bits (B, T)
    int32, the decoded bit of every step; final path metrics (B, S)
    float32).  Adds one to ``launches``, and the re-walked chunks and the
    re-traced pieces to ``fixups`` on the card."""
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
    L, W, _, C = chunk_plan(B, T, S, warmup)
    D = trace_ahead(S)
    dev = r.device
    bits = torch.empty((B, T), dtype=torch.int32, device=dev)
    pm = torch.empty((B, S), dtype=torch.float32, device=dev)
    if B == 0:
        return bits, pm
    rc = r.contiguous()
    dec = torch.empty((B, T, max(1, S // 32)), dtype=torch.int32, device=dev)
    vec = torch.empty((B, C, 2, S), dtype=torch.float32, device=dev)
    ends = torch.empty((B, -(-T // TRACE_PIECE), 2), dtype=torch.int32,
                       device=dev)
    tick = torch.empty(B, dtype=torch.int32, device=dev)
    fix = viterbi_cuda.fixups
    if fix is None or fix.device != dev:
        fix = viterbi_cuda.fixups = torch.zeros(2, dtype=torch.int64,
                                                device=dev)
    masks = device_constant(_masks(np.asarray(out_tab, np.int64).tobytes(),
                                   S, n).view(np.int32), dev, torch.int32)
    fn = launcher("viterbi_scan.cu", "viterbi_acs", _ARGS)
    check_launch(fn(rc.data_ptr(), int(bool(soft)), masks.data_ptr(),
                    bits.data_ptr(), pm.data_ptr(), dec.data_ptr(),
                    vec.data_ptr(), ends.data_ptr(), tick.data_ptr(),
                    fix.data_ptr(), B, T, n, S, L, W, C, TRACE_PIECE, D,
                    dev.index, stream_of(r)), name)
    viterbi_cuda.launches += 1
    return bits, pm


viterbi_cuda.launches = 0
viterbi_cuda.fixups = None
