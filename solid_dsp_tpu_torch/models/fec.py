"""FEC: convolutional encoding, Viterbi decoding, block interleaving and
puncturing.

Port of ``solid_dsp_tpu/models/fec.py``: the rate-1/n convolutional code
(default the K = 7 (171, 133)_8 code of 802.11/DVB/CCSDS), tail-terminated
with K - 1 zero bits so decoding starts and ends in state 0, hard-decision
(Hamming) or soft-decision (LLR, positive favours bit 0) branch metrics.
The trellis tables are the JAX package's host numpy.

**A batch axis.**  JAX encodes and decodes one stream; here
:func:`conv_encode`, :func:`viterbi_decode`, :class:`ConvCode`,
:func:`interleave`, :func:`puncture` and their inverses take any leading
axes ((..., T) bits, (..., T n) coded values), and a 1-D input gives
JAX's 1-D result.  A batch of rows decodes in one walk.

**The walk.**  :func:`viterbi_walk` runs the add-compare-select (ACS)
recurrence over all 2^(K-1) states and the traceback from state 0: on a
CUDA tensor the hand-written Hopper kernel S7 (``ops/cuda_viterbi.py``,
``csrc/viterbi_scan.cu``: the rows cut into chunks walked side by side from
a warm-up, checked bit for bit at every seam and walked again where the
check fails, then traced back by chunks; a warp a chunk with the metrics
in registers up to 64 states, a block a chunk above; three launches a
batch; :func:`viterbi_chunked_torch` is its passes in torch ops), on a
CPU tensor its plain version :func:`viterbi_plain`, JAX's
two scans (``fec.py:143`` and ``:152``) as torch ops in JAX's order of
operations, which the CPU tests hold bit-equal to JAX.  S7 makes the same
float32 operations in the same order, so it is bit-equal to the plain
version.  Soft values are taken in float32 (the JAX package sums float64
inputs in float64 under 64-bit mode).  S7 walks K <= 11 (S <= 1024) and
n <= 32; the plain version (``engine="torch"``) any code.

The functions run where their input lies; :class:`ConvCode` moves its
inputs to its device (the card unless told otherwise).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..device import bind_device, device_constant
from ..ops import cuda_viterbi
from ..ops.cuda_build import use_kernel

__all__ = ["conv_encode", "viterbi_decode", "ConvCode",
           "interleave", "deinterleave", "puncture", "depuncture",
           "PUNCTURE_2_3", "PUNCTURE_3_4", "PUNCTURE_5_6", "PUNCTURE_7_8",
           "viterbi_walk", "viterbi_plain", "viterbi_chunked_torch"]

DEFAULT_POLYS = (0o171, 0o133)
DEFAULT_K = 7
BIG = 1e9                # start metric of every state but 0
_BM_STEPS = 256          # the plain walk's branch metrics at once, in steps


def _bitrev(p: int, K: int) -> int:
    # The register keeps the NEWEST bit at the LSB; the standard convention
    # lists generator taps newest-at-MSB, so polys are reversed once.
    out = 0
    for i in range(K):
        out |= ((p >> i) & 1) << (K - 1 - i)
    return out


def _parity(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    for sh in (16, 8, 4, 2, 1):
        x ^= x >> sh
    return (x & 1).astype(np.int32)


@lru_cache(maxsize=16)
def _tables(polys: tuple, K: int):
    """(out_bits (S, 2, n), next_state (S, 2)) for prev-state s, input b."""
    S = 1 << (K - 1)
    s = np.arange(S)[:, None]
    b = np.arange(2)[None, :]
    reg = (s << 1) | b
    out = np.stack(
        [_parity(reg & _bitrev(p, K)) for p in polys], axis=-1)  # (S, 2, n)
    nxt = reg & (S - 1)
    return out.astype(np.int32), nxt.astype(np.int32)


@lru_cache(maxsize=16)
def _predecessors(K: int) -> np.ndarray:
    """(S, 2): the two predecessors of next state ns, ns >> 1 and
    (ns >> 1) | S / 2; the input bit on either is ns & 1."""
    S = 1 << (K - 1)
    ns = np.arange(S)
    return np.stack([ns >> 1, (ns >> 1) | (S >> 1)], axis=-1)


def conv_encode(bits, polys: tuple = DEFAULT_POLYS,
                constraint: int = DEFAULT_K) -> torch.Tensor:
    """Rate-1/n convolutional encoder with tail termination.

    bits (..., T) 0/1 -> (..., (T + K - 1) n) int32 coded bits, interleaved
    per input bit ([t0_poly0, t0_poly1, t1_poly0, ...])."""
    K = int(constraint)
    bits = torch.as_tensor(bits).to(torch.int32)
    lead = bits.shape[:-1]
    z = bits.new_zeros((*lead, K - 1))
    padded = torch.cat([z, bits, z], -1)
    T = padded.shape[-1] - (K - 1)
    reg = sum(padded[..., K - 1 - j: K - 1 - j + T] << j for j in range(K))
    outs = []
    for p in polys:
        v = reg & _bitrev(p, K)
        for sh in (16, 8, 4, 2, 1):
            v = v ^ (v >> sh)
        outs.append(v & 1)
    return torch.stack(outs, -1).reshape(*lead, T * len(polys))


def _branch_metrics(rt: torch.Tensor, o: torch.Tensor, soft: bool):
    """(..., S, 2) float32 branch metrics of received values rt (..., n)
    against the outputs o (S, 2, n) of each candidate's branch, summed over
    the n outputs in index order (soft: o r; hard: |o - r| in int32)."""
    bm = None
    for k in range(rt.shape[-1]):
        x = rt[..., None, None, k]
        term = o[..., k] * x if soft else torch.abs(o[..., k] - x)
        bm = term if bm is None else bm + term
    return bm.to(torch.float32)


def _candidates(out_tab, dev, soft: bool):
    """(pred (S, 2) long, o (S, 2, n)): the two predecessors of each next
    state and the outputs of the branch each candidate takes."""
    out = np.asarray(out_tab)
    S = out.shape[0]
    pred_np = _predecessors(S.bit_length())
    b_of = np.arange(S) & 1
    return (device_constant(pred_np, dev, torch.long),
            device_constant(out[pred_np, b_of[:, None]], dev,
                            torch.float32 if soft else torch.int32))


def viterbi_plain(r: torch.Tensor, out_tab, soft: bool):
    """S7's plain version over rows r (B, T, n): float32 LLRs (``soft``) or
    int32 hard bits, the (S, 2, n) output table.  Returns (bits (B, T)
    int32, the decoded bit of every step; final path metrics (B, S)
    float32).  JAX's ACS scan step for step: the BIG start, the branch
    metric summed over the n outputs in index order, cand = pm[pred] +
    bm[pred, b], choice 1 only where cand_1 < cand_0 (JAX's argmin), the
    renormalisation by the min at every step; then the traceback from
    state 0."""
    dev = r.device
    S = np.asarray(out_tab).shape[0]
    B, T = int(r.shape[0]), int(r.shape[1])
    pred, o = _candidates(out_tab, dev, soft)
    pm = torch.full((B, S), BIG, dtype=torch.float32, device=dev)
    pm[:, 0] = 0.0
    choices = torch.empty((B, T, S), dtype=torch.bool, device=dev)
    for t0 in range(0, T, _BM_STEPS):
        bm = _branch_metrics(r[:, t0:t0 + _BM_STEPS], o, soft)  # (B, c, S, 2)
        for i in range(bm.shape[1]):
            cand = pm[:, pred] + bm[:, i]                  # (B, S, 2)
            ch = cand[..., 1] < cand[..., 0]
            choices[:, t0 + i] = ch
            pmn = torch.where(ch, cand[..., 1], cand[..., 0])
            pm = pmn - torch.amin(pmn, dim=-1, keepdim=True)
    s = torch.zeros(B, dtype=torch.long, device=dev)
    bits = torch.empty((B, T), dtype=torch.int32, device=dev)
    rows = torch.arange(B, device=dev)
    for t in range(T - 1, -1, -1):
        c = choices[rows, t, s].long()
        bits[:, t] = (s & 1).to(torch.int32)
        s = pred[s, c]
    return bits, pm


def viterbi_chunked_torch(r: torch.Tensor, out_tab, soft: bool, L: int,
                          W: int):
    """S7's passes in torch ops (``csrc/viterbi_scan.cu``) over rows r (B,
    T, n), float32 LLRs (``soft``) or int32 hard bits, and the (S, 2, n)
    output table: chunks of L steps after a first chunk of L + W steps
    (``ops/cuda_viterbi.py::chunk_layout``), each chunk after the first
    started W steps before its seam from all-zero metrics.  Returns (bits
    (B, T) int32, final path metrics (B, S) float32, the count of re-walked
    chunks), bit-equal to :func:`viterbi_plain` for every input.

    Pass 1: every chunk of every row walked as one batch, a step of each at
    once in the kernel's order, keeping its vector at the seam (its guess)
    and at its end and storing the decisions from its seam on.  Pass 2: in
    order, a chunk whose guess is not bit-equal (as int32) to the true end
    vector before it is walked again from that vector, rows side by side.
    Pass 3: the row cut into pieces of ``cuda_viterbi.TRACE_PIECE`` steps,
    each traced back from state 0 at D = ``cuda_viterbi.trace_ahead``
    steps past its end (the last piece from state 0 at T), writing its
    bits; then from the last seam back, a
    piece whose state at its end differs from the true start state of the
    piece after it is traced again from that state (counted on
    ``viterbi_chunked_torch.retraced``)."""
    dev = r.device
    S = np.asarray(out_tab).shape[0]
    B, T = int(r.shape[0]), int(r.shape[1])
    F, C = cuda_viterbi.chunk_layout(T, L, W)
    t = cuda_viterbi.seams(T, int(L), F, C)
    tc = torch.tensor(t[:-1], device=dev)
    te = torch.tensor(t[1:], device=dev)
    exact = torch.arange(C, device=dev) == 0
    start = torch.where(exact, 0, tc - W)
    pred, o = _candidates(out_tab, dev, soft)
    init = torch.full((S,), BIG, dtype=torch.float32, device=dev)
    init[0] = 0.0
    pm = torch.where(exact[:, None], init, 0.0).expand(B, C, S).contiguous()
    guess = pm.clone()
    choices = torch.zeros((B, T, S), dtype=torch.bool, device=dev)

    def step(pm, rt):                       # rt (..., n) -> (pm, choices)
        cand = pm[..., pred] + _branch_metrics(rt, o, soft)
        ch = cand[..., 1] < cand[..., 0]
        pmn = torch.where(ch, cand[..., 1], cand[..., 0])
        return pmn - torch.amin(pmn, dim=-1, keepdim=True), ch

    # pass 1
    for j in range(int((te - start).max()) if T else 0):
        tj = start + j
        guess = torch.where((tj == tc)[:, None], pm, guess)
        live = tj < te
        tt = tj.clamp(max=T - 1)
        new, ch = step(pm, r[:, tt])                        # (B, C, S)
        pm = torch.where(live[:, None], new, pm)
        keep = (live & (tj >= tc)).nonzero()[:, 0]
        choices[:, tt[keep]] = ch[:, keep]
    ends = pm
    # pass 2
    fixups = 0
    for c in range(1, C):
        bad = (guess[:, c].view(torch.int32)
               != ends[:, c - 1].view(torch.int32)).any(-1).nonzero()[:, 0]
        if not len(bad):
            continue
        fixups += len(bad)
        p = ends[bad, c - 1]
        for tt in range(t[c], t[c + 1]):
            p, ch = step(p, r[bad, tt])
            choices[bad, tt] = ch
        ends[bad, c] = p
    # pass 3, over pieces of TRACE_PIECE steps
    bits = torch.zeros((B, T), dtype=torch.int32, device=dev)
    rows = torch.arange(B, device=dev)[:, None]
    Lt = cuda_viterbi.TRACE_PIECE
    Ct = -(-T // Lt)
    lo_all = torch.arange(Ct, device=dev) * Lt
    te_all = (lo_all + Lt).clamp(max=T)

    def trace(s, ks, hi, write):
        """Pieces ks traced back from states s (B, len(ks)) at steps hi,
        writing the bits below each piece's end where ``write`` (B, 1);
        returns (the states after step lo - 1, the states at te)."""
        lo, top = lo_all[ks], te_all[ks]
        s_te = s.clone()
        for j in range(int((hi - lo).max())):
            tj = hi - 1 - j
            live = tj >= lo
            tt = tj.clamp(min=0)
            s_te = torch.where(tj == top - 1, s, s_te)
            bi, ki = (live & (tj < top) & write).nonzero(as_tuple=True)
            bits[bi, tt[ki]] = (s[bi, ki] & 1).to(torch.int32)
            ch = choices[rows, tt, s].long()
            s = torch.where(live, pred[s, ch], s)
        return s, s_te
    retraced = 0
    if Ct:
        every = torch.arange(Ct, device=dev)
        D = cuda_viterbi.trace_ahead(S)
        hi = torch.where(every == Ct - 1, T, (te_all + D).clamp(max=T))
        start, s_te = trace(torch.zeros((B, Ct), dtype=torch.long,
                                        device=dev), every, hi,
                            torch.ones((B, 1), dtype=torch.bool, device=dev))
        s_next = start[:, Ct - 1]
        for k in range(Ct - 2, -1, -1):
            bad = s_te[:, k] != s_next
            s_k = start[:, k]
            if bool(bad.any()):
                retraced += int(bad.sum())
                one = every[k:k + 1]
                redo, _ = trace(s_next[:, None], one, te_all[one],
                                bad[:, None])
                s_k = torch.where(bad, redo[:, 0], s_k)
            s_next = s_k
    viterbi_chunked_torch.retraced = retraced
    return bits, ends[:, C - 1].clone(), fixups


def viterbi_walk(r: torch.Tensor, polys: tuple = DEFAULT_POLYS,
                 constraint: int = DEFAULT_K, soft: bool = False,
                 engine: str = "auto"):
    """The ACS walk and traceback over rows r (B, T, n) (float32 LLRs or
    int32 hard bits): S7 on a CUDA tensor (``engine`` "auto" or "cuda"),
    :func:`viterbi_plain` on a CPU tensor or with ``engine="torch"``.
    Returns (bits (B, T), final metrics (B, S))."""
    K = int(constraint)
    out_tab, _ = _tables(tuple(polys), K)
    if use_kernel(engine, r):
        return cuda_viterbi.viterbi_cuda(r, soft, out_tab, _predecessors(K))
    return viterbi_plain(r, out_tab, soft)


def viterbi_decode(rx, polys: tuple = DEFAULT_POLYS,
                   constraint: int = DEFAULT_K, soft: bool = False,
                   engine: str = "auto") -> torch.Tensor:
    """Viterbi decode of tail-terminated rate-1/n streams.

    rx: hard bits (..., T n) 0/1, or soft LLRs (positive = bit 0 likelier)
    with ``soft=True``.  Returns the (..., T - K + 1) decoded information
    bits (int32); every leading axis is a row of one walk."""
    K = int(constraint)
    n = len(polys)
    rx = torch.as_tensor(rx)
    if rx.shape[-1] % n:
        raise ValueError(
            f"coded length {rx.shape[-1]} is not a multiple of n={n}")
    T = rx.shape[-1] // n
    lead = rx.shape[:-1]
    r = rx.reshape(-1, T, n).to(torch.float32 if soft else torch.int32)
    bits, _ = viterbi_walk(r, tuple(polys), K, soft, engine)
    bits = bits[:, : T - (K - 1)]
    return bits.reshape(*lead, bits.shape[-1])


class ConvCode:
    """encode() / decode() with fixed parameters, on ``device`` (the card
    unless told otherwise); both take a batch axis."""

    def __init__(self, polys: tuple = DEFAULT_POLYS,
                 constraint: int = DEFAULT_K, device=None):
        self.polys = tuple(polys)
        self.K = int(constraint)
        self.rate = 1.0 / len(self.polys)
        self.device = bind_device(device)

    def encode(self, bits) -> torch.Tensor:
        return conv_encode(torch.as_tensor(bits).to(self.device), self.polys,
                           self.K)

    def decode(self, rx, soft: bool = False) -> torch.Tensor:
        return viterbi_decode(torch.as_tensor(rx).to(self.device),
                              self.polys, self.K, soft=soft)

    def __repr__(self):
        return (f"ConvCode [K={self.K}] "
                f"[polys={tuple(oct(p) for p in self.polys)}]")


def interleave(bits, rows: int, cols: int) -> torch.Tensor:
    """Rectangular block interleaver over the last axis: write row-wise,
    read column-wise.  Its length must equal rows * cols."""
    b = torch.as_tensor(bits)
    if b.shape[-1] != rows * cols:
        raise ValueError("length must equal rows*cols")
    lead = b.shape[:-1]
    return b.reshape(*lead, rows, cols).transpose(-1, -2).reshape(
        *lead, rows * cols)


def deinterleave(bits, rows: int, cols: int) -> torch.Tensor:
    b = torch.as_tensor(bits)
    if b.shape[-1] != rows * cols:
        raise ValueError("length must equal rows*cols")
    lead = b.shape[:-1]
    return b.reshape(*lead, cols, rows).transpose(-1, -2).reshape(
        *lead, rows * cols)


# DVB-S / IEEE-standard puncturing patterns for the rate-1/2 mother code:
# row 0 = X (first polynomial) keep-mask over the period, row 1 = Y.
PUNCTURE_2_3 = ((1, 0), (1, 1))
PUNCTURE_3_4 = ((1, 0, 1), (1, 1, 0))
PUNCTURE_5_6 = ((1, 0, 1, 0, 1), (1, 1, 0, 1, 0))
PUNCTURE_7_8 = ((1, 0, 0, 0, 1, 0, 1), (1, 1, 1, 1, 0, 1, 0))


def _puncture_cols(pattern) -> tuple:
    """Static kept-column indices into a (period * n)-wide row."""
    rows = [tuple(r) for r in pattern]
    n = len(rows)
    period = len(rows[0])
    if any(len(r) != period for r in rows):
        raise ValueError("puncture pattern rows must share one period")
    if not any(v for r in rows for v in r):
        raise ValueError("puncture pattern keeps nothing")
    keep = [t * n + i for t in range(period) for i in range(n)
            if rows[i][t]]
    return n, period, tuple(keep)


def puncture(coded, pattern) -> torch.Tensor:
    """Drop coded bits by the keep-pattern (rate 1/n -> higher).

    coded: (..., T n) from conv_encode, T divisible by the pattern's
    period."""
    n, period, keep = _puncture_cols(pattern)
    coded = torch.as_tensor(coded)
    T = coded.shape[-1] // n
    if coded.shape[-1] % n or T % period:
        raise ValueError(
            f"coded length {coded.shape[-1]} must be a multiple of "
            f"n*period = {n * period}")
    lead = coded.shape[:-1]
    rows = coded.reshape(*lead, T // period, period * n)
    idx = device_constant(np.asarray(keep, np.int64), coded.device,
                          torch.long)
    return rows[..., idx].reshape(*lead, -1)


def depuncture(rx, pattern, hard: bool = False) -> torch.Tensor:
    """Re-insert erasures: punctured slots become LLR 0.

    rx: the punctured stream, soft LLRs (positive favours bit 0) or hard
    bits with ``hard=True`` (mapped to +-1 LLRs).  Returns the full-rate
    (..., T n) soft stream for ``viterbi_decode(..., soft=True)``."""
    n, period, keep = _puncture_cols(pattern)
    rx = torch.as_tensor(rx)
    if hard:
        rx = 1.0 - 2.0 * rx.to(torch.float32)
    k = len(keep)
    if rx.shape[-1] % k:
        raise ValueError(
            f"punctured length {rx.shape[-1]} not a multiple of the "
            f"pattern's {k} kept bits")
    lead = rx.shape[:-1]
    rows = rx.reshape(*lead, -1, k)
    full = rx.new_zeros((*lead, rows.shape[-2], period * n))
    idx = device_constant(np.asarray(keep, np.int64), rx.device, torch.long)
    full[..., idx] = rows
    return full.reshape(*lead, -1)
