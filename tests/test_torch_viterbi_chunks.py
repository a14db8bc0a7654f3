"""S7's chunked walk on the CPU: ``models/fec.py::viterbi_chunked_torch``
(the passes of ``csrc/viterbi_scan.cu`` in torch ops) against the plain
walk ``viterbi_plain`` and JAX's ``viterbi_decode``.

The chunks start from all-zero metrics W steps before their seam, are
checked bit for bit at every seam and walked again where the check fails,
and the row is traced back in pieces, each from state 0 D steps past its
end, each seam's state checked against the next piece's and the piece
traced again where it differs.
Gates, all exact:
the bits and the final path metrics (as int32 bits) equal to the plain
walk's, whatever the warm-up, the chunk length and the input (W = 0 and 2
re-walk nearly every chunk; noise-only and tie-heavy random hard streams;
T = 0, 1, T < L, T a whole number of chunks, chunks of one step; a first
chunk of L + W steps, so that no warm-up reaches back past step 0); the
trace's lookahead D set through ``TRACE_AHEAD_PER_MEMORY`` (0 re-traces
nearly every piece); the decoded
bits equal to JAX's at codes K = 3, 5, 7, 9, rates 1/2 and 1/3, hard and
soft.  The kernel's own order (pmn kept unrenormalised with the previous
minimum, a restart from a vector v taking pmn = v and a minimum of 0, the
soft metric an FFMA chain) is emulated in float32 numpy and held equal to
the plain walk, with the same counts of re-walked and re-traced chunks.  At phase 41's
packet rows (soft, 4 dB) a warm-up of 96 steps re-walks no chunk.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.models import fec as jfec
from solid_dsp_tpu_torch.models import fec as tfec
from solid_dsp_tpu_torch.ops import cuda_viterbi

BASE = {3: (0o7, 0o5), 5: (0o23, 0o35), 7: (0o171, 0o133),
        9: (0o561, 0o753)}
CODES = {f"k{K}r{n}": (p + ((p[0] ^ 0o2,) if n == 3 else ()), K)
         for K, p in BASE.items() for n in (2, 3)}


def _np(t):
    return t.detach().cpu().numpy()


def _rows(rng, polys, K, B, T, soft, noise):
    """(B, T, n) received rows: tail-terminated codewords of T - K + 1 bits
    through BPSK + AWGN (soft, float32) or bit flips (hard)."""
    n = len(polys)
    bits = rng.integers(0, 2, (B, T - K + 1))
    c = _np(tfec.conv_encode(torch.from_numpy(bits), polys, K))
    if soft:
        rx = ((1 - 2.0 * c) + noise * rng.standard_normal(c.shape)).astype(
            np.float32)
    else:
        rx = (c ^ (rng.random(c.shape) < noise)).astype(np.int32)
    return torch.from_numpy(rx.reshape(B, T, n))


def _assert_plain(r, polys, K, soft, L, W):
    """viterbi_chunked_torch bit-equal to viterbi_plain; returns (bits,
    re-walked chunks); its re-traced pieces are on
    ``viterbi_chunked_torch.retraced``."""
    out, _ = tfec._tables(tuple(polys), K)
    bp, pp = tfec.viterbi_plain(r, out, soft)
    bc, pc, fix = tfec.viterbi_chunked_torch(r, out, soft, L, W)
    assert bc.dtype == torch.int32 and bc.shape == bp.shape
    assert torch.equal(bc, bp)
    assert torch.equal(pc.view(torch.int32), pp.view(torch.int32))
    return bc, fix


@pytest.mark.parametrize("code", list(CODES))
@pytest.mark.parametrize("soft", [False, True])
def test_s7_chunked_equals_plain_and_jax(code, soft, monkeypatch):
    """Every code at warm-ups 0, 2 (nearly every seam fails and is
    re-walked) and 16 (K - 1), chunks of 16 and 40 steps, the trace's
    lookahead D as trace_ahead gives it and, at the short warm-ups, 0 and
    K - 1 steps; the bits equal JAX's decode."""
    polys, K = CODES[code]
    rng = np.random.default_rng(K + 7 * len(polys) + 100 * soft)
    r = _rows(rng, polys, K, 2, 160, soft, 0.9 if soft else 0.08)
    built = cuda_viterbi.TRACE_AHEAD_PER_MEMORY
    rewalks = {}
    for W, per in ((0, 0), (2, 1), (16 * (K - 1), None)):
        for L in (16, 40):
            bits, rewalks[W, L] = _assert_plain(r, polys, K, soft, L, W)
            if per is not None:
                monkeypatch.setattr(cuda_viterbi, "TRACE_AHEAD_PER_MEMORY",
                                    per)
                _assert_plain(r, polys, K, soft, L, W)
                monkeypatch.setattr(cuda_viterbi, "TRACE_AHEAD_PER_MEMORY",
                                    built)
    assert rewalks[0, 16] >= 16           # of the 2 x 9 seams
    want = np.asarray(jfec.viterbi_decode(
        jnp.asarray(_np(r[1]).reshape(-1)), polys, K, soft=soft))
    np.testing.assert_array_equal(_np(bits[1, :160 - K + 1]), want)


@pytest.mark.parametrize("soft", [False, True])
def test_s7_chunked_noise_and_ties(soft, monkeypatch):
    """A noise-only soft stream and a hard stream of random bits (ties at
    nearly every step, decided by the first-minimum rule), K = 7: bit-equal
    to the plain walk at every warm-up W and trace lookahead D (W / 4 or
    0 where W <= 2: every seam re-walked and re-traced), and JAX's
    bits."""
    rng = np.random.default_rng(31 + soft)
    if soft:
        r = torch.from_numpy(rng.standard_normal((3, 300, 2)).astype(
            np.float32))
    else:
        r = torch.from_numpy(rng.integers(0, 2, (3, 300, 2)).astype(
            np.int32))
    for W, per in ((0, 0), (2, 0), (24, 1), (96, 4)):
        monkeypatch.setattr(cuda_viterbi, "TRACE_AHEAD_PER_MEMORY", per)
        bits, fix = _assert_plain(r, BASE[7], 7, soft, 32, W)
        if W <= 2:
            assert fix > 0 and tfec.viterbi_chunked_torch.retraced > 0
    want = np.asarray(jfec.viterbi_decode(
        jnp.asarray(_np(r[2]).reshape(-1)), soft=soft))
    np.testing.assert_array_equal(_np(bits[2, :294]), want)


@pytest.mark.parametrize("T,L,W", [
    (0, 16, 96),                # no step: the start's metrics
    (1, 16, 96),                # one step
    (40, 64, 96),               # T < L: one chunk
    (200, 40, 0),               # T = 5 L: whole chunks, no ragged one
    (300, 20, 96),              # a first chunk of 116 steps, then 20 each
    (161, 1, 0),                # chunks of one step: a seam at every step
    (97, 96, 0),                # T = L + 1: a last chunk of one step
])
@pytest.mark.parametrize("soft", [False, True])
def test_s7_chunked_edge_shapes(T, L, W, soft):
    rng = np.random.default_rng(T + L + W + soft)
    if soft:
        r = torch.from_numpy(rng.standard_normal((2, T, 2)).astype(
            np.float32))
    else:
        r = torch.from_numpy(rng.integers(0, 2, (2, T, 2)).astype(np.int32))
    F, C = cuda_viterbi.chunk_layout(T, L, W)
    t = cuda_viterbi.seams(T, L, F, C)
    assert t[0] == 0 and t[-1] == T and len(t) == C + 1
    assert all(b > a for a, b in zip(t[:-1], t[1:])) or T == 0
    # F = L + W: no chunk's warm-up reaches back past step 0
    assert all(t[c] - W >= L for c in range(1, C))
    _, fix = _assert_plain(r, BASE[7], 7, soft, L, W)
    assert fix <= 2 * (C - 1)                                   # 2 rows


def test_s7_no_rewalk_at_packet_snr():
    """phase 41's packet rows (K = 7 soft LLRs at Eb/N0 = 4 dB, 550 steps)
    in the chunks chunk_plan gives 1024 rows, with a warm-up of 96 steps:
    no seam fails, and the bits are the plain walk's."""
    rng = np.random.default_rng(41)
    info = rng.integers(0, 2, (96, 544))
    c = _np(tfec.conv_encode(torch.from_numpy(info)))
    sigma = np.sqrt(1 / (2 * 0.5 * 10 ** 0.4))
    y = (1 - 2.0 * c) + sigma * rng.standard_normal(c.shape)
    r = torch.from_numpy((2 * y / sigma ** 2).astype(np.float32)).reshape(
        96, 550, 2)
    L, _, _, C = cuda_viterbi.chunk_plan(1024, 550, 64, warmup=96)
    assert C > 1
    bits, fix = _assert_plain(r, BASE[7], 7, True, L, 96)
    assert fix == 0
    assert np.mean(_np(bits[:, :544]) != info) < 1e-3


def test_s7_chunk_plan():
    """The rule: about TARGET_WARPS warps (a warp a chunk to 64 states),
    chunks of at least MIN_CHUNK steps, a first chunk of L + W so that
    every chunk walks L + W steps; one chunk where the rows fill the card
    or are short; the warm-up's override; bad layouts refused."""
    for B, T, S in ((1024, 550, 64), (64, 8166, 64), (1, 550, 64),
                    (4, 8166, 1024), (7, 12, 8)):
        L, W, F, C = cuda_viterbi.chunk_plan(B, T, S)
        assert W == cuda_viterbi.WARMUP_PER_MEMORY * (S.bit_length() - 1)
        assert F == L + W and L >= cuda_viterbi.MIN_CHUNK
        assert C == cuda_viterbi.chunk_layout(T, L, W)[1]
        warps = B * C * (1 if S <= 64 else S // 32)
        assert C == 1 or warps <= 2 * cuda_viterbi.TARGET_WARPS
    assert cuda_viterbi.chunk_plan(4096, 550, 64)[3] == 1
    assert cuda_viterbi.chunk_plan(1, 550, 64, warmup=10) == (32, 10, 42,
                                                              17)
    assert cuda_viterbi.trace_ahead(64) == 6 * cuda_viterbi.TRACE_AHEAD_PER_MEMORY
    for bad in ((0, 4), (8, -1)):
        with pytest.raises(ValueError):
            cuda_viterbi.chunk_layout(100, *bad)


def _s7_chunks_emulated(r, out_tab, soft, L, W):
    """The kernel's passes in float32 numpy over one row r (T, n): pass 1
    keeps pmn unrenormalised with the previous minimum g (the exact start
    0 / BIG, or all zeros W steps before the seam), the guess and end
    vectors pmn - g; pass 2 compares as int32 bits and re-walks from the
    true vector v with pmn = v, g = 0; pass 3 traces each piece of
    TRACE_PIECE steps back from state 0 at D = trace_ahead steps past its
    end (the last from T), then from the last seam back traces again a piece whose state
    at its end is not the next piece's start.  Returns (bits, final
    metrics, (re-walked chunks, re-traced pieces))."""
    f32 = np.float32
    S, _, n = out_tab.shape
    T = r.shape[0]
    F, C = cuda_viterbi.chunk_layout(T, L, W)
    t = cuda_viterbi.seams(T, L, F, C)
    ns = np.arange(S)
    pred = np.stack([ns >> 1, (ns >> 1) | (S >> 1)], -1)
    o = out_tab[pred, (ns & 1)[:, None]]                  # (S, 2, n)
    dec = np.zeros((T, S), bool)

    def walk(pmn, g, t0, t1, store):
        for tt in range(t0, t1):
            if soft:                   # fma(o, r, bm): o r is exact
                bm = np.zeros((S, 2), f32)
                for k in range(n):
                    bm = (bm + o[..., k].astype(f32) * r[tt, k]).astype(f32)
            else:
                bm = np.abs(o - r[tt]).sum(-1).astype(f32)
            cand = ((pmn[pred] - g).astype(f32) + bm).astype(f32)
            ch = cand[:, 1] < cand[:, 0]
            if store:
                dec[tt] = ch
            pmn = np.where(ch, cand[:, 1], cand[:, 0]).astype(f32)
            g = pmn.min()
        return pmn, g

    guess, end = [None] * C, [None] * C
    for c in range(C):
        exact = c == 0
        pmn = np.full(S, f32(1e9) if exact else 0, f32)
        pmn[0] = 0
        pmn, g = walk(pmn, f32(0), 0 if exact else t[c] - W, t[c], False)
        guess[c] = (pmn - g).astype(f32)
        pmn, g = walk(pmn, g, t[c], t[c + 1], True)
        end[c] = (pmn - g).astype(f32)
    fix = 0
    for c in range(1, C):
        if np.any(guess[c].view(np.int32) != end[c - 1].view(np.int32)):
            pmn, g = walk(end[c - 1].copy(), f32(0), t[c], t[c + 1], True)
            end[c] = (pmn - g).astype(f32)
            fix += 1

    def back(s, t0, t1, te, bits):    # (state after t0 - 1, state at te)
        s_te = s
        for tt in range(t1 - 1, t0 - 1, -1):
            if tt == te - 1:
                s_te = s
            if tt < te:
                bits[tt] = s & 1
            s = pred[s, int(dec[tt, s])]
        return s, s_te
    bits = np.zeros(T, np.int32)
    Lt = cuda_viterbi.TRACE_PIECE
    Ct = -(-T // Lt)
    start, s_te = [0] * Ct, [0] * Ct
    D = cuda_viterbi.trace_ahead(S)
    for k in range(Ct):
        lo, te = k * Lt, min(T, k * Lt + Lt)
        hi = T if k == Ct - 1 else min(T, te + D)
        start[k], s_te[k] = back(0, lo, hi, te, bits)
    s_next, retraced = (start[Ct - 1] if Ct else 0), 0
    for k in range(Ct - 2, -1, -1):
        if s_te[k] != s_next:
            te = min(T, k * Lt + Lt)
            s_next = back(s_next, k * Lt, te, te, bits)[0]
            retraced += 1
        else:
            s_next = start[k]
    fix = (fix, retraced)
    return bits, end[C - 1], fix


@pytest.mark.parametrize("code,soft,L,W,per", [
    ("k7r2", True, 24, 2, 0), ("k7r2", False, 30, 0, 1),
    ("k3r3", True, 10, 20, 16), ("k5r2", True, 40, 64, 16)])
def test_s7_chunk_order_emulated_equals_plain(code, soft, L, W, per,
                                              monkeypatch):
    monkeypatch.setattr(cuda_viterbi, "TRACE_AHEAD_PER_MEMORY", per)
    polys, K = CODES[code]
    rng = np.random.default_rng(len(code) + L + W)
    r = _rows(rng, polys, K, 1, 150, soft, 1.0 if soft else 0.1)
    out, _ = tfec._tables(polys, K)
    bits_e, pm_e, fix_e = _s7_chunks_emulated(_np(r[0]), out, soft, L, W)
    bits_p, pm_p = tfec.viterbi_plain(r, out, soft)
    np.testing.assert_array_equal(_np(bits_p)[0], bits_e)
    np.testing.assert_array_equal(_np(pm_p)[0].view(np.int32),
                                  pm_e.view(np.int32))
    assert fix_e == (tfec.viterbi_chunked_torch(r, out, soft, L, W)[2],
                     tfec.viterbi_chunked_torch.retraced)
