"""Port vs JAX package: models/fec.py on the CPU, and S7's arithmetic
emulated.

The same seeded numpy streams go through both packages.  Gates, all exact:
the trellis tables equal; the encoder, interleaver and puncturing bit-equal;
``viterbi_decode`` (the plain walk on a CPU tensor) bit-equal to JAX's at
hard decisions (random streams: ties at nearly every step) and at soft
decisions (float32 LLRs), at K = 3 and 7, rates 1/2 and 1/3, and through
every puncturing pattern; a batch equal to its rows decoded one at a time.
S7 (``csrc/viterbi_scan.cu``) keeps every state's unrenormalised metric and
subtracts the previous step's minimum as it reads a predecessor (its soft
branch metric an FFMA chain bm + o r, o in {0, 1}: the same sums); that
order, emulated in float32 numpy, is bit-equal to the plain walk (bits and
final metrics), which its card gate then requires of the kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.models import fec as jfec
from solid_dsp_tpu_torch.models import fec as tfec
from solid_dsp_tpu_torch.ops import cuda_viterbi

CODES = {"k7r2": ((0o171, 0o133), 7), "k3r2": ((0o7, 0o5), 3),
         "k7r3": ((0o133, 0o171, 0o165), 7), "k3r3": ((0o7, 0o5, 0o7), 3)}


def _np(t):
    return t.detach().cpu().numpy()


def _stream(rng, polys, K, T, soft, noise):
    """(info bits, received values) for T information bits: a codeword
    through BPSK + AWGN (soft, float32 LLR-like) or bit flips (hard)."""
    bits = rng.integers(0, 2, T)
    c = np.asarray(jfec.conv_encode(bits, polys, K))
    if soft:
        return bits, ((1 - 2.0 * c) + noise * rng.standard_normal(c.size)
                      ).astype(np.float32)
    return bits, (c ^ (rng.random(c.size) < noise)).astype(np.int32)


@pytest.mark.parametrize("code", list(CODES))
def test_tables_and_encoder_equal_jax(code):
    polys, K = CODES[code]
    out_j, nxt_j = jfec._tables(polys, K)
    out_t, nxt_t = tfec._tables(polys, K)
    np.testing.assert_array_equal(out_t, out_j)
    np.testing.assert_array_equal(nxt_t, nxt_j)
    S = 1 << (K - 1)
    # JAX's predecessors: s in {ns >> 1, (ns >> 1) | S/2}
    ns = np.arange(S)
    np.testing.assert_array_equal(tfec._predecessors(K), np.stack(
        [ns >> 1, (ns >> 1) | (S >> 1)], -1))
    rng = np.random.default_rng(K)
    for T in (0, 1, 13, 200):
        b = rng.integers(0, 2, T)
        got = tfec.conv_encode(torch.from_numpy(b), polys, K)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(_np(got), np.asarray(
            jfec.conv_encode(b, polys, K)))


@pytest.mark.parametrize("code", list(CODES))
@pytest.mark.parametrize("soft,noise", [(False, 0.06), (False, 0.5),
                                        (True, 0.8), (True, 1.4)])
def test_viterbi_decode_bit_equal_to_jax(code, soft, noise):
    """Hard streams at flip rate 0.5 are random: ties decide most steps,
    and JAX's first-minimum rule decides them."""
    polys, K = CODES[code]
    rng = np.random.default_rng(int(noise * 100) + K + 10 * soft)
    _, rx = _stream(rng, polys, K, 120, soft, noise)
    want = np.asarray(jfec.viterbi_decode(jnp.asarray(rx), polys, K,
                                          soft=soft))
    got = tfec.viterbi_decode(torch.from_numpy(rx), polys, K, soft=soft)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(_np(got), want)


def test_viterbi_corrects_errors_and_ties_follow_first_minimum():
    """At 4% flips the K = 7 code recovers every bit; and an all-ones
    hard stream of odd length ties everywhere yet decodes as JAX does."""
    rng = np.random.default_rng(3)
    bits, rx = _stream(rng, *CODES["k7r2"], 300, False, 0.04)
    np.testing.assert_array_equal(_np(tfec.viterbi_decode(
        torch.from_numpy(rx))), bits)
    ones = np.ones(2 * 37, np.int32)
    np.testing.assert_array_equal(
        _np(tfec.viterbi_decode(torch.from_numpy(ones))),
        np.asarray(jfec.viterbi_decode(jnp.asarray(ones))))


@pytest.mark.parametrize("pattern", ["PUNCTURE_2_3", "PUNCTURE_3_4",
                                     "PUNCTURE_5_6", "PUNCTURE_7_8"])
def test_puncturing_every_pattern_equals_jax(pattern):
    pat = getattr(tfec, pattern)
    assert pat == getattr(jfec, pattern)
    period = len(pat[0])
    rng = np.random.default_rng(period)
    T = 42 * period - 6           # + 6 tail bits: a multiple of the period
    bits = rng.integers(0, 2, T)
    c = np.asarray(jfec.conv_encode(bits))
    p_j = np.asarray(jfec.puncture(c, pat))
    p_t = tfec.puncture(torch.from_numpy(c), pat)
    np.testing.assert_array_equal(_np(p_t), p_j)
    llr = ((1 - 2.0 * p_j) + 0.6 * rng.standard_normal(p_j.size)).astype(
        np.float32)
    d_j = np.asarray(jfec.depuncture(jnp.asarray(llr), pat))
    d_t = tfec.depuncture(torch.from_numpy(llr), pat)
    np.testing.assert_array_equal(_np(d_t), d_j)
    np.testing.assert_array_equal(
        _np(tfec.depuncture(torch.from_numpy(p_j), pat, hard=True)),
        np.asarray(jfec.depuncture(jnp.asarray(p_j), pat, hard=True)))
    want = np.asarray(jfec.viterbi_decode(jnp.asarray(d_j), soft=True))
    got = _np(tfec.viterbi_decode(d_t, soft=True))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tfec.puncture(torch.from_numpy(c[:-2]), pat)
    with pytest.raises(ValueError):
        tfec.depuncture(torch.from_numpy(llr[:-1]), pat)


@pytest.mark.parametrize("soft", [False, True])
def test_batch_equals_rows_one_at_a_time(soft):
    polys, K = CODES["k7r2"]
    rng = np.random.default_rng(11 + soft)
    rows = np.stack([_stream(rng, polys, K, 90, soft, 0.9 if soft else 0.1)
                     [1] for _ in range(5)])
    batch = tfec.viterbi_decode(torch.from_numpy(rows).reshape(5, 1, -1),
                                soft=soft)
    assert batch.shape == (5, 1, 90)
    for i in range(5):
        one = tfec.viterbi_decode(torch.from_numpy(rows[i]), soft=soft)
        np.testing.assert_array_equal(_np(batch[i, 0]), _np(one))
    code = tfec.ConvCode(device="cpu")
    np.testing.assert_array_equal(
        _np(code.decode(torch.from_numpy(rows), soft=soft)),
        _np(batch[:, 0]))


def test_interleaver_and_class_equal_jax():
    rng = np.random.default_rng(2)
    b = rng.integers(0, 2, 6 * 9)
    it = tfec.interleave(torch.from_numpy(b), 6, 9)
    np.testing.assert_array_equal(_np(it), np.asarray(
        jfec.interleave(b, 6, 9)))
    np.testing.assert_array_equal(_np(tfec.deinterleave(it, 6, 9)), b)
    np.testing.assert_array_equal(
        _np(tfec.interleave(torch.from_numpy(np.stack([b, b])), 6, 9))[1],
        _np(it))
    with pytest.raises(ValueError):
        tfec.interleave(torch.from_numpy(b[:-1]), 6, 9)
    tc, jc = tfec.ConvCode(device="cpu"), jfec.ConvCode()
    assert (repr(tc), tc.rate, tc.K) == (repr(jc), jc.rate, jc.K)
    np.testing.assert_array_equal(_np(tc.encode(b)), np.asarray(
        jc.encode(b)))


def test_viterbi_rejects_truncated_stream_and_kernel_limits():
    with pytest.raises(ValueError, match="multiple of n"):
        tfec.viterbi_decode(torch.zeros(2 * 20 + 1))
    with pytest.raises(ValueError):
        jfec.viterbi_decode(jnp.zeros(2 * 20 + 1))
    # S7 takes CUDA tensors and at most 1024 states; the plain walk any K
    out, _ = tfec._tables((0o171, 0o133), 7)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_viterbi.viterbi_cuda(torch.zeros(1, 8, 2), True, out,
                                  tfec._predecessors(7))
    out12, _ = tfec._tables((0o4335, 0o5723), 12)
    with pytest.raises(ValueError, match="1024 states"):
        cuda_viterbi.check_trellis(out12, tfec._predecessors(12))
    rng = np.random.default_rng(12)
    _, rx = _stream(rng, (0o4335, 0o5723), 12, 40, True, 0.5)
    np.testing.assert_array_equal(
        _np(tfec.viterbi_decode(torch.from_numpy(rx), (0o4335, 0o5723), 12,
                                soft=True)),
        np.asarray(jfec.viterbi_decode(jnp.asarray(rx), (0o4335, 0o5723),
                                       12, soft=True)))


def _s7_emulated(r: np.ndarray, out_tab: np.ndarray, soft: bool):
    """S7's per-thread order in float32 numpy: pmn kept unrenormalised,
    each predecessor read as pmn[p] - min(previous pmn); the min of the
    start taken as 0; choice 1 where cand_1 < cand_0; the traceback from
    state 0 over the stored decisions."""
    f32 = np.float32
    S, _, n = out_tab.shape
    T = r.shape[0]
    ns = np.arange(S)
    p = np.stack([ns >> 1, (ns >> 1) | (S >> 1)], -1)
    b = ns & 1
    pmn = np.full(S, f32(1e9), f32)
    pmn[0] = 0
    g = f32(0)
    dec = np.zeros((T, S), bool)
    for t in range(T):
        cand = []
        for c in (0, 1):
            o = out_tab[p[:, c], b]                     # (S, n)
            if soft:
                bm = np.zeros(S, f32)
                for k in range(n):
                    bm = np.where(o[:, k] == 1, bm + r[t, k], bm).astype(f32)
            else:
                bm = np.abs(o - r[t]).sum(-1).astype(f32)
            cand.append((pmn[p[:, c]] - g).astype(f32) + bm)
        ch = cand[1] < cand[0]
        dec[t] = ch
        pmn = np.where(ch, cand[1], cand[0]).astype(f32)
        g = pmn.min()
    s, bits = 0, np.zeros(T, np.int32)
    for t in range(T - 1, -1, -1):
        bits[t] = s & 1
        s = p[s, int(dec[t, s])]
    return bits, (pmn - g).astype(f32)


@pytest.mark.parametrize("code", ["k7r2", "k3r3"])
@pytest.mark.parametrize("soft", [False, True])
def test_s7_order_emulated_equals_plain(code, soft):
    polys, K = CODES[code]
    n = len(polys)
    rng = np.random.default_rng(K + n + soft)
    _, rx = _stream(rng, polys, K, 150, soft, 1.0 if soft else 0.3)
    r = rx.reshape(-1, n)
    out_tab, _ = tfec._tables(polys, K)
    bits_e, pm_e = _s7_emulated(r, out_tab, soft)
    bits_p, pm_p = tfec.viterbi_plain(torch.from_numpy(r)[None], out_tab,
                                      soft)
    np.testing.assert_array_equal(_np(bits_p)[0], bits_e)
    np.testing.assert_array_equal(_np(pm_p)[0], pm_e)
