"""Port vs JAX package: models/block_codes.py, models/rs.py and
models/ccsds.py on the CPU.

Gates, all exact: the Hamming/SECDED matrices and syndrome tables, the
Golay tables, the RS generator and its parity and syndrome bit-matrices
equal JAX's; every scheme's encoder bit-equal and its decoder's data and
fail flags equal JAX's on the same received bits (errors within and past
each code's radius); RS codewords, syndromes and decodes (errors, erasures,
beyond t, shortened) equal; CCSDS channel bits equal and the frame decoded
at the operating point of tests/test_ccsds.py (Eb/N0 2.8 dB) and through
its 400-bit burst, as JAX decodes them.
"""

import numpy as np
import pytest
import torch

from solid_dsp_tpu.models import block_codes as jbc
from solid_dsp_tpu.models import ccsds as jcc
from solid_dsp_tpu.models import rs as jrs
from solid_dsp_tpu_torch.models import block_codes as tbc
from solid_dsp_tpu_torch.models import ccsds as tcc
from solid_dsp_tpu_torch.models import rs as trs

CPU = "cpu"


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def test_tables_equal_jax():
    for m, k in ((3, 4), (4, 8), (5, 16), (6, 32), (7, 64)):
        for a, b in zip(tbc.hamming_matrices(m, k),
                        jbc.hamming_matrices(m, k)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(tbc._hamming_lut(m, k), jbc._hamming_lut(m, k)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(tbc.golay_tables(), jbc.golay_tables()):
        np.testing.assert_array_equal(a, b)
    assert tbc.SCHEMES == jbc.SCHEMES
    with pytest.raises(ValueError):
        tbc.hamming_matrices(3, 5)


@pytest.mark.parametrize("scheme", list(jbc.SCHEMES))
def test_block_codes_equal_jax(scheme):
    """Random data, then 0 to 5 flips a block (past every radius): the
    coded bits, the decoded data and the fail flags equal JAX's."""
    k, n, _ = tbc.SCHEMES[scheme]
    rng = np.random.default_rng(n)
    data = rng.integers(0, 2, (64, k)).astype(np.int32)
    c_t = tbc.block_encode(torch.from_numpy(data), scheme)
    c_j = np.asarray(jbc.block_encode(data, scheme))
    assert c_t.dtype == torch.int32
    np.testing.assert_array_equal(_np(c_t), c_j)
    r = c_j.copy()
    for i in range(r.shape[0]):
        flips = rng.choice(n, size=min(n, i % 6), replace=False)
        r[i, flips] ^= 1
    d_t, f_t = tbc.block_decode(torch.from_numpy(r), scheme)
    d_j, f_j = jbc.block_decode(r, scheme)
    np.testing.assert_array_equal(_np(d_t), np.asarray(d_j))
    np.testing.assert_array_equal(_np(f_t), np.asarray(f_j))
    assert f_t.dtype == torch.bool
    # within the radius every block comes back
    clean, _ = tbc.block_decode(c_t, scheme)
    np.testing.assert_array_equal(_np(clean), data)


def test_blockcode_class_flat_api():
    t, j = tbc.BlockCode("g2412", CPU), jbc.BlockCode("g2412")
    assert (repr(t), t.rate, t.k, t.n) == (repr(j), j.rate, j.k, j.n)
    bits = np.random.default_rng(1).integers(0, 2, 120)
    np.testing.assert_array_equal(_np(t.encode(bits)),
                                  np.asarray(j.encode(bits)))
    d, f = t.decode(t.encode(bits))
    np.testing.assert_array_equal(_np(d), bits)
    assert not bool(f.any())
    with pytest.raises(ValueError):
        tbc.BlockCode("nope", CPU)
    with pytest.raises(ValueError):
        tbc.block_encode(torch.zeros(7, dtype=torch.int32), "h74")


@pytest.fixture(scope="module")
def rs_pair():
    return trs.rs_255_223(CPU), jrs.rs_255_223()


def test_rs_tables_equal_jax():
    assert trs._generator_poly(32) == jrs._generator_poly(32)
    np.testing.assert_array_equal(trs._gf_tables()[0], jrs._gf_tables()[0])
    np.testing.assert_array_equal(trs._parity_matrix_bits(223, 32),
                                  jrs._parity_matrix_bits(223, 32))
    np.testing.assert_array_equal(trs._syndrome_matrix_bits(255, 32),
                                  jrs._syndrome_matrix_bits(255, 32))


def test_rs_encode_syndromes_decode_equal_jax(rs_pair):
    t, j = rs_pair
    rng = np.random.default_rng(7)
    msg = rng.integers(0, 256, (12, t.k)).astype(np.int32)
    cw_t = t.encode(torch.from_numpy(msg))
    cw_j = np.asarray(j.encode(msg))
    np.testing.assert_array_equal(_np(cw_t), cw_j)
    assert not _np(t.syndromes(cw_t)).any()
    rx = cw_j.copy()
    for i in range(12):                   # 0 .. 22 errors: past t = 16 too
        pos = rng.choice(t.n, size=2 * i, replace=False)
        rx[i, pos] ^= rng.integers(1, 256, 2 * i)
    np.testing.assert_array_equal(_np(t.syndromes(torch.from_numpy(rx))),
                                  np.asarray(j.syndromes(rx)))
    m_t, ok_t = t.decode(rx)
    m_j, ok_j = j.decode(rx)
    np.testing.assert_array_equal(_np(m_t), np.asarray(m_j))
    np.testing.assert_array_equal(_np(ok_t), np.asarray(ok_j))
    assert _np(ok_t)[:9].all()
    np.testing.assert_array_equal(_np(m_t)[:9], msg[:9])
    # errors and erasures: 10 erasures + 10 errors (2 nu + mu = 30 <= 32)
    bad = cw_j[0].copy()
    era = np.zeros(t.n, bool)
    pos = rng.choice(t.n, 20, replace=False)
    bad[pos] ^= rng.integers(1, 256, 20)
    era[pos[:10]] = True
    m_t, ok_t = t.decode(bad, erasures=era)
    m_j, ok_j = j.decode(bad, erasures=era)
    assert bool(ok_t) and bool(ok_j)
    np.testing.assert_array_equal(_np(m_t), np.asarray(m_j))
    assert repr(t) == repr(j)


def test_rs_204_188_shortened_equals_jax():
    t, j = trs.rs_204_188(CPU), jrs.rs_204_188()
    assert (t.n, t.k, t.t) == (j.n, j.k, j.t) == (204, 188, 8)
    rng = np.random.default_rng(9)
    msg = rng.integers(0, 256, (3, t.k)).astype(np.int32)
    cw = _np(t.encode(msg))
    np.testing.assert_array_equal(cw, np.asarray(j.encode(msg)))
    cw[:, [5, 50, 100, 150, 200]] ^= 0x5A
    m_t, ok_t = t.decode(cw)
    np.testing.assert_array_equal(_np(m_t), msg)
    assert _np(ok_t).all()
    with pytest.raises(ValueError):
        trs.RSCode(nroots=3)
    with pytest.raises(ValueError):
        t.encode(np.zeros(10, np.int32))


@pytest.fixture(scope="module")
def ccsds_pair():
    return tcc.CCSDSLink(4, CPU), jcc.CCSDSLink(4)


def _payload(link, seed):
    return np.random.default_rng(seed).integers(
        0, 256, link.payload_bytes, dtype=np.uint8).tobytes()


def test_ccsds_encode_equals_jax_and_operating_point(ccsds_pair):
    t, j = ccsds_pair
    data = _payload(t, 1)
    tx = _np(t.encode(data))
    np.testing.assert_array_equal(tx, np.asarray(j.encode(data)))
    R = len(data) * 8 / len(tx)
    sigma = np.sqrt(1 / (2 * R * 10 ** (2.8 / 10)))
    y = (1 - 2.0 * tx) + sigma * np.random.default_rng(2).standard_normal(
        len(tx))
    llr = (2 * y / sigma ** 2).astype(np.float32)
    dec, ok = t.decode(llr)
    assert ok and dec == data
    assert (dec, ok) == j.decode(llr)
    assert repr(t) == repr(j)
    with pytest.raises(ValueError):
        t.encode(data[:-1])


def test_ccsds_burst_protection_equals_jax(ccsds_pair):
    t, j = ccsds_pair
    data = _payload(t, 3)
    bad = _np(t.encode(data)).copy()
    bad[5000:5400] ^= 1
    llr = (1.0 - 2.0 * bad).astype(np.float32)
    got = t.decode(llr)
    assert got == (data, True) == j.decode(llr)
