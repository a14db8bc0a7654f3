"""Port vs JAX package: utils/bits.py on the CPU.

Gates, all exact: ``crc32`` equal to ``binascii.crc32`` and to JAX's at
every length class (empty, under a chunk, whole chunks, a remainder);
``crc16_ccitt`` 0x29B1 over "123456789"; ``crc_compute`` equal to JAX's for
reflected and plain polynomials of widths 8-32 at chunks 8-64 (the tree fold
against JAX's sequential chunk scan); the CRC fold matrices equal JAX's; a
batch of rows equal to the rows one at a time; the scramblers' outputs and
final registers equal JAX's at every length and seed, descrambling
inverting them; ``crc_check`` equal.
"""

import binascii

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.utils import bits as jb
from solid_dsp_tpu_torch.utils import bits as tb


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 64, 100, 1000])
def test_crc32_matches_binascii_and_jax(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8
                                             ).tobytes()
    assert tb.crc32(data) == binascii.crc32(data) == jb.crc32(data)
    assert tb.crc16_ccitt(data) == jb.crc16_ccitt(data)


def test_crc16_check_value_and_bit_input():
    assert tb.crc16_ccitt(b"123456789") == 0x29B1
    bits = tb._bytes_to_bits_lsb_first(b"hello world")
    assert tb.crc32(bits) == binascii.crc32(b"hello world")
    assert tb.crc32(torch.from_numpy(bits.astype(np.int32))) == \
        binascii.crc32(b"hello world")


@pytest.mark.parametrize("poly,width,init,xorout,reflected", [
    (0xEDB88320, 32, 0xFFFFFFFF, 0xFFFFFFFF, True),
    (0x1021, 16, 0xFFFF, 0, False),
    (0x8005, 16, 0, 0, False),
    (0x07, 8, 0, 0x55, False),
    (0x8C, 8, 0xFF, 0, True),
])
@pytest.mark.parametrize("chunk", [8, 32, 64])
def test_crc_compute_equals_jax(poly, width, init, xorout, reflected, chunk):
    rng = np.random.default_rng(width + chunk)
    for n in (chunk - 1, chunk, 5 * chunk + 3, 37 * chunk):
        b = rng.integers(0, 2, n)
        want = int(jb.crc_compute(jnp.asarray(b), poly, width, init, xorout,
                                  reflected, chunk))
        got = tb.crc_compute(torch.from_numpy(b), poly, width, init, xorout,
                             reflected, chunk)
        assert got.dtype == torch.int64 and int(got) == want
    M_j, C_j = jb._crc_matrices(poly, width, reflected, chunk)
    M_t, C_t = tb._crc_matrices(poly, width, reflected, chunk)
    np.testing.assert_array_equal(M_t, M_j)
    np.testing.assert_array_equal(C_t, C_j)


def test_crc_batch_equals_rows():
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 2, (6, 333))
    got = tb.crc_compute(torch.from_numpy(rows), 0xEDB88320, 32, 0xFFFFFFFF,
                         0xFFFFFFFF, True)
    assert got.shape == (6,)
    for i in range(6):
        assert int(got[i]) == tb.crc32(rows[i].astype(np.int8))


@pytest.mark.parametrize("nbits,taps,state", [(7, (7, 4), 0x7F),
                                              (7, (7, 4), 0x15),
                                              (15, (15, 14), 1),
                                              (5, (5, 3), 0)])
def test_multiplicative_scrambler_equals_jax(nbits, taps, state):
    """Lengths around the port's 32-bit chunk: none, under one, one, and
    a ragged sixth chunk (three levels of the doubling prefix)."""
    rng = np.random.default_rng(nbits + state)
    for n in (0, 1, nbits - 1, nbits, 31, 32, 33, 64, 5 * 32 + 7):
        b = rng.integers(0, 2, n)
        jo, jf = jb.multiplicative_scramble(b, nbits, taps, state)
        to, tf = tb.multiplicative_scramble(torch.from_numpy(b), nbits, taps,
                                            state)
        np.testing.assert_array_equal(_np(to), np.asarray(jo))
        assert int(tf) == int(jf)
        back = tb.multiplicative_descramble(to, nbits, taps, state)
        np.testing.assert_array_equal(_np(back), b)
        np.testing.assert_array_equal(
            _np(back), np.asarray(jb.multiplicative_descramble(
                jnp.asarray(jo), nbits, taps, state)))
    with pytest.raises(ValueError):
        tb.multiplicative_scramble(torch.zeros(4, dtype=torch.int32), 7,
                                   (8, 4))


def test_additive_scramble_and_crc_check_equal_jax():
    rng = np.random.default_rng(8)
    b = rng.integers(0, 2, 40000)        # longer than the 32767 period
    s = tb.additive_scramble(torch.from_numpy(b))
    np.testing.assert_array_equal(_np(s), np.asarray(jb.additive_scramble(b)))
    np.testing.assert_array_equal(_np(tb.additive_scramble(s)), b)
    np.testing.assert_array_equal(
        _np(tb.additive_scramble(torch.from_numpy(b[:100]), 9, seed=5)),
        np.asarray(jb.additive_scramble(b[:100], 9, seed=5)))
    payload = rng.integers(0, 2, 200).astype(np.int8)
    c = tb.crc32(payload)
    frame = np.concatenate([payload, (c >> np.arange(32)) & 1])
    assert tb.crc_check(frame) and jb.crc_check(frame)
    frame[3] ^= 1
    assert not tb.crc_check(frame) and not jb.crc_check(frame)
    c16 = tb.crc16_ccitt(payload)
    f16 = np.concatenate([payload, (c16 >> np.arange(15, -1, -1)) & 1])
    assert tb.crc_check(f16, 16) == jb.crc_check(f16, 16) is True
