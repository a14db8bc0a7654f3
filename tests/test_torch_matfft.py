"""Port vs JAX package: the four-step DFT as matrix products (ops/matfft.py).

The same inputs, made with numpy from a seed, go through both packages.
Gates (tests/test_matfft.py's): > 90 dB between the two at complex64
(composite sizes; the prime Bluestein route > 80 dB, its two extra
transforms' slack), > 200 dB at complex128; the split rule equal.  The
JAX package runs "x3" as full precision on the CPU, the port as FP32
everywhere; "default" (bf16 operands) is held against float64 numpy
instead, since the JAX package's CPU ignores it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.ops import matfft as jmatfft
from solid_dsp_tpu_torch.ops import matfft
from torch_parity import snr_db

SIZES = [1, 2, 8, 13, 60, 64, 100, 128, 240, 256, 271, 1000, 1024, 4096,
         12288]


def _sig(shape, seed=0, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


@pytest.mark.parametrize("n", SIZES)
def test_forward_matches_jax_c64(n):
    """fft_mx at complex64 against the JAX package's (> 90 dB; > 80 dB on
    the prime Bluestein route) and both against float64 numpy."""
    x = _sig((3, n), seed=n)
    got = matfft.fft_mx(torch.from_numpy(x)).numpy()
    ref = np.asarray(jmatfft.fft_mx(jnp.asarray(x)))
    assert got.dtype == np.complex64
    gate = 80.0 if (n > matfft.DIRECT_MAX and matfft._split(n) == 1) else 90.0
    assert snr_db(got, ref) > gate
    assert snr_db(got, np.fft.fft(x.astype(np.complex128))) > gate


@pytest.mark.parametrize("n", [8, 60, 271, 1000, 4096])
def test_forward_and_inverse_match_jax_c128(n):
    """fft_mx and ifft_mx at complex128: > 200 dB against JAX's; the
    inverse is unnormalized."""
    x = _sig((2, n), seed=n + 1, dtype=np.complex128)
    for fn in ("fft_mx", "ifft_mx"):
        got = getattr(matfft, fn)(torch.from_numpy(x)).numpy()
        ref = np.asarray(getattr(jmatfft, fn)(jnp.asarray(x)))
        assert got.dtype == np.complex128
        assert snr_db(got, ref) > 200.0
    np.testing.assert_allclose(matfft.ifft_mx(torch.from_numpy(x)).numpy(),
                               np.fft.ifft(x) * n, rtol=0, atol=1e-9 * n)


def test_planar_entry_point_matches_jax():
    """dft_mx_planar on (pr, pi) float32 planes, both signs: > 90 dB."""
    x = _sig((4, 1000), seed=3)
    for sign in (-1, 1):
        re, im = matfft.dft_mx_planar(torch.from_numpy(x.real.copy()),
                                      torch.from_numpy(x.imag.copy()), sign)
        jre, jim = jmatfft.dft_mx_planar(jnp.asarray(x.real),
                                         jnp.asarray(x.imag), sign)
        assert snr_db(re.numpy() + 1j * im.numpy(),
                      np.asarray(jre) + 1j * np.asarray(jim)) > 90.0


def test_nfft_pad_and_truncate_match_jax():
    x = _sig(100, seed=4)
    for nfft in (128, 64):
        got = matfft.fft_mx(torch.from_numpy(x), nfft=nfft).numpy()
        ref = np.asarray(jmatfft.fft_mx(jnp.asarray(x), nfft=nfft))
        assert got.shape == (nfft,) and snr_db(got, ref) > 90.0


def test_split_matches_jax():
    """The balanced divisor rule is the JAX package's for n = 1..5000."""
    for n in range(1, 5001):
        assert matfft._split(n) == jmatfft._split(n), n


def test_banks_match_jax():
    """DFT banks and twiddle planes: equal to JAX's (the same float64
    construction)."""
    for n, sign in ((16, -1), (128, 1), (60, -1)):
        np.testing.assert_array_equal(
            matfft._dft_bank_np(n, sign, "float32"),
            jmatfft._dft_bank_np(n, sign, "float32"))
    np.testing.assert_array_equal(matfft._twiddle_np(32, 128, -1, "float64"),
                                  jmatfft._twiddle_np(32, 128, -1, "float64"))


def test_default_precision_is_a_bf16_product():
    """"default" rounds both operands to bf16 (~45 dB, the JAX package's
    TPU meaning); "highest" and "x3" are full precision; others raise."""
    x = _sig((8, 4096), seed=5)
    ref = np.fft.fft(x.astype(np.complex128))
    fast = matfft.fft_mx(torch.from_numpy(x), precision="default").numpy()
    full = matfft.fft_mx(torch.from_numpy(x), precision="x3").numpy()
    assert 35.0 < snr_db(fast, ref) < 60.0
    assert snr_db(full, ref) > 100.0
    with pytest.raises(ValueError):
        matfft.fft_mx(torch.from_numpy(x), precision="tf32")
