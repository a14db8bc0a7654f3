"""QPSK modem and FM discriminator: port vs JAX package.

Tolerances: integer outputs (symbols, bits, slices) exact; the block carrier
recovery's frequency and phase estimates within 1e-6 and its derotated
output >= 60 dB (BASELINE.json's QPSK bound: both sides take float32 FFTs
with different roundings, and a difference in the estimate grows with t in
the float32 derotation phase); the discriminator >= 90 dB (float32 angle of
the same products).  The Costas loop (``qpsk_carrier_pll``, S2's plain
version on the CPU): symbols equal, y within 1e-4 and theta within 1e-3 rad
after 4096 steps (float32 sin/cos/atan2 of the two libraries differ in the
last ulp; the loop's feedback keeps the difference small but not zero),
1e-9 in complex128.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.models import fm as jfm
from solid_dsp_tpu.models import qpsk as jqpsk
from solid_dsp_tpu_torch.models import fm, qpsk
from torch_parity import snr_db


def _qpsk_signal(seed, T, f0, phi0, noise=0.05, sps=1):
    rng = np.random.default_rng(seed)
    sym = rng.integers(0, 4, -(-T // sps))
    x = np.repeat(jqpsk.GRAY_MAP[sym], sps)[:T]
    x = x * np.exp(1j * (f0 * np.arange(T) + phi0))
    x = x + noise * (rng.standard_normal(T) + 1j * rng.standard_normal(T))
    return sym, x.astype(np.complex64)


def test_mapping_and_bits_match_jax():
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, 512)
    sym = qpsk.bits_to_symbols(torch.from_numpy(bits))
    want = np.asarray(jqpsk.bits_to_symbols(jnp.asarray(bits)))
    assert sym.dtype == torch.int32
    np.testing.assert_array_equal(sym.numpy(), want)
    np.testing.assert_array_equal(qpsk.symbols_to_bits(sym).numpy(), bits)
    np.testing.assert_array_equal(qpsk.GRAY_MAP, jqpsk.GRAY_MAP)
    pts = qpsk.qpsk_modulate_symbols(sym)
    np.testing.assert_array_equal(
        pts.numpy(), np.asarray(jqpsk.qpsk_modulate_symbols(jnp.asarray(want))))
    np.testing.assert_array_equal(qpsk.qpsk_slice(pts).numpy(), want)


@pytest.mark.parametrize("seed,f0,phi0", [(2, 0.0032, 0.7), (3, -0.011, -2.0),
                                          (4, 0.0, 0.0)])
def test_carrier_block_matches_jax(seed, f0, phi0):
    """T = 32768: f_hat and phi_hat within 1e-6, y >= 60 dB."""
    _, x = _qpsk_signal(seed, 32768, f0, phi0, sps=8)
    y, f_hat, phi_hat = qpsk.qpsk_carrier_block(torch.from_numpy(x))
    wy, wf, wphi = jqpsk.qpsk_carrier_block(jnp.asarray(x))
    assert y.dtype == torch.complex64 and f_hat.dtype == torch.float32
    assert abs(float(f_hat) - float(wf)) <= 1e-6
    assert abs(float(phi_hat) - float(wphi)) <= 1e-6
    assert abs(float(f_hat) - f0) <= 1e-5
    wy = np.asarray(wy)
    assert snr_db(np.stack([y.numpy().real, y.numpy().imag]),
                  np.stack([wy.real, wy.imag])) >= 60.0


def test_demodulate_and_ser_match_jax():
    sym, x = _qpsk_signal(5, 8192, 0.013, 0.7, noise=0.02)
    got, y = qpsk.qpsk_demodulate(torch.from_numpy(x), recovery="block")
    want, _ = jqpsk.qpsk_demodulate(jnp.asarray(x), recovery="block")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ser = qpsk.symbol_error_rate(sym, got.numpy())
    assert ser == jqpsk.symbol_error_rate(jnp.asarray(sym), want)
    assert ser < 1e-3
    raw, y0 = qpsk.qpsk_demodulate(torch.from_numpy(x), recovery="none")
    assert torch.equal(y0, torch.from_numpy(x))
    # recovery="pll", ported: the Costas loop on the first 4096 samples
    got, y = qpsk.qpsk_demodulate(torch.from_numpy(x[:4096]), recovery="pll",
                                  bandwidth=0.02)
    want, wy = jqpsk.qpsk_demodulate(jnp.asarray(x[:4096]), recovery="pll",
                                     bandwidth=0.02)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype,atol", [(np.complex64, 1e-4),
                                        (np.complex128, 1e-9)])
@pytest.mark.parametrize("f0,theta0,dtheta0", [(0.004, 0.0, 0.0),
                                               (-0.02, 1.0, -0.01)])
def test_carrier_pll_matches_jax(dtype, atol, f0, theta0, dtheta0):
    """qpsk_carrier_pll over 4096 symbols with a carrier offset: y, theta
    and dtheta against the JAX scan; decisions equal; locked (SER < 1e-3
    past the first 1024)."""
    sym, x = _qpsk_signal(9, 4096, f0, 0.3, noise=0.02)
    x = x.astype(dtype)
    y, (th, dth) = qpsk.qpsk_carrier_pll(torch.from_numpy(x), 0.02, theta0,
                                         dtheta0)
    wy, (wth, wdth) = jqpsk.qpsk_carrier_pll(jnp.asarray(x), 0.02, theta0,
                                             dtheta0)
    assert y.dtype == torch.from_numpy(x).dtype and th.dtype == y.real.dtype
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), rtol=0, atol=atol)
    assert abs(float(th) - float(wth)) <= 10 * atol
    assert abs(float(dth) - float(wdth)) <= atol
    np.testing.assert_array_equal(qpsk.qpsk_slice(y).numpy(),
                                  np.asarray(jqpsk.qpsk_slice(wy)))
    assert qpsk.symbol_error_rate(sym[1024:],
                                  qpsk.qpsk_slice(y).numpy()[1024:]) < 1e-3


def test_fm_demodulate_matches_jax():
    rng = np.random.default_rng(6)
    T = 4000
    x = (np.exp(1j * np.cumsum(0.05 * np.sin(0.01 * np.arange(T))))
         + 0.01 * rng.standard_normal(T)).astype(np.complex64)
    prev = np.complex64(0.3 - 0.8j)
    y, st = fm.fm_demodulate(torch.tensor(prev), torch.from_numpy(x), 0.1)
    wy, wst = jfm.fm_demodulate(jnp.asarray(prev), jnp.asarray(x), 0.1)
    assert y.dtype == torch.float32
    assert snr_db(y.numpy(), np.asarray(wy)) >= 90.0
    assert complex(st) == complex(np.asarray(wst))
