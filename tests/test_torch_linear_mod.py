"""Port vs JAX package: models/linear_mod.py on the CPU.

The same seeded numpy inputs go through both packages.  Gates: the
constellations bit-equal; bit/symbol packing, slicing, hard demodulation
and DPSK bit-equal (inputs away from decision ties); the soft demapper's
LLRs, pulse shaping, the matched filter and the modem's waveforms within
1e-5 x max in complex64 / float32 (the convolutions and the metric sum in
another order) and 1e-9 in complex128 (tests/test_linear_mod.py's
brute-force gate); ``unwrap``/``interp`` and the V&V trajectory within
1e-12 of JAX's in float64, its corrected symbols within 1e-5 (complex64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.models import linear_mod as jlm
from solid_dsp_tpu_torch.models import linear_mod as tlm

CPU = "cpu"
SCHEMES = [("psk", 2), ("psk", 4), ("psk", 8), ("qam", 16), ("qam", 64),
           ("apsk", 16), ("apsk", 32)]


def _np(t):
    return t.detach().cpu().numpy()


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _noisy(rng, pts, n, sigma, dtype=np.complex64):
    syms = rng.integers(0, len(pts), n)
    y = pts[syms] + sigma * (rng.standard_normal(n)
                             + 1j * rng.standard_normal(n))
    return syms, y.astype(dtype)


@pytest.mark.parametrize("scheme,m", SCHEMES)
def test_constellations_equal_jax(scheme, m):
    np.testing.assert_array_equal(tlm.constellation(scheme, m),
                                  jlm.constellation(scheme, m))


def test_bits_symbols_equal_jax():
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, 600).astype(np.int32)
    for k in (1, 2, 3, 4, 6):
        n = (600 // k) * k
        s_t = tlm.bits_to_symbols(torch.from_numpy(bits[:n]), k)
        s_j = np.asarray(jlm.bits_to_symbols(bits[:n], k))
        assert s_t.dtype == torch.int32
        np.testing.assert_array_equal(_np(s_t), s_j)
        np.testing.assert_array_equal(
            _np(tlm.symbols_to_bits(s_t, k)),
            np.asarray(jlm.symbols_to_bits(s_j, k)))
    pts = jlm.qam_constellation(16)
    syms = rng.integers(0, 16, 50)
    np.testing.assert_array_equal(
        _np(tlm.modulate_symbols(torch.from_numpy(syms), pts)),
        np.asarray(jlm.modulate_symbols(syms, pts)))


@pytest.mark.parametrize("scheme,m", SCHEMES)
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_slice_and_demap_equal_jax(scheme, m, dtype):
    rng = np.random.default_rng(m)
    pts = jlm.constellation(scheme, m)
    _, y = _noisy(rng, pts, 4000, 0.15, dtype)
    hard_t = tlm.slice_symbols(torch.from_numpy(y), pts)
    hard_j = np.asarray(jlm.slice_symbols(jnp.asarray(y), pts))
    llr_t = tlm.demap_soft(torch.from_numpy(y), pts, 0.1)
    llr_j = np.asarray(jlm.demap_soft(jnp.asarray(y), pts, 0.1))
    assert hard_t.dtype == torch.int32 and llr_t.dtype == (
        torch.float32 if dtype == np.complex64 else torch.float64)
    # ties: the two best metrics within the type's rounding decide nothing
    metric = (y[:, None] * np.conj(pts)).real - 0.5 * np.abs(pts) ** 2
    top2 = np.sort(metric, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-4
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(_np(hard_t)[clear], hard_j[clear])
    _close(_np(llr_t), llr_j, 1e-5 if dtype == np.complex64 else 1e-9)


def test_demap_soft_takes_a_tensor_noise_var():
    rng = np.random.default_rng(3)
    pts = jlm.qam_constellation(64)
    _, y = _noisy(rng, pts, 500, 0.05)
    got = tlm.demap_soft(torch.from_numpy(y), pts, torch.tensor(0.02))
    _close(_np(got), np.asarray(jlm.demap_soft(jnp.asarray(y), pts,
                                               jnp.asarray(0.02))), 1e-5)


@pytest.mark.parametrize("flush", [False, True])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_pulse_shape_and_matched_filter_equal_jax(flush, dtype):
    rng = np.random.default_rng(4)
    iq = jlm.qam_constellation(16)[rng.integers(0, 16, 300)]
    jdt = jnp.complex64 if dtype == torch.complex64 else jnp.complex128
    tol = 1e-5 if dtype == torch.complex64 else 1e-9
    got = tlm.pulse_shape(torch.from_numpy(iq), 4, 6, 0.35, dtype, flush)
    want = np.asarray(jlm.pulse_shape(iq, 4, 6, 0.35, jdt, flush))
    assert got.dtype == dtype
    _close(_np(got), want, tol)
    mf_t = tlm.matched_filter(got, 4, 6, 0.35)
    mf_j = np.asarray(jlm.matched_filter(jnp.asarray(want), 4, 6, 0.35))
    _close(_np(mf_t), mf_j, tol)


@pytest.mark.parametrize("scheme,m", [("psk", 4), ("qam", 16), ("qam", 64),
                                      ("apsk", 32)])
def test_linear_modem_equals_jax(scheme, m):
    """Loopback with AWGN: the waveform, the hard bits and symbols and the
    soft LLRs (the noise estimate included) as JAX's."""
    rng = np.random.default_rng(5 + m)
    k = int(np.log2(m))
    bits = rng.integers(0, 2, 300 * k).astype(np.int32)
    tm = tlm.LinearModem(scheme, m, sps=4, device=CPU)
    jm = jlm.LinearModem(scheme, m, sps=4)
    iq_t, iq_j = tm.modulate(bits), np.asarray(jm.modulate(bits))
    assert iq_t.device.type == "cpu" and iq_t.dtype == torch.complex64
    _close(_np(iq_t), iq_j, 1e-5)
    noise = 0.03 * (rng.standard_normal(iq_j.shape)
                    + 1j * rng.standard_normal(iq_j.shape))
    rx = (iq_j + noise).astype(np.complex64)
    b_t, s_t = tm.demodulate(rx)
    b_j, s_j = jm.demodulate(rx)
    np.testing.assert_array_equal(_np(s_t), np.asarray(s_j))
    np.testing.assert_array_equal(_np(b_t), np.asarray(b_j))
    np.testing.assert_array_equal(_np(b_t)[:bits.size], bits)
    _close(_np(tm.demodulate_soft(rx)), np.asarray(jm.demodulate_soft(rx)),
           1e-4)
    _close(_np(tm.demodulate_soft(rx, 0.01)),
           np.asarray(jm.demodulate_soft(rx, 0.01)), 1e-5)


@pytest.mark.parametrize("m", [2, 4, 8])
def test_dpsk_equals_jax(m):
    rng = np.random.default_rng(6 + m)
    k = int(np.log2(m))
    bits = rng.integers(0, 2, 200 * k).astype(np.int32)
    tx_t = tlm.dpsk_modulate(torch.from_numpy(bits), m)
    tx_j = np.asarray(jlm.dpsk_modulate(bits, m))
    assert tx_t.dtype == torch.complex64
    _close(_np(tx_t), tx_j, 1e-6)
    rx = (tx_j * np.exp(0.7j) + 0.05 * (rng.standard_normal(tx_j.size) + 1j
          * rng.standard_normal(tx_j.size))).astype(np.complex64)
    got = tlm.dpsk_demodulate(torch.from_numpy(rx), m)
    np.testing.assert_array_equal(_np(got),
                                  np.asarray(jlm.dpsk_demodulate(rx, m)))
    np.testing.assert_array_equal(_np(got), bits)
    with pytest.raises(ValueError):
        tlm.dpsk_modulate(torch.from_numpy(bits[:6]), 3)


def test_unwrap_and_interp_equal_jax():
    rng = np.random.default_rng(7)
    p = np.cumsum(rng.uniform(-3.5, 3.5, (3, 200)), axis=-1)
    p[0, 5] = p[0, 4] + np.pi            # a step of exactly period / 2
    w = np.angle(np.exp(1j * p))
    np.testing.assert_allclose(_np(tlm.unwrap(torch.from_numpy(w))),
                               np.asarray(jnp.unwrap(w)), rtol=0, atol=1e-12)
    xp = np.sort(rng.uniform(0, 10, 20))
    fp = rng.standard_normal(20)
    x = np.linspace(-2, 12, 301)
    np.testing.assert_allclose(
        _np(tlm.interp(*(torch.from_numpy(a) for a in (x, xp, fp)))),
        np.asarray(jnp.interp(x, xp, fp)), rtol=0, atol=1e-12)


@pytest.mark.parametrize("m,seg", [(4, 64), (2, 32), (8, 50)])
def test_vv_carrier_correct_equals_jax(m, seg):
    rng = np.random.default_rng(8 + m)
    n = 1000
    pts = jlm.psk_constellation(m)
    t = np.arange(n)
    y = (pts[rng.integers(0, m, n)] * np.exp(1j * (0.3 + 2e-4 * t + 0.02
         * np.cumsum(rng.standard_normal(n)) / 10))
         + 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         ).astype(np.complex64)
    yc_t, tr_t = tlm.vv_carrier_correct(torch.from_numpy(y), m, seg)
    yc_j, tr_j = jlm.vv_carrier_correct(jnp.asarray(y), m, seg)
    assert tr_t.dtype == torch.float64 and yc_t.dtype == torch.complex64
    _close(_np(tr_t), np.asarray(tr_j), 1e-6)
    _close(_np(yc_t), np.asarray(yc_j), 1e-5)
    with pytest.raises(ValueError):
        tlm.vv_carrier_correct(torch.from_numpy(y[:10]), m, seg)
