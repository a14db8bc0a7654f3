"""Port vs JAX package: analysis/snr.py, estimate.py, cyclo.py and
measurements.py.

The same seeded numpy inputs go through both packages on the CPU.  Gates:
the M2M4 SNR, EVM, noise floor (its median on odd and even counts) and tone
SNR within rtol 1e-9 of JAX's in float64 / complex128; Kay's and the
Newton-refined FFT frequency estimates, the ML phase and amplitude and
GCC-PHAT within 1e-9 of JAX's (the complex64 estimates to 1e-6: the
float32 time ramps and argmaxes are JAX's too); the cyclic spectrum, the
coherence and the cycle profile within rtol 1e-9 (complex128), and in
complex64 within 1e-4 of the coherence's scale; the detector's and the
symbol-rate search's decisions equal and their profiles within 1e-4
(complex64); the RF measurements within rtol 1e-9 of JAX's on float64 /
complex128 inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

from solid_dsp_tpu.analysis import cyclo as jcy
from solid_dsp_tpu.analysis import estimate as jes
from solid_dsp_tpu.analysis import measurements as jme
from solid_dsp_tpu.analysis import snr as jsn
from solid_dsp_tpu_torch import analysis
from solid_dsp_tpu_torch.analysis import cyclo as tcy
from solid_dsp_tpu_torch.analysis import estimate as tes
from solid_dsp_tpu_torch.analysis import measurements as tme
from solid_dsp_tpu_torch.analysis import snr as tsn


def _cn(rng, n, scale=1.0):
    return scale * (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        / np.sqrt(2)


def _close(got, ref, rtol=1e-9, atol=0.0):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


def _qpsk(rng, n):
    return np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, n)))


# -------------------------------------------------------------------- snr

@pytest.mark.parametrize("kurtosis", [1.0, 1.32])
def test_snr_m2m4_and_evm_equal_jax(kurtosis):
    rng = np.random.default_rng(1)
    s = _qpsk(rng, (3, 4096))
    y = s + _cn(rng, (3, 4096), 0.3)
    _close(tsn.snr_m2m4(torch.from_numpy(y), kurtosis),
           jsn.snr_m2m4(jnp.asarray(y), kurtosis))
    _close(tsn.evm(torch.from_numpy(y), torch.from_numpy(s)),
           jsn.evm(jnp.asarray(y), jnp.asarray(s)))
    with pytest.raises(ValueError, match="identifiable"):
        tsn.snr_m2m4(torch.from_numpy(y), 2.0)


@pytest.mark.parametrize("n", [1023, 1024])
@pytest.mark.parametrize("averages", [0, 1, 8])
def test_noise_floor_equals_jax_on_odd_and_even_counts(n, averages):
    rng = np.random.default_rng(2)
    psd = rng.exponential(1.0, (2, n))
    _close(tsn.noise_floor(torch.from_numpy(psd), averages),
           jsn.noise_floor(jnp.asarray(psd), averages), rtol=1e-14)


@pytest.mark.parametrize("guard", [1, 2])
def test_tone_snr_equals_jax(guard):
    rng = np.random.default_rng(3)
    t = np.arange(2048)
    for f0 in (0.1, -0.3):
        x = np.exp(2j * np.pi * f0 * t) + _cn(rng, 2048, 0.5)
        snr, f = tsn.tone_snr(torch.from_numpy(x), guard)
        snr_j, f_j = jsn.tone_snr(jnp.asarray(x), guard)
        _close(snr, snr_j)
        _close(f, f_j, rtol=0)


# --------------------------------------------------------------- estimate

@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_tone_estimators_equal_jax(dtype):
    rng = np.random.default_rng(4)
    n = 1024
    t = np.arange(n)
    x = (0.8 * np.exp(1j * (2 * np.pi * 0.1234 * t + 0.7))
         + _cn(rng, n, 0.1)).astype(dtype)
    tol = 1e-9 if dtype == np.complex128 else 1e-6
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    _close(tes.tone_freq_kay(xt), jes.tone_freq_kay(xj), tol, tol)
    f = tes.tone_freq_fft(xt)
    assert abs(float(f) - 0.1234) < 1e-4
    if dtype == np.complex64:
        # JAX's Newton scan carries a float32 f that a complex128 x widens
        # (its scan then raises): compared on complex64 only
        _close(f, jes.tone_freq_fft(xj), tol, tol)
    _close(tes.tone_phase(xt, 0.1234), jes.tone_phase(xj, 0.1234), tol, tol)
    _close(tes.tone_amplitude(xt, 0.1234), jes.tone_amplitude(xj, 0.1234),
           tol, tol)


@pytest.mark.parametrize("cplx", [False, True])
def test_gcc_phat_equals_jax(cplx):
    rng = np.random.default_rng(5)
    n = 4096
    s = _cn(rng, n + 64) if cplx else rng.standard_normal(n + 64)
    s = sps.lfilter(np.ones(4) / 4, [1.0], s)
    x, y = s[32:32 + n], s[32 - 7:32 - 7 + n]            # y lags x by 7
    tau, c = tes.tdoa_gcc_phat(torch.from_numpy(x), torch.from_numpy(y), 20)
    tau_j, c_j = jes.tdoa_gcc_phat(jnp.asarray(x), jnp.asarray(y), 20)
    _close(c, c_j, 1e-9, 1e-12)
    _close(tau, tau_j, 1e-9)
    assert abs(float(tau) - 7.0) < 0.5


# ------------------------------------------------------------------ cyclo

def _bpsk(rng, n, sps_, amp=0.5):
    sym = 1.0 - 2.0 * rng.integers(0, 2, n // sps_)
    return np.repeat(sym, sps_) + amp * _cn(rng, n)


@pytest.mark.parametrize("coherent_frames", [None, 4])
@pytest.mark.parametrize("conjugate", [False, True])
def test_cyclic_spectrum_equals_jax(coherent_frames, conjugate):
    rng = np.random.default_rng(6)
    x = _bpsk(rng, 1 << 13, 8)
    alphas = np.array([0.0, 0.125, 0.25, 0.3], np.float32)
    got = tcy.cyclic_spectrum(torch.from_numpy(x), alphas, 128, 32,
                              conjugate=conjugate,
                              coherent_frames=coherent_frames)
    ref = jcy.cyclic_spectrum(jnp.asarray(x), alphas, 128, 32,
                              conjugate=conjugate,
                              coherent_frames=coherent_frames)
    for g, r in zip(got, ref):
        _close(g, r, 1e-9, 1e-12)
    _close(tcy.cycle_profile(torch.from_numpy(x), alphas, 128, 32),
           jcy.cycle_profile(jnp.asarray(x), alphas, 128, 32), 1e-9)


def test_cycle_profile_complex64_and_real_input():
    rng = np.random.default_rng(7)
    x = _bpsk(rng, 1 << 13, 8).astype(np.complex64)
    alphas = np.linspace(0.05, 0.3, 16).astype(np.float32)
    got = tcy.cycle_profile(torch.from_numpy(x), alphas)
    ref = np.asarray(jcy.cycle_profile(jnp.asarray(x), alphas))
    assert got.dtype == torch.float32
    _close(got, ref, 0, 1e-4)
    xr = x.real.copy()
    _close(tcy.cycle_profile(torch.from_numpy(xr), alphas),
           jcy.cycle_profile(jnp.asarray(xr), alphas), 0, 1e-4)


def test_detector_and_symbol_rate_search_equal_jax():
    rng = np.random.default_rng(8)
    x = _bpsk(rng, 1 << 14, 8, 0.7).astype(np.complex64)
    r = tcy.estimate_symbol_rate(torch.from_numpy(x), 0.05, 0.3)
    rj = jcy.estimate_symbol_rate(jnp.asarray(x), 0.05, 0.3)
    assert r["alpha_coarse"] == rj["alpha_coarse"]
    assert r["alpha_hat"] == rj["alpha_hat"]
    assert abs(r["alpha_hat"] - 0.125) < 2e-4
    np.testing.assert_array_equal(r["detected"], rj["detected"])
    _close(r["profile"], rj["profile"], 0, 1e-4)
    alphas = np.linspace(0.03, 0.4, 48).astype(np.float32)
    d = tcy.detect_cyclic_features(torch.from_numpy(x), alphas)
    dj = jcy.detect_cyclic_features(jnp.asarray(x), alphas)
    np.testing.assert_array_equal(d["detected"], dj["detected"])
    assert d["threshold"] == pytest.approx(dj["threshold"], rel=1e-4)
    with pytest.raises(ValueError, match="narrower"):
        tcy.estimate_symbol_rate(torch.from_numpy(x), 0.1, 0.1001)


# ----------------------------------------------------------- measurements

def _tone_plus(n, rng):
    t = np.arange(n)
    return (np.exp(2j * np.pi * 0.12 * t) + 0.01 * np.exp(
        2j * np.pi * 0.31 * t) + _cn(rng, n, 1e-4))


def test_channel_power_acpr_obw_equal_jax():
    rng = np.random.default_rng(9)
    w = _cn(rng, 1 << 15)
    x = sps.lfilter(sps.firwin(129, 0.2), [1.0], w) + 1e-3 * _cn(rng, 1 << 15)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    _close(tme.channel_power(xt, 1.0), jme.channel_power(xj, 1.0))
    _close(tme.channel_power(xt, 2.0, 0.1, 0.3, nfft=512),
           jme.channel_power(xj, 2.0, 0.1, 0.3, nfft=512))
    a, aj = tme.acpr(xt, 1.0, 0.2, n_adjacent=2), jme.acpr(xj, 1.0, 0.2,
                                                           n_adjacent=2)
    assert a["main_power"] == pytest.approx(aj["main_power"], rel=1e-9)
    for key in ("lower_db", "upper_db", "offsets"):
        _close(a[key], aj[key], 1e-9)
    assert (tme.occupied_bandwidth(xt, 1.0)
            == jme.occupied_bandwidth(xj, 1.0))
    with pytest.raises(ValueError, match="Nyquist"):
        tme.acpr(xt, 1.0, 0.3, n_adjacent=2)
    with pytest.raises(ValueError, match="fraction"):
        tme.occupied_bandwidth(xt, 1.0, 1.0)


def test_papr_sinad_enob_sfdr_equal_jax():
    rng = np.random.default_rng(10)
    x = _cn(rng, 1 << 14)
    th = [0.0, 3.0, 6.0, 9.0]
    _close(tme.papr_ccdf(torch.from_numpy(x), th),
           jme.papr_ccdf(jnp.asarray(x), th), 1e-12)
    n = 1 << 15
    t = np.arange(n)
    real = np.sin(2 * np.pi * 1201.7 / n * t)
    q = np.round(real * 127) / 127
    z = _tone_plus(n, rng)
    for sig in (q, z):
        st, sj = torch.from_numpy(sig), jnp.asarray(sig)
        assert tme.sinad_db(st) == pytest.approx(jme.sinad_db(sj), rel=1e-9)
        assert tme.enob(st) == pytest.approx(jme.enob(sj), rel=1e-9)
        assert tme.sfdr_db(st) == pytest.approx(jme.sfdr_db(sj), rel=1e-9)
    assert abs(tme.sfdr_db(torch.from_numpy(z)) - 40.0) < 1.5


def test_package_exports():
    for mod in (tsn, tes, tcy, tme):
        for name in mod.__all__:
            assert getattr(analysis, name) is getattr(mod, name)
