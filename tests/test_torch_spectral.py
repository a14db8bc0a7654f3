"""Port vs JAX package: analysis/ (spectral estimation, group delay,
frequency response).

The same inputs, made with numpy from a seed, go through both packages.
Gates: every spectral function within rtol 1e-9 of JAX's at complex128 /
float64 (functions whose JAX rule computes in complex64 for such inputs --
cepstrum and analytic_signal of complex input -- within 1e-5); istft
reconstructs to tests/test_spectral.py's tolerances and stft_denoise meets
that file's quality gates and matches JAX's output to 1e-9 of its peak; group
delay and frequency response equal to JAX's (the same float64 numpy), with
BASELINE.md section B's group-delay constants.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.analysis import freq_response as jfreq
from solid_dsp_tpu.analysis import group_delay as jgd
from solid_dsp_tpu.analysis import spectral as jsp
from solid_dsp_tpu.design import firdes as jfirdes
from solid_dsp_tpu.design import iirdes
from solid_dsp_tpu.ops import fir as jfir
from solid_dsp_tpu.ops import iir as jiir
from solid_dsp_tpu_torch import analysis
from solid_dsp_tpu_torch.analysis import spectral as sp


def _sig(n, seed, complex_=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n)
    if complex_:
        x = x + 1j * rng.standard_normal(n)
    return x


def _close(got, ref, rtol=1e-9):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, (
        got.shape, ref.shape, got.dtype, ref.dtype)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


def _both(fn_name, *arrays, **kw):
    got = getattr(sp, fn_name)(*(torch.from_numpy(a) for a in arrays), **kw)
    ref = getattr(jsp, fn_name)(*(jnp.asarray(a) for a in arrays), **kw)
    return got.numpy(), np.asarray(ref)


@pytest.mark.parametrize("nfft,hop", [(256, 64), (128, 128), (64, 16)])
def test_frame_signal_is_jax_framing(nfft, hop):
    x = _sig(2000, 1)
    got, ref = _both("frame_signal", x, nfft=nfft, hop=hop)
    np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="divide"):
        sp.frame_signal(torch.from_numpy(x), 256, 60)
    with pytest.raises(ValueError, match="signal length"):
        sp.frame_signal(torch.from_numpy(x[:100]), 256, 64)


@pytest.mark.parametrize("window", ["hann", "hamming", "rect",
                                    "blackman_harris"])
@pytest.mark.parametrize("complex_", [True, False])
def test_stft_and_spectrogram_match_jax(window, complex_):
    x = _sig(4000, 2, complex_)
    _close(*_both("stft", x, nfft=256, hop=64, window=window))
    _close(*_both("stft", x, nfft=256, hop=128, window=window, pad_to=512))
    _close(*_both("spectrogram", x, nfft=256, hop=64, window=window))


@pytest.mark.parametrize("onesided,pad_to,complex_", [
    (False, None, True), (False, 2048, True), (True, None, False),
    (False, None, False)])
def test_welch_psd_matches_jax(onesided, pad_to, complex_):
    x = _sig(1 << 14, 3, complex_)
    _close(*_both("welch_psd", x, nfft=1024, hop=512, fs=2.0,
                  onesided=onesided, pad_to=pad_to))


def test_csd_and_coherence_match_jax():
    x = _sig(1 << 14, 4)
    y = np.convolve(x, [0.5, 0.3, -0.2], mode="same") + 0.1 * _sig(1 << 14, 5)
    _close(*_both("csd", x, y, nfft=512, hop=256, fs=3.0))
    _close(*_both("coherence", x, y, nfft=512, hop=256))
    p1 = sp.welch_psd(torch.from_numpy(x), 512, 256).numpy()
    p2 = sp.csd(torch.from_numpy(x), torch.from_numpy(x), 512, 256).numpy()
    np.testing.assert_allclose(p2.real, p1, rtol=1e-12)


@pytest.mark.parametrize("kind", ["real", "power"])
@pytest.mark.parametrize("complex_", [False, True])
def test_cepstrum_matches_jax(kind, complex_):
    """float64 input computes in complex128; complex128 input, by the JAX
    package's rule, in complex64 (1e-5)."""
    x = _sig(1024, 6, complex_)
    got, ref = _both("cepstrum", x, kind=kind)
    _close(got, ref, rtol=1e-5 if complex_ else 1e-9)
    with pytest.raises(ValueError):
        sp.cepstrum(torch.from_numpy(x), kind="complex")


@pytest.mark.parametrize("n", [1000, 1001])
def test_analytic_signal_envelope_and_frequency_match_jax(n):
    x = _sig(n, 7, complex_=False)
    _close(*_both("analytic_signal", x))
    _close(*_both("envelope", x))
    _close(*_both("instantaneous_frequency", x))
    xc = _sig(n, 8)
    _close(*_both("instantaneous_frequency", xc))
    got, ref = _both("analytic_signal", xc)
    _close(got, ref, rtol=1e-5)


def test_goertzel_bank_matches_jax():
    x = _sig(4096, 9)
    freqs = (0.01, 0.1234, 0.25, -0.3)
    got = sp.goertzel_bank(torch.from_numpy(x), freqs, 256).numpy()
    ref = np.asarray(jsp.goertzel_bank(jnp.asarray(x), freqs, 256))
    _close(got, ref)
    x32 = x.astype(np.complex64)
    got = sp.goertzel_bank(torch.from_numpy(x32), freqs, 256).numpy()
    ref = np.asarray(jsp.goertzel_bank(jnp.asarray(x32), freqs, 256))
    _close(got, ref, rtol=1e-5)


@pytest.mark.parametrize("window,nfft,hop", [("hamming", 256, 64),
                                             ("hann", 512, 128)])
def test_istft_reconstructs_and_matches_jax(window, nfft, hop):
    """istft(stft(x)) against x as tests/test_spectral.py holds it (1e-12
    with hamming; 1e-9 with hann, its zero end points excepted) and 1e-9
    against JAX's istft; batched with a length; the padded STFT inverts
    too."""
    x = _sig(4000, 10)
    S = sp.stft(torch.from_numpy(x), nfft, hop, window)
    xr = sp.istft(S, nfft, hop, window).numpy()
    u = (S.shape[0] - 1) * hop + nfft
    d = np.abs(xr - x[:u])
    tol = 1e-12 if window == "hamming" else 1e-9
    assert set(np.where(d > tol)[0]) <= {0, u - 1}
    ref = np.asarray(jsp.istft(jnp.asarray(S.numpy()), nfft, hop, window))
    _close(xr, ref)
    xb = _sig(2 * 2000, 11, complex_=False).reshape(2, 2000)
    Sb = sp.stft(torch.from_numpy(xb), 256, 128, "hamming")
    xrb = sp.istft(Sb, 256, 128, "hamming", length=1000).numpy()
    assert xrb.shape == (2, 1000)
    np.testing.assert_allclose(xrb, xb[:, :1000], atol=1e-12)
    Sp = sp.stft(torch.from_numpy(x), 256, 64, "hamming", pad_to=512)
    xp = sp.istft(Sp, 256, 64, "hamming").numpy()
    np.testing.assert_allclose(xp, x[:xp.shape[0]], atol=1e-10)


@pytest.mark.parametrize("rule", ["wiener", "subtract"])
def test_stft_denoise_matches_jax_and_improves_snr(rule):
    """Blind noise PSD (20th percentile): the port's output within 1e-9 of
    JAX's peak; the bursty tone's SNR up by > 2 dB with no edge spikes
    (tests/test_spectral.py)."""
    rng = np.random.default_rng(3)
    n = 32000
    k = np.arange(n)
    sig = ((k // 2000) % 3 == 0) * np.exp(2j * np.pi * 0.1 * k)
    x = sig + 0.3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    y = sp.stft_denoise(torch.from_numpy(x), 512, 128, rule=rule).numpy()
    ref = np.asarray(jsp.stft_denoise(jnp.asarray(x), 512, 128, rule=rule))
    _close(y, ref)

    def osnr(v):
        a = np.vdot(sig, v) / np.vdot(sig, sig).real
        e = v - a * sig
        return 10 * np.log10(np.abs(a) ** 2 * np.vdot(sig, sig).real
                             / np.vdot(e, e).real)

    assert osnr(y) > osnr(x) + 2.0 and np.abs(y).max() < 3.0


def test_stft_denoise_known_psd_real_input_and_errors():
    """A given noise PSD and a real ragged-length input match JAX's; bad
    rule and short input raise."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal(3001)
    npsd = np.abs(np.fft.fft(rng.standard_normal(256))) ** 2
    y = sp.stft_denoise(torch.from_numpy(x), 256, 64,
                        noise_psd=torch.from_numpy(npsd)).numpy()
    ref = np.asarray(jsp.stft_denoise(jnp.asarray(x), 256, 64,
                                      noise_psd=jnp.asarray(npsd)))
    assert y.shape == (3001,) and y.dtype == np.float64
    _close(y, ref)
    with pytest.raises(ValueError):
        sp.stft_denoise(torch.from_numpy(x), 256, 64, rule="bogus")
    with pytest.raises(ValueError):
        sp.stft_denoise(torch.from_numpy(x[:100]), 256, 64)


def test_percentile_is_linear_interpolation():
    """The sort-based 20th percentile equals numpy's (and torch.quantile's)
    linear interpolation."""
    P = np.random.default_rng(12).random((37, 5))
    got = sp._percentile(torch.from_numpy(P), 20.0, dim=0).numpy()
    np.testing.assert_allclose(got, np.percentile(P, 20.0, axis=0),
                               rtol=1e-14)


def test_group_delay_matches_jax_and_baseline_constants():
    """fir/iir group delay equal to JAX's; BASELINE.md section B: the PLL
    biquad cascade 19.6774211296624 and one section 17.6774211296624 at
    f = 0 (the reference's +2 per section), the 12-semi-length notch
    rounds to 12."""
    num, den = iirdes.pll_active_lag(0.02, 1.0 / np.sqrt(2.0), 1000.0)
    sos = jiir.SecondOrderFilter(num, den)
    b, a = sos.numerator_coefs(), sos.denominator_coefs()
    one = analysis.iir_group_delay(b, a, 0.0) + 2.0
    assert abs(one - 17.6774211296624) < 1e-10
    cascade = jiir.IIRFilter(num, den, jiir.IIRFilterType.SECOND_ORDER)
    total = sum(analysis.iir_group_delay(s.numerator_coefs(),
                                         s.denominator_coefs(), 0.0) + 4.0
                for s in cascade._sections)
    assert abs(total - 19.6774211296624) < 1e-10
    notch = jfir.FIRFilter(jfirdes.firdes_notch(12, 0.35, 120.0), 1.0)
    assert int(analysis.fir_group_delay(notch.coefficients(), 0.0)
               + 0.5) == 12
    rng = np.random.default_rng(13)
    h = rng.standard_normal(31)
    f = np.linspace(-0.5, 0.5, 41)
    for fr in (0.0, 0.1, -0.37):
        assert analysis.fir_group_delay(h, fr) == jgd.fir_group_delay(h, fr)
        assert analysis.iir_group_delay(h[:5], [1.0, -0.5, 0.1], fr) == \
            jgd.iir_group_delay(h[:5], [1.0, -0.5, 0.1], fr)
    np.testing.assert_array_equal(analysis.fir_group_delay_band(h, f),
                                  jgd.fir_group_delay_band(h, f))
    for fn in (analysis.fir_group_delay, jgd.fir_group_delay):
        with pytest.raises(ValueError):
            fn(h, 0.6)
    with pytest.raises(ZeroDivisionError):
        analysis.iir_group_delay([0.0], [1.0], 0.0)


def test_frequency_response_matches_jax():
    rng = np.random.default_rng(14)
    h = rng.standard_normal(17) + 1j * rng.standard_normal(17)
    b, a = rng.standard_normal(3), np.array([1.0, -0.4, 0.2])
    f = np.linspace(-0.5, 0.5, 33)
    for fr in (0.0, 0.2, -0.45):
        assert analysis.fir_frequency_response(h, fr, 2.0) == \
            jfreq.fir_frequency_response(h, fr, 2.0)
        assert analysis.iir_frequency_response(b, a, fr) == \
            jfreq.iir_frequency_response(b, a, fr)
    np.testing.assert_array_equal(analysis.frequency_response_band(h, f, 0.5),
                                  jfreq.frequency_response_band(h, f, 0.5))
    np.testing.assert_array_equal(analysis.iir_frequency_response_band(b, a,
                                                                       f),
                                  jfreq.iir_frequency_response_band(b, a, f))
