"""The port's IIR design (design/iirdes.py, design/polymath.py) and the
helpers it copied (design/specialfn.py::csqrt, design/firdes.py's length
estimates, models/channel.py::host_wrapped_phase) vs the JAX package's, on
the host.

Tolerance: every design output within 1e-12 (absolute, on second-order
sections normalized to a0 = 1 and on zeros, poles and gains; both sides run
the same float64 arithmetic); estimates and helpers equal.
"""

import numpy as np
import pytest

from solid_dsp_tpu.design import firdes as jfirdes
from solid_dsp_tpu.design import iirdes as jiirdes
from solid_dsp_tpu.design import polymath as jpoly
from solid_dsp_tpu.design import specialfn as jspecial
from solid_dsp_tpu.models import channel as jchannel
from solid_dsp_tpu_torch.design import firdes, iirdes, polymath, specialfn
from solid_dsp_tpu_torch.models import channel

ATOL = 1e-12
DESIGNS = ("butterworth", "chebyshev1", "chebyshev2", "elliptic")


@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize("order", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("bt,fc", [("lowpass", 0.1), ("highpass", 0.22)])
def test_iirdes_sos_single_band_matches_jax(design, order, bt, fc):
    got = iirdes.iirdes_sos(design, order, fc, bandtype=bt)
    want = jiirdes.iirdes_sos(design, order, fc, bandtype=bt)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize("bt", ["bandpass", "bandstop"])
@pytest.mark.parametrize("order", [2, 4])
def test_iirdes_sos_band_matches_jax(design, bt, order):
    got = iirdes.iirdes_sos(design, order, 0.1, 0.2, bandtype=bt,
                            ripple_db=0.5, stopband_db=50.0)
    want = jiirdes.iirdes_sos(design, order, 0.1, 0.2, bandtype=bt,
                              ripple_db=0.5, stopband_db=50.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("fn", ["butterworth_zpk", "chebyshev1_zpk",
                                "chebyshev2_zpk", "elliptic_zpk"])
@pytest.mark.parametrize("order", [1, 4, 7])
def test_prototypes_and_zpk_to_sos_match_jax(fn, order):
    z, p, k = getattr(iirdes, fn)(order)
    jz, jp, jk = getattr(jiirdes, fn)(order)
    np.testing.assert_allclose(z, jz, rtol=0, atol=ATOL)
    np.testing.assert_allclose(p, jp, rtol=0, atol=ATOL)
    assert abs(k - jk) <= ATOL * max(1.0, abs(jk))
    zd, pd, kd = iirdes._bilinear_zpk(*iirdes._lp2lp_zpk(z, p, k, 0.3))
    np.testing.assert_allclose(iirdes.zpk_to_sos(zd, pd, kd),
                               jiirdes.zpk_to_sos(zd, pd, kd), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("fn", ["pll_active_lag",
                                "pll_active_proportional_integral"])
@pytest.mark.parametrize("bw,zeta,gain", [(0.02, 1 / np.sqrt(2), 1000.0),
                                          (0.05, 0.9, 500.0),
                                          (0.1, 0.5, 10.0)])
def test_pll_loop_filters_match_jax(fn, bw, zeta, gain):
    num, den = getattr(iirdes, fn)(bw, zeta, gain)
    jnum, jden = getattr(jiirdes, fn)(bw, zeta, gain)
    np.testing.assert_allclose(num, jnum, rtol=0, atol=ATOL)
    np.testing.assert_allclose(den, jden, rtol=0, atol=ATOL)


def test_pll_golden_stores():
    """The values the reference's sos.rs:118-155 doctest reads (through
    the swapped stores): a[2] / a[0] and b[1] / a[0]."""
    num, den = iirdes.pll_active_lag(0.02, 1.0 / np.sqrt(2.0), 1000.0)
    assert abs(den[2] / den[0] - 0.99999840000128) < 1e-14
    assert abs(num[1] / den[0] - 0.003199997440002048) < 1e-15


@pytest.mark.parametrize("bt", ["lowpass", "highpass", "bandpass",
                                "bandstop"])
def test_bilinear_helpers_match_jax(bt):
    assert iirdes.frequency_pre_warp(0.1, 0.2, bt) == \
        jiirdes.frequency_pre_warp(0.1, 0.2, bt)
    az = np.array([0.5 + 0.1j, -0.2])
    ap = np.array([-0.3 + 0.4j, -0.3 - 0.4j])
    got = iirdes.bilinear_analog_to_digital(az, ap, 2.0, 0.7)
    want = jiirdes.bilinear_analog_to_digital(az, ap, 2.0, 0.7)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
    zp = iirdes.bilinear_numerator_denominator([1.0, 2.0], [1.0, 3.0, 2.0],
                                               0.5)
    jzp = jiirdes.bilinear_numerator_denominator([1.0, 2.0], [1.0, 3.0, 2.0],
                                                 0.5)
    np.testing.assert_allclose(zp.zeros, jzp.zeros, atol=ATOL)
    np.testing.assert_allclose(zp.poles, jzp.poles, atol=ATOL)
    fl = iirdes.digital_filter_flip_pass(az, ap)
    np.testing.assert_array_equal(fl.zeros, -az)
    sh = iirdes.digital_filter_shift(az, ap, 0.1)
    jsh = jiirdes.digital_filter_shift(az, ap, 0.1)
    np.testing.assert_allclose(sh.poles, jsh.poles, atol=ATOL)


@pytest.mark.parametrize("design", DESIGNS)
def test_stable_and_sos_to_iir_coeffs_match_jax(design):
    sos = iirdes.iirdes_sos(design, 5, 0.12)
    for row in sos:
        assert iirdes.stable(row[:3], row[3:]) == jiirdes.stable(row[:3],
                                                                 row[3:])
        assert iirdes.stable(row[:3], row[3:])
    ff, fb = iirdes.sos_to_iir_coeffs(sos)
    jff, jfb = jiirdes.sos_to_iir_coeffs(sos)
    np.testing.assert_array_equal(ff, jff)
    np.testing.assert_array_equal(fb, jfb)
    assert not iirdes.stable([1.0, 0.0, 0.0], [1.0, -2.5, 1.0])


@pytest.mark.parametrize("poly", [[6.0, -5.0, 1.0], [1.0, 0.0, 1.0],
                                  [-6.0, 11.0, -6.0, 1.0],
                                  [1.0, 2.0, 3.0, 4.0, 5.0],
                                  [0.5, -1.5, 0.25, 2.0, -1.0, 1.0]])
def test_polymath_roots_match_jax(poly):
    got = polymath.find_roots(poly)
    want = jpoly.find_roots(poly)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(np.sort_complex(got),
                               np.sort_complex(np.roots(poly[::-1])),
                               atol=1e-8)


@pytest.mark.parametrize("m,k", [(0, 0), (3, 0), (4, 2), (1, 5)])
def test_binomials_match_jax(m, k):
    np.testing.assert_array_equal(polymath.expand_binomial(m),
                                  jpoly.expand_binomial(m))
    np.testing.assert_array_equal(polymath.expand_binomial_pm(m, k),
                                  jpoly.expand_binomial_pm(m, k))


def test_polynomial_errors():
    with pytest.raises(polymath.PolynomialError):
        polymath.find_roots_bairstow([])
    with pytest.raises(ValueError):
        iirdes.iirdes_sos("bessel", 4, 0.1)
    with pytest.raises(ValueError, match="band design"):
        iirdes.iirdes_sos("butterworth", 4, 0.2, 0.1, bandtype="bandpass")


@pytest.mark.parametrize("a", [0.0, 4.0, -4.0, 2.5, -0.3, np.inf, -np.inf])
def test_csqrt_matches_jax(a):
    assert specialfn.csqrt(a) == jspecial.csqrt(a)


@pytest.mark.parametrize("method", ["kaiser", "herrmann"])
@pytest.mark.parametrize("tb,att", [(0.05, 60.0), (0.2, 40.0),
                                    (0.01, 110.0)])
def test_length_estimates_match_jax(method, tb, att):
    assert firdes.estimate_required_filter_length(tb, att, method) == \
        jfirdes.estimate_required_filter_length(tb, att, method)
    assert firdes.estimate_required_filter_stop_band_attenuation(
        tb, 64, method) == jfirdes.estimate_required_filter_stop_band_attenuation(
        tb, 64, method)
    assert firdes.estimate_required_filter_transition(att, 64, method) == \
        jfirdes.estimate_required_filter_transition(att, 64, method)


def test_length_estimate_validation():
    with pytest.raises(ValueError):
        firdes.estimate_required_filter_length(0.6, 60.0)
    with pytest.raises(ValueError):
        firdes.estimate_required_filter_length(0.1, -1.0)


@pytest.mark.parametrize("n,f,ph", [(1000, 19000 / 192000, 0.0),
                                    (4097, 0.3, 0.5), (10, 1.7, -1.0)])
def test_host_wrapped_phase_matches_jax(n, f, ph):
    np.testing.assert_array_equal(channel.host_wrapped_phase(n, f, ph),
                                  jchannel.host_wrapped_phase(n, f, ph))
