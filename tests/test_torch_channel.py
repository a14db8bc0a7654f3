"""Port vs JAX package: models/channel.py and models/ber.py on the CPU.

The port draws its noise from a ``torch.Generator`` where JAX takes a key,
so the draws differ; the gates hold the deterministic parts exactly (or to
float32 rounding) and the draws' statistics:

* ``ebn0_to_noise_var``, ``qfunc``, ``ber_theory``, ``tdl_taps``: equal to
  JAX's (rtol 1e-12); ``apply_cfo`` within 1e-5 of JAX's (float32
  rotation of unit-scale samples) and ``multipath_apply`` within 1e-5 of
  max|y| of JAX's and numpy's convolution;
* ``awgn``: the noise variance from ``snr_db`` equal to JAX's rule, the
  measured noise power within 2% of it at 2^18 samples (its standard error
  is 0.28%), each quadrature holding half;
* ``phase_noise``: the increments' RMS within 2% of the linewidth;
* ``rayleigh_doppler_fading``: unit power (1e-4), no spectral energy
  outside the Doppler support |f| < doppler (below 1e-9 of the total, the
  complex64 rounding: the shaping zeroes those bins before the one inverse
  FFT);
* ``tdl_fading_channel``: y equal to the sum of the delayed, gain-weighted
  inputs (1e-5), each tap's power within 25% of its profile's (2^14
  samples of a slow fade);
* ``ber_sweep``: at each point within the binomial 99.9% interval of
  ``ber_theory`` (tests/test_ber.py's grid) and of JAX's own estimate;
  ``link_sim``: BER and BLER within the binomial 99.9% intervals of JAX's.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.models import ber as jber
from solid_dsp_tpu.models import channel as jch
from solid_dsp_tpu.models.block_codes import BlockCode as JBlockCode
from solid_dsp_tpu_torch.models import ber as tber
from solid_dsp_tpu_torch.models import channel as tch
from solid_dsp_tpu_torch.models.block_codes import BlockCode

CPU = "cpu"
Z = 3.29                 # two-sided 99.9% normal quantile


def _gen(seed):
    return torch.Generator(device=CPU).manual_seed(seed)


def _np(t):
    return t.detach().cpu().numpy()


def _binomial_ok(p_hat, p, n):
    """p_hat within the 99.9% normal interval of a binomial(n, p) mean."""
    return abs(p_hat - p) <= Z * math.sqrt(max(p * (1 - p), 1e-12) / n) \
        + 1.0 / n


def test_theory_and_taps_equal_jax():
    grid = np.array([-2.0, 0.0, 3.0, 7.5, 12.0])
    np.testing.assert_allclose(tch.qfunc(grid / 3), jch.qfunc(grid / 3),
                               rtol=1e-12)
    for scheme, m in (("psk", 2), ("psk", 4), ("psk", 8), ("qam", 16),
                      ("qam", 64)):
        np.testing.assert_allclose(tch.ber_theory(scheme, m, grid),
                                   jch.ber_theory(scheme, m, grid),
                                   rtol=1e-12)
    with pytest.raises(ValueError):
        tch.ber_theory("qam", 8, 3.0)
    for e in (0.0, 4.0, 9.5):
        assert tch.ebn0_to_noise_var(e, 2, 0.5) == jch.ebn0_to_noise_var(
            e, 2, 0.5)
    assert tch.TDL_PROFILES == jch.TDL_PROFILES
    for prof in ("epa", "eva", "etu", ((0, 0.0), (25, -3.0), (26, -3.0))):
        for a, b in zip(tch.tdl_taps(prof, 30.72e6),
                        jch.tdl_taps(prof, 30.72e6)):
            np.testing.assert_allclose(a, b, rtol=1e-12)
    with pytest.raises(ValueError):
        tch.tdl_taps("nope", 1e6)


def test_awgn_variance_and_statistics():
    n = 1 << 18
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64) * 0.7
    xt = torch.from_numpy(x)
    y = tch.awgn(_gen(1), xt, snr_db=10.0)
    p = float(np.mean(np.abs(x) ** 2))
    nv = p / 10.0                        # JAX's rule: p / 10^(snr / 10)
    noise = _np(y) - x
    assert abs(np.mean(np.abs(noise) ** 2) / nv - 1) < 0.02
    assert abs(np.mean(noise.real ** 2) / (nv / 2) - 1) < 0.02
    jy = np.asarray(jch.awgn(jax.random.PRNGKey(1), jnp.asarray(x),
                             snr_db=10.0))
    assert abs(np.mean(np.abs(jy - x) ** 2) / nv - 1) < 0.02
    y2 = tch.awgn(_gen(2), xt, noise_var=0.3)
    assert y2.dtype == torch.complex64
    assert abs(np.mean(np.abs(_np(y2) - x) ** 2) / 0.3 - 1) < 0.02
    with pytest.raises(ValueError):
        tch.awgn(_gen(1), xt)
    with pytest.raises(ValueError, match="Generator"):
        tch.awgn(None, xt, snr_db=3.0)


def test_cfo_multipath_equal_jax():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(5000) + 1j * rng.standard_normal(5000)).astype(
        np.complex64)
    for f in (0.013, -0.2, 3.25):
        np.testing.assert_allclose(
            _np(tch.apply_cfo(torch.from_numpy(x), f, 0.3)),
            np.asarray(jch.apply_cfo(jnp.asarray(x), f, 0.3)), atol=1e-5)
    got = _np(tch.apply_cfo(torch.from_numpy(x), torch.tensor(0.013)))
    want = x * np.exp(2j * np.pi * 0.013 * np.arange(5000))
    np.testing.assert_allclose(got, want, atol=2e-3)
    h = np.array([1.0, 0.4 - 0.2j, 0.1j, -0.05], np.complex64)
    y = _np(tch.multipath_apply(torch.from_numpy(x), h))
    want = np.convolve(x, h)[: len(x)]
    np.testing.assert_allclose(y, want, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(
        y, np.asarray(jch.multipath_apply(jnp.asarray(x), h)),
        atol=1e-5 * np.abs(want).max())


def test_phase_noise_and_fading_statistics():
    n = 1 << 16
    x = torch.ones(n, dtype=torch.complex64)
    y = _np(tch.phase_noise(_gen(4), x, 1e-3))
    assert np.allclose(np.abs(y), 1.0, atol=1e-5)
    dphi = np.diff(np.unwrap(np.angle(y)))
    assert abs(np.std(dphi) / (2 * np.pi * 1e-3) - 1) < 0.02
    g = tch.rayleigh_doppler_fading(_gen(5), n, 0.01)
    assert g.dtype == torch.complex64 and g.shape == (n,)
    gn = _np(g).astype(np.complex128)
    assert abs(np.mean(np.abs(gn) ** 2) - 1) < 1e-4
    spec = np.abs(np.fft.fft(gn)) ** 2
    outside = np.abs(np.fft.fftfreq(n)) >= 0.01
    assert spec[outside].sum() / spec.sum() < 1e-9
    with pytest.raises(ValueError):
        tch.rayleigh_doppler_fading(_gen(5), 64, 0.6)
    x = torch.from_numpy(np.exp(2j * np.pi * 0.01 * np.arange(1 << 14))
                         ).to(torch.complex64)
    y, h = tch.tdl_fading_channel(_gen(6), x, "epa", 30.72e6, 1e-3)
    delays, _ = tch.tdl_taps("epa", 30.72e6)
    assert h.shape == (len(delays), 1 << 14)
    want = sum(_np(h)[i] * np.concatenate(
        [np.zeros(d, np.complex64), _np(x)[: len(x) - d]])
        for i, d in enumerate(delays))
    np.testing.assert_allclose(_np(y), want, atol=1e-5)
    _, amps = tch.tdl_taps("epa", 30.72e6)
    pw = np.mean(np.abs(_np(h)) ** 2, axis=-1)
    np.testing.assert_allclose(pw, amps ** 2, rtol=0.25)
    with pytest.raises(ValueError):
        tch.tdl_fading_channel(_gen(6), x[:10], "etu")


def test_ber_sweep_within_binomial_interval_of_theory_and_jax():
    grid = np.array([2.0, 4.0, 6.0])      # tests/test_ber.py's QPSK grid
    n = 400_000
    ber = tber.ber_sweep(grid, "psk", 4, n, seed=3, device=CPU)
    want = tch.ber_theory("psk", 4, grid)
    jb = jber.ber_sweep(grid, "psk", 4, n, seed=3)
    assert ber.shape == (3,) and (np.diff(ber) < 0).all()
    for b, w, j in zip(ber, want, jb):
        assert _binomial_ok(b, w, n), (b, w)
        assert _binomial_ok(b, j, n), (b, j)
    b16 = tber.ber_sweep(8.0, "qam", 16, 300_000, seed=5, device=CPU)
    assert _binomial_ok(b16[0], float(tch.ber_theory("qam", 16, 8.0)),
                        300_000)
    with pytest.raises(ValueError):
        tber.ber_sweep([4.0], m=4, n_bits=1, device=CPU)


def test_link_sim_within_binomial_interval_of_jax():
    code, jcode = BlockCode("g2312", CPU), JBlockCode("g2312")
    kw = dict(n_blocks=1500, scheme="psk", m=2, soft=False, seed=9)
    out = tber.link_sim(lambda d: code.encode(np.asarray(d).reshape(-1)),
                        code.decode, code.k, code.n, [5.0, 7.0], device=CPU,
                        **kw)
    jout = jber.link_sim(lambda d: jcode.encode(np.asarray(d).reshape(-1)),
                         jcode.decode, jcode.k, jcode.n, [5.0, 7.0], **kw)
    nb = out["bits_per_point"]
    assert nb == jout["bits_per_point"] == 1500 * 12
    for i in range(2):
        assert _binomial_ok(out["ber"][i], jout["ber"][i], nb)
        assert _binomial_ok(out["bler"][i], jout["bler"][i], 1500)
    assert out["ber"][1] < 0.5 * float(tch.ber_theory("psk", 2, 7.0))
