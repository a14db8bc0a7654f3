"""Port vs JAX package: ops/quantize.py, ops/trig_transforms.py, ops/czt.py
and ops/wavelet.py.

The same seeded numpy inputs go through both packages on the CPU.  Gates:
the quantizers, the ADC without dither and the companders equal to JAX's
(float64; the 8-bit codes bit-equal and uint8, their decodes equal); the
ADC's subtractive dither held to its contract (error within +-delta/2,
mean ~0, uncorrelated with the input), since a torch.Generator and a JAX
key draw different numbers; DCT/DST 1-4 on both backends and MDCT/IMDCT
within 1e-9 x max of JAX's (tests/test_trig_transforms.py's atol 1e-9), the
route of backend="auto" JAX's; the CZT and zoom FFT within rtol 1e-9 of
JAX's (test_czt.py: 1e-8 to the direct sum); the wavelets within 1e-12 of
JAX's in float64, the denoiser too, and its MAD median the mean of the two
middle values on an even count, as jnp.median's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.ops import czt as jczt
from solid_dsp_tpu.ops import quantize as jq
from solid_dsp_tpu.ops import trig_transforms as jtt
from solid_dsp_tpu.ops import wavelet as jwv
from solid_dsp_tpu_torch.ops import czt as tczt
from solid_dsp_tpu_torch.ops import quantize as tq
from solid_dsp_tpu_torch.ops import trig_transforms as ttt
from solid_dsp_tpu_torch.ops import wavelet as twv


def _sig(shape, seed, cplx=False, scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if cplx:
        x = x + 1j * rng.standard_normal(shape)
    return scale * x


def _close(got, ref, rtol=1e-9, atol_rel=1e-9):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, (
        got.shape, ref.shape, got.dtype, ref.dtype)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=atol_rel * max(np.abs(ref).max(), 1e-300))


# ------------------------------------------------------------- quantize

@pytest.mark.parametrize("mode", ["midrise", "midtread"])
@pytest.mark.parametrize("bits", [1, 3, 12])
def test_quantize_uniform_equals_jax(mode, bits):
    x = _sig(4096, 1, scale=0.7)
    got = tq.quantize_uniform(torch.from_numpy(x), bits, 1.0, mode)
    ref = jq.quantize_uniform(jnp.asarray(x), bits, 1.0, mode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    got32 = tq.quantize_uniform(torch.from_numpy(x.astype(np.float32)), bits)
    ref32 = jq.quantize_uniform(jnp.asarray(x.astype(np.float32)), bits)
    assert got32.dtype == torch.float32
    np.testing.assert_array_equal(got32.numpy(), np.asarray(ref32))


def test_quantize_validation():
    with pytest.raises(ValueError, match="bits"):
        tq.quantize_uniform(torch.zeros(4), 0)
    with pytest.raises(ValueError, match="mode"):
        tq.quantize_uniform(torch.zeros(4), 4, mode="round")


@pytest.mark.parametrize("cplx", [False, True])
def test_adc_model_without_dither_equals_jax(cplx):
    x = _sig(8192, 2, cplx, scale=0.6)
    got = tq.adc_model(torch.from_numpy(x), 10, 1.0)
    ref = jq.adc_model(jnp.asarray(x), 10, 1.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_adc_dither_contract():
    """Subtractive dither inside the rails: the error lies within
    +-delta/2, its mean is ~0, its variance delta^2/12 and it is
    uncorrelated with the input; without a generator it raises."""
    bits, n = 8, 1 << 16
    delta = 2.0 / (1 << bits)
    rng = np.random.default_rng(3)
    x = rng.uniform(-0.9, 0.9, n) + 1j * rng.uniform(-0.9, 0.9, n)
    g = torch.Generator().manual_seed(0)
    y = tq.adc_model(torch.from_numpy(x), bits, 1.0, dither=True, generator=g)
    e = y.numpy() - x
    for part in (e.real, e.imag):
        assert np.abs(part).max() <= delta / 2 * (1 + 1e-9)
        assert abs(part.mean()) < 5 * (delta / np.sqrt(12)) / np.sqrt(n)
        # uniform on +-delta/2: variance delta^2 / 12
        assert abs(part.var() / (delta ** 2 / 12) - 1.0) < 0.05
    rho = np.corrcoef(e.real, x.real)[0, 1]
    assert abs(rho) < 5 / np.sqrt(n)
    with pytest.raises(ValueError, match="Generator"):
        tq.adc_model(torch.from_numpy(x), bits, dither=True)


@pytest.mark.parametrize("name", ["mulaw", "alaw"])
def test_companders_and_codecs_equal_jax(name):
    x = np.concatenate([np.linspace(-1, 1, 4001), _sig(2000, 4, scale=0.3),
                        [0.0, -0.0, 1.0, -1.0, 1e-6, -1e-6]])
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for fn in ("compress", "expand"):
        _close(getattr(tq, f"{name}_{fn}")(xt),
               getattr(jq, f"{name}_{fn}")(xj), rtol=1e-12, atol_rel=1e-14)
    for xs in (x, x.astype(np.float32)):
        code = getattr(tq, f"{name}_encode")(torch.from_numpy(xs))
        code_j = np.asarray(getattr(jq, f"{name}_encode")(jnp.asarray(xs)))
        assert code.dtype == torch.uint8 and code_j.dtype == np.uint8
        np.testing.assert_array_equal(code.numpy(), code_j)
    allc = np.arange(256, dtype=np.uint8)
    dec = getattr(tq, f"{name}_decode")(torch.from_numpy(allc))
    dec_j = np.asarray(getattr(jq, f"{name}_decode")(jnp.asarray(allc)))
    assert dec.dtype == torch.float32
    np.testing.assert_array_equal(dec.numpy(), dec_j)


def test_sqnr_equals_jax():
    x = _sig((3, 4096), 5, True, scale=0.4)
    xq = np.asarray(jq.adc_model(jnp.asarray(x), 8))
    _close(tq.sqnr(torch.from_numpy(x), torch.from_numpy(xq)),
           jq.sqnr(jnp.asarray(x), jnp.asarray(xq)), rtol=1e-12)


# ------------------------------------------------------ trig transforms

@pytest.mark.parametrize("n", [2, 7, 64])
@pytest.mark.parametrize("type_", [1, 2, 3, 4])
@pytest.mark.parametrize("backend", ["auto", "matmul"])
def test_dct_dst_equal_jax(n, type_, backend):
    x = _sig((3, n), 6)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    _close(ttt.dct(xt, type_, backend), jtt.dct(xj, type_, backend))
    _close(ttt.dst(xt, type_, backend), jtt.dst(xj, type_, backend))


def test_trig_routes_and_validation():
    x = torch.from_numpy(_sig((2, 16), 7))
    with pytest.raises(ValueError, match="1..4"):
        ttt.dct(x, 5)
    with pytest.raises(ValueError, match="1..4"):
        ttt.dst(x, 0)
    with pytest.raises(ValueError, match="n >= 2"):
        ttt.dct(x[..., :1], 1)
    with pytest.raises(ValueError, match="even"):
        ttt.mdct(x[..., :15])


def test_mdct_imdct_equal_jax_and_tdac():
    n = 32
    w = ttt.mdct_window(n)
    np.testing.assert_array_equal(w, jtt.mdct_window(n))
    x = _sig(8 * n, 8)
    frames = np.stack([x[i:i + 2 * n] for i in range(0, 6 * n + 1, n)])
    X = ttt.mdct(torch.from_numpy(frames), w)
    _close(X, jtt.mdct(jnp.asarray(frames), w))
    y = ttt.imdct(X, w)
    _close(y, jtt.imdct(jnp.asarray(X.numpy()), w))
    out = np.zeros(8 * n)
    for i, fr in enumerate(y.numpy()):
        out[i * n:i * n + 2 * n] += fr
    np.testing.assert_allclose(out[n:7 * n], x[n:7 * n], atol=1e-8)
    X32 = ttt.mdct(torch.from_numpy(frames.astype(np.float32)))
    assert X32.dtype == torch.float32


# ------------------------------------------------------------------ czt

@pytest.mark.parametrize("n,m", [(64, 64), (100, 37), (37, 100), (1, 5)])
def test_czt_equals_jax(n, m):
    x = _sig((2, n), 9, True)
    for kw in ({}, {"w": 0.9995 * np.exp(-0.03j), "a": 1.01 * np.exp(0.2j)},
               {"w_angle": -0.011}):
        got = tczt.czt(torch.from_numpy(x), m, **kw)
        ref = jczt.czt(jnp.asarray(x), m, **kw)
        _close(got, ref, rtol=1e-9, atol_rel=1e-9)
    with pytest.raises(ValueError, match="not both"):
        tczt.czt(torch.from_numpy(x), m, w=1j, w_angle=0.1)


def test_czt_default_contour_is_fft_and_real_input():
    x = _sig(128, 10)
    got = tczt.czt(torch.from_numpy(x))
    assert got.dtype == torch.complex128
    _close(got, np.fft.fft(x), rtol=1e-9, atol_rel=1e-9)
    g32 = tczt.czt(torch.from_numpy(x.astype(np.float32)))
    assert g32.dtype == torch.complex64


@pytest.mark.parametrize("endpoint", [False, True])
def test_zoom_fft_and_plan_equal_jax(endpoint):
    x = _sig((3, 1000), 11, True)
    got = tczt.zoom_fft(torch.from_numpy(x), 0.2, 0.3, 256, endpoint=endpoint)
    ref = jczt.zoom_fft(jnp.asarray(x), 0.2, 0.3, 256, endpoint=endpoint)
    _close(got, ref, rtol=1e-9, atol_rel=1e-9)
    _close(tczt.zoom_fft(torch.from_numpy(x), 0.4, fs=1.0),
           jczt.zoom_fft(jnp.asarray(x), 0.4, fs=1.0), atol_rel=1e-9)
    plan, jplan = tczt.CZT(1000, 300, w_angle=-0.002), jczt.CZT(
        1000, 300, w_angle=-0.002)
    _close(plan.execute(torch.from_numpy(x)), jplan.execute(jnp.asarray(x)),
           atol_rel=1e-9)
    assert repr(plan) == repr(jplan)
    with pytest.raises(ValueError, match="n=1000"):
        plan.execute(torch.zeros(10))


# --------------------------------------------------------------- wavelet

@pytest.mark.parametrize("name", ["haar", "db2", "db4"])
def test_wavelets_equal_jax_and_reconstruct(name):
    for a, b in zip(twv.wavelet_filters(name), jwv.wavelet_filters(name)):
        np.testing.assert_array_equal(a, b)
    x = _sig((2, 512), 12)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for got, ref in zip(twv.dwt(xt, name), jwv.dwt(xj, name)):
        _close(got, ref, rtol=1e-12, atol_rel=1e-12)
    cs = twv.wavedec(xt, name, 4)
    cj = jwv.wavedec(xj, name, 4)
    for got, ref in zip(cs, cj):
        _close(got, ref, rtol=1e-12, atol_rel=1e-12)
    y = twv.waverec(cs, name)
    _close(y, jwv.waverec(cj, name), rtol=1e-12, atol_rel=1e-12)
    np.testing.assert_allclose(y.numpy(), x, atol=1e-12)


def test_wavelet_validation():
    with pytest.raises(ValueError, match="unknown wavelet"):
        twv.wavelet_filters("db3")
    with pytest.raises(ValueError, match="divisible"):
        twv.wavedec(torch.zeros(24, dtype=torch.float64), "haar", 4)


@pytest.mark.parametrize("n,sigma_samples", [(4096, None), (4096, 1000),
                                             (8192, 65536)])
def test_denoise_soft_equals_jax(n, sigma_samples):
    t = np.arange(n)
    x = np.sin(2 * np.pi * t / 256) + 0.3 * _sig(n, 13)
    got = twv.denoise_soft(torch.from_numpy(x), "db4", 4,
                           sigma_samples=sigma_samples)
    ref = jwv.denoise_soft(jnp.asarray(x), "db4", 4,
                           sigma_samples=sigma_samples)
    _close(got, ref, rtol=1e-12, atol_rel=1e-12)


def test_denoise_median_of_an_even_count_is_jax_median():
    """The MAD's median over an even count of coefficients is the mean of
    the two middle values (jnp.median), not the lower one (torch.median):
    a fixed threshold from it gives JAX's output, and the lower value's
    threshold would not."""
    d = torch.tensor([[1.0, 2.0, 3.0, 4.0]], dtype=torch.float64)
    assert float(twv._median(d)) == 2.5 == float(jnp.median(jnp.asarray(
        d.numpy())))
    assert float(torch.median(d)) == 2.0
    # 2048 samples: the finest detail level holds 1024 (even) coefficients
    x = _sig(2048, 14) * np.linspace(0.1, 3, 2048)
    got = twv.denoise_soft(torch.from_numpy(x), "db2", 3)
    ref = np.asarray(jwv.denoise_soft(jnp.asarray(x), "db2", 3))
    _close(got, ref, rtol=1e-12, atol_rel=1e-12)
    d1 = np.abs(np.asarray(jwv.wavedec(jnp.asarray(x), "db2", 3)[-1]))
    lower = np.sort(d1)[len(d1) // 2 - 1] / 0.6745 * np.sqrt(
        2 * np.log(2048))
    wrong = np.asarray(jwv.denoise_soft(jnp.asarray(x), "db2", 3,
                                        threshold=lower))
    assert np.abs(wrong - ref).max() > 1e-6


@pytest.mark.parametrize("name", ["mulaw_compress", "mulaw_expand",
                                  "alaw_compress", "alaw_expand"])
def test_p6_companders_on_complex_input_equal_jax(name):
    """P6: JAX's companders take complex input (``jnp.sign`` is z/|z|, 0
    at 0); the port's use ``torch.sgn``, which is the same there and equal
    to ``torch.sign`` on real input.  complex128 within 1e-12 of JAX's,
    zeros included."""
    x = _sig(257, 31, cplx=True, scale=0.4)
    x[::17] = 0.0
    want = np.asarray(getattr(jq, name)(jnp.asarray(x)))
    got = getattr(tq, name)(torch.from_numpy(x)).numpy()
    _close(got, want, rtol=1e-12, atol_rel=1e-12)


@pytest.mark.parametrize("n", [1024, 1000])
def test_p6_denoise_soft_complex_equals_jax(n):
    """P6: complex soft thresholding shrinks |d| and keeps the phase,
    d/|d| max(|d| - thr, 0), as JAX's ``jnp.sign`` gives it; complex128
    within 1e-12 of JAX's (the real denoiser's gate)."""
    x = _sig(n, 32, cplx=True)
    want = np.asarray(jwv.denoise_soft(jnp.asarray(x), "db4", levels=3))
    got = twv.denoise_soft(torch.from_numpy(x), "db4", levels=3).numpy()
    _close(got, want, rtol=1e-12, atol_rel=1e-12)
