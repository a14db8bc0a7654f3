"""Port vs JAX package: analysis/lpc.py and S5's plain version.

The same seeded numpy inputs go through both packages on the CPU (a CPU
tensor takes S5's plain version ``lattice_iir_plain``).  Gates, from
tests/test_lpc.py: acf, levinson, lpc, burg, reflection_to_poly and
lattice_fir within rtol 1e-9 (atol 1e-12) of JAX's in float64 and
complex128; ar_psd 1e-9; lattice_iir within rtol 1e-8 (atol 1e-10) of JAX's
(test_lpc.py:126-140) in float64 and complex128, and it inverts
lattice_fir; in float32 and complex64 within 2e-4 of max|x| against the
float64 walk; orders up to 64 and leading axes with k broadcast.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

from solid_dsp_tpu_torch import analysis

# the packages' ``lpc`` names the function: import the modules by path
jl = importlib.import_module("solid_dsp_tpu.analysis.lpc")
tl = importlib.import_module("solid_dsp_tpu_torch.analysis.lpc")


def _sig(shape, seed, cplx):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if cplx:
        x = x + 1j * rng.standard_normal(shape)
    return x


def _ar_sig(n, seed, cplx=False):
    """An AR(4) process: two resonances."""
    a = np.poly([0.9 * np.exp(1j * 0.6), 0.9 * np.exp(-1j * 0.6),
                 0.8 * np.exp(1j * 1.9), 0.8 * np.exp(-1j * 1.9)]).real
    return sps.lfilter([1.0], a, _sig(n, seed, cplx))


def _close(got, ref, rtol=1e-9, atol=1e-12):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, (
        got.shape, ref.shape, got.dtype, ref.dtype)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("order", [1, 4, 12])
def test_acf_levinson_lpc_burg_match_jax(cplx, order):
    x = _ar_sig(1024, 1, cplx)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    _close(tl.acf(xt, order), jl.acf(xj, order))
    _close(tl.acf(xt, order, normalize=False),
           jl.acf(xj, order, normalize=False), atol=1e-9)
    for got, ref in zip(tl.levinson(tl.acf(xt, order)),
                        jl.levinson(jl.acf(xj, order))):
        _close(got, ref)
    for got, ref in zip(tl.lpc(xt, order), jl.lpc(xj, order)):
        _close(got, ref)
    for got, ref in zip(tl.burg(xt, order), jl.burg(xj, order)):
        _close(got, ref)


def test_batched_leading_axes_match_jax():
    xb = _sig((3, 5, 512), 9, False)
    for fn in ("lpc", "burg"):
        for got, ref in zip(getattr(tl, fn)(torch.from_numpy(xb), 6),
                            getattr(jl, fn)(jnp.asarray(xb), 6)):
            _close(got, ref)


def test_order_validation():
    x = torch.zeros(8, dtype=torch.float64)
    with pytest.raises(ValueError, match="order"):
        tl.acf(x, 8)
    with pytest.raises(ValueError, match="order"):
        tl.burg(x, 8)


@pytest.mark.parametrize("cplx", [False, True])
def test_ar_psd_and_reflection_to_poly_match_jax(cplx):
    x = _ar_sig(2048, 5, cplx)
    a, k, e = tl.lpc(torch.from_numpy(x), 8)
    aj, kj, ej = jl.lpc(jnp.asarray(x), 8)
    _close(tl.ar_psd(a, e, 2048), jl.ar_psd(aj, ej, 2048), rtol=1e-9,
           atol=0)
    _close(tl.reflection_to_poly(k), jl.reflection_to_poly(kj))
    _close(tl.reflection_to_poly(k), a)


@pytest.mark.parametrize("cplx", [False, True])
def test_lattice_fir_matches_jax_and_direct_form(cplx):
    x = _sig(300, 6, cplx)
    _, k, _ = tl.lpc(torch.from_numpy(x), 6)
    y = tl.lattice_fir(torch.from_numpy(x), k)
    _close(y, jl.lattice_fir(jnp.asarray(x), jnp.asarray(k.numpy())))
    a = tl.reflection_to_poly(k).numpy()
    np.testing.assert_allclose(y.numpy(), sps.lfilter(a, [1.0], x),
                               rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("cplx", [False, True])
def test_lattice_iir_matches_jax_and_inverts_lattice_fir(cplx):
    x = _sig(200, 7, cplx)
    _, k, _ = tl.lpc(torch.from_numpy(x), 5)
    y = tl.lattice_fir(torch.from_numpy(x), k)
    got = tl.lattice_iir(y, k)
    ref = jl.lattice_iir(jnp.asarray(y.numpy()), jnp.asarray(k.numpy()))
    _close(got, ref, rtol=1e-8, atol=1e-10)
    _close(got, x, rtol=1e-8, atol=1e-10)
    # the all-pole filter 1 / A(z)
    w = _sig(200, 8, cplx)
    a = tl.reflection_to_poly(k).numpy()
    np.testing.assert_allclose(tl.lattice_iir(torch.from_numpy(w), k).numpy(),
                               sps.lfilter([1.0], a, w), rtol=1e-8,
                               atol=1e-10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
def test_lattice_iir_plain_single_precision(dtype):
    """S5's plain version in float32 / complex64 against its float64 walk:
    a stable order-16 lattice over 4 lanes, k shared (broadcast)."""
    cplx = dtype.is_complex
    x = _sig((4, 256), 10, cplx)
    _, k, _ = tl.burg(torch.from_numpy(_ar_sig(4096, 11, cplx)), 16)
    y64 = tl.lattice_fir(torch.from_numpy(x), k)
    ref = tl.lattice_iir_plain(y64, k)
    got = tl.lattice_iir(y64.to(dtype), k.to(dtype))
    assert got.dtype == dtype and got.shape == (4, 256)
    err = float((got.to(ref.dtype) - ref).abs().max())
    assert err <= 2e-4 * float(ref.abs().max()), err


@pytest.mark.parametrize("cplx", [False, True])
def test_lattice_iir_order_64_and_per_lane_coefficients(cplx):
    """Order 64 (S5's largest register bucket) and coefficients of its own
    for each lane, against JAX in float64 / complex128."""
    rng = np.random.default_rng(12)
    p = 64
    k = 0.6 * rng.uniform(-1, 1, (2, p)) / np.sqrt(np.arange(1, p + 1))
    if cplx:
        k = k * np.exp(1j * rng.uniform(0, 2 * np.pi, (2, p)))
    y = _sig((2, 96), 13, cplx)
    got = tl.lattice_iir(torch.from_numpy(y), torch.from_numpy(k))
    ref = jl.lattice_iir(jnp.asarray(y), jnp.asarray(k))
    _close(got, ref, rtol=1e-8, atol=1e-10)
    back = tl.lattice_fir(got, torch.from_numpy(k))
    _close(back, y, rtol=1e-8, atol=1e-9)


def test_package_exports():
    for name in ("acf", "levinson", "lpc", "burg", "ar_psd", "lattice_fir",
                 "lattice_iir", "reflection_to_poly"):
        assert getattr(analysis, name) is getattr(tl, name)
