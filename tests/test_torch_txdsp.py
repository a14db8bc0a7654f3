"""Port vs JAX package: models/dpd.py and models/cfr.py on the CPU.

Seeded numpy signals go through both packages.  Gates: the MP basis
within 1e-6 x max in complex64 (elementwise products in JAX's order;
torch's complex |x| rounds differently from XLA's in the last place) and
1e-12 in complex128; mp_apply, saleh_pa,
papr_db, clip_envelope and cfr_icf within 1e-5 x max in complex64 (the
product's and the FFTs' sums in another order) and 1e-10 in complex128;
mp_fit's coefficients within 1e-3 relative (complex64 normal equations of
condition ~1e3: tests/test_dpd.py's own gate is rtol 2e-3 to the truth)
and 1e-9 in complex128; dpd_learn's coefficients and gain likewise; the
Predistorter's blocks and its carried state within 1e-5 of JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.models import cfr as jcfr
from solid_dsp_tpu.models import dpd as jdpd
from solid_dsp_tpu_torch.interop import tensors_from_numpy, tensors_to_numpy
from solid_dsp_tpu_torch.models import cfr as tcfr
from solid_dsp_tpu_torch.models import dpd as tdpd

CPU = "cpu"


def _np(t):
    return t.detach().cpu().numpy()


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (
        got.shape, want.shape, got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _sig(n, seed, scale=0.2, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    return (scale * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            ).astype(dtype)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_mp_basis_and_apply_equal_jax(dtype):
    x = _sig(2000, 1, dtype=dtype)
    tol = 1e-5 if dtype == np.complex64 else 1e-10
    _close(_np(tdpd.mp_basis(torch.from_numpy(x), 7, 3)),
           jdpd.mp_basis(jnp.asarray(x), 7, 3),
           1e-6 if dtype == np.complex64 else 1e-12)
    c = np.r_[1.0, np.full(20, 1e-3)].astype(dtype)
    _close(_np(tdpd.mp_apply(torch.from_numpy(c), torch.from_numpy(x), 7, 3)),
           jdpd.mp_apply(jnp.asarray(c), jnp.asarray(x), 7, 3), tol)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_mp_fit_and_saleh_equal_jax(dtype):
    x = _sig(4000, 2, scale=0.25, dtype=dtype)
    y_t = tdpd.saleh_pa(torch.from_numpy(x))
    y_j = jdpd.saleh_pa(jnp.asarray(x))
    _close(_np(y_t), y_j, 1e-6 if dtype == np.complex64 else 1e-12)
    y = np.array(y_j)
    got = tdpd.mp_fit(torch.from_numpy(y), torch.from_numpy(x), 5, 3)
    want = jdpd.mp_fit(jnp.asarray(y), jnp.asarray(x), 5, 3)
    if dtype == np.complex128:
        _close(_np(got), want, 1e-9)
    else:
        y2, x2 = y.astype(np.complex128), x.astype(np.complex128)
        ref = np.asarray(jdpd.mp_apply(jdpd.mp_fit(jnp.asarray(y2),
                                                   jnp.asarray(x2), 5, 3),
                                       jnp.asarray(y2), 5, 3))

        def err(c):
            out = jdpd.mp_apply(jnp.asarray(np.asarray(c), np.complex128),
                                jnp.asarray(y2), 5, 3)
            return np.abs(np.asarray(out) - ref).max()
        assert err(_np(got)) <= min(2e-3 * np.abs(ref).max(),
                                    2 * err(want))


def test_dpd_learn_and_predistorter_equal_jax():
    x = _sig(8192, 3, scale=0.12, dtype=np.complex128)
    c_t, g_t = tdpd.dpd_learn(tdpd.saleh_pa, torch.from_numpy(x), 5, 3, 2)
    c_j, g_j = jdpd.dpd_learn(jdpd.saleh_pa, jnp.asarray(x), 5, 3, 2)
    np.testing.assert_allclose(_np(c_t), np.asarray(c_j), rtol=0,
                               atol=1e-9 * np.abs(np.asarray(c_j)).max())
    assert abs(complex(g_t) - complex(g_j)) <= 1e-10 * abs(complex(g_j))
    c = np.asarray(c_j).astype(np.complex64)
    tp = tdpd.Predistorter(c, 5, 3, device=CPU)
    jp = jdpd.Predistorter(jnp.asarray(c), 5, 3)
    xs = x.astype(np.complex64)
    for lo, hi in ((0, 1000), (1000, 1001), (1001, 4000)):
        _close(_np(tp.execute_block(xs[lo:hi])),
               jp.execute_block(jnp.asarray(xs[lo:hi])), 1e-5)
    _close(_np(tp.state["tail"]), jp._tail, 1e-7)
    # the JAX object's carry continues in the port
    tp2 = tdpd.Predistorter(np.zeros(15, np.complex64), 5, 3, device=CPU)
    tp2.state = tensors_from_numpy({"c": np.asarray(jp._c),
                                    "tail": np.asarray(jp._tail)}, CPU)
    _close(_np(tp2.execute_block(xs[4000:])),
           jp.execute_block(jnp.asarray(xs[4000:])), 1e-5)
    assert set(tensors_to_numpy(tp2.state)) == {"c", "tail"}


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_papr_clip_and_icf_equal_jax(dtype):
    rng = np.random.default_rng(4)
    n = 4096
    X = np.zeros(n, complex)
    X[:n // 8] = rng.standard_normal(n // 8) + 1j * rng.standard_normal(
        n // 8)
    x = (np.fft.ifft(X) * np.sqrt(n / (n // 8))).astype(dtype)
    tol = 1e-5 if dtype == np.complex64 else 1e-10
    assert abs(float(tcfr.papr_db(torch.from_numpy(x)))
               - float(jcfr.papr_db(jnp.asarray(x)))) <= 1e-4
    _close(_np(tcfr.clip_envelope(torch.from_numpy(x), 1.2)),
           jcfr.clip_envelope(jnp.asarray(x), 1.2), tol)
    mask = tcfr.band_mask(n, 0.25)
    np.testing.assert_array_equal(mask, jcfr.band_mask(n, 0.25))
    _close(_np(tcfr.cfr_icf(torch.from_numpy(x), 1.2, mask, iters=4)),
           jcfr.cfr_icf(jnp.asarray(x), 1.2, jnp.asarray(mask), iters=4),
           tol)
