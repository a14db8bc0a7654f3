"""The port's front-end impairment correction (models/impairments.py) vs the
JAX package's, on the CPU.

Tolerances: complex64 reductions summed in another order agree to 1e-6 of
the signal's scale, complex128 to 1e-12; the blanker's mask exactly and
its fraction within 1e-6 (a float32 mean); the corrected
image rejection above 25 dB and 8 dB better than the impaired signal's
(tests/test_impairments.py's gates).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.models import impairments as jimp
from solid_dsp_tpu_torch.models import impairments as imp


def _impaired(n, seed, dt=np.complex64):
    rng = np.random.default_rng(seed)
    s = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) / np.sqrt(2)
    r = np.asarray(jimp.apply_iq_imbalance(s, 1.0, 5.0, dc=0.2 - 0.1j))
    return s, r.astype(dt)


def _close(got, want, atol):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=atol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("dt,atol", [(np.complex64, 1e-6),
                                     (np.complex128, 1e-12)])
def test_estimators_and_correction_match_jax(dt, atol):
    _, r = _impaired(8192, 1, dt)
    rt = torch.from_numpy(r)
    _close(imp.estimate_dc(rt), jimp.estimate_dc(jnp.asarray(r)), atol)
    _close(imp.estimate_iq_imbalance(rt),
           jimp.estimate_iq_imbalance(jnp.asarray(r)), atol)
    dc, k = imp.estimate_dc(rt), imp.estimate_iq_imbalance(rt)
    y = imp.correct(rt, dc, k)
    _close(y, jimp.correct(jnp.asarray(r), jnp.asarray(dc.numpy()),
                           jnp.asarray(k.numpy())), atol)
    irr_before, irr_after = (imp.image_rejection_db(r),
                             imp.image_rejection_db(y))
    assert irr_before < 22.0 and irr_after > max(25.0, irr_before + 8.0)
    assert abs(imp.image_rejection_db(y)
               - jimp.image_rejection_db(np.asarray(y))) < 1e-9


def test_batched_correction_matches_jax():
    _, r = _impaired(3 * 1024, 2)
    r = r.reshape(3, 1024)
    rt = torch.from_numpy(r)
    dc, k = imp.estimate_dc(rt), imp.estimate_iq_imbalance(rt)
    _close(imp.correct(rt, dc, k),
           jimp.correct(jnp.asarray(r), jnp.asarray(dc.numpy()),
                        jnp.asarray(k.numpy())), 1e-6)


def test_apply_iq_imbalance_matches_jax():
    s = np.exp(1j * np.linspace(0, 20, 500)).astype(np.complex64)
    _close(imp.apply_iq_imbalance(s, 0.5, -3.0, dc=0.01),
           jimp.apply_iq_imbalance(s, 0.5, -3.0, dc=0.01), 1e-12)


@pytest.mark.parametrize("primed", [False, True])
def test_ema_correct_matches_jax(primed):
    """The chain's form: bandwidth as a complex64 scalar, primed a bool
    tensor; and the class's: a Python float and bool."""
    _, r = _impaired(4096, 3)
    dc0, k0 = np.complex64(0.1 + 0.2j), np.complex64(0.01 - 0.02j)
    y, dc, k = imp.ema_correct(torch.from_numpy(r), torch.tensor(dc0),
                               torch.tensor(k0),
                               torch.tensor(0.1, dtype=torch.complex64),
                               torch.tensor(primed))
    jy, jdc, jk = jimp.ema_correct(jnp.asarray(r), jnp.asarray(dc0),
                                   jnp.asarray(k0),
                                   jnp.asarray(0.1, jnp.complex64),
                                   jnp.asarray(primed))
    _close(y, jy, 1e-6)
    _close(dc, jdc, 1e-6)
    _close(k, jk, 1e-6)


def test_impairment_corrector_streams_like_jax():
    _, r = _impaired(4 * 2048, 4)
    c, jc = imp.ImpairmentCorrector(0.2, device="cpu"), \
        jimp.ImpairmentCorrector(0.2)
    for b in range(4):
        blk = r[b * 2048:(b + 1) * 2048]
        _close(c.execute_block(blk), jc.execute_block(blk), 1e-6)
        assert abs(c.dc - jc.dc) < 1e-6 and abs(c.k - jc.k) < 1e-6
    assert imp.image_rejection_db(c.execute_block(r[:2048])) > 25.0
    c.reset()
    assert c.dc == 0 and c.k == 0 and "ImpairmentCorrector" in repr(c)
    with pytest.raises(ValueError):
        imp.ImpairmentCorrector(0.0, device="cpu")


@pytest.mark.parametrize("n", [1000, 1001])
def test_noise_blanker_matches_jax(n):
    """Impulses 30x the envelope are zeroed; the median of an even length
    is the midpoint of the two middle values, as jnp.median."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    x[rng.integers(0, n, 12)] *= 30.0
    y, frac = imp.noise_blanker(torch.from_numpy(x), 6.0)
    jy, jfrac = jimp.noise_blanker(jnp.asarray(x), 6.0)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    assert abs(float(frac) - float(jfrac)) < 1e-6 and float(frac) > 0.0
    x2 = x.reshape(1, n)
    y2, f2 = imp.noise_blanker(torch.from_numpy(x2))
    jy2, jf2 = jimp.noise_blanker(jnp.asarray(x2))
    np.testing.assert_array_equal(y2.numpy(), np.asarray(jy2))
    np.testing.assert_allclose(f2.numpy(), np.asarray(jf2), atol=1e-6)
