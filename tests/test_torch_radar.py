"""Port vs JAX package: models/radar.py on the CPU, and fault F7.

Gates: the chirp bit-equal; pulse compression and the range-Doppler map
within 1e-5 x max (complex64; conv1d and FFT sums in another order) and
1e-10 (complex128) of JAX's; CA-CFAR thresholds within 1e-5 relative of
a float64 evaluation, and within 1e-4 of JAX's on rows of at most 1000
cells (there JAX's float32 running sum, up to ~1.3e3 with its ulp of
1.2e-4, errs by a few 1e-5 against window sums of >= 4), detections equal to
JAX's except within 1e-4 of the threshold; the multiplier formula equal.

F7, a fault of the reference: JAX's ``cfar_ca`` forms every window sum as
the difference of one float32 running sum over the whole row; at 2^22
cells (the TPU sweep's ``cfar_ca_g2t16``) its thresholds err by percents.
The port's box sums keep every row within 1e-5 of float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.models import radar as jr
from solid_dsp_tpu_torch.models import radar as tr


def _np(t):
    return t.detach().cpu().numpy()


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _cfar64(p, guard, train, pfa):
    """CA-CFAR thresholds in float64: the windows from a float64 running
    sum, JAX's clipped edges and per-count multipliers."""
    p = np.asarray(p, np.float64)
    N = p.shape[-1]
    c = np.concatenate([np.zeros((*p.shape[:-1], 1)), np.cumsum(p, -1)], -1)
    i = np.arange(N)

    def at(off):
        return c[..., np.clip(i + off, 0, N)]
    total = (at(-guard) - at(-guard - train)
             + at(1 + guard + train) - at(1 + guard))
    left_n = np.clip(i - guard, 0, N) - np.clip(i - guard - train, 0, N)
    right_n = (np.clip(i + 1 + guard + train, 0, N)
               - np.clip(i + 1 + guard, 0, N))
    count = np.maximum(left_n + right_n, 1).astype(np.float64)
    return count * (pfa ** (-1.0 / count) - 1.0) * total / count


def test_chirp_and_factor_equal_jax():
    np.testing.assert_array_equal(tr.lfm_chirp(257, 0.6),
                                  jr.lfm_chirp(257, 0.6))
    for pfa, n in ((1e-4, 32), (1e-6, 8), (0.01, 1)):
        assert tr.cfar_threshold_factor(pfa, n) == jr.cfar_threshold_factor(
            pfa, n)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_pulse_compress_and_range_doppler_equal_jax(dtype):
    rng = np.random.default_rng(1)
    pulse = tr.lfm_chirp(64)
    X = (0.1 * (rng.standard_normal((32, 1024))
                + 1j * rng.standard_normal((32, 1024)))).astype(dtype)
    X[:, 300:364] += pulse * np.exp(2j * np.pi * 0.1 * np.arange(32))[:, None]
    tol = 1e-5 if dtype == np.complex64 else 1e-10
    pc_t = tr.pulse_compress(torch.from_numpy(X), pulse)
    pc_j = jr.pulse_compress(jnp.asarray(X), jnp.asarray(pulse))
    _close(_np(pc_t), pc_j, tol)
    for window in ("hann", "rect"):
        _close(_np(tr.range_doppler_map(pc_t, window)),
               jr.range_doppler_map(pc_j, window), tol)
    with pytest.raises(ValueError):
        tr.range_doppler_map(pc_t, "kaiser")


@pytest.mark.parametrize("guard,train", [(2, 16), (1, 4), (0, 8)])
@pytest.mark.parametrize("shape", [(1000,), (3, 777), (40,)])
def test_cfar_ca_equals_jax_and_float64(guard, train, shape):
    """Rows short enough that JAX's running sum stays near float32:
    thresholds within 1e-5 relative of float64 and 1e-4 of JAX's (edges
    included), detections equal to JAX's away from the threshold."""
    rng = np.random.default_rng(guard + train)
    p = rng.exponential(1.0, shape).astype(np.float32)
    p[..., ::97] += 30.0                         # targets
    det_t, thr_t = tr.cfar_ca(torch.from_numpy(p), guard, train, 1e-4)
    det_j, thr_j = jr.cfar_ca(jnp.asarray(p), guard, train, 1e-4)
    thr64 = _cfar64(p, guard, train, 1e-4)
    assert thr_t.dtype == torch.float32 and det_t.dtype == torch.bool
    thr_t = _np(thr_t)
    np.testing.assert_allclose(thr_t, np.asarray(thr_j), rtol=1e-4)
    np.testing.assert_allclose(thr_t, thr64, rtol=1e-5)
    clear = np.abs(p - thr64) > 1e-4 * thr64
    np.testing.assert_array_equal(_np(det_t)[clear], np.asarray(det_j)[clear])


def test_f7_cfar_window_sums_are_exact():
    """F7 at the TPU sweep's size (2^22 exponential(1) cells, guard 2,
    train 16, pfa 1e-4): JAX's thresholds err above 1e-3 relative of the
    float64 evaluation (its float32 running sum reaches ~4e6, ulp 0.5);
    the port's stay within 1e-5, and its detections equal float64's
    except within that tolerance of the threshold."""
    rng = np.random.default_rng(0)
    p = rng.exponential(1.0, 1 << 22).astype(np.float32)
    thr64 = _cfar64(p, 2, 16, 1e-4)
    _, thr_j = jr.cfar_ca(jnp.asarray(p), 2, 16, 1e-4)
    err_j = np.abs(np.asarray(thr_j, np.float64) / thr64 - 1).max()
    det_t, thr_t = tr.cfar_ca(torch.from_numpy(p), 2, 16, 1e-4)
    err_t = np.abs(_np(thr_t).astype(np.float64) / thr64 - 1).max()
    assert err_j > 1e-3, err_j
    assert err_t <= 1e-5, err_t
    clear = np.abs(p - thr64) > 1e-5 * thr64
    np.testing.assert_array_equal(_np(det_t)[clear], (p > thr64)[clear])
