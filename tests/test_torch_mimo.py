"""Port vs JAX package: models/mimo.py and models/array_proc.py on the CPU.

The same seeded numpy channels and snapshots go through both packages.
Gates (relative to the largest value): ZF, MMSE (solves of the normal
equations) and ``mimo_capacity`` within 1e-4 of JAX's in complex64 and
1e-11 in complex128, the Alamouti code within 1e-5 and 1e-12;
``ml_detect`` and ``slice_nearest`` indices equal (seeds away from
distance ties) and equal to an exhaustive float64 numpy search.  Array
processing: steering vectors and MRC weights within 1e-6; covariance,
beamformer outputs and the Bartlett spectrum within 1e-5; MVDR weights
(a solve) within 1e-4; eigenvectors
are fixed only up to a phase, so the MUSIC spectrum is held within 1e-4
of JAX's (the noise projector, never the vectors) and
the DoAs of ``music_doa``, ``esprit_doa`` and ``root_music_doa`` within
0.01 degrees of JAX's and 0.5 degrees of the truth (tests/
test_array_proc.py's gate).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.models import array_proc as jap
from solid_dsp_tpu.models import mimo as jm
from solid_dsp_tpu_torch.models import array_proc as tap
from solid_dsp_tpu_torch.models import mimo as tm

CPU = "cpu"
QPSK = (np.array([1 + 1j, -1 + 1j, -1 - 1j, 1 - 1j]) / np.sqrt(2)).astype(
    np.complex64)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _cn(rng, *shape, dtype=np.complex64):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            / np.sqrt(2)).astype(dtype)


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(_np(got), want,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("dtype,rtol", [(np.complex64, 1e-5),
                                        (np.complex128, 1e-12)])
def test_linear_detectors_alamouti_capacity_equal_jax(dtype, rtol):
    rng = np.random.default_rng(0)
    H = _cn(rng, 64, 4, 4, dtype=dtype)
    s = QPSK[rng.integers(0, 4, (64, 4))].astype(dtype)
    y = (np.einsum("brt,bt->br", H, s) + 0.05 * _cn(rng, 64, 4)).astype(
        dtype)
    Ht, yt = torch.from_numpy(H), torch.from_numpy(y)
    _close(tm.zf_detect(Ht, yt), jm.zf_detect(H, y), rtol * 10)
    _close(tm.mmse_detect(Ht, yt, 0.05), jm.mmse_detect(H, y, 0.05),
           rtol * 10)
    _close(tm.mimo_capacity(Ht, 10.0), jm.mimo_capacity(H, 10.0), rtol * 10)
    tx_t = tm.alamouti_encode(torch.from_numpy(s.reshape(-1)))
    _close(tx_t, jm.alamouti_encode(s.reshape(-1)), rtol)
    h2 = _cn(rng, 2, dtype=dtype)
    yr = (_np(tx_t) @ h2).astype(dtype)
    for h in (h2, np.broadcast_to(h2, (len(yr) // 2, 2)).copy()):
        for a, b in zip(tm.alamouti_decode(torch.from_numpy(yr),
                                           torch.from_numpy(h)),
                        jm.alamouti_decode(yr, h)):
            _close(a, b, rtol)
    s_hat, g = tm.alamouti_decode(torch.from_numpy(yr), torch.from_numpy(h2))
    np.testing.assert_allclose(_np(s_hat) / _np(g), s.reshape(-1),
                               atol=1e-4)


def test_ml_detect_and_slicing_equal_jax_and_exhaustive_search():
    rng = np.random.default_rng(1)
    H = _cn(rng, 200, 2, 2)
    s_idx = rng.integers(0, 4, (200, 2))
    y = (np.einsum("brt,bt->br", H, QPSK[s_idx]) + 0.3 * _cn(rng, 200, 2)
         ).astype(np.complex64)
    idx_t, pts_t = tm.ml_detect(torch.from_numpy(H), torch.from_numpy(y),
                                torch.from_numpy(QPSK))
    idx_j, pts_j = jm.ml_detect(H, y, QPSK)
    np.testing.assert_array_equal(_np(idx_t), np.asarray(idx_j))
    np.testing.assert_array_equal(_np(pts_t), np.asarray(pts_j))
    hyp = np.array(list(itertools.product(range(4), repeat=2)))
    d = np.abs(y.astype(np.complex128)[:, None, :] - np.einsum(
        "brt,ht->bhr", H.astype(np.complex128), QPSK[hyp])) ** 2
    np.testing.assert_array_equal(_np(idx_t), hyp[d.sum(-1).argmin(-1)])
    soft = _np(tm.zf_detect(torch.from_numpy(H), torch.from_numpy(y)))
    i_t, p_t = tm.slice_nearest(torch.from_numpy(soft), QPSK)
    i_j, p_j = jm.slice_nearest(soft, QPSK)
    np.testing.assert_array_equal(_np(i_t), np.asarray(i_j))
    np.testing.assert_array_equal(_np(p_t), np.asarray(p_j))


def _ula_snapshots(n_ant, thetas_deg, powers, T, noise_pow, seed):
    """tests/test_array_proc.py's snapshots."""
    rng = np.random.default_rng(seed)
    k = np.arange(n_ant)[:, None]
    X = np.zeros((n_ant, T), np.complex128)
    for th, p in zip(thetas_deg, powers):
        a = np.exp(2j * np.pi * 0.5 * np.sin(np.deg2rad(th)) * k)
        X += a * (np.sqrt(p / 2) * (rng.standard_normal(T) + 1j
                                    * rng.standard_normal(T)))[None, :]
    X += np.sqrt(noise_pow / 2) * (rng.standard_normal((n_ant, T))
                                   + 1j * rng.standard_normal((n_ant, T)))
    return X.astype(np.complex64)


@pytest.fixture(scope="module")
def two_sources():
    X = _ula_snapshots(8, [-20.0, 35.0], [1.0, 1.0], 4096, 0.1, seed=1)
    return X, tap.spatial_covariance(torch.from_numpy(X)), \
        np.asarray(jap.spatial_covariance(jnp.asarray(X)))


def test_beamforming_equal_jax(two_sources):
    X, R_t, R_j = two_sources
    _close(R_t, R_j, 1e-5)
    for th in (0.0, np.deg2rad(30.0), np.array([-0.4, 0.1, 1.2])):
        _close(tap.ula_steering(8, th, device=CPU), jap.ula_steering(8, th),
               1e-6)
    a = tap.ula_steering(8, np.deg2rad(35.0), device=CPU)
    a_j = jap.ula_steering(8, np.deg2rad(35.0))
    w_t = tap.mvdr_weights(R_t, a)
    _close(w_t, jap.mvdr_weights(jnp.asarray(R_j), a_j), 1e-4)
    _close(tap.beamform(torch.from_numpy(X), w_t),
           jap.beamform(jnp.asarray(X), jnp.asarray(_np(w_t))), 1e-5)
    _close(tap.mrc_weights(a), jap.mrc_weights(a_j), 1e-6)
    th = np.deg2rad(np.linspace(-90, 90, 721))
    _close(tap.bartlett_spectrum(R_t, th), jap.bartlett_spectrum(
        jnp.asarray(R_j), jnp.asarray(th)), 1e-5)


def test_subspace_estimators_equal_jax(two_sources):
    _, R_t, R_j = two_sources
    th = np.deg2rad(np.linspace(-90, 90, 1801))
    _close(tap.music_spectrum(R_t, th, 2), jap.music_spectrum(
        jnp.asarray(R_j), jnp.asarray(th), 2), 1e-4)
    truth = np.array([-20.0, 35.0])
    for fn_t, fn_j in ((tap.music_doa, jap.music_doa),
                       (tap.esprit_doa, jap.esprit_doa),
                       (tap.root_music_doa, jap.root_music_doa)):
        got = np.rad2deg(fn_t(R_t, 2))
        want = np.rad2deg(fn_j(jnp.asarray(R_j), 2))
        np.testing.assert_allclose(got, want, atol=0.01)
        np.testing.assert_allclose(got, truth, atol=0.5)
    with pytest.raises(ValueError):
        tap.esprit_doa(R_t, 8)
    with pytest.raises(ValueError):
        tap.root_music_doa(R_t, 8)
