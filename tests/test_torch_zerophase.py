"""The port's zero-phase filtering (ops/zerophase.py) vs the JAX package's
and scipy, on the CPU.

Tolerances: tests/test_zerophase.py's.  FIR against scipy 1e-10, IIR
interior 1e-12 and edges 1e-5, SOS interior 1e-12, the narrow filter 1e-4,
complex64 1e-5; against JAX on the same inputs 1e-12 (float64, both
methods; the JAX "parallel" route runs the same math in another order).
"""

import numpy as np
import pytest
import torch
from scipy import signal as sps

from solid_dsp_tpu.ops import zerophase as jzp
from solid_dsp_tpu_torch.ops import cuda_scan, zerophase


def test_fir_matches_scipy_and_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(2048)
    h = sps.firwin(31, 0.2)
    mine = zerophase.filtfilt_fir(h, x, pad=62).numpy()
    ref = sps.filtfilt(h, [1.0], x, padtype="odd", padlen=62)
    np.testing.assert_allclose(mine, ref, atol=1e-10)
    np.testing.assert_allclose(mine, np.asarray(jzp.filtfilt_fir(h, x,
                                                                 pad=62)),
                               atol=1e-12)


@pytest.mark.parametrize("method", ["scan", "parallel"])
def test_iir_matches_scipy_and_jax(method):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(2048)
    b, a = sps.butter(4, 0.25)
    mine = zerophase.filtfilt_iir(b, a, x, method=method).numpy()
    ref = sps.filtfilt(b, a, x, padtype="odd", padlen=120)
    np.testing.assert_allclose(mine[150:-150], ref[150:-150], atol=1e-12)
    np.testing.assert_allclose(mine, ref, atol=1e-5)
    np.testing.assert_allclose(
        mine, np.asarray(jzp.filtfilt_iir(b, a, x, method=method)),
        atol=1e-12)


@pytest.mark.parametrize("method", ["scan", "parallel"])
def test_sos_matches_scipy_and_jax(method):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(2048)
    sos = sps.butter(6, 0.2, output="sos")
    mine = zerophase.filtfilt_sos(sos[:, :3], sos[:, 3:], x,
                                  method=method).numpy()
    ref = sps.sosfiltfilt(sos, x, padtype="odd", padlen=150)
    np.testing.assert_allclose(mine[150:-150], ref[150:-150], atol=1e-12)
    np.testing.assert_allclose(
        mine, np.asarray(jzp.filtfilt_sos(sos[:, :3], sos[:, 3:], x,
                                          method=method)), atol=1e-12)


def test_zero_delay_and_zero_phase():
    n = 1024
    t = np.arange(n)
    env = np.exp(-0.5 * ((t - 512) / 40.0) ** 2)
    x = env * np.cos(2 * np.pi * 0.1 * t)
    b, a = sps.butter(4, [0.05, 0.15], btype="band")
    y = zerophase.filtfilt_iir(b, a, x, method="scan").numpy()
    assert y.shape == x.shape
    assert abs(int(np.argmax(np.abs(sps.hilbert(y)))) - 512) <= 2


def test_narrow_filter_auto_pad_scales():
    b, a = sps.butter(2, 0.005)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(1 << 13) + 1.0
    y = zerophase.filtfilt_iir(b, a, x).numpy()
    ref = sps.filtfilt(b, a, x, padtype="odd",
                       padlen=min(x.size - 1, 12000))
    np.testing.assert_allclose(y, ref, atol=1e-4)


def test_complex_input_and_short_signal():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(1024)
         + 1j * rng.standard_normal(1024)).astype(np.complex64)
    h = sps.firwin(21, 0.3)
    y = zerophase.filtfilt_fir(h, x).numpy()
    ref = sps.filtfilt(h, [1.0], x, padtype="odd", padlen=42)
    np.testing.assert_allclose(y, ref, atol=1e-5)
    with pytest.raises(ValueError):
        zerophase.filtfilt_fir(np.ones(9) / 9.0, np.ones(10))
    with pytest.raises(ValueError, match="pad"):
        zerophase.filtfilt_fir(np.ones(9) / 9.0, np.ones(100), pad=3)


def test_scan_method_takes_the_plain_version_on_the_cpu():
    """filtfilt_sos(method="scan") reaches S3's dispatch once a section a
    pass: on CPU tensors that is the plain version, no launch."""
    before = cuda_scan.iir_scan_cuda.launches
    sos = sps.butter(2, 0.2, output="sos")
    y = zerophase.filtfilt_sos(torch.from_numpy(sos[:, :3]),
                               torch.from_numpy(sos[:, 3:]),
                               torch.ones(200, dtype=torch.float64),
                               method="scan")
    assert y.shape == (200,) and cuda_scan.iir_scan_cuda.launches == before
