"""The port pins full float32 for its own products, whatever the caller set.

A float32 convolution goes through cuDNN in TF32 by default on the card,
and ``torch.set_float32_matmul_precision("high")`` (or the legacy
``allow_tf32`` flags) turns TF32 on for cuBLAS; TF32 keeps some three
digits, which would break the x3 gates.  Every x3 / "highest" float32
convolution and matmul of the port runs under ``device.fp32_exact``.  Here
a spy on ``torch.nn.functional.conv1d`` and ``torch.matmul`` records both
TF32 flags at each call of each pinned path (on the CPU, where the flags
are only read): every call sees them False after the caller set them
True, and the caller's settings are the same afterwards.  Imports no JAX.
"""

import numpy as np
import pytest
import torch

from solid_dsp_tpu_torch.analysis.spectral import goertzel_bank
from solid_dsp_tpu_torch.device import fp32_exact
from solid_dsp_tpu_torch.models.channelizer import (channelizer_apply_planar,
                                                    channelizer_dft_bank,
                                                    channelizer_taps)
from solid_dsp_tpu_torch.models.rx_chain import RxChainConfig
from solid_dsp_tpu_torch.ops import cuda_chan, cuda_ddc, cuda_fft, ddc, matfft
from solid_dsp_tpu_torch.ops import fft as fft_ops
from solid_dsp_tpu_torch.ops.fir import conv1d_mxu
from solid_dsp_tpu_torch.ops.nco import constrain

CPU = "cpu"


def _noise(seed, *shape, cplx=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if cplx:
        x = x + 1j * rng.standard_normal(shape)
    return torch.from_numpy(x.astype(np.complex64 if cplx else np.float32))


def _ddc_inputs(n=64, M=4, L=256 * 8):
    taps = RxChainConfig(fir_taps=n).design_taps()
    x = _noise(1, L)
    x2 = torch.stack([x.real, x.imag]).contiguous()
    return taps, x2, torch.zeros((2, n - M))


def _conv_complex():
    conv1d_mxu(_noise(2, 300), _noise(3, 17))


def _conv_real():
    conv1d_mxu(_noise(2, 300, cplx=False), _noise(3, 17, cplx=False),
               precision="highest")


def _planar_channelizer():
    M, K = 16, 8
    x = _noise(4, M * 32)
    channelizer_apply_planar(channelizer_taps(M, K), channelizer_dft_bank(M, K),
                             torch.zeros((2, K * M - 1)),
                             torch.stack([x.real, x.imag]), M, precision="x3")


def _matfft():
    matfft.fft_mx(_noise(5, 4, 48), precision="x3")


def _ddc_body():
    taps, x2, tail = _ddc_inputs()
    ddc.ddc_body_torch(cuda_ddc.make_ddc_body(taps, constrain(0.2), 4, CPU),
                       x2, tail)


def _ddc_fm():
    taps, x2, tail = _ddc_inputs()
    cuda_ddc.ddc_fm_torch(cuda_ddc.make_ddc_fm(taps, constrain(0.2), 4, 0.1,
                                               CPU), x2, tail)


def _chan_fused():
    M = 16
    body = cuda_chan.make_chan_body(channelizer_taps(M, 8), M, "x3", CPU)
    cuda_chan.chan_fused_torch(body, _noise(6, 24, M),
                               torch.zeros((2, 8, M)))


def _windowed_fft():
    x = _noise(7, 2, 4096)
    cuda_fft.windowed_fft_plain(x, torch.ones(4096), planar=False)


def _fft_dft_plan():
    fft_ops.fft(_noise(8, 3, 13), backend="plan")


def _goertzel():
    goertzel_bank(_noise(9, 1024), [0.1, 0.2], frame_len=256)


PATHS = {f.__name__.lstrip("_"): f for f in (
    _conv_complex, _conv_real, _planar_channelizer, _matfft, _ddc_body,
    _ddc_fm, _chan_fused, _windowed_fft, _fft_dft_plan, _goertzel)}


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())


@pytest.fixture
def caller_tf32(request):
    """The caller's TF32 settings on, the legacy way or through the global
    matmul precision; PyTorch's defaults restored afterwards."""
    before = _flags()
    if request.param == "legacy":
        torch.backends.cuda.matmul.allow_tf32 = True
    else:
        torch.set_float32_matmul_precision("high")
    torch.backends.cudnn.allow_tf32 = True
    yield request.param
    torch.set_float32_matmul_precision(before[2])
    torch.backends.cudnn.allow_tf32 = before[1]


@pytest.mark.parametrize("caller_tf32", ["legacy", "high"], indirect=True)
@pytest.mark.parametrize("path", sorted(PATHS))
def test_pinned_path_runs_without_tf32(monkeypatch, caller_tf32, path):
    """Both flags False at every conv1d / matmul of the path; the caller's
    flags (both True, precision "high") the same afterwards."""
    seen = []

    def spy(real):
        def call(*args, **kwargs):
            seen.append((torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32))
            return real(*args, **kwargs)
        return call

    monkeypatch.setattr(torch.nn.functional, "conv1d",
                        spy(torch.nn.functional.conv1d))
    monkeypatch.setattr(torch, "matmul", spy(torch.matmul))
    before = _flags()
    assert before == (True, True, "high")
    PATHS[path]()
    assert seen, f"{path} ran no conv1d or matmul"
    assert all(s == (False, False) for s in seen)
    assert _flags() == before


@pytest.mark.parametrize("caller_tf32", ["legacy", "high"], indirect=True)
def test_fp32_exact_nests_and_restores_on_error(caller_tf32):
    """Inner pins keep the flags off; an exception inside still restores
    the caller's settings."""
    before = _flags()
    with pytest.raises(RuntimeError, match="inside"):
        with fp32_exact():
            with fp32_exact():
                assert _flags()[:2] == (False, False)
            assert _flags()[:2] == (False, False)
            raise RuntimeError("inside")
    assert _flags() == before
