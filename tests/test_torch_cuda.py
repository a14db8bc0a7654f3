"""The port's CUDA kernel on the card (marker ``gpu``; skips without one).

Imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX.)  The kernel is held
against the port's plain PyTorch version, itself held against the JAX
package by tests/test_torch_ddc_fm.py and test_torch_rx_chain.py.
Tolerances: audio >= 90 dB (the chain's x3 gate); stats rtol 1e-5 with
atol 1e-6 (FP32 sums in another order); phase word and tail exact.
"""

import numpy as np
import pytest
import torch

from solid_dsp_tpu_torch.models.rx_chain import RxChainConfig
from solid_dsp_tpu_torch.ops import cuda_ddc, nco
from torch_parity import L_SMALL, make_blocks, require_cuda, run_torch, snr_db

pytestmark = pytest.mark.gpu


def _body(device, n=64, M=4, dtype=torch.float32):
    taps = RxChainConfig(fir_taps=n).design_taps()
    return cuda_ddc.make_ddc_fm(taps, nco.constrain(0.2), M, 0.1, device,
                                dtype)


def _inputs(seed, L, D):
    rng = np.random.default_rng(seed)
    x = 0.5 * np.exp(1j * 0.21 * np.arange(L)) + 0.1 * (
        rng.standard_normal(L) + 1j * rng.standard_normal(L))
    x2 = np.stack([x.real, x.imag]).astype(np.float32)
    tail = (0.3 * rng.standard_normal((2, D))).astype(np.float32)
    return torch.from_numpy(x2), torch.from_numpy(tail)


@pytest.mark.parametrize("n,M,L", [(64, 4, L_SMALL), (64, 4, 256 * 5),
                                   (48, 8, 512 * 9), (33, 2, 128 * 77),
                                   (64, 32, 2048 * 3)])
def test_cuda_kernel_matches_plain_on_card(n, M, L):
    """Kernel vs plain version on the card, f32 with TF32 off: all of the
    audio >= 90 dB, stats as in the module docstring, one launch counted."""
    dev = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    body = _body(dev, n=n, M=M)
    x2, tail = (t.to(dev) for t in _inputs(7, L, n - M))
    before = cuda_ddc.ddc_fm_cuda.launches
    a, s = cuda_ddc.ddc_fm_cuda(body, x2, tail)
    b, t = cuda_ddc.ddc_fm_torch(body, x2, tail)
    torch.cuda.synchronize()
    assert cuda_ddc.ddc_fm_cuda.launches == before + 1
    assert a.shape == (L // M,) and bool(torch.isfinite(a).all())
    assert snr_db(a.cpu().numpy(), b.cpu().numpy()) >= 90.0
    np.testing.assert_allclose(s.cpu().numpy(), t.cpu().numpy(), rtol=1e-5,
                               atol=1e-6)


def test_cuda_kernel_matches_plain_float64():
    """Kernel vs the plain version in float64 on the CPU: >= 90 dB."""
    dev = require_cuda()
    x2, tail = _inputs(9, L_SMALL, 60)
    a, _ = cuda_ddc.ddc_fm_cuda(_body(dev), x2.to(dev), tail.to(dev))
    b, _ = cuda_ddc.ddc_fm_torch(_body("cpu", dtype=torch.float64),
                                 x2.double(), tail.double())
    assert snr_db(a.cpu().numpy(), b.numpy()) >= 90.0


def test_cuda_kernel_rejects_float64_and_strided_blocks():
    dev = require_cuda()
    x2, tail = _inputs(8, 1024, 60)
    with pytest.raises(TypeError):
        cuda_ddc.ddc_fm_cuda(_body(dev, dtype=torch.float64),
                             x2.double().to(dev), tail.double().to(dev))
    wide = torch.zeros((2, 2048), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_ddc.ddc_fm_cuda(_body(dev), wide[:, ::2], tail.to(dev))


def test_chain_on_card_matches_cpu_plain_chain():
    """The chain through the kernel (engine 'auto' on a CUDA tensor) vs the
    port's plain chain on the CPU: >= 90 dB, nco_theta and fir_tail equal,
    one launch per block."""
    dev = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    blocks = make_blocks(4, seed=13)
    want, st_cpu = run_torch(blocks)
    before = cuda_ddc.ddc_fm_cuda.launches
    got, st = run_torch(blocks, device=dev)
    assert cuda_ddc.ddc_fm_cuda.launches == before + 4
    assert snr_db(got, want) >= 90.0
    assert int(st["nco_theta"]) == int(st_cpu["nco_theta"])
    assert torch.equal(st["fir_tail"].cpu(), st_cpu["fir_tail"])


def test_engine_torch_on_card_never_launches():
    dev = require_cuda()
    blocks = make_blocks(1, seed=14)
    before = cuda_ddc.ddc_fm_cuda.launches
    run_torch(blocks, device=dev, ddc_engine="torch")
    torch.cuda.synchronize()
    assert cuda_ddc.ddc_fm_cuda.launches == before
