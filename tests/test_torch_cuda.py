"""The port's CUDA kernels on the card (marker ``gpu``; skips without one).

Imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX.)  Each kernel is
held against the port's plain PyTorch version, itself held against the JAX
package by tests/test_torch_ddc_fm.py, test_torch_ddc_body.py and
test_torch_rx_chain*.py.  Tolerances: audio and z >= 90 dB (the chain's x3
gate; QPSK 60 dB, BASELINE.json's bound); stats rtol 1e-5 with atol 1e-6
(FP32 sums in another order); phase word and tail exact.
"""

import numpy as np
import pytest
import torch

from solid_dsp_tpu_torch.models.rx_chain import RxChainConfig
from solid_dsp_tpu_torch.ops import cuda_ddc, nco
from torch_parity import (L_SMALL, make_blocks, make_qpsk_blocks,
                          require_cuda, run_torch, snr_db)

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


def _counts():
    return (cuda_ddc.ddc_fm_cuda.launches, cuda_ddc.ddc_body_cuda.launches,
            cuda_ddc.ddc_body_unaligned_cuda.launches)


@pytest.mark.parametrize("demod", ["fm", "am", "qpsk"])
def test_engine_torch_on_card_never_launches(demod):
    dev = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    blocks = make_blocks(1, seed=14)
    before = _counts()
    run_torch(blocks, device=dev, ddc_engine="torch", demod=demod)
    torch.cuda.synchronize()
    assert _counts() == before


def _dbody(device, n=64, M=4):
    taps = RxChainConfig(fir_taps=n).design_taps()
    return cuda_ddc.make_ddc_body(taps, nco.constrain(0.2), M, device)


@pytest.mark.parametrize("n,M,L", [(64, 4, L_SMALL), (64, 4, L_SMALL + 52),
                                   (64, 4, 32), (64, 4, 1000),
                                   (48, 8, 512 * 9 + 8), (33, 2, 128 * 77),
                                   (64, 32, 2048 * 3), (64, 32, 32 * 5)])
def test_body_kernel_matches_plain_on_card(n, M, L):
    """The DDC body kernel vs its plain version on the card: z >= 90 dB,
    counted on K2's route for blocks that are a multiple of 64*M and on
    K3's otherwise (short blocks included)."""
    dev = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    body = _dbody(dev, n=n, M=M)
    x2, tail = (t.to(dev) for t in _inputs(17, L, n - M))
    before = _counts()
    z = body(x2, tail)
    ref = cuda_ddc.ddc_body_torch(body, x2, tail)
    torch.cuda.synchronize()
    aligned = L % (64 * M) == 0
    assert _counts() == (before[0], before[1] + aligned,
                         before[2] + (not aligned))
    assert z.shape == (2, L // M) and bool(torch.isfinite(z).all())
    assert snr_db(z.cpu().numpy(), ref.cpu().numpy()) >= 90.0


@pytest.mark.parametrize("demod,L", [("am", L_SMALL), ("qpsk", L_SMALL),
                                     ("fm", L_SMALL + 52), ("none", 4100)])
def test_body_chains_on_card_match_cpu_plain_chain(demod, L):
    """AM, QPSK, unaligned FM and "none" chains through the body kernel vs
    the port's plain chain on the CPU over 4 blocks: >= 90 dB (QPSK 60),
    nco_theta and fir_tail equal, one body launch per block."""
    dev = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    blocks = (make_qpsk_blocks(4, L=L, seed=15)[0] if demod == "qpsk"
              else make_blocks(4, L=L, seed=15))
    want, st_cpu = run_torch(blocks, demod=demod)
    before = _counts()
    got, st = run_torch(blocks, device=dev, demod=demod)
    aligned = L % 256 == 0
    assert _counts() == (before[0], before[1] + 4 * aligned,
                         before[2] + 4 * (not aligned))
    assert snr_db(got, want) >= (60.0 if demod == "qpsk" else 90.0)
    assert int(st["nco_theta"]) == int(st_cpu["nco_theta"])
    assert torch.equal(st["fir_tail"].cpu(), st_cpu["fir_tail"])
