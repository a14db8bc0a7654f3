"""The port's CUDA kernels on the card (marker ``gpu``; skips without one).

Imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX.)  Each kernel is
held against the port's plain PyTorch version, itself held against the JAX
package by tests/test_torch_ddc_fm.py, test_torch_ddc_body.py,
test_torch_rx_chain*.py, test_torch_channelizer.py and
test_torch_channel_bank.py.  Tolerances: audio and z >= 90 dB (the chain's
x3 gate; QPSK 60 dB, BASELINE.json's bound); stats rtol 1e-5 with atol 1e-6
(FP32 sums in another order); phase word and tail exact.  Channelizer (K4)
x3 >= 90 dB and fast >= 90 dB against the plain version in the same mode
(>= 45 dB against x3, the JAX gate), x3 >= 90 dB against float64, the
complex layout bit-equal to the planar one; front end (K5) atol 2e-5 max|Y|; IIR
bank (K6) atol 3e-5 (tests/test_pallas.py's gates; the narrow cascade's
state relative to its size).  The DDC body (K2/K3) also >= 100 dB against
its plain version in float64.  K1-K3's fast mode (one bf16 pass): K2/K3
z >= 120 dB and K1 audio >= 90 dB against the plain fast versions (the
same roundings, f32 sums in another order), >= 50 dB against float64
(the TPU kernel's ~52 dB).  Windowed FFT (K7)
>= 90 dB against its plain version and float64 numpy; Farrow (K8) within
1e-5 of its plain version with n_valid, t0 and the tail equal
(tests/test_resample.py's gate).  conv1d_mxu and sharded_fir >= 100 dB
against float64 at PyTorch's default TF32 flags (the port pins full
float32; TF32 keeps some 60 dB).  The sequential scans: S1 (the exact
AGC) within 1e-5 of max|y| of its plain version in float32 and 1e-12 in
float64, gain rtol alike, mode and timer equal; S1's FSM entry (the
chunk-and-join kernel) bit-equal to the sequential walk and to its
chunked plain version; S2 (the Costas loop)
symbols equal and y within 1e-4 (float32) or 1e-9 (float64); S3 (the
IIR w-recurrence) bit-equal to its plain version in every type, and the
IIR classes and zero-phase filters on the card within 1e-5 of max (float32
"scan" is S3, bit-equal to the CPU's plain version only up to the b taps'
convolution, which cuDNN sums in another order) or 1e-12 (float64) of the
CPU's.
"""

import numpy as np
import pytest
import torch

from solid_dsp_tpu_torch.models.channel_bank import (ChannelBank,
                                                     design_channel_sos)
from solid_dsp_tpu_torch.models.channelizer import (PolyphaseChannelizer,
                                                    channelizer_taps)
from solid_dsp_tpu_torch.models.rx_chain import RxChainConfig
from solid_dsp_tpu_torch.design.windows import get_window
from solid_dsp_tpu_torch.models import qpsk as qpsk_ops
from solid_dsp_tpu_torch.ops import agc as agc_ops
from solid_dsp_tpu_torch.ops import ddc as ddc_ops
from solid_dsp_tpu_torch.ops import (cuda_chan, cuda_ddc, cuda_fft, cuda_iir,
                                     cuda_resample, cuda_scan, farrow, iir,
                                     linrec, nco, zerophase)
from solid_dsp_tpu_torch.ops import fir as fir_ops
from solid_dsp_tpu_torch.ops import fft as fft_ops
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


K1_GEOMETRIES = [(64, 4, L_SMALL), (64, 4, 256 * 5), (48, 8, 512 * 9),
                 (33, 2, 128 * 77), (64, 32, 2048 * 3)]


@pytest.mark.parametrize("n,M,L", K1_GEOMETRIES)
def test_cuda_kernel_matches_plain_on_card(n, M, L):
    """Kernel vs plain version on the card, f32 with TF32 off: all of the
    audio >= 90 dB, stats as in the module docstring, one launch counted
    on the tensor-core route."""
    dev = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    body = _body(dev, n=n, M=M)
    x2, tail = (t.to(dev) for t in _inputs(7, L, n - M))
    before = cuda_ddc.ddc_fm_cuda.launches
    direct = cuda_ddc.ddc_fm_cuda.direct_launches
    a, s = cuda_ddc.ddc_fm_cuda(body, x2, tail)
    b, t = cuda_ddc.ddc_fm_torch(body, x2, tail)
    torch.cuda.synchronize()
    assert cuda_ddc.ddc_fm_cuda.launches == before + 1
    assert cuda_ddc.ddc_fm_cuda.direct_launches == direct
    assert a.shape == (L // M,) and bool(torch.isfinite(a).all())
    assert snr_db(a.cpu().numpy(), b.cpu().numpy()) >= 90.0
    np.testing.assert_allclose(s.cpu().numpy(), t.cpu().numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("n,M,L", K1_GEOMETRIES)
def test_cuda_kernel_matches_float64_at_each_geometry(n, M, L):
    """The tensor-core route vs the plain version in float64 on the CPU:
    audio >= 90 dB, the energy within 1e-5 and z[0], z[T-1] within 1e-4."""
    dev = require_cuda()
    x2, tail = _inputs(10, L, n - M)
    a, s = cuda_ddc.ddc_fm_cuda(_body(dev, n=n, M=M), x2.to(dev), tail.to(dev))
    b, t = cuda_ddc.ddc_fm_torch(_body("cpu", n=n, M=M, dtype=torch.float64),
                                 x2.double(), tail.double())
    assert snr_db(a.cpu().numpy(), b.numpy()) >= 90.0
    got, want = s.cpu().double().numpy(), t.numpy()
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1:], want[1:], rtol=0, atol=1e-4)


@pytest.mark.parametrize("n,M,L", [(200, 128, 8192 * 8), (129, 128, 256 * 128)])
def test_cuda_kernel_large_decimation_takes_direct_route(n, M, L):
    """Where the tensor-core spans do not fit, the route chosen from (n, M)
    is the direct-form kernel, counted on its own counter: against the
    plain version >= 90 dB, stats as above."""
    dev = require_cuda()
    assert cuda_ddc.fm_geometry(n, M)[0] == "direct"
    body = _body(dev, n=n, M=M)
    x2, tail = (t.to(dev) for t in _inputs(11, L, n - M))
    before = (cuda_ddc.ddc_fm_cuda.launches,
              cuda_ddc.ddc_fm_cuda.direct_launches)
    a, s = cuda_ddc.ddc_fm_cuda(body, x2, tail)
    b, t = cuda_ddc.ddc_fm_torch(body, x2, tail)
    torch.cuda.synchronize()
    assert (cuda_ddc.ddc_fm_cuda.launches,
            cuda_ddc.ddc_fm_cuda.direct_launches) == (before[0], before[1] + 1)
    assert snr_db(a.cpu().numpy(), b.cpu().numpy()) >= 90.0
    np.testing.assert_allclose(s.cpu().numpy(), t.cpu().numpy(), rtol=1e-5,
                               atol=1e-6)


def test_cuda_kernel_every_direct_form_geometry_runs():
    """Every (n, M) the direct-form kernel accepts runs through a kernel of
    its route, >= 90 dB against the plain version."""
    dev = require_cuda()
    for n, M in ((2, 1), (65, 64), (96, 3), (97, 96), (300, 112), (40, 5),
                 (1024, 16), (64, 12)):
        assert cuda_ddc.fm_supported(n, M)
        cuda_ddc.launch_geometry(n, M)
        L = 64 * M * 7
        x2, tail = (t.to(dev) for t in _inputs(12, L, n - M))
        body = _body(dev, n=n, M=M)
        a, _ = cuda_ddc.ddc_fm_cuda(body, x2, tail)
        b, _ = cuda_ddc.ddc_fm_torch(body, x2, tail)
        assert snr_db(a.cpu().numpy(), b.cpu().numpy()) >= 90.0, (n, M)


def test_cuda_kernel_runs_are_bit_equal_also_in_a_graph():
    """The stats are summed in a fixed order: two launches on one block
    give equal audio and stats, and so do replays of a CUDA graph of two
    launches (the ticket is left zero by every launch)."""
    dev = require_cuda()
    body = _body(dev)
    x2, tail = (t.to(dev) for t in _inputs(13, L_SMALL, 60))
    a1, s1 = cuda_ddc.ddc_fm_cuda(body, x2, tail)
    a2, s2 = cuda_ddc.ddc_fm_cuda(body, x2, tail)
    torch.cuda.synchronize()
    assert torch.equal(a1, a2) and torch.equal(s1, s2)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        outs = [cuda_ddc.ddc_fm_cuda(body, x2, tail) for _ in range(2)]
    for _ in range(3):
        g.replay()
        torch.cuda.synchronize()
        for a, s in outs:
            assert torch.equal(a, a1) and torch.equal(s, s1)


def test_chain_on_card_never_takes_the_plain_k1(monkeypatch):
    """The FM chain on a CUDA block goes through the kernel: the plain
    version is never called unless engine="torch" asks for it."""
    dev = require_cuda()

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA block reached ddc_fm_torch")

    monkeypatch.setattr(cuda_ddc, "ddc_fm_torch", refuse)
    before = cuda_ddc.ddc_fm_cuda.launches
    run_torch(make_blocks(2, seed=15), device=dev)
    assert cuda_ddc.ddc_fm_cuda.launches == before + 2


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
                                   (33, 2, 128 * 77 + 2),
                                   (64, 32, 2048 * 3), (64, 32, 32 * 5)])
def test_body_kernel_matches_plain_on_card(n, M, L):
    """The DDC body kernel (TF32 x3 on the tensor cores) vs its plain
    version on the card: z >= 90 dB, and >= 100 dB against the plain
    version in float64 on the CPU (the chain's "highest" contract); counted
    on K2's route for blocks that are a multiple of 64*M and on K3's
    otherwise (short blocks included; L = 128 * 77 + 2 puts the imaginary
    plane off a 16-byte boundary, the kernel's 4-byte path)."""
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
    taps = RxChainConfig(fir_taps=n).design_taps()
    body64 = cuda_ddc.make_ddc_body(taps, nco.constrain(0.2), M, "cpu",
                                    torch.float64)
    ref64 = cuda_ddc.ddc_body_torch(body64, x2.cpu().double(),
                                    tail.cpu().double())
    assert snr_db(z.cpu().numpy(), ref64.numpy()) >= 100.0


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


def _fast_counts():
    return (cuda_ddc.ddc_fm_cuda.fast_launches,
            cuda_ddc.ddc_body_cuda.fast_launches,
            cuda_ddc.ddc_body_unaligned_cuda.fast_launches)


def _fast(device, n=64, M=4, fm=False):
    taps = RxChainConfig(fir_taps=n).design_taps()
    if fm:
        return cuda_ddc.make_ddc_fm(taps, nco.constrain(0.2), M, 0.1, device,
                                    mode="fast")
    return cuda_ddc.make_ddc_body(taps, nco.constrain(0.2), M, device,
                                  mode="fast")


@pytest.mark.parametrize("n,M,L", [(64, 4, L_SMALL), (64, 4, L_SMALL + 52),
                                   (64, 4, 32), (48, 8, 512 * 9 + 8),
                                   (33, 2, 128 * 77 + 2), (64, 32, 2048 * 3),
                                   (4, 4, 4096), (3, 4, 4096 + 8)])
def test_body_fast_kernel_matches_plain_on_card(n, M, L):
    """K2/K3's fast mode (one bf16 wgmma a 16-sample k-step, f32 sums) vs
    its plain fast version on the card: z >= 120 dB (the same roundings,
    f32 sums in another order), >= 50 dB against float64, two launches
    bit-equal, counted on its route's fast counter only (n <= M: K3's
    route)."""
    dev = require_cuda()
    body = _fast(dev, n, M)
    x2, tail = (t.to(dev) for t in _inputs(19, L, max(n - M, 0)))
    before, x3 = _fast_counts(), _counts()
    z = body(x2, tail)
    z2 = body(x2, tail)
    ref = cuda_ddc.ddc_body_torch(body, x2, tail)
    torch.cuda.synchronize()
    k2 = L % (64 * M) == 0 and n > M
    assert _fast_counts() == (before[0], before[1] + 2 * k2,
                              before[2] + 2 * (not k2))
    assert _counts() == x3 and torch.equal(z, z2)
    assert z.shape == (2, L // M) and bool(torch.isfinite(z).all())
    assert snr_db(z.cpu().numpy(), ref.cpu().numpy()) >= 120.0
    taps = RxChainConfig(fir_taps=n).design_taps()
    body64 = cuda_ddc.make_ddc_body(taps, nco.constrain(0.2), M, "cpu",
                                    torch.float64)
    ref64 = cuda_ddc.ddc_body_torch(body64, x2.cpu().double(),
                                    tail.cpu().double())
    assert snr_db(z.cpu().numpy(), ref64.numpy()) >= 50.0


@pytest.mark.parametrize("n,M,L", K1_GEOMETRIES + [(64, 4, 256 * 4096)])
def test_fm_fast_kernel_matches_plain_on_card(n, M, L):
    """K1's fast mode vs its plain fast version on the card: audio >= 90
    dB, stats rtol 1e-5 (atol 1e-6), two launches bit-equal, counted on
    ``fast_launches``; at L = 256 * 4096 the block holds four TPU tiles of
    1024 frames, whose seams stay f32 on both sides."""
    dev = require_cuda()
    body = _fast(dev, n, M, fm=True)
    x2, tail = (t.to(dev) for t in _inputs(21, L, n - M))
    before, x3 = _fast_counts(), _counts()
    a, s = cuda_ddc.ddc_fm_cuda(body, x2, tail)
    a2, s2 = cuda_ddc.ddc_fm_cuda(body, x2, tail)
    b, t = cuda_ddc.ddc_fm_torch(body, x2, tail)
    torch.cuda.synchronize()
    assert _fast_counts() == (before[0] + 2, before[1], before[2])
    assert _counts() == x3
    assert torch.equal(a, a2) and torch.equal(s, s2)
    assert a.shape == (L // M,) and bool(torch.isfinite(a).all())
    assert snr_db(a.cpu().numpy(), b.cpu().numpy()) >= 90.0
    np.testing.assert_allclose(s.cpu().numpy(), t.cpu().numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("n,M,L", [(200, 128, 8192 * 8 * 64),
                                   (129, 128, 256 * 128)])
def test_fm_fast_direct_route_matches_plain_on_card(n, M, L):
    """K1's direct route in fast mode (samples and taps rounded to bf16
    before each FMA, the TPU tiles' seams f32): >= 90 dB against the plain
    fast version, counted on ``direct_fast_launches``."""
    dev = require_cuda()
    assert cuda_ddc.fm_geometry(n, M, True)[0] == "direct"
    body = _fast(dev, n, M, fm=True)
    x2, tail = (t.to(dev) for t in _inputs(23, L, n - M))
    before = cuda_ddc.ddc_fm_cuda.direct_fast_launches
    a, s = cuda_ddc.ddc_fm_cuda(body, x2, tail)
    b, t = cuda_ddc.ddc_fm_torch(body, x2, tail)
    torch.cuda.synchronize()
    assert cuda_ddc.ddc_fm_cuda.direct_fast_launches == before + 1
    assert snr_db(a.cpu().numpy(), b.cpu().numpy()) >= 90.0
    np.testing.assert_allclose(s.cpu().numpy(), t.cpu().numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("override", [
    dict(fir_precision="default"),
    dict(fir_precision="default", demod="am"),
    dict(fir_precision="default", demod="qpsk"),
    dict(fir_precision="default", L=L_SMALL + 52),
    dict(fir_precision="default", fir_taps=4),
    dict(fir_taps=300, demod="am"),
    dict(dtype=torch.complex128, fir_precision="default")])
def test_default_chains_on_card_match_cpu(override):
    """make_rx_chain at fir_precision="default", n <= M, 300 taps and
    complex128 on the card vs device="cpu" over 4 blocks: >= 90 dB (QPSK
    60; complex128 and 300 taps, the plain body on both, >= 100 dB),
    nco_theta and fir_tail equal; the fast kernels of the JAX package's
    routing launched once a block, and no kernel where it runs XLA."""
    dev = require_cuda()
    o = dict(override)
    L = o.pop("L", L_SMALL)
    demod = o.get("demod", "fm")
    blocks = (make_qpsk_blocks(4, L=L, seed=25)[0] if demod == "qpsk"
              else make_blocks(4, L=L, seed=25))
    if o.get("dtype") == torch.complex128:
        blocks = [b.astype(np.float64) for b in blocks]
    want, st_cpu = run_torch(blocks, **o)
    before, x3 = _fast_counts(), _counts()
    got, st = run_torch(blocks, device=dev, **o)
    torch.cuda.synchronize()
    fast = tuple(a - b for a, b in zip(_fast_counts(), before))
    if o.get("fir_precision") != "default" or "dtype" in o:
        assert fast == (0, 0, 0)
    elif demod == "fm" and L % 256 == 0 and "fir_taps" not in o:
        assert fast == (4, 0, 0)
    elif L % 256 == 0 and "fir_taps" not in o:
        assert fast == (0, 4, 0)
    else:
        assert fast == (0, 0, 4)
    assert _counts() == x3          # no x3 launch on any of these routes
    gate = (60.0 if demod == "qpsk" else
            100.0 if "dtype" in o or o.get("fir_taps") == 300 else 90.0)
    assert snr_db(got, want) >= gate
    assert int(st["nco_theta"]) == int(st_cpu["nco_theta"])
    assert torch.equal(st["fir_tail"].cpu(), st_cpu["fir_tail"])


def _chan_counts():
    return (cuda_chan.chan_fused_cuda.launches,
            cuda_chan.pfb_frontend_cuda.launches,
            cuda_iir.iir_bank_cuda.launches)


def _cnoise(seed, *shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


@pytest.mark.parametrize("M,U", [(8, 40), (12, 21), (16, 64), (48, 72),
                                 (64, 200), (256, 16384), (256, 1000),
                                 (1024, 300), (13, 50)])
@pytest.mark.parametrize("mode", ["x3", "fast"])
def test_chan_fused_kernel_matches_plain_on_card(M, U, mode):
    """K4 vs its plain version on the card, same mode, at the flags'
    defaults (the plain version pins full float32): >= 90 dB; x3 >= 90 dB
    against the plain version in float64 on the CPU, fast >= 45 dB against
    the x3 plain version; the complex layout bit-equal to the planar one;
    one launch each.  M = 13 takes the kernel's path for rows that are not
    16-byte aligned (plain loads, direct stores)."""
    dev = require_cuda()
    body = cuda_chan.make_chan_body(channelizer_taps(M, 8), M, mode, dev)
    rng = np.random.default_rng(M + U)
    xf = torch.from_numpy(rng.standard_normal((2, U, M)).astype(np.float32)
                          ).to(dev)
    xc = torch.complex(xf[0], xf[1]).contiguous()
    tail = torch.from_numpy(rng.standard_normal((2, 8, M)).astype(np.float32)
                            ).to(dev)
    before = _chan_counts()
    cplx_before = cuda_chan.chan_fused_cuda.complex_launches
    got = body(xf, tail)
    gotc = body(xc, tail)
    want = cuda_chan.chan_fused_torch(body, xf, tail)
    torch.cuda.synchronize()
    assert _chan_counts() == (before[0] + 2, before[1], before[2])
    assert cuda_chan.chan_fused_cuda.complex_launches == cplx_before + 1
    assert got.shape == (U, 2 * M) and bool(torch.isfinite(got).all())
    assert gotc.shape == (U, M) and gotc.dtype == torch.complex64
    assert torch.equal(gotc.real, got[:, :M])
    assert torch.equal(gotc.imag, got[:, M:])
    assert snr_db(got.cpu().numpy(), want.cpu().numpy()) >= 90.0
    ref = cuda_chan.chan_fused_torch(
        cuda_chan.make_chan_body(channelizer_taps(M, 8), M, "x3", "cpu",
                                 torch.float64),
        xf.cpu().double(), tail.cpu().double())
    assert snr_db(got.cpu().numpy(), ref.numpy()) >= (
        90.0 if mode == "x3" else 45.0)


@pytest.mark.parametrize("M,K,U", [(16, 8, 300), (64, 4, 300), (8, 7, 300),
                                   (256, 8, 16384), (16, 8, 3), (16, 12, 300)])
def test_pfb_frontend_kernel_matches_plain_on_card(M, K, U):
    """K5 vs its plain version: channels within 2e-5 max|Y|; the new tail
    rows equal; one launch."""
    dev = require_cuda()
    h_il = torch.from_numpy(cuda_chan.pfb_frontend_taps(
        channelizer_taps(M, K), M)).to(dev)
    x = torch.from_numpy(_cnoise(U, U * M)).to(dev)
    tail = torch.from_numpy(_cnoise(K, K, M)).to(dev)
    before = _chan_counts()
    Y, t1 = cuda_chan.channelizer_apply_pallas(h_il, tail, x, M, K)
    Yp, t2 = cuda_chan.channelizer_apply_pallas(h_il, tail, x, M, K,
                                                engine="torch")
    torch.cuda.synchronize()
    assert _chan_counts() == (before[0], before[1] + 1, before[2])
    Y, Yp = Y.cpu().numpy(), Yp.cpu().numpy()
    np.testing.assert_allclose(Y, Yp, rtol=0, atol=2e-5 * np.abs(Yp).max())
    assert torch.equal(t1, t2)


LC = cuda_iir.IIR_CHUNK


@pytest.mark.parametrize("C,T,kind,S", [
    (16, 300, "shared", 2), (8, 250, "per_channel", 2),
    (256, 16384, "shared", 2), (256, 16384, "per_channel", 2),
    (3, 1, "shared", 2), (256, 16384, "narrow", 2), (64, LC - 1, "narrow", 2),
    (64, LC + 1, "narrow", 2), (256, 1, "shared", 1),
    (256, LC - 1, "shared", 1), (256, LC + 1, "shared", 1),
    (256, 16384, "shared", 1), (256, 1, "shared", 8),
    (256, LC - 1, "shared", 8), (256, LC + 1, "shared", 8),
    (256, 16384, "shared", 8)])
def test_iir_bank_kernel_matches_plain_on_card(C, T, kind, S):
    """K6 (chunks of IIR_CHUNK rows joined through the tables) vs its plain
    version over two blocks with the state carried: atol 3e-5 on the
    outputs and the state, one launch per block.  The narrow cascade
    (design_channel_sos(0.005)) carries a state of some 270, where one
    float32 ulp is 3e-5 and the plain version is itself 2e-3 from float64:
    its state is held at 3e-5 relative to max|state|
    (tests/test_torch_iir_chunks.py)."""
    dev = require_cuda()
    if kind == "per_channel":
        sos = np.stack([design_channel_sos(0.1 + 0.3 * c / C, 2 * S)
                        for c in range(C)], axis=-1)
    else:
        sos = design_channel_sos(0.005 if kind == "narrow" else 0.2, 2 * S)
    x = torch.from_numpy(_cnoise(C + T, 2 * T, C)).to(dev)
    st_k = st_p = cuda_iir.iir_bank_init(S, C, dev)
    before = _chan_counts()
    outs_k, outs_p = [], []
    for blk in (x[:T], x[T:]):
        yk, st_k = cuda_iir.iir_bank_apply(sos, st_k, blk.contiguous())
        yp, st_p = cuda_iir.iir_bank_apply(sos, st_p, blk.contiguous(),
                                           engine="torch")
        outs_k.append(yk)
        outs_p.append(yp)
    torch.cuda.synchronize()
    assert _chan_counts() == (before[0], before[1], before[2] + 2)
    np.testing.assert_allclose(torch.cat(outs_k).cpu().numpy(),
                               torch.cat(outs_p).cpu().numpy(), rtol=0,
                               atol=3e-5)
    scale = max(1.0, float(st_p.abs().max())) if kind == "narrow" else 1.0
    np.testing.assert_allclose(st_k.cpu().numpy(), st_p.cpu().numpy(),
                               rtol=0, atol=3e-5 * scale)


def test_iir_bank_kernel_rejects_too_many_sections():
    dev = require_cuda()
    x = torch.zeros((8, 4), dtype=torch.complex64, device=dev)
    sos = np.tile(design_channel_sos(0.2)[:1], (9, 1))
    with pytest.raises(ValueError, match="sections"):
        cuda_iir.iir_bank_apply(sos, cuda_iir.iir_bank_init(9, 4, dev), x)


@pytest.mark.parametrize("backend", ["fused", "pallas"])
def test_channelizer_default_device_runs_kernels(backend):
    """PolyphaseChannelizer with no device runs on the card through its
    kernel and matches the same class on the CPU: >= 90 dB over 2 blocks."""
    require_cuda()
    M = 64
    x = _cnoise(5, 2 * 8 * M * 8)
    ch = PolyphaseChannelizer(M, 8, backend=backend)
    assert ch.device.type == "cuda"
    cpu = PolyphaseChannelizer(M, 8, backend=backend, device="cpu")
    before = _chan_counts()
    half = x.size // 2
    got = torch.cat([ch.execute_block(x[:half]), ch.execute_block(x[half:])])
    want = torch.cat([cpu.execute_block(x[:half]),
                      cpu.execute_block(x[half:])])
    after = _chan_counts()
    assert after[0] - before[0] == (2 if backend == "fused" else 0)
    assert after[1] - before[1] == (2 if backend == "pallas" else 0)
    assert snr_db(got.cpu().numpy(), want.numpy()) >= 90.0


@pytest.mark.parametrize("squelch", [None, -10.0])
def test_channel_bank_on_card_matches_cpu(squelch):
    """ChannelBank (fused) on the card vs on the CPU over 3 blocks: >= 90
    dB, gate masks equal, K4 and K6 launched once a block."""
    dev = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    M = 16
    x = 0.3 * _cnoise(6, 3 * 64 * M)
    x += np.exp(2j * np.pi * 3 / M * np.arange(x.size)).astype(np.complex64)
    kw = dict(backend="fused", agc_bandwidth=0.05, squelch_high_db=squelch)
    bk = ChannelBank(M, device=dev, **kw)
    bp = ChannelBank(M, device="cpu", **kw)
    before = _chan_counts()
    for blk in np.split(x, 3):
        yk, yp = bk.execute_block(blk), bp.execute_block(blk)
        assert snr_db(yk.cpu().numpy(), yp.numpy()) >= 90.0
        if squelch is not None:
            assert torch.equal(bk.last_gate.cpu(), bp.last_gate)
    after = _chan_counts()
    assert (after[0] - before[0], after[2] - before[2]) == (3, 3)


def _fft_counts():
    return (cuda_fft.windowed_fft_cuda.launches,
            cuda_resample.farrow_grid_cuda.launches)


@pytest.mark.parametrize("F", [1, 7, 8, 64, 131, 133, 4096, 4101])
@pytest.mark.parametrize("window", ["hamming", "blackman_harris"])
@pytest.mark.parametrize("sign", [-1, 1])
def test_windowed_fft_kernel_matches_plain_on_card(F, window, sign):
    """K7 vs its plain version on the card, both layouts, at the flags'
    defaults: >= 90 dB, and >= 90 dB against numpy's float64 transform of
    the windowed frames; the two layouts give the same spectra; one launch
    each.  F covers the persistent blocks' edges (fewer frames than blocks,
    one more than a round)."""
    dev = require_cuda()
    w = get_window(window, 4096)
    x = torch.from_numpy(_cnoise(F + 1, F, 4096)).to(dev)
    x2 = torch.stack([x.real, x.imag]).contiguous()
    before = _fft_counts()
    yc = cuda_fft.windowed_fft_frames(x, w, sign, planar=False)
    yp = cuda_fft.windowed_fft_frames(x2, w, sign, planar=True)
    ref = cuda_fft.windowed_fft_frames(x2, w, sign, planar=True,
                                       engine="torch")
    torch.cuda.synchronize()
    assert _fft_counts() == (before[0] + 2, before[1])
    assert yp.shape == (F, 8192) and yc.shape == (F, 4096)
    assert snr_db(yp.cpu().numpy(), ref.cpu().numpy()) >= 90.0
    assert torch.equal(yp[:, :4096], yc.real) and torch.equal(yp[:, 4096:],
                                                              yc.imag)
    xw = x.cpu().numpy().astype(np.complex128) * w
    want = np.fft.fft(xw) if sign < 0 else np.fft.ifft(xw) * 4096
    assert snr_db(yc.cpu().numpy(), want) >= 90.0


def test_windowed_fft_kernel_rejects_misaligned_frames():
    """The kernel's bulk copies need 16-byte-aligned frames: a view 8 bytes
    off raises in windowed_fft_cuda; windowed_fft_frames copies it to an
    aligned tensor and gives the same spectra as the aligned frames."""
    dev = require_cuda()
    w = get_window("hamming", 4096)
    base = torch.from_numpy(_cnoise(5, 3 * 4096 + 1)).to(dev)
    x = base[1:].reshape(3, 4096)
    assert x.data_ptr() % 16 == 8
    wt, tw = cuda_fft._tables(np.asarray(w, np.float32).tobytes(), -1, dev)
    with pytest.raises(ValueError, match="aligned"):
        cuda_fft.windowed_fft_cuda(x, wt, tw, planar=False)
    got = cuda_fft.windowed_fft_frames(x, w, planar=False)
    want = cuda_fft.windowed_fft_frames(x.clone(), w, planar=False)
    assert torch.equal(got, want)


def test_windowed_fft_kernel_matches_float64():
    """K7 vs numpy's float64 FFT of the windowed frames: >= 90 dB."""
    dev = require_cuda()
    w = get_window("blackman_harris", 4096)
    x = _cnoise(3, 64, 4096)
    got = cuda_fft.windowed_fft_frames(torch.from_numpy(x).to(dev), w,
                                       planar=False).cpu().numpy()
    assert snr_db(got, np.fft.fft(x.astype(np.complex128) * w)) >= 90.0


def test_windowed_fft_auto_routes_cuda_frames_through_kernel():
    """windowed_fft(auto) on fusable CUDA frames launches K7 once; a
    1000-point frame takes torch.fft; 'xla' never launches."""
    dev = require_cuda()
    x = torch.from_numpy(_cnoise(4, 16, 4096)).to(dev)
    before = _fft_counts()[0]
    a = fft_ops.windowed_fft(x, "hamming")
    assert _fft_counts()[0] == before + 1
    b = fft_ops.windowed_fft(x, "hamming", backend="xla")
    fft_ops.windowed_fft(x[:, :1000], "hamming")
    assert _fft_counts()[0] == before + 1
    assert snr_db(a.cpu().numpy(), b.cpu().numpy()) >= 90.0


@pytest.mark.parametrize("ratio,L", [(48000 / 44100, 8192), (1 / 16, 1000),
                                     (32.0, 4096), (1.0, 3), (0.73, 1 << 16)])
def test_farrow_kernel_matches_plain_on_card(ratio, L):
    """K8 vs its plain version over 3 blocks with the state carried:
    n_valid and t0 equal, outputs within 1e-5, tails equal; one launch a
    block."""
    dev = require_cuda()
    x = torch.from_numpy(_cnoise(L, 3 * L)).to(dev)
    init_k, apply_k, plan = cuda_resample.make_farrow_kernel_resampler(
        ratio, L, device=dev)
    init_p, apply_p, _ = farrow.make_farrow_resampler(ratio, L, device=dev)
    sk, sp = init_k(), init_p()
    before = _fft_counts()
    for b in range(3):
        blk = x[b * L:(b + 1) * L]
        yk, nk, sk = apply_k(sk, blk)
        yp, npl, sp = apply_p(sp, blk)
        assert int(nk) == int(npl) and int(sk[1]) == int(sp[1])
        assert torch.equal(sk[0], sp[0])
        np.testing.assert_allclose(yk.cpu().numpy(), yp.cpu().numpy(),
                                   rtol=0, atol=1e-5)
    assert _fft_counts() == (before[0], before[1] + 3)


# ------------------------------------------------- parallel/ and K9 on a card

M9, K9 = 64, 8


@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """A (1, 1) mesh on an NCCL group of this one process, on the card."""
    require_cuda()
    import torch.distributed as dist

    from solid_dsp_tpu_torch import parallel
    parallel.init_distributed(
        None, str(tmp_path_factory.mktemp("nccl") / "store"), 0, 1)
    try:
        yield parallel.make_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def _k9_inputs(seed, L, n_blocks):
    rng = np.random.default_rng(seed)
    x = [_cnoise(seed + b, L) for b in range(n_blocks)]
    tail = (rng.standard_normal((K9, M9))
            + 1j * rng.standard_normal((K9, M9))).astype(np.complex64)
    return x, tail


def _h_il(dev, M=M9, K=K9):
    return torch.from_numpy(cuda_chan.pfb_frontend_taps(
        channelizer_taps(M, K), M)).to(dev)


@pytest.mark.parametrize("L", [M9 * 9, M9 * 1000, M9 * 4096])
def test_k9_world_one_matches_plain_and_k5(nccl_mesh, L):
    """make_fused_channelizer_frontend at world size 1, 3 blocks with the
    tail carried: one K9 launch a block, z bit-equal to K5 on the same
    blocks and within 2e-5 max|Y| of the plain version, tails bit-equal."""
    from solid_dsp_tpu_torch.ops import cuda_halo
    from solid_dsp_tpu_torch.parallel.pallas_halo import (
        make_fused_channelizer_frontend)
    dev = require_cuda()
    xs, tail = _k9_inputs(21, L, 3)
    k9 = make_fused_channelizer_frontend(nccl_mesh, M9, K9)
    plain = make_fused_channelizer_frontend(nccl_mesh, M9, K9,
                                            engine="torch")
    h = _h_il(dev)
    tk = tp = t5 = torch.from_numpy(tail).to(dev)
    before = cuda_halo.halo_frontend_cuda.launches
    for x in xs:
        x = torch.from_numpy(x).to(dev)
        zk, tk = k9(tk, x)
        zp, tp = plain(tp, x)
        z5, t5 = cuda_chan.pfb_frontend(x, h, t5, M9, K9)
        assert torch.equal(zk, z5)
        lim = 2e-5 * float(torch.fft.fft(zp, dim=-1).abs().max())
        assert float((torch.fft.fft(zk, dim=-1)
                      - torch.fft.fft(zp, dim=-1)).abs().max()) <= lim
        assert torch.equal(tk, tp) and torch.equal(tk, t5)
    assert cuda_halo.halo_frontend_cuda.launches == before + 3


@pytest.mark.parametrize("order", [(0, 1, 2, 3), (3, 2, 1, 0)])
def test_k9_four_shards_on_one_card(order):
    """Four shards on four streams of one card, launched in both orders,
    3 blocks: the shards' z concatenated equals K5 on the whole block bit
    for bit.  A hang fails after 60 s instead of blocking."""
    import time

    from solid_dsp_tpu_torch.ops import cuda_halo
    dev = require_cuda()
    L = M9 * 512
    xs, tail = _k9_inputs(22, 4 * L, 3)
    h = _h_il(dev)
    ring = cuda_halo.local_ring(4, M9, K9, dev)
    streams = [torch.cuda.Stream(dev) for _ in ring]
    full = [torch.from_numpy(x).to(dev) for x in xs]
    t = torch.from_numpy(tail).to(dev)
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = []
    for b, x in enumerate(full):
        zs = [None] * 4
        for i in order:
            with torch.cuda.stream(streams[i]):
                zs[i] = cuda_halo.halo_frontend_cuda(
                    x[i * L:(i + 1) * L], t, h, M9, K9, ring[i], b + 1)
        outs.append(zs)
        t = x[-K9 * M9:].reshape(K9, M9)
    events = []
    for s in streams:
        e = torch.cuda.Event()
        e.record(s)
        events.append(e)
    deadline = time.monotonic() + 60.0
    while not all(e.query() for e in events):
        assert time.monotonic() < deadline, "K9's shards hang"
        time.sleep(0.01)
    t5 = torch.from_numpy(tail).to(dev)
    for x, zs in zip(full, outs):
        z5, t5 = cuda_chan.pfb_frontend(x, h, t5, M9, K9)
        assert torch.equal(torch.cat(zs), z5)


def test_k9_across_processes_through_ipc(tmp_path):
    """Two processes on one card, halos through CUDA IPC handles exchanged
    over a gloo group: 3 blocks, the two slabs' z equal K5 on the whole
    block."""
    import torch_dist
    dev = require_cuda()
    L = M9 * 256
    xs, tail = _k9_inputs(23, 2 * L, 3)
    res = torch_dist.run_ranks(tmp_path, 2, [(
        "ipc", (1, 2), "k9_ipc", dict(M=M9, K=K9, blocks=xs, tail=tail))])
    h = _h_il(dev)
    t5 = torch.from_numpy(tail).to(dev)
    for b, x in enumerate(xs):
        z5, t5 = cuda_chan.pfb_frontend(torch.from_numpy(x).to(dev), h, t5,
                                        M9, K9)
        got = np.concatenate([r["ipc"][b] for r in res])
        np.testing.assert_array_equal(got, z5.cpu().numpy())


def test_k9_rejects_cpu_and_mismatched_blocks():
    from solid_dsp_tpu_torch.ops import cuda_halo
    dev = require_cuda()
    link, = cuda_halo.local_ring(1, M9, K9, dev)
    x = torch.zeros(M9 * 16, dtype=torch.complex64)
    t = torch.zeros((K9, M9), dtype=torch.complex64)
    h = _h_il("cpu")
    with pytest.raises(ValueError, match="card"):
        cuda_halo.halo_frontend_cuda(x, t, h, M9, K9, link, 1)
    with pytest.raises(ValueError, match="link built"):
        cuda_halo.halo_frontend_cuda(x[:32 * 16], t[:, :32], h[:, :64], 32,
                                     K9, link, 1)
    with pytest.raises(ValueError, match="exceed"):
        cuda_halo.halo_frontend_cuda(x[:M9 * K9].to(dev), t.to(dev),
                                     h.to(dev), M9, K9, link, 1)


@pytest.mark.parametrize("frontend", ["xla", "fused"])
def test_sharded_channelizer_world_one_matches_single_card(nccl_mesh,
                                                           frontend):
    """make_sharded_channelizer at world size 1 vs PolyphaseChannelizer on
    the card, 3 blocks: fused (K4 with the same halo) bit-equal, "xla" (a
    DFT product in place of the FFT) >= 115 dB; tails equal."""
    from solid_dsp_tpu_torch import parallel
    dev = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    M = 256
    init, apply = parallel.make_sharded_channelizer(
        M, 8, nccl_mesh, frontend=frontend, precision="x3")
    single = PolyphaseChannelizer(M, 8, backend=frontend, precision="x3",
                                  device=dev)
    t = init()
    before = cuda_chan.chan_fused_cuda.launches
    for b in range(3):
        x = torch.from_numpy(_cnoise(30 + b, M * 64)).to(dev)
        y, t = apply(t, x)
        y1 = single.execute_block(x)
        if frontend == "fused":
            assert torch.equal(y, y1)
        else:
            assert snr_db(y.cpu().numpy(), y1.cpu().numpy()) >= 115.0
        assert torch.equal(t, single.state)
    # K4 launches once a block in each of the two fused channelizers
    assert cuda_chan.chan_fused_cuda.launches == before + (
        6 if frontend == "fused" else 0)


def test_sharded_planar_fm_world_one_matches_single_card(nccl_mesh):
    """make_sharded_rx_chain planar FM at world size 1 vs make_rx_chain on
    the card, 3 blocks: the audio and the state bit-equal, one K1 launch a
    block."""
    from solid_dsp_tpu_torch import parallel
    from solid_dsp_tpu_torch.models.rx_chain import make_rx_chain
    dev = require_cuda()
    cfg = RxChainConfig(input_format="planar", fused_ddc="on",
                        fir_precision="x3")
    init_s, apply_s = parallel.make_sharded_rx_chain(cfg, nccl_mesh)
    init_1, apply_1 = make_rx_chain(cfg, dev)
    st_s, st_1 = init_s(), init_1()
    before = cuda_ddc.ddc_fm_cuda.launches
    for xb in make_blocks(3, seed=24):
        x = torch.from_numpy(xb).to(dev)
        out_s, st_s = apply_s(st_s, x)
        out_1, st_1 = apply_1(st_1, x)
        assert torch.equal(out_s, out_1)
    assert cuda_ddc.ddc_fm_cuda.launches == before + 6
    assert int(st_s["nco_theta"]) == int(st_1["nco_theta"])
    for k in ("fir_tail", "fm_prev"):
        assert torch.equal(st_s[k], st_1[k])
    assert torch.equal(st_s["agc"]["gain"], st_1["agc"]["gain"])


def _default_flags():
    """PyTorch's defaults: cuBLAS full float32, cuDNN TF32 on."""
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = True


@pytest.mark.parametrize("cplx", [True, False])
def test_conv1d_mxu_full_float32_at_default_flags(cplx):
    """conv1d_mxu on the card at PyTorch's default flags (cuDNN in TF32,
    which keeps some 60 dB): >= 100 dB against float64 on the CPU."""
    from solid_dsp_tpu_torch.ops.fir import conv1d_mxu
    dev = require_cuda()
    _default_flags()
    rng = np.random.default_rng(40)
    x, h = rng.standard_normal(1 << 16), rng.standard_normal(64)
    if cplx:
        x = x + 1j * rng.standard_normal(1 << 16)
        h = h + 1j * rng.standard_normal(64)
    x, h = (torch.from_numpy(a.astype(np.complex64 if cplx else np.float32))
            for a in (x, h))
    got = conv1d_mxu(x.to(dev), h.to(dev))
    wide = torch.complex128 if cplx else torch.float64
    want = conv1d_mxu(x.to(wide), h.to(wide))
    assert torch.backends.cudnn.allow_tf32
    assert snr_db(got.cpu().numpy(), want.numpy()) >= 100.0


def test_sharded_fir_full_float32_at_default_flags(nccl_mesh):
    """sharded_fir at world size 1 on the card at PyTorch's default flags:
    >= 100 dB against the same FIR in float64 on the CPU."""
    from solid_dsp_tpu_torch import parallel
    from solid_dsp_tpu_torch.ops.fir import conv1d_mxu
    dev = require_cuda()
    _default_flags()
    rng = np.random.default_rng(41)
    taps = (rng.standard_normal(33) + 1j * rng.standard_normal(33)
            ).astype(np.complex64)
    x = _cnoise(42, 4, 1 << 14)
    apply = parallel.sharded_fir(taps, nccl_mesh)
    tail = torch.zeros((4, 32), dtype=torch.complex64, device=dev)
    y, _ = apply(tail, torch.from_numpy(x).to(dev))
    x64 = np.concatenate([np.zeros((4, 32)), x], axis=1)
    want = conv1d_mxu(torch.from_numpy(x64), torch.from_numpy(
        taps.astype(np.complex128)))
    assert snr_db(y.cpu().numpy(), want.numpy()) >= 100.0


# --------------------------------------------- the sequential scans S1, S2

def _agc_case(dev, dt, T, seed=3, amp=0.1):
    rng = np.random.default_rng(seed)
    x = amp * (rng.standard_normal(T) + 1j * rng.standard_normal(T))
    rdt = torch.float32 if dt == torch.complex64 else torch.float64
    return torch.from_numpy(x).to(dev, dt), agc_ops.agc_init(rdt, dev)


@pytest.mark.parametrize("dt", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("T", [1, 17, 4096])
def test_agc_scan_kernel_matches_plain_on_card(dt, T):
    """S1 vs its plain version on the card in both types: y within 1e-5 of
    max|y| (f32; 1e-12 f64), gain rtol 1e-5 (1e-12), mode and timer equal;
    one launch counted; a batch of 3 carries as 3 sequences."""
    dev = require_cuda()
    x, st = _agc_case(dev, dt, T)
    before = cuda_scan.agc_scan_cuda.launches
    yk, sk = agc_ops.agc_apply(st, x, 0.01, 1.0, -1e30, 100)
    yp, sp = agc_ops.agc_scan_plain(st, x, 0.01, 1.0, -1e30, 100)
    torch.cuda.synchronize()
    assert cuda_scan.agc_scan_cuda.launches == before + 1
    tol = 1e-5 if dt == torch.complex64 else 1e-12
    assert float((yk - yp).abs().max()) <= tol * float(yp.abs().max())
    assert abs(float(sk["gain"]) / float(sp["gain"]) - 1.0) <= tol
    assert int(sk["mode"]) == int(sp["mode"])
    xb = torch.stack([x, 2 * x, 0.5 * x])
    stb = agc_ops.agc_init(st["gain"].dtype, dev, (3,))
    yb, sb = agc_ops.agc_apply(stb, xb, 0.01, 1.0, -1e30, 100)
    for i in range(3):
        yi, si = agc_ops.agc_apply(st, xb[i], 0.01, 1.0, -1e30, 100)
        assert torch.equal(yb[i], yi) and torch.equal(sb["gain"][i],
                                                      si["gain"])


def test_agc_scan_kernel_walks_the_squelch_fsm():
    """loud -> quiet with threshold -30 and timeout 20: S1 in float64
    against the plain version on the CPU (atol 1e-11, JAX's _cmp_parallel
    tolerance), modes and timer equal; the FSM entry against its plain
    version, modes equal; a locked carry keeps its gain."""
    dev = require_cuda()
    rng = np.random.default_rng(10)
    x = np.concatenate([np.exp(1j * rng.standard_normal(50)),
                        1e-8 * np.exp(1j * rng.standard_normal(300))])
    st = agc_ops.agc_init(torch.float64, "cpu")
    st["mode"] = torch.tensor(agc_ops.SquelchMode.ENABLED, dtype=torch.int32)
    yp, sp = agc_ops.agc_scan_plain(st, torch.from_numpy(x), 0.1, 1.0, -30.0,
                                    20)
    yk, sk = agc_ops.agc_apply({k: v.to(dev) for k, v in st.items()},
                               torch.from_numpy(x).to(dev), 0.1, 1.0, -30.0,
                               20)
    np.testing.assert_allclose(yk.cpu().numpy(), yp.numpy(), atol=1e-11)
    assert int(sk["mode"]) == int(sp["mode"]) == agc_ops.SquelchMode.ENABLED
    assert int(sk["timer"]) == int(sp["timer"])
    rssi = torch.from_numpy(np.concatenate([np.full(9, -10.0),
                                            np.full(40, -40.0)])).to(dev)
    m0 = torch.tensor(1, dtype=torch.int32, device=dev)
    t0 = torch.tensor(0, dtype=torch.int32, device=dev)
    mk = cuda_scan.squelch_fsm_cuda(rssi, m0, t0, -30.0, 20)
    mp = agc_ops.squelch_fsm_plain(rssi, m0, t0, -30.0, 20)
    assert all(torch.equal(a, b) for a, b in zip(mk, mp))
    st["lock"] = torch.tensor(True)
    st["gain"] = torch.tensor(3.0, dtype=torch.float64)
    yl, sl = agc_ops.agc_apply({k: v.to(dev) for k, v in st.items()},
                               torch.from_numpy(x).to(dev), 0.1, 1.0, -30.0,
                               20)
    assert float(sl["gain"]) == 3.0
    assert torch.allclose(yl, 3.0 * torch.from_numpy(x).to(dev))


def test_agc_scan_kernel_in_a_cuda_graph():
    """S1 captured in a CUDA graph and replayed gives the eager result."""
    dev = require_cuda()
    x, st = _agc_case(dev, torch.complex64, 8192)
    want, _ = agc_ops.agc_apply(st, x, 0.01, 1.0, -1e30, 100)
    out = {}
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        agc_ops.agc_apply(st, x, 0.01, 1.0, -1e30, 100)
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out["y"], out["st"] = agc_ops.agc_apply(st, x, 0.01, 1.0, -1e30, 100)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out["y"], want)


def test_agc_parallel_fallback_goes_to_the_kernel():
    """An all-zero block trips the gates: the fall-back is S1 (counted on
    both counters), bit-equal to S1 called with the parallel path's
    float32 alpha."""
    dev = require_cuda()
    st = agc_ops.agc_init(torch.float32, dev)
    z = torch.zeros(1 << 14, dtype=torch.complex64, device=dev)
    fb, fl, ln = (agc_ops.agc_apply_parallel.fallbacks,
                  cuda_scan.agc_scan_cuda.fallback_launches,
                  cuda_scan.agc_scan_cuda.launches)
    y, s = agc_ops.agc_apply_parallel(st, z, 0.01, 1.0, -1e30, 100)
    assert cuda_scan.agc_scan_cuda.launches == ln + 1
    y2, s2 = agc_ops.agc_apply(st, z, np.float32(0.01), 1.0, -1e30, 100)
    assert agc_ops.agc_apply_parallel.fallbacks == fb + 1
    assert cuda_scan.agc_scan_cuda.fallback_launches == fl + 1
    assert cuda_scan.agc_scan_cuda.launches == ln + 2
    assert torch.equal(y, y2) and float(s["gain"]) == float(s2["gain"])
    assert float(s["gain"]) == 1e6


def test_fir_classes_on_card_copy_no_taps_to_the_host(monkeypatch):
    """On the card the FIR classes' matmul route (64 taps: the Toeplitz
    form) builds its banks from the host copy of the taps: no tensor is
    copied back a block."""
    from solid_dsp_tpu_torch.ops import fir as fir_ops

    dev = require_cuda()
    seen = []
    host_taps = fir_ops._host_taps
    monkeypatch.setattr(fir_ops, "_host_taps", lambda t: (
        seen.append(type(t)), host_taps(t))[1])
    taps = np.random.default_rng(3).standard_normal(64)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(4096)
                         .astype(np.complex64)).to(dev)
    for f in (fir_ops.FIRFilter(taps, method="matmul", device=dev),
              fir_ops.DecimatingFIRFilter(taps, 1.0, 4, device=dev),
              fir_ops.InterpolatingFIRFilter(taps, 2, device=dev)):
        y = f.execute_block(x)
        assert y.is_cuda and bool(torch.isfinite(y).all())
    assert seen and torch.Tensor not in seen


def test_agc_parallel_matches_exact_on_card():
    """The Newton solve against S1 on a float32 block of 2^18: within 1e-5
    of max|y|, gain rtol 1e-5, no fall-back."""
    dev = require_cuda()
    x, st = _agc_case(dev, torch.complex64, 1 << 18, seed=4)
    fb = agc_ops.agc_apply_parallel.fallbacks
    yp, sp = agc_ops.agc_apply_parallel(st, x, 0.01, 1.0, -1e30, 100)
    ye, se = agc_ops.agc_apply(st, x, 0.01, 1.0, -1e30, 100)
    assert agc_ops.agc_apply_parallel.fallbacks == fb
    assert float((yp - ye).abs().max()) <= 1e-5 * float(ye.abs().max())
    assert abs(float(sp["gain"]) / float(se["gain"]) - 1.0) <= 1e-5


@pytest.mark.parametrize("dt", [torch.complex64, torch.complex128])
def test_costas_pll_kernel_matches_plain_on_card(dt):
    """S2 vs its plain version on the card: symbols equal, y within 1e-4
    (f32; 1e-9 f64), theta within 1e-3; SER < 1e-3 once locked; one launch
    counted."""
    dev = require_cuda()
    rng = np.random.default_rng(5)
    T = 4096
    sym = rng.integers(0, 4, T)
    gray = np.array([1 + 1j, -1 + 1j, 1 - 1j, -1 - 1j]) / np.sqrt(2.0)
    x = gray[sym] * np.exp(1j * (0.004 * np.arange(T) + 0.3)) + 0.02 * (
        rng.standard_normal(T) + 1j * rng.standard_normal(T))
    xt = torch.from_numpy(x).to(dev, dt)
    before = cuda_scan.costas_pll_cuda.launches
    yk, (thk, _) = qpsk_ops.qpsk_carrier_pll(xt, 0.02)
    z = torch.zeros((), dtype=xt.real.dtype, device=dev)
    yp, thp, _ = qpsk_ops.costas_pll_plain(xt, 0.02, float(np.sqrt(0.02)), z,
                                           z)
    torch.cuda.synchronize()
    assert cuda_scan.costas_pll_cuda.launches == before + 1
    tol = 1e-4 if dt == torch.complex64 else 1e-9
    assert float((yk - yp).abs().max()) <= tol
    assert abs(float(thk) - float(thp)) <= 10 * tol
    assert torch.equal(qpsk_ops.qpsk_slice(yk), qpsk_ops.qpsk_slice(yp))
    got = qpsk_ops.qpsk_slice(yk).cpu().numpy()
    assert qpsk_ops.symbol_error_rate(sym[1024:], got[1024:]) < 1e-3


def test_scan_kernels_reject_cpu_and_real_input():
    require_cuda()
    with pytest.raises(ValueError, match="CUDA"):
        cuda_scan.agc_scan_cuda(agc_ops.agc_init(torch.float32, "cpu"),
                                torch.zeros(8, dtype=torch.complex64), 0.9,
                                0.1, -0.05, 1.0, -1e30, 100)
    with pytest.raises(TypeError):
        cuda_scan.costas_pll_cuda(torch.zeros(8, device="cuda"), 0.1, 0.3,
                                  0.7, torch.zeros((), device="cuda"),
                                  torch.zeros((), device="cuda"))


def test_fir_measure_caches_per_device():
    """fir_apply("measure") times both methods once per (ntaps, block,
    dtype, device type): the card's winner is cached beside the CPU's."""
    dev = require_cuda()
    fir_ops._METHOD_CACHE.clear()
    taps = torch.from_numpy(np.hanning(500)).to(torch.complex64)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(1 << 16)
                         ).to(torch.complex64)
    tail = torch.zeros(499, dtype=torch.complex64)
    fir_ops.fir_apply(taps, tail, x, method="measure")
    yk, _ = fir_ops.fir_apply(taps.to(dev), tail.to(dev), x.to(dev),
                              method="auto")          # 500 taps: "measure"
    keys = {k[3] for k in fir_ops._METHOD_CACHE}
    assert keys == {"cpu", "cuda"}
    yp, _ = fir_ops.fir_apply(taps, tail, x, method="fft")
    assert snr_db(yk.cpu().numpy(), yp.numpy()) >= 90.0


@pytest.mark.parametrize("override", [
    dict(agc_mode="exact"), dict(agc_mode="parallel"),
    dict(nco_mode="lut", fused_ddc="auto", agc_mode="parallel",
         fir_precision="highest"),
    dict(nco_mode="lut", fused_ddc="auto", agc_mode="exact", demod="qpsk",
         fir_precision="highest")])
def test_exact_and_parity_chains_on_card_match_cpu(override):
    """The chains of phase 30 at 2^16 a block, three blocks: the card
    (body kernel, the banded-Toeplitz FIR, S1) against the CPU's plain
    versions, >= 90 dB (QPSK 60), phase word equal."""
    dev = require_cuda()
    blocks = (make_qpsk_blocks(3, 1 << 16)[0] if override.get("demod")
              == "qpsk" else make_blocks(3, 1 << 16))
    got, st = run_torch(blocks, device=dev, **override)
    want, sw = run_torch(blocks, device="cpu", **override)
    gate = 60.0 if override.get("demod") == "qpsk" else 90.0
    assert snr_db(got, want) >= gate
    assert int(st["nco_theta"]) == int(sw["nco_theta"])


S3_TYPES = [torch.float32, torch.float64, torch.complex64, torch.complex128]
S3_LC = linrec.S3_CHUNK
WIDE = {torch.float32: torch.float64, torch.float64: torch.float64,
        torch.complex64: torch.complex128, torch.complex128: torch.complex128}


def _s3_case(dev, dt, k, lanes, T, seed, r=0.9):
    """A stable order-k recurrence (poles at radius r: real ones for a
    real type), its input and a random history."""
    rng = np.random.default_rng(seed)
    if dt.is_complex:
        a = np.poly(r * np.exp(2j * np.pi * rng.random(k)))[1:]
    else:
        a = np.poly(r * np.cos(2 * np.pi * rng.random(k)))[1:]
    x = rng.standard_normal((T, *lanes))
    if dt.is_complex:
        x = x + 1j * rng.standard_normal((T, *lanes))
    return (torch.from_numpy(a).to(dev, dt), torch.from_numpy(x).to(dev, dt),
            torch.from_numpy(rng.standard_normal((*lanes, k))).to(dev, dt))


def _db(got, ref) -> float:
    num = float((ref.abs() ** 2).sum())
    den = float(((got.to(ref.dtype) - ref).abs() ** 2).sum())
    return float("inf") if den == 0 else 10 * np.log10(num / den)


def _s3_gate(dt, w, h, a, h0, x):
    """S3's (w, new state) against the sequential walk (iir_scan_torch on
    the CPU), as one vector (the state alone is too few samples for a ratio
    of powers): 64-bit within 1e-10 max|w| of the walk; 32-bit >= 90 dB
    against the float64 walk of the rounded filter, or within 3 dB of the
    walk in the working type where that keeps less (a filter of large
    gain)."""
    wide = WIDE[dt]
    a, h0, x = a.cpu(), h0.cpu(), x.cpu()

    def cat(pair):
        return torch.cat([t.reshape(-1).cpu() for t in pair])
    truth = cat(iir.iir_scan_torch(a.to(wide), h0.to(wide), x.to(wide)))
    got = cat((w, h))
    if dt in (torch.float64, torch.complex128):
        assert float((got - truth).abs().max()) <= 1e-10 * float(
            truth.abs().max())
        return
    walk = cat(iir.iir_scan_torch(a, h0, x))
    assert _db(got, truth) >= min(90.0, _db(walk, truth) - 3.0)


def _s3_rows(a, dt):
    """The kernel's rows a chunk for these coefficients (S3_CHUNK, or 16
    for a 32-bit filter of large transient gain)."""
    return linrec.chunk_rows(linrec.companion(
        a.cpu().to(WIDE[dt]).numpy()), dt)


@pytest.mark.parametrize("dt", S3_TYPES)
@pytest.mark.parametrize("k", [1, 2, 8, 11])
@pytest.mark.parametrize("lanes", [(), (256,), (3, 5)])
def test_iir_scan_kernel_bit_equal_to_plain(dt, k, lanes):
    """S3 vs iir_scan_torch on the card, two blocks with the history
    carried, one launch a block: bit-equal on blocks of one chunk (40 and
    24 rows, or 16 and 16 where the filter takes chunks of 16: the walk
    itself); on blocks of 301 and 399 rows the chunk starts are joined, not
    walked, so there within _s3_gate of the walk."""
    dev = require_cuda()
    a, x, h0 = _s3_case(dev, dt, k, lanes, 700, seed=k)
    lc = _s3_rows(a, dt)
    for cut, end in ((min(40, lc), min(40, lc) + min(24, lc)), (301, 700)):
        before = cuda_scan.iir_scan_cuda.launches
        w1, h1 = cuda_scan.iir_scan_cuda(a, h0, x[:cut])
        w2, h2 = cuda_scan.iir_scan_cuda(a, h1, x[cut:end])
        assert cuda_scan.iir_scan_cuda.launches == before + 2
        w = torch.cat([w1, w2])
        assert h2.shape == (*lanes, k)
        if end < 301:
            p1, q1 = iir.iir_scan_torch(a, h0, x[:cut])
            p2, q2 = iir.iir_scan_torch(a, q1, x[cut:end])
            assert torch.equal(w, torch.cat([p1, p2]))
            assert torch.equal(h2, q2)
        else:
            _s3_gate(dt, w, h2, a, h0, x[:end])


@pytest.mark.parametrize("T", [1, 3, 9, 16, 33, 64, 65])
def test_iir_scan_kernel_short_blocks(T):
    """Blocks shorter than the order, than a chunk (S3_CHUNK = 64 rows:
    bit-equal to the walk) and a chunk with a ragged end (joined: within
    1e-10 max|w|), at orders 2 (registers) and 12 (the generic path)."""
    dev = require_cuda()
    for dt in (torch.float64, torch.complex128):
        for k in (2, 12):
            a, x, h0 = _s3_case(dev, dt, k, (4,), T, seed=T, r=0.5)
            w, h = cuda_scan.iir_scan_cuda(a, h0, x)
            p, q = iir.iir_scan_torch(a, h0, x)
            if T <= S3_LC:
                assert torch.equal(w, p) and torch.equal(h, q)
            else:
                _s3_gate(dt, w, h, a, h0, x)


S3_SHAPES = [((), 1), ((), S3_LC - 1), ((), S3_LC + 1), ((), 5 * S3_LC + 3),
             ((), 1 << 14), ((), 130 * S3_LC + 7), ((256,), S3_LC + 1),
             ((256,), 5 * S3_LC + 3), ((256,), 1 << 12), ((3, 5), 3001)]


@pytest.mark.parametrize("dt", S3_TYPES)
@pytest.mark.parametrize("k", [1, 2, 3, 8, 11])
@pytest.mark.parametrize("lanes,T", S3_SHAPES)
def test_iir_scan_kernel_matches_chunked_plain(dt, k, lanes, T):
    """S3 against its plain version iir_chunked_torch (the same
    association, on the CPU): 32-bit bit-equal or within 1e-6 max|w|,
    64-bit within 1e-12 max|w|, times g / 16 for a filter whose transient
    gain g (linrec.transient_gain) exceeds 16 (the float64 join's sums
    in another order move a start by an ulp, which the chunk's walk
    amplifies by up to g); poles at 0.99 (k <= 3), 0.9 (k = 8), 0.5 (k =
    11, the generic path)."""
    dev = require_cuda()
    r = 0.99 if k <= 3 else 0.9 if k == 8 else 0.5
    a, x, h0 = _s3_case(dev, dt, k, lanes, T, seed=T + k, r=r)
    w, h = cuda_scan.iir_scan_cuda(a, h0, x)
    p, q = iir.iir_chunked_torch(a.cpu(), h0.cpu(), x.cpu())
    g = linrec.transient_gain(linrec.companion(
        a.cpu().to(WIDE[dt]).numpy()))
    tol = (1e-6 if dt in (torch.float32, torch.complex64) else 1e-12) * max(
        1.0, g / 16)
    for got, want in ((w, p), (h, q)):
        assert got.shape == want.shape and torch.isfinite(got).all()
        assert float((got.cpu() - want).abs().max()) <= tol * float(
            want.abs().max())


@pytest.mark.parametrize("dt", S3_TYPES)
@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_iir_scan_kernel_matches_walk(dt, k):
    """S3 against the sequential walk within _s3_gate on one lane of 2^14
    rows, and two blocks carried against one."""
    dev = require_cuda()
    r = 0.99 if k <= 3 else 0.9
    a, x, h0 = _s3_case(dev, dt, k, (), 1 << 14, seed=50 + k, r=r)
    w, h = cuda_scan.iir_scan_cuda(a, h0, x)
    _s3_gate(dt, w, h, a, h0, x)
    w1, h1 = cuda_scan.iir_scan_cuda(a, h0, x[:5000])
    w2, h2 = cuda_scan.iir_scan_cuda(a, h1, x[5000:])
    _s3_gate(dt, torch.cat([w1, w2]), h2, a, h0, x)


@pytest.mark.parametrize("method", ["scan", "parallel"])
def test_risky_pole_on_card_both_routes(method):
    """tests/test_iir.py:210-223's pole (radius 0.9999) in float32 through
    iir_apply on the card: S3 on both routes, >= 80 dB against the float64
    walk, no affine_scan (no cuBLAS gemm)."""
    dev = require_cuda()
    a = np.array([1.0, -2 * 0.9999 * np.cos(0.3), 0.9999 ** 2])
    b = np.array([0.01, 0.0, 0.0])
    x = np.random.default_rng(9).standard_normal(1 << 16)
    before = (cuda_scan.iir_scan_cuda.launches,
              cuda_scan.iir_scan_cuda.parallel_launches)
    y, _ = iir.iir_apply(torch.from_numpy(b).float(),
                         torch.from_numpy(a[1:]).float(),
                         torch.zeros(2, device=dev),
                         torch.from_numpy(x).float().to(dev), method)
    assert (cuda_scan.iir_scan_cuda.launches - before[0],
            cuda_scan.iir_scan_cuda.parallel_launches - before[1]) == (
                1, int(method == "parallel"))
    want, _ = iir.iir_apply(torch.from_numpy(b), torch.from_numpy(a[1:]),
                            torch.zeros(2, dtype=torch.float64),
                            torch.from_numpy(x), "scan")
    assert _db(y.cpu(), want) >= 80.0


def test_iir_routes_on_card_never_call_affine_scan(monkeypatch):
    """On the card "scan", "parallel", the de-emphasis and the SOS cascade
    launch S3 (or its cascade form) and never the doubling scan of torch
    ops (its batched cuBLAS gemms)."""
    from solid_dsp_tpu_torch.models import fm as fm_models

    def refuse(*args, **kwargs):
        raise AssertionError("affine_scan on a card path")
    monkeypatch.setattr(linrec, "affine_scan", refuse)
    monkeypatch.setattr(iir, "affine_scan", refuse)
    dev = require_cuda()
    x = torch.randn(5000, device=dev)
    s3, par = (cuda_scan.iir_scan_cuda.launches,
               cuda_scan.iir_scan_cuda.parallel_launches)
    for method in ("scan", "parallel"):
        iir.iir_apply(torch.tensor([0.5]), torch.tensor([-0.5]),
                      torch.zeros(1, device=dev), x, method)
    fm_models.deemphasis_apply(fm_models.deemphasis_init(device=dev), x,
                               75e-6 * 48000)
    assert cuda_scan.iir_scan_cuda.launches == s3 + 3
    assert cuda_scan.iir_scan_cuda.parallel_launches == par + 2
    from solid_dsp_tpu_torch.design import iirdes
    sos = iirdes.iirdes_sos("elliptic", 8, 0.05)
    before = cuda_scan.sos_cascade_cuda.launches
    for method in ("scan", "parallel"):
        iir.sos_cascade_apply(torch.from_numpy(sos[:, :3]).float(),
                              torch.from_numpy(sos[:, 4:]).float(),
                              torch.zeros(4, 2, device=dev), x, method)
    assert cuda_scan.sos_cascade_cuda.launches == before + 2


def test_host_values_of_card_views_read_their_base_once():
    """The views a caller makes anew at each call (``sos_a[..., 1:]``,
    ``sos_a[s]``) take their host values from their base's, read once and
    kept on the base until it changes in place."""
    dev = require_cuda()
    sos_a = torch.tensor([[1.0, -0.5, 0.25], [1.0, 0.1, -0.3]], device=dev)
    want = sos_a.cpu().double().numpy()
    for _ in range(2):
        np.testing.assert_array_equal(linrec.host_values(sos_a[..., 1:]),
                                      want[:, 1:])
        np.testing.assert_array_equal(linrec.host_values(sos_a[1, 1:]),
                                      want[1, 1:])
    assert sos_a._host_values[0] == sos_a._version
    sos_a[0, 1] = 0.75
    assert linrec.host_values(sos_a[..., 1:])[0, 0] == 0.75


@pytest.mark.parametrize("dt", S3_TYPES)
@pytest.mark.parametrize("T,lanes", [(1, ()), (S3_LC + 1, ()),
                                     (1 << 17, ()), (777, (3,))])
def test_sos_cascade_kernel_matches_plain(dt, T, lanes):
    """The fused cascade (elliptic-8, 4 sections) against
    sos_cascade_chunked_torch on the CPU: 32-bit bit-equal or within 1e-6
    max|y|, 64-bit 1e-12; and against the float64 per-section cascade of
    the rounded coefficients: 64-bit 1e-10 max|y|, 32-bit >= 90 dB; one
    launch."""
    from solid_dsp_tpu_torch.design import iirdes

    dev = require_cuda()
    rng = np.random.default_rng(T)
    sos = iirdes.iirdes_sos("elliptic", 8, 0.05)
    rdt = torch.empty(0, dtype=dt).real.dtype
    sb = torch.from_numpy(sos[:, :3]).to(rdt)
    sa = torch.from_numpy(sos[:, 4:]).to(rdt)
    x = rng.standard_normal((T, *lanes))
    st = 0.1 * rng.standard_normal((4, *lanes, 2))
    if dt.is_complex:
        x = x + 1j * rng.standard_normal(x.shape)
    x, st = torch.from_numpy(x).to(dt), torch.from_numpy(st).to(dt)
    before = cuda_scan.sos_cascade_cuda.launches
    y, s = iir.sos_cascade_apply(sb.to(dev), sa.to(dev), st.to(dev),
                                 x.to(dev), "scan")
    assert cuda_scan.sos_cascade_cuda.launches == before + 1
    p, q = iir.sos_cascade_chunked_torch(sb, sa, st, x)
    tol = 1e-6 if rdt == torch.float32 else 1e-12
    for got, want in ((y, p), (s, q)):
        assert got.shape == want.shape
        assert float((got.cpu() - want).abs().max()) <= tol * float(
            want.abs().max())
    wide = WIDE[dt]
    yw, _ = iir.sos_cascade_apply(sb.double(), sa.double(), st.to(wide),
                                  x.to(wide), "scan")
    if rdt == torch.float64:
        assert float((y.cpu() - yw).abs().max()) <= 1e-10 * float(
            yw.abs().max())
    else:
        assert _db(y.cpu(), yw) >= 90.0


def test_iir_scan_kernel_rejects_bad_input():
    dev = require_cuda()
    with pytest.raises(TypeError):
        cuda_scan.iir_scan_cuda(torch.ones(2, device=dev),
                                torch.zeros(2, device=dev),
                                torch.ones(8, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):
        cuda_scan.iir_scan_cuda(torch.ones(0, device=dev),
                                torch.zeros(0, device=dev),
                                torch.ones(8, device=dev))


@pytest.mark.parametrize("dt,tol", [(torch.float32, 1e-5),
                                    (torch.complex64, 1e-5),
                                    (torch.float64, 1e-12)])
def test_iir_filter_scan_on_card_launches_s3(dt, tol):
    """IIRFilter(SECOND_ORDER, method "scan", and "auto", which resolves to
    the scan for the sections with poles beyond radius 0.99) on the card:
    the whole cascade is one pipeline of S3's cascade form a block
    (sos_cascade_cuda, whatever each section's method), within tol of max
    of the CPU's run (one iir_apply a section: the b taps there are a
    convolution after the recurrence, here inside its step)."""
    from solid_dsp_tpu_torch.design import iirdes

    dev = require_cuda()
    ff, fb = iirdes.sos_to_iir_coeffs(iirdes.iirdes_sos("elliptic", 8, 0.05))
    rng = np.random.default_rng(4)
    x = rng.standard_normal(5000)
    if dt.is_complex:
        x = x + 1j * rng.standard_normal(5000)
    for method in ("scan", "auto"):
        f = iir.IIRFilter(ff, fb, "second_order", dt, method=method,
                          device=dev)
        g = iir.IIRFilter(ff, fb, "second_order", dt, method=method,
                          device="cpu")
        if method == "auto" and dt == torch.float64:
            assert all(s.method == "parallel"
                       for s in f.second_order_filters())
            continue
        scans = sum(s.method == "scan" for s in f.second_order_filters())
        assert scans == (4 if method == "scan" else 2)   # radii > 0.99: 2
        before = (cuda_scan.iir_scan_cuda.launches,
                  cuda_scan.sos_cascade_cuda.launches)
        y = torch.cat([f.execute_block(torch.from_numpy(b).to(dev, dt))
                       for b in np.split(x, [1999])])
        want = torch.cat([g.execute_block(torch.from_numpy(b).to(dt))
                          for b in np.split(x, [1999])])
        assert (cuda_scan.iir_scan_cuda.launches,
                cuda_scan.sos_cascade_cuda.launches) == (before[0],
                                                         before[1] + 2)
        assert float((y.cpu() - want).abs().max()) <= tol * float(
            want.abs().max())
        sa, sb = f.state["state"].cpu(), g.state["state"]   # (S, 2)
        assert float((sa - sb).abs().max()) <= tol * float(sb.abs().max())


def test_iir_parallel_and_filtfilt_on_card():
    """filtfilt_sos on the card by "parallel" and by "scan" alike: the
    fused cascade (S3's cascade form) twice, no doubling scan in torch
    ops; both match the CPU in float64."""
    from solid_dsp_tpu_torch.design import iirdes

    dev = require_cuda()
    sos = iirdes.iirdes_sos("butterworth", 6, 0.1)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(3000))
    before = cuda_scan.sos_cascade_cuda.launches
    yp = zerophase.filtfilt_sos(sos[:, :3], sos[:, 3:], x.to(dev),
                                method="parallel")
    assert cuda_scan.sos_cascade_cuda.launches == before + 2
    ys = zerophase.filtfilt_sos(sos[:, :3], sos[:, 3:], x.to(dev),
                                method="scan")
    assert cuda_scan.sos_cascade_cuda.launches == before + 4
    want = zerophase.filtfilt_sos(sos[:, :3], sos[:, 3:], x, method="scan")
    for y in (yp, ys):
        assert float((y.cpu() - want).abs().max()) <= 1e-12 * float(
            want.abs().max())


# ------------------------------------------ P4: the body's direct route

P4_POINTS = [(128, 200), (256, 128)]


def _direct_counts():
    return (cuda_ddc.ddc_body_cuda.direct_launches,
            cuda_ddc.ddc_body_cuda.direct_fast_launches,
            cuda_ddc.ddc_body_unaligned_cuda.direct_launches,
            cuda_ddc.ddc_body_unaligned_cuda.direct_fast_launches)


@pytest.mark.parametrize("n,M", P4_POINTS + [(129, 128), (300, 150),
                                              (300, 256), (512, 256)])
@pytest.mark.parametrize("mode", ["x3", "fast"])
def test_body_direct_route_matches_plain_on_card(n, M, mode):
    """The body's direct route at large decimations (the tensor-core
    spans do not fit; at M = 256 neither do K1's direct route's): K2's
    route on aligned blocks where n > M, K3's on
    unaligned ones and blocks of 2 outputs, against ddc_body_torch on the
    card in the same mode: >= 120 dB (float32 sums in another order; fast:
    the same bf16 operands), one direct launch each."""
    dev = require_cuda()
    assert cuda_ddc.body_geometry(n, M, mode == "fast")[0] == "direct"
    taps = RxChainConfig(fir_taps=n, decimation=M).design_taps()
    body = cuda_ddc.make_ddc_body(taps, nco.constrain(0.2), M, dev,
                                  mode=mode)
    rng = np.random.default_rng(n + M)
    for L in (4 * 64 * M, 4 * 64 * M + 3 * M, 2 * M):
        x = torch.from_numpy(rng.standard_normal((2, L)).astype(
            np.float32)).to(dev)
        tail = torch.from_numpy(0.3 * rng.standard_normal(
            (2, max(n - M, 0))).astype(np.float32)).to(dev)
        kernel = body.route(L)
        field = "direct_fast_launches" if mode == "fast" else \
            "direct_launches"
        before = getattr(kernel, field)
        zk = kernel(body, x, tail)
        torch.cuda.synchronize()
        assert getattr(kernel, field) == before + 1
        zp = ddc_ops.ddc_body_torch(body, x, tail)
        assert zk.shape == (2, L // M)
        assert snr_db(zk.cpu().numpy(), zp.cpu().numpy()) >= 120.0


@pytest.mark.parametrize("n,M", P4_POINTS)
@pytest.mark.parametrize("demod", ["fm", "am", "qpsk"])
@pytest.mark.parametrize("precision", ["x3", "default"])
def test_p4_chains_on_card_match_cpu(n, M, demod, precision):
    """P4 repaired: make_rx_chain(fused_ddc="on") at 128 taps, M = 200 and
    256 taps, M = 128 runs on the card in x3 and "default" (where it raised
    ValueError), over 4 blocks against device="cpu" (the plain bodies): FM
    and AM >= 90 dB, QPSK >= 60 dB with < 1e-3 of the quadrant decisions
    differing; nco_theta and fir_tail equal; the body's direct route
    launched where the body runs (FM at 256 taps, M = 128 takes K1's
    direct route instead)."""
    dev = require_cuda()
    L = 4 * 64 * M
    o = dict(fir_taps=n, decimation=M, demod=demod, fir_precision=precision)
    blocks = (make_qpsk_blocks(4, L=L, seed=31)[0] if demod == "qpsk"
              else make_blocks(4, L=L, seed=31))
    want, st_cpu = run_torch(blocks, **o)
    before = (_direct_counts(), cuda_ddc.ddc_fm_cuda.direct_launches
              + cuda_ddc.ddc_fm_cuda.direct_fast_launches)
    got, st = run_torch(blocks, device=dev, **o)
    torch.cuda.synchronize()
    body = sum(_direct_counts()) - sum(before[0])
    fm = (cuda_ddc.ddc_fm_cuda.direct_launches
          + cuda_ddc.ddc_fm_cuda.direct_fast_launches - before[1])
    if demod == "fm" and n > M:
        assert (body, fm) == (0, 4)
    else:
        assert (body, fm) == (4, 0)
    assert np.all(np.isfinite(got)) and got.shape == want.shape
    assert snr_db(got, want) >= (60.0 if demod == "qpsk" else 90.0)
    if demod == "qpsk":
        q = lambda v: (v.real < 0).astype(int) + 2 * (v.imag < 0)
        assert np.mean(q(got) != q(want)) < 1e-3
    assert int(st["nco_theta"]) == int(st_cpu["nco_theta"])
    assert torch.equal(st["fir_tail"].cpu(), st_cpu["fir_tail"])


# ------------------------------- K1's direct route: the rest of P4

K1_DIRECT_POINTS = [(256, 128), (256, 200), (256, 240), (512, 256)]


@pytest.mark.parametrize("n,M", K1_DIRECT_POINTS)
@pytest.mark.parametrize("mode", ["x3", "fast"])
def test_k1_direct_route_matches_plain_on_card(n, M, mode):
    """K1's direct route (a warp a run of outputs, no shared memory) at
    large decimations, where the staged design raised included, against
    ddc_fm_torch on the card in the same mode: audio >= 90 dB, stats rtol
    1e-5 (atol 1e-6); two launches bit-equal; counted on the direct
    counter of its mode.  Fast mode over 132 frames, so a TPU tile's f32
    seam falls inside the block."""
    dev = require_cuda()
    fast = mode == "fast"
    assert cuda_ddc.fm_geometry(n, M, fast)[0] == "direct"
    taps = RxChainConfig(fir_taps=n, decimation=M).design_taps()
    body = cuda_ddc.make_ddc_fm(taps, nco.constrain(0.2), M, 0.1, dev,
                                mode=mode)
    L = (132 if fast else 16) * cuda_ddc.DEFAULT_P * M
    x2, tail = (t.to(dev) for t in _inputs(n + M, L, n - M))
    field = "direct_fast_launches" if fast else "direct_launches"
    before = getattr(cuda_ddc.ddc_fm_cuda, field)
    a, s = cuda_ddc.ddc_fm_cuda(body, x2, tail)
    a2, s2 = cuda_ddc.ddc_fm_cuda(body, x2, tail)
    b, t = cuda_ddc.ddc_fm_torch(body, x2, tail)
    torch.cuda.synchronize()
    assert getattr(cuda_ddc.ddc_fm_cuda, field) == before + 2
    assert torch.equal(a, a2) and torch.equal(s, s2)
    assert a.shape == (L // M,) and bool(torch.isfinite(a).all())
    assert snr_db(a.cpu().numpy(), b.cpu().numpy()) >= 90.0
    np.testing.assert_allclose(s.cpu().numpy(), t.cpu().numpy(), rtol=1e-5,
                               atol=1e-6)


# ------------------------- S1's FSM entry: the chunk-and-join kernel

def _rssi_walk(rng, T):
    """An rssi track (dB) crossing -30 in runs of 1-59 samples, 2-15 dB to
    either side: long runs below it time a squelch of timeout 20 out."""
    out, i, above = np.empty(T), 0, True
    while i < T:
        k = int(rng.integers(1, 60))
        out[i:i + k] = -30.0 + (1.0 if above else -1.0) * rng.uniform(
            2.0, 15.0, k)[:T - i]
        i, above = i + k, not above
    return out


# (entry mode, entry timer) of mixed lanes: every mode, SIGNALLO near and
# far from expiry, a mode outside 0-7
FSM_ENTRIES = [(1, 0), (2, 5), (3, 0), (4, 7), (5, 1), (5, 3), (5, 0),
               (5, -4), (5, 40), (6, 2), (0, 9), (7, 1), (11, 3)]


def _fsm_case(seed, B, T, dtype):
    rng = np.random.default_rng(seed)
    rssi = torch.from_numpy(np.stack([_rssi_walk(rng, T) for _ in range(B)]
                                     )).to(dtype)
    ent = [FSM_ENTRIES[b % len(FSM_ENTRIES)] for b in range(B)]
    m0 = torch.tensor([m for m, _ in ent], dtype=torch.int32)
    t0 = torch.tensor([t for _, t in ent], dtype=torch.int32)
    return rssi, m0, t0


@pytest.mark.parametrize("B,T,dtype", [(1, 1 << 16, torch.float32),
                                       (1, 4096, torch.float64),
                                       (64, 4096, torch.float32)])
def test_squelch_fsm_kernel_bit_equal_to_plain(B, T, dtype):
    """The time-parallel FSM kernel against the sequential walk (on the
    CPU): one lane of 2^16 float32, 4096 float64, 64 lanes in mixed entry
    states; modes, final mode and final timer equal; one launch counted."""
    dev = require_cuda()
    rssi, m0, t0 = _fsm_case(B + T, B, T, dtype)
    before = cuda_scan.squelch_fsm_cuda.launches
    got = cuda_scan.squelch_fsm_cuda(rssi.to(dev), m0.to(dev), t0.to(dev),
                                     -30.0, 20)
    torch.cuda.synchronize()
    assert cuda_scan.squelch_fsm_cuda.launches == before + 1
    want = agc_ops.squelch_fsm_plain(rssi, m0, t0, -30.0, 20)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("chunk,threads", [(32, 32), (64, 128), (256, 64),
                                           (32, 1024)])
def test_squelch_fsm_kernel_geometries_match_chunked(chunk, threads):
    """Chunk lengths and chunks a block of the sweep, at blocks of 1, 33,
    5000 and 2^18 steps (one block a lane, several, runs of blocks in the
    join) on 3 lanes: bit-equal to the chunked plain version on the CPU."""
    dev = require_cuda()
    for T in (1, 33, 5000, 1 << 18):
        rssi, m0, t0 = _fsm_case(T, 3, T, torch.float32)
        got = cuda_scan.squelch_fsm_cuda(rssi.to(dev), m0.to(dev),
                                         t0.to(dev), -30.0, 20, chunk=chunk,
                                         threads=threads)
        want = agc_ops.squelch_fsm_chunked_torch(rssi, m0, t0, -30.0, 20)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), T


def test_squelch_fsm_kernel_in_a_cuda_graph():
    """The three launches captured in a CUDA graph and replayed give the
    eager result."""
    dev = require_cuda()
    rssi, m0, t0 = (v.to(dev) for v in _fsm_case(3, 4, 1 << 15,
                                                  torch.float32))
    want = cuda_scan.squelch_fsm_cuda(rssi, m0, t0, -30.0, 20)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        got = cuda_scan.squelch_fsm_cuda(rssi, m0, t0, -30.0, 20)
    g.replay()
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
