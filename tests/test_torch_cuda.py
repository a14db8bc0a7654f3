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
CPU's.  The CLI's ``rx`` on the card writes exactly what ``RxChain`` on the
card returns for the same blocks (bit-equal), through K1.  S4 (the Kalman
walks: forward, RTS backward, LTI, each a chunk-and-join kernel) within
rtol 1e-9 (float64) or 1e-4 (float32) of its plain walks at n, m up to 8
and within 1e-11 or 1e-5 of its chunked plain version, and S5 (the
all-pole lattice, csrc/track_scan.cu) the same as the walks in all four
types at orders 1 to 80.  S6 (turbo's
max-log BCJR walk, csrc/bcjr_scan.cu, the chunk-and-join) bit-equal to
bcjr_maxlog_chunked_torch and within 1e-4 max(1, max|LLR|) of its plain
version, hard bits equal above that, at K = 40 to 6144, batch 1 and 128;
the fused decode, one launch, bit-equal to turbo_decode_chunked_torch and
within that gate of the plain walks' decode, recovering every bit at the
sweep's Eb/N0; a longer codeword through the walk entry.
P7: the transforms of a batch with no rows return JAX's empty shape and
dtype on the card, with no K7 launch.  S7 (the Viterbi ACS walk and
traceback, csrc/viterbi_scan.cu) bit-equal to its plain version, decoded
bits and final path metrics, at K = 3 to 11, hard and soft, rates 1/2 and
1/3, batch 1 and 256, T from 12 to 8,166, and on a random hard stream
(ties at nearly every step); the links decode on the card through it.
S8 (the CVSD codec, csrc/cvsd_scan.cu): the encoder bit-equal to the
plain walk, also for parameters outside the decoder's range; the
chunk-and-join decoder bit-equal to its chunked plain version and within
CHUNKED_ATOL of the walk, at 1 to 1024 lanes, 1 to ~70,000 samples,
histories of 1, 3 and 32, the edge parameters and +-1, {0, 1, 2} and bool
words; 1024 voice lanes of 2^16 keep > 20 dB in band
(tests/test_cvsd.py:59).  S9 (the Gardner loop, csrc/gardner_scan.cu)
bit-equal to its plain version on the card and on the CPU, symbols and
final mu, at sps 1 to 64, also where mu leaves the staged window; it
tracks a clock drift over 2^17 symbols with no symbol error after
acquisition.  The protocol decoders where their input lies: rds_receive,
pocsag_receive and dtmf_decode on the card decode exactly what they decode
on the CPU; signal_moments within rtol 1e-5 and the labels equal;
estimate_cir within 1e-5 x max (complex64) or 1e-12 (complex128); the
MetricsCollector over a card chain reads -20 log10 of its AGC gain, within
1e-4 dB of the CPU chain's, and benchmark waits for the card.
"""

import importlib

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


# P7 on the card: the cases of tests/test_torch_empty_blocks.py, each with
# the shape and dtype JAX returns (that file holds the CPU results to JAX's)
P7_CASES = {
    "fft": ((0, 64), torch.complex64, (), (0, 64)),
    "ifft": ((0, 64), torch.complex64, (), (0, 64)),
    "fft_pad": ((0, 3, 40), torch.float32, (64,), (0, 3, 64)),
    "windowed_fft": ((0, 64), torch.complex64, (), (0, 64)),
    "windowed_fft_4096": ((0, 4096), torch.complex64, (), (0, 4096)),
    "spectrogram": ((10,), torch.float32, (64,), (0, 64)),
    "spectrogram_rows": ((3, 10), torch.complex64, (64, 32), (3, 0, 64)),
}


@pytest.mark.parametrize("call", list(P7_CASES))
def test_p7_transforms_of_no_rows_return_empty_on_card(call):
    """P7 on CUDA tensors: ``fft``, ``ifft`` and ``windowed_fft`` over a
    batch with no rows and ``spectrogram`` of a block shorter than a frame
    return the empty complex64 result on the card (cuFFT and K7 refuse a
    transform with no rows), launching no K7; eight rows of 4096 (K7's
    shape) launch it once."""
    dev = require_cuda()
    shape, dtype, args, want = P7_CASES[call]
    name = call.split("_")[0] if call.startswith(("fft", "spec")) else (
        "windowed_fft" if call.startswith("windowed") else call)
    x = torch.ones(shape, dtype=dtype, device=dev)
    before = _fft_counts()[0]
    got = getattr(fft_ops, name)(x, *args)
    torch.cuda.synchronize()
    assert _fft_counts()[0] == before
    assert tuple(got.shape) == want and got.dtype == torch.complex64
    assert got.is_cuda
    if call == "windowed_fft_4096":
        fft_ops.windowed_fft(torch.ones((8, 4096), dtype=dtype, device=dev))
        assert _fft_counts()[0] == before + 1


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


def test_cli_rx_equals_rx_chain_on_card(tmp_path):
    """``python -m solid_dsp_tpu_torch rx`` on a 2^20-sample ci16 recording
    (blocks of 2^18, the default device): its output file equals the same
    blocks through ``RxChain`` on the card bit for bit, and K1 launched on
    every block."""
    from solid_dsp_tpu_torch.__main__ import main
    from solid_dsp_tpu_torch.models.rx_chain import RxChain
    from solid_dsp_tpu_torch.runtime import read_iq, write_iq

    dev = require_cuda()
    n, block = 1 << 20, 1 << 18
    k = np.arange(n)
    rng = np.random.default_rng(14)
    x = 0.5 * np.exp(1j * (0.2 * k + 2.0 * np.sin(2 * np.pi * 1e-4 * k)))
    x += 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    src, dst = str(tmp_path / "in.ci16"), str(tmp_path / "out.cf32")
    write_iq(src, x.astype(np.complex64), "ci16")
    before = cuda_ddc.ddc_fm_cuda.launches
    assert main(["rx", src, "--format", "ci16", "--block", str(block),
                 "-o", dst]) == 0
    assert cuda_ddc.ddc_fm_cuda.launches - before == n // block
    chain = RxChain(carrier_freq=0.2, decimation=4, fir_taps=64, demod="fm",
                    nco_mode="exact", agc_mode="block", device=dev)
    rec = read_iq(src, "ci16")
    want = np.concatenate([chain.execute_block(rec[i:i + block]).cpu()
                           .numpy() for i in range(0, n, block)])
    got = read_iq(dst)
    assert got.shape == (n // 4,) and np.all(got.imag == 0)
    assert np.array_equal(got.real, want)


# ---------------------------------------------------------------------------
# S4 (the Kalman recursions: the forward chunk-and-join entry in
# csrc/track_forward.cu, the backward and LTI chunk-and-join entries in
# csrc/track_chunks.cu) and S5 (the all-pole lattice, csrc/track_scan.cu)
# against their plain versions on the card.
# Tolerances: float64 within rtol 1e-9 of the plain walk (the solve and the
# sums in another order); float32 within 1e-4 of each output's scale (the
# Riccati recursion is contractive, so rounding does not grow); the chunked
# entries against their chunked plain versions (the same association, only
# the float64 join's sums in another order): LTI 1e-6 (float32) and 1e-12
# (float64) of max|X| times max(1, g / 16) for F's transient gain g,
# forward and backward 1e-5 and 1e-11 of each output's max; S5 within 1e-9 (float64 /
# complex128) and 1e-4 (float32 / complex64) of max|x|.

_KF_SHAPES = [(1, 1), (1, 3), (2, 1), (3, 2), (4, 4), (5, 3), (8, 8)]


def _kf_model(n, m, seed):
    rng = np.random.default_rng(seed)
    A = 0.95 * np.eye(n) + 0.05 * rng.standard_normal((n, n))
    C = rng.standard_normal((m, n))
    Q = 0.01 * np.eye(n)
    R = np.diag(rng.uniform(0.2, 1.0, m))
    Z = rng.standard_normal((300, m))
    return A, C, Q, R, Z


def _rel(got, ref):
    return float((got - ref).abs().max()) / max(float(ref.abs().max()),
                                                1e-300)


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,m", _KF_SHAPES)
def test_s4_forward_and_backward_match_plain_on_card(dt, n, m):
    """S4's forward entry (kalman_apply, rts_smooth's forward pass with the
    covariances kept) and backward entry (the RTS pass) against the plain
    walks on the same card tensors; one launch each, counted."""
    from solid_dsp_tpu_torch.ops import cuda_track
    from solid_dsp_tpu_torch.ops import kalman as kf

    dev = require_cuda()
    A, C, Q, R, Z = _kf_model(n, m, 20 + n + 10 * m)
    x0 = torch.zeros(n, dtype=dt, device=dev)
    P0 = 10.0 * torch.eye(n, dtype=dt, device=dev)
    Zt = torch.from_numpy(Z).to(dev, dt)
    tol = 1e-9 if dt == torch.float64 else 1e-4
    f0 = cuda_track.kalman_filter_cuda.launches
    X, (xT, PT) = kf.kalman_apply((x0, P0), Zt, A, C, Q, R)
    assert cuda_track.kalman_filter_cuda.launches == f0 + 1
    ops = [torch.from_numpy(a).to(dev, dt) for a in (A, C, Q, R)]
    Xp_, xp_, Pp_, Pf, Xpr, Ppr = kf.kalman_walk_plain(x0, P0, Zt, *ops,
                                                       keep=True)
    torch.cuda.synchronize()
    assert X.dtype == dt and X.shape == (300, n)
    assert _rel(X, Xp_) <= tol and _rel(xT, xp_) <= tol
    assert _rel(PT, Pp_) <= tol
    got = cuda_track.kalman_filter_cuda(x0, P0, Zt, *ops, keep=True)
    for g, w in zip(got[3:], (Pf, Xpr, Ppr)):
        assert _rel(g, w) <= tol
    b0 = cuda_track.rts_backward_cuda.launches
    Xs, Ps = kf.rts_smooth((x0, P0), Zt, A, C, Q, R)
    assert cuda_track.rts_backward_cuda.launches == b0 + 1
    Xs_p, Ps_p = kf.rts_backward_plain(Xp_, Pf, Xpr, Ppr, ops[0])
    assert _rel(Xs, Xs_p) <= tol and _rel(Ps, Ps_p) <= tol
    assert torch.equal(Xs[-1], X[-1]) and torch.equal(Ps[-1], PT)
    # the kernel and its chunked plain version on the same inputs
    Xs_k, Ps_k = cuda_track.rts_backward_cuda(Xp_, Pf, Xpr, Ppr, ops[0])
    Xs_c, Ps_c = kf.rts_backward_chunked_torch(Xp_, Pf, Xpr, Ppr, ops[0])
    ctol = 1e-11 if dt == torch.float64 else 1e-5
    assert _rel(Xs_k, Xs_c) <= ctol and _rel(Ps_k, Ps_c) <= ctol


def _lti_tol(dt, F):
    from solid_dsp_tpu_torch.ops import linrec

    g = linrec.transient_gain(np.asarray(F, np.float64))
    return (1e-12 if dt == torch.float64 else 1e-6) * max(1.0, g / 16)


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_s4_lti_entry_matches_plain_on_card(dt, n):
    """S4's LTI entry by both of kalman_lti_apply's routes (and
    AlphaBetaTracker's) against lti_chunked_torch and the sequential walk
    on the card; one launch a call, "parallel" counted apart."""
    from solid_dsp_tpu_torch.ops import cuda_track
    from solid_dsp_tpu_torch.ops import kalman as kf

    dev = require_cuda()
    rng = np.random.default_rng(40 + n)
    F = 0.9 * np.eye(n) + 0.05 * rng.standard_normal((n, n))
    K = rng.standard_normal((n, 1))
    Z = torch.from_numpy(rng.standard_normal(1000)).to(dev, dt)
    x0 = torch.from_numpy(rng.standard_normal(n)).to(dev, dt)
    Ft, Kt = (torch.from_numpy(a).to(dev, dt) for a in (F, K))
    B = Z[:, None] @ Kt.T
    Xc, xc = kf.lti_chunked_torch(x0, B, Ft)
    Xp, xp = kf.lti_walk_plain(x0, B, Ft)
    tol = 1e-9 if dt == torch.float64 else 1e-4
    for method in ("scan", "parallel"):
        before = cuda_track.kalman_lti_cuda.launches
        par = cuda_track.kalman_lti_cuda.parallel_launches
        X, xT = kf.kalman_lti_apply(x0, Z, K, F, method=method)
        assert cuda_track.kalman_lti_cuda.launches == before + 1
        assert (cuda_track.kalman_lti_cuda.parallel_launches
                == par + (method == "parallel"))
        assert _rel(X, Xc) <= _lti_tol(dt, F) and _rel(xT, xc) <= _lti_tol(
            dt, F)
        assert _rel(X, Xp) <= tol and _rel(xT, xp) <= tol
    a, b = kf.alpha_beta_gains(0.1)
    z = torch.cumsum(torch.ones(2000, dtype=dt, device=dev), 0)
    ref = kf.AlphaBetaTracker(a, b, dtype=dt, device="cpu").execute_block(
        z.cpu(), "scan")
    for method in ("scan", "parallel"):
        trk = kf.AlphaBetaTracker(a, b, dtype=dt)
        Y = torch.cat([trk.execute_block(z[:700], method),
                       trk.execute_block(z[700:], method)])
        assert Y.device == dev and _rel(Y.cpu(), ref) <= tol


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("T,chunk", [(1, None), (64, None), (65, None),
                                     (2 * 128 * 64 + 37, None),
                                     (257 * 128 * 32 + 5, 32)])
def test_s4_lti_chunks_match_chunked_plain_on_card(dt, n, T, chunk):
    """S4's LTI entry over three lanes against lti_chunked_torch at T of
    one step, one chunk, a chunk and one, several groups with a ragged end,
    and enough groups that pass 2 runs several a thread; x_T carried."""
    from solid_dsp_tpu_torch.ops import cuda_track
    from solid_dsp_tpu_torch.ops import kalman as kf

    dev = require_cuda()
    rng = np.random.default_rng(70 + n)
    F = 0.9 * np.eye(n) + 0.02 * rng.standard_normal((n, n))
    B = torch.from_numpy(rng.standard_normal((3, T, n))).to(dev, dt)
    x0 = torch.from_numpy(rng.standard_normal((3, n))).to(dev, dt)
    Ft = torch.from_numpy(F).to(dev, dt)
    before = cuda_track.kalman_lti_cuda.launches
    X, xT = cuda_track.kalman_lti_cuda(x0, B, Ft, chunk=chunk)
    assert cuda_track.kalman_lti_cuda.launches == before + 1
    Xc, xc = kf.lti_chunked_torch(x0, B, Ft, chunk=chunk)
    assert X.shape == (3, T, n) and xT.shape == (3, n)
    assert _rel(X, Xc) <= _lti_tol(dt, F) and _rel(xT, xc) <= _lti_tol(dt, F)
    h = T // 3
    Xa, xa = cuda_track.kalman_lti_cuda(x0, B[:, :h], Ft, chunk=chunk)
    Xb, xb = cuda_track.kalman_lti_cuda(xa, B[:, h:], Ft, chunk=chunk)
    tol = 1e-9 if dt == torch.float64 else 1e-4
    assert _rel(torch.cat([Xa, Xb], 1), X) <= tol and _rel(xb, xT) <= tol


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,m", _KF_SHAPES)
@pytest.mark.parametrize("case", ["one", "two", "chunk_and_one", "groups",
                                  "runs"])
def test_s4_backward_chunks_match_chunked_plain_on_card(dt, n, m, case):
    """S4's backward entry over two lanes (the forward entry's outputs)
    against rts_backward_chunked_torch at T of one and two steps, a chunk
    and one, several groups with a ragged end, and, at its shortest chunk,
    enough groups that pass 2 runs several a thread (32 a group at n > 4);
    the last step the filter's, bit for bit; one launch."""
    from solid_dsp_tpu_torch.ops import cuda_track
    from solid_dsp_tpu_torch.ops import kalman as kf

    N = cuda_track.bucket(n)
    cb, join = (128, 256 if N <= 2 else 128) if N <= 4 else (32, 32)
    chunk = (cuda_track.rts_min_chunk(dt, N) if case == "runs"
             else cuda_track.RTS_CHUNK)
    T = {"one": 1, "two": 2, "chunk_and_one": chunk + 2,
         "groups": 2 * cb * chunk + 21,
         "runs": (join + 2) * cb * chunk + 3}[case]
    dev = require_cuda()
    A, C, Q, R, _ = _kf_model(n, m, 30 + n + 10 * m)
    ops = [torch.from_numpy(a).to(dev, dt) for a in (A, C, Q, R)]
    rng = np.random.default_rng(T + n)
    lanes = []
    for _ in range(2):
        Z = torch.from_numpy(rng.standard_normal((T, m))).to(dev, dt)
        out = cuda_track.kalman_filter_cuda(
            torch.zeros(n, dtype=dt, device=dev),
            10.0 * torch.eye(n, dtype=dt, device=dev), Z, *ops, keep=True)
        lanes.append((out[0], *out[3:]))
    Xf, Pf, Xp, Pp = (torch.stack(v) for v in zip(*lanes))
    before = cuda_track.rts_backward_cuda.launches
    Xs, Ps = cuda_track.rts_backward_cuda(Xf, Pf, Xp, Pp, ops[0], chunk)
    assert cuda_track.rts_backward_cuda.launches == before + 1
    Xc, Pc = kf.rts_backward_chunked_torch(Xf, Pf, Xp, Pp, ops[0], chunk)
    ctol = 1e-11 if dt == torch.float64 else 1e-5
    assert Xs.shape == (2, T, n) and Ps.shape == (2, T, n, n)
    assert _rel(Xs, Xc) <= ctol and _rel(Ps, Pc) <= ctol
    assert torch.equal(Xs[:, -1], Xf[:, -1]) and torch.equal(Ps[:, -1],
                                                              Pf[:, -1])
    if case not in ("groups", "runs"):
        Xw, Pw = kf.rts_backward_plain(Xf[1], Pf[1], Xp[1], Pp[1], ops[0])
        tol = 1e-9 if dt == torch.float64 else 1e-4
        assert _rel(Xs[1], Xw) <= tol and _rel(Ps[1], Pw) <= tol


def _fwd_case_model(n, m, model, seed):
    A, C, Q, R, _ = _kf_model(n, m, seed)
    if model == "singular":
        A[0] = 0.0
    elif model == "walk":
        # an unobserved random walk: P grows without bound
        A, C = np.eye(n), np.zeros((m, n))
        C[:, 0] = 1.0
        if n > 1:
            C[:, -1] = 0.0
    return A, C, Q, R


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,m", _KF_SHAPES)
@pytest.mark.parametrize("case", ["one", "chunk_and_one", "groups", "runs",
                                  "singular", "walk"])
def test_s4_forward_chunks_match_chunked_plain_on_card(dt, n, m, case):
    """S4's forward entry over two lanes (their own carried states, P0 of
    10 I and 1e-6 I) against kalman_forward_chunked_torch at T of one step,
    a chunk and one, several groups with a ragged end and, at its shortest
    chunk, enough groups that pass 2 runs several a thread; a singular A
    and an unobserved random walk; with and without the covariances kept,
    one launch a call; against the sequential walk where T is short."""
    from solid_dsp_tpu_torch.ops import cuda_track
    from solid_dsp_tpu_torch.ops import kalman as kf

    N, M = cuda_track.bucket(n), cuda_track.bucket(m)
    cb, join = (128, 256 if N <= 2 else 64) if N <= 4 else (32, 16)
    least = cuda_track.fwd_sub(dt, N, M, False)
    chunk = least if case == "runs" else max(cuda_track.FWD_CHUNK, least)
    T = {"one": 1, "chunk_and_one": chunk + 1, "groups": 2 * cb * chunk + 21,
         "runs": (join + 2) * cb * chunk + 3, "singular": 301,
         "walk": 301}[case]
    dev = require_cuda()
    A, C, Q, R = _fwd_case_model(n, m, case, 50 + n + 10 * m)
    ops = [torch.from_numpy(a).to(dev, dt) for a in (A, C, Q, R)]
    rng = np.random.default_rng(T + n)
    Z = torch.from_numpy(rng.standard_normal((2, T, m))).to(dev, dt)
    x0 = torch.from_numpy(rng.standard_normal((2, n))).to(dev, dt)
    P0 = torch.stack([10.0 * torch.eye(n), 1e-6 * torch.eye(n)]).to(dev, dt)
    ctol = 1e-11 if dt == torch.float64 else 1e-5
    tol = 1e-9 if dt == torch.float64 else 1e-4
    for keep in (False, True):
        before = cuda_track.kalman_filter_cuda.launches
        got = cuda_track.kalman_filter_cuda(x0, P0, Z, *ops, keep=keep,
                                            chunk=chunk)
        assert cuda_track.kalman_filter_cuda.launches == before + 1
        want = kf.kalman_forward_chunked_torch(x0, P0, Z, *ops, keep=keep,
                                               chunk=chunk)
        assert len(got) == len(want) == (6 if keep else 3)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == dt
            assert _rel(g, w) <= ctol
    if T <= 301:
        for i in range(2):
            walk = kf.kalman_walk_plain(x0[i], P0[i], Z[i], *ops, keep=True)
            for g, w in zip(got, walk):
                assert _rel(g[i], w) <= tol


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_make_kalman_lti_takes_s4_lti_entry_on_card(dt):
    """make_kalman_lti's apply on a CUDA tensor is S4's LTI entry, one
    launch a call (counted as "parallel"), for real and complex modes,
    within 1e-4 (float32) or 1e-9 (float64) of the sequential walk."""
    from solid_dsp_tpu_torch.ops import cuda_track
    from solid_dsp_tpu_torch.ops import kalman as kf

    dev = require_cuda()
    A, C, Q, R = kf.cv_model(1.0, 0.05, 1.0)
    K, F = kf.steady_state_gain(A, C, Q, R)
    rot = 0.97 * np.array([[np.cos(0.3), -np.sin(0.3)],
                           [np.sin(0.3), np.cos(0.3)]])
    rng = np.random.default_rng(61)
    z = torch.from_numpy(rng.standard_normal(3000)).to(dev, dt)
    x0 = torch.from_numpy(rng.standard_normal(2)).to(dev, dt)
    tol = 1e-9 if dt == torch.float64 else 1e-4
    for KK, FF in ((K, F), (np.array([[0.3], [0.1]]), rot)):
        apply = kf.make_kalman_lti(KK, FF)
        before = cuda_track.kalman_lti_cuda.launches
        par = cuda_track.kalman_lti_cuda.parallel_launches
        X, xT = apply(x0, z)
        assert cuda_track.kalman_lti_cuda.launches == before + 1
        assert cuda_track.kalman_lti_cuda.parallel_launches == par + 1
        Kt, Ft = (torch.from_numpy(a).to(dev, dt) for a in (KK, FF))
        Xw, xw = kf.lti_walk_plain(x0, z[:, None] * Kt.T, Ft)
        assert X.device == dev and X.dtype == dt
        assert _rel(X, Xw) <= tol and _rel(xT, xw) <= tol


@pytest.mark.parametrize("dt", [torch.float32, torch.float64,
                                torch.complex64, torch.complex128])
@pytest.mark.parametrize("p", [1, 5, 16, 40, 64, 80])
def test_s5_lattice_matches_plain_on_card(dt, p):
    """S5 against lattice_iir_plain on the card, orders 1 to 64 in the
    register buckets and 80 on the generic path, three lanes with their own
    coefficients; lattice_fir of the result gives y back; one launch."""
    from solid_dsp_tpu_torch.ops import cuda_track
    lpc = importlib.import_module("solid_dsp_tpu_torch.analysis.lpc")

    dev = require_cuda()
    rng = np.random.default_rng(60 + p)
    k = 0.6 * rng.uniform(-1, 1, (3, p)) / np.sqrt(np.arange(1, p + 1))
    y = rng.standard_normal((3, 300))
    if dt.is_complex:
        k = k * np.exp(1j * rng.uniform(0, 2 * np.pi, (3, p)))
        y = y + 1j * rng.standard_normal((3, 300))
    kt, yt = (torch.from_numpy(a).to(dev, dt) for a in (k, y))
    before = cuda_track.lattice_iir_cuda.launches
    x = lpc.lattice_iir(yt, kt)
    assert cuda_track.lattice_iir_cuda.launches == before + 1
    xp = lpc.lattice_iir_plain(yt, kt)
    tol = 1e-9 if dt in (torch.float64, torch.complex128) else 1e-4
    assert x.dtype == dt and _rel(x, xp) <= tol
    assert _rel(lpc.lattice_fir(x, kt), yt) <= 10 * tol


def test_s4_s5_reject_cpu_and_wrong_types():
    from solid_dsp_tpu_torch.ops import cuda_track

    require_cuda()
    with pytest.raises(ValueError, match="CUDA"):
        cuda_track.lattice_iir_cuda(torch.zeros(3, 8), torch.zeros(3, 2))
    with pytest.raises(TypeError):
        cuda_track.lattice_iir_cuda(torch.zeros(8, device="cuda",
                                                dtype=torch.int32),
                                    torch.zeros(2, device="cuda",
                                                dtype=torch.int32))
    with pytest.raises(ValueError, match="n, m"):
        cuda_track.kalman_filter_cuda(
            torch.zeros(9, device="cuda"), torch.zeros(9, 9, device="cuda"),
            torch.zeros(4, 1, device="cuda"),
            torch.zeros(9, 9, device="cuda"), torch.zeros(1, 9, device="cuda"),
            torch.zeros(9, 9, device="cuda"), torch.zeros(1, 1, device="cuda"))


# S6: turbo's max-log BCJR walk (csrc/bcjr_scan.cu, the chunk-and-join),
# K over LTE's QPP range

def _s6_gate(got, want):
    """|dLLR| <= 1e-4 max(1, max|LLR|), and the hard bits equal wherever
    |LLR| exceeds that tolerance (the chunk-and-join's association against
    the plain version's radix-8 blocks: float32 association and
    renormalisation)."""
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol
    sure = want.abs() > tol
    assert torch.equal((got < 0)[sure], (want < 0)[sure])


@pytest.mark.parametrize("B", [1, 128])
@pytest.mark.parametrize("T", [40, 41, 49, 1023, 1024, 6144])
def test_s6_matches_plain_on_card(B, T):
    """S6's walk entry bit-equal to bcjr_maxlog_chunked_torch and within
    S6's gate of bcjr_maxlog_plain on the same card rows (LLRs of scales 1
    to 20, as iterations grow them), tails appended (T + 3 leaves last
    chunks of 11, 12, 20, 2, 3 and 3 steps); one launch."""
    from solid_dsp_tpu_torch.models import turbo
    from solid_dsp_tpu_torch.ops import cuda_bcjr, cuda_build

    dev = require_cuda()
    assert cuda_build.build()["bcjr_scan.cu"].bcjr_chunk() == turbo.CHUNK
    rng = np.random.default_rng(T + B)
    scale = rng.uniform(1, 20, (B, 1))
    ls, lp = (torch.from_numpy(scale * rng.standard_normal((B, T + 3))).to(
        dev, torch.float32) for _ in range(2))
    before = cuda_bcjr.bcjr_maxlog_cuda.launches
    got = turbo.bcjr_maxlog(ls, lp, T)
    assert cuda_bcjr.bcjr_maxlog_cuda.launches == before + 1
    chunked = turbo.bcjr_maxlog_chunked_torch(ls, lp, T)
    want = turbo.bcjr_maxlog_plain(ls, lp, T)
    torch.cuda.synchronize()
    assert got.shape == (B, T) and got.dtype == torch.float32
    assert torch.equal(got, chunked)
    _s6_gate(got, want)


@pytest.mark.parametrize("T", [41, 1023])
def test_s6_generic_layout_on_card(T):
    """Pass 1 takes its shift-register layout (a lane a column) for the
    trellises of models/turbo.py::_rsc_tables whose feedforward has the D^3
    tap and its generic one (a lane a row, shuffles) for other tables: the
    LTE trellis with its states relabelled (state 0 kept) gives the same
    LLRs bit for bit, and 15/7 its chunked plain version's."""
    from solid_dsp_tpu_torch.models import turbo
    from solid_dsp_tpu_torch.ops import cuda_bcjr

    dev = require_cuda()
    tabs = [np.asarray(a, np.int64) for a in turbo._rsc_tables(
        turbo.DEFAULT_FB, turbo.DEFAULT_FF, 3)[:4]]
    sig = np.array([0, 3, 6, 1, 7, 2, 5, 4])
    ns, p, prev, prev_u = tabs
    rel = [np.empty_like(a) for a in tabs]
    rel[0][sig], rel[1][sig] = sig[ns], p
    rel[2][sig], rel[3][sig] = sig[prev], prev_u
    assert cuda_bcjr.shift_layout(*tabs) and not cuda_bcjr.shift_layout(*rel)
    for fb, ff in ((0o13, 0o15), (0o17, 0o15)):
        assert cuda_bcjr.shift_layout(*turbo._rsc_tables(fb, ff, 3)[:4])
    # no D^3 feedforward tap: a row's two branches take different halves
    t7 = turbo._rsc_tables(0o15, 0o7, 3)[:4]
    assert not cuda_bcjr.shift_layout(*t7)
    rng = np.random.default_rng(T)
    ls, lp = (torch.from_numpy(20 * rng.standard_normal((4, T + 3))).to(
        dev, torch.float32) for _ in range(2))
    got = cuda_bcjr.bcjr_maxlog_cuda(ls, lp, T, *rel)
    assert torch.equal(got, turbo.bcjr_maxlog_chunked_torch(ls, lp, T))
    got = cuda_bcjr.bcjr_maxlog_cuda(ls, lp, T, *t7)
    assert torch.equal(got, turbo.bcjr_maxlog_chunked_torch(ls, lp, T, 0o15,
                                                            0o7, 3))


def _s6_codewords(code, B, seed):
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    bits = torch.from_numpy(rng.integers(0, 2, (B, code.K))).to(dev)
    cw = code.encode(bits)
    llr = (4.0 * (1 - 2.0 * cw) + torch.from_numpy(
        rng.standard_normal(cw.shape)).to(dev)).to(torch.float32)
    return bits, llr


@pytest.mark.parametrize("K,B", [(40, 1), (1024, 128), (6144, 4)])
def test_s6_turbo_decode_on_card(K, B):
    """TurboCode on the card: one launch of the fused decode (no walk
    launch), its LLRs and bits bit-equal to turbo_decode_chunked_torch on
    the card, within S6's gate of the plain walks' decode, and every bit
    back at the TPU sweep's Eb/N0 (LLRs 4 (1 - 2c) + N(0, 1))."""
    from solid_dsp_tpu_torch.models import turbo
    from solid_dsp_tpu_torch.ops import cuda_bcjr

    require_cuda()
    code = turbo.TurboCode(K, n_iter=6, device="cuda")
    bits, llr = _s6_codewords(code, B, K)
    before = cuda_bcjr.turbo_decode_cuda.launches
    walks = cuda_bcjr.bcjr_maxlog_cuda.launches
    b_k, l_k = code.decode(llr)
    assert cuda_bcjr.turbo_decode_cuda.launches == before + 1
    assert cuda_bcjr.bcjr_maxlog_cuda.launches == walks
    b_c, l_c = turbo.turbo_decode_chunked_torch(llr, code.perm, 6)
    b_p, l_p = turbo.turbo_decode(llr, code.perm, 6, engine="torch")
    assert cuda_bcjr.turbo_decode_cuda.launches == before + 1
    assert b_k.dtype == torch.int32 and l_k.shape == (B, K)
    assert torch.equal(l_k, l_c) and torch.equal(b_k, b_c)
    _s6_gate(l_k, l_p)
    assert torch.equal(b_k, bits.to(torch.int32))


def test_s6_long_codeword_takes_the_walk_route():
    """A codeword above the fused decode's shared memory (K = 8192 here)
    takes the walk entry, two launches an iteration, bit-equal to the
    chunked loop; the fused entry refuses it."""
    from solid_dsp_tpu_torch.models import turbo
    from solid_dsp_tpu_torch.ops import cuda_bcjr

    dev = require_cuda()
    K = 8192
    assert cuda_bcjr.fused_fits(6144, dev) and not cuda_bcjr.fused_fits(K,
                                                                        dev)
    code = turbo.TurboCode(K, n_iter=3, device=dev)
    bits, llr = _s6_codewords(code, 2, K)
    fused = cuda_bcjr.turbo_decode_cuda.launches
    walks = cuda_bcjr.bcjr_maxlog_cuda.launches
    b_k, l_k = code.decode(llr)
    assert cuda_bcjr.bcjr_maxlog_cuda.launches == walks + 6
    assert cuda_bcjr.turbo_decode_cuda.launches == fused
    b_c, l_c = turbo.turbo_decode_chunked_torch(llr, code.perm, 3)
    assert torch.equal(l_k, l_c) and torch.equal(b_k, b_c)
    assert torch.equal(b_k, bits.to(torch.int32))
    tabs = turbo._rsc_tables(turbo.DEFAULT_FB, turbo.DEFAULT_FF, 3)[:4]
    with pytest.raises(ValueError, match="does not fit"):
        cuda_bcjr.turbo_decode_cuda(llr, code.perm, 3, *tabs)


def test_s6_rejects_wrong_inputs_on_card():
    from solid_dsp_tpu_torch.models import turbo
    from solid_dsp_tpu_torch.ops import cuda_bcjr

    dev = require_cuda()
    tabs = turbo._rsc_tables(turbo.DEFAULT_FB, turbo.DEFAULT_FF, 3)[:4]
    ls = torch.zeros((2, 43), device=dev)
    with pytest.raises(TypeError):
        cuda_bcjr.bcjr_maxlog_cuda(ls.double(), ls.double(), 40, *tabs)
    with pytest.raises(ValueError):
        cuda_bcjr.bcjr_maxlog_cuda(ls, ls, 44, *tabs)
    with pytest.raises(ValueError):
        cuda_bcjr.bcjr_maxlog_cuda(ls, ls[:, :40], 40, *tabs)
    tabs4 = turbo._rsc_tables(0o7, 0o5, 2)[:4]
    with pytest.raises(ValueError, match="8-state"):
        cuda_bcjr.bcjr_maxlog_cuda(ls, ls, 40, *tabs4)
    perm = turbo.qpp_permutation(40)
    rows = torch.zeros((2, 132), device=dev)
    with pytest.raises(TypeError):
        cuda_bcjr.turbo_decode_cuda(rows.double(), perm, 2, *tabs)
    with pytest.raises(ValueError):
        cuda_bcjr.turbo_decode_cuda(rows[:, :-1], perm, 2, *tabs)
    with pytest.raises(ValueError, match="permutation"):
        cuda_bcjr.turbo_decode_cuda(rows, np.zeros(40, np.int64), 2, *tabs)
    with pytest.raises(ValueError, match="8-state"):
        cuda_bcjr.turbo_decode_cuda(rows, perm, 2, *tabs4)


# S7: the Viterbi ACS walk and traceback (csrc/viterbi_scan.cu)

S7_CODES = {3: (0o7, 0o5), 5: (0o23, 0o35), 7: (0o171, 0o133),
            9: (0o561, 0o753)}


def _s7_rows(rng, polys, K, B, T, soft, hard_flips=0.05):
    """(B, T, n) received rows for tail-terminated codewords of T - K + 1
    bits: float32 BPSK LLRs through AWGN (soft), or int32 bits with flips
    (hard)."""
    from solid_dsp_tpu_torch.models import fec

    n = len(polys)
    bits = rng.integers(0, 2, (B, T - K + 1))
    c = fec.conv_encode(torch.from_numpy(bits), polys, K).numpy()
    if soft:
        rx = ((1 - 2.0 * c) + 0.8 * rng.standard_normal(c.shape)).astype(
            np.float32)
    else:
        rx = (c ^ (rng.random(c.shape) < hard_flips)).astype(np.int32)
    return bits, rx.reshape(B, T, n)


@pytest.mark.parametrize("K", sorted(S7_CODES))
@pytest.mark.parametrize("rate3", [False, True])
@pytest.mark.parametrize("soft", [False, True])
@pytest.mark.parametrize("B,T", [(1, 12), (256, 550), (1, 8166)])
def test_s7_matches_plain_on_card(K, rate3, soft, B, T):
    """S7 against viterbi_plain on the same card rows: the decoded bits
    and the final path metrics exactly equal, at hard and soft decisions,
    rates 1/2 and 1/3; one launch a batch."""
    from solid_dsp_tpu_torch.models import fec
    from solid_dsp_tpu_torch.ops import cuda_viterbi

    dev = require_cuda()
    polys = S7_CODES[K] + ((S7_CODES[K][0] ^ 0o2,) if rate3 else ())
    rng = np.random.default_rng(K + 10 * B + T)
    _, rx = _s7_rows(rng, polys, K, B, T, soft)
    r = torch.from_numpy(rx).to(dev)
    before = cuda_viterbi.viterbi_cuda.launches
    bk, pk = fec.viterbi_walk(r, polys, K, soft)
    assert cuda_viterbi.viterbi_cuda.launches == before + 1
    bp, pp = fec.viterbi_walk(r, polys, K, soft, engine="torch")
    assert cuda_viterbi.viterbi_cuda.launches == before + 1
    torch.cuda.synchronize()
    assert bk.shape == (B, T) and pk.shape == (B, 1 << (K - 1))
    assert torch.equal(bk, bp) and torch.equal(pk, pp)


@pytest.mark.parametrize("soft", [False, True])
def test_s7_ties_and_k11_match_plain_on_card(soft):
    """A hard stream of random bits (ties at nearly every step, decided by
    the first-minimum rule) at K = 7, and K = 11 (1024 states, the
    kernel's largest: 32 warps, the warp-level block minimum)."""
    from solid_dsp_tpu_torch.models import fec

    dev = require_cuda()
    rng = np.random.default_rng(17)
    r = torch.from_numpy(rng.integers(0, 2, (64, 600, 2)).astype(
        np.int32)).to(dev)
    if soft:
        r = (1 - 2.0 * r + torch.from_numpy(rng.standard_normal(
            (64, 600, 2))).to(dev)).to(torch.float32)
    bk, pk = fec.viterbi_walk(r, soft=soft)
    bp, pp = fec.viterbi_walk(r, soft=soft, engine="torch")
    assert torch.equal(bk, bp) and torch.equal(pk, pp)
    polys = (0o3345, 0o3613)
    _, rx = _s7_rows(rng, polys, 11, 4, 300, soft)
    r = torch.from_numpy(rx).to(dev)
    bk, pk = fec.viterbi_walk(r, polys, 11, soft)
    bp, pp = fec.viterbi_walk(r, polys, 11, soft, engine="torch")
    assert torch.equal(bk, bp) and torch.equal(pk, pp)


def test_s7_decodes_links_on_card():
    """viterbi_decode, CCSDSLink and PacketModem on the card go through S7
    and decode what they do on the CPU: the batch's bits back at Eb/N0 =
    4 dB, a CCSDS frame at its operating point, a packet burst."""
    from solid_dsp_tpu_torch.models import ccsds, fec, packet
    from solid_dsp_tpu_torch.ops import cuda_viterbi

    dev = require_cuda()
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, (32, 544))
    c = fec.conv_encode(torch.from_numpy(bits)).numpy()
    sigma = np.sqrt(1 / (2 * 0.5 * 10 ** 0.4))
    y = (1 - 2.0 * c) + sigma * rng.standard_normal(c.shape)
    llr = torch.from_numpy((2 * y / sigma ** 2).astype(np.float32))
    before = cuda_viterbi.viterbi_cuda.launches
    got = fec.viterbi_decode(llr.to(dev), soft=True)
    assert cuda_viterbi.viterbi_cuda.launches == before + 1
    assert torch.equal(got.cpu(), fec.viterbi_decode(llr, soft=True))
    assert (got.cpu().numpy() != bits).mean() < 1e-3
    link = ccsds.CCSDSLink(4, dev)
    data = rng.integers(0, 256, link.payload_bytes, dtype=np.uint8).tobytes()
    tx = link.encode(data).cpu().numpy()
    R = len(data) * 8 / len(tx)
    s = np.sqrt(1 / (2 * R * 10 ** 0.28))
    yl = (1 - 2.0 * tx) + s * rng.standard_normal(len(tx))
    assert link.decode((2 * yl / s ** 2).astype(np.float32)) == (data, True)
    pm = packet.PacketModem(payload_bytes=64, device=dev)
    burst = pm.transmit(bytes(range(64)))
    x = torch.cat([torch.zeros(300, dtype=burst.dtype, device=dev), burst,
                   torch.zeros(300, dtype=burst.dtype, device=dev)])
    before = cuda_viterbi.viterbi_cuda.launches
    out, info = pm.receive(x)
    assert cuda_viterbi.viterbi_cuda.launches == before + 1
    assert info["crc_ok"] and out == bytes(range(64))


def test_s7_rejects_wrong_inputs_on_card():
    from solid_dsp_tpu_torch.models import fec
    from solid_dsp_tpu_torch.ops import cuda_viterbi

    dev = require_cuda()
    out, _ = fec._tables((0o171, 0o133), 7)
    pred = fec._predecessors(7)
    r = torch.zeros((2, 20, 2), device=dev)
    with pytest.raises(TypeError):
        cuda_viterbi.viterbi_cuda(r.double(), True, out, pred)
    with pytest.raises(TypeError):
        cuda_viterbi.viterbi_cuda(r, False, out, pred)
    with pytest.raises(ValueError):
        cuda_viterbi.viterbi_cuda(r[..., :1], True, out, pred)
    with pytest.raises(ValueError, match="predecessors"):
        cuda_viterbi.viterbi_cuda(r, True, out, pred[::-1])
    bits, pm = cuda_viterbi.viterbi_cuda(r[:0], True, out, pred)
    assert bits.shape == (0, 20) and pm.shape == (0, 64)
    b0, p0 = cuda_viterbi.viterbi_cuda(r[:, :0], True, out, pred)
    assert b0.shape == (2, 0) and torch.equal(
        p0.cpu(), fec.viterbi_plain(r[:, :0].cpu(), out, True)[1])


S7_MORE = {11: (0o3345, 0o3613)}


@pytest.mark.parametrize("K", [3, 5, 7, 9, 11])
@pytest.mark.parametrize("B,T", [(1, 12), (1, 550), (1, 8166), (256, 12),
                                 (256, 550), (256, 8166), (1024, 12),
                                 (1024, 550), (1024, 8166)])
def test_s7_chunked_matches_plain_on_card(K, B, T):
    """The chunked walk as chunk_plan cuts it (soft, rate 1/2) bit-equal to
    viterbi_plain and to viterbi_chunked_torch on the card, bits and final
    path metrics, with the chunked plain version's count of re-walked
    chunks and of re-traced chunks."""
    from solid_dsp_tpu_torch.models import fec
    from solid_dsp_tpu_torch.ops import cuda_viterbi

    dev = require_cuda()
    polys = {**S7_CODES, **S7_MORE}[K]
    rng = np.random.default_rng(K + B + T)
    _, rx = _s7_rows(rng, polys, K, B, T, True)
    r = torch.from_numpy(rx).to(dev)
    out, _ = fec._tables(polys, K)
    L, W, _, _ = cuda_viterbi.chunk_plan(B, T, 1 << (K - 1))
    fec.viterbi_walk(r, polys, K, True)
    cuda_viterbi.viterbi_cuda.fixups.zero_()
    bk, pk = fec.viterbi_walk(r, polys, K, True)
    fix = cuda_viterbi.viterbi_cuda.fixups.tolist()
    bp, pp = fec.viterbi_walk(r, polys, K, True, engine="torch")
    bc, pc, fc = fec.viterbi_chunked_torch(r, out, True, L, W)
    assert torch.equal(bk, bp) and torch.equal(pk, pp)
    assert torch.equal(bk, bc) and torch.equal(pk, pc)
    assert fix == [fc, fec.viterbi_chunked_torch.retraced]


@pytest.mark.parametrize("K", [5, 7, 9])
@pytest.mark.parametrize("soft", [False, True])
@pytest.mark.parametrize("W,per", [(0, 0), (2, 1), (96, 0)])
def test_s7_rewalks_forced_on_card(K, soft, W, per, monkeypatch):
    """A warm-up of 0 or 2 steps (the wrapper's argument) and a trace
    lookahead D of 0 or K - 1 steps (TRACE_AHEAD_PER_MEMORY 0 or 1): nearly
    every seam fails its check, the chunks are walked again in pass 2 and
    the pieces traced again in pass 3, and the result stays bit-equal to
    the plain walk, with the chunked plain version's counts.  A warm-up of
    96 with D = 0: the pieces alone are traced again."""
    from solid_dsp_tpu_torch.models import fec
    from solid_dsp_tpu_torch.ops import cuda_viterbi

    dev = require_cuda()
    polys = S7_CODES[K]
    rng = np.random.default_rng(K + 10 * W + soft)
    _, rx = _s7_rows(rng, polys, K, 16, 700, soft, hard_flips=0.08)
    r = torch.from_numpy(rx).to(dev)
    out, _ = fec._tables(polys, K)
    pred = fec._predecessors(K)
    cuda_viterbi.viterbi_cuda(r, soft, out, pred)
    monkeypatch.setattr(cuda_viterbi, "TRACE_AHEAD_PER_MEMORY", per)
    L = cuda_viterbi.chunk_plan(16, 700, 1 << (K - 1), W)[0]
    cuda_viterbi.viterbi_cuda.fixups.zero_()
    bk, pk = cuda_viterbi.viterbi_cuda(r, soft, out, pred, warmup=W)
    fix = cuda_viterbi.viterbi_cuda.fixups.tolist()
    bp, pp = fec.viterbi_walk(r, polys, K, soft, engine="torch")
    bc, pc, fc = fec.viterbi_chunked_torch(r, out, soft, L, W)
    assert torch.equal(bk, bp) and torch.equal(pk, pp)
    assert torch.equal(bk, bc) and torch.equal(pk, pc)
    assert fix == [fc, fec.viterbi_chunked_torch.retraced]
    assert fc > 100 if W <= 2 else fix[1] > 100


def test_s7_repeats_and_graph_replay_on_card():
    """Two launches on the same rows give the same bits and metrics, and so
    does a CUDA graph of the call replayed (the scratch, the ticket and the
    counters are the call's own); the re-walk count grows by the same
    amount each replay."""
    from solid_dsp_tpu_torch.models import fec
    from solid_dsp_tpu_torch.ops import cuda_viterbi

    dev = require_cuda()
    rng = np.random.default_rng(23)
    _, rx = _s7_rows(rng, S7_CODES[7], 7, 64, 2000, True)
    r = torch.from_numpy(rx).to(dev)
    tabs = (fec._tables(S7_CODES[7], 7)[0], fec._predecessors(7))
    b1, p1 = cuda_viterbi.viterbi_cuda(r, True, *tabs, warmup=4)
    b2, p2 = cuda_viterbi.viterbi_cuda(r, True, *tabs, warmup=4)
    torch.cuda.synchronize()
    assert torch.equal(b1, b2) and torch.equal(p1, p2)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        bg, pg = cuda_viterbi.viterbi_cuda(r, True, *tabs, warmup=4)
    before = cuda_viterbi.viterbi_cuda.fixups.clone()
    g.replay()
    torch.cuda.synchronize()
    once = cuda_viterbi.viterbi_cuda.fixups - before
    assert torch.equal(bg, b1) and torch.equal(pg, p1)
    bg.zero_()
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(bg, b1) and torch.equal(pg, p1)
    assert torch.equal(cuda_viterbi.viterbi_cuda.fixups - before, 2 * once)
    assert int(once[0]) > 0


# S8: the CVSD walk (csrc/cvsd_scan.cu)

def _s8_lanes(rng, B, N):
    """Lanes b % 3 == 0: a two-tone voice at 4x oversampling, scaled by 0.2
    to 1.0; b % 3 == 1: random levels; b % 3 == 2: the voice plus noise."""
    t = np.arange(N) / 32000.0
    voice = 0.5 * np.sin(2 * np.pi * 300 * t) + 0.25 * np.sin(
        2 * np.pi * 800 * t)
    x = np.stack([voice * (0.2 + 0.8 * (b % 5) / 4) for b in range(B)])
    x[1::3] = rng.uniform(-1, 1, x[1::3].shape)
    x[2::3] += 0.02 * rng.standard_normal(x[2::3].shape)
    return x.astype(np.float32)


@pytest.mark.parametrize("B,N", [(1, 1), (3, 31), (32, 64), (70, 1000),
                                 (1024, 4096)])
@pytest.mark.parametrize("n_history", [1, 3, 32])
def test_s8_matches_plain_on_card(B, N, n_history):
    """S8 against its plain versions on the same card lanes: the bits equal
    to cvsd_walk_plain's, the decoded trajectory equal to
    cvsd_decode_chunked_torch's and within CHUNKED_ATOL of the walk's,
    ragged chunks and partial warps included; one call a direction, five
    kernels a decode."""
    from solid_dsp_tpu_torch.models import cvsd
    from solid_dsp_tpu_torch.ops import cuda_cvsd

    dev = require_cuda()
    rng = np.random.default_rng(B + N + n_history)
    x = torch.from_numpy(_s8_lanes(rng, B, N)).to(dev)
    if B * N > 1 << 16:
        x = x[:, :512].contiguous()        # the plain walk's launches
    before = cuda_cvsd.cvsd_cuda.launches
    passes = cuda_cvsd.cvsd_cuda.pass_launches
    bk = cvsd.cvsd_encode(x, n_history=n_history)
    yk = cvsd.cvsd_decode(bk, n_history=n_history)
    assert cuda_cvsd.cvsd_cuda.launches == before + 2
    assert cuda_cvsd.cvsd_cuda.pass_launches == passes + 5
    bp = cvsd.cvsd_encode(x, n_history=n_history, engine="torch")
    yp = cvsd.cvsd_decode(bp, n_history=n_history, engine="torch")
    yc = cvsd.cvsd_decode_chunked_torch(bp, n_history=n_history)
    assert cuda_cvsd.cvsd_cuda.launches == before + 2
    torch.cuda.synchronize()
    assert bk.dtype == torch.int32 and yk.dtype == torch.float32
    assert torch.equal(bk, bp) and torch.equal(yk, yc)
    assert float((yk - yp).abs().max()) <= cvsd.CHUNKED_ATOL


# the decoder's edges: parameters (a constant step, leak 1, a boost below
# the floor's decay, a loud input that holds ref on +-1) and shapes (one
# sample, shorter than a chunk, ragged, lanes not a multiple of 32, several
# blocks a lane and runs of R = 2 and R = 5 chunks in the joins)
_S8_EDGES = {"default": {}, "leak 1": {"leak": 1.0},
             "dmin = dmax": {"delta_min": 0.05, "delta_max": 0.05},
             "small gamma": {"gamma": 1e-5}, "loud": {"gain": 4.0}}


@pytest.mark.parametrize("edge", list(_S8_EDGES))
@pytest.mark.parametrize("n_history", [1, 3, 32])
def test_s8_decode_equals_chunked_plain_on_card(edge, n_history):
    """S8's decoder bit-equal to cvsd_decode_chunked_torch at its chunk
    length, and its encoder to cvsd_walk_plain, at the edges."""
    from solid_dsp_tpu_torch.models import cvsd
    from solid_dsp_tpu_torch.ops import cuda_cvsd

    dev = require_cuda()
    kw = dict(_S8_EDGES[edge])
    gain = kw.pop("gain", 1.0)
    chunk = cuda_cvsd.DECODE_CHUNK
    rng = np.random.default_rng(chunk + n_history)
    for B, N in ((1, 1), (3, chunk - 5), (37, 3 * chunk + 7),
                 (2, 300 * chunk + 3), (3, 1100 * chunk + 5)):
        x = torch.from_numpy(np.clip(gain * _s8_lanes(rng, B, N), -1, 1)).to(
            dev)
        bits = cvsd.cvsd_encode(x, n_history=n_history, **kw)
        n = min(N, 2048)                   # the plain walk's launches
        assert torch.equal(bits[:, :n], cvsd.cvsd_encode(
            x[:, :n], n_history=n_history, engine="torch", **kw))
        y = cuda_cvsd.cvsd_cuda(bits, True, kw.get("beta", 0.9),
                                kw.get("gamma", 0.01),
                                kw.get("delta_min", 0.001),
                                kw.get("delta_max", 0.2), n_history,
                                kw.get("leak", 0.98))
        want = cvsd.cvsd_decode_chunked_torch(bits, n_history=n_history,
                                              **kw)
        torch.cuda.synchronize()
        assert torch.equal(y, want), (B, N)


@pytest.mark.parametrize("alphabet", ["nrz", "ternary", "bool"])
@pytest.mark.parametrize("n_history", [1, 3, 32])
def test_s8_decodes_any_words_on_card(alphabet, n_history):
    """The decoder's history holds the raw words and a word signs the
    step when it is 1, as JAX's does: +-1 (NRZ), {0, 1, 2} and bool words
    against the plain walk (within CHUNKED_ATOL) and the chunked plain
    version (bit-equal)."""
    from solid_dsp_tpu_torch.models import cvsd

    dev = require_cuda()
    rng = np.random.default_rng(n_history)
    B, N = 40, 1500
    words = {"nrz": 2 * rng.integers(0, 2, (B, N)) - 1,
             "ternary": rng.integers(0, 3, (B, N)),
             "bool": rng.integers(0, 2, (B, N)).astype(bool)}[alphabet]
    w = torch.from_numpy(words).to(dev)
    y = cvsd.cvsd_decode(w, n_history=n_history)
    yp = cvsd.cvsd_decode(w, n_history=n_history, engine="torch")
    yc = cvsd.cvsd_decode_chunked_torch(w, n_history=n_history)
    torch.cuda.synchronize()
    assert torch.equal(y, yc)
    assert float((y - yp).abs().max()) <= cvsd.CHUNKED_ATOL


def test_s8_full_lanes_quality_on_card():
    """1024 lanes of 2^16 samples in one launch a direction: every lane's
    decode is its encoder's trajectory (the first 2048 samples of 8 lanes
    against the plain walk), and the voice lanes keep > 20 dB in band."""
    import scipy.signal as sps_sig

    from solid_dsp_tpu_torch.models import cvsd

    dev = require_cuda()
    rng = np.random.default_rng(8)
    x = _s8_lanes(rng, 1024, 1 << 16)
    xd = torch.from_numpy(x).to(dev)
    bits = cvsd.cvsd_encode(xd)
    y = cvsd.cvsd_decode(bits).cpu().numpy()
    bp = cvsd.cvsd_encode(xd[:8, :2048], engine="torch")
    assert torch.equal(bits[:8, :2048], bp)
    lp = sps_sig.firwin(201, 1200, fs=32000)
    for b in (3, 9, 1008):                 # clean voice, scale >= 0.6
        xf = sps_sig.lfilter(lp, 1, x[b])[500:]
        yf = sps_sig.lfilter(lp, 1, y[b])[500:]
        assert 10 * np.log10(np.mean(xf ** 2) / np.mean((yf - xf) ** 2)) > 20


def test_s8_rejects_and_limits_on_card():
    from solid_dsp_tpu_torch.models import cvsd
    from solid_dsp_tpu_torch.ops import cuda_build, cuda_cvsd

    dev = require_cuda()
    x = torch.zeros((2, 40), device=dev)
    with pytest.raises(ValueError, match="history"):
        cvsd.cvsd_encode(x, n_history=33)
    with pytest.raises(ValueError, match="float32"):
        cvsd.cvsd_encode(x.double())
    b = cvsd.cvsd_encode(x.double(), n_history=33, engine="torch")
    assert b.shape == (2, 40) and b.is_cuda
    for shape in ((0, 40), (2, 0)):
        assert cvsd.cvsd_encode(torch.zeros(shape, device=dev)).shape == shape
    with pytest.raises(ValueError, match="lanes"):
        cuda_cvsd.cvsd_cuda(x[0], False, 0.9, 0.01, 0.001, 0.2, 3, 0.98)
    bits = cvsd.cvsd_encode(x)
    built = cuda_build.launcher("cvsd_scan.cu", "cvsd_decode_chunk", ())
    assert built() == cuda_cvsd.DECODE_CHUNK
    for beta, dmin, dmax, leak in ((1.5, 0.001, 0.2, 0.98),
                                   (0.9, 0.3, 0.2, 0.98),
                                   (0.9, 0.001, 0.2, 0.0)):
        with pytest.raises(ValueError, match="beta"):
            cuda_cvsd.cvsd_cuda(bits, True, beta, 0.01, dmin, dmax, 3, leak)
    assert cvsd.cvsd_decode(bits, beta=1.5, engine="torch").is_cuda
    before = cuda_cvsd.cvsd_cuda.pass_launches
    for shape in ((0, 40), (2, 0)):
        w = torch.zeros(shape, dtype=torch.int32, device=dev)
        assert cvsd.cvsd_decode(w).shape == shape
    assert cuda_cvsd.cvsd_cuda.pass_launches == before


# parameters outside the decoder's range (params_proved), which the
# encoder takes through the instantiation that keeps every clamp
_S8_LOOSE = {"beta > 1": {"beta": 1.3}, "leak 0": {"leak": 0.0},
             "leak > 1": {"leak": 1.2}, "dmin < 0": {"delta_min": -0.05},
             "dmin > dmax": {"delta_min": 0.3, "delta_max": 0.2},
             "negative slopes": {"beta": -0.5, "leak": -0.9}}


@pytest.mark.parametrize("loose", list(_S8_LOOSE))
@pytest.mark.parametrize("n_history", [1, 3])
def test_s8_encode_any_params_on_card(loose, n_history):
    """The encoder bit-equal to cvsd_walk_plain for parameters outside
    the decoder's range, where the dropped clamps could bind."""
    from solid_dsp_tpu_torch.models import cvsd
    from solid_dsp_tpu_torch.ops import cuda_cvsd

    dev = require_cuda()
    kw = _S8_LOOSE[loose]
    rng = np.random.default_rng(n_history)
    x = torch.from_numpy(_s8_lanes(rng, 37, 700)).to(dev)
    before = cuda_cvsd.cvsd_cuda.launches
    bits = cvsd.cvsd_encode(x, n_history=n_history, **kw)
    assert cuda_cvsd.cvsd_cuda.launches == before + 1
    want = cvsd.cvsd_encode(x, n_history=n_history, engine="torch", **kw)
    torch.cuda.synchronize()
    assert torch.equal(bits, want)


# S9: the Gardner loop (csrc/gardner_scan.cu)

def _s9_stream(rng, n_sym, sps, tau=0.4, drift=0.0):
    """RRC QPSK at sps with a fractional offset (and a clock drift in
    samples a symbol), through the matched filter, complex64."""
    from solid_dsp_tpu_torch.design.firdes import firdes_rrcos

    idx = rng.integers(0, 4, n_sym)
    pts = np.array([1 + 1j, -1 + 1j, 1 - 1j, -1 - 1j]) / np.sqrt(2)
    rrc = firdes_rrcos(sps, 6, 0.35)
    n = n_sym * sps
    t = (np.arange(n_sym) * (sps + drift) + tau)
    up = np.zeros(n + 64, complex)
    base = np.floor(t).astype(int)
    fr = t - base
    up[base] += pts[idx] * (1 - fr)      # a linear split of each impulse
    up[base + 1] += pts[idx] * fr
    tx = np.convolve(up[:n], rrc)[:n]
    return idx, np.convolve(tx, rrc)[:n].astype(np.complex64)


@pytest.mark.parametrize("sps,n_sym", [(8, 1), (8, 33), (8, 4096), (2, 3000),
                                       (5, 2000), (1, 1500), (64, 300)])
def test_s9_matches_plain_on_card(sps, n_sym):
    """S9 against gardner_walk_plain on the card (and the CPU's plain walk):
    the symbols and the final mu exactly equal; one launch a stream."""
    from solid_dsp_tpu_torch.models import timing
    from solid_dsp_tpu_torch.ops import cuda_timing

    dev = require_cuda()
    rng = np.random.default_rng(sps * 7 + n_sym)
    _, x = _s9_stream(rng, n_sym + 2, max(sps, 2))
    x = x[: (n_sym + 2) * sps + 4]
    xd = torch.from_numpy(x).to(dev)
    before = cuda_timing.gardner_cuda.launches
    sk, mk = timing.gardner_scan(xd, sps, 0.02, 0.3)
    assert cuda_timing.gardner_cuda.launches == before + 1
    sp, mp = timing.gardner_scan(xd, sps, 0.02, 0.3, engine="torch")
    sc, mc = timing.gardner_scan(torch.from_numpy(x), sps, 0.02, 0.3)
    assert cuda_timing.gardner_cuda.launches == before + 1
    torch.cuda.synchronize()
    assert sk.shape == ((len(x) - 4) // sps - 1,)
    assert torch.equal(sk, sp) and torch.equal(mk, mp)
    assert torch.equal(sk.cpu(), sc) and torch.equal(mk.cpu(), mc)


@pytest.mark.parametrize("bandwidth,mu0", [(0.6, 0.0), (0.05, 45.5),
                                           (0.05, -30.0)])
def test_s9_reads_outside_its_window_on_card(bandwidth, mu0):
    """Noise at a wide loop bandwidth (mu jumps beyond the window's
    margin), and a start far off the strobe: the reads that fall outside the
    staged window come from device memory, bit-equal to the plain walk."""
    from solid_dsp_tpu_torch.models import timing

    dev = require_cuda()
    rng = np.random.default_rng(int(bandwidth * 100))
    x = (rng.standard_normal(8 * 700) + 1j * rng.standard_normal(8 * 700)
         ).astype(np.complex64)
    xd = torch.from_numpy(x).to(dev)
    sk, mk = timing.gardner_scan(xd, 8, bandwidth, mu0)
    sp, mp = timing.gardner_scan(xd, 8, bandwidth, mu0, engine="torch")
    torch.cuda.synchronize()
    assert torch.equal(sk, sp) and torch.equal(mk, mp)


def test_s9_tracks_a_clock_drift_on_card():
    """A 2^20-sample stream with a clock drift of 1e-4 sample a symbol: the
    loop follows mu across the whole stream (the window follows it), SER
    0 after acquisition; the first 2^12 symbols equal the plain walk."""
    from solid_dsp_tpu_torch.models import timing

    dev = require_cuda()
    rng = np.random.default_rng(9)
    idx, x = _s9_stream(rng, 1 << 17, 8, drift=1e-4)
    xd = torch.from_numpy(x).to(dev)
    sk, mk = timing.gardner_scan(xd, 8, 0.01)
    sp, _ = timing.gardner_scan(xd[: 8 * 4100], 8, 0.01, engine="torch")
    assert torch.equal(sk[: len(sp)], sp)
    y = sk.cpu().numpy()[2000:]
    got = (y.real < 0).astype(int) + 2 * (y.imag < 0)
    best = min(float(np.mean(idx[2000 + lag: 2000 + lag + len(got) - 40]
                             != got[: len(got) - 40]))
               for lag in range(-20, 21))
    assert best == 0.0 and abs(float(mk) - 1e-4 * (1 << 17)) < 4


def test_s9_rejects_on_card():
    from solid_dsp_tpu_torch.models import timing

    dev = require_cuda()
    x = torch.zeros(800, dtype=torch.complex64, device=dev)
    with pytest.raises(ValueError, match="complex64"):
        timing.gardner_scan(x.to(torch.complex128), 8)
    with pytest.raises(ValueError, match="sps"):
        timing.gardner_scan(x, 65)
    s, _ = timing.gardner_scan(x.to(torch.complex128), 65, engine="torch")
    assert s.is_cuda and s.shape == ((800 - 4) // 65 - 1,)
    s, mu = timing.gardner_scan(x[:6], 8)
    torch.cuda.synchronize()
    assert s.shape == (0,) and float(mu) == 0.0


# ------------------------------------------------ the protocol decoders

def _rds_mpx(fs, reps=3, noise=0.01, seed=2):
    from solid_dsp_tpu_torch.models import rds

    bits = np.tile(rds.make_ps_groups(0x52A1, "SOLIDDSP"), reps)
    sig = rds.rds_modulate(bits, fs)
    n = np.arange(len(sig))
    rng = np.random.default_rng(seed)
    return (0.4 * np.sin(2 * np.pi * 1000.0 / fs * n)
            + 0.1 * np.sin(2 * np.pi * 19000.0 / fs * n) + 0.06 * sig
            + noise * rng.standard_normal(len(n))).astype(np.float32)


@pytest.mark.parametrize("fs", [228000.0, 456000.0])
def test_rds_receive_on_card_equals_cpu(fs):
    """The receiver where the MPX lies: identical bits and groups on the
    card and on the CPU."""
    from solid_dsp_tpu_torch.models import rds

    dev = require_cuda()
    mpx = torch.from_numpy(_rds_mpx(fs))
    a = rds.rds_demodulate_bits(mpx.to(dev), fs)
    b = rds.rds_demodulate_bits(mpx, fs)
    np.testing.assert_array_equal(a, b)
    got = rds.rds_receive(mpx.to(dev), fs)
    assert got == rds.rds_receive(mpx, fs)
    assert got["pi"] == 0x52A1 and got["ps"] == "SOLIDDSP"
    assert got["n_groups"] >= 10


def test_pocsag_receive_on_card_equals_cpu():
    from solid_dsp_tpu_torch.models import pocsag

    dev = require_cuda()
    iq = pocsag.pocsag_transmit(1300120, "CARD PAGE 42", sps=8)
    rng = np.random.default_rng(3)
    iq = (iq + 0.1 * (rng.standard_normal(len(iq))
                      + 1j * rng.standard_normal(len(iq)))).astype(
                          np.complex64)
    iq = np.concatenate([iq, iq[:5]])           # a ragged end
    x = torch.from_numpy(iq)
    got = pocsag.pocsag_receive(x.to(dev), 8)
    assert got == pocsag.pocsag_receive(x, 8)
    assert [(p["address"], p["message"]) for p in got] == [
        (1300120, "CARD PAGE 42")]


def test_dtmf_decode_on_card_equals_cpu():
    from solid_dsp_tpu_torch.models import dtmf

    dev = require_cuda()
    rng = np.random.default_rng(4)
    seq = "123A456B789C*0#D" * 4
    x = dtmf.dtmf_generate(seq)
    x = x + 0.05 * rng.standard_normal(len(x)).astype(np.float32)
    xt = torch.from_numpy(np.concatenate([x, x[:77]]))
    got = dtmf.dtmf_decode(xt.to(dev))
    assert got == dtmf.dtmf_decode(xt) == seq
    assert dtmf.dtmf_decode(xt[:100].to(dev)) == ""


def test_signal_moments_and_classify_on_card_equal_cpu():
    """Moments within rtol 1e-5 (float32 sums in another order) over a
    (64, 4096) batch; the labels identical."""
    from solid_dsp_tpu_torch.models import linear_mod, modclass

    dev = require_cuda()
    rng = np.random.default_rng(5)
    bursts = []
    for k in range(64):
        scheme, m = modclass.DEFAULT_CLASSES[k % 5]
        pts = linear_mod.constellation(scheme, m)
        s = pts[rng.integers(0, m, 4096)] * np.exp(2j * np.pi * rng.random())
        bursts.append(s + 0.1 * (rng.standard_normal(4096)
                                 + 1j * rng.standard_normal(4096)))
    x = torch.from_numpy(np.asarray(bursts, np.complex64))
    got = modclass.signal_moments(x.to(dev))
    want = modclass.signal_moments(x)
    for g, w in zip(got, want):
        assert g.is_cuda and g.shape == (64,)
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-5)
    for k in range(0, 64, 7):
        assert modclass.classify(x[k].to(dev))[0] == \
            modclass.classify(x[k])[0]


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_estimate_cir_on_card_equals_cpu(dtype):
    """The CIR within 1e-5 x max|cir| (complex64) or 1e-12 (complex128)
    of the CPU's; significance flags equal."""
    from solid_dsp_tpu_torch.models import sounder

    dev = require_cuda()
    tx = sounder.sound(255, 7, 64, repeats=16, device="cpu").numpy()
    h = np.zeros(40, np.complex128)
    h[0], h[5], h[31] = 1.0, 0.5j, -0.3
    rng = np.random.default_rng(6)
    rx = np.convolve(tx, h)[: len(tx)] + 0.05 * (
        rng.standard_normal(len(tx)) + 1j * rng.standard_normal(len(tx)))
    x = torch.from_numpy(rx).to(dtype)
    a, ia = sounder.estimate_cir(x.to(dev), 255, 7, 64, 16, 40)
    b, ib = sounder.estimate_cir(x, 255, 7, 64, 16, 40)
    tol = 1e-5 if dtype == torch.complex64 else 1e-12
    assert a.dtype == b.dtype
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.max(np.abs(b)))
    np.testing.assert_array_equal(ia["significant"], ib["significant"])
    assert np.nonzero(ia["significant"])[0].tolist() == [0, 5, 31]
    assert sounder.sound(63, 5, 8).is_cuda


def test_metrics_and_benchmark_on_a_card_chain():
    """MetricsCollector over a config-4 chain on the card: its rssi_db is
    -20 log10 of the state's AGC gain, equal to the CPU chain's within
    1e-4 dB; benchmark waits for the card."""
    from solid_dsp_tpu_torch.models.rx_chain import RxChain
    from solid_dsp_tpu_torch.utils import (MetricsCollector, benchmark,
                                           rssi_db)

    dev = require_cuda()
    cfg = RxChainConfig(carrier_freq=0.2, decimation=4, fir_taps=64,
                        agc_mode="block", demod="fm", nco_mode="exact",
                        input_format="planar", fused_ddc="on",
                        fir_precision="x3")
    chain, cpu = RxChain(cfg, device=dev), RxChain(cfg, device="cpu")
    mc, mc_cpu = MetricsCollector(), MetricsCollector()
    before = cuda_ddc.ddc_fm_cuda.launches
    for xb in make_blocks(3, L=L_SMALL, seed=8):
        out = mc.measure(chain, torch.from_numpy(xb))
        mc_cpu.measure(cpu, torch.from_numpy(xb))
        assert out.is_cuda
    assert cuda_ddc.ddc_fm_cuda.launches == before + 3
    for m, c in zip(mc.history, mc_cpu.history):
        assert m.rssi_db == rssi_db(m.agc_gain)
        assert abs(m.rssi_db - c.rssi_db) <= 1e-4
    assert mc.history[-1].agc_gain == float(chain.state["agc"]["gain"])
    x = torch.from_numpy(make_blocks(1, L=L_SMALL)[0]).to(dev)
    res = benchmark(chain.execute_block, x, warmup=1, iters=5,
                    samples=L_SMALL)
    assert res["seconds_per_call"] > 0 and res["msamples_per_second"] > 0
