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
its plain version in float64.  Windowed FFT (K7)
>= 90 dB against its plain version and float64 numpy; Farrow (K8) within
1e-5 of its plain version with n_valid, t0 and the tail equal
(tests/test_resample.py's gate).  conv1d_mxu and sharded_fir >= 100 dB
against float64 at PyTorch's default TF32 flags (the port pins full
float32; TF32 keeps some 60 dB).
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
from solid_dsp_tpu_torch.ops import (cuda_chan, cuda_ddc, cuda_fft, cuda_iir,
                                     cuda_resample, farrow, nco)
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
