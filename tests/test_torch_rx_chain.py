"""The port's receive chain vs the JAX package's, and the port's contracts.

Four blocks of L = 131072 samples with the state carried.  Tolerances, the
JAX package's own gates (tests/test_rx_chain_fused.py, test_epilogue.py):
audio >= 90 dB at fir_precision="x3" (JAX x3 splits into bf16 pairs, the
port computes in FP32) and >= 100 dB at "highest"; the phase word bit-equal
and the FIR tail exactly equal (both are copies of input samples and
integer arithmetic); AGC gain and energy rtol 1e-5 (float32 sums in another
order); fm_prev rtol 1e-4 (the JAX x3 kernel's seam error).

The chain through the CUDA kernel runs only on the card:
tests/test_torch_cuda.py.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from solid_dsp_tpu_torch.device import resolve_device
from solid_dsp_tpu_torch.interop import state_from_numpy, state_to_numpy
from solid_dsp_tpu_torch.models.rx_chain import (RxChain, RxChainConfig,
                                                  make_rx_chain,
                                                  make_rx_chain_stream)
from solid_dsp_tpu_torch.streaming.state import ChainState
from torch_parity import (CONFIG4, as_format, make_blocks, run_jax, run_torch,
                          snr_db)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _check_state(st, jst, fm_rtol=1e-4):
    got = state_to_numpy(st)
    assert got["nco_theta"].dtype == np.uint32
    assert got["nco_theta"] == jst["nco_theta"]
    np.testing.assert_array_equal(got["fir_tail"], jst["fir_tail"])
    for k in ("gain", "energy"):
        np.testing.assert_allclose(got["agc"][k], jst["agc"][k], rtol=1e-5)
    for k in ("lock", "mode", "timer"):
        assert got["agc"][k] == jst["agc"][k]
    np.testing.assert_allclose(got["fm_prev"], jst["fm_prev"], rtol=fm_rtol)
    assert got["fir_phase"] == jst["fir_phase"]


@pytest.mark.parametrize("jax_engine", ["pallas", "xla"])
def test_chain_x3_matches_jax(jax_engine):
    """x3, 4 blocks: >= 90 dB against JAX's interpret-mode K1 and its XLA
    path; state as in the module docstring."""
    blocks = make_blocks(4)
    want, jst = run_jax(blocks, ddc_engine=jax_engine)
    got, st = run_torch(blocks)
    assert got.shape == want.shape and got.dtype == np.float32
    assert snr_db(got, want) >= 90.0
    _check_state(st, jst)


def test_chain_highest_matches_jax_xla():
    """fir_precision='highest' against JAX's XLA chain: >= 100 dB."""
    blocks = make_blocks(4, seed=11)
    want, jst = run_jax(blocks, ddc_engine="xla", fir_precision="highest")
    got, st = run_torch(blocks, fir_precision="highest")
    assert snr_db(got, want) >= 100.0
    _check_state(st, jst)


def test_state_round_trip_and_resume_from_jax_state():
    """JAX state -> port -> numpy is lossless, and a port chain resumed
    from the JAX state after block 2 matches the uninterrupted JAX run
    (>= 90 dB, state as above)."""
    blocks = make_blocks(4, seed=5)
    want, jst_end = run_jax(blocks, ddc_engine="xla")
    _, jst2 = run_jax(blocks[:2], ddc_engine="xla")
    st2 = state_from_numpy(jst2, "cpu")
    assert st2["nco_theta"].dtype == torch.int64
    back = state_to_numpy(st2)
    for key in ("nco_theta", "fir_tail", "fir_phase", "fm_prev"):
        assert back[key].dtype == jst2[key].dtype
        np.testing.assert_array_equal(back[key], jst2[key])
    for key in jst2["agc"]:
        np.testing.assert_array_equal(back["agc"][key], jst2["agc"][key])
    got, st = run_torch(blocks[2:], state=st2)
    half = want.size // 2
    assert snr_db(got, want[half:]) >= 90.0
    _check_state(st, jst_end)


def test_checkpoint_save_load_round_trip(tmp_path):
    blocks = make_blocks(1, seed=9)
    _, st = run_torch(blocks)
    path = st.save(str(tmp_path / "ckpt"))
    init, _ = make_rx_chain(RxChainConfig(**CONFIG4), "cpu")
    back = ChainState.load(path, like=init())
    a, b = state_to_numpy(back), state_to_numpy(st)
    for key in ("nco_theta", "fir_tail", "fir_phase", "fm_prev"):
        np.testing.assert_array_equal(a[key], b[key])
    with np.load(path) as data:
        assert data["leaf_8"].dtype == np.uint32      # nco_theta, sorted last
    like_bad = init().replace(fir_tail=torch.zeros(10, dtype=torch.complex64))
    with pytest.raises(ValueError, match="fir_tail"):
        ChainState.load(path, like=like_bad)


def test_rx_chain_module_execute_block_and_reset():
    blocks = make_blocks(2, seed=3)
    chain = RxChain(RxChainConfig(**CONFIG4), device="cpu")
    assert isinstance(chain, torch.nn.Module)
    a = [chain.execute_block(b) for b in blocks]
    chain.reset()
    assert int(chain.state["nco_theta"]) == 0
    again = chain.execute_block(blocks[0])
    assert torch.equal(again, a[0])
    want, _ = run_torch(blocks)
    np.testing.assert_array_equal(torch.cat(a).numpy(), want)


def test_rx_chain_module_keeps_ci16_int16():
    """execute_block hands int16 IQ to the chain as int16 (numpy or torch,
    any other dtype cast to it) and matches the chain's apply."""
    blocks = as_format(make_blocks(2, seed=4), "ci16")
    cfg = RxChainConfig(**{**CONFIG4, "input_format": "ci16"})
    chain = RxChain(cfg, device="cpu")
    a = [chain.execute_block(b) for b in blocks]
    want, _ = run_torch(blocks, input_format="ci16")
    np.testing.assert_array_equal(torch.cat(a).numpy(), want)
    chain.reset()
    again = chain.execute_block(torch.from_numpy(blocks[0].astype(np.int32)))
    assert torch.equal(again, a[0])


def test_port_never_imports_jax():
    """Importing the port and running FM, QPSK and ci16 chain blocks and
    config 5's channelizers (all backends), synthesis and oversampled banks,
    ChannelBank and SpectrumMonitor, config 2's FFT engine (every backend,
    the windowed FFT's routes, matfft, spectrogram, Welch), analysis/, the
    Farrow resamplers, parallel/ on a one-rank gloo group (the K9 front
    end, both sharded channelizers, the sharded chain and its state
    interop, the sharded FIR), the IIR design and filters (both methods),
    zero-phase filtering, the autocorrelator, CIC, halfband and arbitrary
    resamplers (both paths, with flush), the FM stereo back end and the DDC
    loads no jax module and no module of the JAX
    package (fresh interpreter: this one has jax)."""
    code = (
        "import sys, numpy as np, torch\n"
        "from solid_dsp_tpu_torch.models.rx_chain import RxChainConfig, "
        "make_rx_chain\n"
        "init, apply = make_rx_chain(RxChainConfig(input_format='planar'), 'cpu')\n"
        "x = torch.from_numpy(np.ones((2, 4096), np.float32))\n"
        "out, st = apply(init(), x)\n"
        "assert out.shape == (1024,)\n"
        "init, apply = make_rx_chain(RxChainConfig(input_format='planar', "
        "demod='qpsk'), 'cpu')\n"
        "out, st = apply(init(), torch.randn(2, 4000))\n"
        "assert out.shape == (1000,) and out.dtype == torch.complex64\n"
        "init, apply = make_rx_chain(RxChainConfig(input_format='ci16'), 'cpu')\n"
        "xi = torch.randint(-900, 900, (4100, 2), dtype=torch.int16)\n"
        "out, st = apply(init(), xi)\n"
        "assert out.shape == (1025,)\n"
        "from solid_dsp_tpu_torch.models.channelizer import ("
        "PolyphaseChannelizer, PolyphaseSynthesizer, OversampledChannelizer)\n"
        "from solid_dsp_tpu_torch.models.channel_bank import ChannelBank\n"
        "from solid_dsp_tpu_torch.models.monitor import SpectrumMonitor\n"
        "import solid_dsp_tpu_torch.interop\n"
        "xc = torch.randn(2048, dtype=torch.complex64)\n"
        "for be in ('xla', 'fused', 'pallas'):\n"
        "    Y = PolyphaseChannelizer(16, backend=be, device='cpu')"
        ".execute_block(xc)\n"
        "    assert Y.shape == (128, 16)\n"
        "PolyphaseSynthesizer(16, device='cpu').execute_block(Y)\n"
        "OversampledChannelizer(16, device='cpu').execute_block(xc)\n"
        "bank = ChannelBank(16, backend='fused', agc_bandwidth=0.05, "
        "squelch_high_db=-20.0, device='cpu')\n"
        "assert bank.execute_block(xc).shape == (128, 16)\n"
        "SpectrumMonitor(16, backend='fused', device='cpu').execute_block(xc)\n"
        "import solid_dsp_tpu_torch.analysis as an\n"
        "from solid_dsp_tpu_torch.ops import (cuda_fft, cuda_resample, fft, "
        "farrow, gridresample, matfft)\n"
        "xf = torch.randn(8, 4096, dtype=torch.complex64)\n"
        "for be in ('auto', 'fused', 'xla'):\n"
        "    assert fft.windowed_fft(xf, 'hamming', backend=be).shape == "
        "(8, 4096)\n"
        "assert fft.windowed_fft_planar(torch.randn(2, 8, 4096)).shape == "
        "(8, 8192)\n"
        "for be in ('plan', 'matmul', 'bluestein', 'xla'):\n"
        "    fft.fft(xc[:97], backend=be)\n"
        "matfft.ifft_mx(xc[:300])\n"
        "fft.spectrogram(xc, 256); fft.welch_psd(xc, 256)\n"
        "an.stft_denoise(xc, 256, 64); an.goertzel_bank(xc, (0.1,), 256)\n"
        "an.fir_group_delay(np.ones(5), 0.1)\n"
        "for mk in (farrow.make_farrow_resampler, "
        "cuda_resample.make_farrow_kernel_resampler):\n"
        "    init, apply, plan = mk(48000 / 44100, 2048, device='cpu')\n"
        "    y, nv, st = apply(init(), xc)\n"
        "farrow.FarrowResampler(1.5, device='cpu').execute_block(xc)\n"
        "import tempfile, torch.distributed as dist\n"
        "from solid_dsp_tpu_torch import parallel\n"
        "from solid_dsp_tpu_torch.ops import cuda_halo\n"
        "parallel.init_distributed('cpu', tempfile.mkdtemp() + '/store', 0, 1)\n"
        "mesh = parallel.make_mesh(1, 1, device='cpu')\n"
        "k9 = parallel.pallas_halo.make_fused_channelizer_frontend(mesh, 16, 8)\n"
        "z, t = k9(torch.zeros((8, 16), dtype=torch.complex64), xc)\n"
        "for fe in ('xla', 'fused'):\n"
        "    init, apply = parallel.make_sharded_channelizer(16, 8, mesh, "
        "frontend=fe)\n"
        "    Y, t = apply(init(), xc)\n"
        "init, apply = parallel.make_sharded_rx_chain(RxChainConfig("
        "input_format='planar'), mesh)\n"
        "out, st = apply(init(), x)\n"
        "solid_dsp_tpu_torch.interop.sharded_state_to_numpy(st, mesh)\n"
        "parallel.sharded_fir(np.ones(5), mesh)(torch.zeros(2, 4), "
        "torch.ones(2, 64))\n"
        "dist.destroy_process_group()\n"
        "from solid_dsp_tpu_torch.design import iirdes, polymath\n"
        "from solid_dsp_tpu_torch.ops import (autocorr, cic, halfband, iir, "
        "resample, zerophase)\n"
        "from solid_dsp_tpu_torch.models import channel, ddc, fm\n"
        "sos = iirdes.iirdes_sos('elliptic', 4, 0.1)\n"
        "polymath.find_roots([1.0, 2.0, 3.0])\n"
        "for m in ('scan', 'parallel'):\n"
        "    f = iir.IIRFilter(*iirdes.sos_to_iir_coeffs(sos), "
        "'second_order', torch.complex64, method=m, device='cpu')\n"
        "    f.execute_block(xc)\n"
        "zerophase.filtfilt_sos(sos[:, :3], sos[:, 3:], np.ones(512), "
        "method='scan')\n"
        "autocorr.AutoCorrelator(8, 3, device='cpu').execute_block(xc)\n"
        "cic.CICDecimator(8, 4, device='cpu').execute_block(xc)\n"
        "cic.CICInterpolator(4, device='cpu').execute_block(xc)\n"
        "halfband.MultistageDecimator(16, device='cpu').execute_block(xc)\n"
        "resample.HalfbandInterpolator(device='cpu').execute_block(xc)\n"
        "for bl in (None, 2048):\n"
        "    r = resample.ArbitraryResampler(0.37, block_len=bl, "
        "device='cpu')\n"
        "    r.execute_block(xc); r.flush()\n"
        "L2, R2, p2 = fm.fm_stereo_decode(fm.fm_stereo_mpx(torch.ones(4096), "
        "torch.zeros(4096), 192000.0), 192000.0, deemphasis_tau=75e-6)\n"
        "ddc.DDC(0.5, ratio=48000 / 44100, device='cpu').execute_block(xc)\n"
        "channel.host_wrapped_phase(16, 0.1)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'solid_dsp_tpu' or m.startswith('solid_dsp_tpu.')]\n"
        "print('BAD', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "BAD []" in r.stdout, r.stdout


def test_rx_chain_stream_raises_not_implemented():
    """The stream loop, ported: 3 blocks in one call equal 3 calls of the
    block chain exactly, and debug_checks is refused as in the JAX
    package."""
    blocks = make_blocks(3, L=8192, seed=4)
    init, apply_stream = make_rx_chain_stream(RxChainConfig(**CONFIG4), 8192,
                                              "cpu")
    got, st = apply_stream(init(), torch.from_numpy(np.concatenate(blocks,
                                                                   axis=1)))
    want, st_w = run_torch(blocks)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(st["nco_theta"]) == int(st_w["nco_theta"])
    with pytest.raises(ValueError, match="debug_checks"):
        make_rx_chain_stream(RxChainConfig(**{**CONFIG4,
                                              "debug_checks": True}), 4096)


@pytest.mark.parametrize("override", [dict(agc_mode="fast"),
                                      dict(ddc_engine="pallas"),
                                      dict(nco_mode="lut")])
def test_invalid_settings_raise_value_error(override):
    with pytest.raises(ValueError):
        make_rx_chain(RxChainConfig(**{**CONFIG4, **override}), "cpu")


@pytest.mark.parametrize("fmt,shape", [("planar", (2, 1002)),
                                       ("cf32", (1002,)), ("ci16", (1002, 2)),
                                       ("planar", (2, 0))])
def test_block_length_not_multiple_of_decimation_raises(fmt, shape):
    init, apply = make_rx_chain(RxChainConfig(**{**CONFIG4,
                                                 "input_format": fmt}), "cpu")
    x = torch.zeros(shape, dtype={"planar": torch.float32,
                                  "cf32": torch.complex64,
                                  "ci16": torch.int16}[fmt])
    with pytest.raises(ValueError, match="multiple of the decimation"):
        apply(init(), x)


def test_engine_cuda_on_cpu_chain_raises():
    init, apply = make_rx_chain(RxChainConfig(**{**CONFIG4,
                                                 "ddc_engine": "cuda"}), "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        apply(init(), torch.zeros((2, 4096)))


def test_entry_points_default_to_the_card():
    """``device=None`` resolves to CUDA (checked without allocating), and
    an entry point given no device runs on the card or, on a machine
    without one, raises PyTorch's own error instead of taking the CPU."""
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert RxChain(RxChainConfig(**CONFIG4)).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            make_rx_chain(RxChainConfig(**CONFIG4))
