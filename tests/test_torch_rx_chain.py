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

from solid_dsp_tpu_torch.interop import state_from_numpy, state_to_numpy
from solid_dsp_tpu_torch.models.rx_chain import (RxChain, RxChainConfig,
                                                  make_rx_chain)
from solid_dsp_tpu_torch.streaming.state import ChainState
from torch_parity import CONFIG4, make_blocks, run_jax, run_torch, snr_db

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
    init, _ = make_rx_chain(RxChainConfig(**CONFIG4))
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
    chain = RxChain(RxChainConfig(**CONFIG4))
    assert isinstance(chain, torch.nn.Module)
    a = [chain.execute_block(b) for b in blocks]
    chain.reset()
    assert int(chain.state["nco_theta"]) == 0
    again = chain.execute_block(blocks[0])
    assert torch.equal(again, a[0])
    want, _ = run_torch(blocks)
    np.testing.assert_array_equal(torch.cat(a).numpy(), want)


def test_port_never_imports_jax():
    """Importing the port and running a chain block loads no jax module and
    no module of the JAX package (fresh interpreter: this one has jax)."""
    code = (
        "import sys, numpy as np, torch\n"
        "from solid_dsp_tpu_torch.models.rx_chain import RxChainConfig, "
        "make_rx_chain\n"
        "init, apply = make_rx_chain(RxChainConfig(input_format='planar'))\n"
        "x = torch.from_numpy(np.ones((2, 4096), np.float32))\n"
        "out, st = apply(init(), x)\n"
        "assert out.shape == (1024,)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'solid_dsp_tpu' or m.startswith('solid_dsp_tpu.')]\n"
        "print('BAD', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "BAD []" in r.stdout, r.stdout


@pytest.mark.parametrize("override", [
    dict(demod="am"), dict(demod="qpsk"), dict(agc_mode="exact"),
    dict(agc_mode="parallel"), dict(input_format="cf32"),
    dict(input_format="ci16"), dict(fused_ddc="off"),
    dict(nco_mode="lut", fused_ddc="auto"), dict(impairment_bw=0.1),
    dict(debug_checks=True), dict(epilogue="rotate"),
    dict(fir_precision="default"), dict(dtype=torch.complex128),
    dict(fir_taps=4), dict(fir_taps=300),
])
def test_unported_settings_raise_not_implemented(override):
    """Each setting outside the collapsed FM branch names its ROADMAP item."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue"):
        make_rx_chain(RxChainConfig(**{**CONFIG4, **override}))


@pytest.mark.parametrize("override", [dict(agc_mode="fast"),
                                      dict(ddc_engine="pallas"),
                                      dict(nco_mode="lut")])
def test_invalid_settings_raise_value_error(override):
    with pytest.raises(ValueError):
        make_rx_chain(RxChainConfig(**{**CONFIG4, **override}))


@pytest.mark.parametrize("L", [1000, 4096 + 4, 128])
def test_block_length_not_multiple_of_256_raises(L):
    """The JAX chain takes its pieces path (K2) there: not ported."""
    init, apply = make_rx_chain(RxChainConfig(**CONFIG4))
    with pytest.raises(ValueError, match="multiple of 256"):
        apply(init(), torch.zeros((2, L)))


def test_engine_cuda_on_cpu_chain_raises():
    init, apply = make_rx_chain(RxChainConfig(**{**CONFIG4,
                                                 "ddc_engine": "cuda"}))
    with pytest.raises(ValueError, match="CUDA"):
        apply(init(), torch.zeros((2, 4096)))
