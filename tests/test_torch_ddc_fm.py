"""The fused DDC + FM body (K1) and its glue: port vs JAX package.

The JAX side runs K1 itself, ``make_pallas_ddc_fm`` in interpret mode, as
the JAX package's own tests do on the CPU.  Its x3 mode splits operands
into bf16 pairs (~1e-5 relative per product); the port computes in FP32.
Tolerances, from the JAX package's own gates: audio >= 90 dB past index 0
(output 0 is left for the glue), energy and z_first / z_last rtol 1e-5;
after the glue, audio >= 90 dB including the exact output 0 (atol 1e-4),
fm_prev rtol 1e-4, ee_mean rtol 1e-5, phase word and tail exact.

The kernel itself runs only on the card: tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.ops import ddc as jddc
from solid_dsp_tpu.ops import pallas_ddc as jpallas_ddc
from solid_dsp_tpu_torch.models.rx_chain import RxChainConfig
from solid_dsp_tpu_torch.ops import cuda_ddc, ddc, nco
from torch_parity import L_SMALL, snr_db

KF = 0.1
M = 4


def _body(device="cpu", n=64, M=M, fc=0.2, dtype=torch.float32):
    taps = RxChainConfig(fir_taps=n).design_taps()
    return cuda_ddc.make_ddc_fm(taps, nco.constrain(fc), M, KF, device,
                                dtype)


def _inputs(seed, L=L_SMALL, D=60):
    rng = np.random.default_rng(seed)
    k = np.arange(L)
    x = 0.5 * np.exp(1j * 0.21 * k) + 0.1 * (rng.standard_normal(L)
                                            + 1j * rng.standard_normal(L))
    x2 = np.stack([x.real, x.imag]).astype(np.float32)
    tail = (0.3 * rng.standard_normal((2, D))).astype(np.float32)
    return x2, tail


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_k1_matches_jax_interpret_kernel(seed):
    """Port's plain K1 vs JAX make_pallas_ddc_fm(interpret=True), same
    taps: audio[1:] >= 90 dB; energy, z_first, z_last rtol 1e-5."""
    body = _body()
    x2, tail = _inputs(seed)
    audio, stats = cuda_ddc.ddc_fm_torch(body, torch.from_numpy(x2),
                                         torch.from_numpy(tail))
    n, P = body.n, cuda_ddc.DEFAULT_P
    hop, D = P * M, n - M
    h_bp = jddc.ddc_taps(RxChainConfig().design_taps(), np.uint32(body.dtheta))
    TF = jpallas_ddc.DEFAULT_TF
    tiles = L_SMALL // hop // TF
    fn = jpallas_ddc.make_pallas_ddc_fm(h_bp, M, tiles, np.uint32(body.dw), KF,
                                        TF=TF, mode="x3", interpret=True)
    tailrow = np.zeros((2, jpallas_ddc.HALO_FRAMES, hop), np.float32)
    tailrow[:, -1, hop - D:] = tail
    a2, s8 = fn(jnp.asarray(x2.reshape(2, -1, hop)), jnp.asarray(tailrow))
    want = np.asarray(a2)[:, :P].reshape(-1)
    st = np.asarray(s8).reshape(tiles, 8, 128)[:, 0, :]
    assert audio.shape == want.shape
    assert snr_db(audio.numpy()[1:], want[1:]) >= 90.0
    got = stats.numpy()
    np.testing.assert_allclose(got[0], st[:, 0].sum(), rtol=1e-5)
    np.testing.assert_allclose(got[1:3], st[-1, 1:3], rtol=1e-5)
    np.testing.assert_allclose(got[3:5], st[0, 3:5], rtol=1e-5)


@pytest.mark.parametrize("seed,theta0", [(2, 0), (3, 0xFFFFF000),
                                         (4, 1234567890)])
def test_ddc_fm_fused_glue_matches_jax(seed, theta0):
    """Port's ddc_fm_fused vs the JAX one at engine='pallas' (interpret):
    audio incl. the exact audio[0], fm_prev, ee_mean, theta_end, tail."""
    body = _body()
    x2, _ = _inputs(seed)
    rng = np.random.default_rng(seed + 100)
    tail2 = (0.3 * rng.standard_normal((2, 63))).astype(np.float32)
    prev_re, prev_im, gain = (np.float32(v) for v in (0.8, -0.4, 1.3))
    got = ddc.ddc_fm_fused(
        body, torch.from_numpy(tail2), torch.tensor(theta0, dtype=torch.int64),
        torch.from_numpy(x2), torch.tensor(prev_re), torch.tensor(prev_im),
        torch.tensor(gain))
    want = jddc.ddc_fm_fused(
        RxChainConfig().design_taps(), np.uint32(body.dtheta),
        jnp.asarray(tail2), jnp.uint32(theta0), jnp.asarray(x2), M, "x3", KF,
        jnp.float32(prev_re), jnp.float32(prev_im), jnp.float32(gain),
        engine="pallas")
    out, pr, pi, ee, tail_n, theta_end = (
        t.numpy() if isinstance(t, torch.Tensor) else t for t in got)
    w_out, w_pr, w_pi, w_ee, w_tail, w_theta = (np.asarray(t) for t in want)
    assert out.shape == w_out.shape
    assert snr_db(out, w_out) >= 90.0
    np.testing.assert_allclose(out[0], w_out[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose([pr, pi], [w_pr, w_pi], rtol=1e-4)
    np.testing.assert_allclose(ee, w_ee, rtol=1e-5)
    np.testing.assert_array_equal(tail_n, w_tail)
    assert int(theta_end) == int(w_theta)


def test_engine_cuda_on_cpu_tensor_raises():
    """ddc_engine='cuda' never falls back: a CPU tensor raises."""
    body = _body()
    x2, tail = _inputs(0, L=1024)
    with pytest.raises(ValueError, match="CUDA"):
        body(torch.from_numpy(x2), torch.from_numpy(tail), engine="cuda")
    with pytest.raises(ValueError, match="unknown ddc_engine"):
        body(torch.from_numpy(x2), torch.from_numpy(tail), engine="xla")


@pytest.mark.parametrize("L", [1000, 256 * 3 + 4, 0])
def test_block_length_not_multiple_of_frame_raises(L):
    body = _body()
    x2, tail = _inputs(0, L=max(L, 1))
    with pytest.raises(ValueError):
        cuda_ddc.ddc_fm_torch(body, torch.from_numpy(x2[:, :L]),
                              torch.from_numpy(tail))


def test_auto_engine_takes_plain_version_on_cpu():
    """engine='auto' on CPU tensors == the plain version, no launch."""
    body = _body()
    x2, tail = (torch.from_numpy(a) for a in _inputs(5, L=4096))
    before = cuda_ddc.ddc_fm_cuda.launches
    a, s = body(x2, tail, engine="auto")
    b, t = cuda_ddc.ddc_fm_torch(body, x2, tail)
    assert torch.equal(a, b) and torch.equal(s, t)
    assert cuda_ddc.ddc_fm_cuda.launches == before


@pytest.mark.parametrize("n,M,threads", [(64, 4, 256), (64, 32, 128),
                                         (64, 2, 256), (513, 16, 256),
                                         (128, 64, 64)])
def test_launch_geometry_fits_shared_memory(n, M, threads):
    """The largest thread block whose staged span fits 227 KB."""
    got_threads, tbo, smem = cuda_ddc.launch_geometry(n, M)
    assert got_threads == threads and tbo == 4 * threads
    assert smem <= 227 * 1024


def test_launch_geometry_too_large_raises():
    with pytest.raises(ValueError, match="shared-memory"):
        cuda_ddc.launch_geometry(512, 256)


def test_plain_f64_matches_f32_body():
    """The plain version in float64 (the card's reference for the kernel)
    agrees with float32 to >= 100 dB."""
    x2, tail = _inputs(6, L=8192)
    a32, _ = cuda_ddc.ddc_fm_torch(_body(), torch.from_numpy(x2),
                                   torch.from_numpy(tail))
    a64, _ = cuda_ddc.ddc_fm_torch(_body(dtype=torch.float64),
                                   torch.from_numpy(x2).double(),
                                   torch.from_numpy(tail).double())
    assert a64.dtype == torch.float64
    assert snr_db(a32.numpy(), a64.numpy()) >= 100.0
