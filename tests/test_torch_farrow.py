"""Port vs JAX package: the Farrow grid resampler (ops/gridresample.py,
ops/farrow.py, K8 in ops/cuda_resample.py) and its state's interop.

The same inputs, made with numpy from a seed, go through both packages; the
JAX side runs K8 in interpret mode as tests/test_resample.py does.  Gates:
grid positions bit-equal (base int32 and mu float32); the Lagrange basis to
float32 rounding; the resamplers within 1e-5 at complex64 (the gate of
tests/test_resample.py's kernel test) and 1e-6 at complex128 (the grid's
mu and so the Lagrange basis are float32 on both sides, and XLA and
PyTorch round the basis's products an ulp apart), with n_valid, t0 and the
tail equal, over 3 blocks with the state carried.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.ops import farrow as jfarrow
from solid_dsp_tpu.ops import gridresample as jgrid
from solid_dsp_tpu.ops import pallas_resample as jpallas_resample
from solid_dsp_tpu_torch import interop
from solid_dsp_tpu_torch.ops import cuda_resample, farrow, gridresample
from torch_parity import snr_db

RATIOS = [48000 / 44100, 1 / 16, 32.0, 1.0]


def _x(n, seed, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        dtype)


@pytest.mark.parametrize("ratio", RATIOS + [0.73, 3.3])
@pytest.mark.parametrize("L", [3, 8192, 1 << 24])
def test_plan_ratio_matches_jax(ratio, L):
    assert vars(gridresample.plan_ratio(ratio, L)) == \
        vars(jgrid.plan_ratio(ratio, L))


@pytest.mark.parametrize("ratio,L", [(0.05, 100), (33.0, 100), (1.0, 0),
                                     (1.0, (1 << 24) + 1)])
def test_plan_ratio_envelope_raises_like_jax(ratio, L):
    with pytest.raises(ValueError) as got:
        gridresample.plan_ratio(ratio, L)
    with pytest.raises(ValueError) as want:
        jgrid.plan_ratio(ratio, L)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("ratio", RATIOS)
def test_grid_positions_bit_equal(ratio):
    """base and mu for k < 2^20 + 5000 and several carried t0 in [0, R):
    bit-equal to the JAX package's; n_valid and t0' equal."""
    plan = gridresample.plan_ratio(ratio, 8192)
    n = (1 << 20) + 5000
    for t0 in (0, 1, plan.R // 3, plan.R - 1):
        base, mu = gridresample.grid_positions(plan, torch.tensor(
            t0, dtype=torch.int32), n)
        jb, jm = jgrid.grid_positions(plan, jnp.int32(t0), n)
        assert base.dtype == torch.int32 and mu.dtype == torch.float32
        np.testing.assert_array_equal(base.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(mu.numpy().view(np.int32),
                                      np.asarray(jm).view(np.int32))
        assert int(gridresample.grid_n_valid(plan, t0)) == \
            int(jgrid.grid_n_valid(plan, jnp.int32(t0)))
        assert int(gridresample.grid_advance(plan, t0)) == \
            int(jgrid.grid_advance(plan, jnp.int32(t0)))


def test_grid_positions_bit_equal_up_to_2_24():
    """The largest block (L = 2^24 at ratio 1: k up to 2^24, every digit of
    k in use): bit-equal to JAX's."""
    plan = gridresample.plan_ratio(1.0 - 1e-6, 1 << 24)
    t0 = plan.R // 2
    base, mu = gridresample.grid_positions(plan, t0, plan.n_pad)
    jb, jm = jgrid.grid_positions(plan, jnp.int32(t0), plan.n_pad)
    assert plan.n_pad > 1 << 24
    np.testing.assert_array_equal(base.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(mu.numpy().view(np.int32),
                                  np.asarray(jm).view(np.int32))


def test_lagrange_coeffs_match_jax():
    mu = np.random.default_rng(1).random(1000)
    for dt, rtol in ((np.float32, 1e-6), (np.float64, 1e-14)):
        got = farrow.lagrange_coeffs(torch.from_numpy(mu.astype(dt))).numpy()
        ref = np.asarray(jfarrow.lagrange_coeffs(jnp.asarray(mu.astype(dt))))
        assert got.shape == (1000, 4) and got.dtype == dt
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-14)


def _run_jax(apply, state, blocks):
    outs = []
    for b in blocks:
        y, nv, state = apply(state, jnp.asarray(b))
        outs.append((np.asarray(y), int(nv)))
    return outs, state


def _run_port(apply, state, blocks):
    outs = []
    for b in blocks:
        y, nv, state = apply(state, torch.from_numpy(b))
        outs.append((y.numpy(), int(nv)))
    return outs, state


def _assert_same(outs, jouts, atol):
    for (y, nv), (jy, jnv) in zip(outs, jouts):
        assert nv == jnv and y.shape == jy.shape and y.dtype == jy.dtype
        np.testing.assert_allclose(y, jy, rtol=0, atol=atol)
        assert not np.any(y[nv:])


@pytest.mark.parametrize("ratio", [48000 / 44100, 0.5, 3.3])
@pytest.mark.parametrize("dtype,atol", [(np.complex64, 1e-5),
                                        (np.complex128, 1e-6)])
def test_make_farrow_resampler_matches_jax(ratio, dtype, atol):
    """The torch-ops grid engine over 3 blocks, state carried: outputs,
    n_valid, the tail and t0 as JAX's."""
    L = 4096
    blocks = np.split(_x(3 * L, 2, dtype), 3)
    init, apply, plan = farrow.make_farrow_resampler(
        ratio, L, torch.complex64 if dtype == np.complex64
        else torch.complex128, device="cpu")
    jinit, japply, jplan = jfarrow.make_farrow_resampler(ratio, L, dtype)
    assert vars(plan) == vars(jplan)
    outs, st = _run_port(apply, init(), blocks)
    jouts, jst = _run_jax(japply, jinit(), blocks)
    _assert_same(outs, jouts, atol)
    np.testing.assert_allclose(st[0].numpy(), np.asarray(jst[0]), atol=0)
    assert int(st[1]) == int(jst[1]) and st[1].dtype == torch.int32


@pytest.mark.parametrize("ratio", [48000 / 44100, 0.37, 5.0])
def test_farrow_resampler_class_matches_jax(ratio):
    """FarrowResampler (host-anchored positions) over 3 blocks of
    different lengths: the same output counts, and >= 70 dB against JAX's
    (the class's own contract: positions expanded in float32 over a
    1024-output chunk hold the interpolation above 70 dB, and XLA and
    PyTorch round that expansion differently)."""
    x = _x(3000, 3)
    port = farrow.FarrowResampler(ratio, device="cpu")
    ref = jfarrow.FarrowResampler(ratio)
    for blk in (x[:1000], x[1000:1001], x[1001:]):
        y = port.execute_block(torch.from_numpy(blk)).numpy()
        jy = np.asarray(ref.execute_block(jnp.asarray(blk)))
        assert y.shape == jy.shape
        if y.size:
            assert snr_db(y, jy) >= 70.0
    assert abs(port._t_next - ref._t_next) < 1e-9
    assert repr(port) == repr(ref)
    port.reset()
    assert port._t_next == 0.0 and not port._tail.any()
    with pytest.raises(ValueError):
        farrow.FarrowResampler(0.0, device="cpu")


def test_k8_plain_matches_interpret_pallas():
    """make_farrow_kernel_resampler on CPU tensors (K8's plain version) vs
    the JAX kernel in interpret mode, L = 8192, ratio 48000/44100, 3
    blocks with the state carried: atol 1e-5, n_valid equal."""
    ratio, L = 48000 / 44100, 8192
    blocks = np.split(_x(3 * L, 7), 3)
    init, apply, plan = cuda_resample.make_farrow_kernel_resampler(
        ratio, L, device="cpu")
    jinit, japply, _ = jpallas_resample.make_farrow_kernel_resampler(
        ratio, L, interpret=True)
    before = cuda_resample.farrow_grid_cuda.launches
    outs, st = _run_port(apply, init(), blocks)
    jouts, jst = _run_jax(japply, jinit(), blocks)
    assert cuda_resample.farrow_grid_cuda.launches == before
    _assert_same(outs, jouts, 1e-5)
    assert int(st[1]) == int(jst[1])
    np.testing.assert_array_equal(st[0].numpy(), np.asarray(jst[0]))


def test_k8_engine_cuda_refuses_cpu_tensors():
    init, apply, _ = cuda_resample.make_farrow_kernel_resampler(
        1.5, 1024, device="cpu", engine="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        apply(init(), torch.zeros(1024, dtype=torch.complex64))


def test_farrow_state_interop_both_ways():
    """The (tail (3,) complex64, t0 int32) state crosses as numpy: JAX's
    state after block 1 continues in the port, the port's in JAX, each
    equal to the other side's own continuation."""
    ratio, L = 48000 / 44100, 2048
    b1, b2 = np.split(_x(2 * L, 9), 2)
    jinit, japply, _ = jfarrow.make_farrow_resampler(ratio, L)
    init, apply, _ = farrow.make_farrow_resampler(ratio, L, device="cpu")
    _, jst1 = _run_jax(japply, jinit(), [b1])
    (want,), _ = _run_jax(japply, jst1, [b2])
    st = interop.tensors_from_numpy(
        jax.tree_util.tree_map(np.asarray, jst1), "cpu")
    assert st[0].dtype == torch.complex64 and st[1].dtype == torch.int32
    (got,), _ = _run_port(apply, st, [b2])
    _assert_same([got], [want], 1e-5)
    _, pst1 = _run_port(apply, init(), [b1])
    back = interop.tensors_to_numpy(pst1)
    assert back[1].dtype == np.int32 and back[0].shape == (3,)
    (jgot,), _ = _run_jax(japply, tuple(jnp.asarray(a) for a in back), [b2])
    _assert_same([jgot], [want], 1e-5)
