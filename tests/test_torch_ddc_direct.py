"""P4 repaired: the DDC body's direct-form route at large decimations, on the
CPU.

Where the JAX package's predicates (``pallas_full_supported``,
``pallas_body_supported``) give a block to K2/K3 but the tensor-core body's
bank and spans do not fit one block's shared memory (M >~ 100),
``ops/cuda_ddc.py::body_geometry`` routes the body to the direct-form FIR of
``csrc/ddc_body.cu``, a warp an output, which needs no shared memory.  The
route is checked over the predicates' grid.  The kernel runs only on the
card (tests/test_torch_cuda.py); here its arithmetic is emulated in torch
(each lane's FP32 FMAs over its taps in order, bf16 operands in fast mode,
the warp's butterfly of shuffles) and held, at two points of P4's range
(128 taps at M = 200, 256 taps at M = 128), against the plain body
``ddc_body_torch`` (>= 120 dB: float32
sums in another order) and against JAX's K2/K3 in interpret mode: x3
>= 100 dB (tests/test_pallas_ddc.py:57-109's Pallas gate), fast >= 120 dB
(the fast mode's bf16 contract, tests/test_torch_ddc_fast.py: the same
roundings, f32 sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.ops import ddc as jddc
from solid_dsp_tpu.ops import pallas_ddc as jpd
from solid_dsp_tpu_torch.models.rx_chain import RxChainConfig
from solid_dsp_tpu_torch.ops import cuda_ddc, ddc, nco
from torch_parity import direct_dots_emulated, snr_db

FC = 0.2
P = cuda_ddc.DEFAULT_P
P4_POINTS = [(128, 200), (256, 128)]


def _taps(n, M):
    return RxChainConfig(fir_taps=n, decimation=M).design_taps()


def _body(n, M, mode):
    return cuda_ddc.make_ddc_body(_taps(n, M), nco.constrain(FC), M, "cpu",
                                  mode=mode)


def _inputs(seed, L, D):
    """A noisy tone near the carrier and a random carried tail, float32."""
    rng = np.random.default_rng(seed)
    x = 0.5 * np.exp(1j * 0.21 * np.arange(L)) + 0.1 * (
        rng.standard_normal(L) + 1j * rng.standard_normal(L))
    x2 = np.stack([x.real, x.imag]).astype(np.float32)
    return x2, (0.3 * rng.standard_normal((2, D))).astype(np.float32)


def _direct_emulated(body, x2: np.ndarray, tail: np.ndarray) -> np.ndarray:
    """csrc/ddc_body.cu's direct route in torch: every output's warp dot
    (torch_parity.direct_dots_emulated) in the body's mode."""
    return direct_dots_emulated(body.taps, body.M, x2, tail,
                                body.mode == "fast")


def _tailrow(tail, hop):
    row = np.zeros((2, jpd.HALO_FRAMES, hop), np.float32)
    if tail.shape[1]:
        row[:, -1, hop - tail.shape[1]:] = tail
    return jnp.asarray(row)


def _jax_k2(n, M, mode, x2, tail, TF):
    hop = P * M
    tiles = x2.shape[1] // hop // TF
    fn = jpd.make_pallas_ddc_full(jddc.ddc_taps(_taps(n, M),
                                                nco.constrain(FC)),
                                  M, tiles, TF=TF, mode=mode, interpret=True)
    y = np.asarray(fn(jnp.asarray(x2.reshape(2, -1, hop)),
                      _tailrow(tail, hop)))
    return np.stack([y[:, :P].reshape(-1), y[:, P:].reshape(-1)]), 0


def _jax_k3(n, M, mode, x2, TF):
    """K3 over the interior of the block, as JAX's ddc_apply_planar_raw
    places it: outputs Th .. Th + tiles TF P."""
    hop = P * M
    n1, first = n - 1, M - 1
    Th = max(-(-(n1 - first) // M), 0)
    start = first + Th * M - n1
    tiles = ((x2.shape[1] - start - n1) // hop - jpd.HALO_FRAMES) // TF
    span = (tiles * TF + jpd.HALO_FRAMES) * hop
    fn = jpd.make_pallas_ddc_body(jddc.ddc_taps(_taps(n, M),
                                                nco.constrain(FC)),
                                  M, tiles, TF=TF, mode=mode, interpret=True)
    y = np.asarray(fn(jnp.asarray(x2[:, start:start + span].reshape(
        2, -1, hop))))
    assert tiles > 0
    return np.stack([y[:, :P].reshape(-1), y[:, P:].reshape(-1)]), Th


# ----------------------------------------------------------------- routes

def _grid():
    """Every (n, M) of n <= 512, M <= 256 that the JAX package's predicates
    give to K2 or K3 (P = 64), on a stride of 5 taps with the tap counts
    around the powers of two."""
    ns = sorted(set(range(1, 513, 5)) | {2, 3, 4, 63, 64, 65, 127, 128, 129,
                                         255, 256, 257, 511, 512})
    return [(n, M) for M in range(1, 257) for n in ns
            if jpd.pallas_full_supported(n, M)
            or jpd.pallas_body_supported(n, M)]


@pytest.mark.parametrize("fast", [False, True])
def test_body_geometry_covers_jax_predicates(fast):
    """body_geometry gives a route wherever the JAX package's predicates
    take the block (n <= 512, M <= 256): the tensor-core one where its bank
    and spans fit one block's shared memory, else the direct one, which
    needs none (so also above M ~217); where n > M K1's direct route, which
    shares the body's warp dot and stages nothing either, takes the same
    geometries (launch_geometry), the largest decimations included."""
    routes = {"tc": 0, "direct": 0}
    k1_large = 0
    for n, M in _grid():
        route, geo = cuda_ddc.body_geometry.__wrapped__(n, M, fast)
        routes[route] += 1
        if route == "direct":
            assert geo is None
            with pytest.raises(ValueError):
                cuda_ddc.body_tc_geometry(n, M, fast)
            if n > M:
                assert cuda_ddc.launch_geometry(n, M) == (
                    cuda_ddc.FM_DIRECT_RUN, cuda_ddc.FM_DIRECT_WARPS)
                k1_large += M >= 218
        else:
            assert geo == cuda_ddc.body_tc_geometry(n, M, fast)
    assert routes["tc"] > 0 and routes["direct"] > 0 and k1_large > 0
    for n, M in P4_POINTS + [(512, 256), (300, 256)]:
        assert cuda_ddc.body_geometry(n, M, fast)[0] == "direct"


@pytest.mark.parametrize("n,M", P4_POINTS)
def test_p4_points_route_to_a_kernel(n, M):
    """At P4's points DdcBody.route gives a kernel (K2's route for aligned
    blocks where n > M, K3's otherwise), as JAX's predicates do."""
    body = _body(n, M, "x3")
    hop = P * M
    aligned = body.route(4 * hop)
    assert aligned is (cuda_ddc.ddc_body_cuda if n > M
                       else cuda_ddc.ddc_body_unaligned_cuda)
    assert body.route(4 * hop + 3 * M) is cuda_ddc.ddc_body_unaligned_cuda


# ------------------------------------------------------- the arithmetic

@pytest.mark.parametrize("n,M", P4_POINTS)
@pytest.mark.parametrize("mode", ["x3", "fast"])
@pytest.mark.parametrize("frames", [16, 19])
def test_direct_route_emulated_matches_plain_body(n, M, mode, frames):
    """The direct route's arithmetic against ddc_body_torch in the same
    mode: >= 120 dB, on an aligned block (16 frames) and an unaligned one
    (19 frames and 3 outputs), the carried tail in, and on a block of 2
    outputs."""
    D = max(n - M, 0)
    for L in (frames * P * M + (3 * M if frames == 19 else 0), 2 * M):
        x2, tail = _inputs(frames + n, L, D)
        body = _body(n, M, mode)
        got = _direct_emulated(body, x2, tail)
        want = ddc.ddc_body_torch(body, torch.from_numpy(x2),
                                  torch.from_numpy(tail)).numpy()
        assert got.shape == want.shape == (2, L // M)
        assert snr_db(got, want) >= 120.0


@pytest.mark.parametrize("n,M", P4_POINTS)
@pytest.mark.parametrize("mode", ["x3", "fast"])
def test_direct_route_emulated_matches_jax_kernels(n, M, mode):
    """The direct route's arithmetic against JAX's K2 (aligned blocks, n >
    M) or K3 (the interior of a block) in interpret mode, tiles of 8
    frames: x3 >= 100 dB, fast >= 120 dB."""
    D = max(n - M, 0)
    hop = P * M
    gate = 100.0 if mode == "x3" else 120.0
    body = _body(n, M, mode)
    TF = 8
    if n > M:                                       # K2: the whole block
        L = 2 * TF * hop
        x2, tail = _inputs(5, L, D)
        want, Th = _jax_k2(n, M, mode, x2, tail, TF)
    else:                                           # K3: the interior
        L = (TF + jpd.HALO_FRAMES + 1) * hop + 5 * M
        x2, tail = _inputs(6, L, D)
        want, Th = _jax_k3(n, M, mode, x2, TF)
    got = _direct_emulated(body, x2, tail)[:, Th:Th + want.shape[1]]
    assert got.shape == want.shape
    assert snr_db(got, want) >= gate
