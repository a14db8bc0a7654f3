"""K1's direct route at large decimations (the rest of P4 repaired), on the
CPU.

Where K1's tensor-core bank and spans do not fit one block's shared memory
(M >~ 100), ``ops/cuda_ddc.py::fm_geometry`` routes K1 to the direct route
of ``csrc/ddc_fm.cu``: a warp a run of R consecutive outputs, each the
body's direct-form warp dot (``csrc/ddc_direct.cuh``), the output before
the run computed first.  It stages nothing in shared memory, so it takes
every (n, M) that the JAX package's ``pallas_fm_supported`` accepts; the
staged design it replaces raised from M ~218.  The kernel runs only on the
card (tests/test_torch_cuda.py).  Here the route is checked over the
predicate's grid, the kernel's arithmetic is emulated in torch (the warp
dots of torch_parity.direct_dots_emulated; the output before each TPU tile
an f32 dot of the unrounded samples in fast mode; the discriminator in
float32) and held against the plain body ``ddc_fm_torch`` and JAX's K1 in
interpret mode, and the fused FM chain at 256 taps/M = 240 runs against the
JAX chain.  Tolerances, the JAX package's K1 gates
(tests/test_torch_ddc_fm.py): audio >= 90 dB, energy and z_first / z_last
rtol 1e-5 (f32 sums in another order); the chain as
tests/test_torch_rx_chain.py holds it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.ops import ddc as jddc
from solid_dsp_tpu.ops import pallas_ddc as jpd
from solid_dsp_tpu_torch.interop import state_to_numpy
from solid_dsp_tpu_torch.models.rx_chain import RxChainConfig
from solid_dsp_tpu_torch.ops import cuda_ddc, nco
from torch_parity import (direct_dots_emulated, make_blocks, run_jax,
                          run_torch, snr_db)

KF = 0.1
P = cuda_ddc.DEFAULT_P
# (taps, M): phase 37's FM point, M = 200 with more taps than M (K1 needs
# n > M), and two points past the staged design's shared memory
K1_POINTS = [(256, 128), (256, 200), (256, 240), (512, 256)]


def _taps(n, M):
    return RxChainConfig(fir_taps=n, decimation=M).design_taps()


def _body(n, M, mode):
    return cuda_ddc.make_ddc_fm(_taps(n, M), nco.constrain(0.2), M, KF, "cpu",
                                mode=mode)


def _inputs(seed, L, D):
    """A noisy tone near the carrier and a random carried tail, float32."""
    rng = np.random.default_rng(seed)
    x = 0.5 * np.exp(1j * 0.21 * np.arange(L)) + 0.1 * (
        rng.standard_normal(L) + 1j * rng.standard_normal(L))
    x2 = np.stack([x.real, x.imag]).astype(np.float32)
    return x2, (0.3 * rng.standard_normal((2, D))).astype(np.float32)


def _k1_direct_emulated(body, x2, tail, seam_period):
    """csrc/ddc_fm.cu's direct route in torch: (audio (T,), stats (5,)).
    Every output is the warp dot in the body's mode; the predecessor of
    output t is output t - 1's dot, except where t starts a TPU tile (t a
    multiple of ``seam_period`` in fast mode, t = 0 in both), whose
    predecessor is computed from the unrounded samples (t = 0: the window
    one sample short, zeros before the tail)."""
    fast = body.mode == "fast"
    T = x2.shape[1] // body.M
    z = direct_dots_emulated(body.taps, body.M, x2, tail, fast)
    prev = np.concatenate([np.zeros((2, 1), np.float32), z[:, :-1]], axis=1)
    seams = np.arange(0, T, seam_period) if fast else np.array([0])
    prev[:, seams] = direct_dots_emulated(body.taps, body.M, x2, tail, False,
                                          seams - 1)
    zr, zi, pr, pi = (torch.from_numpy(np.ascontiguousarray(v))
                      for v in (z[0], z[1], prev[0], prev[1]))
    ure = zr * pr + zi * pi
    uim = zi * pr - zr * pi
    audio = torch.atan2(uim * body.cd + ure * body.sd,
                        ure * body.cd - uim * body.sd) * body.scale
    stats = np.array([np.sum(z.astype(np.float64) ** 2), z[0, -1], z[1, -1],
                      z[0, 0], z[1, 0]])
    return audio.numpy(), stats


def _check_stats(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------- routes

@pytest.mark.parametrize("fast", [False, True])
def test_fm_geometry_covers_jax_predicate(fast):
    """fm_geometry gives a route, and never raises, for every (n, M) with
    n <= 512, M <= 256 that the JAX package's pallas_fm_supported accepts:
    the tensor cores where their bank and spans fit, else the direct route
    (launch_geometry), which the staged design could not give from M ~218
    (4 (2 M (128 + ceil(n / M)) + 2 n + 260) > 232,448 bytes)."""
    ns = sorted(set(range(2, 513, 7)) | {63, 64, 65, 127, 128, 129, 255, 256,
                                         257, 511, 512})
    routes = {"tc": 0, "direct": 0}
    past_staged = 0
    for M in range(1, 257):
        for n in ns:
            if not jpd.pallas_fm_supported(n, M):
                continue
            assert cuda_ddc.fm_supported(n, M)
            route, geo = cuda_ddc.fm_geometry.__wrapped__(n, M, fast)
            routes[route] += 1
            if route == "direct":
                with pytest.raises(ValueError, match="shared memory"):
                    cuda_ddc.fm_tc_geometry(n, M, fast=fast)
                assert geo == cuda_ddc.launch_geometry(n, M)
                staged = 4 * (2 * M * (128 + -(-n // M)) + 2 * n + 260)
                past_staged += staged > 232448
            else:
                assert geo == cuda_ddc.fm_tc_geometry(n, M, fast=fast)
    assert routes["tc"] > 0 and routes["direct"] > 0 and past_staged > 0
    for n, M in K1_POINTS:
        assert cuda_ddc.fm_geometry(n, M, fast)[0] == "direct"


# ------------------------------------------------------- the arithmetic

@pytest.mark.parametrize("n,M", K1_POINTS)
@pytest.mark.parametrize("mode", ["x3", "fast"])
def test_k1_direct_emulated_matches_plain(n, M, mode):
    """The direct route's arithmetic against ddc_fm_torch in the same mode:
    audio >= 90 dB, stats rtol 1e-5; fast mode over 132 frames, so a TPU
    tile's f32 seam (fm_seam_frames: 128 frames) falls inside the block."""
    F = 132 if mode == "fast" else 4
    L = F * P * M
    x2, tail = _inputs(n + M, L, n - M)
    body = _body(n, M, mode)
    period = cuda_ddc.fm_seam_frames(F) * P
    audio, stats = _k1_direct_emulated(body, x2, tail, period)
    want, wstats = cuda_ddc.ddc_fm_torch(body, torch.from_numpy(x2),
                                         torch.from_numpy(tail))
    assert audio.shape == (L // M,)
    assert snr_db(audio, want.numpy()) >= 90.0
    _check_stats(stats, wstats.double().numpy())


@pytest.mark.parametrize("mode", ["x3", "fast"])
def test_k1_direct_emulated_matches_jax_kernel(mode):
    """The direct route's arithmetic at 256 taps/M = 240 (past the staged
    design) against JAX's K1 in interpret mode, two TPU tiles of 8 frames
    (fast: the tiles' seams f32 in both): audio[1:] >= 90 dB (output 0 is
    the glue's), energy and edges rtol 1e-5."""
    n, M, TF, tiles = 256, 240, 8, 2
    hop, D = P * M, n - M
    L = tiles * TF * hop
    x2, tail = _inputs(9, L, D)
    body = _body(n, M, mode)
    audio, stats = _k1_direct_emulated(body, x2, tail, TF * P)
    h_bp = jddc.ddc_taps(_taps(n, M), np.uint32(body.dtheta))
    fn = jpd.make_pallas_ddc_fm(h_bp, M, tiles, np.uint32(body.dw), KF, TF=TF,
                                mode=mode, interpret=True)
    tailrow = np.zeros((2, jpd.HALO_FRAMES, hop), np.float32)
    tailrow[:, -1, hop - D:] = tail
    a2, s8 = fn(jnp.asarray(x2.reshape(2, -1, hop)), jnp.asarray(tailrow))
    want = np.asarray(a2)[:, :P].reshape(-1)
    st = np.asarray(s8).reshape(tiles, 8, 128)[:, 0, :]
    assert audio.shape == want.shape
    assert snr_db(audio[1:], want[1:]) >= 90.0
    np.testing.assert_allclose(stats[0], st[:, 0].sum(), rtol=1e-5)
    np.testing.assert_allclose(stats[1:3], st[-1, 1:3], rtol=1e-5)
    np.testing.assert_allclose(stats[3:5], st[0, 3:5], rtol=1e-5)


# ----------------------------------------------------------- the chain

@pytest.mark.parametrize("n,M", [(256, 240), (512, 256)])
def test_fm_chain_at_large_decimation_matches_jax(n, M):
    """The fused FM chain (x3) where the staged route raised on the card,
    3 blocks of 8 frames with the state carried, against the JAX chain with
    its K1 in interpret mode (ddc_engine="pallas"): audio >= 90 dB; phase
    word and FIR tail exact, AGC gain and energy rtol 1e-5, fm_prev rtol
    1e-4."""
    blocks = make_blocks(3, L=8 * P * M, seed=13)
    o = dict(fir_taps=n, decimation=M)
    want, jst = run_jax(blocks, ddc_engine="pallas", **o)
    got, st = run_torch(blocks, **o)
    assert got.shape == want.shape and got.dtype == np.float32
    assert snr_db(got, want) >= 90.0
    s = state_to_numpy(st)
    assert s["nco_theta"] == jst["nco_theta"]
    np.testing.assert_array_equal(s["fir_tail"], jst["fir_tail"])
    for k in ("gain", "energy"):
        np.testing.assert_allclose(s["agc"][k], jst["agc"][k], rtol=1e-5)
    np.testing.assert_allclose(s["fm_prev"], jst["fm_prev"], rtol=1e-4)
