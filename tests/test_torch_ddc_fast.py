"""K1-K3's "fast" mode: the single-pass bf16 body, port vs the JAX package.

The JAX side runs its kernels themselves, ``make_pallas_ddc_full``,
``make_pallas_ddc_body`` and ``make_pallas_ddc_fm`` with ``mode="fast"``
in interpret mode, at config 4's geometry (64 taps, M = 4, P = 64).  Both
sides round the samples and the bank (float64 -> float32 -> bf16) to bf16
to nearest even, take exact products and sum in float32, in other orders:
z >= 120 dB; K1's audio >= 90 dB (its TPU tiles' seams, f32 dots, at the
same outputs on both sides), its stats rtol 1e-5.  Against float64 the
mode keeps >= 50 dB (the TPU kernel's docstring: ~52 dB).

The kernels' host side (``csrc/ddc_tc.cuh`` runs only on the card): the
packed bf16 bank unpacked in numpy against the bank rounded by
``ml_dtypes`` (bit-equal), and the frame product emulated with it in
float64 on bf16-rounded samples, >= 120 dB against the plain version;
the warp seams of K1's tensor-core route emulated the same way.  The
routing predicates are held against the JAX package's.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from solid_dsp_tpu.ops import ddc as jddc
from solid_dsp_tpu.ops import pallas_ddc as jpd
from solid_dsp_tpu_torch.models.rx_chain import RxChainConfig
from solid_dsp_tpu_torch.ops import cuda_ddc, ddc, nco
from torch_parity import (L_SMALL, snr_db, tc_frames, unpack_tc_bank,
                          unpack_tc_bank_bf16)

M = 4
FC = 0.2
KF = 0.1
P = cuda_ddc.DEFAULT_P
HOP = P * M
WARP_ROWS = 16


def _taps(n=64):
    return RxChainConfig(fir_taps=n).design_taps()


def _body(n=64, M=M, mode="fast", dtype=torch.float32):
    return cuda_ddc.make_ddc_body(_taps(n), nco.constrain(FC), M, "cpu",
                                  dtype, mode)


def _fm(n=64, M=M, mode="fast", dtype=torch.float32):
    return cuda_ddc.make_ddc_fm(_taps(n), nco.constrain(FC), M, KF, "cpu",
                                dtype, mode)


def _inputs(seed, L, D):
    """A noisy tone near the carrier and a random carried tail, float32."""
    rng = np.random.default_rng(seed)
    x = 0.5 * np.exp(1j * 0.21 * np.arange(L)) + 0.1 * (
        rng.standard_normal(L) + 1j * rng.standard_normal(L))
    x2 = np.stack([x.real, x.imag]).astype(np.float32)
    return x2, (0.3 * rng.standard_normal((2, D))).astype(np.float32)


def _bf16(a):
    """float32 -> bf16 (ml_dtypes, JAX's own type) -> float64."""
    return np.asarray(np.asarray(a, np.float32).astype(ml_dtypes.bfloat16),
                      np.float64)


def _tailrow(tail):
    row = np.zeros((2, jpd.HALO_FRAMES, HOP), np.float32)
    row[:, -1, HOP - tail.shape[1]:] = tail
    return jnp.asarray(row)


def _h_bp(n=64):
    return jddc.ddc_taps(_taps(n), nco.constrain(FC))


# ------------------------------------------------- against JAX's kernels

@pytest.mark.parametrize("seed", [0, 1])
def test_plain_k2_fast_matches_jax_interpret_kernel(seed):
    """K2: the whole aligned block, z >= 120 dB."""
    x2, tail = _inputs(seed, L_SMALL, 60)
    z = ddc.ddc_body_torch(_body(), torch.from_numpy(x2),
                           torch.from_numpy(tail)).numpy()
    TF = jpd.DEFAULT_TF
    tiles = L_SMALL // HOP // TF
    fn = jpd.make_pallas_ddc_full(_h_bp(), M, tiles, TF=TF, mode="fast",
                                  interpret=True)
    y = np.asarray(fn(jnp.asarray(x2.reshape(2, -1, HOP)), _tailrow(tail)))
    want = np.stack([y[:, :P].reshape(-1), y[:, P:].reshape(-1)])
    assert z.shape == want.shape
    assert snr_db(z, want) >= 120.0


def test_plain_k3_fast_matches_jax_interpret_kernel():
    """K3: the interior of an unaligned block (outputs Th .. Th + tiles TF
    P after the head's Th = 15), z >= 120 dB."""
    L = L_SMALL + 52
    x2, tail = _inputs(2, L, 60)
    z = ddc.ddc_body_torch(_body(), torch.from_numpy(x2),
                           torch.from_numpy(tail)).numpy()
    n1, first = 63, M - 1
    Th = -(-(n1 - first) // M)
    start = first + Th * M - n1
    TF = jpd.DEFAULT_TF
    tiles = ((L - start - n1) // HOP - jpd.HALO_FRAMES) // TF
    span = (tiles * TF + jpd.HALO_FRAMES) * HOP
    fn = jpd.make_pallas_ddc_body(_h_bp(), M, tiles, TF=TF, mode="fast",
                                  interpret=True)
    y = np.asarray(fn(jnp.asarray(x2[:, start:start + span].reshape(
        2, -1, HOP))))
    want = np.stack([y[:, :P].reshape(-1), y[:, P:].reshape(-1)])
    got = z[:, Th:Th + want.shape[1]]
    assert tiles > 0 and got.shape == want.shape
    assert snr_db(got, want) >= 120.0


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_k1_fast_matches_jax_interpret_kernel(seed):
    """K1 with the TPU tiles JAX's ddc_fm_fused chooses (fm_seam_frames):
    audio >= 90 dB, output 0 included (both read z[-1] from the same f32
    seam); energy, z_first and z_last rtol 1e-5."""
    body = _fm()
    x2, tail = _inputs(seed, L_SMALL, 60)
    audio, stats = cuda_ddc.ddc_fm_torch(body, torch.from_numpy(x2),
                                         torch.from_numpy(tail))
    F = L_SMALL // HOP
    TF = cuda_ddc.fm_seam_frames(F)
    tiles = F // TF
    assert tiles > 1 and tiles * TF == F       # seams inside the block
    fn = jpd.make_pallas_ddc_fm(_h_bp(), M, tiles, np.uint32(body.dw), KF,
                                TF=TF, mode="fast", interpret=True)
    a2, s8 = fn(jnp.asarray(x2.reshape(2, -1, HOP)), _tailrow(tail))
    want = np.asarray(a2)[:, :P].reshape(-1)
    st = np.asarray(s8).reshape(tiles, 8, 128)[:, 0, :]
    assert audio.shape == want.shape
    assert snr_db(audio.numpy(), want) >= 90.0
    got = stats.numpy()
    np.testing.assert_allclose(got[0], st[:, 0].sum(), rtol=1e-5)
    np.testing.assert_allclose(got[1:3], st[-1, 1:3], rtol=1e-5)
    np.testing.assert_allclose(got[3:5], st[0, 3:5], rtol=1e-5)


def test_fm_seam_frames_is_jax_tile_choice():
    """The TPU tile of K1 for a block of F frames, as ddc_fm_fused picks
    it: the largest of 1024, 512, 256 giving four tiles, else 128."""
    for F, want in ((65536, 1024), (4096, 1024), (2048, 512), (1024, 256),
                    (512, 128), (16, 128)):
        assert cuda_ddc.fm_seam_frames(F) == want


@pytest.mark.parametrize("which", ["body", "fm"])
def test_fast_keeps_50_db_against_float64(which):
    """The single bf16 pass against the float64 body: >= 50 dB (z for the
    body; for K1, z recomputed through the body of the same mode and its
    energy within 1e-2)."""
    L = 2 ** 16
    x2, tail = _inputs(3, L, 60)
    xt, tt = torch.from_numpy(x2), torch.from_numpy(tail)
    exact = ddc.ddc_body_torch(_body(mode="x3", dtype=torch.float64),
                               xt.double(), tt.double()).numpy()
    if which == "body":
        assert snr_db(ddc.ddc_body_torch(_body(), xt, tt).numpy(),
                      exact) >= 50.0
    else:
        _, stats = cuda_ddc.ddc_fm_torch(_fm(), xt, tt)
        np.testing.assert_allclose(float(stats[0]),
                                   float(np.sum(exact ** 2)), rtol=1e-2)
        z = ddc.ddc_body_torch(_body(), xt, tt).numpy()
        np.testing.assert_allclose(stats[1:].numpy(), [z[0, -1], z[1, -1],
                                                       z[0, 0], z[1, 0]],
                                   rtol=1e-5, atol=1e-6)


def test_fast_differs_from_x3_and_rounds_operands():
    """The fast body is not the x3 body (~52 dB apart), and equals the x3
    body applied to bf16-rounded samples and a bf16-rounded bank."""
    x2, tail = _inputs(4, 4096, 60)
    xt, tt = torch.from_numpy(x2), torch.from_numpy(tail)
    fast = ddc.ddc_body_torch(_body(), xt, tt).numpy()
    x3 = ddc.ddc_body_torch(_body(mode="x3"), xt, tt).numpy()
    assert 40.0 < snr_db(fast, x3) < 70.0
    b = _body(mode="x3", dtype=torch.float64)
    b.taps.copy_(torch.from_numpy(_bf16(b.taps.float().numpy())))
    want = ddc.ddc_body_torch(b, torch.from_numpy(_bf16(x2)),
                              torch.from_numpy(_bf16(tail))).numpy()
    assert snr_db(fast, want) >= 120.0


def test_modes_are_checked():
    with pytest.raises(ValueError, match="mode"):
        _body(mode="bf16")
    with pytest.raises(ValueError, match="float64"):
        _body(dtype=torch.float64)
    with pytest.raises(ValueError, match="float64"):
        _fm(dtype=torch.float64)


# ----------------------------------------------- the kernels' host side

FAST_GEOMETRIES = [(64, 4, L_SMALL), (64, 4, L_SMALL + 52), (64, 4, 32),
                   (48, 8, 512 * 9 + 8), (33, 2, 128 * 77),
                   (64, 32, 2048 * 3), (4, 4, 4096), (3, 4, 4096 + 8)]


@pytest.mark.parametrize("n,M,fm", [
    (64, 4, False), (48, 8, False), (33, 2, False), (64, 32, False),
    (4, 4, False), (3, 4, False),
    (64, 4, True), (48, 8, True), (33, 2, True), (64, 32, True)])
def test_bf16_bank_packer_matches_numpy_unpack(n, M, fm):
    """The packed fast bank, unpacked in numpy: every entry the float64 tap
    rounded to float32 and then to bf16 by ml_dtypes, bit for bit, in the
    bank's column order (K1's with ``fm``; K1 takes n > M only), zero off
    the band."""
    geo = (cuda_ddc.fm_tc_geometry(n, M, fast=True) if fm
           else cuda_ddc.body_tc_geometry(n, M, fast=True))
    Pk, hpad, KP = geo[:3]
    body = _body(n, M)
    packed = cuda_ddc.body_tc_bank(body.h_bp, n, M, Pk, hpad, KP, fm=fm,
                                   fast=True)
    assert packed.dtype == np.float32 and packed.size == 2 * KP * 2 * Pk
    B = unpack_tc_bank_bf16(packed, Pk, KP)
    h, D = body.h_bp, n - M
    want = np.zeros((2, KP, 2 * Pk))
    for p in range(Pk):
        k0 = hpad - D + p * M
        want[0, k0:k0 + n, p], want[0, k0:k0 + n, Pk + p] = h.real, h.imag
        want[1, k0:k0 + n, p], want[1, k0:k0 + n, Pk + p] = -h.imag, h.real
    if fm:
        want = want[:, :, cuda_ddc.fm_columns(Pk)]
    np.testing.assert_array_equal(B, _bf16(want.astype(np.float32)))
    np.testing.assert_array_equal(
        cuda_ddc.bf16_round(packed), packed)
    # the x3 bank of the same geometry holds the same band in tf32 hi + lo
    hi, lo = unpack_tc_bank(cuda_ddc.body_tc_bank(body.h_bp, n, M, Pk, hpad,
                                                  KP, fm=fm), Pk, KP)
    np.testing.assert_array_equal(B != 0, (hi + lo) != 0)


def test_bf16_round_is_round_to_nearest_even():
    """bf16_round against ml_dtypes on ties, subnormals and the largest
    values."""
    rng = np.random.default_rng(9)
    a = np.concatenate([
        rng.standard_normal(4096).astype(np.float32),
        np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 3e-39,
                  -1e-40, 3.3e38, 0.0, -0.0], np.float32)])
    np.testing.assert_array_equal(cuda_ddc.bf16_round(a), _bf16(a))


@pytest.mark.parametrize("n,M,L", FAST_GEOMETRIES)
def test_bf16_frame_product_matches_plain_fast(n, M, L):
    """The kernel's fast product in float64 arithmetic: the unpacked bf16
    bank applied to bf16-rounded windows of the block (A's K permutation
    is the bank's, thread c holding samples 4c .. 4c+3 of each 16) gives
    the plain fast body at >= 120 dB (float32 sums against float64)."""
    Pk, hpad, KP, _, _, _ = cuda_ddc.body_tc_geometry(n, M, fast=True)
    body = _body(n, M)
    B = unpack_tc_bank_bf16(cuda_ddc.body_tc_bank(body.h_bp, n, M, Pk, hpad,
                                                  KP, fast=True), Pk, KP)
    x2, tail = _inputs(21, L, max(n - M, 0))
    got = tc_frames(_bf16(x2), _bf16(tail), n, M, Pk, hpad, KP,
                    lambda w: w[0] @ B[0] + w[1] @ B[1])
    want = ddc.ddc_body_torch(body, torch.from_numpy(x2),
                              torch.from_numpy(tail)).numpy()
    assert got.shape == want.shape == (2, L // M)
    assert snr_db(got, want) >= 120.0


def test_fast_geometry_takes_a_quarter_of_the_bank():
    """The bf16 bank is a quarter of x3's hi and lo (half the bytes a
    value, no lo): at config 4 both fit two warpgroups of two stages."""
    x3 = cuda_ddc.body_tc_geometry(64, 4)
    fast = cuda_ddc.body_tc_geometry(64, 4, fast=True)
    assert x3[:5] == fast[:5] == (16, 60, 128, 2, 2)
    assert x3[-1] - fast[-1] == 3 * 32 * 128 * 16 // 4
    fm = cuda_ddc.fm_tc_geometry(64, 4, fast=True)
    assert fm[:6] == cuda_ddc.fm_tc_geometry(64, 4)[:6]
    assert cuda_ddc.body_tc_geometry(4, 4, fast=True)[1] == 0   # hpad


def test_emulated_k1_fast_warp_seams_match_plain():
    """K1's tensor-core route in fast mode: every warp's first output takes
    its predecessor from a dot over its n-sample window, its operands
    rounded to bf16 unless it starts a TPU tile (then f32); with the bf16
    frame product this is the plain fast K1 at >= 110 dB (float64 sums
    here, float32 there, through atan2), while f32 seams at every warp
    would fall to ~72 dB."""
    n, L = 64, L_SMALL
    body = _fm()
    x2, tail = _inputs(5, L, n - M)
    audio, stats = cuda_ddc.ddc_fm_torch(body, torch.from_numpy(x2),
                                         torch.from_numpy(tail))
    Pk, hpad, KP = cuda_ddc.fm_tc_geometry(n, M, fast=True)[:3]
    B = unpack_tc_bank_bf16(cuda_ddc.body_tc_bank(
        body.h_bp, n, M, Pk, hpad, KP, fm=True, fast=True), Pk, KP)
    B = B[:, :, np.argsort(cuda_ddc.fm_columns(Pk))]
    z = tc_frames(_bf16(x2), _bf16(tail), n, M, Pk, hpad, KP,
                  lambda w: w[0] @ B[0] + w[1] @ B[1])
    T = L // M
    period = cuda_ddc.fm_seam_frames(L // HOP) * P
    seam_x = np.concatenate([np.zeros((2, M)), tail, x2], axis=1)
    h = body.h_bp.astype(np.complex64).astype(np.complex128)
    hq = _bf16(h.real) + 1j * _bf16(h.imag)

    def disc(seams_f32_everywhere):
        prev = np.concatenate([[0j], z[0, :-1] + 1j * z[1, :-1]])
        for t in range(0, T, WARP_ROWS * Pk):
            w = seam_x[0, t * M:t * M + n] + 1j * seam_x[1, t * M:t * M + n]
            if seams_f32_everywhere or t % period == 0:
                prev[t] = np.dot(h, w.astype(np.complex64))
            else:
                prev[t] = np.dot(hq, _bf16(w.real) + 1j * _bf16(w.imag))
        d = (z[0] + 1j * z[1]) * np.conj(prev) * (body.cd + 1j * body.sd)
        return np.angle(d) * body.scale

    assert snr_db(disc(False), audio.numpy()) >= 110.0
    assert snr_db(disc(True), audio.numpy()) < 90.0


def test_routing_predicates_match_jax():
    """K1, K2 and K3's predicates are the JAX package's, copied."""
    for Mx in (1, 2, 3, 4, 8, 16, 64):
        for n in range(1, 64 * Mx + 8, max(1, Mx // 2)):
            assert cuda_ddc.full_supported(n, Mx) == \
                jpd.pallas_full_supported(n, Mx)
            assert cuda_ddc.body_supported(n, Mx) == \
                jpd.pallas_body_supported(n, Mx)
            assert cuda_ddc.fm_supported(n, Mx) == \
                jpd.pallas_fm_supported(n, Mx)


@pytest.mark.parametrize("n,L,route", [
    (64, 1024, "ddc_body_cuda"), (64, 1000, "ddc_body_unaligned_cuda"),
    (4, 1024, "ddc_body_unaligned_cuda"), (2, 1000, "ddc_body_unaligned_cuda"),
    (259, 1024, "ddc_body_cuda"), (259, 1000, None), (300, 1024, None)])
def test_body_routes_as_jax(n, L, route):
    """Where JAX takes K2 (aligned, 0 < n - M <= 64 M) or K3 (0 < n - 1 <=
    64 M) the port takes its kernel's route, elsewhere (JAX's XLA) the
    plain body, on every device; a float64 body always takes the plain
    body.  On a CPU tensor "auto" runs the plain body and launches
    nothing."""
    body = _body(n, mode="x3")
    got = body.route(L)
    assert (got.__name__ if got else None) == route
    assert _body(n, mode="x3", dtype=torch.float64).route(L) is None
    x2, tail = _inputs(6, L, max(n - M, 0))
    def counts():
        return [getattr(k, c) for k in (cuda_ddc.ddc_body_cuda,
                                        cuda_ddc.ddc_body_unaligned_cuda)
                for c in ("launches", "fast_launches")]

    before = counts()
    z = body(torch.from_numpy(x2), torch.from_numpy(tail))
    assert z.shape == (2, L // M)
    assert counts() == before
    if route is None:
        with pytest.raises(ValueError, match="XLA"):
            body(torch.from_numpy(x2), torch.from_numpy(tail),
                 engine="cuda")


def test_k1_fast_audio_against_float64_is_the_references():
    """K1 fast's audio against float64 on chip_smoke.py phase 35's kind of
    block (config 4's carrier 0.001 cycles/sample off, amplitude 0.1, noise
    0.003): the discriminator turns the body's ~60 dB (z, gated >= 50 dB)
    into some 37 dB of audio.  The JAX package's K1 fast does the same: the
    two SNRs within 0.5 dB, and the port's energy within 1e-3 of
    float64."""
    L = L_SMALL
    rng = np.random.default_rng(35)
    tail = (0.1 * rng.standard_normal((2, 60))).astype(np.float32)
    k = np.arange(L)
    x = 0.1 * np.exp(2j * np.pi * (0.2 / (2 * np.pi) + 0.001) * k)
    x = x + 0.003 * (rng.standard_normal(L) + 1j * rng.standard_normal(L))
    x2 = np.stack([x.real, x.imag]).astype(np.float32)
    xt, tt = torch.from_numpy(x2), torch.from_numpy(tail)
    audio, stats = cuda_ddc.ddc_fm_torch(_fm(), xt, tt)
    a64, s64 = cuda_ddc.ddc_fm_torch(_fm(mode="x3", dtype=torch.float64),
                                     xt.double(), tt.double())
    F = L // HOP
    TF = cuda_ddc.fm_seam_frames(F)
    fn = jpd.make_pallas_ddc_fm(_h_bp(), M, F // TF, np.uint32(_fm().dw), KF,
                                TF=TF, mode="fast", interpret=True)
    a2, _ = fn(jnp.asarray(x2.reshape(2, -1, HOP)), _tailrow(tail))
    want = np.asarray(a2)[:, :P].reshape(-1)
    port, ref = snr_db(audio.numpy(), a64.numpy()), snr_db(want, a64.numpy())
    assert 30.0 <= port <= 50.0 and abs(port - ref) <= 0.5
    np.testing.assert_allclose(float(stats[0]), float(s64[0]), rtol=1e-3)
