"""The DDC body (K2, K3), the NCO exponential, the block AGC and the DDC glue:
port vs JAX package.

The JAX side runs K2 and K3 themselves in interpret mode (``engine="pallas"``,
as the JAX package's own tests do on the CPU) or its XLA path.  JAX's x3
splits operands into bf16 pairs; the port computes in FP32.  Tolerances, the
JAX package's own gates: z >= 90 dB against x3, >= 100 dB against XLA at
"highest"; tails, phase words exact (copies of input samples and integer
arithmetic); oscillator samples within 1e-6 (float32 sin/cos of the same
float32 radians, a few ulp apart); AGC gain and energy rtol 1e-5 (float32
sums in another order).

The kernel itself runs only on the card: tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.ops import agc as jagc
from solid_dsp_tpu.ops import ddc as jddc
from solid_dsp_tpu.ops import nco as jnco
from solid_dsp_tpu_torch.models.rx_chain import RxChainConfig
from solid_dsp_tpu_torch.ops import agc, cuda_ddc, ddc, nco
from torch_parity import L_SMALL, snr_db, tc_frames, unpack_tc_bank

M = 4
FC = 0.2


def _body(n=64, M=M, dtype=torch.float32):
    taps = RxChainConfig(fir_taps=n).design_taps()
    return cuda_ddc.make_ddc_body(taps, nco.constrain(FC), M, "cpu", dtype)


def _inputs(seed, L, n1=63):
    rng = np.random.default_rng(seed)
    x = 0.5 * np.exp(1j * 0.21 * np.arange(L)) + 0.1 * (
        rng.standard_normal(L) + 1j * rng.standard_normal(L))
    x2 = np.stack([x.real, x.imag]).astype(np.float32)
    tail2 = (0.3 * rng.standard_normal((2, n1))).astype(np.float32)
    return x2, tail2


def _both_raw(x2, tail2, theta0, n=64, M=M, **jax_kw):
    """(port, JAX) ddc_apply_planar_raw outputs as numpy."""
    taps = RxChainConfig(fir_taps=n).design_taps()
    got = ddc.ddc_apply_planar_raw(
        _body(n, M), torch.from_numpy(tail2),
        torch.tensor(theta0, dtype=torch.int64), torch.from_numpy(x2))
    want = jddc.ddc_apply_planar_raw(
        taps, nco.constrain(FC), jnp.asarray(tail2), jnp.uint32(theta0),
        jnp.asarray(x2), M, **jax_kw)
    return ([np.asarray(g) for g in got[:5]] + [got[5]],
            [np.asarray(w) for w in want])


def _check_raw(got, want, min_db):
    yre, yim, tail, theta_end, w0, dw = got
    assert yre.shape == want[0].shape and yre.dtype == np.float32
    assert snr_db(np.concatenate([yre, yim]),
                  np.concatenate([want[0], want[1]])) >= min_db
    np.testing.assert_array_equal(tail, want[2])
    assert int(theta_end) == int(want[3])
    assert int(w0) == int(want[4]) and dw == int(want[5])


@pytest.mark.parametrize("L,route", [(L_SMALL, "K2"), (L_SMALL + 52, "K3")])
def test_plain_body_matches_jax_interpret_kernels(L, route):
    """Plain body vs JAX's pieces path with its Pallas kernels in
    interpret mode at x3: K2 covers an aligned block whole; the unaligned
    block runs K3 on its interior (L - 52 is a multiple of 256, L of 4
    only).  >= 90 dB, tail and phase words exact."""
    x2, tail2 = _inputs(1, L)
    got, want = _both_raw(x2, tail2, 0xFFFFF000, precision="x3",
                          engine="pallas")
    _check_raw(got, want, 90.0)


@pytest.mark.parametrize("L", [1000, 4100, 32])
def test_plain_body_matches_jax_xla_highest(L):
    """Plain body vs JAX's XLA pieces at "highest": unaligned blocks, and a
    short block (L < n - 1) whose new tail keeps part of the old one."""
    x2, tail2 = _inputs(2, L)
    got, want = _both_raw(x2, tail2, 1234567890, precision="highest",
                          engine="xla")
    _check_raw(got, want, 100.0)


@pytest.mark.parametrize("n,M,L", [(48, 8, 8 * 333), (33, 2, 2 * 517),
                                   (64, 32, 32 * 70), (100, 4, 4 * 9)])
def test_plain_body_other_geometries_match_jax_xla(n, M, L):
    x2, tail2 = _inputs(3, L, n1=n - 1)
    got, want = _both_raw(x2, tail2, 77, n=n, M=M, precision="highest",
                          engine="xla")
    _check_raw(got, want, 100.0)


def test_plain_body_f64_matches_direct_sum():
    """The float64 plain body equals the direct sum
    z[t] = sum_i h_bp[i] x[tM - D + i] to 1e-12."""
    L, n = 4 * 211, 64
    x2, tail2 = _inputs(4, L)
    body = _body(dtype=torch.float64)
    tail = tail2[:, M - 1:].astype(np.float64)
    z = ddc.ddc_body_torch(body, torch.from_numpy(x2).double(),
                           torch.from_numpy(tail)).numpy()
    xe = np.concatenate([tail, x2.astype(np.float64)], axis=1)
    xe = xe[0] + 1j * xe[1]
    h = jddc.ddc_taps(RxChainConfig().design_taps(), nco.constrain(FC))
    want = np.array([np.dot(h, xe[t * M : t * M + n]) for t in range(L // M)])
    np.testing.assert_allclose(z[0] + 1j * z[1], want, rtol=0, atol=1e-12)


def test_body_rejects_bad_blocks():
    body = _body()
    x2, tail2 = _inputs(5, 1002)
    tail = torch.from_numpy(tail2[:, M - 1:])
    with pytest.raises(ValueError, match="multiple of 4"):
        ddc.ddc_body_torch(body, torch.from_numpy(x2), tail)
    with pytest.raises(ValueError, match="tail"):
        ddc.ddc_body_torch(body, torch.from_numpy(x2[:, :1000]), tail[:, 1:])
    with pytest.raises(ValueError, match="CUDA"):
        body(torch.from_numpy(x2[:, :1000]), tail, engine="cuda")
    with pytest.raises(ValueError, match="unknown ddc_engine"):
        body(torch.from_numpy(x2[:, :1000]), tail, engine="xla")


@pytest.mark.parametrize("L,aligned", [(1024, True), (1000, False)])
def test_body_routes_count_apart(L, aligned):
    """The K2 wrapper takes only blocks that are a multiple of 64*M, the K3
    wrapper only the others; neither launches on a CPU tensor."""
    body = _body()
    x2, tail2 = (torch.from_numpy(a) for a in _inputs(6, L))
    tail = tail2[:, M - 1:]
    right, wrong = ((cuda_ddc.ddc_body_cuda, cuda_ddc.ddc_body_unaligned_cuda)
                    if aligned else
                    (cuda_ddc.ddc_body_unaligned_cuda, cuda_ddc.ddc_body_cuda))
    with pytest.raises(ValueError, match="multiple of 256"):
        wrong(body, x2, tail)
    with pytest.raises(ValueError, match="CUDA"):
        right(body, x2, tail)
    before = (cuda_ddc.ddc_body_cuda.launches,
              cuda_ddc.ddc_body_unaligned_cuda.launches)
    assert torch.equal(body(x2, tail), ddc.ddc_body_torch(body, x2, tail))
    assert (cuda_ddc.ddc_body_cuda.launches,
            cuda_ddc.ddc_body_unaligned_cuda.launches) == before


@pytest.mark.parametrize("n,theta0", [(4096, 0), (4096, 0xFFFFFF00),
                                      (1000, 123456789), (1, 5)])
def test_nco_fast_matches_jax(n, theta0):
    """Both branches of the factorized oscillator: V = 128 (n % 128 == 0)
    and the per-sample path."""
    d = nco.constrain(0.8)
    got = nco.nco_complex_exponential(torch.tensor(theta0), d, n,
                                      mode="fast")
    want = np.asarray(jnco.nco_complex_exponential(
        jnp.uint32(theta0), d, n, mode="fast"))
    assert got.dtype == torch.complex64 and want.dtype == np.complex64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_nco_exact_matches_jax():
    """"exact" within 1e-12; "lut" (the reference's table, ported since the
    LUT oscillator landed) bit-equal to the JAX package's CPU table read,
    with the float64 default table and a float32 one."""
    d = nco.constrain(-1.3)
    got = nco.nco_complex_exponential(torch.tensor(3_000_000_000), d, 777,
                                      mode="exact")
    want = np.asarray(jnco.nco_complex_exponential(
        jnp.uint32(3_000_000_000), d, 777, mode="exact"))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    for lut in (None, np.float32):
        table = None if lut is None else nco.make_sine_lut(lut)
        got = nco.nco_complex_exponential(torch.tensor(0), d, 8, table,
                                          mode="lut")
        want = np.asarray(jnco.nco_complex_exponential(
            jnp.uint32(0), d, 8, table, mode="lut"))
        assert got.dtype == torch.from_numpy(want).dtype
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("gain,energy", [(1.0, 1.0), (1.3, 0.02)])
def test_agc_apply_block_mode_matches_jax(gain, energy):
    rng = np.random.default_rng(8)
    x = (rng.standard_normal(5000) + 1j * rng.standard_normal(5000)
         ).astype(np.complex64) * np.float32(0.3)
    st = agc.agc_init(device="cpu")
    st = {**st, "gain": torch.tensor(np.float32(gain)),
          "energy": torch.tensor(np.float32(energy))}
    out, st2 = agc.agc_apply_block_mode(st, torch.from_numpy(x), 0.01)
    jst = {k: jnp.asarray(v.numpy()) for k, v in st.items()}
    wout, wst = jagc.agc_apply_block_mode(jst, jnp.asarray(x), 0.01)
    np.testing.assert_allclose(out.numpy(), np.asarray(wout), rtol=1e-6)
    for k in ("gain", "energy"):
        np.testing.assert_allclose(st2[k].numpy(), np.asarray(wst[k]),
                                   rtol=1e-5)


@pytest.mark.parametrize("L", [4096, 1000])
def test_ddc_apply_planar_and_complex_match_jax(L):
    """The body plus the decimated-rate rotation ("fast" oscillator), on
    planes and complex in/out: >= 100 dB against JAX's XLA path."""
    x2, tail2 = _inputs(9, L)
    taps = RxChainConfig().design_taps()
    theta0 = 987654321
    got = ddc.ddc_apply_planar(_body(), torch.from_numpy(tail2),
                               torch.tensor(theta0), torch.from_numpy(x2))
    want = jddc.ddc_apply_planar(taps, nco.constrain(FC), jnp.asarray(tail2),
                                 jnp.uint32(theta0), jnp.asarray(x2), M,
                                 precision="highest", engine="xla")
    y = got[0].numpy() + 1j * got[1].numpy()
    w = np.asarray(want[0]) + 1j * np.asarray(want[1])
    assert snr_db(np.stack([y.real, y.imag]), np.stack([w.real, w.imag])
                  ) >= 100.0
    assert int(got[3]) == int(want[3])
    xc = x2[0] + 1j * x2[1]
    tc = (tail2[0] + 1j * tail2[1]).astype(np.complex64)
    yc, tail_c, theta_c = ddc.ddc_apply(
        _body(), torch.from_numpy(tc), torch.tensor(theta0),
        torch.from_numpy(xc.astype(np.complex64)))
    assert yc.dtype == torch.complex64
    np.testing.assert_array_equal(yc.numpy(), y.astype(np.complex64))
    np.testing.assert_array_equal(tail_c.numpy(),
                                  (x2[0] + 1j * x2[1])[L - 63:])
    assert int(theta_c) == int(want[3])


@pytest.mark.parametrize("seed,theta0", [(10, 0), (11, 0xFFFFFFF0)])
def test_epilogues_match_jax(seed, theta0):
    """FM and AM epilogues, energy and the rotated last sample on the same
    z: audio >= 90 dB with output 0 within 1e-5; carry rtol 1e-5."""
    rng = np.random.default_rng(seed)
    T = 2000
    z = (0.4 * np.exp(1j * 0.03 * np.arange(T))
         + 0.05 * (rng.standard_normal(T) + 1j * rng.standard_normal(T)))
    z2 = np.stack([z.real, z.imag]).astype(np.float32)
    zt = torch.from_numpy(z2)
    w0, dw = theta0, int(nco.constrain(0.8))
    pr, pi, g = np.float32(0.7), np.float32(-0.2), np.float32(1.7)
    out, npr, npi = ddc.ddc_fm_epilogue(
        zt[0], zt[1], torch.tensor(w0), dw, torch.tensor(pr),
        torch.tensor(pi), 0.1, torch.tensor(g))
    wout, wpr, wpi = jddc.ddc_fm_epilogue(
        jnp.asarray(z2[0]), jnp.asarray(z2[1]), jnp.uint32(w0),
        np.uint32(dw), jnp.float32(pr), jnp.float32(pi), 0.1,
        jnp.float32(g))
    assert snr_db(out.numpy(), np.asarray(wout)) >= 90.0
    np.testing.assert_allclose(out[0].numpy(), np.asarray(wout)[0], atol=1e-5)
    np.testing.assert_allclose([npr, npi], [wpr, wpi], rtol=1e-5)
    pieces = [("flat", jnp.asarray(z2[0]), jnp.asarray(z2[1]))]
    np.testing.assert_allclose(
        ddc.ddc_pieces_last_rotated(zt, torch.tensor(w0), dw,
                                    torch.tensor(g)),
        jddc.ddc_pieces_last_rotated(pieces, jnp.uint32(w0), np.uint32(dw),
                                     jnp.float32(g)), rtol=1e-5)
    np.testing.assert_allclose(ddc.ddc_energy_pieces(zt).numpy(),
                               np.asarray(jddc.ddc_energy_pieces(pieces)),
                               rtol=1e-5)
    am = ddc.ddc_am_epilogue(zt[0], zt[1], torch.tensor(g))
    wam = jddc.ddc_am_epilogue(jnp.asarray(z2[0]), jnp.asarray(z2[1]),
                               jnp.float32(g))
    np.testing.assert_allclose(am.numpy(), np.asarray(wam), rtol=1e-6)


# The tensor-core body kernel's host side (csrc/ddc_body.cu runs only on
# the card): its geometry and its packed TF32 hi/lo banks, unpacked
# (torch_parity.unpack_tc_bank) and applied as the kernel's frame product
# in float64 (torch_parity.tc_frames).

TC_GEOMETRIES = [(64, 4, L_SMALL), (64, 4, L_SMALL + 52), (64, 4, 32),
                 (48, 8, 512 * 9 + 8), (33, 2, 128 * 77), (64, 32, 2048 * 3)]


@pytest.mark.parametrize("n,M,L", TC_GEOMETRIES)
def test_tc_bank_frame_product_matches_plain_float64(n, M, L):
    """The packed hi + lo banks, applied in float64 to the exact samples,
    give the plain version's float64 z at >= 120 dB (the banks keep about
    21 mantissa bits of the float64 taps)."""
    P, hpad, KP, _, _, _ = cuda_ddc.body_tc_geometry(n, M)
    body = _body(n, M, torch.float64)
    hi, lo = unpack_tc_bank(cuda_ddc.body_tc_bank(body.h_bp, n, M, P, hpad,
                                                   KP), P, KP)
    x2, tail2 = _inputs(21, L, n - M)
    B = hi + lo
    got = tc_frames(x2.astype(np.float64), tail2.astype(np.float64), n, M,
                     P, hpad, KP, lambda w: w[0] @ B[0] + w[1] @ B[1])
    want = ddc.ddc_body_torch(body, torch.from_numpy(x2).double(),
                              torch.from_numpy(tail2).double()).numpy()
    assert got.shape == want.shape == (2, L // M)
    assert snr_db(got, want) >= 120.0


@pytest.mark.parametrize("n,M,L", TC_GEOMETRIES)
def test_tc_x3_product_matches_plain_float64(n, M, L):
    """The kernel's TF32 x3 product (samples split into tf32 hi and the
    rest, read as TF32; hi.hi + lo.hi + hi.lo) in float64 arithmetic:
    >= 100 dB against the
    plain version in float64, the "highest" contract of the chain
    (tests/test_rx_chain_fused.py)."""
    P, hpad, KP, _, _, _ = cuda_ddc.body_tc_geometry(n, M)
    body = _body(n, M, torch.float64)
    hi, lo = unpack_tc_bank(cuda_ddc.body_tc_bank(body.h_bp, n, M, P, hpad,
                                                   KP), P, KP)
    x2, tail2 = _inputs(22, L, n - M)

    def x3(w):
        w = w.astype(np.float32)
        wh = cuda_ddc.tf32_round(w).astype(np.float64)
        # lo = w - hi in float32, read by the tensor cores as TF32: its low
        # 13 bits ignored
        lo_bits = (w - wh).astype(np.float32).view(np.uint32)
        wl = (lo_bits & np.uint32(0xFFFFE000)).view(np.float32).astype(
            np.float64)
        return sum(a[p] @ b[p] for p in range(2)
                   for a, b in ((wh, hi), (wl, hi), (wh, lo)))

    got = tc_frames(x2, tail2, n, M, P, hpad, KP, x3)
    want = ddc.ddc_body_torch(body, torch.from_numpy(x2).double(),
                              torch.from_numpy(tail2).double()).numpy()
    assert snr_db(got, want) >= 100.0


@pytest.mark.parametrize("n,M", [(64, 4), (48, 8), (33, 2), (64, 32)])
def test_tc_bank_hi_lo_reproduce_float64_taps(n, M):
    """hi + lo of every bank entry is the float64 tap to TF32 x3's rounding
    (2^-21 of the largest tap); hi is a TF32 value and lo's magnitude at
    most 2^-11 of hi's; the bank's nonzero entries are the taps, each
    output column holding all n of them once a plane."""
    P, hpad, KP, _, _, _ = cuda_ddc.body_tc_geometry(n, M)
    body = _body(n, M, torch.float64)
    packed = cuda_ddc.body_tc_bank(body.h_bp, n, M, P, hpad, KP)
    hi, lo = unpack_tc_bank(packed, P, KP)
    assert np.array_equal(packed[:packed.size // 2],
                          cuda_ddc.tf32_round(packed[:packed.size // 2]))
    h = body.h_bp
    for plane, col_taps in ((0, (h.real, h.imag)), (1, (-h.imag, h.real))):
        for half, taps in zip((slice(0, P), slice(P, 2 * P)), col_taps):
            exact = hi[plane][:, half] + lo[plane][:, half]
            nz = np.abs(exact).sum(axis=0) > 0
            for p in range(P):
                k0 = hpad - (n - M) + p * M
                np.testing.assert_allclose(exact[k0:k0 + n, p], taps, rtol=0,
                                           atol=2.0 ** -21 * np.abs(h).max())
                assert not exact[:k0, p].any() and not exact[k0 + n:, p].any()
            assert nz.all()
    assert np.all(np.abs(lo) <= 2.0 ** -11 * np.abs(hi) + 1e-300)


def test_tc_geometry_fits_and_raises():
    """The main geometry takes frames of 16 outputs on two warpgroups of two
    stages within one block's shared memory; a decimation whose spans
    cannot fit raises instead of taking another path."""
    P, hpad, KP, wgs, stages, smem = cuda_ddc.body_tc_geometry(64, 4)
    assert (P, hpad, KP, wgs, stages) == (16, 60, 128, 2, 2)
    assert smem <= 227 * 1024
    for n, M in ((48, 8), (33, 2), (64, 32), (64, 1), (512, 4)):
        assert cuda_ddc.body_tc_geometry(n, M)[-1] <= 227 * 1024
    with pytest.raises(ValueError, match="shared memory"):
        cuda_ddc.body_tc_geometry(200, 128)
