"""K1's tensor-core route emulated on the CPU, and its geometry.

``csrc/ddc_fm.cu`` runs only on the card (tests/test_torch_cuda.py holds
it against its plain version there).  Here its arithmetic is emulated in
torch from the host side it is given: the packed TF32 hi/lo bank in K1's
column order (``ops/cuda_ddc.py::body_tc_bank(fm=True)``), unpacked; the
frames' samples split into hi = tf32(a) and lo = a - hi read as TF32 (its
low 13 bits dropped); the x3 product hi.hi + lo.hi + hi.lo with f32 sums
(in another order than the tensor cores'); the 64-frame
tiles of 16-row warps, whose first outputs take their predecessor from an
FP32 dot over its n-sample window (the tile's seam and every warp's), block
0's window reading the M samples before the tail as 0; the discriminator
in float32.  Tolerances: >= 100 dB against the plain version in float64
(the chain's "highest" contract), the energy within 1e-5 relative and
z[0], z[T-1] within 1e-4 (chip_smoke.py's ENERGY_RTOL, EDGE_ATOL); >= 90 dB
against the JAX package's K1 in interpret mode (its x3 splits into bf16
pairs, ~1e-5 relative a product) past output 0, which the glue overwrites.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.ops import ddc as jddc
from solid_dsp_tpu.ops import pallas_ddc as jpallas_ddc
from solid_dsp_tpu_torch.models.rx_chain import RxChainConfig
from solid_dsp_tpu_torch.ops import cuda_ddc, nco
from torch_parity import L_SMALL, snr_db, unpack_tc_bank

KF = 0.1
ENERGY_RTOL = 1e-5
EDGE_ATOL = 1e-4
WARP_ROWS = 16            # frame rows of one warp's accumulators (of 64)

# (n, M, L): T = L / M not a multiple of the tile's 64 P outputs where the
# last tile is partial: L_SMALL + 256 * 5 and 128 * 77 and 2048 * 3
GEOMETRIES = [(64, 4, L_SMALL), (64, 4, L_SMALL + 256 * 5), (48, 8, 512 * 9),
              (33, 2, 128 * 77), (64, 32, 2048 * 3), (513, 16, 1024 * 5),
              (128, 64, 4096 * 3), (64, 1, 64 * 101)]


def _body(n=64, M=4, dtype=torch.float32):
    taps = RxChainConfig(fir_taps=n).design_taps()
    return cuda_ddc.make_ddc_fm(taps, nco.constrain(0.2), M, KF, "cpu", dtype)


def _inputs(seed, L, D):
    rng = np.random.default_rng(seed)
    k = np.arange(L)
    x = 0.5 * np.exp(1j * 0.21 * k) + 0.1 * (rng.standard_normal(L)
                                            + 1j * rng.standard_normal(L))
    x2 = np.stack([x.real, x.imag]).astype(np.float32)
    tail = (0.3 * rng.standard_normal((2, D))).astype(np.float32)
    return torch.from_numpy(x2), torch.from_numpy(tail)


def _tf32_hi(a: torch.Tensor) -> torch.Tensor:
    """float32 -> its TF32 rounding (ties away from zero), as the kernel's
    integer split: (bits + 0x1000) & 0xFFFFE000."""
    return ((a.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(a: torch.Tensor) -> torch.Tensor:
    """What the tensor cores read of a float32 operand: its low 13 bits
    dropped."""
    return (a.view(torch.int32) & -0x2000).view(torch.float32)


def emulate_k1(body, x2: torch.Tensor, tail: torch.Tensor):
    """(audio (T,), stats (5,)) as K1's tensor-core route forms them from
    float32 x2 (2, L) and tail (2, n - M), for a float32 body."""
    n, M = body.n, body.M
    P, hpad, KP, _, _, _, _ = cuda_ddc.fm_tc_geometry(n, M)
    hi, lo = unpack_tc_bank(cuda_ddc.body_tc_bank(body.h_bp, n, M, P, hpad,
                                                  KP, fm=True), P, KP)
    back = np.argsort(cuda_ddc.fm_columns(P))      # K1's columns -> [re | im]
    Bh = torch.from_numpy(hi[:, :, back])
    Bl = torch.from_numpy(lo[:, :, back])
    L = x2.shape[1]
    T, hop, D = L // M, P * M, n - M
    F = -(-T // P)
    ext = torch.zeros((2, hpad + F * hop + KP), dtype=torch.float32)
    ext[:, hpad - D:hpad] = tail
    ext[:, hpad:hpad + L] = x2
    win = ext.unfold(1, KP, hop)[:, :F]                        # (2, F, KP)
    wh = _tf32_hi(win)
    wl = _tf32_trunc(win - wh)
    Bh, Bl = Bh.float(), Bl.float()             # TF32 values: exact in f32
    y = sum(wh[p] @ Bh[p] + wl[p] @ Bh[p] + wh[p] @ Bl[p]
            for p in range(2))                                 # (F, 2P) f32
    zr = y[:, :P].reshape(-1)[:T]
    zi = y[:, P:].reshape(-1)[:T]
    # the first output of every warp's rows (the tile's first included)
    # takes its predecessor from an FP32 dot over the n samples before its
    # own window: x[t M - n .. t M), the M before the tail read as 0
    firsts = torch.arange(0, T, WARP_ROWS * P)
    seam_x = torch.cat([torch.zeros((2, M)), tail, x2], dim=1)  # x[s] at s + n
    sw = torch.stack([seam_x[:, t * M:t * M + n] for t in firsts.tolist()],
                     dim=1)                                    # (2, K, n)
    hr, hi_ = body.taps[0], body.taps[1]
    sr = (sw[0] * hr - sw[1] * hi_).sum(dim=1)
    si = (sw[1] * hr + sw[0] * hi_).sum(dim=1)
    pr = torch.cat([zr[:1], zr[:-1]])
    pi = torch.cat([zi[:1], zi[:-1]])
    pr[firsts] = sr
    pi[firsts] = si
    ure = zr * pr + zi * pi
    uim = zi * pr - zr * pi
    audio = torch.atan2(uim * body.cd + ure * body.sd,
                        ure * body.cd - uim * body.sd) * body.scale
    energy = torch.sum(zr.double() ** 2 + zi.double() ** 2).float()
    return audio, torch.stack([energy, zr[-1], zi[-1], zr[0], zi[0]])


@pytest.mark.parametrize("n,M,L", GEOMETRIES)
def test_emulated_k1_matches_plain_float64(n, M, L):
    """The tensor-core route's arithmetic, tiles and seams: >= 100 dB
    against the plain version in float64, stats at ENERGY_RTOL and
    EDGE_ATOL."""
    x2, tail = _inputs(31, L, n - M)
    audio, stats = emulate_k1(_body(n, M), x2, tail)
    want, wstats = cuda_ddc.ddc_fm_torch(_body(n, M, torch.float64),
                                         x2.double(), tail.double())
    assert audio.shape == want.shape == (L // M,)
    assert snr_db(audio.numpy(), want.numpy()) >= 100.0
    got, ref = stats.double().numpy(), wstats.numpy()
    np.testing.assert_allclose(got[0], ref[0], rtol=ENERGY_RTOL)
    np.testing.assert_allclose(got[1:], ref[1:], rtol=0, atol=EDGE_ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_emulated_k1_matches_jax_interpret_kernel(seed):
    """The emulation vs JAX make_pallas_ddc_fm(interpret=True) at config 4:
    audio[1:] >= 90 dB; energy, z_first, z_last rtol 1e-5."""
    M = 4
    body = _body()
    x2, tail = _inputs(seed, L_SMALL, body.n - M)
    audio, stats = emulate_k1(body, x2, tail)
    n, P = body.n, cuda_ddc.DEFAULT_P
    hop, D = P * M, n - M
    h_bp = jddc.ddc_taps(RxChainConfig().design_taps(), np.uint32(body.dtheta))
    TF = jpallas_ddc.DEFAULT_TF
    tiles = L_SMALL // hop // TF
    fn = jpallas_ddc.make_pallas_ddc_fm(h_bp, M, tiles, np.uint32(body.dw), KF,
                                        TF=TF, mode="x3", interpret=True)
    tailrow = np.zeros((2, jpallas_ddc.HALO_FRAMES, hop), np.float32)
    tailrow[:, -1, hop - D:] = tail.numpy()
    a2, s8 = fn(jnp.asarray(x2.numpy().reshape(2, -1, hop)),
                jnp.asarray(tailrow))
    want = np.asarray(a2)[:, :P].reshape(-1)
    st = np.asarray(s8).reshape(tiles, 8, 128)[:, 0, :]
    assert audio.shape == want.shape
    assert snr_db(audio.numpy()[1:], want[1:]) >= 90.0
    got = stats.numpy()
    np.testing.assert_allclose(got[0], st[:, 0].sum(), rtol=1e-5)
    np.testing.assert_allclose(got[1:3], st[-1, 1:3], rtol=1e-5)
    np.testing.assert_allclose(got[3:5], st[0, 3:5], rtol=1e-5)


@pytest.mark.parametrize("n,M,P,wgs,stages", [
    (64, 4, 16, 2, 2), (64, 32, 4, 1, 2), (64, 2, 32, 1, 2),
    (513, 16, 4, 2, 2), (128, 64, 4, 1, 1), (48, 8, 8, 2, 2),
    (33, 2, 32, 2, 2), (64, 1, 32, 2, 2)])
def test_fm_geometry_takes_the_tensor_cores(n, M, P, wgs, stages):
    """Geometries whose bank and spans fit one block take the tensor-core
    route: the body's frame width, spans starting pre >= n - hpad samples
    early (a multiple of 4: 16-byte copies), the stats' words, 227 KB."""
    route, geo = cuda_ddc.fm_geometry(n, M)
    assert route == "tc"
    got_P, hpad, KP, pre, got_wgs, got_stages, smem = geo
    assert (got_P, got_wgs, got_stages) == (P, wgs, stages)
    assert hpad >= n - M and hpad % 4 == 0
    assert KP % 32 == 0 and KP >= hpad + P * M
    assert pre >= n - hpad and pre % 4 == 0 and pre <= M + 3
    assert smem <= 227 * 1024
    if M < 100:
        assert got_P == cuda_ddc.body_tc_geometry(n, M)[0]


@pytest.mark.parametrize("n,M,threads", [(200, 128, 32), (129, 128, 32),
                                         (300, 112, 32)])
def test_fm_geometry_large_m_takes_the_direct_route(n, M, threads):
    """Where the spans do not fit one block's shared memory, K1 takes its
    direct-form route, chosen from (n, M) before any launch."""
    with pytest.raises(ValueError, match="shared memory"):
        cuda_ddc.fm_tc_geometry(n, M)
    route, (got_threads, tbo, smem) = cuda_ddc.fm_geometry(n, M)
    assert route == "direct"
    assert got_threads == threads and tbo == 4 * threads
    assert smem <= 227 * 1024


def test_fm_geometry_too_large_raises():
    with pytest.raises(ValueError, match="shared-memory"):
        cuda_ddc.fm_geometry(512, 256)


def test_fm_geometry_covers_every_direct_form_geometry():
    """Every (n, M) the direct-form kernel accepts gets a route, the
    tensor cores wherever they fit: the redesign drops no geometry."""
    for M in (1, 2, 3, 4, 5, 8, 12, 16, 32, 48, 64, 96, 100, 128, 200):
        for n in sorted({M + 1, 2 * M, 4 * M + 1, 64, 513, 64 * M}):
            if not cuda_ddc.fm_supported(n, M):
                continue
            try:
                cuda_ddc.launch_geometry(n, M)
            except ValueError:
                continue
            route, _ = cuda_ddc.fm_geometry(n, M)
            try:
                cuda_ddc.fm_tc_geometry(n, M)
                assert route == "tc", (n, M)
            except ValueError:
                assert route == "direct", (n, M)


@pytest.mark.parametrize("P", [4, 8, 16, 32, 64])
def test_fm_columns_give_each_thread_consecutive_outputs(P):
    """Column 8 j + 2 c + e of K1's bank is part e of output c P/4 + j: the
    thread of accumulator columns 2c, 2c+1 holds outputs c P/4 .. c P/4 +
    P/4 - 1, real and imaginary part side by side."""
    cols = cuda_ddc.fm_columns(P)
    assert sorted(cols) == list(range(2 * P))
    Q = P // 4
    for c in range(4):
        for j in range(Q):
            for e in range(2):
                assert cols[8 * j + 2 * c + e] == e * P + c * Q + j


@pytest.mark.parametrize("n,M", [(64, 4), (48, 8), (33, 2), (64, 32)])
def test_fm_bank_is_the_body_bank_with_its_columns_moved(n, M):
    """K1's packed bank holds the body's hi and lo entries, bit for bit,
    in its own column order."""
    P, hpad, KP, _, _, _, _ = cuda_ddc.fm_tc_geometry(n, M)
    body = _body(n, M)
    cols = cuda_ddc.fm_columns(P)
    plain = unpack_tc_bank(cuda_ddc.body_tc_bank(body.h_bp, n, M, P, hpad, KP),
                           P, KP)
    fm = unpack_tc_bank(cuda_ddc.body_tc_bank(body.h_bp, n, M, P, hpad, KP,
                                              fm=True), P, KP)
    for a, b in zip(plain, fm):
        np.testing.assert_array_equal(b, a[:, :, cols])


def test_fm_body_keeps_float64_taps():
    """The body keeps the float64 taps its packed bank is split from."""
    body = _body()
    assert body.h_bp.dtype == np.complex128 and body.h_bp.shape == (64,)
    np.testing.assert_allclose(body.taps.numpy(),
                               np.stack([body.h_bp.real, body.h_bp.imag]),
                               rtol=1e-7)
    assert body.banks == {}
