"""Port vs JAX package: tap design, NCO phase words, banks and the AGC rule.

Tolerances: host design math is the same float64 numpy code on both sides,
so taps and windows agree to 1e-12 and phase words and banks exactly; the
AGC update runs in float32 on both sides (rtol 1e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.design import firdes as jfirdes
from solid_dsp_tpu.design import specialfn as jspecialfn
from solid_dsp_tpu.design import windows as jwindows
from solid_dsp_tpu.models.rx_chain import RxChainConfig as JaxRxChainConfig
from solid_dsp_tpu.ops import agc as jagc
from solid_dsp_tpu.ops import ddc as jddc
from solid_dsp_tpu.ops import nco as jnco
from solid_dsp_tpu.ops import pallas_ddc as jpallas_ddc
from solid_dsp_tpu_torch.design import firdes, specialfn, windows
from solid_dsp_tpu_torch.models.rx_chain import RxChainConfig
from solid_dsp_tpu_torch.ops import agc, cuda_ddc, ddc, nco


@pytest.mark.parametrize("n,fc,att", [(64, 0.1, 60.0), (31, 0.2, 40.0),
                                      (128, 0.05, 80.0), (16, 0.25, 20.0)])
def test_firdes_kaiser_matches_jax(n, fc, att):
    """firdes_kaiser: 1e-12 against the JAX package's design."""
    np.testing.assert_allclose(firdes.firdes_kaiser(n, fc, att),
                               jfirdes.firdes_kaiser(n, fc, att),
                               rtol=0, atol=1e-12)
    assert firdes.kaiser_beta(att) == jfirdes.kaiser_beta(att)


@pytest.mark.parametrize("taps,cutoff", [(64, 0.1), (48, 0.12)])
def test_design_taps_unity_dc_match_jax(taps, cutoff):
    """RxChainConfig.design_taps (unity DC gain): 1e-12."""
    got = RxChainConfig(fir_taps=taps, fir_cutoff=cutoff).design_taps()
    want = JaxRxChainConfig(fir_taps=taps, fir_cutoff=cutoff).design_taps()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert abs(np.sum(got) - 1.0) < 1e-12


@pytest.mark.parametrize("beta", [0.0, 2.5, 5.65326])
def test_kaiser_window_and_besseli_match_jax(beta):
    """Kaiser window and I0: 1e-12."""
    np.testing.assert_allclose(windows.kaiser(64, beta),
                               jwindows.kaiser(64, beta), rtol=0, atol=1e-12)
    z = np.concatenate([np.linspace(0.0, 20.0, 41), [1e-4, -1e-4, -2.0]])
    np.testing.assert_allclose(specialfn.besseli(z), jspecialfn.besseli(z),
                               rtol=1e-12, atol=0)
    assert specialfn.besseli(beta) == jspecialfn.besseli(beta, 0.0)
    np.testing.assert_allclose(specialfn.sinc(z - 10.0),
                               jspecialfn.sinc(z - 10.0), rtol=0, atol=1e-12)


@pytest.mark.parametrize("theta", [0.0, 0.2, -0.2, 3.0, -7.5, 2 * np.pi,
                                   1e-9, 123.456])
def test_constrain_bit_equal(theta):
    """constrain: the same u32 word, bit for bit."""
    got, want = nco.constrain(theta), jnco.constrain(theta)
    assert got.dtype == np.uint32 and got == want


@pytest.mark.parametrize("theta0", [0, 123456789, 0xFFFFFFF0])
def test_nco_phases_wrap_exactly(theta0):
    """int64-masked phase words == the JAX package's wrapping uint32."""
    d = int(nco.constrain(0.2))
    got = nco.nco_phases(torch.tensor(theta0, dtype=torch.int64), d, 4096)
    want = np.asarray(jnco.nco_phases(jnp.uint32(theta0), jnp.uint32(d), 4096))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_mix_down_block_exact_matches_jax():
    """Exact-mode mix: complex64 output within 1e-6; theta_end bit-equal."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(8192) + 1j * rng.standard_normal(8192)).astype(
        np.complex64)
    d = nco.constrain(0.37)
    got, th = nco.mix_down_block(torch.from_numpy(x),
                                 torch.tensor(4000000000, dtype=torch.int64), d,
                                 mode="exact")
    want, jth = jnco.mix_down_block(jnp.asarray(x), jnp.uint32(4000000000),
                                    jnp.uint32(d), mode="exact")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    assert int(th) == int(jth)


@pytest.mark.parametrize("fc", [0.2, -1.3])
def test_ddc_taps_match_jax(fc):
    """Bandpass taps h e^{-j i drad}: identical complex128 values."""
    taps = RxChainConfig().design_taps()
    d = nco.constrain(fc)
    np.testing.assert_array_equal(ddc.ddc_taps(taps, d),
                                  jddc.ddc_taps(taps, d))


@pytest.mark.parametrize("n,M", [(64, 4), (48, 8), (33, 2)])
def test_banks_equal_jax_banks(n, M):
    """Folded body, previous-frame and seam banks equal the JAX package's
    _banks_full_cached / _seam_bank_cached exactly.  The JAX banks carry
    TPU padding (the previous-frame bank to a multiple of 8 rows, the seam
    bank to hop rows and 128 lanes); those pads must be zero."""
    taps = RxChainConfig(fir_taps=n).design_taps()
    h = np.ascontiguousarray(ddc.ddc_taps(taps, nco.constrain(0.2)))
    P = cuda_ddc.DEFAULT_P
    hop, D = P * M, n - M
    body, prev = cuda_ddc._banks_full(h.tobytes(), n, M, P, np.float32)
    (Bbr, Bbi, Bpr, Bpi), hpad = jpallas_ddc._banks_full_cached(
        h.tobytes(), n, M, P)
    np.testing.assert_array_equal(body[0], Bbr)
    np.testing.assert_array_equal(body[1], Bbi)
    np.testing.assert_array_equal(prev[0], Bpr[hpad - D:])
    np.testing.assert_array_equal(prev[1], Bpi[hpad - D:])
    assert not Bpr[:hpad - D].any() and not Bpi[:hpad - D].any()
    seam = cuda_ddc._seam_bank(h.tobytes(), n, np.float32)
    Bsr, Bsi = jpallas_ddc._seam_bank_cached(h.tobytes(), n, M, P)
    np.testing.assert_array_equal(seam[0], Bsr[hop - n:, :2])
    np.testing.assert_array_equal(seam[1], Bsi[hop - n:, :2])
    assert not Bsr[:hop - n].any() and not Bsr[:, 2:].any()
    assert not Bsi[:hop - n].any() and not Bsi[:, 2:].any()


@pytest.mark.parametrize("ee,alpha,T", [(0.25, 0.01, 32768), (3.0, 0.1, 7),
                                        (1e-9, 0.5, 1)])
def test_block_gain_update_matches_jax(ee, alpha, T):
    """Block AGC update (f32 both sides): rtol 1e-6."""
    st = {**agc.agc_init(device="cpu"), "gain": torch.tensor(1.7), "energy":
          torch.tensor(0.3)}
    jst = {**jagc.agc_init(np.float32, xp=np), "gain": np.float32(1.7),
           "energy": np.float32(0.3)}
    got = agc.block_gain_update(st, torch.tensor(ee, dtype=torch.float32),
                                alpha, T)
    want = jagc.block_gain_update(jst, jnp.float32(ee), alpha, T)
    for k in ("gain", "energy"):
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6)
