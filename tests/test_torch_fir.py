"""The port's FIR layer (ops/fir.py, ops/dotprod.py, streaming/framing.py,
design/firdes.py's notch and metrics) vs the JAX package's, on the CPU.

Tolerances: float64 / complex128 products in another library's order agree
to 1e-12 of the signal's scale (5e-12 for the FFT method); goldens as the
JAX package's own tests hold them (BASELINE.md §B: 10.1, 60.03,
[28.28, 21.39] to 1e-12; the Firdes-trait metrics within 2e-7 in
float32, and equal to the JAX package's);
config 1 complex64 against complex128 >= 60 dB and config 3 against the
zero-stuff + convolve + select model >= 100 dB (tests/test_snr_configs.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.design import firdes as jfirdes
from solid_dsp_tpu.ops import dotprod as jdotprod
from solid_dsp_tpu.ops import fir as jfir
from solid_dsp_tpu.streaming import framing as jframing
from solid_dsp_tpu_torch.design import firdes
from solid_dsp_tpu_torch.ops import dotprod, fir
from solid_dsp_tpu_torch.streaming import framing
from torch_parity import snr_db

RNG = np.random.default_rng(20)


def _c(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n) + 1j * rng.standard_normal(n)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, atol=1e-12):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(1.0, float(np.max(np.abs(want))) if want.size else 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol * scale)


# ------------------------------------------------------------- goldens

def test_fir_goldens():
    """BASELINE.md §B: FIRFilter([1..5]).execute(2.02) = 10.1; the block's
    output[4] = 60.03; the decimating filter (M = 2) gives [28.28, 21.39]."""
    f = fir.FIRFilter([1.0, 2.0, 3.0, 4.0, 5.0], 1.0, device="cpu")
    assert abs(complex(f.execute(2.02 + 0j)[0]) - 10.1) < 1e-12
    f = fir.FIRFilter([1.0, 2.0, 3.0, 4.0, 5.0], 1.0, device="cpu")
    out = f.execute_block(np.array([2.02, 4.04, 1.02, 0.23, 9.19],
                                   np.complex128))
    assert abs(complex(out[4]) - 60.03) < 1e-12
    d = fir.DecimatingFIRFilter([1.0, 2.0, 3.0, 4.0, 5.0], 1.0, 2,
                                device="cpu")
    out = d.execute_block(np.array([2.02, 4.04, 1.02, 0.23], np.complex128))
    np.testing.assert_allclose(out.numpy(), [28.28, 21.39], atol=1e-12)
    assert d.get_decimation() == 2


def test_fir_accessors_and_reversed_coefficients():
    f = fir.FIRFilter([1.0, 2.0, 3.0], 1.0, device="cpu")
    np.testing.assert_array_equal(f.coefficients(), [3.0, 2.0, 1.0])
    assert f.get_scale() == 1.0 and len(f) == 3 and not f.is_empty()
    f.set_scale(2.0)
    assert f.get_scale() == 2.0
    jf = jfir.FIRFilter([1.0, 2.0, 3.0], 2.0)
    assert repr(f) == repr(jf)
    with pytest.raises(ValueError):
        fir.FIRFilter([], device="cpu")
    with pytest.raises(ValueError):
        fir.DecimatingFIRFilter([1.0], decimation=0, device="cpu")


def test_notch_response_and_group_delay_goldens():
    """notch(25, 0.35, 120) passes DC (response rounds to 1); notch(12)
    delays 12 samples; both as the JAX package computes them."""
    f = fir.FIRFilter(firdes.firdes_notch(25, 0.35, 120.0), device="cpu")
    r = f.frequency_response(0.0)
    assert round(r.real) == 1.0 and abs(r.imag) < 1e-12
    jf = jfir.FIRFilter(jfirdes.firdes_notch(25, 0.35, 120.0))
    assert abs(r - jf.frequency_response(0.0)) < 1e-12
    g = fir.FIRFilter(firdes.firdes_notch(12, 0.35, 120.0), device="cpu")
    assert int(g.group_delay(0.0) + 0.5) == 12


def test_firdes_trait_goldens():
    """The reference doctests' values (firdes/mod.rs:441,485,549,600) as
    FIRFilter methods on the reversed storage, within 2e-7 in float32 (the
    JAX package's tests/test_models.py gate)."""
    notch = fir.FIRFilter(firdes.firdes_notch(25, 0.2, 30.0), device="cpu")
    kais = fir.FIRFilter(firdes.firdes_kaiser(51, 0.35, 60.0, 0.0),
                         device="cpu")

    def near(v, golden):
        return abs(np.float32(v) - np.float32(golden)) < 2e-7

    assert near(notch.autocorrelation(3), 0.047983058)
    assert notch.autocorrelation(3) == notch.autocorrelation(-3)
    assert near(kais.crosscorrelation(notch, 0), 0.92825377)
    rms, mx = notch.isi(1, 25)
    assert near(rms, 0.02509764) and near(mx, 0.061966006)
    assert near(notch.energy(0.35, 128), 0.3152318)
    assert notch.energy(0.7, 128) == 0.0            # the swallowed error
    jn = jfir.FIRFilter(jfirdes.firdes_notch(25, 0.2, 30.0))
    jk = jfir.FIRFilter(jfirdes.firdes_kaiser(51, 0.35, 60.0, 0.0))
    assert kais.crosscorrelation(notch, 0) == jk.crosscorrelation(jn, 0)
    assert notch.isi(1, 25) == jn.isi(1, 25)


@pytest.mark.parametrize("args", [(25, 0.35, 120.0), (12, 0.1, 40.0),
                                  (1, 0.5, 20.0)])
def test_firdes_notch_and_metrics_match_jax(args):
    h = firdes.firdes_notch(*args)
    np.testing.assert_array_equal(h, jfirdes.firdes_notch(*args))
    g = firdes.firdes_kaiser(17, 0.2, 50.0)
    for lag in (-30, -3, 0, 2, 5, 60):
        assert firdes.filter_autocorrelation(h, lag) == \
            jfirdes.filter_autocorrelation(h, lag)
        assert firdes.filter_crosscorrelation(h, g, lag) == \
            jfirdes.filter_crosscorrelation(h, g, lag)
    assert firdes.filter_isi(h, 1, args[0]) == jfirdes.filter_isi(
        h, 1, args[0])
    assert firdes.filter_energy(h, 0.3, 64) == jfirdes.filter_energy(
        h, 0.3, 64)
    for bad in ((0, 0.1, 40.0), (5, 0.6, 40.0), (5, 0.1, -1.0)):
        with pytest.raises(ValueError):
            firdes.firdes_notch(*bad)


# ------------------------------------------------ framing and dotprod

def test_framing_matches_jax():
    tail, x = _c(7, 1), _c(40, 2)
    ext = framing.extend_with_tail(_t(tail), _t(x))
    _close(ext, jframing.extend_with_tail(jnp.asarray(tail), jnp.asarray(x)))
    for n in (0, 7):
        _close(framing.split_tail(ext, n),
               jframing.split_tail(jnp.asarray(ext.numpy()), n))
    for length, stride in ((8, 1), (5, 3)):
        _close(framing.frame_windows(ext, length, stride),
               jframing.frame_windows(jnp.asarray(ext.numpy()), length,
                                      stride))


@pytest.mark.parametrize("direction", ["forward", "reverse"])
def test_dotproduct_matches_jax(direction):
    c, w = RNG.standard_normal(9), _c(9 * 13, 3).reshape(13, 9)
    d = dotprod.DotProduct(c, direction, device="cpu")
    jd = jdotprod.DotProduct(c, direction)
    _close(d.coefficients(), jd.coefficients())
    _close(d.execute(w[0, :5]), jd.execute(w[0, :5]))
    _close(d.execute_block(w), jd.execute_block(w))
    assert len(d) == 9 and not d.is_empty() and repr(d) == repr(jd)
    _close(dotprod.dot(_t(c), _t(w[1])), jdotprod.dot(jnp.asarray(c),
                                                      jnp.asarray(w[1])))


# ----------------------------------------------------- functional core

@pytest.mark.parametrize("method", ["matmul", "fft", "auto", "measure"])
@pytest.mark.parametrize("ntaps,L", [(17, 301), (64, 1000), (200, 256),
                                     (1, 50)])
def test_fir_apply_matches_jax(method, ntaps, L):
    """Every method on real and complex taps with a carried tail, two
    blocks: 1e-12 (5e-12 "fft") of the output's scale; tails exact."""
    for taps in (RNG.standard_normal(ntaps),
                 RNG.standard_normal(ntaps) + 1j * RNG.standard_normal(ntaps)):
        x = _c(2 * L, 4)
        tail = _t(np.zeros(ntaps - 1, np.complex128))
        jtail = jnp.zeros(ntaps - 1, jnp.complex128)
        for b in range(2):
            xb = x[b * L:(b + 1) * L]
            y, tail = fir.fir_apply(_t(taps), tail, _t(xb), 1.5, method)
            jy, jtail = jfir.fir_apply(jnp.asarray(taps), jtail,
                                       jnp.asarray(xb), 1.5, method)
            _close(y, jy, 5e-12)
            _close(tail, jtail, 0.0)


def test_auto_method_rule():
    """"auto": the JAX CPU rule on the CPU (fft once ntaps > 2 log2(block)
    + 8); on the card matmul up to 384 taps, then measure."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert fir._pick_method("auto", 28, 1024, cpu) == "matmul"
    assert fir._pick_method("auto", 29, 1024, cpu) == "fft"
    assert fir._pick_method("auto", 24, 256, cpu) == "matmul"
    assert fir._pick_method("auto", 25, 256, cpu) == "fft"
    assert fir._pick_method("auto", 384, 1 << 20, cuda) == "matmul"
    assert fir._pick_method("auto", 385, 1 << 20, cuda) == "measure"
    assert fir._pick_method("fft", 3, 8, cuda) == "fft"


def test_card_route_rule():
    """The card's route by tap count (ops/fir.py::CARD_TOEPLITZ_MIN_TAPS,
    measured by torch_kernel_sweep.py fir-route): conv1d below 32 taps,
    the banded-Toeplitz matmul from 32 up; CPU tensors always take the
    convolution, as the JAX package does on its CPU."""
    class Card:
        is_cuda = True
    assert fir.CARD_TOEPLITZ_MIN_TAPS == 32
    assert not fir._use_toeplitz(Card(), 4)
    assert not fir._use_toeplitz(Card(), 31)
    assert fir._use_toeplitz(Card(), 32)
    assert fir._use_toeplitz(Card(), 300)
    assert not fir._use_toeplitz(torch.zeros(4), 300)


@pytest.mark.parametrize("kind", ["fir", "decim", "decim_sample", "pfb",
                                  "interp"])
def test_classes_pass_host_taps_to_the_toeplitz_route(kind, monkeypatch):
    """The classes hand the product their host copy of the taps, so the
    Toeplitz route (forced here on CPU tensors) never copies taps back from
    the device; the outputs equal the convolution route's."""
    taps = RNG.standard_normal(40)
    x = _c(96, 14)

    def run():
        if kind == "fir":
            return fir.FIRFilter(taps, 1.5, method="matmul",
                                 device="cpu").execute_block(x)
        if kind == "decim":
            return fir.DecimatingFIRFilter(taps, 1.0, 4,
                                           device="cpu").execute_block(x)
        if kind == "decim_sample":
            d = fir.DecimatingFIRFilter(taps, 1.0, 4, device="cpu")
            return torch.cat([d.execute(complex(v)) for v in x[:12]])
        if kind == "pfb":
            return fir.PolyPhaseFilterBank(taps, 4,
                                           device="cpu").push_block(x)
        return fir.InterpolatingFIRFilter(taps, 3,
                                          device="cpu").execute_block(x)

    want = run()

    def no_copy(t):
        raise AssertionError("taps copied from a tensor on the matmul route")
    monkeypatch.setattr(fir, "_host_taps", lambda t: (
        no_copy(t) if isinstance(t, torch.Tensor) else np.asarray(t)))
    monkeypatch.setattr(fir, "_use_toeplitz", lambda x, n: True)
    _close(run(), want)


def test_measure_caches_per_device_type():
    fir._METHOD_CACHE.clear()
    taps = _t(RNG.standard_normal(40))
    x = _t(_c(512, 5))
    fir.fir_apply(taps, torch.zeros(39, dtype=torch.complex128), x,
                  method="measure")
    key = (40, 512, str(x.dtype), "cpu")
    assert fir._METHOD_CACHE[key] in ("matmul", "fft")
    fir._METHOD_CACHE[key] = "fft"            # a cached winner is reused
    y, _ = fir.fir_apply(taps, torch.zeros(39, dtype=torch.complex128), x,
                         method="measure")
    y2, _ = fir.fir_apply(taps, torch.zeros(39, dtype=torch.complex128), x,
                          method="fft")
    assert torch.equal(y, y2)


@pytest.mark.parametrize("stride,O,block", [(1, None, None), (3, None, None),
                                            (4, 5, None), (2, None, 7),
                                            (8, 3, 100)])
@pytest.mark.parametrize("cplx_taps", [False, True])
def test_fir_toeplitz_matches_jax(stride, O, block, cplx_taps):
    n = 23
    shape = (n,) if O is None else (n, O)
    taps = RNG.standard_normal(shape)
    if cplx_taps:
        taps = taps + 1j * RNG.standard_normal(shape)
    for x in (_c(2 * 517, 6).reshape(2, 517), RNG.standard_normal(517)):
        y = fir.fir_toeplitz(_t(x), taps, stride=stride, block=block)
        jy = jfir.fir_toeplitz(jnp.asarray(x), jnp.asarray(taps),
                               stride=stride, block=block)
        _close(y, jy)
        _close(fir.conv1d_mxu(_t(x), _t(taps), stride=stride), jy)
    with pytest.raises(ValueError, match="shorter"):
        fir.fir_toeplitz(_t(np.ones(5)), taps, stride=stride)


def test_fir_toeplitz_precisions():
    """"x3" and "highest" are full precision here; "default" rounds both
    operands to bf16 first (the JAX package's single-pass bf16, ~45 dB)."""
    taps = firdes.firdes_kaiser(64, 0.1, 60.0).astype(np.float32)
    x = _t(_c(4096, 7).astype(np.complex64))
    hi = fir.fir_toeplitz(x, taps, stride=4)
    assert torch.equal(fir.fir_toeplitz(x, taps, stride=4, precision="x3"),
                       hi)
    ref = np.convolve(x.numpy().astype(np.complex128), taps[::-1],
                      "valid")[::4]
    assert snr_db(hi.numpy(), ref) >= 120.0
    lo = fir.fir_toeplitz(x, taps, stride=4, precision="default")
    assert 40.0 <= snr_db(lo.numpy(), ref) < 70.0
    with pytest.raises(ValueError):
        fir.fir_toeplitz(x, taps, precision="fast")


@pytest.mark.parametrize("M,phase", [(4, 0), (4, 1), (4, 3), (3, 2), (1, 0)])
def test_fir_decim_apply_matches_jax(M, phase):
    """The reference's phase counter: output at (phase + k + 1) % M == 0;
    two blocks, phase and tail carried (tensor and int phases)."""
    taps = RNG.standard_normal(21)
    x = _c(2 * 96 * M, 8)
    L = 96 * M
    tail, jtail = torch.zeros(20, dtype=torch.complex128), jnp.zeros(
        20, jnp.complex128)
    ph, jph = torch.tensor(phase, dtype=torch.int32), jnp.int32(phase)
    for b in range(2):
        xb = x[b * L:(b + 1) * L]
        y, tail, ph = fir.fir_decim_apply(taps, tail, ph, _t(xb), 2.0, M)
        jy, jtail, jph = jfir.fir_decim_apply(jnp.asarray(taps), jtail, jph,
                                              jnp.asarray(xb), 2.0, M)
        _close(y, jy)
        _close(tail, jtail, 0.0)
        assert int(ph) == int(jph) and ph.dtype == torch.int32
    _, _, p_int = fir.fir_decim_apply(taps, tail, phase, _t(x[:L]), 1.0, M)
    assert p_int == (phase + L) % M
    with pytest.raises(ValueError, match="multiple"):
        fir.fir_decim_apply(taps, tail, 0, _t(x[:L + 1]), 1.0, 2)


def test_phase_window_selects_on_device():
    """The card's window for a device phase (no host read): the same
    samples as slicing at every offset, batched or not."""
    x = _t(_c(3 * 200, 17).reshape(3, 200))
    for first in range(4):
        for xx in (x, x[0]):
            got = fir._phase_window(xx, torch.tensor(first), 197)
            assert torch.equal(got, xx[..., first:first + 197])


@pytest.mark.parametrize("P", [1, 3, 4])
def test_pfb_and_interp_apply_match_jax(P):
    c = RNG.standard_normal(24)
    B = fir.pfb_branch_matrix(c, P, device="cpu")
    jB = jfir.pfb_branch_matrix(c, P)
    _close(B, jB, 0.0)
    x = _c(200, 9)
    tail = torch.zeros(B.shape[0] - 1, dtype=torch.complex128)
    jtail = jnp.zeros(jB.shape[0] - 1, jnp.complex128)
    out, t1 = fir.pfb_apply_all(B, tail, _t(x))
    jout, jt1 = jfir.pfb_apply_all(jB, jtail, jnp.asarray(x))
    _close(out, jout)
    _close(t1, jt1, 0.0)
    y, t2 = fir.fir_interp_apply(B, tail, _t(x), 0.5)
    jy, jt2 = jfir.fir_interp_apply(jB, jtail, jnp.asarray(x), 0.5)
    _close(y, jy)
    _close(t2, jt2, 0.0)


# ------------------------------------------------------------- classes

@pytest.mark.parametrize("method", ["matmul", "fft"])
def test_fir_filter_streams_like_jax(method):
    """Uneven blocks through FIRFilter (float64 taps, complex128 blocks)."""
    taps = RNG.standard_normal(17)
    x = _c(301, 10)
    f = fir.FIRFilter(taps, 1.5, method=method, dtype=torch.float64,
                      device="cpu")
    jf = jfir.FIRFilter(taps, 1.5, method=method, dtype=jnp.float64)
    for lo, hi in ((0, 100), (100, 107), (107, 301)):
        _close(f.execute_block(x[lo:hi]), jf.execute_block(x[lo:hi]), 5e-12)
    _close(f.state, jf.state, 0.0)
    f.reset()
    assert not torch.any(f.state)


def test_decimating_filter_per_sample_matches_jax():
    """execute() pushes one sample at a time: the product runs on every
    M-th push; then a block continues from the per-sample phase."""
    taps = RNG.standard_normal(9)
    x = _c(120, 11)
    d = fir.DecimatingFIRFilter(taps, 1.0, 3, device="cpu")
    jd = jfir.DecimatingFIRFilter(taps, 1.0, 3)
    got = [d.execute(complex(v)) for v in x[:11]]
    want = [jd.execute(complex(v)) for v in x[:11]]
    for g, w in zip(got, want):
        _close(g, w)
    x2 = x[11:110]
    _close(d.execute_block(x2), jd.execute_block(jnp.asarray(x2)))
    with pytest.raises(ValueError, match="multiple"):
        d.execute_block(x[:4])


def test_polyphase_filter_bank_matches_jax():
    c = RNG.standard_normal(32)
    p = fir.PolyPhaseFilterBank(c, 4, device="cpu")
    jp = jfir.PolyPhaseFilterBank(c, 4)
    assert len(p) == 4 and p.sub_len == jp.sub_len == 8
    for a, b in zip(p.coefficients(), jp.coefficients()):
        np.testing.assert_array_equal(a, b)
    _close(p.execute_all(), jp.execute_all())         # the zeroed window
    x = _c(20, 12)
    for v in x[:5]:
        p.push(complex(v))
        jp.push(complex(v))
    for i in range(4):
        _close(p.execute(i), jp.execute(i))
    _close(p.execute_all(), jp.execute_all())
    _close(p.push_block(x[5:]), jp.push_block(jnp.asarray(x[5:])))
    _close(p.execute_all(), jp.execute_all())
    with pytest.raises(ValueError):
        p.execute(4)
    with pytest.raises(ValueError):
        fir.PolyPhaseFilterBank(c, 0, device="cpu")


@pytest.mark.parametrize("P", [2, 3])
def test_interpolating_filter_matches_jax(P):
    c = RNG.standard_normal(25)
    f = fir.InterpolatingFIRFilter(c, P, device="cpu")
    jf = jfir.InterpolatingFIRFilter(c, P)
    np.testing.assert_array_equal(f.coefficients(), jf.coefficients())
    x = _c(64, 13)
    _close(f.execute_block(x[:30]), jf.execute_block(jnp.asarray(x[:30])))
    _close(f.execute(complex(x[30])), jf.execute(complex(x[30])))
    _close(f.execute_block(x[31:]), jf.execute_block(jnp.asarray(x[31:])))
    _close(f.state, jf.state, 0.0)
    assert len(f) == P
    assert abs(f.frequency_response(0.1) - jf.frequency_response(0.1)) < 1e-12
    assert abs(f.group_delay(0.1) - jf.group_delay(0.1)) < 1e-9


@pytest.mark.parametrize("P,Q", [(3, 2), (1, 8), (2, 3), (5, 5)])
def test_rational_resampler_matches_jax(P, Q):
    """Three uneven blocks with the commutator phase and tail carried."""
    taps = firdes.firdes_kaiser(48 * P, 0.4 / max(P, Q), 60.0)
    x = _c(1000, 14)
    r = fir.RationalResampler(taps, P, Q, dtype=torch.complex128,
                              device="cpu")
    jr = jfir.RationalResampler(taps, P, Q, dtype=jnp.complex128)
    for lo, hi in ((0, 333), (333, 334), (334, 1000)):
        _close(r.execute_block(x[lo:hi]), jr.execute_block(jnp.asarray(
            x[lo:hi])))
    with pytest.raises(ValueError):
        fir.RationalResampler(taps, 0, 2, device="cpu")


def _zero_stuff_model(x, coefs, P, Q):
    """Independent interpolate-then-select (tests/test_snr_configs.py):
    out[n*P + f] = sum_k eff[f + (L-1-k)P] x[n-k], then every Q-th."""
    c = np.asarray(coefs, np.complex128)
    sub_len = -(-len(c) // P)
    eff = np.zeros(sub_len * P, np.complex128)
    eff[:len(c)] = c
    up = np.empty(len(x) * P, np.complex128)
    for f in range(P):
        up[f::P] = np.convolve(x, eff[f::P][::-1])[:len(x)]
    return up[::Q]


@pytest.mark.parametrize("P,Q", [(3, 2), (1, 8)])
def test_config3_resampler_vs_independent_model(P, Q):
    """Config 3 at 2^15 samples, two blocks: >= 100 dB against the
    zero-stuff model; float32 taps with complex64 blocks (a complex64
    product) >= 60 dB against it."""
    n = 1 << 15
    x = _c(n, 15)
    taps = firdes.firdes_kaiser(48 * P, 0.4 / max(P, Q), 60.0)
    want = _zero_stuff_model(x, taps, P, Q)
    r = fir.RationalResampler(taps, P, Q, dtype=torch.complex128,
                              device="cpu")
    got = torch.cat([r.execute_block(x[:n // 4]),
                     r.execute_block(x[n // 4:])]).numpy()
    assert got.shape == want.shape and snr_db(got, want) >= 100.0
    r32 = fir.RationalResampler(taps.astype(np.float32), P, Q,
                                dtype=torch.complex64, device="cpu")
    got32 = torch.cat([r32.execute_block(x[:n // 4].astype(np.complex64)),
                       r32.execute_block(x[n // 4:].astype(np.complex64))])
    assert got32.dtype == torch.complex64
    assert snr_db(got32.numpy(), want) >= 60.0


def test_config1_fir_complex64_vs_complex128():
    """Config 1 at 2^16: the 64-tap Kaiser filter on a tone, complex64
    against complex128 >= 60 dB, every method; complex128 against numpy's
    convolve >= 100 dB."""
    n = 1 << 16
    k = np.arange(n)
    x = 0.5 * np.exp(2j * np.pi * 0.03 * k) + 0.01 * _c(n, 16)
    taps = firdes.firdes_kaiser(64, 0.1, 60.0)
    ref = np.convolve(x, taps[::-1])[:n]
    for method in ("matmul", "fft", "auto"):
        f64 = fir.FIRFilter(taps, dtype=torch.complex128, method=method,
                            device="cpu")
        f32 = fir.FIRFilter(taps, dtype=torch.complex64, method=method,
                            device="cpu")
        y128 = torch.cat([f64.execute_block(x[:n // 2]),
                          f64.execute_block(x[n // 2:])]).numpy()
        y64 = torch.cat([f32.execute_block(x[:n // 2].astype(np.complex64)),
                         f32.execute_block(x[n // 2:].astype(np.complex64))])
        assert y64.dtype == torch.complex64
        assert snr_db(y128, ref) >= 100.0
        assert snr_db(y64.numpy(), y128) >= 60.0
