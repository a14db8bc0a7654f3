"""The port's rate changers and the autocorrelator (ops/cic.py,
ops/halfband.py, ops/resample.py, ops/autocorr.py) vs the JAX package's,
on the CPU.

Tolerances: JAX's own.  CIC against JAX 1e-10 of max|y| (tests/test_cic.py:
the unnormalized DC gain is (RM)^N), streaming 1e-10; halfband decimation
1e-12 (tests/test_halfband.py:136-158); the halfband interpolator 1e-12
against the zero-stuffed convolution and 1e-6 across block splits
(tests/test_resample.py:33-58); the resamplers in complex128 1e-9 against
JAX and across odd block splits (tests/test_resample.py:126-160), their
tone SNRs as JAX's (> 60 dB, > 50 dB in complex64); the grid engines 1e-4
(float32, tests/test_resample.py:273-304) and 2e-4; the autocorrelator
1e-10 (tests/test_autocorr.py).  F1: the JAX ArbitraryResampler's flush
in block_len mode raises, the port's drains the tail.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.ops import autocorr as jac
from solid_dsp_tpu.ops import cic as jcic
from solid_dsp_tpu.ops import halfband as jhb
from solid_dsp_tpu.ops import resample as jrs
from solid_dsp_tpu_torch.interop import tensors_from_numpy, tensors_to_numpy
from solid_dsp_tpu_torch.ops import autocorr, cic, halfband, resample

CPU = "cpu"
C128 = torch.complex128


def _cx(rng, n):
    return rng.standard_normal(n) + 1j * rng.standard_normal(n)


# ------------------------------------------------------------------- CIC

@pytest.mark.parametrize("R,N,M", [(4, 3, 1), (8, 4, 1), (5, 2, 2)])
def test_cic_decimator_matches_jax(R, N, M):
    rng = np.random.default_rng(R * N)
    x = _cx(rng, 40 * R)
    d = cic.CICDecimator(R, N, M, normalize=False, dtype=C128, device=CPU)
    jd = jcic.CICDecimator(R, N, M, normalize=False, dtype=jnp.complex128)
    got = d.execute_block(x).numpy()
    want = np.asarray(jd.execute_block(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-10 * np.abs(want).max())
    np.testing.assert_array_equal(cic.cic_kernel(R, N, M),
                                  jcic.cic_kernel(R, N, M))


def test_cic_streaming_dc_gain_and_response():
    rng = np.random.default_rng(5)
    x = _cx(rng, 4096)
    full = cic.CICDecimator(4, 3, dtype=C128, device=CPU).execute_block(x)
    d = cic.CICDecimator(4, 3, dtype=C128, device=CPU)
    parts = [d.execute_block(b).numpy() for b in np.split(x, [1000])]
    np.testing.assert_allclose(np.concatenate(parts), full.numpy(),
                               atol=1e-10)
    ones = np.ones(1024, np.complex128)
    assert abs(cic.CICDecimator(8, 4, dtype=C128, device=CPU)
               .execute_block(ones)[-1] - 1.0) < 1e-9
    assert abs(cic.CICInterpolator(8, 4, dtype=C128, device=CPU)
               .execute_block(ones)[-1] - 1.0) < 1e-9
    f = np.linspace(0.001, 0.5, 7)
    np.testing.assert_array_equal(cic.cic_frequency_response(f, 8, 4),
                                  jcic.cic_frequency_response(f, 8, 4))
    assert cic.CICDecimator(8, 4, device=CPU).frequency_response(0.01) == \
        jcic.CICDecimator(8, 4).frequency_response(0.01)
    assert repr(cic.CICDecimator(8, 4, device=CPU)) == \
        "CICDecimator [R=8] [N=4] [M=1]"


@pytest.mark.parametrize("dtype,jdtype,tol", [
    (torch.complex128, jnp.complex128, 1e-10),
    (torch.complex64, jnp.complex64, 1e-5)])
def test_cic_interpolator_matches_jax(dtype, jdtype, tol):
    rng = np.random.default_rng(3)
    x = _cx(rng, 300)
    u = cic.CICInterpolator(4, 3, dtype=dtype, device=CPU)
    ju = jcic.CICInterpolator(4, 3, dtype=jdtype)
    got = np.concatenate([u.execute_block(b).numpy()
                          for b in np.split(x, [101])])
    want = np.concatenate([np.asarray(ju.execute_block(jnp.asarray(b)))
                           for b in np.split(x, [101])])
    assert got.shape == (1200,)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def test_cic_state_interop_both_ways():
    rng = np.random.default_rng(4)
    x1, x2, x3 = (_cx(rng, 64) for _ in range(3))
    jd = jcic.CICDecimator(8, 4, dtype=jnp.complex128)
    d = cic.CICDecimator(8, 4, dtype=C128, device=CPU)
    jd.execute_block(jnp.asarray(x1))
    d.state = tensors_from_numpy({"tail": np.asarray(jd._tail),
                                  "phase": np.asarray(jd._phase)}, CPU)
    np.testing.assert_allclose(d.execute_block(x2).numpy(),
                               np.asarray(jd.execute_block(jnp.asarray(x2))),
                               atol=1e-12)
    back = tensors_to_numpy(d.state)
    jd._tail, jd._phase = jnp.asarray(back["tail"]), jnp.int32(back["phase"])
    np.testing.assert_allclose(d.execute_block(x3).numpy(),
                               np.asarray(jd.execute_block(jnp.asarray(x3))),
                               atol=1e-12)


# -------------------------------------------------------------- halfband

@pytest.mark.parametrize("m", [1, 3, 8, 12])
def test_firdes_halfband_matches_jax(m):
    np.testing.assert_allclose(halfband.firdes_halfband(m, 70.0),
                               jhb.firdes_halfband(m, 70.0), rtol=0,
                               atol=1e-15)


def test_halfband_decimator_matches_jax_and_streams():
    rng = np.random.default_rng(6)
    x = _cx(rng, 2000)
    d = halfband.HalfbandDecimator(8, dtype=C128, device=CPU)
    jd = jhb.HalfbandDecimator(8, dtype=jnp.complex128)
    got = np.concatenate([d.execute_block(b).numpy()
                          for b in np.split(x, [600, 1400])])
    want = np.concatenate([np.asarray(jd.execute_block(jnp.asarray(b)))
                           for b in np.split(x, [600, 1400])])
    np.testing.assert_allclose(got, want, atol=1e-12)
    whole = halfband.HalfbandDecimator(8, dtype=C128, device=CPU)
    np.testing.assert_allclose(got, whole.execute_block(x).numpy(),
                               atol=1e-12)
    with pytest.raises(ValueError):
        d.execute_block(np.ones(5, np.complex128))


@pytest.mark.parametrize("R", [4, 12, 16, 40])
def test_multistage_decimator_matches_jax(R):
    rng = np.random.default_rng(R)
    x = _cx(rng, 64 * R)
    d = halfband.MultistageDecimator(R, dtype=C128, device=CPU)
    jd = jhb.MultistageDecimator(R, dtype=jnp.complex128)
    assert d.total_taps == jd.total_taps
    assert (d.n_halfband, d.residual) == (jd.n_halfband, jd.residual)
    got = np.concatenate([d.execute_block(b).numpy()
                          for b in np.split(x, 2)])
    want = np.concatenate([np.asarray(jd.execute_block(jnp.asarray(b)))
                           for b in np.split(x, 2)])
    np.testing.assert_allclose(got, want, atol=1e-10)
    st = tensors_to_numpy(d.state)
    assert len(st["stages"]) == d.n_halfband


def test_halfband_interpolate_equals_zero_stuffed_conv():
    rng = np.random.default_rng(0)
    h = halfband.firdes_halfband(6, 70.0)
    c = (len(h) - 1) // 2
    x = _cx(rng, 200)
    u = np.zeros(400, complex)
    u[0::2] = x
    ref = 2 * np.convolve(u, h)[:400]
    y, _ = resample.halfband_interpolate(torch.from_numpy(h),
                                         torch.zeros(c, dtype=C128),
                                         torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), ref, atol=1e-12)


def test_halfband_interpolator_matches_jax_and_streams():
    rng = np.random.default_rng(1)
    x = _cx(rng, 1000)
    h1 = resample.HalfbandInterpolator(8, dtype=C128, device=CPU)
    jh = jrs.HalfbandInterpolator(8, dtype=jnp.complex128)
    ya = h1.execute_block(x).numpy()
    np.testing.assert_allclose(ya, np.asarray(jh.execute_block(
        jnp.asarray(x))), atol=1e-12)
    h2 = resample.HalfbandInterpolator(8, dtype=C128, device=CPU)
    yb = np.concatenate([h2.execute_block(b).numpy()
                         for b in np.split(x, [137, 400, 777])])
    np.testing.assert_allclose(ya, yb, atol=1e-6)
    assert len(ya) == 2000


# -------------------------------------------------------------- resample

def _tone_snr(y, rate, f_in, trim=None):
    trim = min(len(y) // 4, 4000) if trim is None else trim
    y = y[trim: len(y) - trim]
    ref = np.exp(2j * np.pi * (f_in / rate) * np.arange(len(y)))
    a = np.mean(np.conj(ref) * y)
    err = y - a * ref
    return 10 * np.log10(np.mean(np.abs(y) ** 2) / np.mean(np.abs(err) ** 2))


def test_pfb_tables_match_jax():
    np.testing.assert_array_equal(resample._pfb_tables(24, 64, 0.37, 60.0),
                                  jrs._pfb_tables(24, 64, 0.37, 60.0))


@pytest.mark.parametrize("rate", [0.37, 1 / np.pi, 0.713, 1.402, 2.5, 0.2])
def test_arbitrary_resampler_matches_jax_over_odd_blocks(rate):
    """The legacy path in complex128, cut at odd points (the halfband
    cascade's alignment remainder and the PFB's positions carried)."""
    rng = np.random.default_rng(2)
    x = _cx(rng, 12000)
    r = resample.ArbitraryResampler(rate, dtype=C128, device=CPU)
    jr = jrs.ArbitraryResampler(rate, dtype=jnp.complex128)
    cuts = [3001, 5111, 9003]
    got = np.concatenate([r.execute_block(b).numpy()
                          for b in np.split(x, cuts)])
    want = np.concatenate([np.asarray(jr.execute_block(jnp.asarray(b)))
                           for b in np.split(x, cuts)])
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, atol=1e-9)
    whole = resample.ArbitraryResampler(rate, dtype=C128, device=CPU)
    ya = whole.execute_block(x).numpy()
    n = min(len(ya), len(got))
    assert abs(len(ya) - len(got)) <= 1
    np.testing.assert_allclose(ya[:n], got[:n], atol=1e-9)
    assert repr(r) == repr(jr)


@pytest.mark.parametrize("rate,f_in,min_db", [(0.37, 0.10, 60.0),
                                              (1.7, 0.35, 58.0),
                                              (np.pi, 0.30, 60.0)])
def test_arbitrary_resampler_tone_fidelity(rate, f_in, min_db):
    r = resample.ArbitraryResampler(rate, dtype=C128, device=CPU)
    x = np.exp(2j * np.pi * f_in * np.arange(50000))
    assert _tone_snr(r.execute_block(x).numpy(), rate, f_in) > min_db


def test_complex64_accuracy():
    r = resample.ArbitraryResampler(0.77, dtype=torch.complex64, device=CPU)
    x = np.exp(2j * np.pi * 0.2 * np.arange(50000)).astype(np.complex64)
    assert _tone_snr(r.execute_block(x).numpy(), 0.77, 0.2) > 50.0


def test_pfb_batched_bank_matches_single_and_jax():
    rng = np.random.default_rng(5)
    xb = rng.standard_normal((4, 6000)) + 1j * rng.standard_normal((4, 6000))
    bank = resample.PfbArbitraryResampler(1.37, dtype=C128, batch_shape=(4,),
                                          device=CPU)
    yb = bank.execute_block(xb).numpy()
    single = resample.PfbArbitraryResampler(1.37, dtype=C128, device=CPU)
    np.testing.assert_array_equal(yb[2], single.execute_block(xb[2]).numpy())
    jb = jrs.PfbArbitraryResampler(1.37, dtype=jnp.complex128,
                                   batch_shape=(4,))
    np.testing.assert_allclose(yb, np.asarray(jb.execute_block(
        jnp.asarray(xb))), atol=1e-9)


def test_pfb_state_interop_both_ways():
    rng = np.random.default_rng(8)
    x1, x2, x3 = (_cx(rng, 999) for _ in range(3))
    jr = jrs.PfbArbitraryResampler(0.61, dtype=jnp.complex128)
    r = resample.PfbArbitraryResampler(0.61, dtype=C128, device=CPU)
    jr.execute_block(jnp.asarray(x1))
    r.state = tensors_from_numpy({"tail": np.asarray(jr._tail),
                                  "t_next": jr._t_next}, CPU)
    np.testing.assert_allclose(r.execute_block(x2).numpy(),
                               np.asarray(jr.execute_block(jnp.asarray(x2))),
                               atol=1e-9)
    back = tensors_to_numpy(r.state)
    jr._tail, jr._t_next = jnp.asarray(back["tail"]), float(back["t_next"])
    np.testing.assert_allclose(r.execute_block(x3).numpy(),
                               np.asarray(jr.execute_block(jnp.asarray(x3))),
                               atol=1e-9)


def test_pfb_grid_engine_matches_jax_and_legacy():
    from solid_dsp_tpu_torch.ops.gridresample import plan_ratio

    L = 4096
    ratio = plan_ratio(1 / 0.37, L).ratio
    rng = np.random.default_rng(1)
    x = _cx(rng, 3 * L).astype(np.complex64)
    init, apply, plan = resample.make_pfb_resampler(ratio, L, device=CPU)
    jinit, japply, _ = jrs.make_pfb_resampler(ratio, L)
    st, jst, outs, jouts = init(), jinit(), [], []
    for i in range(3):
        y, nv, st = apply(st, torch.from_numpy(x[i * L:(i + 1) * L]))
        jy, jnv, jst = japply(jst, jnp.asarray(x[i * L:(i + 1) * L]))
        assert int(nv) == int(jnv)
        outs.append(y.numpy()[:int(nv)])
        jouts.append(np.asarray(jy)[:int(jnv)])
    got = np.concatenate(outs)
    np.testing.assert_allclose(got, np.concatenate(jouts), atol=1e-5)
    assert int(st[1]) == int(jst[1])
    leg = resample.PfbArbitraryResampler(ratio, dtype=torch.complex64,
                                         device=CPU)
    ys = np.concatenate([leg.execute_block(x[i * L:(i + 1) * L]).numpy()
                         for i in range(3)])
    assert len(got) == len(ys)
    assert np.max(np.abs(got - ys)) < 1e-4


@pytest.mark.parametrize("rate", [1.0 / (2.0 * 1.3515625),
                                  float(2 ** 20) / 419430.0,
                                  1.0 / 1.296875, 0.37, 2.5])
def test_arb_grid_engine_matches_jax_and_class(rate):
    L = 8192
    rng = np.random.default_rng(3)
    x = _cx(rng, 3 * L).astype(np.complex64)
    init, apply, n_pad = resample.make_arb_resampler(rate, L, device=CPU)
    jinit, japply, jn_pad = jrs.make_arb_resampler(rate, L)
    assert n_pad == jn_pad
    st, jst, outs, jouts = init(), jinit(), [], []
    for i in range(3):
        y, nv, st = apply(st, torch.from_numpy(x[i * L:(i + 1) * L]))
        jy, jnv, jst = japply(jst, jnp.asarray(x[i * L:(i + 1) * L]))
        assert int(nv) == int(jnv)
        outs.append(y.numpy()[:int(nv)])
        jouts.append(np.asarray(jy)[:int(jnv)])
    got = np.concatenate(outs)
    np.testing.assert_allclose(got, np.concatenate(jouts), atol=2e-4)
    cls = resample.ArbitraryResampler(rate, dtype=torch.complex64,
                                      block_len=L, device=CPU)
    ys = np.concatenate([cls.execute_block(x[i * L:(i + 1) * L]).numpy()
                         for i in range(3)])
    np.testing.assert_array_equal(ys, got)
    assert isinstance(cls.state["grid"], dict)


def test_grid_envelope_falls_back_to_the_legacy_path():
    """Interpolation beyond 16x is outside the grid: block_len is dropped
    and the legacy path runs, as in the JAX package."""
    r = resample.ArbitraryResampler(20.0, block_len=1000, device=CPU)
    jr = jrs.ArbitraryResampler(20.0, block_len=1000)
    assert r._grid is None and jr._grid is None
    assert r.execute_block(np.ones(37, np.complex64)).shape[-1] > 0


def test_f1_flush_in_block_len_mode():
    """F1 (ROADMAP's faults of the reference): with block_len set, the JAX
    flush() feeds one block of another length and raises; the port feeds
    whole zero blocks and returns a tail that carries the signal
    (tests/test_resample.py:186-202); an identity flush stays empty."""
    n, L = 40000, 8000
    x = np.exp(2j * np.pi * 0.003 * np.arange(n)).astype(np.complex64)
    jr = jrs.ArbitraryResampler(0.37, block_len=L)
    for i in range(n // L):
        jr.execute_block(jnp.asarray(x[i * L:(i + 1) * L]))
    with pytest.raises(ValueError, match="block_len"):
        jr.flush()
    for rate in (0.37, 2.5):
        r = resample.ArbitraryResampler(rate, block_len=L, device=CPU)
        assert r._grid is not None
        y = np.concatenate([r.execute_block(x[i * L:(i + 1) * L]).numpy()
                            for i in range(n // L)])
        tail = r.flush().numpy()
        assert len(y) + len(tail) >= int(round(n * rate)), rate
        if rate <= 0.5:
            assert np.abs(tail[: max(1, len(tail) // 4)]).max() > 0.1
    assert len(resample.ArbitraryResampler(1.0, block_len=L,
                                           device=CPU).flush()) == 0


@pytest.mark.parametrize("rate", [0.01, 0.37, 2.5])
def test_flush_matches_jax_on_the_legacy_path(rate):
    x = np.exp(2j * np.pi * 0.003 * np.arange(20000))
    r = resample.ArbitraryResampler(rate, dtype=C128, device=CPU)
    jr = jrs.ArbitraryResampler(rate, dtype=jnp.complex128)
    r.execute_block(x)
    jr.execute_block(jnp.asarray(x))
    np.testing.assert_allclose(r.flush().numpy(), np.asarray(jr.flush()),
                               atol=1e-9)
    assert len(resample.ArbitraryResampler(1.0, device=CPU).flush()) == 0


def test_arbitrary_resampler_state_interop():
    rng = np.random.default_rng(9)
    x1, x2 = _cx(rng, 5001), _cx(rng, 3000)
    jr = jrs.ArbitraryResampler(0.37, dtype=jnp.complex128)
    r = resample.ArbitraryResampler(0.37, dtype=C128, device=CPU)
    jr.execute_block(jnp.asarray(x1))
    pfb = jr.stages[1]
    r.state = tensors_from_numpy({
        "stages": [{"tail": np.asarray(jr.stages[0]._tail)},
                   {"tail": np.asarray(pfb._tail), "t_next": pfb._t_next}],
        "rem": np.asarray(jr._rem)}, CPU)
    np.testing.assert_allclose(r.execute_block(x2).numpy(),
                               np.asarray(jr.execute_block(jnp.asarray(x2))),
                               atol=1e-9)
    back = tensors_to_numpy(r.state)
    assert back["rem"].shape == np.asarray(jr._rem).shape


def test_validation():
    with pytest.raises(ValueError):
        resample.ArbitraryResampler(0.0, device=CPU)
    with pytest.raises(ValueError):
        resample.ArbitraryResampler(0.5, fpass=0.6, device=CPU)
    with pytest.raises(ValueError):
        resample.PfbArbitraryResampler(-1.0, device=CPU)
    with pytest.raises(ValueError):
        resample.PfbArbitraryResampler(1.0, cutoff=0.7, device=CPU)
    r = resample.ArbitraryResampler(0.5, block_len=1024, device=CPU)
    with pytest.raises(ValueError, match="block_len"):
        r.execute_block(np.ones(1000, np.complex64))


# -------------------------------------------------------------- autocorr

@pytest.mark.parametrize("W,D", [(8, 3), (6, 2), (5, 10), (1, 0), (4, 0)])
def test_autocorrelator_matches_jax(W, D):
    rng = np.random.default_rng(11 + W)
    x = _cx(rng, 200)
    ac = autocorr.AutoCorrelator(W, D, dtype=C128, device=CPU)
    jac_ = jac.AutoCorrelator(W, D, dtype=jnp.complex128)
    got = np.concatenate([ac.execute_block(b).numpy()
                          for b in np.split(x, [81])])
    want = np.concatenate([np.asarray(jac_.execute_block(jnp.asarray(b)))
                           for b in np.split(x, [81])])
    np.testing.assert_allclose(got, want, atol=1e-10)
    assert abs(ac.get_energy() - jac_.get_energy()) < 1e-10
    np.testing.assert_allclose(complex(ac.execute()),
                               complex(jac_.execute()), atol=1e-10)


def test_autocorrelator_energy_golden_and_state():
    k = np.arange(-250, 250).astype(np.float64)
    x = 0.05 * np.cos(k) + 1j * 0.05 * np.sin(k)
    ac = autocorr.AutoCorrelator(5, 10, dtype=C128, device=CPU)
    out = ac.execute_block(x).numpy()
    assert round(ac.get_energy() * 10000.0) == 125.0
    np.testing.assert_array_equal(out, np.zeros_like(out))
    jac_ = jac.AutoCorrelator(8, 3, dtype=jnp.complex128)
    p = autocorr.AutoCorrelator(8, 3, dtype=C128, device=CPU)
    jac_.execute_block(jnp.asarray(x[:100]))
    p.state = tensors_from_numpy({**{k: np.asarray(v)
                                     for k, v in jac_._st.items()},
                                  "energy": jac_._energy}, CPU)
    np.testing.assert_allclose(p.execute_block(x[100:]).numpy(),
                               np.asarray(jac_.execute_block(
                                   jnp.asarray(x[100:]))), atol=1e-12)
    assert set(tensors_to_numpy(p.state)) == {"x_tail", "e_tail", "energy"}
    p.reset()
    assert p.get_energy() == 0.0


def test_entry_points_default_to_the_card():
    makers = (lambda: cic.CICDecimator(8, 4),
              lambda: halfband.HalfbandDecimator(8),
              lambda: resample.ArbitraryResampler(0.37),
              lambda: autocorr.AutoCorrelator(8, 3))
    for make in makers:
        if torch.cuda.is_available():
            assert make().device.type == "cuda"
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                make()
