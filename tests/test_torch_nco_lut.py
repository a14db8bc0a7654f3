"""The port's LUT oscillator and NCO (ops/nco.py) vs the JAX package's and the
reference simulator, on the CPU.

Tolerances: the table read ("lut", "lut-table") is bit-equal (the same
rounded 10-bit index into the same table; the port reads the table on
every device, as the JAX package does on its CPU); "exact" within 1e-12;
mixed blocks, a complex product of x and the oscillator, within 1e-6 in
complex64 (XLA's CPU takes it with FMA) and 1e-12 in complex128; phase
words exact; pll_step's u32 words exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ref_sim import RefNCO
from solid_dsp_tpu.ops import nco as jnco
from solid_dsp_tpu_torch.ops import nco


@pytest.mark.parametrize("theta0,rad,n", [(0, 0.1, 1000), (3_000_000_000,
                                                           -1.3, 4096),
                                          (0xFFFFFFFF, 2.5, 300), (5, 0.0, 1)])
@pytest.mark.parametrize("lut_dt", [None, np.float32, np.float64])
@pytest.mark.parametrize("mode", ["lut", "lut-table"])
def test_nco_sincos_lut_bit_equal(theta0, rad, n, lut_dt, mode):
    d = nco.constrain(rad)
    table = None if lut_dt is None else nco.make_sine_lut(lut_dt)
    s, c = nco.nco_sincos(torch.tensor(theta0, dtype=torch.int64), d, n,
                          table, mode)
    js, jc = jnco.nco_sincos(np.uint32(theta0), np.uint32(d), n, table, mode)
    assert s.dtype == torch.from_numpy(np.asarray(js).copy()).dtype
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))


def test_lut_index_and_table_match_jax():
    w = np.array([0, 1 << 21, (1 << 21) - 1, 0xFFFFFFFF, 0xFFE00000,
                  0x80000000, 123456789], dtype=np.uint32)
    got = nco._lut_index(torch.from_numpy(w.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnco._lut_index(jnp.asarray(w))))
    for dt in (np.float32, np.float64):
        np.testing.assert_array_equal(nco.make_sine_lut(dt),
                                      jnco.make_sine_lut(dt))


def test_nco_sincos_exact_matches_jax():
    d = nco.constrain(0.37)
    s, c = nco.nco_sincos(4_000_000_000, d, 777, mode="exact", device="cpu")
    js, jc = jnco.nco_sincos(np.uint32(4_000_000_000), np.uint32(d), 777,
                             mode="exact")
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-12)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-12)
    with pytest.raises(ValueError):
        nco.nco_sincos(0, d, 8, mode="cordic")


@pytest.mark.parametrize("fn", ["nco_phases", "nco_sincos",
                                "nco_complex_exponential", "pll_step"])
def test_python_phase_words_default_to_the_card(fn):
    """A Python int phase word (a float phase error for pll_step) lands on
    the device asked for, and with none on the card: on a machine without
    one the call raises PyTorch's own error instead of taking the CPU.  A
    tensor word stays where it lies."""
    d = int(nco.constrain(0.37))
    call = {"nco_phases": lambda **kw: nco.nco_phases(5, d, 16, **kw),
            "nco_sincos": lambda **kw: nco.nco_sincos(5, d, 16, **kw)[0],
            "nco_complex_exponential":
                lambda **kw: nco.nco_complex_exponential(5, d, 16, **kw),
            "pll_step": lambda **kw: nco.pll_step(5, d, 0.1, 0.05, 0.2,
                                                  **kw)[0]}[fn]
    assert call(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert call().device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            call()
    if fn != "pll_step":
        tensor_call = {"nco_phases": nco.nco_phases,
                       "nco_sincos": lambda *a: nco.nco_sincos(*a)[0],
                       "nco_complex_exponential":
                           nco.nco_complex_exponential}[fn]
        assert tensor_call(torch.tensor(5), d, 16).device.type == "cpu"


def test_nco_lut_block_and_wraparound_vs_reference():
    """The reference's per-sample NCO (sin, cos, step) and the class's
    block output, bit-equal, through a fast-wrapping phase."""
    for rad, phase, n in ((0.1, 0.0, 1000), (2.5, 1.0, 300)):
        ref = RefNCO()
        ref.set_frequency(rad)
        ref.set_phase(phase)
        sref, cref = [], []
        for _ in range(n):
            sref.append(ref.sin())
            cref.append(ref.cos())
            ref.step()
        o = nco.NCO(mode="lut", device="cpu")
        o.set_frequency(rad)
        o.set_phase(phase)
        s, c = o.sincos_block(n)
        np.testing.assert_array_equal(s.numpy(), np.array(sref))
        np.testing.assert_array_equal(c.numpy(), np.array(cref))
        assert int(o.theta) == int(ref.theta)


@pytest.mark.parametrize("mode,dt,atol", [("lut", np.complex64, 1e-6),
                                          ("lut", np.complex128, 1e-12),
                                          ("exact", np.complex64, 1e-6),
                                          ("exact", np.complex128, 1e-12)])
def test_mix_blocks_match_jax(mode, dt, atol):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(5000) + 1j * rng.standard_normal(5000)).astype(dt)
    d = nco.constrain(0.37)
    lut = nco.make_sine_lut(np.float32 if dt == np.complex64 else np.float64)
    for fn, jfn in ((nco.mix_down_block, jnco.mix_down_block),
                    (nco.mix_up_block, jnco.mix_up_block)):
        y, th = fn(torch.from_numpy(x), torch.tensor(4_000_000_000), d, lut,
                   mode)
        jy, jth = jfn(jnp.asarray(x), jnp.uint32(4_000_000_000),
                      jnp.uint32(d), lut, mode)
        assert y.dtype == torch.from_numpy(x).dtype
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                                   atol=atol)
        assert int(th) == int(jth)


def test_nco_class_matches_jax():
    """Every method of the stateful NCO against the JAX class, LUT mode:
    blocks, single values, mixing with phase continuity, accessors."""
    o, jo = nco.NCO(mode="lut", device="cpu"), jnco.NCO(mode="lut")
    for obj in (o, jo):
        obj.set_frequency(0.05)
        obj.adjust_frequency(0.01)
        obj.set_phase(0.3)
        obj.adjust_phase(-0.7)
    assert (int(o.theta), int(o.delta_theta)) == (int(jo.theta),
                                                  int(jo.delta_theta))
    assert o.get_frequency() == jo.get_frequency()
    assert o.get_phase() == jo.get_phase()
    assert o.sincos() == jo.sincos() and o.sin() == jo.sin()
    assert o.cos() == jo.cos()
    assert o.complex_exponential() == jo.complex_exponential()
    np.testing.assert_array_equal(o.complex_exponential_block(37).numpy(),
                                  np.asarray(jo.complex_exponential_block(37)))
    x = np.ones(100, np.complex128)
    a = torch.cat([o.mix_up_block(x[:37]), o.mix_up_block(x[37:])])
    ja = np.concatenate([np.asarray(jo.mix_up_block(jnp.asarray(x[:37]))),
                         np.asarray(jo.mix_up_block(jnp.asarray(x[37:])))])
    np.testing.assert_array_equal(a.numpy(), ja)
    np.testing.assert_array_equal(o.mix_down_block(x[:10]).numpy(),
                                  np.asarray(jo.mix_down_block(
                                      jnp.asarray(x[:10]))))
    assert o.mix_up(2.0 + 1j) == jo.mix_up(2.0 + 1j)
    assert o.mix_down(2.0 + 1j) == jo.mix_down(2.0 + 1j)
    o.step()
    jo.step()
    for obj in (o, jo):
        obj.set_internal_pll_bandwidth(0.04)
        obj.pll_step(0.3)
    assert (int(o.theta), int(o.delta_theta)) == (int(jo.theta),
                                                  int(jo.delta_theta))
    assert o.alpha == 0.04 and abs(o.beta - 0.2) < 1e-15
    assert repr(o) == repr(jo)
    with pytest.raises(ValueError):
        o.set_internal_pll_bandwidth(-1.0)
    o.reset()
    assert int(o.theta) == int(o.delta_theta) == 0


def test_exact_mode_class_round_trip():
    up = nco.NCO(mode="exact", device="cpu")
    up.set_frequency(0.3)
    x = np.exp(1j * np.random.default_rng(0).standard_normal(256))
    y = up.mix_up_block(x)
    down = nco.NCO(mode="exact", device="cpu")
    down.set_frequency(0.3)
    np.testing.assert_allclose(down.mix_down_block(y).numpy(), x, atol=1e-9)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_pll_step_matches_jax(dt):
    """The tensor constrain: u32 words as int64, exact, for phase errors of
    both signs (float32 and float64)."""
    dphi = np.array([0.3, -0.2, 2.9, -3.1, 0.0], dt)
    theta = np.array([0, 5, 0xFFFFFFF0, 1 << 31, 7], np.uint32)
    dtheta = np.array([9, 0xFFFFFFFF, 3, 0, 1 << 20], np.uint32)
    th, dth = nco.pll_step(torch.from_numpy(theta.astype(np.int64)),
                           torch.from_numpy(dtheta.astype(np.int64)),
                           torch.from_numpy(dphi), 0.05, 0.2)
    jth, jdth = jnco.pll_step(jnp.asarray(theta), jnp.asarray(dtheta),
                              jnp.asarray(dphi), 0.05, 0.2)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jth).astype(np.int64))
    np.testing.assert_array_equal(dth.numpy(),
                                  np.asarray(jdth).astype(np.int64))
