"""The port's AGC (ops/agc.py: the exact scan, S1's plain version on the
CPU; the parallel Newton solve; the AGC class) and linear recurrences
(ops/linrec.py) vs the JAX package's, on the CPU.

Tolerances: JAX's own (tests/test_nco_agc.py:214-340).  agc_apply against
JAX's scan in float64: atol 1e-12 on y, rtol 1e-12 on gain and energy,
mode and timer equal.  agc_apply_parallel: against the exact scan atol
1e-11, gain rtol 1e-10, energy rtol 1e-9 (JAX's _cmp_parallel), and against
JAX's parallel the same; the gate fall-back bit-equal to the scan.  The AGC
goldens (ref auto_gain_control/mod.rs:19-41): |y[-1]| in (0.98, 1.02),
rssi in (-26, -25.5).  float32 scans: 1e-5 of max|y| (the libraries'
logf/expf differ in the last ulp).  linrec: 1e-10 of the scale in
float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ref_sim import RefAGC
from solid_dsp_tpu.ops import agc as jagc
from solid_dsp_tpu.ops import linrec as jlinrec
from solid_dsp_tpu_torch.ops import agc, linrec

S = agc.SquelchMode


def _c(n, amp, seed):
    rng = np.random.default_rng(seed)
    return amp * (rng.standard_normal(n) + 1j * rng.standard_normal(n))


def _state(**over):
    st = agc.agc_init(torch.float64, "cpu")
    for k, v in over.items():
        st[k] = torch.tensor(v, dtype=st[k].dtype)
    return st


def _jstate(**over):
    st = dict(jagc.agc_init(jnp.float64))
    for k, v in over.items():
        st[k] = jnp.asarray(v, dtype=st[k].dtype)
    return st


def _tone(n=500, amp=0.05):
    k = np.arange(-n // 2, n // 2).astype(np.float64)
    return amp * np.cos(k) + 1j * amp * np.sin(k)


def _cmp_state(s, js, rtol_gain=1e-12, rtol_energy=1e-12):
    np.testing.assert_allclose(float(s["gain"]), float(js["gain"]),
                               rtol=rtol_gain)
    np.testing.assert_allclose(float(s["energy"]), float(js["energy"]),
                               rtol=rtol_energy)
    for k in ("mode", "timer", "lock"):
        assert int(s[k]) == int(js[k]), k
        assert s[k].dtype == {"mode": torch.int32, "timer": torch.int32,
                              "lock": torch.bool}[k]


CASES = [dict(amp=0.1, alpha=0.02, T=1000), dict(amp=1.0, alpha=0.1, T=512),
         dict(amp=100.0, alpha=0.1, T=700), dict(amp=1e-3, alpha=0.05, T=900)]


@pytest.mark.parametrize("case", CASES)
def test_agc_apply_matches_jax(case):
    x = _c(case["T"], case["amp"], 11)
    y, s = agc.agc_apply(_state(), torch.from_numpy(x), case["alpha"], 1.0,
                         -1e30, 100)
    jy, js = jagc.agc_apply(_jstate(), jnp.asarray(x), case["alpha"], 1.0,
                            -1e30, 100)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-12)
    _cmp_state(s, js)


def test_agc_apply_batched_and_float32_match_jax():
    """Leading axes are independent carries (one per channel); a float32
    carry on complex64 blocks."""
    x = _c(3 * 600, 0.2, 12).reshape(3, 600).astype(np.complex64)
    st = agc.agc_init(torch.float32, "cpu", (3,))
    st["gain"] = torch.tensor([1.0, 3.0, 0.5])
    jst = dict(jagc.agc_init(jnp.float32, (3,)))
    jst["gain"] = jnp.asarray([1.0, 3.0, 0.5], jnp.float32)
    y, s = agc.agc_apply(st, torch.from_numpy(x), 0.05, 1.0, -1e30, 100)
    jy, js = jagc.agc_apply(jst, jnp.asarray(x), 0.05, 1.0, -1e30, 100)
    assert y.dtype == torch.complex64 and s["gain"].dtype == torch.float32
    jy = np.asarray(jy)
    np.testing.assert_allclose(y.numpy(), jy, rtol=0,
                               atol=1e-5 * np.abs(jy).max())
    np.testing.assert_allclose(s["gain"].numpy(), np.asarray(js["gain"]),
                               rtol=1e-5)


def test_agc_squelch_timeout_path_matches_reference():
    """loud -> quiet walks RISE -> SIGNALHI -> FALL -> SIGNALLO -> TIMEOUT
    -> ENABLED: the reference simulator within 1e-9, JAX's scan within
    1e-12, the final mode equal."""
    rng = np.random.default_rng(10)
    x = np.concatenate([np.exp(1j * rng.standard_normal(50)),
                        1e-8 * np.exp(1j * rng.standard_normal(300))])
    ref = RefAGC()
    ref.mode, ref.threshold, ref.alpha, ref.timeout = RefAGC.ENABLED, -30.0, \
        0.1, 20
    want = ref.execute_block(x)
    a = agc.AGC(device="cpu")
    a.squelch_enable()
    a.squelch_set_threshold(-30.0)
    a.squelch_set_timeout(20)
    got = a.execute_block(x).numpy()
    np.testing.assert_allclose(got, want, atol=1e-9)
    assert a.squelch_get_mode() == ref.mode
    y, s = agc.agc_apply(_state(mode=S.ENABLED), torch.from_numpy(x), 0.1,
                         1.0, -30.0, 20)
    jy, js = jagc.agc_apply(_jstate(mode=S.ENABLED), jnp.asarray(x), 0.1,
                            1.0, -30.0, 20)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-12)
    _cmp_state(s, js)


@pytest.mark.parametrize("mode", [S.UNKNOWN, S.ENABLED, S.RISE, S.SIGNALHI,
                                  S.FALL, S.SIGNALLO, S.TIMEOUT, S.DISABLED])
def test_squelch_fsm_plain_matches_jax(mode):
    """S1's FSM entry (plain version) from every state over an rssi track
    crossing the threshold: modes and the final timer equal JAX's FSM."""
    rssi = np.concatenate([np.full(7, -10.0), np.full(30, -40.0),
                           np.full(4, -5.0), np.full(25, -50.0)])
    m0, t0 = torch.tensor(mode, dtype=torch.int32), torch.tensor(
        3, dtype=torch.int32)
    modes, m, t = agc.squelch_fsm_plain(torch.from_numpy(rssi), m0, t0,
                                        -30.0, 9)
    jm, jt, want = jnp.int32(mode), jnp.int32(3), []
    for r in rssi:
        jm, jt = jagc._squelch_update(jm, jt, jnp.float64(r), -30.0, 9)
        want.append(int(jm))
    np.testing.assert_array_equal(modes.numpy(), want)
    assert int(m) == int(jm) and int(t) == int(jt)


def test_agc_locked_and_far_gain_match_jax():
    x = _c(800, 0.3, 15)
    for over in (dict(lock=True, gain=3.0), dict(gain=1000.0),
                 dict(gain=1e-4, energy=100.0)):
        y, s = agc.agc_apply(_state(**over), torch.from_numpy(x), 0.05, 1.0,
                             -1e30, 100)
        jy, js = jagc.agc_apply(_jstate(**over), jnp.asarray(x), 0.05, 1.0,
                                -1e30, 100)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-12)
        _cmp_state(s, js)


# ------------------------------------------------- the parallel solve

def _cmp_parallel(x, st, jst, alpha, thr=-1e30, to=100):
    y1, s1 = agc.agc_apply(st, torch.from_numpy(x), alpha, 1.0, thr, to)
    y2, s2 = agc.agc_apply_parallel(st, torch.from_numpy(x), alpha, 1.0,
                                    thr, to)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-11)
    _cmp_state(s2, s1, rtol_gain=1e-10, rtol_energy=1e-9)
    jy2, js2 = jagc.agc_apply_parallel(jst, jnp.asarray(x), alpha, 1.0, thr,
                                       to)
    np.testing.assert_allclose(y2.numpy(), np.asarray(jy2), atol=1e-11)
    _cmp_state(s2, js2, rtol_gain=1e-10, rtol_energy=1e-9)
    return y1, y2


@pytest.mark.parametrize("case", CASES)
def test_agc_parallel_matches_scan_and_jax(case):
    x = _c(case["T"], case["amp"], 21)
    _cmp_parallel(x, _state(), _jstate(), case["alpha"])


def test_agc_parallel_newton_path_runs_and_counts_syncs():
    """On a benign stream the Newton path (not the fall-back) gives the
    output: it differs from the scan in the last ulps; the host reads are
    the lock/mode read, one a Newton iteration and the gate test."""
    before = agc.agc_apply_parallel.fallbacks
    y1, y2 = _cmp_parallel(_c(4096, 0.1, 12), _state(), _jstate(), 0.02)
    assert float((y1 - y2).abs().max()) != 0.0
    assert agc.agc_apply_parallel.fallbacks == before
    it = agc.agc_apply_parallel.newton_iters
    assert 1 <= it <= 24 and agc.agc_apply_parallel.syncs == it + 2


def test_agc_parallel_far_gain_squelch_and_locked():
    x = _c(4096, 0.1, 13)
    _cmp_parallel(x, _state(gain=1000.0), _jstate(gain=1000.0), 0.05)
    _cmp_parallel(x, _state(gain=1e-4, energy=100.0),
                  _jstate(gain=1e-4, energy=100.0), 0.05)
    rng = np.random.default_rng(14)
    xs = np.concatenate([np.exp(1j * rng.standard_normal(50)),
                         1e-4 * np.exp(1j * rng.standard_normal(300))])
    _cmp_parallel(xs, _state(mode=S.ENABLED), _jstate(mode=S.ENABLED), 0.1,
                  thr=-30.0, to=20)
    xl = _c(2048, 0.3, 15)
    _cmp_parallel(xl, _state(lock=True, gain=3.0),
                  _jstate(lock=True, gain=3.0), 0.02)


def test_agc_parallel_gate_fallback_bit_exact():
    """All-zero input: the energy decays through the 1e-6 gate and the gain
    climbs to the 1e6 clamp; the parallel path falls back to the scan
    (counted) and is bit-equal to it."""
    st = _state()
    x = torch.zeros(2000, dtype=torch.complex128)
    before = agc.agc_apply_parallel.fallbacks
    y1, s1 = agc.agc_apply(st, x, 0.02, 1.0, -1e30, 100)
    y2, s2 = agc.agc_apply_parallel(st, x, 0.02, 1.0, -1e30, 100)
    assert torch.equal(y1, y2)
    assert float(s1["gain"]) == float(s2["gain"]) == 1e6
    assert float(s1["energy"]) == float(s2["energy"])
    assert agc.agc_apply_parallel.fallbacks == before + 1


def test_agc_parallel_streaming_continuation():
    x = _c(6000, 0.1, 16)
    st = _state()
    y_full, s_full = agc.agc_apply_parallel(st, torch.from_numpy(x), 0.02,
                                            1.0, -1e30, 100)
    y_a, s_mid = agc.agc_apply_parallel(st, torch.from_numpy(x[:2500]), 0.02,
                                        1.0, -1e30, 100)
    y_b, s_end = agc.agc_apply_parallel(s_mid, torch.from_numpy(x[2500:]),
                                        0.02, 1.0, -1e30, 100)
    np.testing.assert_allclose(y_full.numpy(),
                               torch.cat([y_a, y_b]).numpy(), atol=1e-11)
    np.testing.assert_allclose(float(s_full["gain"]), float(s_end["gain"]),
                               rtol=1e-10)


def test_agc_parallel_class_vs_reference():
    rng = np.random.default_rng(17)
    x = 0.1 * (rng.standard_normal(400) + 1j * rng.standard_normal(400))
    ref = RefAGC()
    ref.mode, ref.threshold, ref.alpha = RefAGC.ENABLED, -30.0, 0.02
    want = ref.execute_block(x)
    a = agc.AGC(method="parallel", device="cpu")
    a.squelch_enable()
    a.squelch_set_threshold(-30.0)
    a.set_bandwidth(0.02)
    np.testing.assert_allclose(a.execute_block(x).numpy(), want, atol=1e-10)
    assert a.squelch_get_mode() == ref.mode


# ------------------------------------------------------ the AGC class

@pytest.mark.parametrize("method", ["scan", "parallel"])
def test_agc_class_goldens(method):
    """ref auto_gain_control/mod.rs:19-41: |y[-1]| -> 1 +- 0.02 and rssi
    in (-26, -25.5), both methods; the JAX class agrees to 1e-10."""
    x = _tone()
    a, ja = agc.AGC(method=method, device="cpu"), jagc.AGC(method=method)
    for obj in (a, ja):
        obj.squelch_enable()
        obj.squelch_set_threshold(-30.0)
        obj.set_bandwidth(0.02)
    y = a.execute_block(x).numpy()
    jy = np.asarray(ja.execute_block(jnp.asarray(x)))
    assert 0.98 < abs(y[-1]) < 1.02
    assert -26.0 < a.get_rssi() < -25.5
    np.testing.assert_allclose(y, jy, atol=1e-10)
    assert abs(a.get_rssi() - ja.get_rssi()) < 1e-9


def test_agc_class_accessors_and_reset():
    a = agc.AGC(device="cpu")
    assert a.get_bandwidth() == 0.1 and a.get_signal_level() == 1.0
    a.set_bandwidth(0.01)
    assert a.get_bandwidth() == 0.01
    a.set_signal_level(10.0)
    assert abs(a.get_signal_level() - 10.0) < 1e-12
    a.set_rssi(-20.0)
    assert abs(a.get_rssi() + 20.0) < 1e-12
    a.set_gain(2.0)
    assert a.get_gain() == 2.0
    a.set_scale(2.0)
    assert a.get_scale() == 2.0
    for bad in (lambda: a.set_bandwidth(2.0), lambda: a.set_gain(0.0),
                lambda: a.set_scale(-1.0), lambda: a.set_signal_level(0.0),
                lambda: agc.AGC(method="fast", device="cpu")):
        with pytest.raises(ValueError):
            bad()
    level = agc.AGC(device="cpu").init(_tone())
    assert 0.04999 < level <= 0.05
    assert level == jagc.AGC().init(_tone())
    a.lock()
    assert a.is_unlocked()          # the reference's quirk
    a.unlock()
    x = _tone(100)
    a.squelch_enable()
    a.execute_block(x)
    assert a.is_squelch_enabled() and a.get_gain() > 1.0
    a.reset()
    assert a.get_gain() == 1.0 and a.squelch_get_mode() == S.ENABLED
    a.squelch_disable()
    assert not a.is_squelch_enabled()
    assert "AGC [Gain=" in repr(a)
    y0 = agc.AGC(device="cpu").execute(0.05 + 0j)
    assert complex(y0) == complex(jagc.AGC().execute(0.05 + 0j))


def test_agc_checkpoint_carry_moves_both_ways():
    """A JAX AGC carry after a squelch walk into the port's class and on;
    the port's carry back into JAX: leaves equal, dtypes kept."""
    x = _c(300, 0.5, 18)
    ja = jagc.AGC()
    ja.squelch_enable()
    ja.squelch_set_threshold(-30.0)
    ja.execute_block(jnp.asarray(x[:150]))
    a = agc.AGC(device="cpu")
    a.squelch_set_threshold(-30.0)
    a.state = {k: torch.from_numpy(np.array(v)) for k, v in ja._st.items()}
    y = a.execute_block(x[150:]).numpy()
    jy = np.asarray(ja.execute_block(jnp.asarray(x[150:])))
    np.testing.assert_allclose(y, jy, atol=1e-12)
    back = {k: jnp.asarray(v.numpy()) for k, v in a.state.items()}
    for k, v in ja._st.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_allclose(np.asarray(back[k]), np.asarray(v),
                                   rtol=1e-12)


# ---------------------------------------------------------- linrec

def test_associative_scan_is_a_prefix():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((5, 37)))
    (got,) = linrec.associative_scan(lambda a, b: (a[0] + b[0],), (x,), dim=1)
    np.testing.assert_allclose(got.numpy(), np.cumsum(x.numpy(), axis=1),
                               atol=1e-12)


def test_affine_scan_matches_jax():
    rng = np.random.default_rng(2)
    As = 0.5 * rng.standard_normal((50, 3, 3))
    vs = rng.standard_normal((50, 3))
    got = linrec.affine_scan(torch.from_numpy(As), torch.from_numpy(vs))
    want = np.asarray(jlinrec.affine_scan(jnp.asarray(As), jnp.asarray(vs)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-10 * np.abs(want).max())
    s, ref = np.zeros(3), []
    for A, v in zip(As, vs):
        s = A @ s + v
        ref.append(s)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-10)


@pytest.mark.parametrize("lams,cplx_u", [
    (np.array([0.9, 0.5, -0.3]), False), (np.array([0.99]), True),
    (np.array([0.9 * np.exp(0.3j), 0.7j]), True)])
@pytest.mark.parametrize("T,chunk", [(1000, 256), (77, 16)])
def test_chunked_first_order_matches_jax(lams, cplx_u, T, chunk):
    rng = np.random.default_rng(3)
    u = rng.standard_normal((2, len(lams), T))
    if cplx_u:
        u = u + 1j * rng.standard_normal(u.shape)
    got = linrec.chunked_first_order(lams, torch.from_numpy(u), chunk)
    want = np.asarray(jlinrec.chunked_first_order(lams, jnp.asarray(u),
                                                  chunk))
    assert got.dtype == torch.from_numpy(want.copy()).dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-10 * np.abs(want).max())
