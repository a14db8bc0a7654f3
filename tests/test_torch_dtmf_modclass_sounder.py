"""Port vs JAX package on the CPU: the DTMF generator and decoder, the
modulation classifier and the channel sounder.

Every case of tests/test_dtmf.py, test_modclass.py and test_sounder.py runs
through both packages on the same seeded numpy inputs.  Gates: DTMF
waveforms equal and decoded strings equal; the moments within rtol 1e-5
(float32 means summed in another order); the class table within 1e-12;
labels equal (near unit input power, F9) and finite scores within rtol
1e-4 plus 1e-5 absolute (the
infeasible ones inf in both): a score is a normalized residual of O(1)
terms that cancel, so the float32 moments' ~1e-7 relative difference
leaves ~2e-6 on a winning score near 1e-3; the CIR within 1e-5 x
max|cir|, the power-delay profile within 1e-5 x its largest tap's power,
the noise floor within the same (its dB and the SNR within rtol 1e-5
where the floor is real noise), the significance flags equal
wherever a tap's power is not within that tolerance of the threshold;
the validation errors raised by both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.models import dtmf as jdtmf
from solid_dsp_tpu.models import modclass as jmc
from solid_dsp_tpu.models import sounder as jsd
from solid_dsp_tpu.models.channel import tdl_fading_channel, tdl_taps
from solid_dsp_tpu.models.linear_mod import constellation
from solid_dsp_tpu_torch.models import dtmf, modclass, sounder

CPU = "cpu"
MOMENT_RTOL = 1e-5
SCORE_RTOL = 1e-4
SCORE_ATOL = 1e-5
CIR_RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- DTMF

def _both_decode(x, **kw):
    got = dtmf.dtmf_decode(_t(x), **kw)
    want = jdtmf.dtmf_decode(x, **kw)
    assert got == want, (got, want)
    return got


def test_dtmf_generate_matches_jax():
    seq = "123A456B789C*0#D"
    for kw in ({}, {"fs": 16000.0, "tone_ms": 50.0, "gap_ms": 30.0,
                    "amp": 0.3}):
        got = dtmf.dtmf_generate(seq, **kw)
        want = jdtmf.dtmf_generate(seq, **kw)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert dtmf.DTMF_ROWS == jdtmf.DTMF_ROWS
    assert dtmf.DTMF_COLS == jdtmf.DTMF_COLS


def test_all_16_keys_clean_and_noisy():
    rng = np.random.default_rng(0)
    seq = "123A456B789C*0#D"
    x = dtmf.dtmf_generate(seq)
    assert _both_decode(x) == seq
    y = x + 0.05 * rng.standard_normal(len(x)).astype(np.float32)
    assert _both_decode(y) == seq


def test_repeated_digits_need_a_gap():
    assert _both_decode(dtmf.dtmf_generate("55")) == "55"


def test_silence_and_single_tone_rejected():
    rng = np.random.default_rng(1)
    assert _both_decode(0.05 * rng.standard_normal(8000)
                        .astype(np.float32)) == ""
    t = np.arange(4000) / 8000.0
    one = 0.5 * np.sin(2 * np.pi * dtmf.DTMF_ROWS[0] * t).astype(np.float32)
    assert _both_decode(one) == ""


def test_excess_twist_rejected():
    t = np.arange(2000) / 8000.0
    bad = (0.5 * np.sin(2 * np.pi * dtmf.DTMF_ROWS[0] * t)
           + 0.05 * np.sin(2 * np.pi * dtmf.DTMF_COLS[0] * t)
           ).astype(np.float32)
    assert _both_decode(np.concatenate([np.zeros(400, np.float32),
                                        bad])) == ""


@pytest.mark.parametrize("n", [0, 100, 159, 160, 161, 8000 + 77])
def test_dtmf_short_and_ragged_inputs(n):
    """Shorter than a frame gives ""; a tail shorter than a frame is
    dropped, as in JAX."""
    x = dtmf.dtmf_generate("7")
    x = np.concatenate([x, x])[:n]
    _both_decode(x)


@pytest.mark.parametrize("dtype", [np.float64, np.complex64])
def test_dtmf_decode_other_dtypes(dtype):
    rng = np.random.default_rng(3)
    x = dtmf.dtmf_generate("9D*1")
    x = (x + 0.02 * rng.standard_normal(len(x))).astype(dtype)
    assert _both_decode(x) == "9D*1"


def test_dtmf_decode_options():
    rng = np.random.default_rng(4)
    x = dtmf.dtmf_generate("2468", tone_ms=40.0, gap_ms=40.0, fs=16000.0)
    x = x + 0.05 * rng.standard_normal(len(x)).astype(np.float32)
    for kw in ({"fs": 16000.0, "frame_len": 320},
               {"fs": 16000.0, "frame_len": 200, "min_frames": 3},
               {"fs": 16000.0, "threshold": 0.6},
               {"fs": 16000.0, "max_twist_db": 0.01}):
        _both_decode(x, **kw)


def test_validation_dtmf():
    with pytest.raises(ValueError):
        jdtmf.dtmf_generate("1z2")
    with pytest.raises(ValueError):
        dtmf.dtmf_generate("1z2")


# ---------------------------------------------------------- classifier

def _symbols(scheme, m, n, snr_db, seed=0, phase=0.0, scale=1.0):
    rng = np.random.default_rng(seed)
    pts = np.asarray(constellation(scheme, m))
    pts = pts / np.sqrt(np.mean(np.abs(pts) ** 2))
    s = pts[rng.integers(0, m, n)] * np.exp(1j * phase)
    npow = 10 ** (-snr_db / 10)
    s = s + np.sqrt(npow / 2) * (rng.standard_normal(n)
                                 + 1j * rng.standard_normal(n))
    return (scale * s).astype(np.complex64)


def _both_classify(x):
    label, scores = modclass.classify(_t(x))
    jlabel, jscores = jmc.classify(jnp.asarray(x))
    assert label == jlabel, (label, jlabel)
    fin = np.isfinite(jscores)
    np.testing.assert_array_equal(np.isfinite(scores), fin)
    np.testing.assert_allclose(scores[fin], jscores[fin], rtol=SCORE_RTOL,
                               atol=SCORE_ATOL)
    return label


def test_class_moment_table_matches_jax():
    for classes in (modclass.DEFAULT_CLASSES,
                    (("psk", 2), ("qam", 16), ("apsk", 16), ("apsk", 32))):
        np.testing.assert_allclose(
            modclass.class_moment_table(classes),
            jmc.class_moment_table(classes), rtol=0, atol=1e-12)
    assert modclass.DEFAULT_CLASSES == jmc.DEFAULT_CLASSES


def test_class_moment_table_known_values():
    t = modclass.class_moment_table()
    by = dict(zip(modclass.DEFAULT_CLASSES, t))
    np.testing.assert_allclose(by[("psk", 2)], [1, 1, 1, 2], atol=1e-9)
    np.testing.assert_allclose(by[("psk", 4)], [1, 1, 0, 1], atol=1e-9)
    np.testing.assert_allclose(by[("psk", 8)], [1, 1, 0, 0], atol=1e-9)
    np.testing.assert_allclose(by[("qam", 16)][0], 1.32, atol=1e-9)
    np.testing.assert_allclose(by[("qam", 16)][3], 0.68, atol=1e-9)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_signal_moments_match_jax_batched(dtype):
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((3, 5, 4096))
         + 1j * rng.standard_normal((3, 5, 4096))).astype(dtype)
    x[1] *= np.exp(0.7j) * 2.5
    got = modclass.signal_moments(_t(x))
    want = jax.vmap(jax.vmap(jmc.signal_moments))(jnp.asarray(x))
    for g, w in zip(got, want):
        assert g.shape == (3, 5)
        assert g.dtype == (torch.float64 if dtype == np.complex128
                           else torch.float32)
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=MOMENT_RTOL)


def test_classify_moments_equals_classify():
    x = _symbols("qam", 64, 50_000, 20.0, seed=2)
    m = [float(v) for v in modclass.signal_moments(_t(x))]
    a, sa = modclass.classify_moments(m)
    b, sb = modclass.classify(_t(x))
    assert a == b
    np.testing.assert_array_equal(sa, sb)


@pytest.mark.parametrize("scheme,m", [("psk", 2), ("psk", 4), ("psk", 8),
                                      ("qam", 16), ("qam", 64)])
def test_classify_at_15db(scheme, m):
    x = _symbols(scheme, m, 100_000, 15.0, seed=m, phase=0.3)
    assert _both_classify(x) == (scheme, m)


@pytest.mark.parametrize("scheme,m", [("psk", 2), ("psk", 4), ("qam", 16)])
def test_classify_at_10db(scheme, m):
    x = _symbols(scheme, m, 200_000, 10.0, seed=10 + m)
    assert _both_classify(x) == (scheme, m)


def test_rotation_and_scale_invariance():
    x = _symbols("qam", 16, 100_000, 18.0, seed=3, phase=0.41)
    assert _both_classify(x) == _both_classify(37.0 * x) == ("qam", 16)


def test_noise_rejected():
    rng = np.random.default_rng(5)
    z = ((rng.standard_normal(100_000) + 1j * rng.standard_normal(100_000))
         / np.sqrt(2)).astype(np.complex64)
    assert _both_classify(z) == "noise"


def test_qpsk_not_confused_with_qam16_and_vice_versa():
    q = _symbols("psk", 4, 200_000, 12.0, seed=7)
    a = _symbols("qam", 16, 200_000, 12.0, seed=8)
    assert _both_classify(q) == ("psk", 4)
    assert _both_classify(a) == ("qam", 16)


@pytest.mark.parametrize("snr_db", [-5.0, 0.0, 3.0])
def test_classify_low_snr_matches_jax(snr_db):
    """Where the hypotheses thin out (infeasible ones inf), both packages
    take the same branch (at unit power, where F9's rules agree)."""
    for seed, (scheme, m) in enumerate(modclass.DEFAULT_CLASSES):
        x = _symbols(scheme, m, 20_000, snr_db, seed=seed + 40)
        _both_classify(x / np.sqrt(np.mean(np.abs(x) ** 2)))


@pytest.mark.parametrize("gain", [0.01, 0.1, 0.3, 3.0, 30.0, 300.0])
def test_f9_classify_is_scale_invariant(gain):
    """F9: JAX's noise rule compares the fitted S^2 with 0.05 M2, so its
    label changes with the input's scale (a 15 dB 16-QAM burst at gain
    0.1 reads as noise); the port compares S^2 with 0.05 M2^2: the label
    and the scores are those at unit gain."""
    x = _symbols("qam", 16, 100_000, 15.0, seed=16, phase=0.3)
    noise = _symbols("psk", 2, 100_000, -60.0, seed=5)   # noise-dominated
    noise = noise / np.sqrt(np.mean(np.abs(noise) ** 2))
    for burst, want in ((x, ("qam", 16)), (noise, "noise")):
        label, scores = modclass.classify(_t(burst * gain))
        ref_label, ref_scores = modclass.classify(_t(burst))
        assert label == ref_label == want
        np.testing.assert_allclose(scores, ref_scores, rtol=1e-4)
    assert jmc.classify(jnp.asarray(x))[0] == ("qam", 16)
    assert jmc.classify(jnp.asarray(x * 0.1))[0] == "noise"   # JAX's fault


# ---------------------------------------------------------- sounder

def _both_cir(rx, *args, **kw):
    cir, info = sounder.estimate_cir(_t(rx), *args, **kw)
    jcir, jinfo = jsd.estimate_cir(jnp.asarray(rx), *args, **kw)
    jcir = np.asarray(jcir)
    assert isinstance(cir, np.ndarray) and cir.dtype == jcir.dtype
    scale = np.max(np.abs(jcir))
    np.testing.assert_allclose(cir, jcir, rtol=0, atol=CIR_RTOL * scale)
    assert set(info) == set(jinfo)
    # the profile in power: within 1e-5 of its largest tap's
    assert isinstance(info["pdp_db"], np.ndarray)
    p, jp = 10.0 ** (info["pdp_db"] / 10.0), 10.0 ** (jinfo["pdp_db"] / 10.0)
    np.testing.assert_allclose(p, jp, rtol=0, atol=CIR_RTOL * np.max(jp))
    # the noise floor in power within the same; the dB figures compared
    # where the floor is real noise, not the FFT's rounding (a noiseless
    # channel reads ~-160 dB)
    noise = 10.0 ** (info["noise_floor_db"] / 10.0)
    jnoise = 10.0 ** (jinfo["noise_floor_db"] / 10.0)
    assert abs(noise - jnoise) <= CIR_RTOL * np.max(jp)
    for k in ("noise_floor_db", "snr_db"):
        assert isinstance(info[k], float)
        if jnoise > 1e3 * CIR_RTOL * np.max(jp):
            assert abs(info[k] - jinfo[k]) <= CIR_RTOL * abs(jinfo[k]), k
    # significance equal wherever the tap's power is not within that
    # tolerance of the 6 x noise threshold
    thr = 6.0 * 10.0 ** (jinfo["noise_floor_db"] / 10.0)
    clear = np.abs(jp - thr) > CIR_RTOL * np.max(jp)
    assert info["significant"].dtype == bool
    np.testing.assert_array_equal(info["significant"][clear],
                                  jinfo["significant"][clear])
    return cir, info


def test_sound_matches_jax():
    for args in ((255, 7, 64, 4), (63, 5, 0, 1), (255, 7, 150, 1)):
        got = sounder.sound(*args, device=CPU)
        assert got.dtype == torch.complex64 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jsd.sound(*args)))


def test_recovers_known_sparse_channel():
    rng = np.random.default_rng(0)
    tx = sounder.sound(255, 7, 64, repeats=4, device=CPU).numpy()
    np.testing.assert_allclose(np.abs(tx), 1.0, atol=1e-6)
    h = np.zeros(30, np.complex64)
    h[0], h[7], h[22] = 1.0, 0.4 - 0.3j, 0.2j
    rx = np.convolve(tx, h)[: len(tx)]
    rx = rx + 0.05 * (rng.standard_normal(len(rx))
                      + 1j * rng.standard_normal(len(rx)))
    cir, info = _both_cir(rx.astype(np.complex64), 255, 7, 64, repeats=4,
                          max_delay=30)
    assert np.nonzero(info["significant"])[0].tolist() == [0, 7, 22]
    np.testing.assert_allclose(cir[[0, 7, 22]], h[[0, 7, 22]], atol=0.05)
    assert info["snr_db"] > 25.0


def test_coherent_averaging_gain():
    rng = np.random.default_rng(1)
    h = np.zeros(10, np.complex64)
    h[0] = 1.0

    def run(reps):
        tx = sounder.sound(255, 7, 32, repeats=reps, device=CPU).numpy()
        rx = np.convolve(tx, h)[: len(tx)]
        rx = rx + 0.5 * (rng.standard_normal(len(rx))
                         + 1j * rng.standard_normal(len(rx)))
        _, info = _both_cir(rx.astype(np.complex64), 255, 7, 32,
                            repeats=reps, max_delay=10)
        return info["snr_db"]

    assert run(8) > run(1) + 5.0


def test_measures_tdl_profile():
    tx = np.asarray(jsd.sound(255, 7, 64, repeats=4))
    y, _ = tdl_fading_channel(jax.random.PRNGKey(3), jnp.asarray(tx),
                              "epa", 20e6, doppler=1e-5)
    rng = np.random.default_rng(3)
    y = np.asarray(y) + 0.01 * (rng.standard_normal(len(tx))
                                + 1j * rng.standard_normal(len(tx)))
    _, info = _both_cir(y.astype(np.complex64), 255, 7, 64, repeats=4,
                        max_delay=20)
    delays, _ = tdl_taps("epa", 20e6)
    found = set(np.nonzero(info["significant"])[0].tolist())
    assert set(delays[:3].tolist()) <= found
    assert all(d <= delays[-1] + 1 for d in found)


def test_defaults_and_dtype_guards():
    tx = sounder.sound(255, 7, 150, device=CPU).numpy()
    h = np.zeros(5, np.complex64)
    h[0] = 1.0
    rx = np.convolve(tx, h)[: len(tx)].astype(np.complex64)
    cir, info = _both_cir(rx, 255, 7, 150)
    assert len(cir) == 255 // 2
    assert info["significant"][0]
    cir2, _ = _both_cir(rx.real.copy(), 255, 7, 150)
    assert np.iscomplexobj(cir2) and cir2.dtype == np.complex64
    # a 64-bit input stays 64-bit, as jnp.result_type(rx, complex64)
    cir3, _ = _both_cir(rx.astype(np.complex128), 255, 7, 150)
    assert cir3.dtype == np.complex128
    cir4, _ = _both_cir(rx.real.astype(np.float64), 255, 7, 150)
    assert cir4.dtype == np.complex128


@pytest.mark.parametrize("call", [
    lambda m: m.sound(256),
    lambda m: m.sound(255, cp=255),
    lambda m: m.sound(255, cp=-1),
    lambda m: m.estimate_cir(np.zeros(10, np.complex64), 255, 7, 64),
    lambda m: m.estimate_cir(np.zeros(1000, np.complex64), 255, 7, 64,
                             max_delay=200),
    lambda m: m.estimate_cir(np.zeros(1000, np.complex64), 255, 7, 64,
                             repeats=0),
])
def test_validation_sounder(call):
    with pytest.raises(ValueError) as want:
        call(jsd)
    with pytest.raises(ValueError) as got:
        call(sounder)
    assert str(got.value) == str(want.value)


def test_public_names_of_the_last_modules():
    """Every public name of the eight JAX modules this slice ports is in
    its counterpart, and ``models`` imports the five new models as JAX's
    ``models/__init__.py`` does."""
    import importlib

    import solid_dsp_tpu_torch.models as tm

    for path in ("models.dtmf", "models.modclass", "models.sounder",
                 "models.pocsag", "models.rds", "utils.metrics",
                 "utils.profiling", "parallel.fault"):
        jmod = importlib.import_module(f"solid_dsp_tpu.{path}")
        tmod = importlib.import_module(f"solid_dsp_tpu_torch.{path}")
        for name in jmod.__all__:
            if path == "utils.profiling" and name == "CHIP_PEAKS":
                assert "tpu-v5e" not in tmod.CHIP_PEAKS   # the divergence
                continue
            assert hasattr(tmod, name), (path, name)
    for name in ("dtmf", "modclass", "pocsag", "rds", "sounder"):
        assert getattr(tm, name).__name__ == \
            f"solid_dsp_tpu_torch.models.{name}"
