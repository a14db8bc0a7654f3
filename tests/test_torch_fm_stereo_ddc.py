"""The port's FM broadcast back end (models/fm.py: fm_modulate, the stereo
multiplex and decoder, the de-emphasis; the CLI's audio tail) and the DDC
(models/ddc.py) vs the JAX package's, on the CPU.

Tolerances: the multiplex 1e-6 of its max (both packages take its sin in
float32, their libraries a last ulp apart); float64 decode against JAX
1e-9 of max|out| (the same filters, convolutions summed in another
order); float32 1e-5 of it; the
separation (> 40 dB), tone power (0.25 +- 0.01) and pilot (0.1 +- 0.005)
gates of tests/test_models.py:426-471 at 2^15 samples; the de-emphasis
response (0 / -3.01 / -17.1 dB within 0.1 / 0.25 / 0.7); the audio tail
(resample 48000/192000 with flush, then the one-pole de-emphasis) 1e-5 of
max in complex64; DDC at complex128 against JAX 1e-10 (tests/test_ddc.py's
streaming tolerance), the compensator's taps 1e-15.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.models import ddc as jddc
from solid_dsp_tpu.models import fm as jfm
from solid_dsp_tpu.ops import iir as jiir
from solid_dsp_tpu.ops import resample as jrs
from solid_dsp_tpu_torch.interop import tensors_from_numpy, tensors_to_numpy
from solid_dsp_tpu_torch.models import ddc, fm
from solid_dsp_tpu_torch.ops import iir, resample

CPU = "cpu"
FS = 192000.0


def _lr(n, dtype=np.float64):
    k = np.arange(n)
    return (np.sin(2 * np.pi * 1000 / FS * k).astype(dtype),
            np.sin(2 * np.pi * 2500 / FS * k).astype(dtype))


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-6),
                                       (np.float32, 1e-6)])
def test_stereo_mpx_matches_jax(dtype, tol):
    """Both packages take the subcarriers' sin in float32 (on the exact
    wrapped phase), where their libraries differ in the last ulp."""
    L, R = _lr(5000, dtype)
    got = fm.fm_stereo_mpx(torch.from_numpy(L), torch.from_numpy(R), FS)
    want = jfm.fm_stereo_mpx(jnp.asarray(L), jnp.asarray(R), FS)
    assert got.dtype == torch.from_numpy(L).dtype
    _close(got.numpy(), want, tol)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-9),
                                       (np.float32, 1e-5)])
@pytest.mark.parametrize("tau", [0.0, 75e-6])
def test_stereo_decode_matches_jax(dtype, tol, tau):
    L, R = _lr(1 << 14, dtype)
    mpx = np.array(jfm.fm_stereo_mpx(jnp.asarray(L), jnp.asarray(R), FS))
    l, r, p = fm.fm_stereo_decode(torch.from_numpy(mpx), FS,
                                  deemphasis_tau=tau)
    jl, jr, jp = jfm.fm_stereo_decode(jnp.asarray(mpx), FS,
                                      deemphasis_tau=tau)
    _close(l.numpy(), jl, tol)
    _close(r.numpy(), jr, tol)
    assert abs(float(p) - float(jp)) < tol
    assert l.dtype == torch.from_numpy(mpx).dtype


def test_stereo_decode_separation_and_pilot():
    n = np.arange(1 << 15)
    L, R = _lr(len(n))
    mpx = fm.fm_stereo_mpx(torch.from_numpy(L), torch.from_numpy(R), FS)
    l_out, r_out, pilot = fm.fm_stereo_decode(mpx, FS)
    l_out, r_out = l_out.numpy(), r_out.numpy()
    assert abs(float(pilot) - 0.1) < 0.005
    sl = slice(2000, -2000)

    def tone_pow(x, f):
        return np.abs(np.mean(x[sl] * np.exp(-2j * np.pi * f / FS
                                             * n[sl]))) ** 2

    assert abs(tone_pow(l_out, 1000) - 0.25) < 0.01
    assert abs(tone_pow(r_out, 2500) - 0.25) < 0.01
    assert 10 * np.log10(tone_pow(l_out, 1000) / tone_pow(l_out, 2500)) > 40
    assert 10 * np.log10(tone_pow(r_out, 2500) / tone_pow(r_out, 1000)) > 40


def test_deemphasis_response_and_jax():
    tau = 75e-6
    f3 = 1.0 / (2 * np.pi * tau)
    n = np.arange(1 << 14)
    for f, want_db, tol in ((50.0, 0.0, 0.1), (f3, -3.01, 0.25),
                            (15000.0, -17.1, 0.7)):
        x = np.sin(2 * np.pi * f / FS * n)
        y, st = fm.deemphasis_apply(fm.deemphasis_init(torch.float64,
                                                       device=CPU),
                                    torch.from_numpy(x), tau * FS)
        jy, jst = jfm.deemphasis_apply(jfm.deemphasis_init(jnp.float64),
                                       jnp.asarray(x), tau * FS)
        _close(y.numpy(), jy, 1e-10)
        _close(st.numpy(), jst, 1e-10)
        y = y.numpy()[5000:]
        amp = 2 * np.abs(np.mean(y * np.exp(-2j * np.pi * f / FS * n[5000:])))
        assert abs(20 * np.log10(amp) - want_db) < tol, f


def test_fm_modulate_matches_jax_and_demodulates():
    rng = np.random.default_rng(3)
    msg = rng.standard_normal(4000) * 0.1
    iq, ph = fm.fm_modulate(torch.from_numpy(msg), 0.05, 0.3)
    jiq, jph = jfm.fm_modulate(jnp.asarray(msg), 0.05, 0.3)
    _close(iq.numpy(), jiq, 1e-9)
    assert abs(float(ph) - float(jph)) < 1e-9
    y, _ = fm.fm_demodulate(torch.tensor(np.exp(0.3j)), iq, 0.05)
    np.testing.assert_allclose(y.numpy(), msg, atol=1e-9)


def test_cli_audio_tail_matches_jax():
    """The CLI's WAV path (solid_dsp_tpu/__main__.py:150-180) on decoded
    audio: ArbitraryResampler(48000/192000) execute_block + flush, then
    the 75 us one-pole de-emphasis at the audio rate through iir_apply."""
    L, _ = _lr(1 << 14)
    ch = L.astype(np.complex64)
    rate_out = 48000
    r = resample.ArbitraryResampler(rate_out / FS, dtype=torch.complex64,
                                    device=CPU)
    a = torch.cat([r.execute_block(ch), r.flush()])
    jr = jrs.ArbitraryResampler(rate_out / FS, dtype=jnp.complex64)
    ja = np.concatenate([np.asarray(jr.execute_block(jnp.asarray(ch))),
                         np.asarray(jr.flush())])
    assert a.shape[-1] == len(ja)
    _close(a.numpy(), ja, 1e-5)
    alpha = float(np.exp(-1.0 / (75e-6 * rate_out)))
    y, _ = iir.iir_apply(torch.tensor([1.0 - alpha], dtype=torch.complex64),
                         torch.tensor([-alpha], dtype=torch.complex64),
                         iir.iir_init(1, device=CPU), a)
    jy, _ = jiir.iir_apply(jnp.asarray(np.asarray([1.0 - alpha],
                                                  np.complex64)),
                           jnp.asarray(np.asarray([-alpha], np.complex64)),
                           jiir.iir_init(1), jnp.asarray(ja))
    _close(y.numpy(), jy, 1e-5)


@pytest.mark.parametrize("ntaps,R,N,cutoff", [(65, 8, 4, 0.2),
                                              (64, 4, 3, 0.25)])
def test_cic_compensation_matches_jax(ntaps, R, N, cutoff):
    np.testing.assert_allclose(
        ddc.firdes_cic_compensation(ntaps, R, N, cutoff),
        jddc.firdes_cic_compensation(ntaps, R, N, cutoff), rtol=0,
        atol=1e-15)


@pytest.mark.parametrize("kw", [dict(freq=0.7), dict(freq=0.5, fir_decim=4),
                                dict(freq=0.3, cic_rate=4, cic_stages=3,
                                     ratio=1.25),
                                dict(freq=0.7, ratio=48000 / 44100)])
def test_ddc_matches_jax(kw):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(8192) + 1j * rng.standard_normal(8192)
    d = ddc.DDC(dtype=torch.complex128, device=CPU, **kw)
    jd = jddc.DDC(dtype=jnp.complex128, **kw)
    got = np.concatenate([d.execute_block(b).numpy()
                          for b in np.split(x, 2)])
    want = np.concatenate([np.asarray(jd.execute_block(jnp.asarray(b)))
                           for b in np.split(x, 2)])
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, atol=1e-10)
    assert d.decimation == jd.decimation and repr(d) == repr(jd)


def test_ddc_tone_and_state_interop():
    fc, delta, n = 0.7, 0.0015, 1 << 14
    k = np.arange(n)
    x = np.exp(1j * (fc * k + 2 * np.pi * delta * k))
    d = ddc.DDC(freq=fc, dtype=torch.complex128, device=CPU)
    y = d.execute_block(x[: n // 2]).numpy()
    jd = jddc.DDC(freq=fc, dtype=jnp.complex128)
    jd.execute_block(jnp.asarray(x[: n // 2]))
    st = tensors_to_numpy(d.state)
    assert int(st["theta"]) == int(jd._theta)
    e = ddc.DDC(freq=fc, dtype=torch.complex128, device=CPU)
    e.state = tensors_from_numpy({
        "theta": np.asarray(jd._theta),
        "cic": {"tail": np.asarray(jd.cic._tail),
                "phase": np.asarray(jd.cic._phase)},
        "fir_tail": np.asarray(jd._fir_tail),
        "fir_phase": np.asarray(jd._fir_phase)}, CPU)
    y2 = e.execute_block(x[n // 2:]).numpy()
    np.testing.assert_allclose(y2, np.asarray(jd.execute_block(
        jnp.asarray(x[n // 2:]))), atol=1e-10)
    steady = np.concatenate([y, y2])[len(y) // 2:]
    f_meas = np.mean(np.diff(np.unwrap(np.angle(steady)))) / (2 * np.pi)
    assert abs(f_meas - delta * 16) < 1e-4
    d.reset()
    assert int(d.state["theta"]) == 0


def test_entry_points_default_to_the_card():
    for make in (lambda: ddc.DDC(0.5), lambda: fm.deemphasis_init()):
        if torch.cuda.is_available():
            assert make().device.type == "cuda"
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                make()
