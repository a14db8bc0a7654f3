"""Port vs JAX package, item 13c's modems on the CPU: ``fm_demod_init``,
``detect.py``'s ``burst_edges`` and ``BurstDetector``, AM (envelope, DC
tracker, SSB), MSK/GMSK (both receivers), FSK, CSS, DSSS, FHSS and CW.

Gates (the JAX tests' where they have one): the DC tracker within 1e-12 of
JAX in float64 (tests/test_models.py's sequential check is 1e-9) and 1e-5
in float32 (an associative scan against the port's one-pole IIR, another
order of sums); the analytic signal 1e-12 (float64); modulated waveforms
within 1e-4 of JAX in complex64 (a float32 phase accumulated by cumsum in
another order) and 1e-12 in float64 where JAX computes in float64; decided
bits, symbols, gates, edges, schedules and texts exactly equal (the
detector's window powers within 1e-5 of the block's largest: a float32
running sum over the block, summed in another order and differenced); the
AM waveform within an ulp (JAX may fuse its product and sum); the GMSK
discriminator loopback error-free (tests/test_gmsk.py:72-84) and the
receivers' decisions on a noisy burst equal to JAX's; the DSSS acquisition
offset equal and its metric within 1e-4 relative; the RAKE gains 1e-4.
``BurstDetector``'s state carries across the packages through ``interop``:
one block in JAX, the state moved, the next block in both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.models import am as jam
from solid_dsp_tpu.models import css as jcss
from solid_dsp_tpu.models import cw as jcw
from solid_dsp_tpu.models import detect as jdet
from solid_dsp_tpu.models import dsss as jdsss
from solid_dsp_tpu.models import fhss as jfhss
from solid_dsp_tpu.models import fm as jfm
from solid_dsp_tpu.models import fsk as jfsk
from solid_dsp_tpu.models import gmsk as jgmsk
from solid_dsp_tpu_torch import interop
from solid_dsp_tpu_torch.models import am, css, cw, detect, dsss, fhss, fm
from solid_dsp_tpu_torch.models import fsk, gmsk

CPU = "cpu"


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_fm_demod_init_matches_jax():
    for dt, jdt in ((torch.complex64, jnp.complex64),
                    (torch.complex128, jnp.complex128)):
        got = fm.fm_demod_init(dt, (3, 2), device=CPU)
        want = np.asarray(jfm.fm_demod_init(jdt, (3, 2)))
        assert got.dtype == dt and got.device.type == "cpu"
        np.testing.assert_array_equal(_np(got), want)


# ------------------------------------------------------------- detect

def _bursty(rng, n, spans, amp=1.0, floor=0.01):
    x = floor * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for a, b in spans:
        x[a:b] += amp * np.exp(2j * np.pi * 0.05 * np.arange(b - a))
    return x.astype(np.complex64)


@pytest.mark.parametrize("prev", [False, True])
def test_burst_edges_match_jax(prev):
    rng = np.random.default_rng(int(prev))
    gate = rng.random(500) < 0.5
    for k in (3, 64, 600):
        r, f = detect.burst_edges(_t(gate), prev, k)
        jr, jf = jdet.burst_edges(jnp.asarray(gate), prev, k)
        assert r.dtype == torch.int32 and r.shape == (k,)
        np.testing.assert_array_equal(_np(r), np.asarray(jr))
        np.testing.assert_array_equal(_np(f), np.asarray(jf))


def test_burst_detector_matches_jax_and_carries_state():
    """Two blocks in JAX; the port runs the first, and also the second from
    JAX's state after the first (interop): gates, energies and edges
    equal; tests/test_detect.py's end-to-end edges."""
    rng = np.random.default_rng(2)
    x = _bursty(rng, 3200, [(500, 800), (2000, 2600)])
    jd = jdet.BurstDetector(window=32, high_db=-10.0)
    pd = detect.BurstDetector(window=32, high_db=-10.0, device=CPU)
    j1 = jd.execute_block(jnp.asarray(x[:1500]))
    p1 = pd.execute_block(x[:1500])
    carried = detect.BurstDetector(window=32, high_db=-10.0, device=CPU)
    carried.state = interop.tensors_from_numpy(
        {"tail": np.asarray(jd._tail), "on": np.asarray(jd._on)}, CPU)
    j2 = jd.execute_block(jnp.asarray(x[1500:]))
    p2 = pd.execute_block(x[1500:])
    c2 = carried.execute_block(x[1500:])
    for jo, po in ((j1, p1), (j2, p2), (j2, c2)):
        np.testing.assert_array_equal(_np(po["gate"]), np.asarray(jo["gate"]))
        np.testing.assert_array_equal(_np(po["rises"]),
                                      np.asarray(jo["rises"]))
        np.testing.assert_array_equal(_np(po["falls"]),
                                      np.asarray(jo["falls"]))
        pw, jpw = 10 ** (_np(po["e_db"]) / 10), 10 ** (np.asarray(
            jo["e_db"]) / 10)
        np.testing.assert_allclose(pw, jpw, atol=1e-5 * jpw.max())
    r = [v for v in _np(p1["rises"]) if v >= 0] + [
        1500 + v for v in _np(p2["rises"]) if v >= 0]
    assert len(r) == 2 and abs(r[0] - 500) <= 64 and abs(r[1] - 2000) <= 64
    assert interop.tensors_to_numpy(pd.state)["on"].dtype == np.bool_
    pd.reset()
    assert not bool(pd.state["on"]) and not pd.state["tail"].any()
    with pytest.raises(ValueError):
        detect.BurstDetector(high_db=-20, low_db=-10, device=CPU)


# ---------------------------------------------------------------- AM

@pytest.mark.parametrize("dt,jdt,tol", [(torch.float64, jnp.float64, 1e-12),
                                        (torch.float32, jnp.float32, 1e-5)])
def test_dc_blocker_and_envelope_match_jax(dt, jdt, tol):
    rng = np.random.default_rng(5)
    x = (1.0 + rng.standard_normal((2, 3000))).astype(np.dtype(str(jdt(0).dtype)))
    st0 = 0.3 * np.ones(2, x.dtype)
    y, s = am.dc_blocker_apply(_t(st0), _t(x), 0.02)
    jy, js = jam.dc_blocker_apply(jnp.asarray(st0), jnp.asarray(x), 0.02)
    assert y.dtype == dt
    np.testing.assert_allclose(_np(y), np.asarray(jy), atol=tol)
    np.testing.assert_allclose(_np(s), np.asarray(js), atol=tol)
    msg = np.sin(2 * np.pi * 0.003 * np.arange(3000)).astype(x.dtype)
    iq = am.am_modulate(_t(msg), 0.8, 1.0)
    jiq = jam.am_modulate(jnp.asarray(msg), 0.8, 1.0)
    assert np.dtype(str(iq.dtype).split(".")[1]) == np.asarray(jiq).dtype
    np.testing.assert_allclose(_np(iq), np.asarray(jiq), rtol=tol * 0.1)
    e, _ = am.am_demodulate_envelope(am.dc_blocker_init(dt, device=CPU), iq,
                                     0.005)
    je, _ = jam.am_demodulate_envelope(jam.dc_blocker_init(jdt), jiq, 0.005)
    np.testing.assert_allclose(_np(e), np.asarray(je), atol=tol)
    np.testing.assert_array_equal(_np(am.am_demodulate_coherent(iq)),
                                  _np(iq).real)
    np.testing.assert_allclose(_np(am.am_demodulate_coherent(iq)),
                               np.asarray(jam.am_demodulate_coherent(jiq)),
                               rtol=tol * 0.1)


@pytest.mark.parametrize("sideband", ["upper", "lower"])
def test_ssb_matches_jax_streaming(sideband):
    rng = np.random.default_rng(6)
    msg = rng.standard_normal(2048)
    taps, tail = am.hilbert_init(127, torch.float64, device=CPU)
    jtaps, jtail = jam.hilbert_init(127, dtype=jnp.float64)
    np.testing.assert_array_equal(taps, np.asarray(jtaps))
    outs, jouts = [], []
    for blk in (msg[:700], msg[700:]):
        a, tail = am.ssb_modulate(taps, tail, _t(blk), sideband)
        ja, jtail = jam.ssb_modulate(jtaps, jtail, jnp.asarray(blk), sideband)
        outs.append(_np(a))
        jouts.append(np.asarray(ja))
    np.testing.assert_allclose(np.concatenate(outs), np.concatenate(jouts),
                               atol=1e-12)
    np.testing.assert_array_equal(_np(am.ssb_demodulate(_t(outs[0]))),
                                  outs[0].real)
    with pytest.raises(ValueError):
        am.ssb_modulate(taps, tail, _t(msg), "both")


# ----------------------------------------------------------- MSK/GMSK

SPS = 8


def test_gmsk_pulses_match_jax():
    for bt in (0.3, 0.5):
        np.testing.assert_array_equal(gmsk.gaussian_pulse_taps(bt, SPS),
                                      jgmsk.gaussian_pulse_taps(bt, SPS))
    np.testing.assert_allclose(gmsk.laurent_pulse(0.3, SPS),
                               jgmsk.laurent_pulse(0.3, SPS), atol=1e-12)
    assert gmsk.gmsk_demod_delay_symbols(SPS) == \
        jgmsk.gmsk_demod_delay_symbols(SPS)


def test_msk_matches_jax_and_loops_back():
    bits = np.random.default_rng(7).integers(0, 2, 200)
    iq, ph = gmsk.msk_modulate(_t(bits), SPS, 0.3)
    jiq, jph = jgmsk.msk_modulate(jnp.asarray(bits), SPS, 0.3)
    np.testing.assert_allclose(_np(iq), np.asarray(jiq), atol=1e-4)
    np.testing.assert_allclose(float(ph), float(jph), atol=1e-4)
    got = gmsk.msk_demod_coherent(iq, SPS, 0.3)
    np.testing.assert_array_equal(_np(got), bits)
    np.testing.assert_array_equal(
        _np(got), np.asarray(jgmsk.msk_demod_coherent(jiq, SPS, 0.3)))


def test_gmsk_streaming_and_receivers_match_jax():
    """Two blocks through the modulator and the discriminator with the
    carries (the port's carried from JAX's after block one), then the
    matched receiver on a noisy burst: the decisions equal JAX's, the
    discriminator's loopback error-free."""
    rng = np.random.default_rng(8)
    bits = rng.integers(0, 2, 300)
    jst = jgmsk.gmsk_mod_init(0.3, SPS)
    st = gmsk.gmsk_mod_init(0.3, SPS, device=CPU)
    iq, jiq = [], []
    for blk in (bits[:128], bits[128:]):
        a, st = gmsk.gmsk_modulate(st, _t(blk), SPS, 0.3)
        ja, jst = jgmsk.gmsk_modulate(jst, jnp.asarray(blk), SPS, 0.3)
        iq.append(_np(a))
        jiq.append(np.asarray(ja))
    iq, jiq = np.concatenate(iq), np.concatenate(jiq)
    np.testing.assert_allclose(iq, jiq, atol=1e-4)
    np.testing.assert_allclose(_np(st[0]), np.asarray(jst[0]), atol=1e-6)
    noisy = (jiq * np.exp(0.7j) + 0.05 * (rng.standard_normal(len(jiq))
                                          + 1j * rng.standard_normal(
                                              len(jiq)))).astype(np.complex64)
    dst = gmsk.gmsk_demod_init(0.3, SPS, device=CPU)
    jdst = jgmsk.gmsk_demod_init(0.3, SPS)
    outs, jouts = [], []
    for blk in (noisy[: 100 * SPS], noisy[100 * SPS:]):
        b, dst = gmsk.gmsk_demod_discriminator(dst, _t(blk), SPS, 0.3)
        jb, jdst = jgmsk.gmsk_demod_discriminator(jdst, jnp.asarray(blk), SPS,
                                                  0.3)
        outs.append(_np(b))
        jouts.append(np.asarray(jb))
    got = np.concatenate(outs)
    np.testing.assert_array_equal(got, np.concatenate(jouts))
    d = gmsk.gmsk_demod_delay_symbols(SPS)
    assert np.sum(got[d:] != bits[: len(got) - d]) == 0
    coherent = noisy * np.complex64(np.exp(-0.7j))
    m = gmsk.gmsk_demod_matched(_t(coherent), SPS, 0.3)
    np.testing.assert_array_equal(
        _np(m), np.asarray(jgmsk.gmsk_demod_matched(jnp.asarray(coherent),
                                                    SPS, 0.3)))
    assert np.mean(_np(m)[:-4] != bits[:-4]) < 0.02


# ---------------------------------------------------------------- FSK

@pytest.mark.parametrize("m_ary", [2, 4])
def test_fsk_matches_jax(m_ary):
    rng = np.random.default_rng(9 + m_ary)
    sym = rng.integers(0, m_ary, 150)
    sps, sep = 16, 0.05
    np.testing.assert_array_equal(fsk.fsk_tones(m_ary, sep),
                                  jfsk.fsk_tones(m_ary, sep))
    iq, ph = fsk.fsk_modulate(_t(sym), sps, m_ary, sep)
    jiq, jph = jfsk.fsk_modulate(jnp.asarray(sym), sps, m_ary, sep)
    np.testing.assert_allclose(_np(iq), np.asarray(jiq), atol=1e-4)
    y = (np.asarray(jiq) + 0.1 * (rng.standard_normal(len(jiq)) + 1j
                                  * rng.standard_normal(len(jiq)))
         ).astype(np.complex64)
    d, _ = fsk.fsk_demod_discriminator(fm.fm_demod_init(device=CPU), _t(y),
                                       sps, m_ary, sep)
    jd, _ = jfsk.fsk_demod_discriminator(jfm.fm_demod_init(), jnp.asarray(y),
                                         sps, m_ary, sep)
    np.testing.assert_array_equal(_np(d), np.asarray(jd))
    mt = fsk.fsk_demod_matched(_t(y), sps, m_ary, sep)
    np.testing.assert_array_equal(
        _np(mt), np.asarray(jfsk.fsk_demod_matched(jnp.asarray(y), sps,
                                                   m_ary, sep)))
    np.testing.assert_array_equal(_np(mt), sym)


# ---------------------------------------------------------------- CSS

@pytest.mark.parametrize("sf", [7, 9])
def test_css_matches_jax(sf):
    rng = np.random.default_rng(sf)
    bits = rng.integers(0, 2, sf * 24)
    np.testing.assert_array_equal(css.css_base_chirp(sf, True),
                                  jcss.css_base_chirp(sf, True))
    modem = css.CSSModem(sf, device=CPU)
    tx = modem.modulate(_t(bits))
    jtx = jcss.CSSModem(sf).modulate(jnp.asarray(bits))
    np.testing.assert_allclose(_np(tx), np.asarray(jtx), atol=1e-4)
    n = len(jtx)
    y = (np.asarray(jtx) * np.exp(1.3j) + 1.5 * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
    ).astype(np.complex64)
    got = modem.demodulate(_t(y))
    np.testing.assert_array_equal(_np(got),
                                  np.asarray(jcss.css_demodulate(y, sf)))
    np.testing.assert_array_equal(_np(modem.demodulate(tx)), bits)
    with pytest.raises(ValueError):
        modem.modulate(_t(bits[:-1]))
    with pytest.raises(ValueError):
        css.css_demodulate(tx[:-1], sf)


# --------------------------------------------------------------- DSSS

def test_dsss_matches_jax():
    from solid_dsp_tpu.utils.sequences import gold_codes

    rng = np.random.default_rng(11)
    code = (2.0 * np.asarray(gold_codes(5)[0]) - 1.0)
    N = len(code)
    syms = ((2 * rng.integers(0, 2, 64) - 1)
            + 1j * (2 * rng.integers(0, 2, 64) - 1)) / np.sqrt(2)
    chips = dsss.dsss_spread(_t(syms), code)
    jchips = jdsss.dsss_spread(jnp.asarray(syms), code)
    np.testing.assert_allclose(_np(chips), np.asarray(jchips), atol=1e-12)
    np.testing.assert_allclose(_np(dsss.dsss_despread(chips, code)), syms,
                               atol=1e-12)
    x = np.concatenate([np.zeros(17), np.asarray(jchips)])
    x = (x + 0.3 * (rng.standard_normal(len(x)) + 1j
                    * rng.standard_normal(len(x)))).astype(np.complex64)
    k, m = dsss.dsss_acquire(_t(x), code, 2 * N)
    jk, jm = jdsss.dsss_acquire(jnp.asarray(x), code, 2 * N)
    assert int(k) == int(jk) == 17
    np.testing.assert_allclose(_np(m), np.asarray(jm), rtol=1e-4)
    # a two-path channel, the RAKE against JAX's
    g0, g1 = 0.9 * np.exp(0.4j), 0.5 * np.exp(-1.1j)
    ch = g0 * np.asarray(jchips) + g1 * np.roll(np.asarray(jchips), 3)
    ch = ch.astype(np.complex64)
    pil = syms[:16]
    g = dsss.rake_finger_gains(_t(ch), code, _t(pil), [0, 3])
    jg = jdsss.rake_finger_gains(jnp.asarray(ch), code, pil, [0, 3])
    np.testing.assert_allclose(_np(g), np.asarray(jg), atol=1e-4)
    r = dsss.rake_despread(_t(ch), code, [0, 3], g)
    jr = jdsss.rake_despread(jnp.asarray(ch), code, [0, 3], jg)
    np.testing.assert_allclose(_np(r), np.asarray(jr), atol=1e-4)


# --------------------------------------------------------------- FHSS

def test_fhss_matches_jax():
    np.testing.assert_array_equal(fhss.hop_schedule(16, 500, 3),
                                  jfhss.hop_schedule(16, 500, 3))
    rng = np.random.default_rng(12)
    x = (rng.standard_normal((2, 64 * 40)) + 1j * rng.standard_normal(
        (2, 64 * 40))).astype(np.complex64)
    hp = fhss.FHSS(16, 64, device=CPU)
    jh = jfhss.FHSS(16, 64)
    y = hp.hop(_t(x))
    jy = jh.hop(jnp.asarray(x))
    np.testing.assert_allclose(_np(y), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(_np(hp.dehop(y)), x, atol=1e-5)
    with pytest.raises(ValueError):
        hp.hop(_t(x[..., :-1]))
    with pytest.raises(ValueError):
        fhss.FHSS(12, device=CPU)


# ----------------------------------------------------------------- CW

def test_cw_matches_jax():
    assert cw.text_to_morse("CQ DX") == jcw.text_to_morse("CQ DX")
    assert cw.MORSE == jcw.MORSE
    x = cw.cw_keyer("PARIS TOM", 24, 0.1, device=CPU)
    jx = np.asarray(jcw.cw_keyer("PARIS TOM", 24, 0.1))
    np.testing.assert_array_equal(_np(x), jx)
    rng = np.random.default_rng(13)
    y = (jx + 0.2 * (rng.standard_normal(len(jx)) + 1j
                     * rng.standard_normal(len(jx)))).astype(np.complex64)
    assert cw.cw_decode(_t(y)) == jcw.cw_decode(jnp.asarray(y)) == \
        "PARIS TOM"
    assert cw.cw_decode(_t(jx), dit_samples=24) == "PARIS TOM"
    q = (0.3 * (rng.standard_normal(4000) + 1j * rng.standard_normal(4000))
         ).astype(np.complex64)
    assert cw.cw_decode(_t(q)) == jcw.cw_decode(jnp.asarray(q)) == ""
    assert cw.cw_decode(torch.zeros(100, dtype=torch.complex64)) == ""
    with pytest.raises(ValueError):
        cw.cw_keyer("E", 3, device=CPU)
