"""Port vs JAX package: CVSD (S8's plain version) and symbol timing
(Oerder-Meyr, the block synchroniser, the Gardner loop with S9's plain
version), on the CPU; S8's and S9's arithmetic emulated in numpy against
the plain versions; F8.

Gates: CVSD bits equal to JAX's and the decoded trajectory within
tests/test_cvsd.py:47's 1e-5, in-band SNR > 20 dB at 4x oversampling
(:59), a bit error healed (:71-72); S8's steps (numpy float32: the encoder's two-branch step
with the 32-bit history word, the decoder's walk inside a chunk) bit-equal
to the plain walk.
Timing: the Oerder-Meyr estimate within 1e-4 samples of JAX's and the
fractional-delay taps within 1e-6; ``symbol_sync_block``'s symbols within
1e-4 and tests/test_timing.py's SER < 0.01; ``gardner_scan`` against JAX
at k sps <= 2^14, where JAX's float32 strobe positions still keep 10
fractional bits (F8): symbols within 5e-3 and mu within 5e-3 (JAX's
position rounding, up to 2^-10 samples, against the port's split),
with tests/test_timing.py:95's SER < 0.02 after acquisition on both; S9's
order emulated in numpy float32 bit-equal to the plain walk, at even and
odd sps.  F8 at k sps from 2^20 to 2^25: the port's strobe and midpoint
split equal the float64 position's whole part exactly and its fraction to
one float32 rounding, where JAX's float32 position loses up to 2^-4 of a
sample at 2^20 and all of it at 2^24.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps_sig
import torch

from solid_dsp_tpu.models import cvsd as jcvsd
from solid_dsp_tpu.models import timing as jtiming
from solid_dsp_tpu_torch.design.firdes import firdes_rrcos
from solid_dsp_tpu_torch.models import cvsd, timing
from solid_dsp_tpu_torch.ops import cuda_cvsd, cuda_timing

CPU = "cpu"
GRAY = np.array([1 + 1j, -1 + 1j, 1 - 1j, -1 - 1j]) / np.sqrt(2.0)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _voice(fs=32000, n=16000):
    t = np.arange(n) / fs
    return (0.5 * np.sin(2 * np.pi * 300 * t)
            + 0.25 * np.sin(2 * np.pi * 800 * t)).astype(np.float32)


# ---------------------------------------------------------------- CVSD

def test_cvsd_matches_jax():
    x = _voice(n=2000)
    bits = cvsd.cvsd_encode(torch.from_numpy(x))
    jbits = np.asarray(jcvsd.cvsd_encode(x))
    assert bits.dtype == torch.int32
    np.testing.assert_array_equal(_np(bits), jbits)
    y = cvsd.cvsd_decode(torch.from_numpy(jbits))
    assert y.dtype == torch.float32
    np.testing.assert_allclose(_np(y), np.asarray(jcvsd.cvsd_decode(jbits)),
                               atol=1e-5)
    # batched, float64 (JAX's 64-bit walk), other histories and parameters
    xb = np.stack([x[:600], 0.3 * x[:600]]).astype(np.float64)
    for kw in ({}, {"n_history": 1}, {"n_history": 5, "beta": 0.8,
                                       "gamma": 0.02, "leak": 0.95}):
        b = cvsd.CVSD(device=CPU, **kw).encode(torch.from_numpy(xb))
        jb = np.asarray(jcvsd.CVSD(**kw).encode(xb))
        np.testing.assert_array_equal(_np(b), jb)
        np.testing.assert_allclose(
            _np(cvsd.CVSD(device=CPU, **kw).decode(b)),
            np.asarray(jcvsd.CVSD(**kw).decode(jb)), atol=1e-5)


def test_cvsd_quality_and_error_healing():
    fs = 32000
    x = _voice(fs)
    c = cvsd.CVSD(device=CPU)
    bits = c.encode(torch.from_numpy(x))
    y = _np(c.decode(bits))
    lp = sps_sig.firwin(201, 1200, fs=fs)
    xf = sps_sig.lfilter(lp, 1, x)[500:]
    yf = sps_sig.lfilter(lp, 1, y)[500:]
    assert 10 * np.log10(np.mean(xf ** 2) / np.mean((yf - xf) ** 2)) > 20.0
    bad = _np(bits[:8000]).copy()
    bad[1000] ^= 1
    d = np.abs(_np(c.decode(torch.from_numpy(bad))) - y[:8000])
    assert d[1000:1100].max() > 1e-3 and d[3000:].max() < 1e-6


def _s8_emulated(v, decode, beta=0.9, gamma=0.01, dmin=0.001, dmax=0.2,
                 n_history=3, leak=0.98, all_clamps=False):
    """S8's steps (csrc/cvsd_scan.cu) in numpy float32 scalars, each product
    and sum rounded once, the clamps as fmaxf then fminf.  Encode: the
    two-branch step, both outcomes of the bit from the old state (the
    history word under its mask, agreeing when all ones or all zeros), the
    clamps that cannot bind dropped (``all_clamps``: kept, the encoder's
    instantiation for any parameters), the compare only selecting.
    Decode: the walk a chunk makes from its start, the history the raw
    words."""
    f = np.float32
    be, ga, lo, hi, lk = f(beta), f(gamma), f(dmin), f(dmax), f(leak)
    mask = (1 << n_history) - 1
    out = np.empty(v.shape, np.float32 if decode else np.int32)
    for i, lane in enumerate(v):
        ref, step, hist = f(0), f(dmin), 0
        words = [0] * n_history
        for j, s in enumerate(lane):
            if decode:
                words = words[1:] + [int(s)]
                boost = ga if len(set(words)) == 1 else f(0)
                step = min(max(f(be * step) + boost, lo), hi)
                ref = min(max(f(lk * ref) + (step if s == 1 else -step),
                              f(-1)), f(1))
                out[i, j] = ref
                continue
            h1, h0 = ((hist << 1) | 1) & mask, (hist << 1) & mask
            bs = f(be * step)
            boosted = min(max(f(bs + ga), lo), hi)
            plain = min(max(f(bs + f(0)), lo), hi) if all_clamps else max(
                bs, lo)
            s1 = boosted if h1 == mask else plain
            s0 = boosted if h0 == 0 else plain
            lr = f(lk * ref)
            r1, r0 = min(f(lr + s1), f(1)), max(f(lr - s0), f(-1))
            if all_clamps:
                r1, r0 = max(r1, f(-1)), min(r0, f(1))
            bit = f(s) >= ref
            ref, step, hist = (r1, s1, h1) if bit else (r0, s0, h0)
            out[i, j] = int(bit)
    return out


@pytest.mark.parametrize("n_history", [1, 3, 32])
def test_s8_order_emulated_matches_plain(n_history):
    rng = np.random.default_rng(n_history)
    x = np.stack([_voice(n=700), rng.uniform(-1, 1, 700).astype(np.float32),
                  0.01 * rng.standard_normal(700).astype(np.float32)])
    b = cvsd.cvsd_encode(torch.from_numpy(x), n_history=n_history)
    np.testing.assert_array_equal(_s8_emulated(x, False, n_history=n_history),
                                  _np(b))
    y = cvsd.cvsd_decode(b, n_history=n_history)
    np.testing.assert_array_equal(
        _s8_emulated(_np(b), True, n_history=n_history), _np(y))


def test_cvsd_limits_and_validation():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="history"):
        cuda_cvsd.check_limits(x, False, 33)
    with pytest.raises(ValueError, match="float32"):
        cuda_cvsd.check_limits(x.double(), False, 3)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_cvsd.cvsd_cuda(x, False, 0.9, 0.01, 0.001, 0.2, 3, 0.98)
    with pytest.raises(ValueError, match="CUDA"):
        cvsd.cvsd_encode(x, engine="cuda")
    assert cvsd.cvsd_encode(x, n_history=40).shape == (2, 8)   # plain: any
    for kw in ({"beta": 1.0}, {"gamma": 0.0}, {"delta_min": 0.5,
                                                "delta_max": 0.1},
               {"leak": 0.0}, {"n_history": 0}):
        with pytest.raises(ValueError):
            cvsd.CVSD(device=CPU, **kw)
    with pytest.raises(ValueError):
        cvsd.cvsd_decode(torch.zeros(8, dtype=torch.int32), n_history=-1)
    assert cvsd.cvsd_encode(torch.zeros(3, 0)).shape == (3, 0)


# -------------------------------------------------------------- timing

def _tx_rx(n_sym, sps, tau, seed, rolloff=0.35, delay=6):
    """QPSK -> RRC -> fractional delay -> RRC matched filter (numpy)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 4, n_sym)
    rrc = firdes_rrcos(sps, delay, rolloff)
    up = np.zeros(n_sym * sps, complex)
    up[::sps] = GRAY[idx]
    tx = np.convolve(up, rrc)[: len(up)]
    if tau:
        h = _np(timing.fractional_delay_taps(torch.tensor(float(tau)), 33))
        tx = np.convolve(tx, h)[16: 16 + len(tx)]
    return idx, np.convolve(tx, rrc)[: len(up)].astype(np.complex64)


def _best_ser(tx_idx, y, max_lag=20, margin=10):
    got = (y.real < 0).astype(int) + 2 * (y.imag < 0)
    best = 1.0
    for lag in range(max_lag):
        for a, c in ((tx_idx[lag:], got), (tx_idx, got[lag:])):
            n = min(len(a), len(c)) - margin
            if n > 0:
                best = min(best, float(np.mean(a[:n] != c[:n])))
    return best


@pytest.mark.parametrize("tau", [0.0, 0.3, -0.35])
def test_oerder_meyr_and_symbol_sync_match_jax(tau):
    sps = 4
    idx, rx = _tx_rx(2000, sps, tau, seed=0)
    est = timing.oerder_meyr_offset(torch.from_numpy(rx), sps)
    jest = jtiming.oerder_meyr_offset(jnp.asarray(rx), sps)
    assert abs(float(est) - float(jest)) < 1e-4
    h = timing.fractional_delay_taps(torch.tensor(0.3), 17)
    np.testing.assert_allclose(
        _np(h), np.asarray(jtiming.fractional_delay_taps(jnp.asarray(0.3),
                                                         17)), atol=1e-6)
    syms, t_hat = timing.symbol_sync_block(torch.from_numpy(rx), sps)
    jsyms, _ = jtiming.symbol_sync_block(jnp.asarray(rx), sps)
    assert syms.shape == jsyms.shape
    np.testing.assert_allclose(_np(syms), np.asarray(jsyms), atol=1e-4)
    assert _best_ser(idx, _np(syms)) < 0.01
    with pytest.raises(ValueError):
        timing.fractional_delay_taps(torch.tensor(0.1), 16)


@pytest.mark.parametrize("sps", [4, 5])
def test_gardner_matches_jax_where_float32_positions_are_fine_f8(sps):
    """F8 parity: at k sps <= 2^14 JAX's float32 strobe keeps 10 or more
    fractional bits, so the port's exact split and JAX's rounded position
    give the same loop to 5e-3; both lock (SER < 0.02 after 200 symbols)."""
    n_sym = (1 << 14) // sps - 40
    idx, rx = _tx_rx(n_sym, sps, 0.25, seed=3)
    syms, mu = timing.gardner_scan(torch.from_numpy(rx), sps, bandwidth=0.05)
    jsyms, jmu = jtiming.gardner_scan(jnp.asarray(rx), sps, bandwidth=0.05)
    assert syms.shape == jsyms.shape and syms.dtype == torch.complex64
    assert int(np.floor(len(rx) - 4) // sps) - 1 == len(syms)
    np.testing.assert_allclose(_np(syms), np.asarray(jsyms), atol=5e-3)
    assert abs(float(mu) - float(jmu)) < 5e-3
    assert _best_ser(idx[200:], _np(syms)[200:]) < 0.02
    assert _best_ser(idx[200:], np.asarray(jsyms)[200:]) < 0.02


def _s9_emulated(x, sps, bandwidth, mu0=0.0):
    """S9's walk (csrc/gardner_scan.cu) in numpy float32 scalars: 32-bit
    whole parts, the clip, Horner on each rail, each product and sum
    rounded once."""
    f = np.float32
    alpha, beta = f(bandwidth), f(bandwidth * bandwidth / 4.0)
    n = len(x)
    xr, xi = x.real.astype(np.float32), x.imag.astype(np.float32)
    n_sym = (n - 4) // sps - 1
    half = sps // 2

    def farrow(r, b, t):
        a0, a1, a2, a3 = r[b], r[b + 1], r[b + 2], r[b + 3]
        c1 = f(0.5) * (a2 - a0)
        c2 = ((a0 - f(2.5) * a1) + f(2.0) * a2) - f(0.5) * a3
        c3 = f(0.5) * (a3 - a0) + f(1.5) * (a1 - a2)
        return ((c3 * t + c2) * t + c1) * t + a1

    def clip(i):
        return min(max(i, 1), n - 3) - 1

    mu, rate, pr, pi = f(mu0), f(0), f(0), f(0)
    out = np.empty(max(n_sym, 0), np.complex64)
    for k in range(1, n_sym + 1):
        fl = np.floor(mu)
        frac = mu - fl
        ip = k * sps + int(fl)
        if sps % 2:
            m2 = mu - f(0.5)
            fl2 = np.floor(m2)
            mfrac, mip = m2 - fl2, k * sps - half + int(fl2)
        else:
            mfrac, mip = frac, ip - half
        b, mb = clip(ip), clip(mip)
        sr, si = farrow(xr, b, frac), farrow(xi, b, frac)
        mr, mi = farrow(xr, mb, mfrac), farrow(xi, mb, mfrac)
        e = mr * (pr - sr) + mi * (pi - si)
        rate = rate + beta * e
        mu = (mu + alpha * e) + rate
        pr, pi = sr, si
        out[k - 1] = sr + 1j * si
    return out, mu


@pytest.mark.parametrize("sps,mu0", [(8, 0.0), (3, 0.7), (1, -0.2)])
def test_s9_order_emulated_matches_plain(sps, mu0):
    _, rx = _tx_rx(600, max(sps, 2), 0.4, seed=sps)
    rx = rx[: 600 * sps]
    syms, mu = timing.gardner_scan(torch.from_numpy(rx), sps, 0.02, mu0)
    want, wmu = _s9_emulated(rx, sps, 0.02, mu0)
    np.testing.assert_array_equal(_np(syms), want)
    assert float(mu) == float(wmu)


@pytest.mark.parametrize("sps", [8, 5])
def test_f8_strobe_split_exact_beyond_2e20(sps):
    """F8 repaired: at k sps from 2^20 to 2^25 the port's strobe (and
    midpoint) whole part equals the float64 position's and its fraction
    is within a float32 rounding, where
    JAX's float32 ``k * sps + mu`` keeps 3 fractional bits at 2^20 and
    none at 2^24."""
    rng = np.random.default_rng(sps)
    k = rng.integers((1 << 20) // sps, (1 << 25) // sps, 4096)
    mu = rng.uniform(-1.5, 2.5, 4096).astype(np.float32)
    n = 1 << 26
    base, frac, mbase, mfrac = timing.strobe_split(
        torch.from_numpy(k), sps, torch.from_numpy(mu), n)
    pos = k * sps + mu.astype(np.float64)
    np.testing.assert_array_equal(_np(base), np.floor(pos) - 1)
    # the fraction in float32: one rounding (of mu - floor(mu), mu < 0)
    assert np.max(np.abs(_np(frac) - (pos - np.floor(pos)))) <= 2.0 ** -24
    mpos = pos - sps / 2.0
    np.testing.assert_array_equal(_np(mbase), np.floor(mpos) - 1)
    assert np.max(np.abs(_np(mfrac) - (mpos - np.floor(mpos)))) <= 2.0 ** -24
    # the reference's float32 position: its fraction is coarse
    jpos = (k * sps).astype(np.float32) + mu
    jfrac = (jpos - np.floor(jpos)).astype(np.float64)
    lost = np.abs(jfrac - (pos - np.floor(pos)))
    assert lost[k * sps >= (1 << 24)].max() > 0.2
    assert lost.max() > 2.0 ** -5


def test_gardner_limits():
    x = torch.zeros(400, dtype=torch.complex64)
    with pytest.raises(ValueError, match="complex64"):
        cuda_timing.check_limits(x.to(torch.complex128), 4)
    with pytest.raises(ValueError, match="sps"):
        cuda_timing.check_limits(x, 65)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_timing.gardner_cuda(x, 4, 0.01, 2.5e-5, 0.0, 10)
    with pytest.raises(ValueError, match="CUDA"):
        timing.gardner_scan(x, 4, engine="cuda")
    s, mu = timing.gardner_scan(torch.zeros(6, dtype=torch.complex64), 4)
    assert s.shape == (0,) and float(mu) == 0.0
    s, _ = timing.gardner_scan(x.to(torch.complex128), 80)     # plain: any
    assert s.shape == ((400 - 4) // 80 - 1,)
