"""IIR filter design: bilinear transform machinery, stability, PLL loop filters.

Port of ``solid_dsp_tpu/design/iirdes.py`` (host numpy float64, the same
arithmetic in the same order, so the sections equal the JAX package's).
Parity: reference ``src/filter/iirdes/mod.rs`` — frequency_pre_warp (:63-81),
bilinear_analog_to_digital (:109-137), bilinear_numerator_denominator
(:164-212), digital_filter_flip_pass (:235-250), digital_filter_shift
(:274-301), stable (:328-348); and ``src/filter/iirdes/pll/mod.rs`` —
active_lag (:24-52), active_proportional_integral (:71-99).

Design-time NumPy float64; outputs feed ``solid_dsp_tpu_torch.ops.iir``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import polymath

__all__ = [
    "BandType",
    "ZerosAndPoles",
    "frequency_pre_warp",
    "bilinear_analog_to_digital",
    "bilinear_numerator_denominator",
    "digital_filter_flip_pass",
    "digital_filter_shift",
    "stable",
    "pll_active_lag",
    "pll_active_proportional_integral",
    "butterworth_zpk",
    "elliptic_zpk",
    "chebyshev1_zpk",
    "chebyshev2_zpk",
    "zpk_to_sos",
    "iirdes_sos",
    "sos_to_iir_coeffs",
]


class BandType:
    LOWPASS = "lowpass"
    HIGHPASS = "highpass"
    BANDPASS = "bandpass"
    BANDSTOP = "bandstop"


@dataclass
class ZerosAndPoles:
    zeros: np.ndarray
    poles: np.ndarray


def frequency_pre_warp(cutoff: float, center_frequency: float, bandtype: str) -> float:
    """Bilinear pre-warp factor.  Parity: ref iirdes/mod.rs:63-81."""
    if bandtype == BandType.LOWPASS:
        return abs(np.tan(np.pi * cutoff))
    if bandtype == BandType.HIGHPASS:
        base = np.pi * cutoff
        return abs(-np.cos(base) / np.sin(base))
    if bandtype == BandType.BANDPASS:
        base = 2.0 * np.pi * cutoff
        center = 2.0 * np.pi * center_frequency
        return abs((np.cos(base) - np.cos(center)) / np.sin(base))
    if bandtype == BandType.BANDSTOP:
        base = 2.0 * np.pi * cutoff
        center = 2.0 * np.pi * center_frequency
        return abs(np.sin(base) / (np.cos(base) - np.cos(center)))
    raise ValueError(f"unknown band type {bandtype!r}")


def bilinear_analog_to_digital(analog_zeros, analog_poles, nominal_gain, pre_warp):
    """Bilinear z-transform in pole-zero form.

    Parity: ref iirdes/mod.rs:109-137 — zeros beyond the analog zero list map
    to z=-1; gain accumulates (1-p)/(1-z) per pole.
    Returns (digital_zeros, digital_poles, digital_gain).
    """
    analog_zeros = np.asarray(analog_zeros, dtype=np.complex128)
    analog_poles = np.asarray(analog_poles, dtype=np.complex128)
    digital_zeros = []
    digital_poles = []
    digital_gain = complex(nominal_gain)
    for i, pole in enumerate(analog_poles):
        if i < analog_zeros.size:
            zm = analog_zeros[i] * pre_warp
            z = (1.0 + zm) / (1.0 - zm)
        else:
            z = complex(-1.0, 0.0)
        digital_zeros.append(z)
        pm = pole * pre_warp
        p = (1.0 + pm) / (1.0 - pm)
        digital_poles.append(p)
        digital_gain *= (1.0 - p) / (1.0 - z)
    return (
        np.array(digital_zeros, dtype=np.complex128),
        np.array(digital_poles, dtype=np.complex128),
        digital_gain,
    )


def bilinear_numerator_denominator(numerators, denominators, warp) -> ZerosAndPoles:
    """Bilinear z-transform from transfer-function coefficients.

    Parity: ref iirdes/mod.rs:164-212 — including the reference's in-place
    overwrite semantics (each order-k term *overwrites* rather than
    accumulates, so only the highest-order analog coefficient and the final
    warp power survive; reproduced for parity with the reference doctest).
    """
    numerators = np.asarray(numerators, dtype=np.complex128)
    denominators = np.asarray(denominators, dtype=np.complex128)
    if numerators.size == 0 or denominators.size == 0:
        raise ValueError("invalid order")
    numerator_order = numerators.size - 1
    denominator_order = denominators.size - 1
    if numerator_order > denominator_order:
        raise ValueError("numerator order exceeds denominator order")

    num_out = np.zeros(numerator_order, dtype=np.complex128)
    den_out = np.zeros(denominator_order, dtype=np.complex128)

    poly_1pz = polymath.expand_binomial_pm(denominator_order, denominator_order - 1)

    mk = 1.0
    for d in denominators[:denominator_order]:
        for j in range(denominator_order):
            den_out[j] = d * mk * poly_1pz[j]
        mk *= warp

    mk = 1.0
    for nmr in numerators[:numerator_order]:
        for j in range(numerator_order):
            num_out[j] = nmr * mk * poly_1pz[j]
        mk *= warp

    inv_d0 = 1.0 / den_out[0]
    den_out *= inv_d0
    num_out[:denominator_order] *= inv_d0
    return ZerosAndPoles(zeros=num_out, poles=den_out)


def digital_filter_flip_pass(zeros, poles) -> ZerosAndPoles:
    """LP<->HP flip (negate all zeros/poles).  Parity: ref iirdes/mod.rs:235-250."""
    zeros = np.asarray(zeros, dtype=np.complex128)
    poles = np.asarray(poles, dtype=np.complex128)
    if zeros.size != poles.size:
        raise ValueError("invalid order")
    return ZerosAndPoles(zeros=-zeros, poles=-poles)


def digital_filter_shift(zeros, poles, shift: float) -> ZerosAndPoles:
    """Low-pass to band-pass frequency shift (doubles the order).

    Parity: ref iirdes/mod.rs:274-301.
    """
    zeros = np.asarray(zeros, dtype=np.complex128)
    poles = np.asarray(poles, dtype=np.complex128)
    if zeros.size != poles.size:
        raise ValueError("invalid order")
    c = np.cos(2.0 * np.pi * shift)
    out_z = np.zeros(zeros.size * 2, dtype=np.complex128)
    out_p = np.zeros(poles.size * 2, dtype=np.complex128)
    for i in range(zeros.size):
        t = zeros[i] + 1.0
        s = np.sqrt(c * c * t * t - 4.0 * zeros[i])
        out_z[2 * i] = 0.5 * (c * t + s)
        out_z[2 * i + 1] = 0.5 * (c * t - s)
        t = poles[i] + 1.0
        s = np.sqrt(c * c * t * t - 4.0 * poles[i])
        out_p[2 * i] = 0.5 * (c * t + s)
        out_p[2 * i + 1] = 0.5 * (c * t - s)
    return ZerosAndPoles(zeros=out_z, poles=out_p)


def stable(feed_forward, feed_back) -> bool:
    """True iff every root of the reversed feed-back polynomial has |z| <= 1.

    Parity: ref iirdes/mod.rs:328-348 (roots via Bairstow on reversed a).
    """
    feed_back = np.asarray(feed_back, dtype=np.float64)
    if feed_back.size < 2:
        return False
    a_hat = feed_back[::-1]
    roots = polymath.find_roots(a_hat)
    return bool(np.all(np.abs(roots) <= 1.0))


def _pll_common(bandwidth: float, damping_factor: float, loop_gain: float):
    if bandwidth <= 0.0:
        raise ValueError("invalid bandwidth")
    if damping_factor <= 0.0:
        raise ValueError("invalid damping factor")
    if loop_gain <= 0.0:
        raise ValueError("invalid loop gain")
    t1 = loop_gain / (bandwidth * bandwidth)
    t2 = 2.0 * damping_factor / bandwidth - 1.0 / loop_gain
    num = np.array(
        [
            2.0 * loop_gain * (1.0 + t2 / 2.0),
            2.0 * loop_gain * 2.0,
            2.0 * loop_gain * (1.0 - t2 / 2.0),
        ]
    )
    return t1, num


def pll_active_lag(bandwidth: float, damping_factor: float, loop_gain: float):
    """2nd-order PLL active-lag loop filter (num, den).

    Parity: ref iirdes/pll/mod.rs:24-52.
    """
    t1, num = _pll_common(bandwidth, damping_factor, loop_gain)
    den = np.array([1.0 + t1 / 2.0, -t1, -1.0 + t1 / 2.0])
    return num, den


def pll_active_proportional_integral(
    bandwidth: float, damping_factor: float, loop_gain: float
):
    """2nd-order PLL active-PI loop filter (num, den).

    Parity: ref iirdes/pll/mod.rs:71-99.
    """
    t1, num = _pll_common(bandwidth, damping_factor, loop_gain)
    den = np.array([t1 / 2.0, -t1, t1 / 2.0])
    return num, den


# --------------------------------------------------------------------------
# Complete analog-prototype designers (beyond the reference)
# --------------------------------------------------------------------------
# The reference ships only the bilinear MACHINERY (mod.rs:109-212) and PLL
# loop filters — it has no Butterworth/Chebyshev designers at all, and its
# per-pole DC-gain normalization (bilinear_analog_to_digital above) cannot
# express band-pass filters (the DC zero makes the (1-z) factor vanish).
# These designers use the standard zpk pipeline instead: normalized analog
# prototype -> lp2{lp,hp,bp,bs} frequency transform (pre-warped) ->
# bilinear -> second-order sections.


def butterworth_zpk(order: int):
    """Analog Butterworth prototype (zeros, poles, gain), cutoff 1 rad/s."""
    if order < 1:
        raise ValueError("order must be >= 1")
    k = np.arange(order)
    poles = np.exp(1j * np.pi * (2 * k + order + 1) / (2 * order))
    return np.zeros(0, np.complex128), poles.astype(np.complex128), 1.0


def chebyshev1_zpk(order: int, ripple_db: float = 1.0):
    """Analog Chebyshev type-I prototype: equiripple passband."""
    if order < 1:
        raise ValueError("order must be >= 1")
    if ripple_db <= 0:
        raise ValueError("ripple_db must be positive")
    eps = np.sqrt(10.0 ** (ripple_db / 10.0) - 1.0)
    mu = np.arcsinh(1.0 / eps) / order
    k = np.arange(order)
    theta = np.pi * (2 * k + 1) / (2 * order)
    poles = -np.sinh(mu) * np.sin(theta) + 1j * np.cosh(mu) * np.cos(theta)
    gain = np.real(np.prod(-poles))
    if order % 2 == 0:
        gain /= np.sqrt(1.0 + eps * eps)
    return np.zeros(0, np.complex128), poles.astype(np.complex128), float(gain)


def chebyshev2_zpk(order: int, stopband_db: float = 40.0):
    """Analog Chebyshev type-II (inverse) prototype: equiripple stopband."""
    if order < 1:
        raise ValueError("order must be >= 1")
    if stopband_db <= 0:
        raise ValueError("stopband_db must be positive")
    eps = 1.0 / np.sqrt(10.0 ** (stopband_db / 10.0) - 1.0)
    mu = np.arcsinh(1.0 / eps) / order
    k = np.arange(order)
    theta = np.pi * (2 * k + 1) / (2 * order)
    lp_poles = -np.sinh(mu) * np.sin(theta) + 1j * np.cosh(mu) * np.cos(theta)
    poles = 1.0 / lp_poles
    # zeros on the imaginary axis at the stopband ripple frequencies
    m = k[np.abs(np.cos(theta)) > 1e-12]
    zeros = 1j / np.cos(np.pi * (2 * m + 1) / (2 * order))
    gain = np.real(np.prod(-poles) / np.prod(-zeros))
    return zeros.astype(np.complex128), poles.astype(np.complex128), float(gain)


def _lp2lp_zpk(z, p, k, wo):
    degree = p.size - z.size
    return z * wo, p * wo, k * wo ** degree


def _lp2hp_zpk(z, p, k, wo):
    degree = p.size - z.size
    zh = np.append(wo / z if z.size else np.zeros(0, np.complex128),
                   np.zeros(degree, np.complex128))
    ph = wo / p
    kh = k * np.real(np.prod(-z) / np.prod(-p))
    return zh, ph, kh


def _quad_split(r, wo):
    """Each root r -> the pair r ± sqrt(r² − wo²) (band transform split)."""
    s = np.sqrt(r * r - wo * wo + 0j)
    return np.concatenate([r + s, r - s])


def _lp2bp_zpk(z, p, k, wo, bw):
    degree = p.size - z.size
    zb = _quad_split(z * 0.5 * bw, wo) if z.size else np.zeros(
        0, np.complex128)
    zb = np.append(zb, np.zeros(degree, np.complex128))
    pb = _quad_split(p * 0.5 * bw, wo)
    kb = k * bw ** degree
    return zb, pb, kb


def _lp2bs_zpk(z, p, k, wo, bw):
    degree = p.size - z.size
    zi = (0.5 * bw) / z if z.size else np.zeros(0, np.complex128)
    pi = (0.5 * bw) / p
    zb = np.append(_quad_split(zi, wo),
                   np.tile(np.array([1j * wo, -1j * wo]), degree))
    pb = _quad_split(pi, wo)
    kb = k * np.real(np.prod(-z) / np.prod(-p)) if z.size else \
        k * np.real(np.prod(1.0 / (-p)))
    return zb, pb, kb


def _bilinear_zpk(z, p, k):
    """Standard bilinear s->z with fs=1/2 (prototype frequencies already
    pre-warped via tan(π·f)): z_d = (1+s)/(1-s); excess zeros -> z=-1."""
    degree = p.size - z.size
    zd = (1.0 + z) / (1.0 - z) if z.size else np.zeros(0, np.complex128)
    pd = (1.0 + p) / (1.0 - p)
    zd = np.append(zd, -np.ones(degree, np.complex128))
    kd = k * np.real(np.prod(1.0 - z) / np.prod(1.0 - p))
    return zd, pd, kd


def _conj_pairs(roots, tol=1e-8):
    """Group roots into conjugate pairs (+ singleton reals), sorted by
    descending modulus so the most selective sections come first."""
    roots = np.asarray(roots, np.complex128)
    reals = sorted([r for r in roots if abs(r.imag) <= tol * (1 + abs(r))],
                   key=lambda r: -abs(r))
    upper = sorted([r for r in roots if r.imag > tol * (1 + abs(r))],
                   key=lambda r: -abs(r))
    pairs = [(u, np.conj(u)) for u in upper]
    while len(reals) >= 2:
        pairs.append((reals.pop(0), reals.pop(0)))
    if reals:
        pairs.append((reals.pop(0),))
    return sorted(pairs, key=lambda pr: -max(abs(r) for r in pr))


def zpk_to_sos(z, p, k) -> np.ndarray:
    """Digital zeros/poles/gain -> (S, 6) second-order sections
    [b0 b1 b2 a0 a1 a2], overall gain folded into the first section."""
    z = np.asarray(z, np.complex128)
    p = np.asarray(p, np.complex128)
    if z.size > p.size:
        raise ValueError("more zeros than poles")
    zp = _conj_pairs(z)
    pp = _conj_pairs(p)
    sos = []
    for i, ppair in enumerate(pp):
        zpair = zp[i] if i < len(zp) else ()
        a = np.real(np.poly(list(ppair)))
        b = np.real(np.poly(list(zpair))) if zpair else np.array([1.0])
        a = np.pad(a, (0, 3 - a.size))
        b = np.pad(b, (0, 3 - b.size))
        sos.append(np.concatenate([b, a]))
    out = np.asarray(sos, np.float64)
    if out.size == 0:
        raise ValueError("empty design")
    out[0, :3] *= float(np.real(k))
    return out




# ---- Jacobi elliptic machinery (Landen iterations; design-time numpy) ----

def _landen_seq(k, tol=1e-14):
    ks = []
    while k > tol and len(ks) < 60:
        k = (k / (1.0 + np.sqrt(1.0 - k * k))) ** 2
        ks.append(k)
    return np.asarray(ks)


def _cde(u, k):
    """Jacobi cd(u*K(k), k), complex-capable (descending Landen)."""
    ks = _landen_seq(k)
    w = np.cos(np.asarray(u) * np.pi / 2.0 + 0j)
    for kn in ks[::-1]:
        w = (1.0 + kn) * w / (1.0 + kn * w * w)
    return w


def _sne(u, k):
    """Jacobi sn(u*K(k), k), complex-capable."""
    ks = _landen_seq(k)
    w = np.sin(np.asarray(u) * np.pi / 2.0 + 0j)
    for kn in ks[::-1]:
        w = (1.0 + kn) * w / (1.0 + kn * w * w)
    return w


def _asne(w, k):
    """Inverse sn (principal branch), complex-capable (ascending Landen)."""
    ks = _landen_seq(k)
    w = np.asarray(w, np.complex128)
    kprev = k
    for kn in ks:
        w = 2.0 * w / ((1.0 + kn) * (1.0 + np.sqrt(1.0 - kprev ** 2 * w * w)))
        kprev = kn
    return 2.0 / np.pi * np.arcsin(w)


def _ellipdeg(N, k1):
    """Degree equation: selectivity k for order N and discrimination k1."""
    L = N // 2
    ui = (2 * np.arange(1, L + 1) - 1.0) / N
    kc = np.sqrt(1.0 - k1 * k1)
    kp = kc ** N * np.prod(np.real(_sne(ui, kc))) ** 4
    return np.sqrt(1.0 - kp * kp)


def elliptic_zpk(order: int, ripple_db: float = 1.0,
                 stopband_db: float = 40.0):
    """Analog elliptic (Cauer) prototype: equiripple passband AND stopband.

    Passband edge at 1 rad/s with |H| = 10^(-ripple_db/20) there; the
    sharpest possible transition for a given order.
    """
    if order < 1:
        raise ValueError("order must be >= 1")
    if ripple_db <= 0 or stopband_db <= ripple_db:
        raise ValueError("need 0 < ripple_db < stopband_db")
    eps_p = np.sqrt(10.0 ** (ripple_db / 10.0) - 1.0)
    eps_s = np.sqrt(10.0 ** (stopband_db / 10.0) - 1.0)
    k1 = eps_p / eps_s
    k = _ellipdeg(order, k1)
    L, r = order // 2, order % 2
    ui = (2 * np.arange(1, L + 1) - 1.0) / order
    zeros_half = 1j / (k * _cde(ui, k))
    v0 = -1j * _asne(1j / eps_p, k1) / order
    poles_half = 1j * _cde(ui - 1j * v0, k)
    zeros = np.concatenate([zeros_half, np.conj(zeros_half)])
    poles = np.concatenate([poles_half, np.conj(poles_half)])
    if r:
        poles = np.append(poles, 1j * _sne(1j * v0, k))
    gain = np.abs(np.prod(poles) / np.prod(zeros)) if zeros.size else \
        np.abs(np.prod(poles))
    if r == 0:
        gain *= 10.0 ** (-ripple_db / 20.0)
    return (zeros.astype(np.complex128), poles.astype(np.complex128),
            float(np.real(gain)))


_PROTOTYPES = {
    "butterworth": lambda order, rip, att: butterworth_zpk(order),
    "chebyshev1": lambda order, rip, att: chebyshev1_zpk(order, rip),
    "chebyshev2": lambda order, rip, att: chebyshev2_zpk(order, att),
    "elliptic": lambda order, rip, att: elliptic_zpk(order, rip, att),
}


def iirdes_sos(design: str, order: int, cutoff: float, cutoff2: float = 0.0,
               bandtype: str = BandType.LOWPASS, ripple_db: float = 1.0,
               stopband_db: float = 40.0) -> np.ndarray:
    """Design a digital IIR filter as second-order sections.

    design: "butterworth" | "chebyshev1" | "chebyshev2"; cutoff (and
    cutoff2 for band filters) in cycles/sample (0, 0.5).  Returns (S, 6)
    [b0 b1 b2 1 a1 a2] rows, most selective section first.  Feed to
    ``sos_to_iir_coeffs`` for ops.iir.IIRFilter(SECOND_ORDER).
    """
    if design not in _PROTOTYPES:
        raise ValueError(f"unknown design {design!r} "
                         f"(have {sorted(_PROTOTYPES)})")
    if not 0.0 < cutoff < 0.5:
        raise ValueError("cutoff must be in (0, 0.5) cycles/sample")
    z, p, k = _PROTOTYPES[design](order, ripple_db, stopband_db)
    if bandtype == BandType.LOWPASS:
        z, p, k = _lp2lp_zpk(z, p, k, np.tan(np.pi * cutoff))
    elif bandtype == BandType.HIGHPASS:
        z, p, k = _lp2hp_zpk(z, p, k, np.tan(np.pi * cutoff))
    elif bandtype in (BandType.BANDPASS, BandType.BANDSTOP):
        if not cutoff < cutoff2 < 0.5:
            raise ValueError("band design needs cutoff < cutoff2 < 0.5")
        w1, w2 = np.tan(np.pi * cutoff), np.tan(np.pi * cutoff2)
        wo, bw = np.sqrt(w1 * w2), w2 - w1
        tf = _lp2bp_zpk if bandtype == BandType.BANDPASS else _lp2bs_zpk
        z, p, k = tf(z, p, k, wo, bw)
    else:
        raise ValueError(f"unknown band type {bandtype!r}")
    zd, pd, kd = _bilinear_zpk(z, p, k)
    sos = zpk_to_sos(zd, pd, kd)
    # normalize a0 = 1 per section (it already is, np.poly is monic)
    return sos


def sos_to_iir_coeffs(sos: np.ndarray):
    """(S, 6) sections -> flattened (feed_forward, feed_back) triples for
    ops.iir.IIRFilter(..., iirtype=SECOND_ORDER)."""
    sos = np.asarray(sos, np.float64)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError("expected (S, 6) second-order sections")
    return sos[:, :3].reshape(-1).copy(), sos[:, 3:].reshape(-1).copy()
