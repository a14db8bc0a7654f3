"""Kaiser windowed-sinc low-pass, notch and root-raised-cosine design, and
the tap-vector metrics (host, float64).

Port of ``solid_dsp_tpu/design/firdes.py::kaiser_beta``, ``_check_as``,
``firdes_kaiser``, ``firdes_notch`` (:175), the metrics
``filter_autocorrelation``, ``filter_crosscorrelation``, ``filter_isi`` and
``filter_energy`` (:216-271) (reference ``src/filter/firdes/mod.rs``) and
``firdes_rrcos`` (:291), and the length estimates
``estimate_required_filter_length`` with its Kaiser and Herrmann variants,
``estimate_required_filter_stop_band_attenuation`` and
``estimate_required_filter_transition`` (:48-142), which size the halfband
and resampler stages.  The Kaiser taps feed the receive chain's
decimating filter (``models/rx_chain.py``), the FIR filters of
``ops/fir.py`` and the channelizer's prototype (``models/channelizer.py``);
the metrics are ``FIRFilter``'s Firdes-trait methods; the root-raised
cosine is the 2x-oversampled bank's reconstruction prototype.  Also
``firdes_doppler`` (:197, Jakes + Rice-K), ``firdes_hilbert`` (:322), the
least-squares designs ``firdes_ls`` and ``firdes_equiripple`` (Lawson's
reweighting) with their helpers (:347-421) and ``firdes_savgol`` (:424).
"""

from __future__ import annotations

import numpy as np

import math

from .specialfn import besselj, sinc
from .windows import hamming
from .windows import kaiser as kaiser_window

__all__ = ["EstimationMethod", "estimate_required_filter_length",
           "estimate_required_filter_length_kaiser",
           "estimate_required_filter_length_herrmann",
           "estimate_required_filter_stop_band_attenuation",
           "estimate_required_filter_transition", "kaiser_beta",
           "firdes_kaiser", "firdes_notch", "firdes_doppler", "firdes_rrcos",
           "firdes_hilbert", "firdes_ls", "firdes_equiripple",
           "firdes_savgol",
           "filter_autocorrelation", "filter_crosscorrelation",
           "filter_isi", "filter_energy"]


def _check_as(stop_band_attenuation: float):
    if stop_band_attenuation <= 0.0:
        raise ValueError("invalid stop band attenuation (0, inf)")


class EstimationMethod:
    KAISER = "kaiser"
    HERRMANN = "herrmann"


def _check_tb(transition_bandwidth: float):
    if not (0.0 <= transition_bandwidth <= 0.5):
        raise ValueError("invalid transition bandwidth [0, 0.5]")


def estimate_required_filter_length_kaiser(
    transition_bandwidth: float, stop_band_attenuation: float
) -> float:
    """Kaiser length estimate.  Parity: ref firdes/mod.rs:199-210."""
    _check_tb(transition_bandwidth)
    _check_as(stop_band_attenuation)
    return (stop_band_attenuation - 7.95) / (14.26 * transition_bandwidth)


def estimate_required_filter_length_herrmann(
    transition_bandwidth: float, stop_band_attenuation: float
) -> float:
    """Herrmann length estimate.  Parity: ref firdes/mod.rs:213-240."""
    _check_tb(transition_bandwidth)
    _check_as(stop_band_attenuation)
    if stop_band_attenuation > 105.0:
        return estimate_required_filter_length_kaiser(
            transition_bandwidth, stop_band_attenuation
        )
    a = stop_band_attenuation + 7.4
    d1 = 10.0 ** (-a / 20.0)
    d2 = 10.0 ** (-a / 20.0)
    t1 = np.log10(d1)
    t2 = np.log10(d2)
    d_inf = (0.005309 * t1 * t1 + 0.07114 * t1 - 0.4761) * t2 - (
        0.002660 * t1 * t1 + 0.59410 * t1 + 0.4278
    )
    f = 11.012 + 0.51244 * (t1 - t2)
    return (
        d_inf - f * transition_bandwidth * transition_bandwidth
    ) / transition_bandwidth + 1.0


def _estimate(method: str, tb: float, att: float) -> float:
    if method == EstimationMethod.KAISER:
        return estimate_required_filter_length_kaiser(tb, att)
    return estimate_required_filter_length_herrmann(tb, att)


def estimate_required_filter_length(
    transition_bandwidth: float,
    stop_band_attenuation: float,
    method: str = EstimationMethod.KAISER,
) -> int:
    """Required filter length (truncated to int).  Parity: ref firdes/mod.rs:71-95."""
    _check_tb(transition_bandwidth)
    _check_as(stop_band_attenuation)
    return int(_estimate(method, transition_bandwidth, stop_band_attenuation))


def estimate_required_filter_stop_band_attenuation(
    transition_bandwidth: float,
    filter_length: int,
    method: str = EstimationMethod.KAISER,
) -> float:
    """Bisection (20 steps in [0.01, 200] dB).  Parity: ref firdes/mod.rs:117-146."""
    as0, as1 = 0.01, 200.0
    as_hat = 0.0
    for _ in range(20):
        as_hat = 0.5 * (as1 + as0)
        n_hat = _estimate(method, transition_bandwidth, as_hat)
        if n_hat < filter_length:
            as0 = as_hat
        else:
            as1 = as_hat
    return as_hat


def estimate_required_filter_transition(
    stop_band_attenuation: float,
    filter_length: int,
    method: str = EstimationMethod.KAISER,
) -> float:
    """Bisection (20 steps in [0.001, 0.499]).  Parity: ref firdes/mod.rs:168-196."""
    df0, df1 = 0.001, 0.499
    df_hat = 0.0
    for _ in range(20):
        df_hat = 0.5 * (df1 + df0)
        n_hat = _estimate(method, df_hat, stop_band_attenuation)
        if n_hat < filter_length:
            df1 = df_hat
        else:
            df0 = df_hat
    return df_hat


def kaiser_beta(stop_band_attenuation: float) -> float:
    """Kaiser beta from the stop-band attenuation in dB."""
    a = abs(stop_band_attenuation)
    if a > 50.0:
        return 0.1102 * (a - 8.7)
    if a > 21.0:
        return 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    return 0.0


def firdes_kaiser(
    filter_length: int,
    cutoff_frequency: float,
    stop_band_attenuation: float,
    fractional_sample_offset: float = 0.0,
) -> np.ndarray:
    """Windowed-sinc Kaiser low-pass taps (float64)."""
    if not (-0.5 <= fractional_sample_offset <= 0.5):
        raise ValueError("invalid mu range [-0.5, 0.5]")
    if not (0.0 <= cutoff_frequency <= 0.5):
        raise ValueError("invalid bandwidth [0, 0.5]")
    _check_as(stop_band_attenuation)
    beta = kaiser_beta(stop_band_attenuation)
    i = np.arange(filter_length, dtype=np.float64)
    t = i - (filter_length - 1) / 2.0 + fractional_sample_offset
    h1 = sinc(2.0 * cutoff_frequency * t)
    return np.asarray(h1) * kaiser_window(filter_length, beta)


def firdes_notch(semi_length: int, notch_frequency: float,
                 stop_band_attenuation: float) -> np.ndarray:
    """Kaiser-windowed notch (band-stop) of 2 * semi_length + 1 taps."""
    if not (1 <= semi_length <= 1000):
        raise ValueError("invalid filter semi length [1, 1000]")
    if not (0.0 <= notch_frequency <= 0.5):
        raise ValueError("invalid bandwidth [0, 0.5]")
    _check_as(stop_band_attenuation)
    beta = kaiser_beta(stop_band_attenuation)
    h_len = 2 * semi_length + 1
    i = np.arange(h_len, dtype=np.float64)
    tone = -np.cos(2.0 * np.pi * notch_frequency * (i - semi_length))
    h = tone * kaiser_window(h_len, beta)
    h = h / np.sum(h * tone)
    h[semi_length] += 1.0
    return h


def filter_autocorrelation(h, lag: int) -> float:
    """Autocorrelation of a tap vector at an integer lag."""
    h = np.asarray(h, dtype=np.float64)
    lag = abs(int(lag))
    if lag >= h.size:
        return 0.0
    return float(np.dot(h[lag:], h[: h.size - lag]))


def filter_crosscorrelation(h, g, lag: int) -> float:
    """Cross-correlation of two tap vectors at an integer lag, the longer
    filter first (swapped otherwise)."""
    h = np.asarray(h, dtype=np.float64)
    g = np.asarray(g, dtype=np.float64)
    if h.size < g.size:
        return filter_crosscorrelation(g, h, lag)
    lag = int(lag)
    if lag <= -g.size or lag >= h.size:
        return 0.0
    ig = -lag if lag < 0 else 0
    ih = lag if lag > 0 else 0
    if lag < 0:
        n = g.size + lag
    elif lag < h.size - g.size:
        n = g.size
    else:
        n = h.size - lag
    return float(np.dot(h[ih: ih + n], g[ig: ig + n]))


def filter_isi(h, samples_per_symbol: int,
               filter_delay: int) -> tuple[float, float]:
    """Inter-symbol interference (rms, max); (0, 0) unless the filter has
    2 * sps * delay + 1 taps."""
    h = np.asarray(h, dtype=np.float64)
    if 2 * samples_per_symbol * filter_delay + 1 != h.size:
        return (0.0, 0.0)
    rxx0 = filter_autocorrelation(h, 0)
    isi_rms = 0.0
    isi_max = 0.0
    for i in range(1, 2 * filter_delay):
        e = abs(filter_autocorrelation(h, i * samples_per_symbol) / rxx0)
        isi_rms += e * e
        if i == 1 or e > isi_max:
            isi_max = e
    return (float(np.sqrt(isi_rms / (2.0 * filter_delay))), float(isi_max))


def filter_energy(h, cutoff_frequency: float, fft_size: int) -> float:
    """Relative energy above ``cutoff_frequency``: the DTFT probed at
    f = 0.5 i / fft_size with the positive-exponent tone e^{+j 2 pi f k},
    one (fft_size, ntaps) product."""
    h = np.asarray(h, dtype=np.float64)
    if not (0.0 <= cutoff_frequency <= 0.5):
        raise ValueError("invalid bandwidth [0, 0.5]")
    if h.size == 0:
        raise ValueError("invalid filter size [1, inf)")
    if fft_size == 0:
        raise ValueError("invalid fft size [1, inf)")
    f = 0.5 * np.arange(fft_size, dtype=np.float64) / fft_size
    k = np.arange(h.size, dtype=np.float64)
    v = np.exp(2j * np.pi * np.outer(f, k)) @ h.astype(np.complex128)
    e2 = (v * np.conj(v)).real
    return float(np.sum(e2[f > cutoff_frequency])) / float(np.sum(e2))


def firdes_rrcos(samples_per_symbol: int, delay_symbols: int,
                 rolloff: float = 0.35) -> np.ndarray:
    """Root-raised-cosine pulse: ntaps = 2*sps*delay + 1, unit energy; the
    t = 0 and t = +-Ts/(4 beta) singularities take their limits."""
    sps = int(samples_per_symbol)
    beta = float(rolloff)
    if not 0.0 < beta <= 1.0:
        raise ValueError("rolloff must be in (0, 1]")
    n = 2 * sps * int(delay_symbols) + 1
    t = (np.arange(n) - (n - 1) / 2.0) / sps  # in symbol periods
    h = np.zeros(n)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-12:
            h[i] = 1.0 - beta + 4.0 * beta / np.pi
        elif abs(abs(ti) - 1.0 / (4.0 * beta)) < 1e-9:
            h[i] = (beta / np.sqrt(2.0)) * (
                (1 + 2 / np.pi) * np.sin(np.pi / (4 * beta))
                + (1 - 2 / np.pi) * np.cos(np.pi / (4 * beta)))
        else:
            num = (np.sin(np.pi * ti * (1 - beta))
                   + 4 * beta * ti * np.cos(np.pi * ti * (1 + beta)))
            den = np.pi * ti * (1 - (4 * beta * ti) ** 2)
            h[i] = num / den
    return h / np.sqrt(np.sum(h ** 2))


def firdes_doppler(filter_length: int, doppler_frequency: float,
                   rice_fading_factor: float, theta: float) -> np.ndarray:
    """Doppler filter (Jakes + Rice-K), Kaiser-windowed at beta 4
    (reference firdes/mod.rs:389-418)."""
    i = np.arange(filter_length, dtype=np.float64)
    t = i - (filter_length - 1.0) / 2.0
    j = 1.5 * besselj(np.abs(2.0 * np.pi * doppler_frequency * t), 0.0)
    r = (1.5 * rice_fading_factor / (rice_fading_factor + 1.0)
         * np.cos(2.0 * np.pi * doppler_frequency * t * np.cos(theta)))
    return (j + r) * kaiser_window(filter_length, 4.0)


def firdes_hilbert(ntaps: int) -> np.ndarray:
    """Hamming-windowed FIR Hilbert transformer of odd length: 2/(pi k) at
    odd offsets k from the centre, 0 elsewhere (group delay (N-1)/2)."""
    n = int(ntaps)
    if n % 2 == 0:
        raise ValueError("ntaps must be odd")
    k = np.arange(n) - (n - 1) // 2
    h = np.zeros(n)
    odd = (k % 2) != 0
    h[odd] = 2.0 / (np.pi * k[odd])
    return h * hamming(n)


def _type1_design_matrix(ntaps: int, grid: np.ndarray):
    """The cosine basis (G, (ntaps - 1)/2 + 1) of a type-I FIR on ``grid``."""
    m = (ntaps - 1) // 2
    return np.cos(np.outer(2.0 * np.pi * grid, np.arange(m + 1)))


def _bands_grid(bands, desired, weights, grid_density, ntaps):
    """(frequencies, targets, weights) of the bands' dense grid: at least 8
    points a band, grid_density * ntaps (at least 64) in all, shared by the
    bands' widths."""
    pts, des, wts = [], [], []
    n_total = max(grid_density * ntaps, 64)
    span = sum(b[1] - b[0] for b in bands)
    for (f0, f1), d, w in zip(bands, desired, weights):
        n = max(int(round(n_total * (f1 - f0) / span)), 8)
        pts.append(np.linspace(f0, f1, n))
        des.append(np.full(n, float(d)))
        wts.append(np.full(n, float(w)))
    return np.concatenate(pts), np.concatenate(des), np.concatenate(wts)


def _coeffs_to_taps(coeffs: np.ndarray, ntaps: int) -> np.ndarray:
    """Cosine-basis coefficients -> the symmetric type-I impulse response."""
    m = (ntaps - 1) // 2
    h = np.zeros(ntaps)
    h[m] = coeffs[0]
    for k in range(1, m + 1):
        h[m + k] = h[m - k] = 0.5 * coeffs[k]
    return h


def firdes_ls(ntaps: int, bands, desired, weights=None,
              grid_density: int = 16) -> np.ndarray:
    """Weighted least-squares multiband linear-phase FIR (type I; an even
    ``ntaps`` grows by one).  bands [(f0, f1), ...] in cycles/sample,
    ``desired`` a gain a band, ``weights`` an error weight a band."""
    if ntaps % 2 == 0:
        ntaps += 1
    if weights is None:
        weights = [1.0] * len(bands)
    f, d, w = _bands_grid(bands, desired, weights, grid_density, ntaps)
    A = _type1_design_matrix(ntaps, f)
    coeffs, *_ = np.linalg.lstsq(A * w[:, None], d * w, rcond=None)
    return _coeffs_to_taps(coeffs, ntaps)


def firdes_equiripple(ntaps: int, bands, desired, weights=None,
                      grid_density: int = 16, iterations: int = 60,
                      beta: float = 0.5) -> np.ndarray:
    """Near-equiripple multiband FIR by Lawson's iteratively reweighted least
    squares: after each solve the grid's weights grow with the error
    envelope (to the power ``beta``), renormalised to the largest band
    weight."""
    if ntaps % 2 == 0:
        ntaps += 1
    if weights is None:
        weights = [1.0] * len(bands)
    f, d, w0 = _bands_grid(bands, desired, weights, grid_density, ntaps)
    A = _type1_design_matrix(ntaps, f)
    w = w0.copy()
    coeffs = None
    for _ in range(iterations):
        coeffs, *_ = np.linalg.lstsq(A * w[:, None], d * w, rcond=None)
        err = np.abs((A @ coeffs - d) * w0)
        env = err / (np.mean(err) + 1e-300)
        w = w * np.power(env + 1e-12, beta)
        w = w / np.max(w) * np.max(w0)
    return _coeffs_to_taps(coeffs, ntaps)


def firdes_savgol(window_length: int, polyorder: int,
                  deriv: int = 0) -> np.ndarray:
    """Savitzky-Golay taps: deriv! times row ``deriv`` of the pseudo-inverse
    of the Vandermonde matrix over the centred odd window (the best-fit
    polynomial's value or derivative at the centre, newest-last taps,
    group delay (W-1)/2)."""
    W, p, d = int(window_length), int(polyorder), int(deriv)
    if W < 1 or W % 2 == 0:
        raise ValueError("window_length must be odd and >= 1")
    if not 0 <= p < W:
        raise ValueError("need 0 <= polyorder < window_length")
    if not 0 <= d <= p:
        raise ValueError("need 0 <= deriv <= polyorder")
    x = np.arange(W, dtype=np.float64) - (W - 1) / 2.0
    A = x[:, None] ** np.arange(p + 1)[None, :]
    return np.linalg.pinv(A)[d] * float(math.factorial(d))
