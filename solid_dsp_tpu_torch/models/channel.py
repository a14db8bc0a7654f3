"""Channel models and link-budget theory: AWGN, multipath, fading, CFO.

Port of ``solid_dsp_tpu/models/channel.py``.  ``host_wrapped_phase`` is the
exact host-side oscillator phase that ``models/fm.py``'s stereo multiplex
and decoder use; the rest are block transforms on the device (noise from a
generator, the Jakes-shaped fading by one inverse FFT, the multipath
convolution through ``ops/fir.py::conv1d_mxu``) and the closed-form AWGN
error rates (``qfunc``, ``ber_theory``) the tests gate measured BERs
against.

**Randomness.**  Where JAX takes a ``jax.random`` key, the port takes a
``torch.Generator`` in that argument's place, on the device the draws are
made on (x's device; ``rayleigh_doppler_fading`` draws on the generator's
own); a missing generator raises.  The draws differ from JAX's; their
statistics and every deterministic part (the noise variance from
``snr_db``, the CFO rotation, multipath, the theory, the TDL taps) are the
JAX package's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import device_constant
from ..ops.fir import conv1d_mxu

__all__ = [
    "ebn0_to_noise_var", "awgn", "apply_cfo", "phase_noise",
    "multipath_apply", "rayleigh_doppler_fading",
    "qfunc", "ber_theory",
    "TDL_PROFILES", "tdl_taps", "tdl_fading_channel", "host_wrapped_phase",
]


def _generator(generator) -> torch.Generator:
    if not isinstance(generator, torch.Generator):
        raise ValueError("pass a torch.Generator on the data's device (the "
                         "port's stand-in for a jax.random key)")
    return generator


def _real_dtype(x: torch.Tensor):
    return x.real.dtype if x.is_complex() else x.dtype


def _cnormal(generator, shape, x: torch.Tensor) -> torch.Tensor:
    """Complex standard normals (each quadrature N(0, 1)) in x's type."""
    rd = _real_dtype(x)
    re = torch.randn(shape, generator=generator, dtype=rd, device=x.device)
    im = torch.randn(shape, generator=generator, dtype=rd, device=x.device)
    return torch.complex(re, im)


def ebn0_to_noise_var(ebn0_db, bits_per_symbol: int, code_rate: float = 1.0,
                      es: float = 1.0) -> float:
    """Complex-noise variance N0 (both quadratures) for a target Eb/N0:
    Eb = es / (bits_per_symbol code_rate), N0 = Eb / 10^(Eb/N0 dB / 10)."""
    eb = es / (bits_per_symbol * code_rate)
    return eb / (10.0 ** (ebn0_db / 10.0))


def awgn(generator, x, snr_db=None, noise_var=None) -> torch.Tensor:
    """Add complex white Gaussian noise from ``generator``: either
    ``snr_db`` (relative to the measured mean power of x) or an absolute
    complex ``noise_var`` (N0; each quadrature gets N0 / 2)."""
    g = _generator(generator)
    x = torch.as_tensor(x)
    if (snr_db is None) == (noise_var is None):
        raise ValueError("pass exactly one of snr_db / noise_var")
    if noise_var is None:
        p = torch.mean((x * torch.conj(x)).real)
        noise_var = p / (10.0 ** (snr_db / 10.0))
    sigma = torch.sqrt(torch.as_tensor(noise_var, device=x.device).to(
        _real_dtype(x)) / 2.0)
    return x + (sigma * _cnormal(g, x.shape, x)).to(x.dtype)


def host_wrapped_phase(n_samples: int, cycles_per_sample: float,
                       phase0: float = 0.0) -> np.ndarray:
    """(N,) float32 phase 2 pi ((f n) mod 1) + phase0, built on the host.

    2 pi f n taken directly in float32 loses integer resolution once n
    exceeds 2^24; reducing mod 1 in float64 first keeps the wrapped phase
    exact to ~1e-8 cycles for any practical block length."""
    frac = (float(cycles_per_sample) % 1.0) * np.arange(
        n_samples, dtype=np.float64)
    return (2.0 * np.pi * (frac % 1.0) + phase0).astype(np.float32)


def apply_cfo(x, cfo_cycles_per_sample, phase0: float = 0.0):
    """Rotate by a carrier-frequency offset (cycles/sample) and an initial
    phase.  A Python-float offset uses the exact host-side wrapped phase; a
    tensor offset the float32 phase on the device (exact to 2^24 samples)."""
    x = torch.as_tensor(x)
    if isinstance(cfo_cycles_per_sample, (int, float, np.floating)):
        ph = torch.from_numpy(host_wrapped_phase(
            x.shape[-1], cfo_cycles_per_sample, phase0)).to(x.device)
    else:
        k = torch.arange(x.shape[-1], dtype=torch.float32, device=x.device)
        ph = 2.0 * math.pi * torch.as_tensor(cfo_cycles_per_sample).to(
            x.device) * k + phase0
    return x * torch.exp(1j * ph).to(x.dtype)


def phase_noise(generator, x, linewidth_cycles: float) -> torch.Tensor:
    """Wiener (random-walk) phase noise: per-sample increments of RMS
    ``linewidth_cycles`` cycles, from ``generator``."""
    g = _generator(generator)
    x = torch.as_tensor(x)
    dphi = 2.0 * math.pi * linewidth_cycles * torch.randn(
        x.shape[-1], generator=g, dtype=_real_dtype(x), device=x.device)
    return x * torch.exp(1j * torch.cumsum(dphi, 0)).to(x.dtype)


def multipath_apply(x, taps) -> torch.Tensor:
    """Static multipath (FIR) channel y[n] = sum_k h[k] x[n-k], zero initial
    state, output as long as the input (numpy.convolve(x, taps)[:len(x)])."""
    x = torch.as_tensor(x)
    h = torch.as_tensor(np.asarray(taps)).to(x.device, x.dtype).flip(-1)
    x_ext = torch.cat([x.new_zeros((*x.shape[:-1], h.shape[-1] - 1)), x], -1)
    return conv1d_mxu(x_ext, h)


def _jakes_shape(n: int, doppler: float) -> np.ndarray:
    freqs = np.fft.fftfreq(n)
    inside = np.abs(freqs) < doppler
    shape = np.zeros(n)
    shape[inside] = 1.0 / np.sqrt(
        np.maximum(1.0 - (freqs[inside] / doppler) ** 2, 1e-4))
    return np.sqrt(shape)


def rayleigh_doppler_fading(generator, n: int, doppler: float,
                            dtype=torch.complex64) -> torch.Tensor:
    """Unit-power Rayleigh flat-fading gains (n,) with a Jakes spectrum
    (``doppler`` the maximum shift in cycles a sample, in (0, 0.5)):
    complex white bins from ``generator`` (on its device) shaped by the
    Jakes PSD, one inverse FFT, power-normalised."""
    if not 0.0 < doppler < 0.5:
        raise ValueError("doppler must be in (0, 0.5) cycles/sample")
    g = _generator(generator)
    dev = g.device
    like = torch.empty(0, dtype=dtype, device=dev)
    bins = _cnormal(g, (n,), like)
    shape = device_constant(_jakes_shape(n, doppler), dev,
                            _real_dtype(like))
    out = torch.fft.ifft(bins * shape)
    out = out / torch.sqrt(torch.mean((out * torch.conj(out)).real) + 1e-30)
    return out.to(dtype)


# ------------------------------------------------------------- theory

def qfunc(x) -> np.ndarray:
    """Gaussian tail probability Q(x) = erfc(x / sqrt 2) / 2 (float64,
    host values in, numpy out)."""
    t = torch.as_tensor(np.asarray(x, float), dtype=torch.float64)
    return 0.5 * torch.special.erfc(t / math.sqrt(2.0)).numpy()


def ber_theory(scheme: str, m: int, ebn0_db) -> np.ndarray:
    """Textbook uncoded AWGN bit-error rate for Gray-coded M-PSK / M-QAM:
    exact for BPSK/QPSK, the nearest-neighbour approximations above."""
    ebn0 = 10.0 ** (np.asarray(ebn0_db, float) / 10.0)
    k = int(np.log2(m))
    if scheme == "psk":
        if m == 2 or m == 4:
            return qfunc(np.sqrt(2.0 * ebn0))
        return (2.0 / k) * qfunc(np.sqrt(2.0 * k * ebn0) *
                                 math.sin(math.pi / m))
    if scheme == "qam":
        if int(np.sqrt(m)) ** 2 != m:
            raise ValueError("square QAM only")
        return (4.0 / k) * (1.0 - 1.0 / math.sqrt(m)) * qfunc(
            np.sqrt(3.0 * k / (m - 1.0) * ebn0))
    raise ValueError(f"unknown scheme {scheme!r}")


# ------------------------------------------- frequency-selective fading

# 3GPP tapped-delay-line power profiles (delay ns, power dB).
TDL_PROFILES = {
    "epa": ((0, 0.0), (30, -1.0), (70, -2.0), (90, -3.0), (110, -8.0),
            (190, -17.2), (410, -20.8)),
    "eva": ((0, 0.0), (30, -1.5), (150, -1.4), (310, -3.6), (370, -0.6),
            (710, -9.1), (1090, -7.0), (1730, -12.0), (2510, -16.9)),
    "etu": ((0, -1.0), (50, -1.0), (120, -1.0), (200, 0.0), (230, 0.0),
            (500, 0.0), (1600, -3.0), (2300, -5.0), (5000, -7.0)),
}


def tdl_taps(profile, fs_hz: float) -> tuple:
    """(delays_samples, amplitudes) of a named or custom (delay_ns,
    power_db) profile at ``fs_hz``; taps on one sample add in power;
    unit total power."""
    if isinstance(profile, str):
        try:
            prof = TDL_PROFILES[profile.lower()]
        except KeyError:
            raise ValueError(f"unknown TDL profile {profile!r}; one of "
                             f"{sorted(TDL_PROFILES)}") from None
    else:
        prof = tuple(profile)
    pow_by_delay: dict = {}
    for delay_ns, p_db in prof:
        d = int(round(delay_ns * 1e-9 * fs_hz))
        pow_by_delay[d] = pow_by_delay.get(d, 0.0) + 10.0 ** (p_db / 10.0)
    delays = np.asarray(sorted(pow_by_delay), np.int64)
    powers = np.asarray([pow_by_delay[d] for d in delays])
    return delays, np.sqrt(powers / powers.sum())


def tdl_fading_channel(generator, x, profile="eva", fs_hz: float = 30.72e6,
                       doppler: float = 1e-4):
    """Frequency-selective time-varying fading: each tap of the power-delay
    profile fades independently with a Jakes-spectrum Rayleigh gain.
    Returns (y, h_taps (n_taps, T)); the gains are drawn from ``generator``
    one tap after another."""
    x = torch.as_tensor(x)
    n = x.shape[-1]
    delays, amps = tdl_taps(profile, fs_hz)
    if int(delays[-1]) >= n:
        raise ValueError(
            f"signal length {n} shorter than the largest tap delay "
            f"({int(delays[-1])} samples at fs={fs_hz:g})")
    gains = [float(np.float32(amps[i]))
             * rayleigh_doppler_fading(generator, n, doppler, x.dtype).to(
                 x.device) for i in range(len(delays))]
    y = torch.zeros_like(x)
    for d, g in zip(delays.tolist(), gains):
        xd = (torch.cat([x.new_zeros((*x.shape[:-1], d)), x[..., : n - d]],
                        -1) if d else x)
        y = y + g * xd
    return y, torch.stack(gains)
