"""MSK and GMSK modems (minimum-shift keying, Gaussian-filtered MSK).

Port of ``solid_dsp_tpu/models/gmsk.py``.  MSK is CPFSK with modulation
index 1/2 (each bit moves the phase by +-pi/2 over a symbol) on the FM
phase accumulator (``models/fm.py``); GMSK shapes the frequency pulse with
a Gaussian of bandwidth-time product BT (0.3 for GSM, 0.4 for AIS, 0.5 for
DECT) through ``conv1d_mxu`` with a carried tail.  Two receivers:

* ``gmsk_demod_discriminator``: receive lowpass, FM discriminator,
  integrate and dump, sign; streaming ``(state, x) -> (bits, state)``;
* ``gmsk_demod_matched``: the coherent Laurent receiver, a matched filter
  with the principal Laurent pulse C0, fitted on the host by least
  squares in numpy (``laurent_pulse``), as in the JAX package.

The taps and the pulse are host numpy; tensor functions run where their
input lies, and ``gmsk_mod_init`` / ``gmsk_demod_init`` build their carries
on ``device`` (the card by default).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from ..design.firdes import firdes_kaiser
from ..device import device_constant, resolve_device
from ..ops.fir import conv1d_mxu
from . import fm as fm_mod
from .linear_mod import unwrap

__all__ = ["gaussian_pulse_taps", "laurent_pulse", "msk_modulate",
           "msk_demod_coherent", "gmsk_mod_init", "gmsk_modulate",
           "gmsk_demod_init", "gmsk_demod_discriminator",
           "gmsk_demod_delay_symbols", "gmsk_demod_matched"]


def gaussian_pulse_taps(bt: float, sps: int,
                        span_symbols: int = 4) -> np.ndarray:
    """The Gaussian frequency pulse (host numpy float64): a one-symbol
    rectangle convolved with a Gaussian of 3-dB bandwidth-time product
    ``bt`` (closed form by erf), sampled at ``sps`` over 2 span_symbols
    symbols and normalised to unit sum."""
    if bt <= 0 or sps < 1 or span_symbols < 1:
        raise ValueError("bt > 0, sps >= 1, span_symbols >= 1 required")
    n = int(2 * span_symbols * sps) + 1
    t = (np.arange(n) - (n - 1) / 2.0) / sps
    alpha = 2.0 * np.pi * bt / np.sqrt(np.log(2.0))
    erf = np.vectorize(math.erf)
    g = 0.5 * (erf(alpha * (t + 0.5) / math.sqrt(2.0))
               - erf(alpha * (t - 0.5) / math.sqrt(2.0)))
    g = np.maximum(g, 0.0)
    return (g / g.sum()).astype(np.float64)


def msk_modulate(bits, sps: int, phase0=0.0):
    """MSK: bits {0, 1} -> complex baseband, +-1/(4 sps) cycles a sample
    for a symbol each.  Returns (iq, phase_end)."""
    nrz = 2.0 * torch.as_tensor(bits).to(torch.float32) - 1.0
    f_inst = torch.repeat_interleave(nrz, sps, dim=-1) / (4.0 * sps)
    return fm_mod.fm_modulate(f_inst, 1.0, phase0)


def gmsk_mod_init(bt: float = 0.3, sps: int = 8, span_symbols: int = 4,
                  dtype=torch.float32, device=None):
    """The modulator's carry on ``device``: (shaping tail, phase)."""
    dev = resolve_device(device)
    ntaps = 2 * span_symbols * sps + 1
    return (torch.zeros(ntaps - 1, dtype=dtype, device=dev),
            torch.zeros((), dtype=dtype, device=dev))


def gmsk_modulate(state, bits, sps: int, bt: float = 0.3,
                  span_symbols: int = 4):
    """GMSK: bits -> complex baseband through the Gaussian-shaped frequency
    pulse; state = (tail, phase0) from ``gmsk_mod_init``.  Returns (iq,
    new_state), len(bits) * sps samples; the shaping delay of span_symbols
    symbols is carried by the tail."""
    tail, phase0 = state
    taps = gaussian_pulse_taps(bt, sps, span_symbols)
    nrz = 2.0 * torch.as_tensor(bits, device=tail.device).to(tail.dtype) - 1.0
    f_nrz = torch.repeat_interleave(nrz, sps, dim=-1) / (4.0 * sps)
    ext = torch.cat([tail, f_nrz], dim=-1)
    f_shaped = conv1d_mxu(ext, device_constant(taps, ext.device, tail.dtype))
    iq, phase_end = fm_mod.fm_modulate(f_shaped, 1.0, phase0)
    return iq, (ext[..., ext.shape[-1] - (len(taps) - 1):],
                phase_end.to(tail.dtype))


def msk_demod_coherent(x: torch.Tensor, sps: int, phase0=0.0):
    """Coherent MSK demodulation by the phase trajectory: the bit is the
    sign of each symbol's phase increment (clean, high-SNR signals)."""
    T = x.shape[-1] // sps
    ph = unwrap(torch.angle(x[..., : T * sps]))
    bound = ph[..., sps - 1:: sps]
    inc = torch.diff(bound, dim=-1)
    first = bound[..., :1] - phase0
    return (torch.cat([first, inc], dim=-1) > 0).to(torch.int32)


def _rx_lowpass_taps(sps: int) -> np.ndarray:
    """The pre-discriminator lowpass: Kaiser, cutoff 0.75 / sps, unit DC
    gain."""
    h = np.asarray(firdes_kaiser(4 * sps + 1, 0.75 / sps, 60.0, 0.0))
    return h / h.sum()


def gmsk_demod_delay_symbols(sps: int, span_symbols: int = 4) -> int:
    """Modulator plus discriminator latency in symbols: the shaping delay
    and the receive lowpass's group delay (2 symbols)."""
    del sps
    return span_symbols + 2


def gmsk_demod_init(bt: float = 0.3, sps: int = 8, span_symbols: int = 4,
                    dtype=torch.complex64, device=None):
    """The discriminator receiver's carry on ``device``: (receive-filter
    tail, FM discriminator state)."""
    del bt, span_symbols
    return (torch.zeros(4 * sps, dtype=dtype, device=resolve_device(device)),
            fm_mod.fm_demod_init(dtype, device=device))


def gmsk_demod_discriminator(state, x: torch.Tensor, sps: int,
                             bt: float = 0.3, span_symbols: int = 4):
    """Limiter-discriminator GMSK receiver (noncoherent, streaming):
    receive lowpass, FM discriminator, integrate and dump over each symbol,
    sign.  len(x) a multiple of sps.  Returns (bits, new_state); bit k is
    transmitted bit k - gmsk_demod_delay_symbols(sps, span_symbols)."""
    del bt
    rx_tail, fm_state = state
    taps = _rx_lowpass_taps(sps)
    ext = torch.cat([rx_tail, x.to(rx_tail.dtype)], dim=-1)
    xf = conv1d_mxu(ext, device_constant(taps, ext.device, x.dtype))
    freq, new_fm = fm_mod.fm_demodulate(fm_state, xf, 1.0)
    T = x.shape[-1] // sps
    per_sym = freq[..., : T * sps].reshape(*freq.shape[:-1], T, sps)
    bits = (torch.mean(per_sym, dim=-1) > 0).to(torch.int32)
    return bits, (ext[..., ext.shape[-1] - (len(taps) - 1):], new_fm)


@lru_cache(maxsize=8)
def laurent_pulse(bt: float, sps: int, span_symbols: int = 4,
                  pulse_symbols: int = 10) -> np.ndarray:
    """The principal Laurent pulse C0, fitted on the host by least squares:
    a fixed random training burst modulated in numpy, s[n] ~ sum_k
    j^{A_k} p[n - k sps] solved for p (pulse_symbols sps taps), normalised
    to unit matched-filter gain (p / ||p||^2)."""
    rng = np.random.default_rng(0x6A5C)
    ntr = 256
    tb = rng.integers(0, 2, ntr)
    taps = gaussian_pulse_taps(bt, sps, span_symbols)
    f_nrz = np.repeat(2.0 * tb - 1.0, sps) / (4.0 * sps)
    ext = np.concatenate([np.zeros(len(taps) - 1), f_nrz])
    f_shaped = np.convolve(ext, taps, mode="valid")
    s = np.exp(2j * np.pi * np.cumsum(f_shaped))
    beta = np.exp(1j * np.pi / 2 * np.cumsum(2 * tb - 1))
    P = pulse_symbols * sps
    N = len(s)
    M = np.zeros((N, P), complex)
    eye = np.eye(P)
    for k in range(ntr):
        n0 = k * sps
        hi = min(P, N - n0)
        if hi > 0:
            M[n0:n0 + hi, :hi] += beta[k] * eye[:hi, :hi]
    p, *_ = np.linalg.lstsq(M, s, rcond=None)
    return p / (np.linalg.norm(p) ** 2)


def gmsk_demod_matched(x: torch.Tensor, sps: int, bt: float = 0.3,
                       span_symbols: int = 4) -> torch.Tensor:
    """Coherent Laurent GMSK receiver (bursts modulated from
    ``gmsk_mod_init``'s state): matched filter with C0, symbol-rate
    samples de-rotated by j^-k, s_k = sign(Im z_k) on the alternating
    axis, a_0 = s_0 and a_k = s_k s_{k-1}.  One bit a symbol, aligned to
    the transmitted bits (the last span_symbols need a flushed
    transmitter)."""
    p = laurent_pulse(bt, sps, span_symbols)
    P = p.shape[0]
    T = x.shape[-1] // sps
    ext = torch.cat([x, x.new_zeros((*x.shape[:-1], P - sps))], dim=-1)
    y = conv1d_mxu(ext, device_constant(np.conj(p), x.device, x.dtype))
    y = y[..., ::sps][..., :T]
    k = np.arange(T)
    rot = device_constant(np.exp(-0.5j * np.pi * k), x.device, x.dtype)
    s = torch.where((y * rot).imag > 0, 1, -1)
    a = torch.cat([s[..., :1], s[..., 1:] * s[..., :-1]], dim=-1)
    return torch.div(a + 1, 2, rounding_mode="floor").to(torch.int32)
