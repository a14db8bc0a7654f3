"""Chirp spread spectrum (LoRa-style CSS modulation).

Port of ``solid_dsp_tpu/models/css.py``.  A symbol of SF bits is a cyclic
shift of a base upchirp of N = 2^SF chips, built in closed form from the
phase law (chip n of shift s has the base chirp's phase at (n + s) mod N,
float32 as in JAX); demodulation dechirps (one product by the conjugate
base chirp) and takes one batched length-N FFT a symbol, whose magnitude's
argmax is the (Gray-coded) shift.  The shift indices are Gray-coded as in
the LoRa PHY, on ``linear_mod``'s ``_gray``, ``bits_to_symbols`` and
``symbols_to_bits``.  The functions run where their input lies;
``CSSModem`` moves its inputs to ``device`` (the card by default).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import bind_device, device_constant
from .linear_mod import _gray, bits_to_symbols, symbols_to_bits

__all__ = ["css_base_chirp", "css_modulate", "css_demodulate", "CSSModem"]


def css_base_chirp(sf: int, down: bool = False) -> np.ndarray:
    """The unit upchirp (or downchirp) of N = 2^sf chips, host numpy:
    phase[n] = 2 pi (n^2 / (2N) - n / 2), sweeping -1/2 .. +1/2 cycles a
    chip."""
    if not (2 <= sf <= 16):
        raise ValueError("spreading factor in [2, 16]")
    n = np.arange(1 << sf, dtype=np.float64)
    N = float(1 << sf)
    ph = 2.0 * np.pi * (n * n / (2.0 * N) - 0.5 * n)
    c = np.exp(1j * ph)
    return np.conj(c) if down else c


def css_modulate(bits, sf: int = 8) -> torch.Tensor:
    """Bits (a multiple of sf) -> the CSS waveform ((len / sf) 2^sf,)
    complex64."""
    N = 1 << sf
    bits = torch.as_tensor(bits)
    sym = bits_to_symbols(bits, sf)
    shift = device_constant(_gray(N).astype(np.int32), sym.device)[sym.long()]
    n = torch.arange(N, dtype=torch.float32, device=sym.device)
    m = torch.remainder(n[None, :] + shift[:, None].to(torch.float32), N)
    ph = 2.0 * np.pi * (m * m / (2.0 * N) - 0.5 * m)
    return torch.exp(1j * ph).to(torch.complex64).reshape(-1)


def css_demodulate(x, sf: int = 8) -> torch.Tensor:
    """The CSS waveform -> hard bits: dechirp, batched FFT, argmax,
    un-Gray.  Noncoherent (magnitude), so a constant phase is
    irrelevant."""
    N = 1 << sf
    x = torch.as_tensor(x)
    if x.shape[-1] % N:
        raise ValueError(
            f"waveform length {x.shape[-1]} is not a multiple of the "
            f"{N}-chip symbol (clipped burst?)")
    n_sym = x.shape[-1] // N
    down = device_constant(css_base_chirp(sf, down=True).astype(np.complex64),
                           x.device)
    d = x[: n_sym * N].reshape(n_sym, N) * down[None, :]
    shift = torch.argmax(torch.abs(torch.fft.fft(d, dim=-1)), dim=-1)
    inv = np.zeros(N, np.int32)
    inv[_gray(N)] = np.arange(N)
    return symbols_to_bits(device_constant(inv, x.device)[shift], sf)


class CSSModem:
    """Bit-level CSS modem at spreading factor ``sf`` on ``device``."""

    def __init__(self, sf: int = 8, device=None):
        if not (2 <= sf <= 16):
            raise ValueError("spreading factor in [2, 16]")
        self.sf = int(sf)
        self.chips_per_symbol = 1 << self.sf
        self.device = bind_device(device)

    def modulate(self, bits) -> torch.Tensor:
        bits = torch.as_tensor(bits).to(self.device)
        if bits.shape[-1] % self.sf:
            raise ValueError(
                f"bit count must be a multiple of sf={self.sf}")
        return css_modulate(bits, self.sf)

    def demodulate(self, x) -> torch.Tensor:
        return css_demodulate(torch.as_tensor(x).to(self.device), self.sf)

    def __repr__(self):
        return (f"CSSModem [SF={self.sf}] "
                f"[N={self.chips_per_symbol} chips/symbol]")
