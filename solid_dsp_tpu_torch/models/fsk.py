"""M-ary FSK modem (continuous-phase frequency-shift keying).

Port of ``solid_dsp_tpu/models/fsk.py``: modulation is FM of a symbol
staircase (phase-continuous within and across blocks through the FM phase
accumulator); demodulation is the FM discriminator with integrate and dump
and a slicer (``fsk_demod_discriminator``), or the noncoherent bank of
tone correlators, one strided multi-output ``conv1d_mxu`` (stride sps,
an (sps, M) tone bank: ``fsk_demod_matched``).  The tones are float32, as
the JAX package holds them without 64-bit mode; the functions run where
their input lies.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import device_constant
from ..ops.fir import conv1d_mxu
from . import fm as fm_mod

__all__ = ["fsk_tones", "fsk_modulate", "fsk_demod_discriminator",
           "fsk_demod_matched"]


def fsk_tones(m_ary: int, separation: float) -> np.ndarray:
    """Symmetric tone frequencies (cycles a sample): M levels spaced by
    ``separation``, centred on 0."""
    m = int(m_ary)
    return (np.arange(m) - (m - 1) / 2.0) * separation


def fsk_modulate(symbols, sps: int, m_ary: int, separation: float,
                 phase0=0.0, dtype=torch.float32):
    """CPFSK: symbols (0..M-1) -> complex baseband at sps samples a
    symbol, the phase accumulated in ``dtype`` (float32, as the JAX
    package without 64-bit mode; float64 gives complex128).  Returns (iq,
    phase_end)."""
    symbols = torch.as_tensor(symbols)
    tones = device_constant(fsk_tones(m_ary, separation), symbols.device,
                            dtype)
    f_inst = torch.repeat_interleave(tones[symbols.long()], sps, dim=-1)
    return fm_mod.fm_modulate(f_inst, 1.0, phase0)


def fsk_demod_discriminator(state, x: torch.Tensor, sps: int, m_ary: int,
                            separation: float):
    """FM discriminator, integrate and dump a symbol, nearest level.
    len(x) a multiple of sps.  Returns (symbols int32, new_state)."""
    freq, new_state = fm_mod.fm_demodulate(state, x, 1.0)
    T = x.shape[-1] // sps
    est = torch.mean(freq[..., : T * sps].reshape(*freq.shape[:-1], T, sps),
                     dim=-1)
    tones = device_constant(fsk_tones(m_ary, separation), est.device,
                            est.dtype)
    return (torch.argmin(torch.abs(est[..., None] - tones), dim=-1)
            .to(torch.int32), new_state)


def fsk_demod_matched(x: torch.Tensor, sps: int, m_ary: int,
                      separation: float) -> torch.Tensor:
    """Noncoherent tone-correlator bank: argmax_m |sum_n x e^{-j 2 pi f_m
    n}| over each symbol (int32)."""
    T = x.shape[-1] // sps
    n = np.arange(sps)
    bank = np.exp(-2j * np.pi * np.outer(n, fsk_tones(m_ary, separation)))
    scores = torch.abs(conv1d_mxu(x[..., : T * sps],
                                  device_constant(bank, x.device, x.dtype),
                                  stride=sps))
    return torch.argmax(scores, dim=-1).to(torch.int32)
