"""FM modulation and demodulation, and the broadcast-stereo back end.

Port of ``solid_dsp_tpu/models/fm.py``: the phase-difference discriminator
``fm_demodulate`` (which the receive chain runs on its rotated, gained
output, ``epilogue="rotate"``), ``fm_modulate`` (a cumulative phase), and
the broadcast layer on the discriminator's output: ``fm_stereo_mpx``
composes the stereo multiplex, ``fm_stereo_decode`` isolates the 19 kHz
pilot by a complex mix and a centred lowpass, regenerates the 38 kHz
subcarrier by squaring the unit pilot phasor (no PLL: block-parallel),
detects L-R synchronously, matrixes and optionally de-emphasizes; the
one-pole de-emphasis runs as ``ops/iir.py::iir_apply`` (its parallel route,
as in the JAX package; on the card that is S3, ``csrc/iir_scan.cu``).
Tensor functions: they run where their input lies.
"""

from __future__ import annotations

import numpy as np
import torch

from ..design.firdes import firdes_kaiser
from ..ops.fir import conv1d_mxu
from ..ops.iir import iir_apply, iir_init
from .channel import host_wrapped_phase

__all__ = ["fm_modulate", "fm_demodulate", "fm_stereo_mpx",
           "fm_stereo_decode", "deemphasis_init", "deemphasis_apply"]

_PILOT_HZ = 19_000.0


def fm_modulate(msg: torch.Tensor, kf: float, phase0=0.0):
    """Complex-baseband FM: exp(j (phase0 + 2 pi kf cumsum(msg))) over the
    last axis.  Returns (iq, phase_end mod 2 pi) for block streaming."""
    dphase = 2.0 * np.pi * kf * msg
    phase = phase0 + torch.cumsum(dphase, dim=-1)
    return torch.exp(1j * phase), torch.remainder(phase[..., -1],
                                                  2.0 * np.pi)


def fm_demodulate(state: torch.Tensor, x: torch.Tensor, kf: float):
    """y[n] = arg(x[n] conj(x[n-1])) / (2 pi kf) over the last axis, x[-1]
    the carried ``state`` (one per leading index); returns
    (y, new_state = x[..., -1])."""
    prev = torch.cat([state.to(x.dtype)[..., None], x[..., :-1]], dim=-1)
    dt = np.float64 if x.dtype == torch.complex128 else np.float32
    return (torch.angle(x * prev.conj()) / float(dt(2.0 * np.pi * kf)),
            x[..., -1])


def _phase(n: int, cycles: float, device) -> torch.Tensor:
    """The exact wrapped oscillator phase (float32), on ``device``."""
    return torch.from_numpy(host_wrapped_phase(n, cycles)).to(device)


def fm_stereo_mpx(left, right, fs: float, pilot_level: float = 0.1):
    """The broadcast stereo multiplex (the transmit side):
    0.45 (L + R) + pilot sin(2 pi 19k t) + 0.45 (L - R) sin(2 pi 38k t);
    the audio band-limited to 15 kHz beforehand."""
    left = torch.as_tensor(left)
    right = torch.as_tensor(right, device=left.device)
    n = left.shape[-1]
    th = _phase(n, _PILOT_HZ / fs, left.device)
    th2 = _phase(n, 2.0 * _PILOT_HZ / fs, left.device)
    return (0.45 * (left + right)
            + pilot_level * torch.sin(th).to(left.dtype)
            + 0.45 * (left - right) * torch.sin(th2).to(left.dtype))


def _filt_same(x: torch.Tensor, h) -> torch.Tensor:
    """Centred same-length FIR (symmetric taps: zero phase)."""
    h = torch.as_tensor(np.asarray(h), device=x.device).to(x.dtype)
    c = (h.shape[-1] - 1) // 2
    z = torch.zeros((*x.shape[:-1], c), dtype=x.dtype, device=x.device)
    return conv1d_mxu(torch.cat([z, x, z], dim=-1), h)


def fm_stereo_decode(mpx, fs: float, deemphasis_tau: float = 0.0):
    """Stereo MPX -> (left, right, pilot_amplitude), over a whole block
    (its edges carry the filters' transients).  The pilot: a 19 kHz complex
    mix and a centred 401-tap lowpass (+-1 kHz); the 38 kHz subcarrier: the
    squared unit pilot phasor shifted back (sin 2 theta, no PLL); L - R by
    a synchronous product; both rails through the same centred 201-tap
    15 kHz lowpass so they stay aligned.  ``deemphasis_tau`` (seconds, for
    example 75e-6) applies the receiver's de-emphasis."""
    mpx = torch.as_tensor(mpx)
    rdt = mpx.dtype
    th = _phase(mpx.shape[-1], _PILOT_HZ / fs, mpx.device)
    rot = torch.exp(-1j * th)
    h_pilot = firdes_kaiser(401, 1_000.0 / fs, 60.0, 0.0)
    h_pilot = h_pilot / np.sum(h_pilot)
    cdt = torch.complex128 if rdt == torch.float64 else torch.complex64
    p_bb = _filt_same(mpx.to(cdt) * rot, h_pilot)
    amp = torch.abs(p_bb)
    pilot_amp = 2.0 * torch.mean(amp)          # sin amplitude = 2 |analytic|
    u = p_bb / (amp + 1e-30)
    # sin(theta) has the analytic phasor e^{j(theta - pi/2)}; its square
    # e^{j(2 theta - pi)} has Im = -sin(2 theta): negated
    carrier38 = -torch.imag((u * torch.conj(rot)) ** 2).to(rdt)
    h_audio = firdes_kaiser(201, 15_000.0 / fs, 60.0, 0.0)
    h_audio = h_audio / np.sum(h_audio)
    mono = _filt_same(mpx, h_audio)                       # 0.45 (L + R)
    diff = _filt_same(2.0 * mpx * carrier38, h_audio)     # 0.45 (L - R)
    left = (mono + diff) / 0.9
    right = (mono - diff) / 0.9
    if deemphasis_tau > 0.0:
        left, _ = deemphasis_apply(deemphasis_init(rdt, device=mpx.device),
                                   left, deemphasis_tau * fs)
        right, _ = deemphasis_apply(deemphasis_init(rdt, device=mpx.device),
                                    right, deemphasis_tau * fs)
    return left, right, pilot_amp


def deemphasis_init(dtype=torch.float32, batch_shape: tuple = (),
                    device=None) -> torch.Tensor:
    """Carry of the one-pole de-emphasis (its w-state), on ``device`` (the
    card unless told otherwise)."""
    return iir_init(1, dtype=dtype, batch_shape=batch_shape, device=device)


def deemphasis_apply(state, x, tau_samples: float):
    """One-pole de-emphasis y[n] = a x[n] + (1 - a) y[n-1],
    a = 1 - e^{-1/tau}: the broadcast RC network (tau = 75 us in the
    Americas, 50 us elsewhere, times fs), unity DC gain, through
    ``iir_apply`` (parallel route).  Returns (y, new_state)."""
    a = 1.0 - np.exp(-1.0 / float(tau_samples))
    x = torch.as_tensor(x)
    # host coefficients: on the card S3 takes its tables from host values
    b = torch.tensor([a], dtype=x.dtype)
    a_tail = torch.tensor([-(1.0 - a)], dtype=x.dtype)
    return iir_apply(b, a_tail, state, x)
