"""Channel sounder: Zadoff-Chu excitation -> impulse response estimate.

Port of ``solid_dsp_tpu/models/sounder.py``.  A CAZAC (Zadoff-Chu)
sequence has an ideal periodic autocorrelation (a delta), so the circular
cross-correlation of the received body with it is the channel impulse
response, computed as FFTs where the input lies.  ``sound`` builds the
excitation (with a cyclic prefix so linear convolution looks circular over
the body) on ``device`` (the card by default); ``estimate_cir`` averages
the bodies coherently, correlates once, and reads back the CIR, the
power-delay profile in dB, the noise floor from the empty anti-causal
region, per-tap significance and an SNR estimate, with the JAX package's
types (numpy arrays and floats).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..utils.sequences import zadoff_chu

__all__ = ["sound", "estimate_cir"]


def sound(length: int = 255, root: int = 7, cp: int = 64,
          repeats: int = 1, device=None) -> torch.Tensor:
    """Build the sounding waveform: [CP | ZC body] x repeats (complex64, on
    ``device``).

    length: ZC length (odd for ideal autocorrelation); cp: cyclic prefix
    covering the longest expected channel delay; repeats: coherent
    averaging factor (SNR gain 10 log10(repeats) dB).
    """
    if length % 2 == 0:
        raise ValueError("ZC length must be odd (ideal autocorrelation)")
    if not 0 <= cp < length:
        raise ValueError("cp in [0, length)")
    z = np.asarray(zadoff_chu(root, length))
    one = np.concatenate([z[length - cp:], z]) if cp else z
    return torch.from_numpy(np.tile(one, max(int(repeats), 1)).astype(
        np.complex64)).to(resolve_device(device))


def estimate_cir(rx, length: int = 255, root: int = 7, cp: int = 64,
                 repeats: int = 1, max_delay: int | None = None):
    """Received sounding burst -> (cir, info), computed where ``rx`` lies
    (numpy on the CPU).

    rx: samples starting at the burst (synchronize upstream).  Returns cir
    (max_delay,) complex numpy (tap k = gain at delay k samples; complex128
    for a 64-bit input) and info with the power-delay profile in dB, the
    estimated noise floor, and per-tap significance.  Coherent averaging
    across ``repeats`` bodies.
    """
    length = int(length)
    cp = int(cp)
    if repeats < 1:
        raise ValueError("repeats must be >= 1")
    max_delay = int(max_delay if max_delay is not None
                    else min(cp or 64, length // 2))
    if max_delay > length // 2:
        raise ValueError("max_delay must be <= length/2 (ZC ambiguity)")
    rx = torch.as_tensor(rx)
    period = length + cp
    need = period * repeats
    if rx.shape[-1] < need:
        raise ValueError(f"need {need} samples, got {rx.shape[-1]}")
    cdt = torch.promote_types(rx.dtype, torch.complex64)
    rx = rx.to(cdt)
    z = torch.from_numpy(np.asarray(zadoff_chu(root, length))).to(
        rx.device, cdt)
    # average the bodies coherently, then ONE circular correlation:
    # corr = IFFT(FFT(body) * conj(FFT(z))) / length
    bodies = rx[: need].reshape(repeats, period)[:, cp:]
    body = torch.mean(bodies, dim=0)
    C = torch.fft.fft(body) * torch.conj(torch.fft.fft(z))
    corr = torch.fft.ifft(C) / length
    cir = corr[:max_delay]
    # noise floor from the guaranteed-empty delay region (the second
    # half of the circle is the anti-causal side, empty after CP sync)
    floor_region = corr[length // 2: length // 2 + length // 4]
    noise = float(torch.mean(torch.abs(floor_region) ** 2))
    p = torch.abs(cir) ** 2
    pdp_db = 10.0 * torch.log10(torch.clamp(p, min=1e-30))
    info = {
        "pdp_db": pdp_db.cpu().numpy(),
        "noise_floor_db": float(10.0 * np.log10(noise + 1e-30)),
        "significant": (p > 6.0 * noise).cpu().numpy(),
        "snr_db": float(10.0 * np.log10(
            float(torch.sum(p)) / (noise * max_delay + 1e-30) + 1e-30)),
    }
    return cir.cpu().numpy(), info
