"""Fused digital down-converter + FM discriminator: design helpers and glue.

Port of the collapsed-FM path of ``solid_dsp_tpu/ops/ddc.py``.  With u32
phase words theta(k) = theta0 + k*dtheta and decimation M, the NCO mix folds
into the filter (the one-stage DDC identity):

    y[t] = e^{-j rad(w_t)} z[t],   z[t] = sum_i h_bp[i] x[tM - D + i],
    h_bp[i] = h[i] e^{-j i drad},  w_t = w0 + t*dw (u32),

and the FM discriminator of the rotated, gained signal only needs
z[t] conj(z[t-1]) e^{-j rad(dw)}: the rotation and the positive AGC gain
cancel in the phase difference.  ``ops/cuda_ddc.py`` computes that body
(the CUDA kernel or its plain version); :func:`ddc_fm_fused` is the glue
around it: the exact first output from the carried ``fm_prev``, the energy
for the AGC, the new ``fm_prev``, tail and phase word.
"""

from __future__ import annotations

import numpy as np
import torch

from .nco import TWO_PI, U32, U32_MASK, phase_to_rad

__all__ = ["ddc_taps", "fm_first_sample", "ddc_fm_fused"]


def ddc_taps(taps: np.ndarray, dtheta: np.uint32) -> np.ndarray:
    """Bandpass tap set h[i] * e^{-j i * dtheta_rad} (complex128 host)."""
    drad = np.float64(dtheta) * (TWO_PI / U32)
    i = np.arange(len(taps), dtype=np.float64)
    return np.asarray(taps, np.complex128) * np.exp(-1j * drad * i)


def _fold_banks(Hr: np.ndarray, Hi: np.ndarray, bank_dt) -> np.ndarray:
    """Fold the complex-tap plane algebra into one bank (2, W, 2K).

    With input planes (xr, xi) of width W, ``xr @ H[0] + xi @ H[1]`` gives
    [Re(y) | Im(y)] in column blocks: Re(y) = xr@Hr - xi@Hi and
    Im(y) = xr@Hi + xi@Hr.
    """
    W, K = Hr.shape
    H = np.zeros((2, W, 2 * K), bank_dt)
    H[0, :, :K] = Hr
    H[0, :, K:] = Hi
    H[1, :, :K] = -Hi
    H[1, :, K:] = Hr
    return H


def _rot_scalar(w: torch.Tensor, rdtype: torch.dtype):
    """e^{-j rad(w)} for one phase word -> (cos, -sin), with the radians
    taken at the output precision (f32 chains in f32, f64 in f64)."""
    rad = phase_to_rad(w, rdtype)
    return torch.cos(rad), -torch.sin(rad)


def fm_first_sample(z0re, z0im, w0, prev_re, prev_im, kf):
    """Exact first FM output of a block: z0 rotated by w0 against the
    carried previous chain output (rotated, gained)."""
    scale = 1.0 / (2.0 * np.pi * float(kf))
    c0, s0 = _rot_scalar(w0, z0re.dtype)
    y0re = z0re * c0 - z0im * s0
    y0im = z0im * c0 + z0re * s0
    return torch.atan2(y0im * prev_re - y0re * prev_im,
                       y0re * prev_re + y0im * prev_im) * scale


def ddc_fm_fused(body, tail2, theta0, x2, prev_re, prev_im, gain,
                 engine: str = "auto"):
    """One block of the fused DDC + FM demodulator.

    Args:
      body: the block's constants (``ops/cuda_ddc.py::DdcFmBody``): taps,
        decimation M, phase increment, FM index.
      tail2: carried raw-input tail planes (2, n-1).
      theta0: int64 phase word of the block's first sample.
      x2: input planes (2, L), L a multiple of 64*M.
      prev_re, prev_im: carried last chain output (rotated, gained).
      gain: this block's AGC gain (real, positive).
      engine: "auto" | "cuda" | "torch" (``ops/cuda_ddc.py::DdcFmBody``).

    Returns (out, new_prev_re, new_prev_im, ee_mean, new_tail2, theta_end):
    out (L/M,) audio equal to rotate -> AGC -> fm_demodulate to float
    rounding, ee_mean = mean |z|^2 for the AGC update.
    """
    n, M = body.n, body.M
    n1 = n - 1
    L = int(x2.shape[-1])
    if L % (body.P * M):
        raise ValueError(
            f"block length {L} must be a multiple of {body.P * M} (64*M): "
            "other lengths take the K2 pieces path, which is not ported yet")
    T = L // M
    first = M - 1
    d = body.dtheta
    w0 = (theta0 + ((first * d) & U32_MASK) - ((n1 * d) & U32_MASK)) & U32_MASK
    audio, stats = body(x2, tail2[:, first:].contiguous(), engine)
    # stats = [sum |z|^2, z_last re, z_last im, z_first re, z_first im]
    # Output 0: the body's window for z[-1] is one sample short (the tail
    # carries n-1 samples); the carried fm_prev gives the exact value.  In
    # place: audio is this call's own buffer.
    audio[0] = fm_first_sample(stats[3], stats[4], w0, prev_re, prev_im,
                               body.kf)
    ee_mean = stats[0] / T
    wl = (w0 + ((body.dw * (T - 1)) & U32_MASK)) & U32_MASK
    cl, sl = _rot_scalar(wl, x2.dtype)
    g = gain.to(x2.dtype)
    new_prev_re = g * (stats[1] * cl - stats[2] * sl)
    new_prev_im = g * (stats[2] * cl + stats[1] * sl)
    new_tail2 = x2[:, L - n1:]
    theta_end = (theta0 + ((L * d) & U32_MASK)) & U32_MASK
    return audio, new_prev_re, new_prev_im, ee_mean, new_tail2, theta_end
