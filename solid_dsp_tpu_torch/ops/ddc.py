"""Fused digital down-converter: design helpers, the plain body and glue.

Port of ``solid_dsp_tpu/ops/ddc.py``.  With u32 phase words
theta(k) = theta0 + k*dtheta and decimation M, the NCO mix folds into the
filter (the one-stage DDC identity):

    y[t] = e^{-j rad(w_t)} z[t],   z[t] = sum_i h_bp[i] x[tM - D + i],
    h_bp[i] = h[i] e^{-j i drad},  w_t = w0 + t*dw (u32),  D = n - M.

The body z is computed by a Hopper kernel or its plain version
(``ops/cuda_ddc.py``); :func:`ddc_body_torch` here is that plain version,
the JAX module's non-Pallas pieces (head straddling the carried tail,
banded-Toeplitz frames, straggler).  Where the JAX module returns the body
as tagged pieces in TPU-lane layouts, the port returns one planar (2, T)
z [re; im], and the ``*_pieces`` epilogues are functions of that z.

The rest is glue around a body: the decimated-rate rotation
(:func:`ddc_apply_planar`), the rotation-invariant FM and AM epilogues,
the energy for the AGC, and the carried tail and phase words.  The FM
discriminator of the rotated, gained signal only needs
z[t] conj(z[t-1]) e^{-j rad(dw)}: the rotation and the positive AGC gain
cancel in the phase difference; :func:`ddc_fm_fused` is the glue around the
fused DDC + FM body (K1).

Every body and its glue takes the block either as real planes (2, L) or as
the raw interleaved int16 IQ of a ci16 recording, (L, 2): the kernels read
the int16 and scale it in registers, and the glue converts only the few
samples it reads itself (:func:`ci16_planes`, the chain's conversion), so
both forms give the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import fp32_exact
from .fir import _bank_rem_np, _banks_np
from .nco import (TWO_PI, U32, U32_MASK, nco_complex_exponential,
                  phase_to_rad)

__all__ = ["ddc_taps", "ci16_scale", "ci16_planes", "block_len",
           "ddc_body_torch", "ddc_apply_planar_pieces",
           "ddc_apply_planar_raw",
           "ddc_apply_planar", "ddc_apply", "ddc_fm_epilogue",
           "ddc_am_epilogue", "ddc_energy_pieces", "ddc_pieces_last_rotated",
           "fm_first_sample", "ddc_fm_fused"]


def ddc_taps(taps: np.ndarray, dtheta: np.uint32) -> np.ndarray:
    """Bandpass tap set h[i] * e^{-j i * dtheta_rad} (complex128 host)."""
    drad = np.float64(dtheta) * (TWO_PI / U32)
    i = np.arange(len(taps), dtype=np.float64)
    return np.asarray(taps, np.complex128) * np.exp(-1j * drad * i)


def ci16_scale(rdtype: torch.dtype) -> float:
    """The ci16 scale 1/32767 rounded to the real type: in float32 the
    constant ``k`` of the native runtime's conversion and of the kernels'
    (``csrc/ddc_tc.cuh``), so that int16 times it is the same float32
    everywhere."""
    return float((np.float64 if rdtype == torch.float64 else np.float32)(
        1.0 / 32767.0))


def ci16_planes(x: torch.Tensor, rdtype: torch.dtype, lo: int = 0,
                hi: int | None = None) -> torch.Tensor:
    """Samples [lo, hi) of the raw int16 block x (L, 2) as contiguous real
    planes (2, hi - lo) of ``rdtype``: each int16 times
    :func:`ci16_scale`, one product rounded to ``rdtype``, written straight
    into the planar layout.  (An int16 tensor times a Python float
    computes in float32 whatever the output, so a float64 block is
    widened first.)"""
    x = x[lo:hi].T
    if rdtype == torch.float64:
        x = x.to(rdtype)
    out = torch.empty(x.shape, dtype=rdtype, device=x.device)
    return torch.mul(x, ci16_scale(rdtype), out=out)


def _is_ci16(x2: torch.Tensor) -> bool:
    return x2.dtype == torch.int16


def block_len(x2: torch.Tensor) -> int:
    """Samples of a block given as planes (2, L) or as raw int16 (L, 2)."""
    return int(x2.shape[0] if _is_ci16(x2) else x2.shape[-1])


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


def _bf16(a: torch.Tensor) -> torch.Tensor:
    """a rounded to bf16 (to nearest even) and back to its dtype: the
    operands of the TPU kernels' single-pass bf16 ("fast") products."""
    return a.to(torch.bfloat16).to(a.dtype)


def _plane_dot(lhs: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """lhs (2, ..., W) x folded bank (2, W, 2K) -> (..., 2K), contracting
    the plane dim and W together."""
    return torch.matmul(lhs[0], bank[0]) + torch.matmul(lhs[1], bank[1])


def _bank(body, key, build):
    """The body's folded bank ``key`` on its device and in its dtype, built
    on the host by ``build(taps_re, taps_im, bank_dt)`` at first use; in
    the body's fast mode rounded to bf16 (from its float32 values, as the
    TPU kernel's bank)."""
    fast = body.mode == "fast"
    key = key + (fast,)
    bank = body.banks.get(key)
    if bank is None:
        dt = body.taps.dtype
        bank_dt = np.float64 if dt == torch.float64 else np.float32
        h = body.taps.cpu().numpy().astype(bank_dt)
        bank = torch.tensor(build(h[0][:, None], h[1][:, None], bank_dt),
                            dtype=dt, device=body.taps.device)
        if fast:
            bank = _bf16(bank)
        body.banks[key] = bank
    return bank


def _rem_bank(body, Tr: int) -> torch.Tensor:
    M = body.M
    return _bank(body, ("rem", Tr), lambda hr, hi, dt: _fold_banks(
        _bank_rem_np(hr, Tr, M), _bank_rem_np(hi, Tr, M), dt))


def _frame_banks(body, P: int):
    M = body.M
    body_bank = _bank(body, ("body", P), lambda hr, hi, dt: _fold_banks(
        _banks_np(hr, P, M)[0], _banks_np(hi, P, M)[0], dt))
    head_bank = _bank(body, ("head", P), lambda hr, hi, dt: _fold_banks(
        _banks_np(hr, P, M)[1], _banks_np(hi, P, M)[1], dt))
    return body_bank, head_bank


@fp32_exact()
def ddc_body_torch(body, x2: torch.Tensor, tail: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the unrotated DDC body (K2 and K3), and the
    counterpart of the JAX module's XLA body where no kernel takes the
    taps or the dtype (float64; n > 64*M + 1).

    ``body`` holds the taps ``(2, n)`` [re; im] of h_bp, n, M and the mode
    (``ops/cuda_ddc.py::DdcBody``); x2 is the (2, L) block, or the raw
    int16 block (L, 2) (converted by :func:`ci16_planes` once: the frames
    read every sample), L any multiple of M, and tail the carried
    x[-D .. -1], (2, D), D = max(n - M, 0).
    Returns z (2, L / M).  The pieces of the JAX module's XLA path, in its
    order: the first outputs, whose windows straddle the tail, as one
    small matmul (none for n <= M); whole frames of P outputs as
    banded-Toeplitz matmuls on the free frame view plus the next frame's
    head; the straggler outputs past the last frame.  Every product is a
    float32 (or float64) matmul, run with TF32 off (``device.fp32_exact``)
    whatever the caller set; the fast mode rounds the samples, the tail
    and the banks to bf16 first (the TPU's single-pass bf16, in the
    kernels and in the XLA pieces alike).
    """
    n, M = body.n, body.M
    n1 = n - 1
    first = M - 1                # decimator phase 0
    _check_x2(x2, M)
    if _is_ci16(x2):
        x2 = ci16_planes(x2, body.taps.dtype)
    L = int(x2.shape[-1])
    D = max(n - M, 0)
    if tuple(tail.shape) != (2, D):
        raise ValueError(f"tail must be (2, {D}), got {tuple(tail.shape)}")
    if body.mode == "fast":
        x2, tail = _bf16(x2), _bf16(tail)
    T = L // M
    pieces = []
    # head outputs whose windows straddle the carried tail
    Th = min(max(-(-(n1 - first) // M), 0), T)
    if Th > 0:
        from_x = (Th - 1) * M + n - (n1 - first)
        zhead = torch.cat([tail, x2[:, :from_x]], dim=1)
        pieces.append(_plane_dot(zhead, _rem_bank(body, Th)).reshape(2, Th))
    # whole frames of P outputs, aligned to x
    start = first + Th * M - n1
    Tb = T - Th
    P = max(min(64, max((4 * n) // M, 8), max(Tb, 1)),
            max(-(-n1 // M), 1))
    hop = P * M
    Fb = min(max((L - start - n1) // hop, 0), Tb // P) if Tb > 0 else 0
    if Fb > 0:
        body_bank, head_bank = _frame_banks(body, P)
        frames = x2[:, start : start + Fb * hop].reshape(2, Fb, hop)
        y = _plane_dot(frames, body_bank)
        if n1 > 0:
            heads = x2[:, start + hop :].unfold(1, n1, hop)[:, :Fb]
            y = y + _plane_dot(heads, head_bank)
        pieces.append(y.reshape(Fb, 2, P).transpose(0, 1).reshape(2, Fb * P))
    # straggler outputs past the last whole frame
    Trem = Tb - Fb * P
    if Trem > 0:
        srem = start + Fb * hop
        zrem = x2[:, srem : srem + (Trem - 1) * M + n]
        pieces.append(_plane_dot(zrem, _rem_bank(body, Trem))
                      .reshape(2, Trem))
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=1)


def _check_x2(x2: torch.Tensor, quantum: int):
    """ValueError unless x2 is planes (2, L) or raw int16 (L, 2) with L a
    positive multiple of ``quantum``."""
    L = block_len(x2)
    shape = (L, 2) if _is_ci16(x2) else (2, L)
    if x2.dim() != 2 or tuple(x2.shape) != shape or L % quantum or L == 0:
        raise ValueError(f"x2 must be (2, L) planes or (L, 2) int16 with L a "
                         f"positive multiple of {quantum}, got "
                         f"{tuple(x2.shape)} {x2.dtype}")


def _phase_words(body, theta0: torch.Tensor, L: int):
    """(w0, theta_end): the rotation word of output 0,
    theta0 + (M-1)*d - (n-1)*d, and the block's end phase theta0 + L*d,
    both wrapping as u32 (int64 masked to 32 bits)."""
    d = body.dtheta
    w0 = (theta0 + (((body.M - 1) * d) & U32_MASK)
          - (((body.n - 1) * d) & U32_MASK)) & U32_MASK
    theta_end = (theta0 + ((L * d) & U32_MASK)) & U32_MASK
    return w0, theta_end


def _new_tail(tail2: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """The last n-1 raw samples after this block: a short block keeps part
    of the old tail.  A raw int16 block converts only those samples; the
    tail stays real planes (chain state)."""
    n1 = int(tail2.shape[-1])
    L = block_len(x2)
    if _is_ci16(x2):
        new = ci16_planes(x2, tail2.dtype, max(L - n1, 0))
        return new if L >= n1 else torch.cat([tail2[:, L:], new], dim=1)
    if L >= n1:
        return x2[:, L - n1 :]
    return torch.cat([tail2[:, L:], x2], dim=1)


def ddc_apply_planar_pieces(body, tail2, theta0, x2, engine: str = "auto"):
    """Unrotated fused-DDC body on input planes.

    Args:
      body: the body's constants (``ops/cuda_ddc.py::DdcBody``), which pick
        the kernel or the plain version from ``engine`` and the device.
      tail2: carried raw-input tail planes (2, n-1).
      theta0: int64 phase word of the block's first sample.
      x2: input planes (2, L), or the raw int16 block (L, 2), L a multiple
        of M (any length, short blocks included).

    Returns (z, new_tail2, theta_end, w0, dw): the true DDC output is
    y[t] = (z[0, t] + j z[1, t]) e^{-j rad(w_t)}, w_t = w0 + t*dw.  The
    JAX function returns the body as tagged pieces in TPU-lane layouts;
    here the body is one planar z (2, L / M).
    """
    z = body(x2, tail2[:, body.M - 1 :].contiguous(), engine)
    w0, theta_end = _phase_words(body, theta0, block_len(x2))
    return z, _new_tail(tail2, x2), theta_end, w0, body.dw


def ddc_apply_planar_raw(body, tail2, theta0, x2, engine: str = "auto"):
    """:func:`ddc_apply_planar_pieces` with the body as two rows: returns
    (yre, yim, new_tail2, theta_end, w0, dw)."""
    z, new_tail2, theta_end, w0, dw = ddc_apply_planar_pieces(
        body, tail2, theta0, x2, engine)
    return z[0], z[1], new_tail2, theta_end, w0, dw


def ddc_apply_planar(body, tail2, theta0, x2, engine: str = "auto",
                     rot_mode: str = "fast"):
    """One fused DDC block on input planes: the body, then the
    decimated-rate rotation by e^{-j rad(w_t)} (``rot_mode`` "fast", the
    factorized oscillator, or "exact").  Returns
    (out_re, out_im, new_tail2, theta_end), out equal to the exact mix
    followed by the decimating FIR to float rounding."""
    yre, yim, new_tail2, theta_end, w0, dw = ddc_apply_planar_raw(
        body, tail2, theta0, x2, engine)
    rot = nco_complex_exponential(w0, dw, int(yre.shape[-1]), mode=rot_mode)
    c = rot.real.to(yre.dtype)
    s = rot.imag.to(yre.dtype)
    return yre * c + yim * s, yim * c - yre * s, new_tail2, theta_end


def ddc_apply(body, tail, theta0, x, engine: str = "auto",
              rot_mode: str = "fast"):
    """Complex-in, complex-out :func:`ddc_apply_planar`: ``tail`` is the
    carried complex raw-input tail (n-1,), ``x`` the complex block (L,).
    Returns (y, new_tail, theta_end)."""
    tail2 = torch.stack([tail.real, tail.imag])
    x2 = torch.stack([x.real, x.imag])
    out_re, out_im, new_tail2, theta_end = ddc_apply_planar(
        body, tail2, theta0, x2, engine, rot_mode)
    return (torch.complex(out_re, out_im).to(x.dtype),
            torch.complex(new_tail2[0], new_tail2[1]).to(x.dtype), theta_end)


def _rot_scalar(w: torch.Tensor, rdtype: torch.dtype):
    """e^{-j rad(w)} for one phase word -> (cos, -sin), with the radians
    taken at the output precision (f32 chains in f32, f64 in f64)."""
    rad = phase_to_rad(w, rdtype)
    return torch.cos(rad), -torch.sin(rad)


def _last_rotated(zre, zim, w0, dw: int, T: int, gain):
    """g * z[T-1] * e^{-j rad(w0 + (T-1) dw)} for the block's last raw body
    sample -> (re, im): the chain's ``fm_prev`` carry."""
    c, s = _rot_scalar((w0 + ((dw * (T - 1)) & U32_MASK)) & U32_MASK,
                       zre.dtype)
    g = gain.to(zre.dtype)
    return g * (zre * c - zim * s), g * (zim * c + zre * s)


def ddc_pieces_last_rotated(z: torch.Tensor, w0, dw: int, gain):
    """Gained, rotated last output of the block from its raw body z
    (2, T): the chain's ``fm_prev`` carry.  The JAX function takes the
    body's pieces; here it takes the one planar z."""
    return _last_rotated(z[0, -1], z[1, -1], w0, dw, int(z.shape[-1]), gain)


def ddc_energy_pieces(z: torch.Tensor) -> torch.Tensor:
    """mean |z|^2 over the block (= mean |y|^2: |rot| = 1).  The JAX
    function sums over the body's pieces; here over the one planar z."""
    return torch.sum(z * z) / z.shape[-1]


def ddc_fm_epilogue(yre, yim, w0, dw: int, prev_re, prev_im, kf, gain):
    """FM discriminator straight off the unrotated body output.

    The rotation and the real, positive AGC gain cancel in the phase
    difference: (g y[t]) conj(g y[t-1]) = g^2 z[t] conj(z[t-1]) e^{-j drad},
    so arg needs the raw cross products and one constant rotation.  Output
    0 uses the carried previous chain output (rotated, gained).

    Returns (out, new_prev_re, new_prev_im): out equal to
    rotate -> AGC -> fm_demodulate to float rounding, and the gained,
    rotated last sample (the rotated path's ``fm_prev``).
    """
    # e^{-j drad} in float64 on the host, rounded to the output dtype
    dt = np.float64 if yre.dtype == torch.float64 else np.float32
    drad = float(np.float64(dw) * (TWO_PI / U32))
    cd, sd = float(dt(np.cos(drad))), float(dt(-np.sin(drad)))
    ure = yre[1:] * yre[:-1] + yim[1:] * yim[:-1]
    uim = yim[1:] * yre[:-1] - yre[1:] * yim[:-1]
    rest = torch.atan2(uim * cd + ure * sd, ure * cd - uim * sd)
    out = torch.cat([
        fm_first_sample(yre[0], yim[0], w0, prev_re, prev_im, kf)[None],
        rest * (1.0 / (2.0 * np.pi * float(kf)))])
    new_prev_re, new_prev_im = _last_rotated(
        yre[-1], yim[-1], w0, dw, int(yre.shape[-1]), gain)
    return out, new_prev_re, new_prev_im


def ddc_am_epilogue(yre, yim, gain):
    """AM envelope off the unrotated body output: |g z e^{-j w}| = g |z|."""
    return gain.to(yre.dtype) * torch.sqrt(yre * yre + yim * yim)


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
                 engine: str = "auto", with_seams: bool = False):
    """One block of the fused DDC + FM demodulator.

    Args:
      body: the block's constants (``ops/cuda_ddc.py::DdcFmBody``): taps,
        decimation M, phase increment, FM index.
      tail2: carried raw-input tail planes (2, n-1).
      theta0: int64 phase word of the block's first sample.
      x2: input planes (2, L), or the raw int16 block (L, 2), L a multiple
        of 64*M.
      prev_re, prev_im: carried last chain output (rotated, gained).
      gain: this block's AGC gain (real, positive).
      engine: "auto" | "cuda" | "torch" (``ops/cuda_ddc.py::DdcFmBody``).

    Returns (out, new_prev_re, new_prev_im, ee_mean, new_tail2, theta_end):
    out (L/M,) audio equal to rotate -> AGC -> fm_demodulate to float
    rounding, ee_mean = mean |z|^2 for the AGC update.  Other block lengths
    take the body and :func:`ddc_fm_epilogue` (``models/rx_chain.py``).

    ``with_seams=True`` appends (z0re, z0im, w0), the raw first body output
    and its rotation word, as the JAX function does: a caller that learns
    ``prev`` only later (the time-sharded chain receives it from its left
    neighbour) passes any prev and sets out[0] with :func:`fm_first_sample`.
    """
    M = body.M
    L = block_len(x2)
    if L % (body.P * M):
        raise ValueError(f"block length {L} must be a multiple of "
                         f"{body.P * M} (64*M) for the fused FM body")
    T = L // M
    w0, theta_end = _phase_words(body, theta0, L)
    audio, stats = body(x2, tail2[:, M - 1 :].contiguous(), engine)
    # stats = [sum |z|^2, z_last re, z_last im, z_first re, z_first im]
    # Output 0: the body's window for z[-1] is one sample short (the tail
    # carries n-1 samples); the carried fm_prev gives the exact value.  In
    # place: audio is this call's own buffer.
    audio[0] = fm_first_sample(stats[3], stats[4], w0, prev_re, prev_im,
                               body.kf)
    ee_mean = stats[0] / T
    new_prev_re, new_prev_im = _last_rotated(stats[1], stats[2], w0,
                                             body.dw, T, gain)
    out = (audio, new_prev_re, new_prev_im, ee_mean, _new_tail(tail2, x2),
           theta_end)
    return out + (stats[3], stats[4], w0) if with_seams else out
