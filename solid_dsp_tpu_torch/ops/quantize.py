"""Quantization, companding and the ADC front-end model.

Port of ``solid_dsp_tpu/ops/quantize.py``: uniform quantizers (midrise and
midtread, saturating), the complex ADC model (clip, quantize I and Q, with
optional subtractive dither), the G.711 mu-law and A-law compressor curves
and their 8-bit codecs (segment arithmetic, no tables), and the SQNR.
Elementwise torch ops that run where their input lies.

The dither is drawn from a ``torch.Generator`` where the JAX package takes
a PRNG key: the two give different numbers, so ``dither=True`` matches JAX
in its contract (the error within +-delta/2, mean ~0, independent of the
signal), not bit for bit.  The 8-bit codes are uint8, as JAX's are.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["quantize_uniform", "adc_model", "mulaw_compress",
           "mulaw_expand", "alaw_compress", "alaw_expand",
           "mulaw_encode", "mulaw_decode", "alaw_encode", "alaw_decode",
           "sqnr"]

_MU = 255.0
_A = 87.6


def quantize_uniform(x: torch.Tensor, bits: int, full_scale: float = 1.0,
                     mode: str = "midrise") -> torch.Tensor:
    """Uniform quantizer of ``bits`` bits on [-full_scale, full_scale],
    saturating at the rails: "midrise" (levels at odd multiples of
    delta/2, as ADCs have) or "midtread" (zero a level).  Real tensors."""
    if bits < 1:
        raise ValueError("bits must be >= 1")
    if mode not in ("midrise", "midtread"):
        raise ValueError(f"unknown mode {mode!r}")
    x = torch.as_tensor(x)
    levels = 1 << bits
    delta = 2.0 * full_scale / levels
    if mode == "midrise":
        q = torch.floor(x / delta) + 0.5
        q = torch.clamp(q, -(levels // 2) + 0.5, levels // 2 - 0.5)
    else:
        q = torch.round(x / delta)
        q = torch.clamp(q, -(levels // 2), levels // 2 - 1)
    return (q * delta).to(x.dtype)


def adc_model(x: torch.Tensor, bits: int = 12, full_scale: float = 1.0,
              dither: bool = False,
              generator: torch.Generator | None = None) -> torch.Tensor:
    """Complex (or real) ADC: clip to the rails, midrise-quantize I and Q.
    ``dither=True`` adds uniform dither of +-delta/2 from ``generator`` (a
    ``torch.Generator`` on x's device, required) and subtracts it again
    after the quantizer, which makes the error uniform, white and
    independent of the signal."""
    x = torch.as_tensor(x)
    i, q = (x.real, x.imag) if x.is_complex() else (x, None)
    delta = 2.0 * full_scale / (1 << bits)
    di = dq = None
    if dither:
        if generator is None:
            raise ValueError("dither=True requires a torch.Generator")

        def draw(like):
            u = torch.rand(like.shape, generator=generator, dtype=like.dtype,
                           device=like.device)
            return (u - 0.5) * delta
        di = draw(i)
        i = i + di
        if q is not None:
            dq = draw(q)
            q = q + dq
    i = quantize_uniform(torch.clamp(i, -full_scale, full_scale), bits,
                         full_scale)
    if di is not None:
        i = i - di
    if q is None:
        return i
    q = quantize_uniform(torch.clamp(q, -full_scale, full_scale), bits,
                         full_scale)
    if dq is not None:
        q = q - dq
    return torch.complex(i, q)


def mulaw_compress(x: torch.Tensor, mu: float = _MU) -> torch.Tensor:
    """sign(x) ln(1 + mu|x|) / ln(1 + mu), |x| <= 1."""
    x = torch.as_tensor(x)
    return torch.sgn(x) * torch.log1p(mu * torch.abs(x)) / np.log1p(mu)


def mulaw_expand(y: torch.Tensor, mu: float = _MU) -> torch.Tensor:
    """The inverse of :func:`mulaw_compress`."""
    y = torch.as_tensor(y)
    return torch.sgn(y) * (torch.exp(torch.abs(y) * np.log1p(mu)) - 1.0) / mu


def alaw_compress(x: torch.Tensor, A: float = _A) -> torch.Tensor:
    """The continuous A-law curve (ITU G.711), |x| <= 1."""
    x = torch.as_tensor(x)
    ax = torch.abs(x)
    denom = 1.0 + np.log(A)
    small = A * ax / denom
    large = (1.0 + torch.log(torch.clamp(A * ax, min=1.0))) / denom
    return torch.sgn(x) * torch.where(ax < 1.0 / A, small, large)


def alaw_expand(y: torch.Tensor, A: float = _A) -> torch.Tensor:
    """The inverse of :func:`alaw_compress`."""
    y = torch.as_tensor(y)
    ay = torch.abs(y)
    denom = 1.0 + np.log(A)
    small = ay * denom / A
    large = torch.exp(ay * denom - 1.0) / A
    return torch.sgn(y) * torch.where(ay < 1.0 / denom, small, large)


def _code(exp: torch.Tensor, mant: torch.Tensor) -> torch.Tensor:
    return (exp * 16.0 + mant).to(torch.uint8)


def mulaw_encode(x: torch.Tensor) -> torch.Tensor:
    """G.711 mu-law codec: float in [-1, 1] -> uint8 codewords (bias 33, 8
    chords of 16 steps on the 14-bit magnitude, all bits inverted)."""
    x = torch.as_tensor(x)
    mag = torch.clamp(torch.abs(x) * 8159.0, 0, 8159.0) + 33.0
    exp = torch.clamp(torch.floor(torch.log2(mag)) - 5.0, 0.0, 7.0)
    mant = torch.clamp(torch.floor(mag / torch.exp2(exp + 1.0)) - 16.0,
                       0.0, 15.0)
    sign = (x < 0).to(torch.uint8) * 0x80
    return (_code(exp, mant) | sign) ^ 0xFF


def mulaw_decode(code: torch.Tensor) -> torch.Tensor:
    """uint8 mu-law codewords -> float32 in [-1, 1]."""
    c = torch.as_tensor(code).to(torch.uint8) ^ 0xFF
    sign = torch.where((c & 0x80) != 0, -1.0, 1.0)
    c = (c & 0x7F).to(torch.float32)
    exp = torch.floor(c / 16.0)
    mant = c - exp * 16.0
    mag = (mant * 2.0 + 33.0) * torch.exp2(exp) - 33.0
    # a product with the float32 reciprocal: XLA compiles JAX's / 8159.0
    # so, and the decoded values are bit-equal to its
    return sign * mag * (1.0 / 8159.0)


def alaw_encode(x: torch.Tensor) -> torch.Tensor:
    """G.711 A-law codec: float in [-1, 1] -> uint8 codewords (13-bit
    magnitude, even bits inverted)."""
    x = torch.as_tensor(x)
    mag = torch.clamp(torch.abs(x) * 4096.0, 0, 4095.0)
    exp = torch.clamp(torch.floor(torch.log2(torch.clamp(mag, min=1.0)))
                      - 4.0, 0.0, 7.0)
    mant = torch.where(exp < 1.0, torch.floor(mag / 2.0),
                       torch.floor(mag / torch.exp2(exp)) - 16.0)
    mant = torch.clamp(mant, 0.0, 15.0)
    sign = (x >= 0).to(torch.uint8) * 0x80
    return (_code(exp, mant) | sign) ^ 0x55


def alaw_decode(code: torch.Tensor) -> torch.Tensor:
    """uint8 A-law codewords -> float32 in [-1, 1]."""
    c = torch.as_tensor(code).to(torch.uint8) ^ 0x55
    sign = torch.where((c & 0x80) != 0, 1.0, -1.0)
    c = (c & 0x7F).to(torch.float32)
    exp = torch.floor(c / 16.0)
    mant = c - exp * 16.0
    mag = torch.where(exp < 1.0, mant * 2.0 + 1.0,
                      (mant * 2.0 + 33.0) * torch.exp2(exp - 1.0))
    return sign * mag / 4096.0


def sqnr(x: torch.Tensor, xq: torch.Tensor) -> torch.Tensor:
    """Signal-to-quantization-noise ratio in dB along the last axis."""
    x = torch.as_tensor(x)
    err = torch.as_tensor(xq) - x
    ps = torch.sum(torch.abs(x) ** 2, dim=-1)
    pn = torch.clamp(torch.sum(torch.abs(err) ** 2, dim=-1),
                     min=torch.finfo(torch.abs(err).dtype).tiny)
    return 10.0 * torch.log10(ps / pn)
