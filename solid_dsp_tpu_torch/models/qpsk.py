"""QPSK modem: mapping, slicing and block carrier recovery.

Port of ``solid_dsp_tpu/models/qpsk.py``: the Gray map, bit/symbol
conversion, modulation, hard slicing, the block carrier recovery
(``qpsk_carrier_block``: 4th power, one FFT to find the carrier line,
parabolic refinement, linear phase fit, derotation), the block demodulator
and the symbol error rate.  The decision-directed Costas loop
``qpsk_carrier_pll`` is a sequential scan that the receive chain does not
take; it is not ported yet (ROADMAP queue 1 item 7).

Every step of ``qpsk_carrier_block`` keeps the JAX package's dtypes: a
complex64 block is raised to the 4th power as (x x)(x x), its spectrum and
magnitudes stay complex64 / float32, and the frequency and phase estimates
and the derotation phase f t + phi are float32.  The derotation phase grows
with t, so a difference in the estimate grows along the block.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["GRAY_MAP", "bits_to_symbols", "symbols_to_bits",
           "qpsk_modulate_symbols", "qpsk_slice", "qpsk_carrier_block",
           "qpsk_demodulate", "symbol_error_rate"]

# Gray-coded constellation: 2 bits -> unit-energy QPSK point
GRAY_MAP = np.array([1 + 1j, -1 + 1j, 1 - 1j, -1 - 1j],
                    dtype=np.complex128) / np.sqrt(2.0)


def bits_to_symbols(bits: torch.Tensor) -> torch.Tensor:
    """Pairs of bits (MSB first) -> symbol indices 0..3 (int32)."""
    b = bits.reshape(*bits.shape[:-1], -1, 2)
    return (b[..., 0] * 2 + b[..., 1]).to(torch.int32)


def symbols_to_bits(symbols: torch.Tensor) -> torch.Tensor:
    b0 = (symbols >> 1) & 1
    b1 = symbols & 1
    return torch.stack([b0, b1], dim=-1).reshape(*symbols.shape[:-1], -1)


def qpsk_modulate_symbols(symbols: torch.Tensor) -> torch.Tensor:
    """Symbol indices -> constellation points (complex128)."""
    return torch.as_tensor(GRAY_MAP, device=symbols.device)[symbols.long()]


def qpsk_slice(x: torch.Tensor) -> torch.Tensor:
    """Hard decision back to symbol indices (inverse of the Gray map)."""
    b0 = (x.real < 0).to(torch.int32)
    b1 = (x.imag < 0).to(torch.int32)
    return b0 + 2 * b1


def _f(v: float, rdtype: torch.dtype) -> float:
    """A host constant rounded to the working real dtype (JAX's weak-typed
    Python scalars take the array's dtype)."""
    return float(np.float64(v) if rdtype == torch.float64 else np.float32(v))


def qpsk_carrier_block(x: torch.Tensor):
    """Block carrier recovery via the 4th-power spectral line.

    x (..., n): each row its own block.  Returns (y, f_hat, phi_hat):
    derotated samples plus the frequency (rad/sample) and phase estimates
    of each row.  The phase keeps QPSK's pi/2 ambiguity.
    """
    n = int(x.shape[-1])
    rdtype = x.real.dtype
    x2 = x * x
    x4 = x2 * x2
    mag = torch.abs(torch.fft.fft(x4, dim=-1))
    k = torch.argmax(mag, dim=-1)

    def at(idx):
        return torch.gather(mag, -1, (idx % n)[..., None])[..., 0]

    a, b, c = at(k - 1), at(k), at(k + 1)
    denom = a - 2 * b + c
    delta = torch.where(denom.abs() > _f(1e-12, rdtype),
                        _f(0.5, rdtype) * (a - c) / denom,
                        torch.zeros((), dtype=rdtype, device=x.device))
    kf = torch.remainder(k.to(rdtype) + delta, n)
    f4 = _f(2.0 * np.pi, rdtype) * torch.where(kf > n / 2, kf - n, kf) / n
    f_hat = f4 / 4
    t = torch.arange(n, device=x.device).to(rdtype)
    ph4 = f4[..., None] * t
    z = x4 * torch.complex(torch.cos(ph4), -torch.sin(ph4))
    phi4 = torch.angle(torch.sum(z, dim=-1))
    phi_hat = phi4 / 4 + _f(np.pi / 4.0, rdtype)
    ph = f_hat[..., None] * t + phi_hat[..., None]
    y = x * torch.complex(torch.cos(ph), -torch.sin(ph))
    return y, f_hat, phi_hat


def qpsk_demodulate(x: torch.Tensor, recovery: str = "block"):
    """Carrier recovery ("block"; any other value but "pll" slices x as it
    is) -> slice.  Returns (symbols, corrected)."""
    if recovery == "block":
        y, _, _ = qpsk_carrier_block(x)
    elif recovery == "pll":
        raise NotImplementedError(
            "recovery='pll' is not ported to solid_dsp_tpu_torch yet: see "
            "ROADMAP.md queue 1 item 7 (qpsk_carrier_pll)")
    else:
        y = x
    return qpsk_slice(y), y


def symbol_error_rate(tx_symbols, rx_symbols) -> float:
    """SER with the QPSK pi/2 phase ambiguity resolved (best of 4
    rotations)."""
    tx = torch.as_tensor(np.asarray(tx_symbols))
    rx = torch.as_tensor(np.asarray(rx_symbols))
    gray = torch.as_tensor(GRAY_MAP)
    want = qpsk_slice(gray[tx.long()])
    got = gray[rx.long()]
    best = 1.0
    for r in range(4):
        rot = got * complex(np.exp(1j * np.pi / 2 * r))
        best = min(best, float((qpsk_slice(rot) != want).double().mean()))
    return best
