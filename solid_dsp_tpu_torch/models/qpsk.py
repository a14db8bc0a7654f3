"""QPSK modem: mapping, slicing and block carrier recovery.

Port of ``solid_dsp_tpu/models/qpsk.py``: the Gray map, bit/symbol
conversion, modulation, hard slicing, the block carrier recovery
(``qpsk_carrier_block``: 4th power, one FFT to find the carrier line,
parabolic refinement, linear phase fit, derotation), the block demodulator
and the symbol error rate, and the decision-directed Costas loop
``qpsk_carrier_pll`` (``qpsk_demodulate(recovery="pll")``): a sequential
scan, one launch of S2 (``ops/cuda_scan.py``, ``csrc/seq_scan.cu``) on a
CUDA tensor and its plain version :func:`costas_pll_plain` on a CPU tensor.

Every step of ``qpsk_carrier_block`` keeps the JAX package's dtypes: a
complex64 block is raised to the 4th power as (x x)(x x), its spectrum and
magnitudes stay complex64 / float32, and the frequency and phase estimates
and the derotation phase f t + phi are float32.  The derotation phase grows
with t, so a difference in the estimate grows along the block.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import cuda_scan

__all__ = ["GRAY_MAP", "bits_to_symbols", "symbols_to_bits",
           "qpsk_modulate_symbols", "qpsk_slice", "qpsk_carrier_block",
           "qpsk_carrier_pll", "costas_pll_plain", "qpsk_demodulate",
           "symbol_error_rate"]

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


def costas_pll_plain(x: torch.Tensor, alpha: float, beta: float,
                     theta0: torch.Tensor, dtheta0: torch.Tensor):
    """S2's plain version: the Costas loop as a torch loop over time (the
    last axis), vectorized over the leading axes, in S2's arithmetic:
    y = x (cos theta - j sin theta), d the Gray point of y's quadrant,
    e = arg(y conj d), dtheta += alpha e, theta = (theta + dtheta) + beta e.
    Returns (y, theta_end, dtheta_end)."""
    rdt = x.real.dtype
    lead = x.shape[:-1]
    h = torch.tensor(1.0 / np.sqrt(2.0), dtype=rdt, device=x.device)
    th = theta0.to(device=x.device, dtype=rdt).expand(lead).clone()
    dth = dtheta0.to(device=x.device, dtype=rdt).expand(lead).clone()
    a, b = _f(alpha, rdt), _f(beta, rdt)
    ys = []
    for n in range(x.shape[-1]):
        xr, xi = x[..., n].real, x[..., n].imag
        c, s = torch.cos(th), torch.sin(th)
        yr = xr * c + xi * s
        yi = xi * c - xr * s
        dr = torch.where(yr < 0, -h, h)
        di = torch.where(yi < 0, -h, h)
        e = torch.atan2(yi * dr - yr * di, yr * dr + yi * di)
        dth = dth + a * e
        th = th + dth + b * e
        ys.append(torch.complex(yr, yi))
    return torch.stack(ys, dim=-1), th, dth


def qpsk_carrier_pll(x: torch.Tensor, bandwidth=0.01, theta0=0.0,
                     dtheta0=0.0):
    """Decision-directed Costas loop (exact streaming recovery) over x
    (..., T), time last, each leading index its own loop: the phase
    detector e = angle(y conj(decision(y))) and the reference NCO's
    coupling, dtheta += e alpha, theta += dtheta + e beta, alpha = bw,
    beta = sqrt(bw); theta is left unwrapped, as in the JAX package.
    Returns (y, (theta_end, dtheta_end)).  S2 on a CUDA tensor, the plain
    version on a CPU tensor."""
    alpha = float(bandwidth)
    beta = float(np.sqrt(bandwidth))
    rdt = x.real.dtype
    th0, dth0 = (t.to(device=x.device, dtype=rdt)
                 if isinstance(t, torch.Tensor)
                 else torch.full((), float(t), dtype=rdt, device=x.device)
                 for t in (theta0, dtheta0))
    if x.is_cuda:
        y, th, dth = cuda_scan.costas_pll_cuda(
            x, alpha, beta, float(1.0 / np.sqrt(2.0)), th0, dth0)
    else:
        y, th, dth = costas_pll_plain(x, alpha, beta, th0, dth0)
    return y, (th, dth)


def qpsk_demodulate(x: torch.Tensor, recovery: str = "block", **kw):
    """Carrier recovery ("block", or "pll" with ``qpsk_carrier_pll``'s
    keywords; any other value slices x as it is) -> slice.  Returns
    (symbols, corrected)."""
    if recovery == "block":
        y, _, _ = qpsk_carrier_block(x)
    elif recovery == "pll":
        y, _ = qpsk_carrier_pll(x, **kw)
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
