"""Generic linear modem: M-PSK / M-QAM / APSK map, pulse shape, slice,
demap, differential PSK and blind Viterbi & Viterbi carrier correction.

Port of ``solid_dsp_tpu/models/linear_mod.py``.  The constellations are
the same numpy tables (Gray-coded, unit energy).  Nearest-point slicing
and the max-log soft demapper both score every point with one metric
matrix m(c) = Re(y conj(c)) - |c|^2 / 2 over (..., T, M); the demapper
takes each bit's two maxima over a view of that matrix that splits the
point index at the bit (a max is exact, so the LLRs are JAX's masked
maxima).  The RRC pulse shaping and matched filter run on
``ops/fir.py::conv1d_mxu`` with the port's ``design/firdes.py`` taps.

The functions run where their input lies; a numpy input is taken on the
CPU.  :class:`LinearModem` holds its device (the card unless told
otherwise) and moves its inputs there.  Host constants are float64 /
complex128 numpy, as the JAX package's are under 64-bit mode, and are cast
to the data's type where JAX casts them.  ``unwrap`` and ``interp``, which
torch lacks, follow ``jnp.unwrap`` and ``jnp.interp`` (clamped outside the
centres) step for step.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..design import firdes
from ..device import bind_device
from ..ops.fir import conv1d_mxu

__all__ = [
    "psk_constellation", "qam_constellation", "apsk_constellation",
    "constellation",
    "bits_to_symbols", "symbols_to_bits", "modulate_symbols",
    "slice_symbols", "demap_soft", "pulse_shape", "matched_filter",
    "LinearModem", "dpsk_modulate", "dpsk_demodulate", "vv_carrier_correct",
    "unwrap", "interp"]


def _gray(n: int) -> np.ndarray:
    k = np.arange(n)
    return k ^ (k >> 1)


@lru_cache(maxsize=32)
def psk_constellation(m: int) -> np.ndarray:
    """Gray-coded M-PSK points, unit energy; index = symbol value."""
    if m < 2 or m & (m - 1):
        raise ValueError("M-PSK order must be a power of two >= 2")
    pts = np.empty(m, dtype=np.complex128)
    phase = 2.0 * np.pi * np.arange(m) / m + (np.pi / 4.0 if m == 4 else 0.0)
    pts[_gray(m)] = np.exp(1j * phase)
    return pts


@lru_cache(maxsize=32)
def qam_constellation(m: int) -> np.ndarray:
    """Gray-coded square M-QAM, unit average energy."""
    side = int(np.sqrt(m))
    if side * side != m or side < 2 or side & (side - 1):
        raise ValueError("M-QAM order must be 4^k (4, 16, 64, 256, ...)")
    levels = 2.0 * np.arange(side) - (side - 1)
    pts = np.empty(m, dtype=np.complex128)
    gray = _gray(side)
    bits_per_axis = int(np.log2(side))
    for i in range(side):       # I index (high bits)
        for q in range(side):   # Q index (low bits)
            sym = (gray[i] << bits_per_axis) | gray[q]
            pts[sym] = levels[i] + 1j * levels[q]
    return pts / np.sqrt(np.mean(np.abs(pts) ** 2))


@lru_cache(maxsize=8)
def apsk_constellation(m: int) -> np.ndarray:
    """DVB-S2-style M-APSK (4+12 for 16, 4+12+16 for 32), unit energy,
    with the JAX package's ring radii and bit labelling."""
    if m == 16:
        rings = [(4, 1.0, np.pi / 4), (12, 2.7, np.pi / 12)]
    elif m == 32:
        rings = [(4, 1.0, np.pi / 4), (12, 2.84, np.pi / 12),
                 (16, 5.27, 0.0)]
    else:
        raise ValueError("APSK order must be 16 or 32")
    pts = []
    for n_pts, radius, phase0 in rings:
        ph = phase0 + 2.0 * np.pi * np.arange(n_pts) / n_pts
        ring = radius * np.exp(1j * ph)
        seg = np.empty(n_pts, np.complex128)
        if n_pts & (n_pts - 1):          # 12-ring: no Gray code exists
            seg[:] = ring
        else:
            seg[_gray(n_pts)] = ring
        pts.append(seg)
    pts = np.concatenate(pts)
    return pts / np.sqrt(np.mean(np.abs(pts) ** 2))


def constellation(scheme: str, m: int) -> np.ndarray:
    if scheme == "psk":
        return psk_constellation(m)
    if scheme == "qam":
        return qam_constellation(m)
    if scheme == "apsk":
        return apsk_constellation(m)
    raise ValueError(f"unknown scheme {scheme!r}")


def _points(points, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """The constellation as a tensor on ``like``'s device (in ``dtype``)."""
    c = torch.as_tensor(points, device=like.device)
    return c if dtype is None else c.to(dtype)


def bits_to_symbols(bits, bits_per_symbol: int) -> torch.Tensor:
    """Pack a bit stream (length divisible by k) into symbol values, MSB
    first (int32; every leading axis is flattened, as in JAX)."""
    bits = torch.as_tensor(bits).to(torch.int32)
    k = int(bits_per_symbol)
    weights = torch.as_tensor(1 << np.arange(k - 1, -1, -1),
                              device=bits.device).to(torch.int32)
    return torch.sum(bits.reshape(-1, k) * weights, dim=-1,
                     dtype=torch.int32)


def symbols_to_bits(symbols, bits_per_symbol: int) -> torch.Tensor:
    """Symbol values -> their bits, MSB first, flattened (int32)."""
    symbols = torch.as_tensor(symbols).to(torch.int32)
    k = int(bits_per_symbol)
    shifts = torch.as_tensor(np.arange(k - 1, -1, -1),
                             device=symbols.device).to(torch.int32)
    return ((symbols[..., None] >> shifts) & 1).reshape(-1)


def modulate_symbols(symbols, points) -> torch.Tensor:
    """Symbol values -> constellation points (a gather, complex128 for the
    numpy tables)."""
    symbols = torch.as_tensor(symbols)
    return _points(points, symbols)[symbols.long()]


def _metric(y: torch.Tensor, points) -> torch.Tensor:
    """m(c) = Re(y conj(c)) - |c|^2 / 2 over (..., T, M), in y's type."""
    c = _points(points, y, y.dtype)
    return ((y[..., None] * torch.conj(c)).real
            - 0.5 * (c * torch.conj(c)).real)


def slice_symbols(y, points) -> torch.Tensor:
    """Nearest-constellation-point decision: argmax of the metric matrix
    (the first maximum, as ``jnp.argmax``), int32."""
    y = torch.as_tensor(y)
    return torch.argmax(_metric(y, points), dim=-1).to(torch.int32)


def demap_soft(y, points, noise_var=1.0) -> torch.Tensor:
    """Max-log bit LLRs, positive favouring bit 0:
    LLR_i = (2 / noise_var) (max_{b_i = 0} m - max_{b_i = 1} m).
    Returns (T * k,) LLRs, bit order as :func:`symbols_to_bits`."""
    y = torch.as_tensor(y)
    metric = _metric(y, points)
    m = int(metric.shape[-1])
    k = int(np.log2(m))
    lead = metric.shape[:-1]
    llrs = []
    for i in range(k):
        # point index = a 2^(k-i) + b_i 2^(k-1-i) + r: split at bit i
        v = metric.reshape(*lead, 1 << i, 2, 1 << (k - 1 - i))
        llrs.append(torch.amax(v[..., 0, :], dim=(-2, -1))
                    - torch.amax(v[..., 1, :], dim=(-2, -1)))
    scale = 2.0 / torch.as_tensor(noise_var, dtype=metric.dtype,
                                  device=y.device)
    return (torch.stack(llrs, dim=-1) * scale).reshape(-1)


def _rrc(sps: int, delay_symbols: int, rolloff: float, like: torch.Tensor,
         dtype) -> torch.Tensor:
    return torch.as_tensor(firdes.firdes_rrcos(sps, delay_symbols, rolloff),
                           device=like.device).to(dtype)


def pulse_shape(iq_symbols, sps: int, delay_symbols: int = 6,
                rolloff: float = 0.35, dtype=torch.complex64,
                flush: bool = False) -> torch.Tensor:
    """Ideal RRC pulse shaping: zero-stuff by ``sps``, then one sliding
    correlation with the RRC taps.  ``flush=False``: n * sps samples, the
    last 2 delay_symbols symbols' pulses cut (streaming); ``flush=True``:
    2 delay_symbols zero symbols shaped after the payload, so every pulse
    is emitted ((n + 2 delay) sps samples, a burst)."""
    iq = torch.as_tensor(iq_symbols).to(dtype)
    lead = iq.shape[:-1]
    if flush:
        iq = torch.cat([iq, iq.new_zeros((*lead, 2 * delay_symbols))], -1)
    rrc = _rrc(sps, delay_symbols, rolloff, iq, dtype)
    up = iq.new_zeros((*lead, iq.shape[-1] * sps))
    up[..., ::sps] = iq
    x_ext = torch.cat([iq.new_zeros((*lead, rrc.shape[0] - 1)), up], -1)
    return conv1d_mxu(x_ext, rrc)


def matched_filter(x, sps: int, delay_symbols: int = 6,
                   rolloff: float = 0.35) -> torch.Tensor:
    """Receive RRC (matched) filter at the full input rate."""
    x = torch.as_tensor(x)
    rrc = _rrc(sps, delay_symbols, rolloff, x, x.dtype)
    x_ext = torch.cat([x.new_zeros((*x.shape[:-1], rrc.shape[0] - 1)), x],
                      -1)
    return conv1d_mxu(x_ext, rrc)


class LinearModem:
    """M-PSK / M-QAM / APSK modem with RRC shaping, on ``device`` (the card
    unless told otherwise).

    modulate(bits) -> IQ at sps samples a symbol (a flushed burst);
    demodulate(iq) -> (bits, symbols) with matched filtering and the
    combined TX+RX RRC group delay compensated.  Carrier and timing
    offsets are corrected upstream.
    """

    def __init__(self, scheme: str = "qam", m: int = 16, sps: int = 4,
                 delay_symbols: int = 6, rolloff: float = 0.35,
                 dtype=torch.complex64, device=None):
        self.points = constellation(scheme, m)
        self.scheme = scheme
        self.m = int(m)
        self.k = int(np.log2(m))
        self.sps = int(sps)
        self.delay_symbols = int(delay_symbols)
        self.rolloff = float(rolloff)
        self.dtype = dtype
        self.device = bind_device(device)

    def modulate(self, bits) -> torch.Tensor:
        """bits -> (n_symbols + 2 delay_symbols) sps burst samples."""
        syms = bits_to_symbols(torch.as_tensor(bits).to(self.device), self.k)
        iq = modulate_symbols(syms, self.points).to(self.dtype)
        return pulse_shape(iq, self.sps, self.delay_symbols, self.rolloff,
                           self.dtype, flush=True)

    def _symbol_estimates(self, x) -> torch.Tensor:
        x = torch.as_tensor(x).to(self.device, self.dtype)
        y = matched_filter(x, self.sps, self.delay_symbols, self.rolloff)
        # combined TX+RX RRC delay = 2 delay_symbols sps samples
        y_sym = y[..., 2 * self.delay_symbols * self.sps::self.sps]
        # energy-normalise to the unit-average-energy constellations
        return y_sym / torch.sqrt(
            torch.mean((y_sym * torch.conj(y_sym)).real) + 1e-30)

    def demodulate(self, x):
        y_sym = self._symbol_estimates(x)
        syms = slice_symbols(y_sym, self.points)
        return symbols_to_bits(syms, self.k), syms

    def demodulate_soft(self, x, noise_var=None) -> torch.Tensor:
        """Bit LLRs (positive favours 0); ``noise_var`` None estimates it
        from the decision residual E|y - c_hard|^2."""
        y_sym = self._symbol_estimates(x)
        if noise_var is None:
            c = _points(self.points, y_sym, y_sym.dtype)
            r = y_sym - c[slice_symbols(y_sym, self.points).long()]
            noise_var = torch.mean((r * torch.conj(r)).real) + 1e-12
        return demap_soft(y_sym, self.points, noise_var)

    def __repr__(self):
        return (f"LinearModem [{self.scheme}{self.m}] [sps={self.sps}] "
                f"[delay={self.delay_symbols}] [rolloff={self.rolloff}]")


# ---------------------------------------------------- differential PSK

def _check_dpsk(m: int) -> int:
    if m < 2 or m & (m - 1):
        raise ValueError("DPSK order must be a power of two >= 2")
    return int(np.log2(m))


def dpsk_modulate(bits, m: int = 4) -> torch.Tensor:
    """Differential M-PSK: each k-bit group Gray-selects a phase step
    2 pi g / m; the phase indices are the cumulative sum mod m.  A leading
    reference symbol (phase 0) is prepended: n_symbols + 1 complex64."""
    k = _check_dpsk(m)
    sym = bits_to_symbols(bits, k)
    slots = torch.as_tensor(_gray(m), device=sym.device).to(torch.int32)
    idx = torch.cumsum(slots[sym.long()], dim=0) % m
    phase = 2.0 * np.pi * idx.to(torch.float32) / m
    ref = torch.ones(1, dtype=torch.complex64, device=sym.device)
    return torch.cat([ref, torch.exp(1j * phase).to(torch.complex64)])


def dpsk_demodulate(y, m: int = 4) -> torch.Tensor:
    """Noncoherent differential detection: d[n] = y[n+1] conj(y[n]), the
    nearest multiple of 2 pi / m, inverse-Gray-mapped to bits.
    y (n_symbols + 1,) -> (n_symbols log2(m),) hard bits."""
    k = _check_dpsk(m)
    y = torch.as_tensor(y)
    d = y[1:] * torch.conj(y[:-1])
    slot = torch.round(torch.angle(d) * m / (2.0 * np.pi)).to(
        torch.int32) % m
    inv = np.zeros(m, np.int32)
    inv[_gray(m)] = np.arange(m)
    sym = torch.as_tensor(inv, device=y.device)[slot.long()]
    return symbols_to_bits(sym, k)


# ------------------------------------- blind carrier phase (V&V)

def _ipow(x: torch.Tensor, n: int) -> torch.Tensor:
    """x^n for an integer n >= 1 by repeated squaring, in the order of
    ``lax.integer_pow`` (x^4 = (x x)(x x)): torch's complex pow goes
    through exp and log."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def _fmod_floor(a: torch.Tensor, b: float) -> torch.Tensor:
    """a mod b with the divisor's sign, from fmod (as ``jnp.mod``)."""
    r = torch.fmod(a, b)
    return torch.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)


def unwrap(p: torch.Tensor, period: float = 2.0 * np.pi) -> torch.Tensor:
    """``jnp.unwrap`` along the last axis: steps larger than period / 2
    lose whole periods."""
    if p.shape[-1] == 0:
        return p
    interval = period / 2
    dd = torch.diff(p, dim=-1)
    ddmod = _fmod_floor(dd + interval, period) - interval
    ddmod = torch.where((ddmod == -interval) & (dd > 0),
                        torch.full_like(ddmod, interval), ddmod)
    ph_correct = torch.where(torch.abs(dd) < interval,
                             torch.zeros_like(dd), ddmod - dd)
    return torch.cat([p[..., :1],
                      p[..., 1:] + torch.cumsum(ph_correct, dim=-1)], -1)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor):
    """``jnp.interp``: piecewise-linear through (xp, fp), xp increasing,
    clamped to fp[0] and fp[-1] outside [xp[0], xp[-1]]."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1,
                    xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(
        np.float64 if xp.dtype == torch.float64 else np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (
        delta / torch.where(dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def vv_carrier_correct(y, m: int = 4, seg_len: int = 64):
    """Viterbi & Viterbi M-th-power carrier phase tracking (pilot-free):
    segment sums of y^m, their phases unwrapped and divided by m,
    interpolated per symbol (clamped past the first and last centres),
    derotated.  Returns (y_corrected, phase_trajectory); the estimate
    keeps the M-fold ambiguity.  The trajectory is float64, as the JAX
    package computes it under 64-bit mode (its reference rotation is a
    complex128 numpy scalar)."""
    y = torch.as_tensor(y)
    if y.dim() != 1:
        raise ValueError("vv_carrier_correct takes a 1-D symbol stream "
                         "(vmap for batches)")
    n = y.shape[-1]
    n_seg = n // seg_len
    if n_seg < 1:
        raise ValueError(f"need at least seg_len={seg_len} symbols")
    yp = _ipow(y[: n_seg * seg_len], m).reshape(n_seg, seg_len)
    s = torch.sum(yp, dim=-1)
    # the constellation's own M-th-power phase: QPSK at pi/4 + k pi/2
    # powers to -1, every other order to +1
    ref = np.pi if m == 4 else 0.0
    s = s.to(torch.promote_types(s.dtype, torch.complex128)) * complex(
        np.exp(-1j * ref))
    ph = unwrap(torch.angle(s)) / m
    centers = (torch.arange(n_seg, device=y.device, dtype=ph.dtype) + 0.5
               ) * seg_len
    traj = interp(torch.arange(n, device=y.device, dtype=ph.dtype), centers,
                  ph)
    return y * torch.exp(-1j * traj).to(y.dtype), traj
