"""NCO: phase words, the sine LUT, mixers, the PLL coupling and the
stateful oscillator.

Port of ``solid_dsp_tpu/ops/nco.py`` (reference ``src/nco/mod.rs``):
``constrain`` (design time, numpy), ``make_sine_lut``, ``nco_phases``,
``nco_sincos`` ("lut", "lut-table", "exact"), ``nco_complex_exponential``
("lut", "exact", "fast"), ``mix_up_block`` / ``mix_down_block``,
``pll_step`` and the ``NCO`` class.  The phase sequence is closed-form,
theta[k] = theta0 + k * dtheta (mod 2^32), so a whole block is one
vectorized expression.

Where the LUT is read: the JAX package reads its 1024-entry table only on
the CPU and evaluates sin(idx * 2 pi / 1024) on the TPU, whose gather is
slow.  A 1024-entry gather is cheap on a GPU (the table sits in L1), so the
port reads the table on every device, for "lut" and "lut-table" alike:
bit-equal to the JAX package's CPU path, which is the reference's
semantics (the rounded 10-bit index, cos = LUT[idx + 256]).

torch has no general uint32 arithmetic, so phase words are int64 tensors
kept in [0, 2^32) by masking with ``& 0xFFFFFFFF`` after every operation
(exact: the products stay below 2^63 for any block a chain can hold).
numpy ``uint32`` appears only at the state boundary
(``streaming/state.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import device_constant, resolve_device

__all__ = ["constrain", "make_sine_lut", "nco_phases", "phase_to_rad",
           "nco_sincos", "nco_complex_exponential", "mix_up_block",
           "mix_down_block", "pll_step", "NCO", "U32_MASK", "TWO_PI", "U32"]

TWO_PI = 2.0 * np.pi
U32 = 4294967296.0
U32_MASK = 0xFFFFFFFF


def constrain(theta: float) -> np.uint32:
    """radians -> u32 phase word: frac(theta / 2pi), made positive, times
    0xffffffff (not 2^32), truncated toward zero."""
    frac = np.float64(theta) / TWO_PI
    frac = frac - np.trunc(frac)
    if frac < 0.0:
        frac += 1.0
    return np.uint32(np.trunc(frac * np.float64(0xFFFFFFFF)))


def make_sine_lut(dtype=np.float64) -> np.ndarray:
    """1024-entry sine table LUT[i] = sin(2 pi i / 1024), host numpy."""
    i = np.arange(1024, dtype=np.float64)
    return np.sin(TWO_PI * i / 1024.0).astype(dtype)


def _word(theta0, device=None) -> torch.Tensor:
    """A phase word as an int64 tensor: a tensor stays where it lies, a
    Python or numpy int goes to ``device`` (the card unless given)."""
    if isinstance(theta0, torch.Tensor):
        return theta0.to(torch.int64)
    return torch.tensor(int(theta0) & U32_MASK, dtype=torch.int64,
                        device=resolve_device(device))


def nco_phases(theta0, delta_theta: int, n: int,
               device=None) -> torch.Tensor:
    """Phase words theta0 + k*dtheta (mod 2^32), k = 0..n-1, as int64, on
    theta0's device when it is a tensor, else on ``device`` (the card
    unless given)."""
    theta0 = _word(theta0, device)
    k = torch.arange(n, dtype=torch.int64, device=theta0.device)
    return (theta0 + k * int(delta_theta)) & U32_MASK


def phase_to_rad(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Phase word -> radians in ``dtype``: the word is rounded to ``dtype``
    first and then scaled, as the JAX package does for u32 words."""
    step = np.float32(TWO_PI / U32) if dtype == torch.float32 else TWO_PI / U32
    return w.to(dtype) * float(step)


def _nco_cexp_fast(theta0: torch.Tensor, delta_theta: int,
                   n: int) -> torch.Tensor:
    """Factorized oscillator block e^{j(theta0 + k d)}, k = 0..n-1, complex64.

    With V = 128 when n is a multiple of 128, k = uV + v and e^{j theta_k}
    is the outer product of e^{j(theta0 + uVd)} and e^{jvd}: n/V + V
    sin/cos instead of n.  Otherwise every sample takes its own sin/cos.
    Phase words wrap as u32, and each becomes radians as the JAX package
    does it: word -> float32 -> times 2 pi / 2^32.
    """
    d = int(np.uint32(delta_theta))
    V = 128 if n % 128 == 0 and n >= 128 else 1
    if V == 1:
        ph = phase_to_rad(nco_phases(theta0, d, n), torch.float32)
        return torch.complex(torch.cos(ph), torch.sin(ph))
    pc = phase_to_rad(nco_phases(theta0, (V * d) & U32_MASK, n // V),
                      torch.float32)
    pf = phase_to_rad(nco_phases(torch.zeros_like(theta0), d, V),
                      torch.float32)
    ec = torch.complex(torch.cos(pc), torch.sin(pc))
    ef = torch.complex(torch.cos(pf), torch.sin(pf))
    return (ec[:, None] * ef[None, :]).reshape(n)


def _lut_index(theta: torch.Tensor) -> torch.Tensor:
    """Rounded 10-bit LUT index ((theta + 2^21) >> 22) & 0x3ff of int64
    words in [0, 2^32): the carry past bit 31 falls outside the mask."""
    return ((theta + (1 << 21)) >> 22) & 0x3FF


def nco_sincos(theta0, delta_theta, n: int, lut=None, mode: str = "lut",
               device=None):
    """(sin, cos) of a block of n oscillator steps, on theta0's device when
    it is a tensor, else on ``device`` (the card unless given).

    "lut" and "lut-table" read the 1024-entry table (``lut``, the float64
    sine table when None) at the rounded 10-bit index, cos at idx + 256:
    the reference's phase quantization, bit-equal to the JAX package's CPU
    path on every device (module docstring).  "exact" takes sin/cos of the
    u32 phase in float64, as the JAX package does with x64 enabled.
    """
    if mode not in ("lut", "lut-table", "exact"):
        raise ValueError(f"unknown nco mode {mode!r}")
    theta = nco_phases(theta0, delta_theta, n, device)
    if mode in ("lut", "lut-table"):
        table = (lut.to(theta.device) if isinstance(lut, torch.Tensor)
                 else device_constant(make_sine_lut() if lut is None else lut,
                                      theta.device))
        idx = _lut_index(theta)
        return table[idx], table[(idx + 256) & 0x3FF]
    ph = phase_to_rad(theta, torch.float64)
    return torch.sin(ph), torch.cos(ph)


def nco_complex_exponential(theta0, delta_theta: int, n: int, lut=None,
                            mode: str = "lut", device=None) -> torch.Tensor:
    """Block of e^{+j theta_k} = cos + j sin, k = 0..n-1, on theta0's
    device when it is a tensor, else on ``device`` (the card unless given).
    Modes: "lut" (the reference's table), "exact" (per-sample sin/cos in
    float64, complex128) and "fast" (the factorized complex64 oscillator,
    same math as "exact" to ~1 ulp of float32)."""
    if mode == "fast":
        return _nco_cexp_fast(_word(theta0, device), delta_theta, n)
    s, c = nco_sincos(theta0, delta_theta, n, lut, mode, device)
    return torch.complex(c, s)


def _theta_end(theta0, delta_theta: int, n: int, device) -> torch.Tensor:
    return (_word(theta0, device) + n * int(delta_theta)) & U32_MASK


def mix_up_block(x: torch.Tensor, theta0, delta_theta, lut=None,
                 mode: str = "lut"):
    """y[k] = e^{+j theta_k} x[k]; returns (y, theta_after_block)."""
    n = x.shape[-1]
    w0 = _word(theta0, x.device)
    ph = nco_complex_exponential(w0, delta_theta, n, lut, mode)
    return (x * ph.to(x.dtype),
            _theta_end(w0, delta_theta, n, x.device))


def mix_down_block(x: torch.Tensor, theta0, delta_theta, lut=None,
                   mode: str = "lut"):
    """y[k] = e^{-j theta_k} x[k]; returns (y, theta_after_block).  The
    conjugate oscillator is cast to x's type before the product, as in the
    JAX package."""
    n = x.shape[-1]
    w0 = _word(theta0, x.device)
    ph = nco_complex_exponential(w0, delta_theta, n, lut, mode).conj()
    return (x * ph.to(x.dtype),
            _theta_end(w0, delta_theta, n, x.device))


def _constrain_t(rad: torch.Tensor) -> torch.Tensor:
    """Tensor ``constrain``: frac(rad / 2pi) made positive, times
    0xffffffff, truncated: the u32 word as int64 (float -> integer
    directly, as the JAX package converts float -> uint32)."""
    frac = rad / TWO_PI
    frac = frac - torch.trunc(frac)
    frac = torch.where(frac < 0.0, frac + 1.0, frac)
    return torch.trunc(frac * 4294967295.0).to(torch.int64)


def pll_step(theta, delta_theta, delta_phi, alpha, beta, device=None):
    """One PLL coupling step: delta_theta += constrain(delta_phi * alpha),
    theta += constrain(delta_phi * beta), both u32 words (int64 in
    [0, 2^32)); returns (theta, delta_theta), on delta_phi's device when it
    is a tensor, else on ``device`` (the card unless given)."""
    if not isinstance(delta_phi, torch.Tensor):
        delta_phi = torch.as_tensor(delta_phi, device=resolve_device(device))
    ddt = _constrain_t(delta_phi * alpha)
    dth = _constrain_t(delta_phi * beta)
    return ((_word(theta, ddt.device) + dth) & U32_MASK,
            (_word(delta_theta, ddt.device) + ddt) & U32_MASK)


_U32_INT = 1 << 32


class NCO:
    """Stateful oscillator with the reference's API shape; its blocks are
    made on ``device`` (the card unless told otherwise).  The phase words
    live on the host as numpy uint32, as in the JAX package."""

    def __init__(self, mode: str = "lut", dtype=None, device=None):
        self.mode = mode
        self.device = resolve_device(device)
        self._lut = make_sine_lut(dtype or np.float64)
        self.theta = np.uint32(0)
        self.delta_theta = np.uint32(0)
        self.alpha = 0.1
        self.beta = float(np.sqrt(0.1))

    def reset(self) -> None:
        self.theta = np.uint32(0)
        self.delta_theta = np.uint32(0)

    def set_frequency(self, rad_per_sample: float) -> None:
        self.delta_theta = constrain(rad_per_sample)

    def adjust_frequency(self, d: float) -> None:
        self.delta_theta = np.uint32(
            (int(self.delta_theta) + int(constrain(d))) % _U32_INT)

    def set_phase(self, phi: float) -> None:
        self.theta = constrain(phi)

    def adjust_phase(self, dphi: float) -> None:
        self.theta = np.uint32((int(self.theta) + int(constrain(dphi)))
                               % _U32_INT)

    def get_frequency(self) -> float:
        """delta_theta as signed radians/sample (the reference's integer
        division always returns 0.0; this is its documented intent)."""
        dt = float(self.delta_theta) / U32 * TWO_PI
        return dt - TWO_PI if dt > np.pi else dt

    def get_phase(self) -> float:
        return float(self.theta) / U32 * TWO_PI

    def set_internal_pll_bandwidth(self, bandwidth: float) -> None:
        if bandwidth < 0.0:
            raise ValueError("bandwidth out of range [0, inf)")
        self.alpha = bandwidth
        self.beta = float(np.sqrt(bandwidth))

    def step(self) -> None:
        self.theta = np.uint32((int(self.theta) + int(self.delta_theta))
                               % _U32_INT)

    def pll_step(self, delta_phi: float) -> None:
        self.adjust_frequency(delta_phi * self.alpha)
        self.adjust_phase(delta_phi * self.beta)

    def _advance(self, n: int) -> None:
        self.theta = np.uint32((int(self.theta) + n * int(self.delta_theta))
                               % _U32_INT)

    def _w0(self) -> torch.Tensor:
        return _word(self.theta, self.device)

    def sincos_block(self, n: int):
        """n (sin, cos) pairs, stepping the phase accumulator n times."""
        s, c = nco_sincos(self._w0(), self.delta_theta, n, self._lut,
                          self.mode)
        self._advance(n)
        return s, c

    def sincos(self):
        s, c = nco_sincos(self._w0(), self.delta_theta, 1, self._lut,
                          self.mode)
        return float(s[0]), float(c[0])

    def sin(self) -> float:
        return self.sincos()[0]

    def cos(self) -> float:
        return self.sincos()[1]

    def complex_exponential_block(self, n: int) -> torch.Tensor:
        out = nco_complex_exponential(self._w0(), self.delta_theta, n,
                                      self._lut, self.mode)
        self._advance(n)
        return out

    def complex_exponential(self) -> complex:
        return complex(nco_complex_exponential(
            self._w0(), self.delta_theta, 1, self._lut, self.mode)[0])

    def _mix(self, fn, x):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x))
        y, theta = fn(x.to(self.device), self._w0(), self.delta_theta,
                      self._lut, self.mode)
        self.theta = np.uint32(int(theta))
        return y

    def mix_up_block(self, x) -> torch.Tensor:
        return self._mix(mix_up_block, x)

    def mix_down_block(self, x) -> torch.Tensor:
        return self._mix(mix_down_block, x)

    def mix_up(self, sample):
        return complex(self.complex_exponential() * sample)

    def mix_down(self, sample):
        return complex(np.conj(self.complex_exponential()) * sample)

    def __repr__(self) -> str:
        return (f"NCO [Theta={int(self.theta)}] "
                f"[dTheta={int(self.delta_theta)}] [Alpha={self.alpha}] "
                f"[Beta={self.beta}]")
