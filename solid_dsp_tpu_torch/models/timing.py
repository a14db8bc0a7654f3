"""Symbol timing recovery: the feedforward Oerder-Meyr synchroniser and
the Gardner loop.

Port of ``solid_dsp_tpu/models/timing.py``:

* ``symbol_sync_block``: the Oerder & Meyr squaring estimator gives a
  block's fractional timing offset in closed form (one DFT bin of |x|^2),
  a windowed-sinc fractional-delay FIR built on the device from that
  offset aligns the stream (``conv1d_mxu``), and a gather picks the symbol
  instants; no host sync;
* ``gardner_scan``: the decision-free Gardner timing loop with cubic
  (Farrow) interpolation at the strobe and the midpoint, one symbol a
  step.  JAX runs it as ``lax.scan`` (:124); here a CUDA tensor goes
  through S9 (``ops/cuda_timing.py``, ``csrc/gardner_scan.cu``), a CPU
  tensor through the plain version :func:`gardner_walk_plain`, the same
  real operations on the re/im rails in the same order (S9 is bit-equal to
  it).  S9 takes complex64 and 1 <= sps <= 64; the plain version
  (``engine="torch"``) the rest.

**F8, a fault of the reference, met here.**  JAX forms the strobe
position ``pos = k * sps + mu`` (:110, and ``pos - sps / 2`` for the
midpoint, :115) as an int32 plus a float32 carry, so the position is
float32: from k sps ~ 2^20 samples on its fraction keeps 3 bits, from 2^24
none, and the interpolation point coarsens along a stream while the loop
stays locked.  The port keeps the whole part ``k * sps`` as an integer and
carries mu apart (:func:`strobe_split`: base = k sps + floor(mu), frac =
mu - floor(mu), rounded once at most; the midpoint the same way, an odd sps's half sample taken
off mu), keeping JAX's clip of the index to [1, n - 3] and its - 1.
"""

from __future__ import annotations

import numpy as np
import torch

from ..design.windows import hamming
from ..device import device_constant
from ..ops.cuda_build import use_kernel
from ..ops.fir import conv1d_mxu

__all__ = ["oerder_meyr_offset", "fractional_delay_taps",
           "symbol_sync_block", "gardner_scan", "gardner_walk_plain",
           "strobe_split"]


def oerder_meyr_offset(x: torch.Tensor, sps: int) -> torch.Tensor:
    """Feedforward timing estimate in samples, in [-sps/2, sps/2):
    -sps / (2 pi) arg(sum_n |x[n]|^2 e^{-j 2 pi n / sps})."""
    cd = torch.promote_types(x.dtype, torch.complex64)
    period = device_constant(np.exp(-2j * np.pi * np.arange(sps) / sps),
                             x.device, cd)
    ph = period[torch.arange(x.shape[-1], device=x.device) % sps]
    m = torch.sum(torch.abs(x) ** 2 * ph, dim=-1)
    return -sps / (2.0 * np.pi) * torch.angle(m)


def fractional_delay_taps(tau: torch.Tensor, ntaps: int = 17) -> torch.Tensor:
    """Windowed-sinc fractional-delay FIR for the delay ``tau`` (a tensor,
    (-1, 1) samples): group delay (ntaps - 1) / 2 + tau; ``ntaps`` odd."""
    if ntaps % 2 == 0:
        raise ValueError("ntaps must be odd (integer base delay)")
    tau = torch.as_tensor(tau)
    t = (torch.arange(ntaps, device=tau.device) - (ntaps - 1) / 2.0) - tau
    return torch.sinc(t) * device_constant(hamming(ntaps), tau.device,
                                           t.dtype)


def symbol_sync_block(x: torch.Tensor, sps: int, ntaps: int = 17):
    """Block symbol synchroniser on a matched-filtered stream at ``sps``:
    (symbols, tau_hat), (len(x) - ntaps) // sps - t0 - 1 symbols with t0 =
    ((ntaps - 1) // 2 + sps) // sps + 1 (head margin and filter edges
    dropped)."""
    tau = oerder_meyr_offset(x, sps)       # symbol instants at t sps + tau
    fl = torch.floor(tau)
    C = (ntaps - 1) // 2
    h = fractional_delay_taps(tau - fl, ntaps).to(x.dtype)
    y = conv1d_mxu(x, h)                   # y[n] = x(n + C + frac)
    t0 = (C + sps) // sps + 1
    n_sym = (x.shape[-1] - ntaps) // sps - t0 - 1
    idx = ((t0 + torch.arange(n_sym, device=x.device)) * sps
           + fl.to(torch.int64) - C).clamp(0, y.shape[-1] - 1)
    return y[..., idx], tau


def strobe_split(k, sps: int, mu: torch.Tensor, n: int):
    """F8's strobe arithmetic: for symbol k (an int or an int64 tensor) and
    the float mu, (base, frac, mbase, mfrac): the first of the 4 samples
    around the strobe k sps + mu and its fraction, and the same for the
    midpoint k sps - sps / 2 + mu, the whole parts as integers (JAX's clip
    to [1, n - 3] and - 1 kept)."""
    fl = torch.floor(mu)
    frac = mu - fl
    ip = k * sps + fl.to(torch.int64)
    half = sps // 2
    if sps % 2:
        m2 = mu - 0.5
        fl2 = torch.floor(m2)
        mfrac = m2 - fl2
        mip = k * sps - half + fl2.to(torch.int64)
    else:
        mfrac = frac
        mip = ip - half
    return (ip.clamp(1, n - 3) - 1, frac, mip.clamp(1, n - 3) - 1, mfrac)


def _farrow(s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Cubic Lagrange interpolation on points at offsets -1, 0, 1, 2 (the
    last axis of s) at fraction t, elementwise over the leading axes."""
    s0, s1, s2, s3 = s.unbind(-1)
    c1 = 0.5 * (s2 - s0)
    c2 = ((s0 - 2.5 * s1) + 2.0 * s2) - 0.5 * s3
    c3 = 0.5 * (s3 - s0) + 1.5 * (s1 - s2)
    return ((c3 * t + c2) * t + c1) * t + s1


def gardner_walk_plain(x: torch.Tensor, sps: int, alpha: float, beta: float,
                       mu0: float, n_sym: int):
    """The Gardner loop in torch ops, a symbol at a time, on the re/im
    rails: each step interpolates the strobe and the midpoint (one gather
    of 2 x 4 samples a rail), e = mid.re d.re + mid.im d.im with d = the
    previous symbol - the symbol, rate += beta e, mu = (mu + alpha e) +
    rate.  Returns (symbols (n_sym,), final mu)."""
    rails = torch.stack([x.real, x.imag])                  # (2, n)
    rd = rails.dtype
    n = x.shape[-1]
    dev = x.device
    mu = torch.tensor(mu0, dtype=rd, device=dev)
    rate = torch.zeros((), dtype=rd, device=dev)
    prev = torch.zeros(2, dtype=rd, device=dev)
    ar4 = torch.arange(4, device=dev)
    out = []
    for k in range(1, n_sym + 1):
        b, frac, mb, mfrac = strobe_split(k, sps, mu, n)
        idx = torch.stack([b + ar4, mb + ar4])             # (2 points, 4)
        v = _farrow(rails[:, idx], torch.stack([frac, mfrac]))   # (rail, pt)
        sym, mid = v[:, 0], v[:, 1]
        p = mid * (prev - sym)
        e = p[0] + p[1]
        rate = rate + beta * e
        mu = (mu + alpha * e) + rate
        prev = sym
        out.append(sym)
    if not out:
        return x.new_zeros(0), mu
    s = torch.stack(out)
    return torch.complex(s[:, 0], s[:, 1]), mu


def gardner_scan(x: torch.Tensor, sps: int, bandwidth: float = 0.01,
                 mu0: float = 0.0, engine: str = "auto"):
    """The Gardner timing loop with cubic interpolation (exact streaming
    semantics, F8 met): (symbols, final_mu), one symbol a step, (len(x) -
    4) // sps - 1 of them.  S9 on a CUDA tensor, the plain walk on a CPU
    tensor or with ``engine="torch"``."""
    x = torch.as_tensor(x)
    sps = int(sps)
    alpha = float(bandwidth)
    beta = bandwidth * bandwidth / 4.0
    n_sym = (x.shape[-1] - 4) // sps - 1
    if use_kernel(engine, x):
        from ..ops.cuda_timing import gardner_cuda

        return gardner_cuda(x, sps, alpha, beta, mu0, n_sym)
    return gardner_walk_plain(x, sps, alpha, beta, mu0, max(n_sym, 0))
