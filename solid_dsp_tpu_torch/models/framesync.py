"""Preamble-based frame synchronisation and data-aided CFO / phase
estimation.

Port of ``solid_dsp_tpu/models/framesync.py``: the normalised matched
filter |rho|^2 (one sliding correlation with the conjugate preamble and
one sliding energy, both ``ops/fir.py::conv1d_mxu``, which pins full
float32 on the card), the detector, the Moose and Kay CFO estimators, the
common-phase estimate, :class:`FrameSync` and the host-side burst scan
``scan_bursts``.

The functions run where their input lies; :class:`FrameSync` moves its
input to its device (the card unless told otherwise).  ``extract`` reads
the detected start back to the host once (JAX slices with a traced
start); the window of the Moose estimate is clamped into the block as
``lax.dynamic_slice_in_dim`` clamps it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import bind_device
from ..ops.fir import conv1d_mxu

__all__ = [
    "preamble_correlate", "detect_preamble",
    "estimate_cfo_repeated", "estimate_cfo_kay", "estimate_phase",
    "FrameSync", "scan_bursts",
]


def _like(p, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(p, device=x.device).to(x.dtype)


def preamble_correlate(x, preamble):
    """Normalised matched-filter metric per alignment: (|rho|^2, raw
    correlation), index n = candidate start of the preamble;
    rho[n] = sum_k conj(p[k]) x[n+k] / sqrt(E_p E_x[n])."""
    x = torch.as_tensor(x)
    p = _like(preamble, x)
    L = p.shape[-1]
    lead = x.shape[:-1]
    e = (x * torch.conj(x)).real
    # L - 1 trailing zeros so every start n = 0 .. len(x) - 1 exists
    corr = conv1d_mxu(torch.cat([x, x.new_zeros((*lead, L - 1))], -1),
                      torch.conj(p))
    energy = conv1d_mxu(torch.cat([e, e.new_zeros((*lead, L - 1))], -1),
                        torch.ones(L, dtype=e.dtype, device=x.device))
    ep = torch.sum((p * torch.conj(p)).real)
    rho2 = (corr * torch.conj(corr)).real / (ep * energy + 1e-30)
    return rho2, corr


def detect_preamble(x, preamble, threshold: float = 0.5):
    """Best preamble alignment: (start int32, rho2 peak, found), tensors."""
    rho2, _ = preamble_correlate(x, preamble)
    idx = torch.argmax(rho2)
    peak = rho2.reshape(-1)[idx]
    return idx.to(torch.int32), peak, peak >= threshold


def estimate_cfo_repeated(x_pp, L: int):
    """Moose CFO estimate (cycles a sample, range +-1/(2L)) from the 2L
    received samples of a [p, p] preamble."""
    x_pp = torch.as_tensor(x_pp)
    acc = torch.sum(torch.conj(x_pp[..., :L]) * x_pp[..., L:2 * L], dim=-1)
    return torch.angle(acc) / (2.0 * np.pi * L)


def estimate_cfo_kay(x_seg, preamble):
    """Kay phase-slope CFO estimate from any known preamble (+-0.5 cycles
    a sample)."""
    x_seg = torch.as_tensor(x_seg)
    z = x_seg * torch.conj(_like(preamble, x_seg))
    acc = torch.sum(z[..., 1:] * torch.conj(z[..., :-1]), dim=-1)
    return torch.angle(acc) / (2.0 * np.pi)


def estimate_phase(x_seg, preamble):
    """Common-phase estimate angle(sum conj(p) x) on the aligned preamble."""
    x_seg = torch.as_tensor(x_seg)
    return torch.angle(torch.sum(torch.conj(_like(preamble, x_seg)) * x_seg,
                                 dim=-1))


class FrameSync:
    """Detect a [p, p]-preambled frame, correct CFO and phase, extract the
    payload; on ``device`` (the card unless told otherwise)."""

    def __init__(self, preamble, payload_len: int, threshold: float = 0.5,
                 device=None):
        self.p = np.asarray(preamble)
        self.L = len(self.p)
        self.payload_len = int(payload_len)
        self.threshold = float(threshold)
        self.device = bind_device(device)

    def full_preamble(self) -> np.ndarray:
        return np.concatenate([self.p, self.p])

    def extract(self, x):
        """x -> (payload, info dict of start/rho2/cfo/phase/found)."""
        x = torch.as_tensor(x).to(self.device)
        pp = _like(self.full_preamble(), x)
        start, peak, found = detect_preamble(x, pp, self.threshold)
        n = x.shape[-1]
        s = int(start)
        lo = min(max(s, 0), n - 2 * self.L)   # dynamic_slice's clamp
        cfo = estimate_cfo_repeated(x[lo:lo + 2 * self.L], self.L)
        # de-rotate from the preamble start, so the phase estimate is
        # consistent with the corrected samples
        k = (torch.arange(n, device=x.device) - s).to(torch.float32)
        xc = x * torch.exp(-2j * np.pi * cfo * k).to(x.dtype)
        xc = torch.roll(xc, -s)
        phase = estimate_phase(xc[: 2 * self.L], pp)
        xc = xc * torch.exp(-1j * phase).to(x.dtype)
        payload = xc[2 * self.L: 2 * self.L + self.payload_len]
        return payload, {"start": start, "rho2": peak, "found": found,
                         "cfo": cfo, "phase": phase}

    def __repr__(self):
        return (f"FrameSync [L={self.L}] [payload={self.payload_len}] "
                f"[threshold={self.threshold}]")


def scan_bursts(above, frame_samples: int, margin: int, n_total: int,
                decode_fn, max_bursts: int = 64) -> list:
    """Burst-capture scan on the host: for each first crossing d of the
    boolean metric ``above``, ``decode_fn(lo, hi)`` on [d - margin,
    d + frame_samples + margin) clipped to [0, n_total), with
    ``info["offset"] = lo``; then past the frame."""
    above = np.asarray(above, bool)
    out = []
    pos = 0
    while len(out) < max_bursts and pos < len(above):
        nxt = int(np.argmax(above[pos:]))
        if not above[pos + nxt]:
            break
        d = pos + nxt
        lo = max(0, d - margin)
        hi = min(n_total, d + frame_samples + margin)
        data, info = decode_fn(lo, hi)
        info["offset"] = lo
        out.append((data, info))
        pos = d + frame_samples
    return out
