"""Cyclostationary analysis: time-smoothed cyclic periodograms.

Port of ``solid_dsp_tpu/analysis/cyclo.py``.  The spectral correlation at
cycle frequency alpha is the frame average of X+(f) conj(X-(f)), X+- the
STFTs of x(n) exp(-+j pi alpha n); the spectral coherence normalises it
by the branches' PSDs to [0, 1].  The whole alpha grid is one batched
STFT (alphas x frames x nfft) on ``analysis/spectral.py``'s framing and
windows and ``torch.fft``, as JAX's is on ``jnp.fft`` (no kernel of its
own).  ``cycle_profile`` takes the max coherence over f per alpha;
``detect_cyclic_features`` gates that profile on the host;
``estimate_symbol_rate`` scans coarse (segmented, incoherent averages)
then fine.  Tensor functions: they run where their input lies.
"""

from __future__ import annotations

import numpy as np
import torch

from .spectral import _window_taps, frame_signal

__all__ = ["cyclic_spectrum", "cycle_profile", "detect_cyclic_features",
           "estimate_symbol_rate"]


def cyclic_spectrum(x: torch.Tensor, alphas, nfft: int = 256, hop: int = 64,
                    window: str = "hann", conjugate: bool = False,
                    coherent_frames: int | None = None):
    """(scf, coherence), both (A, nfft) in natural FFT bin order, of x (N,)
    complex baseband at the cycle frequencies ``alphas`` (A,) (cycles a
    sample; a linear modem at sps samples a symbol has its feature at
    1/sps).  ``conjugate`` correlates with conj(x) (the doubled-carrier
    features).  ``coherent_frames=Q`` averages frames coherently in groups
    of Q and the groups' magnitudes after (scf is then that magnitude),
    widening the alpha tolerance to ~1/(Q hop)."""
    x = torch.as_tensor(x)
    if not x.is_complex():
        x = x.to(torch.complex64)
    alphas = torch.as_tensor(np.asarray(alphas, np.float32), device=x.device)
    n = torch.arange(x.shape[-1], dtype=torch.float32, device=x.device)
    ph = np.pi * alphas[:, None] * n[None, :]
    rot = torch.exp(-1j * ph).to(x.dtype)
    up = x[None, :] * rot                    # spectrum shifted down by a/2
    base = torch.conj(x) if conjugate else x
    dn = base[None, :] * torch.conj(rot)     # shifted up by a/2
    taps = torch.from_numpy(_window_taps(window, nfft)).to(x.device,
                                                           x.real.dtype)
    Xp = torch.fft.fft(frame_signal(up, nfft, hop) * taps, dim=-1)
    Xm = torch.fft.fft(frame_signal(dn, nfft, hop) * taps, dim=-1)
    prod = Xp * torch.conj(Xm)                                 # (A, P, nfft)
    if coherent_frames is None:
        scf = torch.mean(prod, dim=1)
        mag = torch.abs(scf)
    else:
        Q = int(coherent_frames)
        G = prod.shape[1] // Q
        seg = torch.mean(prod[:, :G * Q].reshape(prod.shape[0], G, Q, nfft),
                         dim=2)
        mag = torch.mean(torch.abs(seg), dim=1)
        scf = mag.to(prod.dtype)
    psd_p = torch.mean(torch.abs(Xp) ** 2, dim=1)
    psd_m = torch.mean(torch.abs(Xm) ** 2, dim=1)
    return scf, mag / torch.sqrt(psd_p * psd_m + 1e-30)


def cycle_profile(x: torch.Tensor, alphas, nfft: int = 256, hop: int = 64,
                  window: str = "hann", conjugate: bool = False,
                  coherent_frames: int | None = None) -> torch.Tensor:
    """The max spectral coherence over f at each alpha: (A,)."""
    _, coh = cyclic_spectrum(x, alphas, nfft, hop, window, conjugate,
                             coherent_frames)
    return torch.amax(coh, dim=-1)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def detect_cyclic_features(x: torch.Tensor, alphas, nfft: int = 256,
                           hop: int = 64, window: str = "hann",
                           conjugate: bool = False,
                           threshold: float | None = None) -> dict:
    """Scan an alpha grid: {"alphas", "profile", "detected", "threshold",
    "alpha_hat" (nan if nothing passes), "peak"} on the host.  The default
    gate is max(median + 6 MAD, 1.5 median) of the profile."""
    alphas = np.asarray(alphas, np.float32)
    prof = _host(cycle_profile(x, alphas, nfft, hop, window, conjugate))
    return _gate_profile(alphas, prof, threshold)


def _gate_profile(alphas, prof, threshold):
    if threshold is None:
        med = float(np.median(prof))
        mad = float(np.median(np.abs(prof - med))) + 1e-12
        threshold = max(med + 6.0 * mad, 1.5 * med)
    hits = prof > threshold
    alpha_hat = float(alphas[int(np.argmax(prof))]) if hits.any() else float("nan")
    return {"alphas": alphas, "profile": prof, "detected": hits,
            "threshold": float(threshold), "alpha_hat": alpha_hat,
            "peak": float(prof.max())}


def estimate_symbol_rate(x: torch.Tensor, lo: float, hi: float,
                         nfft: int = 256, hop: int = 64,
                         window: str = "hann", coherent_frames: int = 8,
                         conjugate: bool = False) -> dict:
    """Blind symbol-rate search on [lo, hi) cycles a sample: a coarse scan
    at step 1/(2 coherent_frames hop) with segmented averages, then a
    coherent scan at step 1/(2N) within a coarse step of its peak.  The
    fine stage's ``detect_cyclic_features`` dict plus "alpha_coarse"."""
    x = torch.as_tensor(x)
    N = int(x.shape[-1])
    tol = 1.0 / (coherent_frames * hop)
    coarse = np.arange(lo, hi, tol / 2, dtype=np.float64)
    if coarse.size < 2:
        raise ValueError("search range narrower than the coarse step")
    prof_c = _host(cycle_profile(x, coarse.astype(np.float32), nfft, hop,
                                 window, conjugate, coherent_frames))
    a0 = float(coarse[int(np.argmax(prof_c))])
    fine = np.arange(max(lo, a0 - tol), min(hi, a0 + tol), 0.5 / N,
                     dtype=np.float64)
    prof_f = _host(cycle_profile(x, fine.astype(np.float32), nfft, hop,
                                 window, conjugate))
    out = _gate_profile(fine.astype(np.float32), prof_f, None)
    out["alpha_coarse"] = a0
    return out
