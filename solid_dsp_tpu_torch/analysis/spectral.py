"""Spectral estimation: STFT, spectrogram, Welch PSD, cross-spectra,
cepstrum, analytic signal, Goertzel bank, STFT denoising.

Port of ``solid_dsp_tpu/analysis/spectral.py``.  Framing is a gather-free
strided view (``unfold``), with the JAX package's rule that the hop divides
the frame; every estimate is one batched op over the frame axis; the
Goertzel bank is one complex matrix product frames @ probes.  Complex
types follow the JAX package's (float32 -> complex64, float64 ->
complex128, and its float64-only rule in ``cepstrum`` and
``analytic_signal``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..design.windows import get_window
from ..device import fp32_exact

__all__ = ["frame_signal", "stft", "istft", "spectrogram", "welch_psd",
           "csd", "coherence", "cepstrum", "analytic_signal", "envelope",
           "instantaneous_frequency", "goertzel_bank", "stft_denoise"]


def _check_frame_args(nfft: int, hop: int) -> None:
    if hop <= 0 or nfft <= 0:
        raise ValueError("nfft and hop must be positive")
    if hop > nfft:
        raise ValueError(f"hop ({hop}) must not exceed nfft ({nfft})")
    if nfft % hop:
        raise ValueError(
            f"gather-free framing requires hop ({hop}) to divide "
            f"nfft ({nfft})")


def frame_signal(x: torch.Tensor, nfft: int, hop: int) -> torch.Tensor:
    """Overlapping frames (..., F, nfft) of the last axis, F = (n - nfft)
    // hop + 1: a strided view of x, no copy."""
    _check_frame_args(nfft, hop)
    x = torch.as_tensor(x)
    n = x.shape[-1]
    if n < nfft:
        raise ValueError(f"signal length {n} < nfft {nfft}")
    return x.unfold(-1, nfft, hop)


def _window_taps(window: str, nfft: int) -> np.ndarray:
    """Window taps by name: the design.windows families plus "rect"."""
    if window == "rect":
        return np.ones(nfft, dtype=np.float64)
    return np.asarray(get_window(window, nfft), dtype=np.float64)


def _real_type(dtype: torch.dtype) -> torch.dtype:
    return torch.empty(0, dtype=dtype).real.dtype


def stft(x: torch.Tensor, nfft: int = 1024, hop: int = 512,
         window: str = "hann", pad_to: int | None = None) -> torch.Tensor:
    """Short-time Fourier transform: (..., F, pad_to or nfft) complex;
    ``pad_to`` zero-pads each windowed frame before the FFT."""
    if pad_to is not None and pad_to < nfft:
        raise ValueError(f"pad_to {pad_to} < frame length {nfft}")
    frames = frame_signal(x, nfft, hop)
    w = torch.from_numpy(_window_taps(window, nfft)).to(
        frames.device, frames.dtype if frames.is_complex()
        else _real_type(frames.dtype))
    return torch.fft.fft(frames * w, n=pad_to or nfft, dim=-1)


def _power(S: torch.Tensor) -> torch.Tensor:
    return (S * S.conj()).real


def spectrogram(x: torch.Tensor, nfft: int = 1024, hop: int = 512,
                window: str = "hann") -> torch.Tensor:
    """Power spectrogram |STFT|^2 in dB, (..., F, nfft)."""
    p = _power(stft(x, nfft, hop, window))
    return 10.0 * torch.log10(torch.clamp(p, min=1e-30))


def _psd_norm(window: str, nfft: int, fs: float) -> float:
    w = _window_taps(window, nfft)
    return 1.0 / (fs * float(np.sum(w * w)))


def welch_psd(x: torch.Tensor, nfft: int = 1024, hop: int = 512,
              window: str = "hann", fs: float = 1.0, onesided: bool = False,
              pad_to: int | None = None) -> torch.Tensor:
    """Welch-averaged PSD: the mean periodogram times 1/(fs sum w^2);
    ``onesided`` folds a real signal to nfft//2 + 1 bins (doubling all but
    DC and Nyquist)."""
    S = stft(x, nfft, hop, window, pad_to)
    p = torch.mean(_power(S), dim=-2) * _psd_norm(window, nfft, fs)
    if onesided:
        if pad_to is not None:
            raise ValueError("onesided with pad_to is not supported")
        half = nfft // 2 + 1
        scale = torch.ones(half, dtype=p.dtype, device=p.device)
        scale[1:] = 2.0
        if nfft % 2 == 0:
            scale[-1] = 1.0
        p = p[..., :half] * scale
    return p


def goertzel_bank(x: torch.Tensor, freqs, frame_len: int = 256
                  ) -> torch.Tensor:
    """Per-frame complex amplitude at K probe frequencies (cycles a
    sample), normalized by 2/N: (F, K) complex, one matrix product of the
    (F, N) frames with the (N, K) probes."""
    freqs = np.atleast_1d(np.asarray(freqs, dtype=np.float64))
    n = np.arange(frame_len)[:, None]
    probes = np.exp(-2j * np.pi * n * freqs[None, :]) * (2.0 / frame_len)
    frames = frame_signal(x, frame_len, frame_len)
    cdt = torch.promote_types(frames.dtype, torch.complex64)
    with fp32_exact():
        return torch.matmul(frames.to(cdt),
                            torch.from_numpy(probes).to(frames.device, cdt))


def csd(x: torch.Tensor, y: torch.Tensor, nfft: int = 1024, hop: int = 512,
        window: str = "hann", fs: float = 1.0) -> torch.Tensor:
    """Welch-averaged cross-spectral density E[X(f) conj(Y(f))], with
    welch_psd's segmentation and normalization (csd(x, x) = welch_psd(x))."""
    Sx = stft(x, nfft, hop, window)
    Sy = stft(y, nfft, hop, window)
    return torch.mean(Sx * Sy.conj(), dim=-2) * _psd_norm(window, nfft, fs)


def coherence(x: torch.Tensor, y: torch.Tensor, nfft: int = 1024,
              hop: int = 512, window: str = "hann") -> torch.Tensor:
    """Magnitude-squared coherence |P_xy|^2 / (P_xx P_yy) in [0, 1]."""
    Sx = stft(x, nfft, hop, window)
    Sy = stft(y, nfft, hop, window)
    pxy = torch.mean(Sx * Sy.conj(), dim=-2)
    pxx = torch.mean(_power(Sx), dim=-2)
    pyy = torch.mean(_power(Sy), dim=-2)
    return _power(pxy) / torch.clamp(pxx * pyy, min=1e-30)


def _cepstrum_complex(dtype: torch.dtype) -> torch.dtype:
    # the JAX package's rule: complex128 only for float64 input
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def cepstrum(x: torch.Tensor, kind: str = "real") -> torch.Tensor:
    """Cepstrum of one frame (last axis): "real" IFFT(log|X|), "power"
    |IFFT(log|X|^2)|^2."""
    if kind not in ("real", "power"):
        raise ValueError(f"unknown cepstrum kind {kind!r} (real|power)")
    x = torch.as_tensor(x)
    X = torch.fft.fft(x, dim=-1)
    logmag = torch.log(torch.clamp(X.abs(), min=1e-30))
    cdt = _cepstrum_complex(x.dtype)
    if kind == "real":
        return torch.fft.ifft(logmag.to(cdt), dim=-1).real
    c = torch.fft.ifft((2.0 * logmag).to(cdt), dim=-1)
    return _power(c)


def analytic_signal(x: torch.Tensor) -> torch.Tensor:
    """Analytic signal of a real block by the FFT method: positive
    frequencies doubled, negative ones zeroed, DC and Nyquist kept."""
    x = torch.as_tensor(x)
    n = x.shape[-1]
    X = torch.fft.fft(x.to(_cepstrum_complex(x.dtype)), dim=-1)
    h = np.zeros(n)
    h[0] = 1.0
    if n % 2 == 0:
        h[1: n // 2] = 2.0
        h[n // 2] = 1.0
    else:
        h[1: (n + 1) // 2] = 2.0
    return torch.fft.ifft(X * torch.from_numpy(h).to(X.device, X.dtype),
                          dim=-1)


def envelope(x: torch.Tensor) -> torch.Tensor:
    """Instantaneous amplitude |analytic(x)| of a real block."""
    return analytic_signal(x).abs()


def instantaneous_frequency(x: torch.Tensor) -> torch.Tensor:
    """Instantaneous frequency (cycles a sample, length n - 1) from the
    analytic phase difference; complex input is its own analytic signal."""
    x = torch.as_tensor(x)
    z = x if x.is_complex() else analytic_signal(x)
    d = z[..., 1:] * z[..., :-1].conj()
    return torch.angle(d) / (2.0 * np.pi)


def _ola(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Overlap-add (..., F, nfft) frames at ``hop``: one ``index_add_``
    of every sample at f hop + n."""
    F, nfft = frames.shape[-2], frames.shape[-1]
    idx = (torch.arange(F, device=frames.device)[:, None] * hop
           + torch.arange(nfft, device=frames.device)[None, :]).reshape(-1)
    out = torch.zeros((*frames.shape[:-2], (F - 1) * hop + nfft),
                      dtype=frames.dtype, device=frames.device)
    return out.index_add_(-1, idx, frames.reshape(*frames.shape[:-2], -1))


def istft(S: torch.Tensor, nfft: int = 1024, hop: int = 512,
          window: str = "hann", length: int | None = None) -> torch.Tensor:
    """Inverse STFT by weighted overlap-add: each frame inverse-transformed
    (the full spectrum, then the first nfft samples), re-weighted by the
    window, overlap-added and divided by the window-power envelope; 0 where
    that envelope is 0.  istft(stft(x)) == x for any window with hop |
    nfft."""
    _check_frame_args(nfft, hop)
    F = S.shape[-2]
    frames = torch.fft.ifft(S, dim=-1)[..., :nfft]
    w = torch.from_numpy(_window_taps(window, nfft)).to(
        frames.device, _real_type(frames.dtype))
    num = _ola(frames * w, hop)
    env = _ola((w * w).expand(F, nfft), hop)
    good = env > 0.0
    y = torch.where(good, num / torch.where(good, env, torch.ones_like(env)),
                    torch.zeros((), dtype=num.dtype, device=num.device))
    n_out = (F - 1) * hop + nfft
    return y[..., :length if length is not None else n_out]


def _percentile(P: torch.Tensor, q: float, dim: int) -> torch.Tensor:
    """Linear-interpolation percentile along ``dim`` (numpy's default and
    ``torch.quantile``'s) by a sort, which takes tensors of any size."""
    s, _ = torch.sort(P, dim=dim)
    n = s.shape[dim]
    pos = q / 100.0 * (n - 1)
    lo, hi = int(np.floor(pos)), min(int(np.ceil(pos)), n - 1)
    w_hi = pos - lo
    return s.select(dim, lo) * (1.0 - w_hi) + s.select(dim, hi) * w_hi


def stft_denoise(x: torch.Tensor, nfft: int = 512, hop: int = 128,
                 window: str = "hann", rule: str = "wiener",
                 oversubtract: float = 1.5, floor: float = 0.05,
                 noise_psd=None) -> torch.Tensor:
    """STFT-domain noise suppression.  The noise PSD is the 20th percentile
    of the frame powers per bin unless ``noise_psd`` (nfft,) is given; the
    per-frame power is EMA-smoothed over time (0.6 / 0.4) and each bin
    gets G = max(1 - nu N/P, floor) ("wiener") or max(1 - sqrt(nu N/P),
    floor) ("subtract").  A frame of padding on both sides keeps every
    output sample fully covered.  Returns x's length and kind."""
    if rule not in ("wiener", "subtract"):
        raise ValueError(f"unknown rule {rule!r}")
    x = torch.as_tensor(x)
    n = x.shape[-1]
    if n < nfft:
        raise ValueError(f"signal length {n} < nfft {nfft}")
    F = -(-(n + nfft) // hop) + 1
    usable = (F - 1) * hop + nfft
    xp = torch.nn.functional.pad(x, (nfft, usable - n - nfft))
    S = stft(xp, nfft, hop, window)
    P = _power(S)
    if noise_psd is None:
        N = _percentile(P, 20.0, dim=-2)
    else:
        N = torch.as_tensor(noise_psd).to(P.device, P.dtype)
    # time smoothing of the power track (reduces musical noise)
    c = P[..., 0, :]
    rows = []
    for f in range(P.shape[-2]):
        c = 0.6 * c + 0.4 * P[..., f, :]
        rows.append(c)
    Ps = torch.stack(rows, dim=-2)
    ratio = oversubtract * N[..., None, :] / torch.clamp(
        Ps, min=torch.finfo(Ps.dtype).tiny)
    if rule == "wiener":
        G = torch.clamp(1.0 - ratio, min=floor)
    else:
        G = torch.clamp(1.0 - torch.sqrt(ratio), min=floor)
    y = istft(S * G.to(S.dtype), nfft, hop, window)[..., nfft:nfft + n]
    return y if x.is_complex() else y.real
