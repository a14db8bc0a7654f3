"""RF measurements: channel power, ACPR, occupied bandwidth, the PAPR
CCDF, SINAD / ENOB and SFDR.

Port of ``solid_dsp_tpu/analysis/measurements.py``, on the port's
``welch_psd`` (the framed FFT does the work; band selections are masks over
the PSD's bins).  Complex baseband: frequencies in the units of ``fs``, the
span [-fs/2, fs/2).  ``channel_power`` returns a tensor where x lies; the
others return host floats, dicts and numpy arrays, as JAX's do.
"""

from __future__ import annotations

import numpy as np
import torch

from .spectral import welch_psd

__all__ = ["channel_power", "acpr", "occupied_bandwidth", "papr_ccdf",
           "sinad_db", "enob", "sfdr_db"]


def _psd_and_freqs(x, fs: float, nfft: int, hop: int | None, window: str):
    hop = nfft // 2 if hop is None else hop
    p = welch_psd(torch.as_tensor(x), nfft=nfft, hop=hop, window=window,
                  fs=fs)
    return p, np.fft.fftfreq(nfft, d=1.0 / fs)


def _band_mask(f: np.ndarray, f_lo: float, f_hi: float) -> np.ndarray:
    return (f >= f_lo) & (f < f_hi)


def _masked_sum(p: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    return torch.sum(p * torch.as_tensor(m, dtype=p.dtype, device=p.device),
                     dim=-1)


def channel_power(x, fs: float, f_center: float = 0.0,
                  bw: float | None = None, nfft: int = 1024,
                  hop: int | None = None, window: str = "hann"
                  ) -> torch.Tensor:
    """Integrated power (linear) in [f_center - bw/2, f_center + bw/2);
    ``bw=None`` integrates the whole span (~ mean |x|^2)."""
    p, f = _psd_and_freqs(x, fs, nfft, hop, window)
    df = fs / nfft
    if bw is None:
        return torch.sum(p, dim=-1) * df
    m = _band_mask(f, f_center - bw / 2, f_center + bw / 2)
    if not m.any():
        raise ValueError("band contains no PSD bins; increase nfft")
    return _masked_sum(p, m) * df


def acpr(x, fs: float, bw: float, spacing: float | None = None,
         n_adjacent: int = 2, nfft: int = 2048, hop: int | None = None,
         window: str = "hann") -> dict:
    """Adjacent-channel power ratios of a carrier at 0: the main channel
    (width ``bw``) and ``n_adjacent`` channels each side at multiples of
    ``spacing`` (default ``bw``), in dB relative to the main channel.
    {"main_power", "lower_db", "upper_db", "offsets"}, nearest first."""
    spacing = bw if spacing is None else float(spacing)
    p, f = _psd_and_freqs(x, fs, nfft, hop, window)
    df = fs / nfft
    need = bw / 2 + n_adjacent * spacing
    if need > fs / 2:
        raise ValueError(f"outermost channel edge {need:g} exceeds "
                         f"Nyquist {fs / 2:g}")

    def band(center):
        return float(_masked_sum(p, _band_mask(f, center - bw / 2,
                                               center + bw / 2)) * df)
    main = band(0.0)
    offsets = [(i + 1) * spacing for i in range(n_adjacent)]
    lower = [10.0 * np.log10(band(-o) / main) for o in offsets]
    upper = [10.0 * np.log10(band(+o) / main) for o in offsets]
    return {"main_power": main, "lower_db": np.array(lower),
            "upper_db": np.array(upper), "offsets": np.array(offsets)}


def occupied_bandwidth(x, fs: float, fraction: float = 0.99,
                       nfft: int = 2048, hop: int | None = None,
                       window: str = "hann") -> float:
    """The span holding ``fraction`` of the power, (1 - fraction)/2 cut off
    each edge of the cumulative spectrum."""
    if not 0.0 < fraction < 1.0:
        raise ValueError("fraction must be in (0, 1)")
    p, f = _psd_and_freqs(x, fs, nfft, hop, window)
    order = np.argsort(f)
    c = np.cumsum(p.detach().cpu().numpy()[order])
    f_sorted = f[order]
    total = c[-1]
    if total <= 0:
        return 0.0
    tail = (1.0 - fraction) / 2.0
    lo = int(np.searchsorted(c, tail * total))
    hi = min(int(np.searchsorted(c, (1.0 - tail) * total)),
             len(f_sorted) - 1)
    return float(f_sorted[hi] - f_sorted[lo])


def papr_ccdf(x, thresholds_db) -> np.ndarray:
    """P[|x|^2 / mean > threshold] for each threshold in dB (host)."""
    x = torch.as_tensor(x)
    p = torch.real(x * torch.conj(x))
    ratio_db = 10.0 * torch.log10(torch.clamp(p / torch.mean(p), min=1e-30))
    th = torch.as_tensor(np.atleast_1d(np.asarray(thresholds_db, float)),
                         device=x.device)
    return (ratio_db[None, :] > th[:, None]).double().mean(dim=-1).cpu().numpy()


def _tone_and_rest(x, fs: float, nfft: int, hop: int | None, window: str,
                   guard_bins: int):
    """(fundamental power, the other bins' power (host), df): one-sided for
    real input, the full span for complex; DC's guard blanked first."""
    x = torch.as_tensor(x)
    hop = nfft // 2 if hop is None else hop
    real_in = not x.is_complex()
    p = welch_psd(x, nfft=nfft, hop=hop, window=window, fs=fs,
                  onesided=real_in).detach().cpu().numpy().copy()
    df = fs / nfft
    p[:guard_bins] = 0.0
    if not real_in:
        p[-guard_bins:] = 0.0
    k0 = int(np.argmax(p))
    lo, hi = max(k0 - guard_bins, 0), min(k0 + guard_bins + 1, len(p))
    fund = p[lo:hi].sum() * df
    p[lo:hi] = 0.0
    return fund, p, df


def sinad_db(x, fs: float = 1.0, nfft: int = 4096, hop: int | None = None,
             window: str = "blackman_harris", guard_bins: int = 8) -> float:
    """Signal to noise and distortion (dB): the fundamental's lobe against
    every other bin (``guard_bins`` covers the window's main lobe)."""
    fund, rest, df = _tone_and_rest(x, fs, nfft, hop, window, guard_bins)
    return float(10.0 * np.log10(fund / max(rest.sum() * df, 1e-30)))


def enob(x, fs: float = 1.0, **kw) -> float:
    """Effective number of bits: (SINAD - 1.76) / 6.02."""
    return (sinad_db(x, fs, **kw) - 1.76) / 6.02


def sfdr_db(x, fs: float = 1.0, nfft: int = 4096, hop: int | None = None,
            window: str = "blackman_harris", guard_bins: int = 8) -> float:
    """Spurious-free dynamic range (dB): the fundamental against the
    strongest spur, both integrated over +-guard_bins."""
    fund, rest, df = _tone_and_rest(x, fs, nfft, hop, window, guard_bins)
    ks = int(np.argmax(rest))
    lo, hi = max(ks - guard_bins, 0), min(ks + guard_bins + 1, len(rest))
    return float(10.0 * np.log10(fund / max(rest[lo:hi].sum() * df, 1e-30)))
