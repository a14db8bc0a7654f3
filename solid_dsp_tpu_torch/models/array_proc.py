"""Array processing: beamforming, diversity combining, DoA estimation.

Port of ``solid_dsp_tpu/models/array_proc.py``: dense linear algebra over
an (N_antennas, T) snapshot matrix (covariance outer products, Hermitian
eigendecompositions by ``torch.linalg.eigh``, steering projections), the
products under ``device.fp32_exact``.  The grid peak-picking of
``music_doa`` and the small non-Hermitian parts of ``esprit_doa`` and
``root_music_doa`` (``np.linalg.eigvals``, ``np.roots``) stay on the host in
numpy, as in JAX.  An eigenvector is fixed only up to a phase, so two
decompositions agree on spectra, projectors and DoAs, not on the vectors.

Conventions: narrowband x(t) = sum_s a(theta_s) s_s(t) + n(t), a(theta) the
steering vector of a uniform linear array of spacing ``d`` wavelengths,
a_k = exp(+2 pi i k d sin(theta)).  The functions run where their input
lies; ``ula_steering`` on a numpy angle runs on ``device`` (the card unless
told otherwise).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import fp32_exact, resolve_device

__all__ = ["ula_steering", "spatial_covariance", "mrc_weights",
           "mvdr_weights", "beamform", "music_spectrum", "music_doa",
           "bartlett_spectrum", "esprit_doa", "root_music_doa"]


def ula_steering(n_antennas: int, theta, spacing: float = 0.5,
                 device=None) -> torch.Tensor:
    """Steering vector(s) (..., N) complex64 of a ULA; theta in radians
    from broadside (the phase in theta's precision, as JAX's, then
    complex64)."""
    if isinstance(theta, torch.Tensor):
        th = theta if device is None else theta.to(device)
    else:
        th = torch.as_tensor(np.asarray(theta, np.float64),
                             device=resolve_device(device))
    k = torch.arange(n_antennas, device=th.device, dtype=th.dtype)
    phase = 2j * np.pi * spacing * torch.sin(th)[..., None] * k
    return torch.exp(phase.to(torch.complex64))


def _mm(a, b):
    """a @ b in the promoted type (complex64 steering vectors against a
    complex128 covariance promote, as in JAX), full float32 on the card."""
    t = torch.promote_types(a.dtype, b.dtype)
    with fp32_exact():
        return a.to(t) @ b.to(t)


def spatial_covariance(X) -> torch.Tensor:
    """R = X X^H / T for an (N, T) snapshot block."""
    X = torch.as_tensor(X)
    return _mm(X, torch.conj(X).T) / X.shape[-1]


def mrc_weights(h) -> torch.Tensor:
    """Maximum-ratio combining for a known channel vector: h / ||h||^2."""
    h = torch.as_tensor(h)
    return h / torch.clamp(torch.vdot(h, h).real, min=1e-30)


def mvdr_weights(R, a, loading: float = 1e-3) -> torch.Tensor:
    """MVDR (Capon): w = R^-1 a / (a^H R^-1 a), ``loading`` the diagonal
    loading relative to tr(R) / N."""
    R, a = torch.as_tensor(R), torch.as_tensor(a)
    n = R.shape[-1]
    Rl = R + (loading * torch.trace(R).real / n) * torch.eye(
        n, dtype=R.dtype, device=R.device)
    Ria = torch.linalg.solve(Rl, a)
    return Ria / torch.vdot(a, Ria).real


def beamform(X, w) -> torch.Tensor:
    """y(t) = w^H x(t) over an (N, T) block."""
    return _mm(torch.conj(torch.as_tensor(w)), torch.as_tensor(X))


def _steering(R: torch.Tensor, thetas, spacing) -> torch.Tensor:
    return ula_steering(R.shape[-1], thetas, spacing, R.device)


def music_spectrum(R, thetas, n_sources: int,
                   spacing: float = 0.5) -> torch.Tensor:
    """MUSIC pseudo-spectrum 1 / ||E_n^H a(theta)||^2 over candidate angles
    (radians), E_n the N - n_sources eigenvectors of the smallest
    eigenvalues of Hermitian R."""
    R = torch.as_tensor(R)
    n = R.shape[-1]
    _, vecs = torch.linalg.eigh(R)
    En = vecs[:, : n - n_sources]
    proj = _mm(torch.conj(_steering(R, thetas, spacing)), En)
    denom = torch.sum((proj * torch.conj(proj)).real, -1)
    return 1.0 / torch.clamp(denom, min=1e-30)


def music_doa(R, n_sources: int, spacing: float = 0.5,
              grid: int = 2048) -> np.ndarray:
    """Grid-scan MUSIC DoA estimates (radians): the spectrum on a dense grid
    on the device, then on the host the ``n_sources`` strongest separated
    peaks, each refined by a 3-point parabola on the log-spectrum."""
    thetas = np.linspace(-np.pi / 2, np.pi / 2, grid, endpoint=True)
    spec = music_spectrum(R, thetas, n_sources, spacing).cpu().numpy()
    logp = np.log(spec)
    ismax = np.r_[False, (logp[1:-1] > logp[:-2]) & (logp[1:-1] > logp[2:]),
                  False]
    cand = np.argsort(np.where(ismax, -logp, np.inf))
    picks = []
    for i in cand:
        if not ismax[i]:
            break
        if all(abs(i - j) > grid // 64 for j in picks):
            picks.append(int(i))
        if len(picks) == n_sources:
            break
    out = []
    dth = thetas[1] - thetas[0]
    for i in picks:
        if 0 < i < grid - 1:
            y0, y1, y2 = logp[i - 1], logp[i], logp[i + 1]
            delta = 0.5 * (y0 - y2) / (y0 - 2 * y1 + y2 + 1e-30)
            out.append(thetas[i] + np.clip(delta, -1, 1) * dth)
        else:
            out.append(thetas[i])
    return np.sort(np.asarray(out))


def bartlett_spectrum(R, thetas, spacing: float = 0.5) -> torch.Tensor:
    """Conventional (delay-and-sum) spatial spectrum a^H R a / N^2."""
    R = torch.as_tensor(R)
    n = R.shape[-1]
    A = _steering(R, thetas, spacing)
    return torch.sum(_mm(torch.conj(A), R) * A, -1).real / (n * n)


def _signal_subspace(R, n_sources: int) -> np.ndarray:
    """The K strongest eigenvectors of Hermitian R, read back to the host
    (the device half of the gridless estimators)."""
    R = torch.as_tensor(R)
    _, vecs = torch.linalg.eigh(R)
    return vecs[:, R.shape[-1] - n_sources:].cpu().numpy()


def esprit_doa(R, n_sources: int, spacing: float = 0.5) -> np.ndarray:
    """TLS-ESPRIT DoA estimates (radians): the signal subspace on the
    device, the K x K rotation's eigenvalues on the host."""
    Es = _signal_subspace(R, n_sources)
    n = Es.shape[0]
    if n_sources >= n:
        raise ValueError("need n_sources < n_antennas")
    E1, E2 = Es[:-1], Es[1:]
    C = np.concatenate([E1, E2], axis=1)
    _, V = np.linalg.eigh(C.conj().T @ C)
    Vn = V[:, :n_sources]
    V12, V22 = Vn[:n_sources], Vn[n_sources:]
    psi = -V12 @ np.linalg.inv(V22)
    phases = np.angle(np.linalg.eigvals(psi))
    s = np.clip(phases / (2 * np.pi * spacing), -1.0, 1.0)
    return np.sort(np.arcsin(s))


def root_music_doa(R, n_sources: int, spacing: float = 0.5) -> np.ndarray:
    """Root-MUSIC DoA estimates (radians): the noise subspace on the device,
    the projector's diagonal sums and ``np.roots`` on the host; the K
    roots inside and nearest the unit circle."""
    R = torch.as_tensor(R)
    n = R.shape[-1]
    if n_sources >= n:
        raise ValueError("need n_sources < n_antennas")
    _, vecs = torch.linalg.eigh(R)
    En = vecs[:, : n - n_sources].cpu().numpy()
    G = En @ En.conj().T
    coeffs = np.array([np.trace(G, offset=l) for l in range(n - 1, -n, -1)])
    roots = np.roots(coeffs)
    roots = roots[np.abs(roots) < 1.0]
    keep = roots[np.argsort(1.0 - np.abs(roots))[:n_sources]]
    s = np.clip(np.angle(keep) / (2 * np.pi * spacing), -1.0, 1.0)
    return np.sort(np.arcsin(s))
