"""Direct-sequence spread spectrum: spread, despread, acquire, RAKE.

Port of ``solid_dsp_tpu/models/dsss.py``: spreading is a rank-1 outer
product (symbol by chip); despreading a (T, N) by (N,) product; code
acquisition one correlation over all chip lags (``conv1d_mxu``) and the
despread energy at each candidate offset, where JAX vmaps a dynamic slice
over the offsets (:87), here one gather of an (offsets, symbols) index
grid; the RAKE receiver despreads at its fingers and combines them by
maximum ratio with gains from a joint least-squares fit to the pilots
(``torch.linalg.solve_ex``: no host sync).  Products run in full float32
(``fp32_exact``).  The functions run where their input lies.
"""

from __future__ import annotations

import torch

from ..device import fp32_exact
from ..ops.fir import conv1d_mxu

__all__ = ["dsss_spread", "dsss_despread", "dsss_acquire",
           "rake_finger_gains", "rake_despread"]


def _code(code, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(code).to(like.device, like.dtype)


def dsss_spread(symbols, code) -> torch.Tensor:
    """out[..., t N + i] = symbols[..., t] code[i] (chips at the chip
    rate)."""
    symbols = torch.as_tensor(symbols)
    code = _code(code, symbols)
    chips = symbols[..., None] * code
    return chips.reshape(*symbols.shape[:-1],
                         symbols.shape[-1] * code.shape[-1])


@fp32_exact()
def dsss_despread(x, code) -> torch.Tensor:
    """Despread a chip-aligned stream: (..., T) symbol estimates,
    normalised by the code's energy (spread then despread is the
    identity)."""
    x = torch.as_tensor(x)
    code = _code(code, x)
    N = code.shape[-1]
    T = x.shape[-1] // N
    blocks = x[..., : T * N].reshape(*x.shape[:-1], T, N)
    return (blocks @ torch.conj(code).resolve_conj()) / torch.sum(
        torch.abs(code) ** 2)


def dsss_acquire(x, code, max_offset: int):
    """Code acquisition: the chip offset in [0, max_offset) whose despread
    energy is largest.  Returns (offset, metric), metric[k] the mean
    |correlation|^2 of the symbols that fit at lag k."""
    x = torch.as_tensor(x)
    code = _code(code, x)
    N = code.shape[-1]
    c = conv1d_mxu(x, torch.conj(code).resolve_conj())
    T = (c.shape[-1] - max_offset) // N
    idx = (torch.arange(max_offset, device=c.device)[:, None]
           + N * torch.arange(T, device=c.device)[None, :])
    seg = torch.mean(torch.abs(c[..., idx]) ** 2, dim=-1)
    return torch.argmax(seg, dim=-1), seg


@fp32_exact()
def rake_finger_gains(x, code, pilots, offsets) -> torch.Tensor:
    """The complex path gains at the finger offsets by joint least squares
    against the re-spread pilot chips: (A^H A) g = A^H x with A the shifted
    pilot chips (independent correlations would keep the short code's
    partial cross-correlations)."""
    x = torch.as_tensor(x)
    ref = dsss_spread(torch.as_tensor(pilots).to(x.device, x.dtype), code)
    L = ref.shape[-1]
    refs = torch.stack([
        torch.cat([ref.new_zeros(int(o)), ref])[:L] for o in offsets])
    gram = torch.conj(refs) @ refs.T
    rhs = torch.conj(refs) @ x[..., :L]
    return torch.linalg.solve_ex(gram, rhs[..., None])[0][..., 0]


@fp32_exact()
def rake_despread(x, code, offsets, gains) -> torch.Tensor:
    """RAKE receiver: despread at each finger offset (Python ints) and
    combine by maximum ratio with the complex ``gains``, normalised so a
    unit-energy channel gives unit-gain symbols."""
    x = torch.as_tensor(x)
    fingers = torch.stack([dsss_despread(torch.roll(x, -int(o), dims=-1),
                                         code) for o in offsets], dim=-1)
    g = torch.as_tensor(gains).to(x.device, x.dtype)
    return (fingers @ torch.conj(g).resolve_conj()) / torch.sum(
        torch.abs(g) ** 2)
