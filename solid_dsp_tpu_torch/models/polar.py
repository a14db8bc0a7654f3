"""Polar codes: Bhattacharyya construction, butterfly encoder, belief
propagation decoder.

Port of ``solid_dsp_tpu/models/polar.py``.  The construction is the same
host numpy.  Encoding is the F^(x)n butterfly: log2(N) stages of paired
XORs on a reshaped lattice.  Decoding is min-sum belief propagation on
the Arikan factor graph: each iteration a left pass (stages n-1 .. 0) and
a right pass (0 .. n-1), every butterfly of a stage at once, in the JAX
package's order of operations; the JAX ``lax.scan`` over iterations is a
Python loop here, and its stacked message arrays are lists of per-stage
tensors.  Codewords batch over leading axes.  LLRs: positive favours 0.

The functions run where their input lies; :class:`PolarCode` moves its
inputs to its device (the card unless told otherwise).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import bind_device, device_constant

__all__ = ["polar_construct", "polar_encode", "polar_decode_bp",
           "PolarCode"]


def polar_construct(n: int, k: int, design_snr_db: float = 2.0) -> np.ndarray:
    """The sorted information positions (the k most reliable of n) by
    Bhattacharyya parameter at the design Eb/N0: z0 = exp(-R Eb/N0),
    evolved z -> {2z - z^2, z^2}; encoder index i sees z[bitrev(i)]."""
    if n & (n - 1) or n <= 0:
        raise ValueError("polar block length must be a power of two")
    if not 0 < k <= n:
        raise ValueError("need 0 < k <= n")
    rate = k / n
    z0 = np.exp(-rate * 10.0 ** (design_snr_db / 10.0))
    z = np.array([z0], np.float64)
    while len(z) < n:
        z = np.concatenate([2.0 * z - z * z, z * z])
    nb = int(np.log2(n))
    rev = np.array([int(format(i, f"0{nb}b")[::-1], 2) for i in range(n)])
    return np.sort(np.argsort(z[rev])[:k]).astype(np.int32)


def _pairs(t: torch.Tensor, s: int):
    """Stage s's butterfly halves: index i pairs with i + 2^s inside
    blocks of 2^(s+1)."""
    d = 1 << s
    v = t.reshape(*t.shape[:-1], t.shape[-1] // (2 * d), 2, d)
    return v[..., 0, :], v[..., 1, :]


def _unpairs(top: torch.Tensor, bot: torch.Tensor) -> torch.Tensor:
    return torch.stack([top, bot], dim=-2).reshape(
        *top.shape[:-2], 2 * top.shape[-2] * top.shape[-1])


def _butterfly_xor(x: torch.Tensor) -> torch.Tensor:
    """The full F^(x)n butterfly over (..., N) int32 bits: at stage s the
    top of each pair becomes top XOR bottom."""
    n = int(np.log2(x.shape[-1]))
    for s in range(n):
        top, bot = _pairs(x, s)
        x = _unpairs(top ^ bot, bot)
    return x


def polar_encode(info_bits, info_set, n: int) -> torch.Tensor:
    """Encode (..., k) information bits into (..., N) codewords (frozen
    positions 0), int32."""
    info_bits = torch.as_tensor(info_bits).to(torch.int32)
    u = info_bits.new_zeros((*info_bits.shape[:-1], n))
    u[..., device_constant(np.asarray(info_set), info_bits.device,
                           torch.long)] = info_bits
    return _butterfly_xor(u)


def _minsum(a, b):
    return torch.sign(a) * torch.sign(b) * torch.minimum(torch.abs(a),
                                                         torch.abs(b))


def polar_decode_bp(llr, frozen_mask, n_iters: int = 40):
    """Belief-propagation decode of (..., N) channel LLRs with the (N,)
    frozen mask (1.0 where frozen).  Returns (u_hat (..., N), x_hat the
    re-encoded codeword, ok (...,): the L messages alone agree that every
    frozen bit is 0).  Frozen positions carry a prior of 1e4 toward 0."""
    llr = torch.as_tensor(llr)
    N = llr.shape[-1]
    n = int(np.log2(N))
    lead = llr.shape[:-1]
    frozen = torch.as_tensor(frozen_mask, device=llr.device).to(llr.dtype)
    zeros = llr.new_zeros((*lead, N))
    # Rm[s]: left-to-right messages into stage s's left side; Lm[s+1]:
    # right-to-left messages into its right side
    Rm = [torch.broadcast_to(frozen * 1e4, (*lead, N))] + [zeros] * (n - 1)
    Lm = [zeros] * n
    for _ in range(int(n_iters)):
        for s in range(n - 1, -1, -1):
            lt, lb = _pairs(llr if s == n - 1 else Lm[s + 1], s)
            rt, rb = _pairs(Rm[s], s)
            Lm[s] = _unpairs(_minsum(lt, lb + rb), _minsum(rt, lt) + lb)
        Rnew = list(Rm)
        for s in range(n - 1):          # stage n-1's right side is llr
            lt, lb = _pairs(Lm[s + 1], s)
            rt, rb = _pairs(Rnew[s], s)
            Rnew[s + 1] = _unpairs(_minsum(rt, lb + rb),
                                   _minsum(rt, lt) + rb)
        Rm = Rnew
    raw = (Lm[0] + Rm[0] < 0).to(torch.int32)
    is_frozen = frozen > 0
    ok = torch.all(torch.where(is_frozen, Lm[0] >= 0, True), dim=-1)
    u_hat = torch.where(is_frozen, 0, raw).to(torch.int32)
    return u_hat, _butterfly_xor(u_hat), ok


class PolarCode:
    """(N, K) polar code with BP decoding, on ``device`` (the card unless
    told otherwise)."""

    def __init__(self, n: int, k: int, design_snr_db: float = 2.0,
                 n_iters: int = 40, device=None):
        self.n, self.k = int(n), int(k)
        self.n_iters = int(n_iters)
        self.info_set = polar_construct(self.n, self.k, design_snr_db)
        mask = np.ones(self.n, np.float32)
        mask[self.info_set] = 0.0
        self.frozen_mask = mask
        self.device = bind_device(device)

    def encode(self, info_bits) -> torch.Tensor:
        return polar_encode(torch.as_tensor(info_bits).to(self.device),
                            self.info_set, self.n)

    def decode(self, llr, n_iters: int | None = None):
        """llr (..., N) -> (info_bits (..., K), ok (...,))."""
        u_hat, _x_hat, ok = polar_decode_bp(
            torch.as_tensor(llr).to(self.device), self.frozen_mask,
            self.n_iters if n_iters is None else int(n_iters))
        return u_hat[..., device_constant(self.info_set, self.device,
                                          torch.long)], ok

    def __repr__(self):
        return f"PolarCode [N={self.n}] [K={self.k}]"
