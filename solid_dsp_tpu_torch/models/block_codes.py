"""Short block codes: Hamming, SECDED, Golay, repetition.

Port of ``solid_dsp_tpu/models/block_codes.py``: Hamming(7,4), SECDED(8,4),
Hamming(12,8), Golay(23,12)/(24,12), SECDED(22,16)/(39,32)/(72,64) and
repetition, by name from ``SCHEMES``.  The generator, parity-check and
syndrome matrices and the syndrome -> error-pattern tables are the JAX
package's host numpy.  Every encoder is a GF(2) product (blocks, k) @ (k, n)
mod 2 and every decoder a syndrome product followed by a gather from the
syndrome table (a device copy of the host table) and an XOR.  The products
run as float32 matmuls under ``device.fp32_exact`` (``utils/bits.py::
gf2_matmul``; sums of at most 72 ones): ``torch.matmul`` has no int32
kernel on the card.

Golay(23,12) is perfect: its 2^11 syndromes are exactly the 2048 error
patterns of weight <= 3.  The functions run where their input lies;
:class:`BlockCode` moves its input to its device (the card unless told
otherwise).
"""

from __future__ import annotations

from functools import lru_cache
from itertools import combinations

import numpy as np
import torch

from ..device import bind_device, device_constant
from ..utils.bits import gf2_matmul

__all__ = ["gf2_encode", "hamming_matrices", "golay_tables",
           "block_encode", "block_decode", "BlockCode", "SCHEMES"]

# Golay generator polynomial x^11 + x^10 + x^6 + x^5 + x^4 + x^2 + 1.
_GOLAY_GEN = 0b110001110101


def _poly_mod(value: int, gen: int, gen_deg: int) -> int:
    """value(x) mod gen(x) over GF(2), ints as bit-polynomials (host)."""
    d = value.bit_length() - 1
    while d >= gen_deg:
        value ^= gen << (d - gen_deg)
        d = value.bit_length() - 1
    return value


def _bits_msb_first(value: int, width: int) -> np.ndarray:
    return np.array([(value >> (width - 1 - i)) & 1 for i in range(width)],
                    dtype=np.uint8)


def gf2_encode(data, G) -> torch.Tensor:
    """Batched GF(2) encode: (blocks, k) @ G (k, n) mod 2, int32."""
    data = torch.as_tensor(data)
    return gf2_matmul(data, device_constant(np.asarray(G, np.float32),
                                            data.device))


@lru_cache(maxsize=None)
def hamming_matrices(m: int, k: int):
    """Systematic (shortened) Hamming matrices for m parity bits, k data
    bits: ``(G (k, k+m), H (m, k+m), col_ids (k+m,))``, codewords
    ``[data | parity]`` (the JAX package's construction)."""
    if k > (1 << m) - 1 - m:
        raise ValueError(f"Hamming with {m} parity bits supports at most "
                         f"{(1 << m) - 1 - m} data bits, got {k}")
    data_cols = [v for v in range(3, 1 << m) if v & (v - 1)][:k]
    parity_cols = [1 << (m - 1 - i) for i in range(m)]
    cols = np.array(data_cols + parity_cols, dtype=np.int64)
    H = np.stack([_bits_msb_first(int(c), m) for c in cols], axis=1)
    P = H[:, :k].T
    G = np.concatenate([np.eye(k, dtype=np.uint8), P], axis=1)
    return G.astype(np.uint8), H.astype(np.uint8), cols


@lru_cache(maxsize=None)
def _hamming_lut(m: int, k: int):
    """Syndrome -> (error row (n,), uncorrectable flag) tables."""
    _, _, cols = hamming_matrices(m, k)
    n = k + m
    errors = np.zeros((1 << m, n), dtype=np.uint8)
    bad = np.ones(1 << m, dtype=np.uint8)
    bad[0] = 0
    for pos, c in enumerate(cols):
        errors[c, pos] = 1
        bad[c] = 0
    return errors, bad


def _lut(table, dev, dtype=torch.int32) -> torch.Tensor:
    return device_constant(np.asarray(table), dev, dtype)


def _syndrome_int(r: torch.Tensor, S_cols) -> torch.Tensor:
    """Syndromes as ints, MSB first: (r @ S_cols mod 2) . 2^(m-1..0)."""
    s_bits = gf2_matmul(r, device_constant(np.asarray(S_cols, np.float32),
                                           r.device))
    m = s_bits.shape[-1]
    weights = _lut(1 << np.arange(m - 1, -1, -1), r.device)
    return torch.sum(s_bits * weights, -1, dtype=torch.int32).long()


def _hamming_decode(r, m: int, k: int):
    _, H, _ = hamming_matrices(m, k)
    errors, bad = _hamming_lut(m, k)
    s = _syndrome_int(r, H.T)
    e = _lut(errors, r.device)[s]
    fail = _lut(bad, r.device)[s]
    return (r ^ e)[:, :k], fail.bool()


def _secded_encode(data, m: int, k: int):
    G, _, _ = hamming_matrices(m, k)
    inner = gf2_encode(data, G)
    overall = torch.sum(inner, -1, dtype=torch.int32) & 1
    return torch.cat([inner, overall[:, None]], -1)


def _secded_decode(r, m: int, k: int):
    """Extended Hamming: correct singles, detect (flag) doubles."""
    _, H, _ = hamming_matrices(m, k)
    errors, bad_lut = _hamming_lut(m, k)
    inner = r[:, :-1]
    s = _syndrome_int(inner, H.T)
    parity = torch.sum(r, -1, dtype=torch.int32) & 1
    e = _lut(errors, r.device)[s]
    corrected = (inner ^ e)[:, :k]
    odd = parity == 1
    fail = torch.where(odd, _lut(bad_lut, r.device)[s].bool(), s != 0)
    return corrected, fail


@lru_cache(maxsize=None)
def golay_tables():
    """Host tables for the perfect (23,12) Golay code:
    ``(G (12, 23), S (23, 11), lut (2048, 23))``."""
    deg = 11
    P = np.zeros((12, deg), dtype=np.uint8)
    for i in range(12):
        P[i] = _bits_msb_first(_poly_mod(1 << (22 - i), _GOLAY_GEN, deg), deg)
    G = np.concatenate([np.eye(12, dtype=np.uint8), P], axis=1)
    S = np.zeros((23, deg), dtype=np.uint8)
    for j in range(23):
        S[j] = _bits_msb_first(_poly_mod(1 << (22 - j), _GOLAY_GEN, deg), deg)
    lut = np.zeros((1 << deg, 23), dtype=np.uint8)
    seen = np.zeros(1 << deg, dtype=bool)
    pw = [1 << (deg - 1 - i) for i in range(deg)]
    syn_of = [int(sum(int(b) * w for b, w in zip(S[j], pw)))
              for j in range(23)]
    for wgt in (1, 2, 3):
        for pos in combinations(range(23), wgt):
            s = 0
            for p in pos:
                s ^= syn_of[p]
            assert not seen[s], "Golay syndrome collision"
            seen[s] = True
            for p in pos:
                lut[s, p] = 1
    seen[0] = True
    assert seen.all(), "Golay weight-3 patterns must cover every syndrome"
    return G, S, lut


def _golay23_decode(r):
    _, S, lut = golay_tables()
    s = _syndrome_int(r, S)
    e = _lut(lut, r.device)[s]
    return (r ^ e)[:, :12], e


def _golay24_encode(data):
    G, _, _ = golay_tables()
    inner = gf2_encode(data, G)
    overall = torch.sum(inner, -1, dtype=torch.int32) & 1
    return torch.cat([inner, overall[:, None]], -1)


def _golay24_decode(r):
    """Correct <= 3 errors; flag patterns the parity proves were >= 4."""
    data, e = _golay23_decode(r[:, :23])
    nflip = torch.sum(e, -1, dtype=torch.int32)
    parity = torch.sum(r, -1, dtype=torch.int32) & 1
    est_p24 = parity ^ (nflip & 1)
    return data, (nflip == 3) & (est_p24 == 1)


SCHEMES = {
    # name: (k, n, description)
    "none": (1, 1, "pass-through"),
    "rep3": (1, 3, "3x repetition, majority vote"),
    "rep5": (1, 5, "5x repetition, majority vote"),
    "h74": (4, 7, "Hamming(7,4), corrects 1"),
    "h84": (4, 8, "SECDED(8,4): corrects 1, detects 2"),
    "h128": (8, 12, "shortened Hamming(12,8), corrects 1"),
    "g2312": (12, 23, "perfect Golay(23,12), corrects 3"),
    "g2412": (12, 24, "extended Golay(24,12): corrects 3, detects 4"),
    "secded2216": (16, 22, "SECDED(22,16)"),
    "secded3932": (32, 39, "SECDED(39,32)"),
    "secded7264": (64, 72, "SECDED(72,64)"),
}

_HAMMING_PARAMS = {"h74": (3, 4), "h128": (4, 8)}
_SECDED_PARAMS = {"h84": (3, 4), "secded2216": (5, 16),
                  "secded3932": (6, 32), "secded7264": (7, 64)}


def _to_blocks(bits, k: int) -> torch.Tensor:
    bits = torch.as_tensor(bits)
    if bits.dim() == 1:
        if bits.shape[0] % k:
            raise ValueError(f"bit count {bits.shape[0]} not a multiple of "
                             f"k={k}")
        bits = bits.reshape(-1, k)
    elif bits.dim() != 2 or bits.shape[-1] != k:
        raise ValueError(f"expected (n,) or (blocks, {k}) bits, "
                         f"got {tuple(bits.shape)}")
    return bits.to(torch.int32)


def _check(scheme: str):
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}; one of {list(SCHEMES)}")
    return SCHEMES[scheme]


def block_encode(bits, scheme: str) -> torch.Tensor:
    """Encode a flat bit vector (or (blocks, k) array) -> (blocks, n)."""
    k, n, _ = _check(scheme)
    d = _to_blocks(bits, k)
    if scheme == "none":
        return d
    if scheme.startswith("rep"):
        return torch.repeat_interleave(d, n, dim=-1)
    if scheme in _HAMMING_PARAMS:
        m, kk = _HAMMING_PARAMS[scheme]
        return gf2_encode(d, hamming_matrices(m, kk)[0])
    if scheme in _SECDED_PARAMS:
        return _secded_encode(d, *_SECDED_PARAMS[scheme])
    if scheme == "g2312":
        return gf2_encode(d, golay_tables()[0])
    return _golay24_encode(d)


def block_decode(bits, scheme: str):
    """Decode (blocks, n) (or flat) hard bits -> ((blocks, k), fail flags);
    ``fail[b]`` marks a detected but uncorrectable pattern."""
    k, n, _ = _check(scheme)
    r = _to_blocks(bits, n)
    nb = r.shape[0]
    no_fail = torch.zeros(nb, dtype=torch.bool, device=r.device)
    if scheme == "none":
        return r, no_fail
    if scheme.startswith("rep"):
        votes = torch.sum(r, -1, keepdim=True)
        return (votes > n // 2).to(torch.int32), no_fail
    if scheme in _HAMMING_PARAMS:
        m, kk = _HAMMING_PARAMS[scheme]
        return _hamming_decode(r, m, kk)
    if scheme in _SECDED_PARAMS:
        return _secded_decode(r, *_SECDED_PARAMS[scheme])
    if scheme == "g2312":
        data, _ = _golay23_decode(r)
        return data, no_fail
    return _golay24_decode(r)


class BlockCode:
    """Scheme-by-name block code, ``BlockCode("g2412")``, on ``device`` (the
    card unless told otherwise)."""

    def __init__(self, scheme: str = "h74", device=None):
        self.k, self.n, self.description = _check(scheme)
        self.scheme = scheme
        self.device = bind_device(device)

    @property
    def rate(self) -> float:
        return self.k / self.n

    def encode(self, bits) -> torch.Tensor:
        """Flat data bits (multiple of k) -> flat coded bits."""
        return block_encode(torch.as_tensor(bits).to(self.device),
                            self.scheme).reshape(-1)

    def decode(self, bits):
        """Flat coded bits -> (flat data bits, per-block fail flags)."""
        data, fail = block_decode(torch.as_tensor(bits).to(self.device),
                                  self.scheme)
        return data.reshape(-1), fail

    def __repr__(self):
        return (f"BlockCode({self.scheme!r}: ({self.n},{self.k}) "
                f"rate {self.rate:.3f} — {self.description})")
