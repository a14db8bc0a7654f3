"""Synchronization & spreading sequences: Zadoff-Chu, m-sequences, Gold.

The building blocks every acquisition path needs (LTE/5G use Zadoff-Chu
for PSS/PRACH, GPS uses Gold codes, 802.11 uses m-sequence scrambling).
Generation is setup-time host work (numpy); the sequences then feed the
jitted correlators/matched filters.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

__all__ = ["zadoff_chu", "m_sequence", "gold_codes", "MSEQ_TAPS"]

# maximal-length LFSR feedback taps (polynomial exponents) per register size
MSEQ_TAPS = {
    3: (3, 2), 4: (4, 3), 5: (5, 3), 6: (6, 5), 7: (7, 6),
    9: (9, 5), 10: (10, 7), 11: (11, 9), 15: (15, 14), 23: (23, 18),
}


def zadoff_chu(root: int, length: int, shift: int = 0) -> np.ndarray:
    """Zadoff-Chu sequence: constant amplitude, zero cyclic autocorrelation.

    x[n] = exp(-j pi * root * n (n + cf + 2 shift) / length), cf = length%2.
    ``root`` must be coprime with ``length`` (prime lengths accept any
    root in 1..length-1).
    """
    if length < 1:
        raise ValueError("length must be positive")
    if np.gcd(root, length) != 1:
        raise ValueError("root must be coprime with length")
    n = np.arange(length)
    cf = length % 2
    return np.exp(-1j * np.pi * root * n * (n + cf + 2 * shift) / length)


@lru_cache(maxsize=64)
def _mseq_cached(nbits: int, taps: tuple, seed: int) -> tuple:
    mask = (1 << nbits) - 1
    state = seed & mask
    if state == 0:
        raise ValueError("seed must be nonzero")
    L = mask
    out = np.empty(L, dtype=np.int8)
    for i in range(L):
        out[i] = (state >> (nbits - 1)) & 1  # emit the MSB
        fb = 0
        for t in taps:
            fb ^= (state >> (t - 1)) & 1
        state = ((state << 1) | fb) & mask
    return tuple(out.tolist())


def m_sequence(nbits: int, taps: tuple | None = None,
               seed: int = 1) -> np.ndarray:
    """Maximal-length LFSR sequence of length 2^nbits - 1 (0/1 valued).

    Fibonacci LFSR with feedback from ``taps`` (polynomial exponents,
    defaults from MSEQ_TAPS).  Balanced (one extra 1), two-valued cyclic
    autocorrelation {L, -1}.
    """
    if taps is None:
        if nbits not in MSEQ_TAPS:
            raise ValueError(f"no default taps for nbits={nbits}; pass taps")
        taps = MSEQ_TAPS[nbits]
    return np.array(_mseq_cached(nbits, tuple(taps), seed), dtype=np.int8)


def gold_codes(nbits: int, count: int | None = None) -> np.ndarray:
    """Family of Gold codes (count x (2^nbits - 1)), 0/1 valued.

    XOR of two preferred-pair m-sequences at all relative shifts, plus the
    two parents; bounded cross-correlation across the family (the CDMA
    spreading construction).  Preferred pairs provided for nbits in
    {5, 6, 7, 9, 10, 11}.
    """
    preferred = {
        5: ((5, 3), (5, 4, 3, 2)),
        6: ((6, 5), (6, 5, 2, 1)),
        7: ((7, 3), (7, 3, 2, 1)),
        9: ((9, 5), (9, 6, 4, 3)),
        10: ((10, 7), (10, 9, 8, 5)),
        11: ((11, 9), (11, 8, 5, 2)),
    }
    if nbits not in preferred:
        raise ValueError(f"no preferred pair for nbits={nbits}")
    t1, t2 = preferred[nbits]
    u = m_sequence(nbits, t1)
    v = m_sequence(nbits, t2)
    L = len(u)
    n_total = L + 2
    count = n_total if count is None else min(count, n_total)
    fam = np.empty((count, L), dtype=np.int8)
    k = 0
    if k < count:
        fam[k] = u
        k += 1
    if k < count:
        fam[k] = v
        k += 1
    for sh in range(L):
        if k >= count:
            break
        fam[k] = u ^ np.roll(v, sh)
        k += 1
    return fam
