"""Integer and number-theory helpers of the FFT planner (host, Python ints).

Port of ``solid_dsp_tpu/design/resources.py`` (reference
``src/resources/mod.rs``: msb_index :21-23, factor :37-51, modpow :66-73,
primitive_root_prime :86-119).  They run when a plan is built, never on a
tensor.
"""

from __future__ import annotations

__all__ = ["msb_index", "factor", "unique_prime_factors", "modpow",
           "primitive_root_prime", "is_prime", "is_pow2", "next_pow2"]

_MAX_FACTORS = 64


def msb_index(x: int) -> int:
    """Bit length of ``x``: msb_index(1) == 1, msb_index(129) == 8."""
    return int(x).bit_length()


def factor(n: int) -> list[int]:
    """Prime factors with multiplicity, smallest first (trial division,
    at most 64 factors, as the reference)."""
    factors: list[int] = []
    n = int(n)
    while n > 1 and len(factors) < _MAX_FACTORS:
        i = 2
        while i <= n:
            if n % i == 0:
                factors.append(i)
                n //= i
                break
            i += 1
    return factors


def unique_prime_factors(n: int) -> list[int]:
    """Distinct prime factors of ``n`` in discovery order."""
    out: list[int] = []
    for p in factor(n):
        if p not in out:
            out.append(p)
    return out


def modpow(base: int, exp: int, n: int) -> int:
    """(base ** exp) % n."""
    return pow(int(base), int(exp), int(n))


def primitive_root_prime(n: int) -> int:
    """Smallest primitive root modulo the prime ``n``: g is one iff
    g^((n-1)/p) != 1 mod n for every distinct prime p of n - 1."""
    n = int(n)
    factors = unique_prime_factors(n - 1)
    h = 0
    for g in range(2, n):
        h = g
        if all(modpow(g, (n - 1) // p, n) != 1 for p in factors):
            break
    return h


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for 64-bit integers."""
    n = int(n)
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def is_pow2(n: int) -> bool:
    n = int(n)
    return n > 0 and (n & (n - 1)) == 0


def next_pow2(n: int) -> int:
    """Smallest power of two >= n."""
    n = int(n)
    return 1 if n <= 1 else 1 << (n - 1).bit_length()
