"""Polynomial root finding (Bairstow) and binomial expansions.

Port of ``solid_dsp_tpu/design/polymath.py`` (host numpy float64, the same
arithmetic in the same order).  Parity: reference ``src/math/poly.rs`` — find_roots (:50-74),
find_roots_bairstow (:95-161), bairstow recursion (:184-250),
bairstow persistent restart (:274-295), expand_binomial (:312-330),
expand_binomial_pm (:348-373).

Polynomials are ascending-power float64 coefficient arrays.  These run at
design time (IIR bilinear transform, stability checks) on the host.
"""

from __future__ import annotations

import numpy as np

from .specialfn import csqrt

__all__ = [
    "find_roots",
    "find_roots_bairstow",
    "find_roots_bairstow_recursion",
    "find_roots_bairstow_persistent",
    "expand_binomial",
    "expand_binomial_pm",
]

_ITERATIONS = 32
_TOLERANCE = 1e-16


class PolynomialError(ValueError):
    pass


def find_roots(polynomial) -> np.ndarray:
    """All complex roots, sorted by (re ascending, im descending).

    Parity: ref math/poly.rs:50-74 (same sort order as the doctest).
    """
    roots = find_roots_bairstow(polynomial)
    order = sorted(range(len(roots)), key=lambda i: (roots[i].real, -roots[i].imag))
    return np.array([roots[i] for i in order], dtype=np.complex128)


def find_roots_bairstow(polynomial) -> list[complex]:
    """Bairstow root extraction, unsorted (deflation order).

    Parity: ref math/poly.rs:95-161, including the input/output polynomial
    ping-pong and the final linear-root extraction for even degree.
    """
    input_poly = [float(x) for x in np.asarray(polynomial, dtype=np.float64)]
    output_poly: list[float] = []
    roots: list[complex] = []

    n = len(input_poly)
    if n == 0:
        raise PolynomialError("invalid order")

    r = n % 2
    ell = (n - r) // 2
    j = ell - 1 + r
    last_i = 0
    for i in range(j):
        if i % 2 == 0:
            if input_poly[n - 1] == 0.0:
                raise PolynomialError("irreducible polynomial")
            u = input_poly[n - 2] / input_poly[n - 1]
            v = input_poly[n - 3] / input_poly[n - 1]
            if n > 3:
                output_poly, u, v = find_roots_bairstow_persistent(input_poly, u, v)
        else:
            if output_poly[n - 1] == 0.0:
                raise PolynomialError("irreducible polynomial")
            u = output_poly[n - 2] / output_poly[n - 1]
            v = output_poly[n - 3] / output_poly[n - 1]
            if n > 3:
                input_poly, u, v = find_roots_bairstow_persistent(output_poly, u, v)

        root = csqrt(u * u - 4.0 * v)
        roots.append(0.5 * (-u + root))
        roots.append(0.5 * (-u - root))
        n -= 2
        last_i = i

    if r == 0:
        if last_i % 2 == 0:
            roots.append(complex(-output_poly[0] / output_poly[1], 0.0))
        else:
            roots.append(complex(-input_poly[0] / input_poly[1], 0.0))

    return roots


def find_roots_bairstow_recursion(polynomial, u_estimate: float, v_estimate: float):
    """One Bairstow run: find quadratic factor x^2 + u x + v and deflate.

    Parity: ref math/poly.rs:184-250 (32 iterations, 1e-16 tolerance, the
    halving fallback when the Jacobian metric underflows).
    Returns (reduced_polynomial, u, v).
    """
    p = [float(x) for x in polynomial]
    if len(p) < 3:
        raise PolynomialError("invalid polynomial length")

    u, v = float(u_estimate), float(v_estimate)
    n = len(p) - 1
    iterations = 0
    b = [0.0] * (n + 1)
    f = [0.0] * (n + 1)

    while iterations != _ITERATIONS:
        iterations += 1
        for i in range(n - 2, -1, -1):
            b[i] = p[i + 2] - u * b[i + 1] - v * b[i + 2]
            f[i] = b[i + 2] - u * f[i + 1] - v * f[i + 2]
        c = p[1] - u * b[0] - v * b[1]
        g = b[1] - u * f[0] - v * f[1]
        d = p[0] - v * b[0]
        h = b[0] - v * f[0]

        q0 = v * g * g
        q1 = h * (h - u * g)
        metric = abs(q0 + q1)
        if metric < _TOLERANCE:
            u *= 0.5
            v *= 0.5
            continue
        q = 1.0 / (q0 + q1)

        du = -q * (-h * c + g * d)
        dv = -q * (-g * v * c + (g * u - h) * d)
        step = abs(du) + abs(dv)
        u += du
        v += dv
        if step < _TOLERANCE:
            break

    if iterations == _ITERATIONS:
        raise PolynomialError("failed to converge")

    return b[: n - 1], u, v


def find_roots_bairstow_persistent(polynomial, u_estimate: float, v_estimate: float):
    """Bairstow with the reference's restart schedule on non-convergence.

    Parity: ref math/poly.rs:274-295 (restart value cos(i*1.1)*exp(i*0.2)).
    """
    u, v = float(u_estimate), float(v_estimate)
    for i in range(_ITERATIONS):
        try:
            return find_roots_bairstow_recursion(polynomial, u, v)
        except PolynomialError:
            val = np.cos(i * 1.1) * np.exp(i * 0.2)
            u = val
            v = val
    raise PolynomialError("failed to converge")


def expand_binomial(n_roots: int) -> np.ndarray:
    """Coefficients of (1 + x)^n, ascending.  Parity: ref math/poly.rs:312-330."""
    n_roots = int(n_roots)
    if n_roots == 0:
        return np.array([0.0])
    out = np.zeros(n_roots + 1, dtype=np.float64)
    out[0] = 1.0
    for i in range(n_roots):
        for j in range(i + 1, 0, -1):
            out[j] += out[j - 1]
    return out


def expand_binomial_pm(m_roots: int, k_roots: int) -> np.ndarray:
    """Coefficients of (1 + x)^m (1 - x)^k, ascending.

    Parity: ref math/poly.rs:348-373.
    """
    m_roots, k_roots = int(m_roots), int(k_roots)
    roots = m_roots + k_roots
    out = np.zeros(roots + 1, dtype=np.float64)
    out[0] = 1.0
    for i in range(m_roots):
        for j in range(i + 1, 0, -1):
            out[j] += out[j - 1]
    for i in range(m_roots, roots):
        for j in range(i + 1, 0, -1):
            out[j] -= out[j - 1]
    return out
