"""Design-time math (host, numpy float64): the Kaiser FIR design."""

from . import firdes, specialfn, windows  # noqa: F401
