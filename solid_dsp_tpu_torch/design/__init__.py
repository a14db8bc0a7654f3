"""Design-time math (host, numpy float64): the Kaiser FIR design, the
windows and the FFT planner's integer helpers."""

from . import firdes, resources, specialfn, windows  # noqa: F401
