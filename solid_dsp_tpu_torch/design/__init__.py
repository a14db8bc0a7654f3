"""Design-time math (host, numpy float64): the Kaiser FIR design and the
length estimates, the IIR designs (bilinear transform, Butterworth,
Chebyshev I and II, elliptic, the PLL loop filters, second-order sections)
with Bairstow's root finder, the windows and the FFT planner's integer
helpers."""

from . import firdes, iirdes, polymath, resources, specialfn, windows  # noqa: F401
