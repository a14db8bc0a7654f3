"""Block operations on tensors: NCO, AGC, the fused DDC + FM body."""

from . import agc, cuda_ddc, ddc, fir, nco  # noqa: F401
