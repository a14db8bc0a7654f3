"""Block operations on tensors: NCO, AGC, the DDC bodies and their glue."""

from . import agc, cuda_ddc, ddc, fir, nco  # noqa: F401
