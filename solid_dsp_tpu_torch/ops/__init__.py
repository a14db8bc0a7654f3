"""Block operations on tensors: NCO, AGC, the DDC bodies and their glue,
the channelizer kernels (K4, K5) and the IIR bank (K6)."""

from . import (agc, cuda_build, cuda_chan, cuda_ddc, cuda_iir, ddc, fir,  # noqa: F401
               nco)
