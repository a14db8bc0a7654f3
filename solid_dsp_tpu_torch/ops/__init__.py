"""Block operations on tensors: NCO, AGC, the DDC bodies and their glue,
the channelizer kernels (K4, K5), the IIR bank (K6), the FFT engine with
the windowed FFT (K7), and the Farrow grid resampler (K8)."""

from . import (agc, cuda_build, cuda_chan, cuda_ddc, cuda_fft, cuda_iir,  # noqa: F401
               cuda_resample, ddc, farrow, fft, fir, gridresample, matfft,
               nco)
