"""Block operations on tensors: NCO, AGC (block, exact and parallel), the
FIR layer and its dot product, linear recurrences, the DDC bodies and their
glue, the channelizer kernels (K4, K5), the IIR bank (K6), the FFT engine
with the windowed FFT (K7), the Farrow grid resampler (K8) and the
sequential scans (S1, S2)."""

from . import (agc, cuda_build, cuda_chan, cuda_ddc, cuda_fft, cuda_iir,  # noqa: F401
               cuda_resample, cuda_scan, ddc, dotprod, farrow, fft, fir,
               gridresample, linrec, matfft, nco)
