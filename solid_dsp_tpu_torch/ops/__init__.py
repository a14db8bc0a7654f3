"""Block operations on tensors: NCO, AGC (block, exact and parallel), the
FIR layer and its dot product, IIR filtering (direct form II, biquad
cascades, decimating and interpolating) with zero-phase filtering, the
autocorrelator, CIC and halfband rate changers and the arbitrary resamplers,
linear recurrences, the DDC bodies and their glue, the channelizer kernels
(K4, K5), the IIR bank (K6), the FFT engine with the windowed FFT (K7), the
Farrow grid resampler (K8) and the sequential scans (S1, S2, S3)."""

from . import (agc, autocorr, cic, cuda_build, cuda_chan, cuda_ddc,  # noqa: F401
               cuda_fft, cuda_iir, cuda_resample, cuda_scan, ddc, dotprod,
               farrow, fft, fir, gridresample, halfband, iir, linrec, matfft,
               nco, resample, zerophase)
