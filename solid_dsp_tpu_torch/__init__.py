"""solid_dsp_tpu_torch — the PyTorch / CUDA port of solid_dsp_tpu.

The JAX package ``solid_dsp_tpu`` is the reference; this package is its port
to PyTorch, with the TPU's Pallas kernels rewritten by hand for NVIDIA Hopper
(``csrc/``).  The module layout mirrors the JAX package, so each counterpart
has the same path.  The port imports ``torch`` and numpy and never ``jax`` or
``solid_dsp_tpu``.

Ported so far: the config-4 receive chain in all its branches
(``models.rx_chain``: FM, QPSK, AM or none; planar, cf32 or ci16 input),
with the fused DDC + FM kernel and the DDC body kernel (``ops.cuda_ddc``);
config 5, the polyphase channelizer (``models.channelizer``: the
commutator form, the fused kernel and the front-end kernel
``ops.cuda_chan``; the synthesis and 2x-oversampled banks),
``models.channel_bank.ChannelBank`` with the IIR bank kernel
(``ops.cuda_iir``) and ``models.monitor.SpectrumMonitor``; config 2, the
FFT engine (``ops.fft``, ``ops.matfft``) with the windowed 4096-point FFT
kernel (``ops.cuda_fft``) and spectral analysis (``analysis``); the Farrow
grid resampler (``ops.gridresample``, ``ops.farrow``) with its kernel
(``ops.cuda_resample``); ``parallel``, the sharded FIR, receive chain and
channelizer on ``torch.distributed``, with the time-sharded channelizer
front end whose halo exchange runs inside its kernel (``ops.cuda_halo``);
configs 1 and 3 and the FIR layer (``ops.fir``, ``ops.dotprod``); the
exact-AGC and reference-parity chains (the LUT NCO, the exact and
parallel AGC, impairment correction, every branch of ``make_rx_chain``
and the sharded unfused staging), with the two sequential scans, the
exact AGC (S1) and the QPSK Costas loop (S2), as kernels
(``ops.cuda_scan``); the IIR layer (``design.iirdes``, ``design.polymath``,
``ops.iir`` with zero-phase filtering, ``ops.zerophase``), the rate
changers (``ops.cic``, ``ops.halfband``, ``ops.resample``), the
autocorrelator (``ops.autocorr``), the FM broadcast-stereo back end
(``models.fm``) and the digital down-converter (``models.ddc``), with the
IIR filters' w-recurrence as a third sequential-scan kernel (S3).  Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (``device.py``).
"""

__version__ = "0.1.0"

from . import (analysis, design, device, interop, models, ops,  # noqa: F401
               parallel, streaming)
