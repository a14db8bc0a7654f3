"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths through the kernels built from
solid_dsp_tpu_torch/csrc/:

* the config-4 receive chain of bench.py and BASELINE.json
  (solid_dsp_tpu_torch.models.rx_chain: 16M-sample planar f32 blocks,
  64-tap NCO-folded bandpass FIR decimating by 4, block AGC, FM, QPSK and AM
  demodulation): the fused DDC+FM kernel (ddc_fm.cu) and the DDC body
  kernel (ddc_body.cu), on its aligned (K2) and unaligned (K3) routes;
* config 5, the 256-channel polyphase filterbank of BASELINE.json and
  bench_all.py's channelizer rows (M = 256, K = 8, blocks of 2^22 complex
  samples): PolyphaseChannelizer through the fused channelizer kernel (K4,
  channelizer.cu) and the front-end kernel (K5, channelizer.cu),
  ChannelBank through K4 and the IIR bank kernel (K6, iir_bank.cu), and
  SpectrumMonitor through K4;
* config 2 of BASELINE.json, windowed 4096-point FFT spectral analysis
  (bench_all.py:457-502: F = 4096 frames of N = 4096 points, 2^24
  samples): windowed_fft, windowed_fft_planar and spectrogram of
  solid_dsp_tpu_torch.ops.fft through the windowed FFT kernel (K7,
  windowed_fft.cu), on config 2's chirp;
* the Farrow grid resampler (bench_all.py:572-582: ratio 48000/44100,
  blocks of 2^22): make_farrow_kernel_resampler through its kernel (K8,
  farrow.cu);
* configs 1 and 3 of BASELINE.json (ops/fir.py: FIRFilter on a 1M-sample
  tone, RationalResampler 3/2 and 1/8), the exact-AGC and reference-parity
  receive chains (the LUT NCO, fir_decim_apply, the exact AGC through the
  sequential-scan kernel S1 and the parallel Newton AGC) and the QPSK
  Costas loop through S2 (seq_scan.cu);
* the IIR layer and the rate changers (ops/iir.py, ops/zerophase.py,
  ops/cic.py, ops/halfband.py, ops/resample.py, ops/autocorr.py), the FM
  broadcast-stereo back end and the DDC (models/fm.py, models/ddc.py): the
  IIR filters' w-recurrence through S3, the time-parallel chunk-and-join
  kernel (iir_scan.cu), on the "scan" and "parallel" routes alike, and the
  SOS cascades through its fused cascade form, at the TPU sweep's sizes
  (bench_all.py's CIC, halfband and arbitrary-resampler rows, 2^22
  samples) and a 192 kHz stereo multiplex of 2^22 samples;
* parallel/, config 5's channels sharded over time and config 4 at scale,
  on an NCCL group of one rank (one card): the fused halo-exchange front
  end make_fused_channelizer_frontend through its kernel (K9,
  halo_frontend.cu), K9 as four shards on one card exchanging halos
  through each other's regions, make_sharded_channelizer ("xla", "fused"
  through K4) and make_sharded_rx_chain (planar FM through K1);
* the fused route at fir_precision="default" (K1-K3's single-pass bf16
  "fast" mode), complex128 and 300 taps;
* the fused route at large decimations (128 taps at M = 200, 256 at
  M = 128; FM also at 256 taps, M = 240 and 512 taps, M = 256), where the
  tensor-core spans do not fit shared memory: the body's and K1's
  direct-form routes (ddc_body.cu, ddc_fm.cu) in both modes.

Phases, one line each:

  1. device: GPU name and power limit, torch and CUDA versions;
  2. build: every kernel from the repository's sources (one nvcc each, all
     at once), with ptxas's registers and spills;
  3. FM kernel (TF32 x3 on the tensor cores, the discriminator and stats in
     its epilogue) vs its plain PyTorch version on the card, L = 2^24
     (f32), two launches on the block bit-equal, timed over a CUDA graph
     beside its bound, its back-to-back time and its plain version;
  4. FM kernel vs the plain version in float64 on the CPU, L = 2^20;
  5. FM chain (kernel) vs chain (plain version) over 4 blocks with the state
     carried, launches counted; the audio of the tone must be its frequency;
  6. throughput of both FM chains with CUDA events over 20 blocks;
  7. body kernel (TF32 x3 on the tensor cores) vs its plain version on the
     card: L = 2^24 (K2's route), 2^24 + 52 (K3's route) and 32 (a block
     shorter than the filter), timed over a CUDA graph beside its bound,
     its plain version and one strided conv1d (the library call);
  8. body kernel vs the plain version in float64 on the CPU, L = 2^20, at
     the chain's "highest" contract (>= 100 dB);
  9. QPSK, AM and unaligned-FM chains (kernel vs plain version) over 4
     blocks each with the state carried, launches counted: QPSK symbols
     and carrier offset, the AM envelope's tone, the FM tone read back;
 10. throughput of the QPSK and AM chains with CUDA events over 20 blocks,
     and for them and the FM chain (K1) the host's enqueue time, the
     profiler's device time a block, the idle share and the largest
     kernels;
 11. K4 vs its plain version on the card, x3 and fast, planar and complex
     layouts (bit-equal), timed over a CUDA graph, and x3 vs the plain
     version in float64 on the CPU at 2^18;
 12. K5 vs its plain version, beside one grouped conv1d (the library call);
 13. K6 (the chunked recurrence) vs its plain version at T = 2^14,
     C = 256, shared, per-channel and narrow (cutoff 0.005) sections, two
     blocks with the state carried, timed over a CUDA graph beside its
     bound and its plain version;
 14. PolyphaseChannelizer(256, 8) over 4 blocks, fused (K4's complex
     layout, x3) then pallas (K5), against the "xla" formulation and the
     plain versions, launches counted; a +c/M tone lands in channel c;
 15. ChannelBank(256, fused, AGC) over 4 blocks, kernels vs plain, launches
     counted; SpectrumMonitor(256, fused) events vs the plain run;
 16. throughput in Msamples/s of input over 20 blocks with CUDA events
     (fused x3, fused fast, "xla", ChannelBank), host enqueue time, and the
     device's busy time from torch.profiler with the idle share it leaves;
 17. K7 vs its plain version on the card, F = 4096 x N = 4096, Hamming and
     Blackman-Harris, x3 and fast, planar and complex layouts, timed beside
     torch.fft.fft on the windowed frames (the library call, over a CUDA
     graph like the kernel), and vs numpy float64 on the CPU at F = 64;
 18. the config-2 path, launches counted: windowed_fft (auto) vs "xla" on
     complex64 frames; windowed_fft_planar and spectrogram(frame=4096) of a
     2^24-sample chirp, each frame's peak bin within 1 of the chirp's
     frequency; welch_psd of a tone;
 19. config-2 throughput, Msamples/s and GFLOP/s (5 N log2 N a frame) over
     20 calls with CUDA events (planar x3 and fast, complex auto, "xla",
     the plain version), host enqueue, device busy time and idle share;
 20. K8 over 3 blocks of 2^22 (ratio 48000/44100) with the state carried,
     launches counted, vs the torch-ops engine (n_valid, t0, tail equal),
     and vs an independent float64 numpy reference at 2^16;
 21. Farrow throughput, Msamples/s of input over 20 blocks, K8 vs the
     torch-ops engine;
 22. K9 at world size 1 (NCCL), M = 256, K = 8, 4 blocks of 2^22 with the
     tail carried, launches counted: against its plain version and K5 on
     the same blocks (2e-5 max|Y|), a tone in its channel, the new tail
     rows bit-equal;
 23. K9 as four shards on one card, on four streams launched 0 -> 3 and
     3 -> 0, 3 blocks of 4 x 2^22: the shards' z against K5 on the whole
     2^24 block (2e-5 max|Y|); a hang fails the phase after 60 s;
 24. the entry points at world size 1 against the single-card chains,
     launches counted: make_sharded_channelizer "xla" and "fused" (x3) at
     config 5 against PolyphaseChannelizer, make_sharded_rx_chain planar
     FM at config 4 (2^24 samples) against make_rx_chain, at x3 and at
     fir_precision="default" (K1 fast); bit-equal, or >= 115 dB where a
     reduction is reordered;
 25. K9's time over a CUDA graph of 20 launches beside K5's, its plain
     version, the grouped conv1d and its bound; the four-shard form's ms a
     block; the sharded entry points' Msamples/s against the unsharded
     ones (turns unsharded, sharded, sharded, unsharded);
 26. with the caller's torch.set_float32_matmul_precision("high") and
     cuDNN's TF32 at PyTorch's default: the x3 gates of configs 4 and 5
     (kernels against plain versions, plain versions against float64)
     and conv1d_mxu >= 100 dB against float64, the caller's flags the same
     afterwards.  The script leaves every TF32 flag at PyTorch's default:
     the port pins full float32 for its own products;
 27. config 1 (BASELINE.json: a 64-tap complex FIR lowpass on a 1M-sample
     tone): FIRFilter(firdes_kaiser(64, 0.1, 60), complex64) on 2^20
     samples as 4 blocks of 2^18 with the tail carried, by "matmul",
     "fft", "auto" and "measure", each >= 60 dB against numpy's float64
     convolve, "fft" vs "matmul" in complex128 >= 100 dB; Msamples/s; the
     methods "auto" and "measure" took; and the unfused chain's FIR route,
     conv1d against the banded-Toeplitz matmul at stride 4 over 2^24
     samples with config 4's 64 taps and with 4, one on each side of
     ops/fir.py's tap threshold, both timed;
 28. config 3 (BASELINE.json: the polyphase rational resampler, 3/2 and
     1/8): RationalResampler on 3 blocks of 2^22 with the phase and tail
     carried, complex128 >= 100 dB against the zero-stuff + convolve +
     select model in float64, float32 taps on complex64 >= 60 dB against
     complex128; Msamples/s;
 29. S1 (the exact AGC scan, seq_scan.cu) vs its plain version in float32
     on the card at T = 2^14 (max|dy| <= 1e-5 max|y|, gain rtol 1e-5, mode
     and timer equal) and in float64 vs the plain version on the CPU (atol
     1e-11) with a squelch walk (loud -> quiet, threshold -30, timeout
     20); S1's FSM entry vs its plain version on card tensors over an rssi
     walk across the threshold that visits every state (float32 at 2^16,
     float64 at 4096; modes, final mode and timer equal);
     agc_apply_parallel vs S1 at T = 2^22 (its Newton iterations and
     host syncs printed), an all-zero block through its fall-back to S1,
     bit-equal, counted at S1's launch; S2 (the Costas loop) through
     qpsk_demodulate(recovery="pll") on 2^16 QPSK symbols with a carrier
     offset, symbols equal to the plain version, SER < 1e-3; S1 vs its
     plain version at T = 2^16 (the error the kernels line reports); the
     three entries' times at T = 2^16 and their plain versions'; S1's FSM
     entry (the time-parallel chunk-and-join kernel) also on one lane of
     2^22, bit-equal to its chunked plain version, timed beside its bytes
     bound and the sequential kernel it replaced;
 30. the exact-AGC and parity chains, 4 blocks each with the state
     carried, launches and host syncs counted: (a) config 4 fused (K2)
     with agc_mode="parallel", FM at 2^24; (b) the parity chain
     (nco_mode="lut", unfused, agc_mode="parallel"), FM and QPSK at 2^24;
     (c) (a) and (b) with agc_mode="exact" (S1) at 2^18 a block, and with
     the parallel AGC on the same blocks: parallel vs exact within phase
     29's tolerances, the FM tone read back, QPSK SER < 1e-3; (d) the
     AGC class, float32, squelch on (threshold -30, timeout 20), on 4
     bursty blocks of 2^16: method "parallel" (Newton, then S1's FSM
     entry) against method "scan" (S1) within phase 29's tolerances, final
     mode and timer equal;
 31. throughput of (a), (b), (c) and (d) in Msamples/s of input over 20
     blocks (5 for the exact AGC), host enqueue, device busy and idle
     share ((d) beside its device busy with the sequential FSM kernel).
     Phase 24 also runs make_sharded_rx_chain's unfused staging
     (local_unfused) at world size 1 against make_rx_chain.
 32. S3 (the IIR w-recurrence, the chunk-and-join kernel of iir_scan.cu)
     against its plain version iir_chunked_torch on the card at T = 2^12
     (two blocks, the history carried; 32-bit within 1e-6 max|w|, 64-bit
     1e-12) and against the sequential walk (64-bit 1e-10 max|w|, 32-bit
     >= 90 dB against float64, or within 3 dB of the walk where that keeps
     less), k = 1, 2, 8, in float32, float64, complex64 and complex128, on
     1 and 256 lanes; the risky pole of tests/test_iir.py:210-223 (radius
     0.9999, 2^20 samples) through IIRFilter(float32, "auto" -> "scan"),
     >= 80 dB against S3 in float64, itself >= 200 dB against scipy's
     lfilter; pll_active_lag(0.02) as a float32 SECOND_ORDER filter (the
     fused cascade) >= 63 dB against its float64 run and at least as
     close to it as its float32 CPU run (one sequential walk a section);
     the 8th-order elliptic cascade on complex64 2^22-sample blocks by
     "scan" and "parallel" (both the fused cascade), against its plain
     version and the float64 cascade, and S3 over (2^16, 256) lanes and one lane at 2^22, and the
     cascade kernel: ms, Msamples/s, host enqueue, device busy and idle
     share;
 33. CICDecimator(8, 4), HalfbandDecimator(8), MultistageDecimator(16),
     HalfbandInterpolator(8), CICInterpolator(8, 4) and
     ArbitraryResampler at 0.37 (2^22) and 2.5 (2^21), on the grid
     (block_len) and host-anchored, two complex64 blocks each against
     their own complex128 run within the tolerance of the matching JAX
     test (named beside each gate), and their throughput; flush() in
     block_len mode (the reference's fault F1, repaired in the port);
 34. the stereo chain at fs = 192 kHz, 2^22 samples (fm_stereo_mpx ->
     fm_stereo_decode, without and with the 75 us de-emphasis; the
     separation, pilot and tone-power gates of tests/test_models.py:426-
     471), the CLI's audio tail (ArbitraryResampler(48000/192000) with
     flush, then the one-pole de-emphasis by iir_apply), DDC(0.7, 8, 4, 2,
     48000/44100) on two complex64 2^22-sample blocks against its
     complex128 run, filtfilt_sos (8th-order elliptic, float64, "scan":
     the fused cascade twice) at 2^20 against scipy's sosfiltfilt,
     AutoCorrelator(64, 16) at 2^22 against its complex128 run; each timed
     (Msamples/s, host enqueue, device busy, idle share); the stereo
     decoder's kernels by the profiler: S3's, and no cuBLAS gemm;
 35. K1-K3's "fast" mode (the TPU kernels' single bf16 pass, m64nNk16
     bf16 wgmma with f32 sums): K1 fast at L = 2^24, the body kernel fast
     at 2^24 (K2's route), 2^24 + 52 (K3's) and 32, each against its plain
     fast version on the card (K2/K3 z >= 120 dB; K1 audio >= 90 dB,
     energy rtol 1e-5, edges 1e-4), two launches on one block bit-equal,
     >= 50 dB against the float64 plain version on the CPU at 2^20 (K1:
     its energy within 1e-3 and its audio >= 30 dB, the discriminator on
     this weak carrier offset giving 37.0 dB in the JAX package's K1 fast
     as in the port), timed
     over a CUDA graph beside its bound, its x3 time, its plain version
     and (K2/K3) one strided conv1d on bf16 tensors;
 36. the config-4 chains at fir_precision="default", kernel vs plain over
     4 blocks with the state carried, the fast launch counts (and no x3
     launch): FM through K1 fast, FM at 2^24 + 52 through K3 fast, AM and
     QPSK through K2 fast; the FM tone and the AM tone read back, QPSK
     SER < 1e-3; throughput over 20 blocks in turns with the x3 chain (x3,
     default, default, x3; then the plain bodies once), host enqueue,
     device busy and idle share; the complex128 and
     300-tap chains (the plain body: JAX's XLA route) on 4 blocks of 2^22
     against their CPU runs (>= 100 dB), ms a block;
 37. P4 repaired: the DDC body's direct-form route at 128 taps, M = 200
     (K3's route) and 256 taps, M = 128 (K2's), x3 and fast, on ~2^24
     samples against its plain version (>= 120 dB), two launches
     bit-equal, timed beside its bound, its plain version and one strided
     conv1d; the fused FM, AM and QPSK chains there at x3 and "default",
     kernel vs plain body over 4 blocks of ~2^22 (>= 90 dB, QPSK >= 60 dB
     with < 1e-3 of its decisions differing), the direct launches counted
     (FM at 256 taps takes K1's direct route); the FM chains at 256 taps,
     M = 240 and 512 taps, M = 256 (K1's direct route only) the same way;
     K1's direct route (a warp a run of outputs, no shared memory) at 256
     taps, M = 128, 200 and 240 and 512 taps, M = 256, x3 and fast, on
     ~2^24 samples against its plain version (audio >= 90 dB, energy
     rtol 1e-5, edges 1e-4), two launches bit-equal, timed beside its
     bound, its plain version and the staged design it replaced.

Then the kernels' JSON line (each kernel's launches on the main paths; its
time, by CUDA events over a CUDA graph of 20 launches so that the host's
launch rate is not counted (K5 over back-to-back launches); its plain
version's time, the library call's where one PyTorch call computes the
same function, and its bound: the larger of its bytes over 3.35 TB/s and
its operations over the peak of their type), the nvidia-smi
line and, last, {"ok": true, "device": {...}}.  Any failed phase exits
non-zero.  Needs one CUDA GPU; imports neither jax nor solid_dsp_tpu.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np
import torch

L_FULL = 1 << 24          # config 4's block length
L_UNALIGNED = L_FULL + 4 * 13   # a multiple of M = 4, not of 64 * M
L_SHORT = 32              # shorter than the 63-sample filter tail
L_F64 = 1 << 20
N_CHAIN = 4               # blocks of the chain comparison
N_TIMED = 20              # blocks of the throughput phase
SEED = 0
DEVICE = "cuda"
# the JAX package's own gates (tests/test_rx_chain_fused.py, test_epilogue.py)
MIN_SNR_DB = 90.0
ENERGY_RTOL = 1e-5
EDGE_ATOL = 1e-4
TONE_ATOL = 1e-3
QPSK_MIN_SNR_DB = 60.0    # BASELINE.json's QPSK bound
MAX_SER = 1e-3
QPSK_OFFSET = 5e-4        # rad per input sample beyond the 0.2 carrier
F_HAT_ATOL = 1e-6         # rad per decimated sample, ~3 FFT bins at 2^22
AM_TONE = 1.0 / 4096      # cycles per input sample: bin T / 1024 of a block
# config 5: bench_all.py:386-403, BASELINE.json config 5
M5, K5 = 256, 8
L5 = 1 << 22              # complex samples a block: U = 16384 frame rows
L5_F64 = 1 << 18
T_IIR = 1 << 14           # ChannelBank's rows a block at M = 256
N_MON = 16                # SpectrumMonitor blocks
N_PLAIN_BANK = 2          # blocks a timed turn of the plain ChannelBank
FRONTEND_ATOL = 2e-5      # x max|Y| (tests/test_pallas.py:42)
IIR_ATOL = 3e-5           # tests/test_pallas.py:152
# a narrow cascade (poles near the unit circle): its state reaches ~270,
# where one float32 ulp is 3e-5 and the plain version is itself 2e-3 from
# float64, so its state is held at IIR_ATOL x max|state|
NARROW_CUTOFF = 0.005
FAST_MIN_SNR_DB = 45.0    # tests/test_models.py:582
PEAK_DB_ATOL = 0.05       # event peaks, kernel vs plain (fast mode)
# config 2: bench_all.py:457-502 (F = 4096 frames of N = 4096 points)
N2 = 4096
F2 = 4096
F2_F64 = 64
CHIRP_NOISE = 0.01
# the Farrow grid resampler: bench_all.py:572-582
FARROW_RATIO = 48000 / 44100
L8 = 1 << 22
L8_F64 = 1 << 16
FARROW_ATOL = 1e-5        # tests/test_resample.py:348
# parallel/: the sharded entry points against the single-card chains where
# a reduction is reordered (tests/test_parallel.py's fused-channelizer gate)
SHARDED_MIN_SNR_DB = 115.0
# full float32 against float64 (TF32 keeps ~3 digits, some 60 dB)
CONV_MIN_SNR_DB = 100.0
# the chain's fir_precision="highest" contract (tests/test_rx_chain_fused.py)
# for the body kernel's TF32 x3 product against float64
HIGHEST_MIN_SNR_DB = 100.0
PHASE_LIMIT_S = 60.0      # a K9 phase still running after this has hung
# config 1 (BASELINE.json: 64-tap complex FIR lowpass on a 1M-sample tone)
L_CFG1 = 1 << 20
N_CFG1 = 4                # blocks of 2^18, the tail carried
CFG1_MIN_SNR_DB = 60.0    # tests/test_snr_configs.py:39-51
METHODS_MIN_SNR_DB = 100.0
# config 3 (BASELINE.json: polyphase rational resampler, 3/2 and 1/8)
L_CFG3 = 1 << 22
N_CFG3 = 3
CFG3_MIN_SNR_DB = 100.0   # tests/test_snr_configs.py:190-208
CFG3_C64_MIN_SNR_DB = 60.0
# the sequential scans (S1, S2) and the exact-AGC / parity chains
T_S1 = 1 << 14            # S1 against its plain version on the card
T_S1_F64 = 4096
T_PAR = 1 << 22           # agc_apply_parallel against S1
T_SCAN = 1 << 16          # the timed shape: one 2^18 block decimated by 4
T_FSM_LONG = 1 << 22      # S1's FSM entry on one lane at the Newton AGC's size
# the sequential FSM entry it replaced: ms at T = 2^16 and the device busy
# of phase 31 (d) a block (PERF.md section 5-6, NVIDIA H100 80GB HBM3,
# 700.00 W), printed beside this run's
SEQUENTIAL_FSM_MS = 4.7206
SEQUENTIAL_D_BUSY_MS = 13.90
S1_RTOL = 1e-5            # x max|y|, and the gain
S1_F64_ATOL = 1e-11       # tests/test_nco_agc.py:214-226 (_cmp_parallel)
SQ_THRESHOLD = -30.0      # the squelch walks (dB) and their timeout
SQ_TIMEOUT = 20
AGC_BW = 0.01             # the chain's agc_bandwidth
PLL_BW = 0.02
L_EXACT = 1 << 18         # the exact-AGC chains' blocks (the TPU row's size)
N_EXACT_TIMED = 5
# H100 SXM peaks (NVIDIA's data sheet)
T_S3 = 1 << 12            # S3 against its plain version, two blocks
S3_LANES = 256
P4_POINTS = ((128, 200), (256, 128))   # (taps, M): the body's direct route
# (taps, M) of K1's direct route (K1 needs more taps than M): phase 37's FM
# point, M = 200, and two points where the staged design (its input span in
# shared memory as M polyphase rows) did not fit; the FM chains run at the
# last two
K1_DIRECT_POINTS = ((256, 128), (256, 200), (256, 240), (512, 256))
K1_CHAIN_POINTS = ((256, 240), (512, 256))
# the staged design's times in ms over a CUDA graph of 20 launches at
# ~2^24 samples (torch_kernel_sweep.py k1-route on the checkout before it
# was replaced, PERF.md section 6; NVIDIA H100 80GB HBM3, 700.00 W); it
# raised at the last two points
STAGED_K1_MS = {(256, 128, "x3"): 2.0698, (256, 128, "fast"): 2.4434,
                (256, 200, "x3"): 1.8955, (256, 200, "fast"): 2.2812}
L_P4_CHAIN = 1 << 22      # the P4 chains' blocks, cut to a multiple of 64 M
S3_RTOL = 1e-6            # x max|w|: S3 (32-bit) against iir_chunked_torch,
S3_F64_RTOL = 1e-12       # 64-bit; x g / 16 for a transient gain g > 16
S3_WALK_RTOL = 1e-10      # 64-bit S3 against the sequential walk
CASCADE_MIN_SNR_DB = 90.0  # the complex64 cascade against float64
L_CASC_F64 = 1 << 15      # its float64 per-section run on the CPU
T_RISKY = 1 << 20         # tests/test_iir.py:210-223's block
RISKY_MIN_SNR_DB = 80.0
# pll_active_lag(0.02) as a float32 SECOND_ORDER filter against the float64
# cascade of its float32 coefficients: the fused cascade read 65.5 dB on an
# H100 (the float32 CPU walk a section 60.7 dB); a floor between them
PLL_MIN_SNR_DB = 63.0
LFILTER_MIN_SNR_DB = 200.0  # S3 in float64 against scipy's lfilter
T_PLL = 1 << 12
L_IIR = 1 << 22           # the elliptic cascade's timed block
T_S3_LANES = 1 << 16      # S3's per-lane rate: (2^16, 256)
L_RS = 1 << 22            # bench_all.py:550-568 and 819-836's blocks
L_RS_UP = 1 << 21
FIR_C64_RTOL = 1e-5       # x max|y|: complex64 against complex128
GRID_ATOL = 2e-4          # tests/test_resample.py:307-336
LEGACY_MIN_SNR_DB = 50.0  # tests/test_resample.py:171-174 (complex64)
FS_STEREO = 192000.0      # tests/test_models.py:426-471
L_STEREO = 1 << 22
SEPARATION_MIN_DB = 40.0
TONE_POW_ATOL = 0.01
PILOT_ATOL = 0.005
L_FILTFILT = 1 << 20
FILTFILT_PAD = 16384      # above the cascade's transient pad (8262)
FILTFILT_ATOL = 1e-12     # tests/test_zerophase.py:22-42: interior
FILTFILT_EDGE_ATOL = 1e-5
DDC_MIN_SNR_DB = 50.0     # complex64 against complex128 (Farrow's float32
DDC_F_ATOL = 1e-4         # positions); tests/test_ddc.py:41-55's tone
# K1-K3's "fast" mode (the single bf16 pass): against the plain version of
# the same roundings (f32 sums in another order), and against float64 (the
# TPU kernel's docstring: ~52 dB)
BODY_FAST_MIN_SNR_DB = 120.0
FAST_F64_MIN_SNR_DB = 50.0
# K1 fast's audio against float64: the discriminator turns the body's ~60 dB
# into 37.0 dB on this block's weak carrier offset, in the JAX package's own
# K1 fast as in the port (tests/test_torch_ddc_fast.py)
FM_FAST_F64_MIN_SNR_DB = 30.0
FM_FAST_ENERGY_RTOL = 1e-3  # its sum |z|^2 against float64
CPU_RUN_MIN_SNR_DB = 100.0  # a chain on the card against its CPU run
L_CPU_RUN = 1 << 22       # the complex128 and 300-tap chains' blocks
AC_W, AC_D = 64, 16       # the autocorrelator's window and delay

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def snr_db(got, ref) -> float:
    """Signal-to-error ratio in dB; complex arrays count both parts."""
    got, ref = np.asarray(got), np.asarray(ref)
    if np.iscomplexobj(got) or np.iscomplexobj(ref):
        got = np.stack([got.real, got.imag])
        ref = np.stack([ref.real, ref.imag])
    got = got.astype(np.float64)
    ref = ref.astype(np.float64)
    err = float(np.sum((got - ref) ** 2))
    return 10.0 * np.log10(float(np.sum(ref ** 2)) / max(err, 1e-300))


def make_block(rng, b: int, L: int) -> np.ndarray:
    """bench.py's config-4 tone (carrier + 0.001 cycles/sample) plus
    low-level complex noise, as planar (2, L) f32; block b continues the
    phase of block b - 1."""
    k = np.arange(b * L, (b + 1) * L)
    sig = 0.1 * np.exp(2j * np.pi * (0.2 / (2 * np.pi) + 0.001) * k)
    sig += 0.003 * (rng.standard_normal(L) + 1j * rng.standard_normal(L))
    return np.stack([sig.real, sig.imag]).astype(np.float32)


GRAY = np.array([1 + 1j, -1 + 1j, 1 - 1j, -1 - 1j]) / np.sqrt(2.0)


def qpsk_symbols(n_blocks: int, L: int) -> np.ndarray:
    """Gray symbol indices, one per 32 input samples, from the seed."""
    return np.random.default_rng(SEED + 1).integers(0, 4, n_blocks * L // 32)


def make_qpsk_block(rng, sym, b: int, L: int) -> np.ndarray:
    """Symbols held for 32 samples, mixed to 0.2 + QPSK_OFFSET rad/sample,
    plus complex noise, as planar (2, L) f32; block b continues block b-1."""
    k = np.arange(b * L, (b + 1) * L)
    x = 0.5 * GRAY[sym[k // 32]] * np.exp(1j * (0.2 + QPSK_OFFSET) * k)
    x += 0.05 * (rng.standard_normal(L) + 1j * rng.standard_normal(L))
    return np.stack([x.real, x.imag]).astype(np.float32)


def make_am_block(rng, b: int, L: int) -> np.ndarray:
    """A carrier at 0.2 rad/sample, 50 % amplitude-modulated by a tone of
    AM_TONE cycles/sample, plus complex noise, as planar (2, L) f32."""
    k = np.arange(b * L, (b + 1) * L)
    x = 0.5 * (1 + 0.5 * np.cos(2 * np.pi * AM_TONE * k)) * np.exp(0.2j * k)
    x += 0.003 * (rng.standard_normal(L) + 1j * rng.standard_normal(L))
    return np.stack([x.real, x.imag]).astype(np.float32)


def best_aligned_ser(tx: np.ndarray, got: np.ndarray, max_lag: int = 20,
                     margin: int = 10) -> float:
    """Min SER over integer alignments in both directions and the four
    pi/2 rotations (tests/test_timing.py::_best_aligned_ser with
    models/qpsk.py::symbol_error_rate's ambiguity resolution)."""
    best = 1.0
    for lag in range(max_lag):
        for a, c in ((tx[lag:], got), (tx, got[lag:])):
            n = min(len(a), len(c)) - margin
            if n <= 0:
                continue
            want = a[:n]
            for r in range(4):
                rot = GRAY[c[:n]] * np.exp(0.5j * np.pi * r)
                sl = (rot.real < 0).astype(int) + 2 * (rot.imag < 0)
                best = min(best, float(np.mean(sl != want)))
    return best


def cuda_ms(fn, n: int) -> float:
    """Mean ms of fn() over n calls, CUDA events, after 2 warm-up calls."""
    return timed(fn, n)[0]


def timed(fn, n: int):
    """(device ms a call from CUDA events, host ms a call to enqueue) over
    n calls after 2 warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n, host_ms


def graph_ms(fn, n: int) -> float:
    """Device ms of one fn() call: n calls captured in a CUDA graph,
    replayed 5 times between CUDA events, so that no host launch cost is
    counted (a kernel faster than its wrapper's enqueue reads its own
    time)."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(5):
        g.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / (5 * n)


def profiled_busy(fn, n: int = 10):
    """(device ms a call, its three largest kernels as text) from
    torch.profiler: the kernels' rows only (an op's row repeats the time of
    the kernels it launched).  The device tracer misses the first records
    after it starts (7, 9 or 0 of 10 kernels seen), so n calls run in a
    warm-up step and n in the recorded one; a kernel's time a call is still
    its mean record times its records a call, rounded, in case one drops.
    The step's own row (ProfilerStep*) spans the step, not a kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            prof.step()
    rows = sorted(((e.self_device_time_total / 1e3 / e.count
                    * max(1, round(e.count / n)), e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.count
                   and not e.key.startswith("ProfilerStep")),
                  reverse=True)
    top = ", ".join(f"{k[:40]} {t:.4f} ({c} records in {n} calls)"
                    for t, k, c in rows[:3])
    return sum(t for t, _, _ in rows), top


def kernel_names(fn) -> list:
    """The names of the kernels one fn() call launches, from
    torch.profiler (after a warm-up call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA})


def cuda_ms_once(fn) -> float:
    """ms of one call of fn(), CUDA events, nothing warm but the build."""
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


def bound_ms(nbytes: float, flops: float, peak: float):
    """(ms, "bytes" | "operations"): the larger of the bytes over the
    memory rate and the operations over ``peak``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_entry(name, source, replaces, launches, err, ms, plain, bound,
                 library=None):
    return {"name": name, "route": "cuda",
            "source": f"solid_dsp_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": library}


def rssi_walk(rng, T: int) -> np.ndarray:
    """An rssi track (dB) that crosses SQ_THRESHOLD in runs of 1-59
    samples, 2-15 dB to either side: long runs below it time the squelch
    out (SQ_TIMEOUT), short ones return to SIGNALHI."""
    out, i, above = np.empty(T), 0, True
    while i < T:
        n = int(rng.integers(1, 60))
        side = 1.0 if above else -1.0
        out[i:i + n] = SQ_THRESHOLD + side * rng.uniform(2.0, 15.0, n)[:T - i]
        i, above = i + n, not above
    return out


def burst_blocks(rng, nb: int, T: int) -> list:
    """nb blocks of T complex64 samples, bursts of 2000-8000 samples at
    amplitude 1 and 0.01 in turn (the AGC's rssi crosses SQ_THRESHOLD
    both ways), random phase, 10 % amplitude noise."""
    out = []
    for b in range(nb):
        amp, i, loud = np.empty(T), 0, b % 2 == 0
        while i < T:
            n = int(rng.integers(2000, 8000))
            amp[i:i + n] = 1.0 if loud else 0.01
            i, loud = i + n, not loud
        x = (amp * np.exp(1j * rng.uniform(0.0, 2 * np.pi, T))
             * (1.0 + 0.1 * rng.standard_normal(T)))
        out.append(x.astype(np.complex64))
    return out


def cnoise(rng, shape, scale=1.0) -> np.ndarray:
    """Complex Gaussian noise, complex64."""
    return (scale * (rng.standard_normal(shape)
                     + 1j * rng.standard_normal(shape))).astype(np.complex64)


def tone(c: int, L: int, amp: float = 1.0, start: int = 0) -> np.ndarray:
    """A tone at +c/M5 of the input rate: the centre of channel c."""
    k = np.arange(start, start + L)
    return (amp * np.exp(2j * np.pi * c / M5 * k)).astype(np.complex64)


def tone_ok(Y: torch.Tensor, c: int):
    """(ok, ratio): the mean |Y| past the transient peaks in channel c, at
    least 20 times any other channel's (tests/test_pallas.py:70-84)."""
    power = Y[2 * K5:].abs().mean(dim=0).cpu().numpy()
    ratio = float(power[c] / np.delete(power, c).max())
    return int(power.argmax()) == c and ratio > 20.0, ratio


def config5(dev, smi) -> list:
    """Phases 11-16: config 5 at full width.  Returns the kernels' entries
    of K4, K5 and K6."""
    from solid_dsp_tpu_torch.models.channel_bank import (ChannelBank,
                                                         design_channel_sos)
    from solid_dsp_tpu_torch.models.channelizer import (PolyphaseChannelizer,
                                                        channelizer_taps)
    from solid_dsp_tpu_torch.models.monitor import SpectrumMonitor
    from solid_dsp_tpu_torch.ops import cuda_chan, cuda_ddc, cuda_iir

    counters = {"channelizer": cuda_chan.chan_fused_cuda,
                "pfb_frontend": cuda_chan.pfb_frontend_cuda,
                "iir_bank": cuda_iir.iir_bank_cuda,
                "ddc_fm": cuda_ddc.ddc_fm_cuda,
                "ddc_body": cuda_ddc.ddc_body_cuda,
                "ddc_body_unaligned": cuda_ddc.ddc_body_unaligned_cuda}
    launches = {k: 0 for k in ("channelizer", "pfb_frontend", "iir_bank")}

    def main_path(run):
        """Run one main path with every count at 0 just before it; add its
        counts of the config-5 kernels; return run()'s result and them
        ("complex": K4's launches on its complex layout)."""
        for c in counters.values():
            c.launches = 0
        cuda_chan.chan_fused_cuda.complex_launches = 0
        out = run()
        torch.cuda.synchronize()
        counts = {k: c.launches for k, c in counters.items()}
        counts["complex"] = cuda_chan.chan_fused_cuda.complex_launches
        for k in launches:
            launches[k] += counts[k]
        return out, counts

    rng = np.random.default_rng(SEED + 5)
    U = L5 // M5
    taps = channelizer_taps(M5, K5)

    # 11. K4 vs plain on the card, x3 and fast, planar and complex layouts;
    # x3 vs float64 on the CPU
    x = cnoise(rng, L5)
    xc5 = torch.from_numpy(x).to(dev).reshape(U, M5)
    xf = torch.stack([xc5.real, xc5.imag]).contiguous()
    tail = torch.from_numpy(rng.standard_normal((2, 8, M5)).astype(
        np.float32)).to(dev)
    chan = {}
    for mode in ("x3", "fast"):
        body = cuda_chan.make_chan_body(taps, M5, mode, dev)
        yk = cuda_chan.chan_fused_cuda(body, xf, tail)
        yc = cuda_chan.chan_fused_cuda(body, xc5, tail)
        yp = cuda_chan.chan_fused_torch(body, xf, tail)
        torch.cuda.synchronize()
        same = (torch.equal(yc.real, yk[:, :M5])
                and torch.equal(yc.imag, yk[:, M5:]))
        chan[mode] = (body, yk, yp, same)
    yx3 = chan["x3"][2].cpu().numpy()
    stats11 = {}
    for mode, (body, yk, yp, same) in chan.items():
        yk, yp = yk.cpu().numpy(), yp.cpu().numpy()
        snr_same = snr_db(yk, yp)
        snr_x3 = snr_db(yk, yx3)
        kms = graph_ms(lambda: cuda_chan.chan_fused_cuda(body, xf, tail), 20)
        kms_c = graph_ms(lambda: cuda_chan.chan_fused_cuda(body, xc5, tail),
                         20)
        pms = cuda_ms(lambda: cuda_chan.chan_fused_torch(body, xf, tail), 20)
        flops = 8 * U * M5 * M5 + 4 * (K5 + 1) * U * M5
        nbytes = 4 * (2 * L5 + 16 * M5 + (K5 + 1) * M5 + 2 * M5 * M5
                      + 2 * U * M5)
        # x3 is f32-grade: three bf16 tensor-core passes at the least
        bnd = bound_ms(nbytes, flops * (3 if mode == "x3" else 1),
                       BF16_FLOPS)
        # the main paths (PolyphaseChannelizer, ChannelBank, the monitor,
        # the sharded channelizer) run the complex layout
        stats11[mode] = (float(np.max(np.abs(yk - yp))), kms_c, pms, bnd)
        gate = MIN_SNR_DB if mode == "x3" else FAST_MIN_SNR_DB
        print(f"[11 channelizer kernel vs plain, {mode}, M=256 K=8 L=2^22] "
              f"{snr_same:.1f} dB vs plain {mode}, {snr_x3:.1f} dB vs plain "
              f"x3 (gate {gate}), max |err| {stats11[mode][0]:.3g}, complex "
              f"layout bit-equal {same}; kernel (CUDA graph of 20 launches) "
              f"planar {kms:.4f} ms, complex {kms_c:.4f} ms, plain "
              f"{pms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}) | {smi}",
              flush=True)
        if not (snr_x3 >= gate and snr_same >= MIN_SNR_DB and same
                and np.all(np.isfinite(yk)) and yk.shape == (U, 2 * M5)):
            fail(f"phase 11: the channelizer kernel disagrees ({mode})")
    U64 = L5_F64 // M5
    xf1 = xf[:, :U64].contiguous()
    yk1 = cuda_chan.chan_fused_cuda(chan["x3"][0], xf1, tail)
    body64 = cuda_chan.make_chan_body(taps, M5, "x3", "cpu", torch.float64)
    y64 = cuda_chan.chan_fused_torch(body64, xf1.cpu().double(),
                                     tail.cpu().double())
    snr11 = snr_db(yk1.cpu().numpy(), y64.numpy())
    print(f"[11 channelizer kernel vs plain f64 (CPU), x3, L=2^18] "
          f"{snr11:.1f} dB (gate {MIN_SNR_DB})", flush=True)
    if not snr11 >= MIN_SNR_DB:
        fail("phase 11: the channelizer kernel disagrees with float64")

    # 12. K5 vs plain, and one grouped conv1d as the library call
    h_il = torch.from_numpy(cuda_chan.pfb_frontend_taps(taps, M5)).to(dev)
    xc = torch.from_numpy(x).to(dev)
    tail_c = torch.from_numpy(cnoise(rng, (K5, M5))).to(dev)
    zk = cuda_chan.pfb_frontend_cuda(xc, h_il, tail_c, M5, K5)
    zp = cuda_chan.pfb_frontend_torch(xc, h_il, tail_c, M5, K5)
    Yk = torch.fft.fft(zk, dim=-1).cpu().numpy()
    Yp = torch.fft.fft(zp, dim=-1).cpu().numpy()
    err12 = float(np.max(np.abs(Yk - Yp)))
    lim12 = FRONTEND_ATOL * float(np.max(np.abs(Yp)))
    max_abs12 = float((zk - zp).abs().max())
    k12 = cuda_ms(lambda: cuda_chan.pfb_frontend_cuda(xc, h_il, tail_c, M5,
                                                      K5), 20)
    p12 = cuda_ms(lambda: cuda_chan.pfb_frontend_torch(xc, h_il, tail_c, M5,
                                                       K5), 20)
    # grouped conv1d over the 2M real lanes on the transposed layout: lane
    # l reads rows u .. u + K of [tail; x] with the taps reversed
    xp_t = torch.cat([torch.view_as_real(tail_c).reshape(K5, 2 * M5),
                      torch.view_as_real(xc).reshape(U, 2 * M5)]).T[None]
    xp_t = xp_t.contiguous()
    w12 = h_il.flip(0).T[:, None, :].contiguous()            # (2M, 1, K+1)
    zl = torch.nn.functional.conv1d(xp_t, w12, groups=2 * M5)[0].T
    snr_lib12 = snr_db(zl.cpu().numpy(),
                       torch.view_as_real(zp).reshape(U, 2 * M5).cpu().numpy())
    l12 = cuda_ms(lambda: torch.nn.functional.conv1d(xp_t, w12,
                                                     groups=2 * M5), 20)
    b12 = bound_ms(8 * L5 + 8 * K5 * M5 + 8 * (K5 + 1) * M5 + 8 * U * M5,
                   4 * (K5 + 1) * U * M5, FP32_FLOPS)
    print(f"[12 front-end kernel vs plain, M=256 K=8 L=2^22] channels max "
          f"|err| {err12:.3g} (gate {lim12:.3g}), z max |err| "
          f"{max_abs12:.3g}; kernel {k12:.4f} ms, plain {p12:.4f} ms, "
          f"library grouped conv1d {l12:.4f} ms ({snr_lib12:.1f} dB vs "
          f"plain), bound {b12[0]:.4f} ms ({b12[1]}) | {smi}", flush=True)
    if not (err12 <= lim12 and np.all(np.isfinite(Yk))):
        fail("phase 12: the front-end kernel disagrees")

    # 13. K6 vs plain, T = 2^14, C = 256, two blocks with the state carried;
    # the narrow cascade's state held relative to its size (IIR_ATOL note)
    xi = torch.from_numpy(cnoise(rng, (2 * T_IIR, M5))).to(dev)
    stats13 = {}
    for label, sos in (
            ("shared", design_channel_sos()),
            ("per-channel", np.stack([design_channel_sos(0.1 + 0.3 * c / M5)
                                      for c in range(M5)], axis=-1)),
            ("narrow", design_channel_sos(NARROW_CUTOFF))):
        bank = cuda_iir.IirBank(sos, M5, dev)
        st_k = st_p = cuda_iir.iir_bank_init(sos.shape[0], M5, dev)
        outs_k, outs_p = [], []
        for blk in (xi[:T_IIR], xi[T_IIR:]):
            y, st_k = cuda_iir.iir_bank_cuda(bank.lanes, st_k, blk, bank.tables)
            outs_k.append(y)
            y, st_p = cuda_iir.iir_bank_torch(bank.lanes, st_p, blk)
            outs_p.append(y)
        yk = torch.cat(outs_k).cpu().numpy()
        yp = torch.cat(outs_p).cpu().numpy()
        err_y = float(np.max(np.abs(yk - yp)))
        err_st = float((st_k - st_p).abs().max())
        st_scale = (max(1.0, float(st_p.abs().max())) if label == "narrow"
                    else 1.0)
        blk = xi[:T_IIR]
        st0 = cuda_iir.iir_bank_init(sos.shape[0], M5, dev)
        k13 = graph_ms(lambda: cuda_iir.iir_bank_cuda(bank.lanes, st0, blk,
                                                      bank.tables), 20)
        p13 = cuda_ms_once(lambda: cuda_iir.iir_bank_torch(bank.lanes, st0,
                                                           blk))
        S = sos.shape[0]
        b13 = bound_ms(16 * T_IIR * M5 + 32 * S * M5 + 40 * S * M5,
                       9 * S * 2 * M5 * T_IIR, FP32_FLOPS)
        stats13[label] = (max(err_y, err_st), k13, p13, b13)
        print(f"[13 iir bank kernel vs plain, {label}, T=2^14 C=256 S={S}, "
              f"2 blocks] max |err| y {err_y:.3g}, state {err_st:.3g} (gate "
              f"{IIR_ATOL}, state x {st_scale:.3g}); kernel (CUDA graph of 20 "
              f"calls, chunks of {cuda_iir.IIR_CHUNK} rows) {k13:.4f} ms, "
              f"plain {p13:.1f} ms (once), bound {b13[0]:.4f} ms ({b13[1]}) "
              f"| {smi}", flush=True)
        if not (err_y <= IIR_ATOL and err_st <= IIR_ATOL * st_scale
                and np.all(np.isfinite(yk))):
            fail(f"phase 13: the IIR bank kernel disagrees ({label})")

    # 14. PolyphaseChannelizer over 4 blocks: fused (K4) and pallas (K5)
    blocks = [torch.from_numpy(cnoise(rng, L5)).to(dev)
              for _ in range(N_CHAIN)]
    ref = PolyphaseChannelizer(M5, K5, backend="xla", device=dev)
    y_ref = torch.cat([ref.execute_block(b) for b in blocks]).cpu().numpy()
    for backend, key in (("fused", "channelizer"), ("pallas", "pfb_frontend")):
        kern = PolyphaseChannelizer(M5, K5, backend=backend, precision="x3",
                                    device=dev)
        y_k, counts = main_path(
            lambda: torch.cat([kern.execute_block(b) for b in blocks]))
        plain = PolyphaseChannelizer(M5, K5, backend=backend,
                                     precision="x3", device=dev,
                                     engine="torch")
        y_p = torch.cat([plain.execute_block(b) for b in blocks])
        y_k, y_p = y_k.cpu().numpy(), y_p.cpu().numpy()
        snr_ref, snr_plain = snr_db(y_k, y_ref), snr_db(y_k, y_p)
        tails = torch.equal(kern.state, plain.state)
        flat = (torch.complex(kern.state[0], kern.state[1]).reshape(-1)
                if backend == "fused" else kern.state.reshape(-1))
        tails = tails and torch.equal(flat[-(K5 * M5 - 1):], ref.state)
        c = 37 if backend == "fused" else 201
        ok_tone, ratio = tone_ok(PolyphaseChannelizer(
            M5, K5, backend=backend, device=dev).execute_block(
                torch.from_numpy(tone(c, L5)).to(dev)), c)
        print(f"[14 PolyphaseChannelizer {backend} x3, {N_CHAIN} x 2^22] "
              f"{snr_ref:.1f} dB vs xla, {snr_plain:.1f} dB vs plain (gate "
              f"{MIN_SNR_DB}), tails equal {tails}, launches {key} "
              f"{counts[key]} ({counts['complex']} on K4's complex layout), "
              f"tone in channel {c} {ratio:.0f}x the others", flush=True)
        want_complex = N_CHAIN if backend == "fused" else 0
        if not (snr_ref >= MIN_SNR_DB and snr_plain >= MIN_SNR_DB and tails
                and counts[key] == N_CHAIN and ok_tone
                and counts["complex"] == want_complex
                and y_k.shape == (N_CHAIN * U, M5)):
            fail(f"phase 14: PolyphaseChannelizer({backend}) is wrong")

    # 15. ChannelBank over 4 blocks, kernels vs plain; SpectrumMonitor
    bk = ChannelBank(M5, backend="fused", agc_bandwidth=0.05, device=dev)
    y_k, counts = main_path(
        lambda: torch.cat([bk.execute_block(b) for b in blocks]))
    bp = ChannelBank(M5, backend="fused", agc_bandwidth=0.05, device=dev,
                     engine="torch")
    y_p = torch.cat([bp.execute_block(b) for b in blocks])
    snr15 = snr_db(y_k.cpu().numpy(), y_p.cpu().numpy())
    gain_err = float((bk.state["agc"]["gain"] - bp.state["agc"]["gain"]
                      ).abs().max() / bp.state["agc"]["gain"].abs().max())
    print(f"[15 ChannelBank fused + AGC, {N_CHAIN} x 2^22] {snr15:.1f} dB vs "
          f"plain (gate {MIN_SNR_DB}), gain rel err {gain_err:.3g}, launches "
          f"channelizer {counts['channelizer']} ({counts['complex']} complex) "
          f"iir_bank {counts['iir_bank']}", flush=True)
    if not (snr15 >= MIN_SNR_DB and counts["channelizer"] == N_CHAIN
            and counts["complex"] == N_CHAIN
            and counts["iir_bank"] == N_CHAIN
            and bool(torch.isfinite(y_k).all())):
        fail("phase 15: ChannelBank through the kernels is wrong")

    mon_blocks = []
    for b in range(N_MON):
        xm = cnoise(rng, L5, 0.05)
        if 2 <= b < 6:
            xm += tone(40, L5, 0.1, b * L5)
        if 8 <= b < 11:
            xm += tone(200, L5, 0.07, b * L5)
        mon_blocks.append(torch.from_numpy(xm).to(dev))
    mon_k = SpectrumMonitor(M5, backend="fused", device=dev)
    _, counts = main_path(lambda: [mon_k.execute_block(b) for b in mon_blocks])
    mon_p = SpectrumMonitor(M5, backend="fused", device=dev, engine="torch")
    for b in mon_blocks:
        mon_p.execute_block(b)

    def key(e):
        return (e["channel"], e["start_block"], e["end_block"])

    same = ([key(e) for e in mon_k.events] == [key(e) for e in mon_p.events]
            and all(abs(a["peak_rel_db"] - b["peak_rel_db"]) <= PEAK_DB_ATOL
                    for a, b in zip(mon_k.events, mon_p.events)))
    print(f"[15 SpectrumMonitor fused, {N_MON} x 2^22] events {mon_k.events}"
          f", plain run's {mon_p.events}, same {same}, launches channelizer "
          f"{counts['channelizer']} ({counts['complex']} complex)", flush=True)
    if not (same and sorted(e["channel"] for e in mon_k.events) == [40, 200]
            and counts["channelizer"] == N_MON
            and counts["complex"] == N_MON):
        fail("phase 15: SpectrumMonitor's events are wrong")

    # 16. throughput (turns plain, kernel, kernel, plain), host enqueue,
    # device busy time
    def cycle(obj):
        """fn() running obj over the blocks in turn."""
        i = iter(range(1 << 30))
        return lambda: obj.execute_block(blocks[next(i) % N_CHAIN])

    def rate(obj, n_blocks):
        dev_ms, host_ms = timed(cycle(obj), n_blocks)
        return L5 / (dev_ms * 1e3), host_ms

    def busy_ms(obj, n_blocks=10):
        return profiled_busy(cycle(obj), n_blocks)

    for label, make in (
            ("fused x3", lambda eng: PolyphaseChannelizer(
                M5, K5, backend="fused", precision="x3", device=dev,
                engine=eng)),
            ("fused fast", lambda eng: PolyphaseChannelizer(
                M5, K5, backend="fused", precision="fast", device=dev,
                engine=eng)),
            ("xla", lambda eng: PolyphaseChannelizer(
                M5, K5, backend="xla", device=dev, engine=eng)),
            ("ChannelBank", lambda eng: ChannelBank(
                M5, backend="fused", agc_bandwidth=0.05, device=dev,
                engine=eng))):
        n_plain = N_PLAIN_BANK if label == "ChannelBank" else N_TIMED
        p1 = rate(make("torch"), n_plain)
        k1 = rate(make("auto"), N_TIMED)
        k2 = rate(make("auto"), N_TIMED)
        p2 = rate(make("torch"), n_plain)
        busy, top = busy_ms(make("auto"))
        wall = L5 / (0.5 * (k1[0] + k2[0]) * 1e3)        # ms a block
        print(f"[16 throughput {label}, 2^22-sample blocks] with kernels "
              f"{k1[0]:.1f} / {k2[0]:.1f} Msamples/s (host enqueue "
              f"{k1[1]:.4f} / {k2[1]:.4f} ms a block, device busy "
              f"{busy:.4f} ms a block, idle {max(0.0, 1 - busy / wall):.0%}"
              f"; largest kernels, ms a block: {top}), plain {p1[0]:.1f} / "
              f"{p2[0]:.1f} Msamples/s over {n_plain} blocks | {smi}",
              flush=True)

    b11 = stats11["x3"]
    e13 = stats13["shared"]
    return [
        kernel_entry("channelizer", "channelizer.cu",
                     "solid_dsp_tpu/ops/pallas_kernels.py:384",
                     launches["channelizer"], b11[0], b11[1], b11[2], b11[3]),
        kernel_entry("pfb_frontend", "channelizer.cu",
                     "solid_dsp_tpu/ops/pallas_kernels.py:90",
                     launches["pfb_frontend"], max_abs12, k12, p12, b12, l12),
        kernel_entry("iir_bank", "iir_bank.cu",
                     "solid_dsp_tpu/ops/pallas_kernels.py:239",
                     launches["iir_bank"], e13[0], e13[1], e13[2], e13[3]),
    ]


def chirp(n: int, rng, noise: float = CHIRP_NOISE) -> np.ndarray:
    """Config 2's chirp e^{j pi 0.4 k^2 / n} (tests/test_snr_configs.py),
    the phase reduced exactly in integers, plus complex noise: complex64."""
    k = np.arange(n, dtype=np.int64)
    x = np.exp(2j * np.pi * ((k * k) % (5 * n)) / (5 * n))
    return (x + noise * (rng.standard_normal(n)
                         + 1j * rng.standard_normal(n))).astype(np.complex64)


def chirp_bins_ok(power: np.ndarray, n: int):
    """(ok, worst): the peak bin of each N2-point frame of the chirp within
    1 bin (circularly) of the instantaneous frequency 0.4 k / n at the
    frame's centre."""
    F = power.shape[0]
    kc = np.arange(F) * N2 + (N2 - 1) / 2.0
    want = 0.4 * kc / n * N2
    got = np.argmax(power, axis=1)
    d = np.abs((got - want + N2 / 2) % N2 - N2 / 2)
    return bool(np.all(d <= 1.0)), float(d.max())


def config2(dev, smi) -> list:
    """Phases 17-19: config 2 (windowed 4096-point FFT spectral analysis)
    at full size.  Returns the kernels' entry of K7."""
    from solid_dsp_tpu_torch.design.windows import get_window
    from solid_dsp_tpu_torch.ops import cuda_fft
    from solid_dsp_tpu_torch.ops import fft as fft_ops

    rng = np.random.default_rng(SEED + 2)
    x = cnoise(rng, (F2, N2))
    xc = torch.from_numpy(x).to(dev)
    x2 = torch.stack([xc.real, xc.imag]).contiguous()
    flops = 5.0 * N2 * np.log2(N2) * F2           # bench_all.py:461
    bnd = bound_ms(16.0 * F2 * N2 + 4 * N2 + 8 * N2, flops, FP32_FLOPS)

    # 17. K7 vs its plain version, both layouts, x3 and fast, two windows
    err = None
    for window in ("hamming", "blackman_harris"):
        w = get_window(window, N2)
        for mode in ("x3", "fast"):
            apply_k = cuda_fft.make_fused_windowed_fft(N2, F2, w, 8, mode)
            apply_p = cuda_fft.make_fused_windowed_fft(N2, F2, w, 8, mode,
                                                       engine="torch")
            yk = apply_k(x2)
            yp = apply_p(x2)
            yc = cuda_fft.fused_windowed_fft(xc, w, 8, mode)
            torch.cuda.synchronize()
            same = (torch.equal(yc.real, yk[:, :N2])
                    and torch.equal(yc.imag, yk[:, N2:]))
            snr = snr_db(yk.cpu().numpy(), yp.cpu().numpy())
            e = float((yk - yp).abs().max())
            err = e if err is None else err          # Hamming x3's
            print(f"[17 windowed fft kernel vs plain, {window} {mode}, "
                  f"F=4096 N=4096] {snr:.1f} dB (gate {MIN_SNR_DB}), max "
                  f"|err| {e:.3g}, complex layout equal {same}", flush=True)
            if not (snr >= MIN_SNR_DB and same and yk.shape == (F2, 2 * N2)
                    and bool(torch.isfinite(yk).all())):
                fail(f"phase 17: the windowed FFT kernel disagrees ({window}"
                     f", {mode})")
    w = get_window("hamming", N2)
    wt, tw = cuda_fft._tables(np.asarray(w, np.float32).tobytes(), -1, dev)
    k_planar = graph_ms(lambda: cuda_fft.windowed_fft_cuda(x2, wt, tw), 20)
    k_complex = graph_ms(lambda: cuda_fft.windowed_fft_cuda(
        xc, wt, tw, planar=False), 20)
    k_eager = cuda_ms(lambda: cuda_fft.windowed_fft_cuda(x2, wt, tw), 20)
    p_ms = cuda_ms(lambda: cuda_fft.windowed_fft_plain(x2, wt), 20)
    xw = xc * wt                           # the library call's input
    yl = torch.fft.fft(xw)
    snr_lib = snr_db(yl.cpu().numpy(), torch.complex(
        *cuda_fft.windowed_fft_plain(x2, wt).split(N2, dim=1)).cpu().numpy())
    l_ms = graph_ms(lambda: torch.fft.fft(xw), 20)
    print(f"[17 windowed fft timing, F=4096 N=4096] kernel (CUDA graph of 20"
          f" launches) planar {k_planar:.4f} ms, complex {k_complex:.4f} ms, "
          f"planar launched eagerly {k_eager:.4f} ms; plain {p_ms:.4f} ms, "
          f"library torch.fft.fft on windowed complex64 frames (cuFFT, the "
          f"same CUDA graph timing) {l_ms:.4f} ms ({snr_lib:.1f} dB vs "
          f"plain), bound {bnd[0]:.4f} ms ({bnd[1]}) | {smi}", flush=True)
    x64 = x[:F2_F64]
    got = cuda_fft.windowed_fft_frames(xc[:F2_F64].contiguous(), w,
                                       planar=False).cpu().numpy()
    snr64 = snr_db(got, np.fft.fft(x64.astype(np.complex128) * w))
    print(f"[17 windowed fft kernel vs numpy float64 (CPU), x3, F=64] "
          f"{snr64:.1f} dB (gate {MIN_SNR_DB})", flush=True)
    if not snr64 >= MIN_SNR_DB:
        fail("phase 17: the windowed FFT kernel disagrees with float64")

    # 18. the config-2 path through the entry points, launches counted
    n = F2 * N2
    s = chirp(n, rng)
    sc = torch.from_numpy(s).to(dev)
    s2 = torch.stack([sc.real, sc.imag]).reshape(2, F2, N2).contiguous()
    k7 = cuda_fft.windowed_fft_cuda
    k7.launches = 0
    ya = fft_ops.windowed_fft(xc, "hamming")
    yp2 = fft_ops.windowed_fft_planar(s2, "hamming")
    sg = fft_ops.spectrogram(sc, frame=N2)
    torch.cuda.synchronize()
    launches = k7.launches
    yx = fft_ops.windowed_fft(xc, "hamming", backend="xla")
    snr_auto = snr_db(ya.cpu().numpy(), yx.cpu().numpy())
    p_planar = (yp2[:, :N2] ** 2 + yp2[:, N2:] ** 2).cpu().numpy()
    ok_p, worst_p = chirp_bins_ok(p_planar, n)
    ok_s, worst_s = chirp_bins_ok((sg.abs() ** 2).cpu().numpy(), n)
    k7.launches = 0
    tone_f = 0.1234
    tn = np.exp(2j * np.pi * tone_f * np.arange(1 << 22)).astype(np.complex64)
    psd = fft_ops.welch_psd(torch.from_numpy(tn).to(dev), frame=N2)
    torch.cuda.synchronize()
    welch_launches = k7.launches
    peak = int(torch.argmax(psd))
    print(f"[18 config-2 path, 2^24 samples] windowed_fft auto vs xla "
          f"{snr_auto:.1f} dB (gate {MIN_SNR_DB}); chirp peak bins within 1 of"
          f" its frequency: planar {ok_p} (worst {worst_p:.2f}), spectrogram "
          f"{ok_s} (worst {worst_s:.2f}); K7 launches {launches} (auto, "
          f"planar, spectrogram); welch_psd tone peak bin {peak} want "
          f"{round(tone_f * N2)}, K7 launches {welch_launches} (Welch frames "
          f"take torch.fft, as in the JAX package)", flush=True)
    if not (snr_auto >= MIN_SNR_DB and ok_p and ok_s and launches == 3
            and peak == round(tone_f * N2) and welch_launches == 0
            and sg.shape == (F2, N2)):
        fail("phase 18: the config-2 path is wrong")

    # 19. throughput: device time, host enqueue, profiler busy time
    for label, fn in (
            ("planar x3", lambda: fft_ops.windowed_fft_planar(x2, "hamming")),
            ("planar fast", lambda: fft_ops.windowed_fft_planar(
                x2, "hamming", mode="fast")),
            ("complex auto", lambda: fft_ops.windowed_fft(xc, "hamming")),
            ("xla", lambda: fft_ops.windowed_fft(xc, "hamming",
                                                 backend="xla")),
            ("plain", lambda: cuda_fft.windowed_fft_frames(
                x2, w, engine="torch"))):
        dev_ms, host_ms = timed(fn, N_TIMED)
        busy, top = profiled_busy(fn)
        print(f"[19 throughput {label}, F=4096 N=4096] {n / dev_ms / 1e3:.1f}"
              f" Msamples/s, {flops / dev_ms / 1e6:.1f} GFLOP/s ({dev_ms:.4f} "
              f"ms a call; host enqueue {host_ms:.4f} ms, device busy "
              f"{busy:.4f} ms, idle {max(0.0, 1 - busy / dev_ms):.0%}; "
              f"largest kernels, ms a call: {top}) | {smi}", flush=True)

    return [kernel_entry("windowed_fft", "windowed_fft.cu",
                         "solid_dsp_tpu/ops/pallas_fft.py:165", launches, err,
                         k_planar, p_ms, bnd, l_ms)]


def farrow_ref64(plan, tail: np.ndarray, t0: int, x: np.ndarray):
    """Independent float64 reference of one grid block: positions from the
    exact integer formula t_k = t0 + k R, the cubic Lagrange basis and the
    4-point stencil of [tail, x] in float64 (numpy)."""
    k = np.arange(plan.n_pad, dtype=np.int64)
    t = t0 + k * plan.R
    base = np.clip(t >> 20, 0, plan.L - 1)
    m = (t & ((1 << 20) - 1)) / float(1 << 20)
    c = np.stack([-m * (m - 1) * (m - 2) / 6, (m + 1) * (m - 1) * (m - 2) / 2,
                  -(m + 1) * m * (m - 2) / 2, (m + 1) * m * (m - 1) / 6], 1)
    ext = np.concatenate([tail, x]).astype(np.complex128)
    y = sum(c[:, i] * ext[base + i] for i in range(4))
    n_valid = plan.q0 + int(t0 < plan.r0)
    y[n_valid:] = 0
    return y, n_valid


def farrow_phases(dev, smi) -> list:
    """Phases 20-21: the Farrow grid resampler (ratio 48000/44100, blocks of
    2^22).  Returns the kernels' entry of K8."""
    from solid_dsp_tpu_torch.ops import cuda_resample, farrow, gridresample

    rng = np.random.default_rng(SEED + 8)
    blocks = [torch.from_numpy(cnoise(rng, L8)).to(dev) for _ in range(3)]
    init_k, apply_k, plan = cuda_resample.make_farrow_kernel_resampler(
        FARROW_RATIO, L8, device=dev)
    init_p, apply_p, _ = farrow.make_farrow_resampler(FARROW_RATIO, L8,
                                                      device=dev)

    # 20. K8 (the main path, counted) vs the torch-ops engine, 3 blocks
    k8 = cuda_resample.farrow_grid_cuda
    k8.launches = 0
    st_k, outs_k = init_k(), []
    for b in blocks:
        y, nv, st_k = apply_k(st_k, b)
        outs_k.append((y, nv))
    torch.cuda.synchronize()
    launches = k8.launches
    st_p, err, same = init_p(), 0.0, True
    for (yk, nk), b in zip(outs_k, blocks):
        yp, npl, st_p = apply_p(st_p, b)
        same = same and int(nk) == int(npl)
        err = max(err, float((yk - yp).abs().max()))
    same = (same and int(st_k[1]) == int(st_p[1])
            and torch.equal(st_k[0], st_p[0]))
    tail0 = torch.zeros(3, dtype=torch.complex64, device=dev)
    t00 = torch.zeros((), dtype=torch.int32, device=dev)
    k_ms = graph_ms(lambda: k8(plan, tail0, t00, blocks[0]), 20)
    k_eager = cuda_ms(lambda: k8(plan, tail0, t00, blocks[0]), 20)
    p_ms = cuda_ms(lambda: farrow.farrow_grid_plain(plan, tail0, t00,
                                                    blocks[0]), 20)
    bnd = bound_ms(8.0 * (L8 + plan.n_pad + 6) + 12, 30.0 * plan.n_pad,
                   FP32_FLOPS)
    print(f"[20 farrow kernel vs plain, ratio 48000/44100, L=2^22, 3 blocks] "
          f"max |err| {err:.3g} (gate {FARROW_ATOL}), n_valid/t0/tail equal "
          f"{same}, launches {launches}; kernel {k_ms:.4f} ms (CUDA graph "
          f"of 20 launches; launched eagerly {k_eager:.4f} ms, the host's "
          f"rate), plain {p_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), library none: no "
          f"one PyTorch call interpolates on a Farrow grid | {smi}",
          flush=True)
    if not (err <= FARROW_ATOL and same and launches == 3
            and all(bool(torch.isfinite(y).all()) for y, _ in outs_k)):
        fail("phase 20: the Farrow kernel disagrees with its plain version")
    plan64 = gridresample.plan_ratio(FARROW_RATIO, L8_F64)
    xs = cnoise(rng, L8_F64)
    tail = cnoise(rng, 3)
    t0 = plan64.R // 3
    y, nv, _ = k8(plan64, torch.from_numpy(tail).to(dev),
                  torch.tensor(t0, dtype=torch.int32, device=dev),
                  torch.from_numpy(xs).to(dev))
    y64, nv64 = farrow_ref64(plan64, tail, t0, xs)
    snr20 = snr_db(y.cpu().numpy(), y64)
    print(f"[20 farrow kernel vs numpy float64 (CPU), L=2^16] {snr20:.1f} dB "
          f"(gate {MIN_SNR_DB}), n_valid {int(nv)} want {nv64}", flush=True)
    if not (snr20 >= MIN_SNR_DB and int(nv) == nv64):
        fail("phase 20: the Farrow kernel disagrees with float64")

    # 21. throughput over 20 blocks (turns plain, kernel, kernel, plain)
    def rate(init, apply):
        st, i = [init()], iter(range(1 << 30))

        def step():
            st[0] = apply(st[0], blocks[next(i) % 3])[2]
        dev_ms, host_ms = timed(step, N_TIMED)
        return L8 / dev_ms / 1e3, host_ms

    p1 = rate(init_p, apply_p)
    r1 = rate(init_k, apply_k)
    r2 = rate(init_k, apply_k)
    p2 = rate(init_p, apply_p)
    print(f"[21 throughput farrow, 2^22-sample blocks] kernel {r1[0]:.1f} / "
          f"{r2[0]:.1f} Msamples/s of input (host enqueue {r1[1]:.4f} / "
          f"{r2[1]:.4f} ms a block), torch-ops engine {p1[0]:.1f} / "
          f"{p2[0]:.1f} | {smi}", flush=True)
    return [kernel_entry("farrow_grid", "farrow.cu",
                         "solid_dsp_tpu/ops/pallas_resample.py:114", launches,
                         err, k_ms, p_ms, bnd)]


def await_streams(streams, what: str, limit: float = PHASE_LIMIT_S):
    """Wait until every stream's work so far is done; a phase whose kernels
    are still running after ``limit`` seconds has hung: fail at once (the
    process's exit takes the card's context with it)."""
    events = []
    for s in streams:
        e = torch.cuda.Event()
        e.record(s)
        events.append(e)
    t0 = time.monotonic()
    while not all(e.query() for e in events):
        if time.monotonic() - t0 > limit:
            print(f"FAIL: {what} still running after {limit:.0f} s: a hang",
                  file=sys.stderr, flush=True)
            os._exit(1)
        time.sleep(0.005)


def ring_blocks(cuda_halo, ring, streams, order, blocks, tail, h_il,
                epoch: int, keep: bool = True):
    """K9 as len(ring) shards on one card: each block's slabs launched on
    the shards' own streams in ``order``, block b as epoch ``epoch + b``,
    the tail rows carried.  Returns [per block: [per shard: z]], or
    nothing with ``keep=False`` (each z freed at once, so that the
    allocator reuses its memory instead of growing)."""
    n = len(ring)
    L = blocks[0].shape[0] // n
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    out = []
    for b, x in enumerate(blocks):
        zs = [None] * n
        for i in order:
            with torch.cuda.stream(streams[i]):
                zs[i] = cuda_halo.halo_frontend_cuda(
                    x[i * L:(i + 1) * L], tail, h_il, M5, K5, ring[i],
                    epoch + b)
        tail = x[-K5 * M5:].reshape(K5, M5)
        if keep:
            out.append(zs)
    for s in streams:
        torch.cuda.current_stream().wait_stream(s)
    return out


def parallel_phases(dev, smi) -> list:
    """Phases 22-25: parallel/ on an NCCL group of one rank, and K9 as four
    shards on one card.  Returns the kernels' entry of K9."""
    import tempfile

    import torch.distributed as dist

    from solid_dsp_tpu_torch import parallel
    from solid_dsp_tpu_torch.models.channelizer import (PolyphaseChannelizer,
                                                        channelizer_taps)
    from solid_dsp_tpu_torch.models.rx_chain import (RxChainConfig,
                                                     make_rx_chain)
    from solid_dsp_tpu_torch.ops import cuda_chan, cuda_ddc, cuda_halo
    from solid_dsp_tpu_torch.parallel.pallas_halo import (
        halo_frontend_torch, make_fused_channelizer_frontend)

    counters = {"halo_frontend": cuda_halo.halo_frontend_cuda,
                "channelizer": cuda_chan.chan_fused_cuda,
                "pfb_frontend": cuda_chan.pfb_frontend_cuda,
                "ddc_fm": cuda_ddc.ddc_fm_cuda}

    def main_path(run):
        """run() with every count at 0 just before it; its counts after."""
        for c in counters.values():
            c.launches = 0
        out = run()
        torch.cuda.synchronize()
        return out, {k: c.launches for k, c in counters.items()}

    rng = np.random.default_rng(SEED + 9)
    h_il = torch.from_numpy(cuda_chan.pfb_frontend_taps(
        channelizer_taps(M5, K5), M5)).to(dev)
    U = L5 // M5
    with tempfile.TemporaryDirectory() as tmp:
        parallel.init_distributed(dev, f"{tmp}/store", 0, 1)
        try:
            mesh = parallel.make_mesh(1, 1)            # NCCL, on the card
            blk, tail0, link, zk, zp, launches = phase22(
                dev, mesh, rng, h_il, main_path,
                make_fused_channelizer_frontend, cuda_chan,
                halo_frontend_torch)
            four_ms = phase23(dev, rng, h_il, cuda_halo, cuda_chan)
            rates = phase24(dev, mesh, rng, main_path, parallel,
                            PolyphaseChannelizer, RxChainConfig,
                            make_rx_chain)
            # 25. times beside the card's name and power limit; one rank
            # is shard 0 and the last, so its launches never wait
            k_ms = graph_ms(lambda: cuda_halo.halo_frontend_cuda(
                blk, tail0, h_il, M5, K5, link, 1), 20)
            k5_ms = graph_ms(lambda: cuda_chan.pfb_frontend_cuda(
                blk, h_il, tail0, M5, K5), 20)
            p_ms = cuda_ms(lambda: halo_frontend_torch(
                tail0, blk, h_il, M5, K5, mesh), 20)
        finally:
            dist.destroy_process_group()
    xp_t = torch.cat([torch.view_as_real(tail0).reshape(K5, 2 * M5),
                      torch.view_as_real(blk).reshape(U, 2 * M5)]).T[None]
    xp_t = xp_t.contiguous()
    w = h_il.flip(0).T[:, None, :].contiguous()
    zl = torch.nn.functional.conv1d(xp_t, w, groups=2 * M5)[0].T
    snr_lib = snr_db(zl.cpu().numpy(),
                     torch.view_as_real(zp).reshape(U, 2 * M5).cpu().numpy())
    l_ms = cuda_ms(lambda: torch.nn.functional.conv1d(xp_t, w,
                                                      groups=2 * M5), 20)
    # one rank is shard 0 and the last: no halo moves, K5's bytes
    bnd = bound_ms(8 * L5 + 8 * K5 * M5 + 8 * (K5 + 1) * M5 + 8 * U * M5,
                   4 * (K5 + 1) * U * M5, FP32_FLOPS)
    err = float((zk - zp).abs().max())
    print(f"[25 K9 timing, M=256 K=8 L=2^22] kernel (CUDA graph of 20 "
          f"launches) {k_ms:.4f} ms, K5 the same way {k5_ms:.4f} ms; plain "
          f"{p_ms:.4f} ms; library grouped conv1d on [halo | x] {l_ms:.4f} "
          f"ms ({snr_lib:.1f} dB vs plain), the halo's NCCL send/recv not "
          f"measured (one card); bound {bnd[0]:.4f} ms ({bnd[1]}); four "
          f"shards on one card {four_ms:.4f} ms a block of 4 x 2^22 | "
          f"{smi}", flush=True)
    for label, (u1, s1, s2, u2) in rates.items():
        print(f"[25 throughput {label}] sharded at world size 1 {s1:.1f} / "
              f"{s2:.1f} Msamples/s, unsharded {u1:.1f} / {u2:.1f} | {smi}",
              flush=True)
    return [kernel_entry("halo_frontend", "halo_frontend.cu",
                         "solid_dsp_tpu/parallel/pallas_halo.py:111",
                         launches, err, k_ms, p_ms, bnd, l_ms)]


def phase22(dev, mesh, rng, h_il, main_path, make_frontend, cuda_chan,
            halo_frontend_torch):
    """22. K9 at world size 1 (an NCCL group of one rank): 4 blocks of 2^22
    with the tail carried, against its plain version, K5 on the same
    blocks and a tone in its channel; the tail rows bit-equal."""
    blocks = [torch.from_numpy(cnoise(rng, L5)).to(dev)
              for _ in range(N_CHAIN)]
    tail0 = torch.from_numpy(cnoise(rng, (K5, M5))).to(dev)
    k9 = make_frontend(mesh, M5, K5)
    plain = make_frontend(mesh, M5, K5, engine="torch")

    def run(fn):
        t, zs, tails = tail0, [], []
        for x in blocks:
            z, t = fn(t, x)
            zs.append(z)
            tails.append(t)
        return torch.cat(zs), tails

    (zk, tk), counts = main_path(lambda: run(k9))
    zp, tp = run(plain)
    z5, t5 = run(lambda t, x: cuda_chan.pfb_frontend(x, h_il, t, M5, K5))
    torch.cuda.synchronize()
    Yk, Yp, Y5 = (torch.fft.fft(z, dim=-1) for z in (zk, zp, z5))
    lim = FRONTEND_ATOL * float(Yp.abs().max())
    err_p = float((Yk - Yp).abs().max())
    err_5 = float((Yk - Y5).abs().max())
    tails = all(torch.equal(a, b) and torch.equal(a, c) and torch.equal(
        a, x[-K5 * M5:].reshape(K5, M5)) for a, b, c, x in zip(tk, tp, t5,
                                                                blocks))
    c = 201
    zt, _ = k9(torch.zeros_like(tail0), torch.from_numpy(tone(c, L5)).to(dev))
    ok_tone, ratio = tone_ok(torch.fft.fft(zt, dim=-1), c)
    print(f"[22 K9 at world size 1 (NCCL), M=256 K=8, {N_CHAIN} x 2^22] "
          f"channels vs plain max |err| {err_p:.3g}, vs K5 {err_5:.3g} (gate "
          f"{lim:.3g}), bit-equal to K5 {torch.equal(zk, z5)}, tails "
          f"bit-equal {tails}, launches {counts['halo_frontend']}, tone in "
          f"channel {c} {ratio:.0f}x the others", flush=True)
    if not (err_p <= lim and err_5 <= lim and tails and ok_tone
            and counts["halo_frontend"] == N_CHAIN
            and bool(torch.isfinite(zk).all())
            and zk.shape == (N_CHAIN * L5 // M5, M5)):
        fail("phase 22: K9 at world size 1 is wrong")
    return blocks[0], tail0, k9.link, zk[:L5 // M5], zp[:L5 // M5], \
        counts["halo_frontend"]


def phase23(dev, rng, h_il, cuda_halo, cuda_chan) -> float:
    """23. K9 as four shards on one card, each on its own stream, launched
    0 -> 3 and 3 -> 0, 3 blocks of 4 x 2^22: the concatenated z against K5
    on the whole 2^24 block, the tail rows bit-equal.  A hang fails the
    phase after PHASE_LIMIT_S.  Returns the four-shard form's ms a block."""
    n_blocks = 3
    full = [torch.from_numpy(cnoise(rng, 4 * L5)).to(dev)
            for _ in range(n_blocks)]
    tail0 = torch.from_numpy(cnoise(rng, (K5, M5))).to(dev)
    t, refs = tail0, []
    for x in full:
        z, t = cuda_chan.pfb_frontend(x, h_il, t, M5, K5)
        refs.append(z)
    del t
    torch.cuda.synchronize()
    for order in ((0, 1, 2, 3), (3, 2, 1, 0)):
        ring = cuda_halo.local_ring(4, M5, K5, dev)
        streams = [torch.cuda.Stream(dev) for _ in ring]
        outs = ring_blocks(cuda_halo, ring, streams, order, full, tail0,
                           h_il, 1)
        await_streams(streams, f"phase 23, order {order}")
        torch.cuda.synchronize()
        got = [torch.cat(zs) for zs in outs]
        lim = FRONTEND_ATOL * max(float(torch.fft.fft(r, dim=-1).abs().max())
                                  for r in refs)
        err = max(float((torch.fft.fft(g, dim=-1)
                         - torch.fft.fft(r, dim=-1)).abs().max())
                  for g, r in zip(got, refs))
        same = all(torch.equal(g, r) for g, r in zip(got, refs))
        print(f"[23 K9 as four shards on one card, order {order}, "
              f"{n_blocks} x 4 x 2^22] channels vs K5 on 2^24 max |err| "
              f"{err:.3g} (gate {lim:.3g}), bit-equal {same}", flush=True)
        if not (err <= lim and bool(all(torch.isfinite(g).all() for g in got))
                and all(g.shape == (4 * L5 // M5, M5) for g in got)):
            fail(f"phase 23: K9's four shards disagree (order {order})")
    # the four-shard form's time a block: N_TIMED blocks, order 0 -> 3
    ring = cuda_halo.local_ring(4, M5, K5, dev)
    streams = [torch.cuda.Stream(dev) for _ in ring]
    ring_blocks(cuda_halo, ring, streams, range(4), full, tail0, h_il, 1,
                keep=False)
    await_streams(streams, "phase 23 warm-up")
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    ring_blocks(cuda_halo, ring, streams, range(4),
                [full[i % n_blocks] for i in range(N_TIMED)], tail0, h_il,
                1 + n_blocks, keep=False)
    e1.record()
    await_streams([torch.cuda.current_stream()], "phase 23 timing")
    return e0.elapsed_time(e1) / N_TIMED


def phase24(dev, mesh, rng, main_path, parallel, PolyphaseChannelizer,
            RxChainConfig, make_rx_chain) -> dict:
    """24. The entry points at world size 1 against the single-card chains:
    make_sharded_channelizer ("xla", "fused" x3) at config 5,
    make_sharded_rx_chain planar FM at config 4 and its unfused LUT-parity
    staging on one cf32 stream, 3 blocks each with the state carried,
    launches counted.  Returns their throughput turns."""
    n_blocks = 3
    blocks5 = [torch.from_numpy(cnoise(rng, L5)).to(dev)
               for _ in range(n_blocks)]
    rates = {}
    for frontend in ("xla", "fused"):
        init, apply = parallel.make_sharded_channelizer(
            M5, K5, mesh, frontend=frontend, precision="x3")

        def sharded(blocks, state=None):
            t = init() if state is None else state
            ys = []
            for x in blocks:
                y, t = apply(t, x)
                ys.append(y)
            return torch.cat(ys), t

        single = PolyphaseChannelizer(M5, K5, backend=frontend,
                                      precision="x3", device=dev)
        (ys, ts), counts = main_path(lambda: sharded(blocks5))
        y1 = torch.cat([single.execute_block(x) for x in blocks5])
        same = torch.equal(ys, y1)
        snr = snr_db(ys.cpu().numpy(), y1.cpu().numpy())
        tails = torch.equal(ts, single.state)
        want = n_blocks if frontend == "fused" else 0
        print(f"[24 make_sharded_channelizer {frontend} at world size 1, "
              f"{n_blocks} x 2^22] vs PolyphaseChannelizer({frontend}): "
              f"bit-equal {same}, {snr:.1f} dB (gate {SHARDED_MIN_SNR_DB}), "
              f"tails equal {tails}, launches channelizer "
              f"{counts['channelizer']} (want {want})", flush=True)
        if not ((same or snr >= SHARDED_MIN_SNR_DB) and tails
                and counts["channelizer"] == want
                and ys.shape == (n_blocks * L5 // M5, M5)):
            fail(f"phase 24: the sharded {frontend} channelizer disagrees")

        state, nxt = [None], iter(range(1 << 30))

        def step_s():
            state[0] = sharded([blocks5[next(nxt) % n_blocks]], state[0])[1]

        def step_1():
            single.execute_block(blocks5[next(nxt) % n_blocks])

        turns = [timed(f, N_TIMED)[0] for f in (step_1, step_s, step_s,
                                                step_1)]
        rates[f"channelizer {frontend}, 2^22-sample blocks"] = tuple(
            L5 / (ms * 1e3) for ms in turns)

    cfg = RxChainConfig(carrier_freq=0.2, decimation=4, fir_taps=64,
                        agc_mode="block", demod="fm", nco_mode="exact",
                        input_format="planar", fused_ddc="on",
                        fir_precision="x3")
    blocks4 = [torch.from_numpy(make_block(rng, b, L_FULL)).to(dev)
               for b in range(n_blocks)]
    init_s, apply_s = parallel.make_sharded_rx_chain(cfg, mesh)
    init_1, apply_1 = make_rx_chain(cfg, dev)

    def chain(init, apply):
        st, outs = init(), []
        for x in blocks4:
            out, st = apply(st, x)
            outs.append(out)
        return torch.cat(outs), st

    (out_s, st_s), counts = main_path(lambda: chain(init_s, apply_s))
    out_1, st_1 = chain(init_1, apply_1)
    same = torch.equal(out_s, out_1)
    snr = snr_db(out_s.cpu().numpy(), out_1.cpu().numpy())
    state_ok = (int(st_s["nco_theta"]) == int(st_1["nco_theta"])
                and torch.equal(st_s["fir_tail"], st_1["fir_tail"])
                and torch.equal(st_s["agc"]["gain"], st_1["agc"]["gain"]))
    print(f"[24 make_sharded_rx_chain planar FM at world size 1, {n_blocks} "
          f"x 2^24] vs make_rx_chain: bit-equal {same}, {snr:.1f} dB (gate "
          f"{SHARDED_MIN_SNR_DB}), state equal {state_ok}, launches ddc_fm "
          f"{counts['ddc_fm']}", flush=True)
    if not ((same or snr >= SHARDED_MIN_SNR_DB) and state_ok
            and counts["ddc_fm"] == n_blocks
            and out_s.shape == (n_blocks * L_FULL // 4,)):
        fail("phase 24: the sharded FM chain disagrees")

    # the same at fir_precision="default": K1's fast mode on every shard
    from solid_dsp_tpu_torch.ops import cuda_ddc
    dcfg = replace(cfg, fir_precision="default")
    init_sd, apply_sd = parallel.make_sharded_rx_chain(dcfg, mesh)
    cuda_ddc.ddc_fm_cuda.fast_launches = 0
    out_sd, st_sd = chain(init_sd, apply_sd)
    torch.cuda.synchronize()
    fast = cuda_ddc.ddc_fm_cuda.fast_launches
    out_1d, st_1d = chain(*make_rx_chain(dcfg, dev))
    same_d = torch.equal(out_sd, out_1d)
    snr_d = snr_db(out_sd.cpu().numpy(), out_1d.cpu().numpy())
    state_d = (int(st_sd["nco_theta"]) == int(st_1d["nco_theta"])
               and torch.equal(st_sd["fir_tail"], st_1d["fir_tail"])
               and torch.equal(st_sd["agc"]["gain"], st_1d["agc"]["gain"]))
    print(f"[24 make_sharded_rx_chain planar FM at default, world size 1, "
          f"{n_blocks} x 2^24] vs make_rx_chain: bit-equal {same_d}, "
          f"{snr_d:.1f} dB (gate {SHARDED_MIN_SNR_DB}), state equal "
          f"{state_d}, K1 fast launches {fast}", flush=True)
    if not ((same_d or snr_d >= SHARDED_MIN_SNR_DB) and state_d
            and fast == n_blocks):
        fail("phase 24: the sharded FM chain at default disagrees")

    # the unfused parity staging (local_unfused): one cf32 stream as (1, L)
    ucfg = replace(cfg, nco_mode="lut", fused_ddc="auto", input_format="cf32",
                   fir_precision="highest")
    xs_u = [torch.complex(b[0], b[1]) for b in blocks4]
    init_su, apply_su = parallel.make_sharded_rx_chain(ucfg, mesh)
    init_1u, apply_1u = make_rx_chain(ucfg, dev)
    st_su, st_1u, outs_su, outs_1u = init_su(1), init_1u(), [], []
    for xb in xs_u:
        out, st_su = apply_su(st_su, xb[None])
        outs_su.append(out[0])
        out, st_1u = apply_1u(st_1u, xb)
        outs_1u.append(out)
    out_su, out_1u = torch.cat(outs_su), torch.cat(outs_1u)
    same_u = torch.equal(out_su, out_1u)
    snr_u = snr_db(out_su.cpu().numpy(), out_1u.cpu().numpy())
    state_u = (int(st_su["nco_theta"]) == int(st_1u["nco_theta"])
               and torch.equal(st_su["fir_tail"][0], st_1u["fir_tail"])
               and torch.allclose(st_su["agc"]["gain"][0],
                                  st_1u["agc"]["gain"], rtol=1e-6))
    print(f"[24 make_sharded_rx_chain unfused (LUT parity, local_unfused) at "
          f"world size 1, {n_blocks} x 2^24] vs make_rx_chain: bit-equal "
          f"{same_u}, {snr_u:.1f} dB (gate {SHARDED_MIN_SNR_DB}), state "
          f"equal {state_u}", flush=True)
    if not ((same_u or snr_u >= SHARDED_MIN_SNR_DB) and state_u
            and out_su.shape == (n_blocks * L_FULL // 4,)):
        fail("phase 24: the sharded unfused chain disagrees")
    del xs_u, outs_su, outs_1u

    def rx_step(init, apply):
        st, i = [init()], iter(range(1 << 30))

        def step():
            st[0] = apply(st[0], blocks4[next(i) % n_blocks])[1]
        return step

    turns = [timed(rx_step(*c), N_TIMED)[0]
             for c in ((init_1, apply_1), (init_s, apply_s),
                       (init_s, apply_s), (init_1, apply_1))]
    rates["planar FM chain, 2^24-sample blocks"] = tuple(
        L_FULL / (ms * 1e3) for ms in turns)
    return rates


def precision_phase(dev, smi):
    """26. A caller's torch.set_float32_matmul_precision("high") (cuBLAS in
    TF32) with cuDNN at PyTorch's default (TF32 on): the x3 gates of config
    4 (K1 and the DDC body kernel against their plain versions, the body's
    plain version against float64) and config 5 (K4 x3 against its plain
    version, the plain version and the planar channelizer against
    float64) still hold, since the port pins full float32 for its own
    products; conv1d_mxu >= 100 dB against float64; the caller's settings
    are the same afterwards."""
    from solid_dsp_tpu_torch.models.channelizer import (
        channelizer_apply_planar, channelizer_dft_bank, channelizer_taps)
    from solid_dsp_tpu_torch.models.rx_chain import RxChainConfig
    from solid_dsp_tpu_torch.ops import cuda_chan, cuda_ddc
    from solid_dsp_tpu_torch.ops.fir import conv1d_mxu
    from solid_dsp_tpu_torch.ops.nco import constrain

    rng = np.random.default_rng(SEED + 26)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        flags = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        snrs = {}
        cfg = RxChainConfig(carrier_freq=0.2, decimation=4, fir_taps=64,
                            fir_precision="x3")
        taps, dtheta = cfg.design_taps(), constrain(cfg.carrier_freq)
        x4 = make_block(rng, 0, L_F64)
        tail4 = (0.1 * rng.standard_normal((2, 60))).astype(np.float32)
        xd, td = torch.from_numpy(x4).to(dev), torch.from_numpy(tail4).to(dev)
        body = cuda_ddc.make_ddc_body(taps, dtheta, 4, dev)
        body64 = cuda_ddc.make_ddc_body(taps, dtheta, 4, "cpu", torch.float64)
        z64 = cuda_ddc.ddc_body_torch(body64, torch.from_numpy(x4).double(),
                                      torch.from_numpy(tail4).double())
        zp = cuda_ddc.ddc_body_torch(body, xd, td)
        snrs["config 4 body kernel vs plain"] = snr_db(
            cuda_ddc.ddc_body_cuda(body, xd, td).cpu().numpy(),
            zp.cpu().numpy())
        snrs["config 4 body plain vs float64"] = snr_db(zp.cpu().numpy(),
                                                        z64.numpy())
        fm = cuda_ddc.make_ddc_fm(taps, dtheta, 4, cfg.fm_kf, dev)
        snrs["config 4 FM kernel vs plain"] = snr_db(
            cuda_ddc.ddc_fm_cuda(fm, xd, td)[0].cpu().numpy(),
            cuda_ddc.ddc_fm_torch(fm, xd, td)[0].cpu().numpy())
        U = L5_F64 // M5
        xc = cnoise(rng, L5_F64)
        xf = np.stack([xc.real, xc.imag]).reshape(2, U, M5)
        tail5 = rng.standard_normal((2, 8, M5)).astype(np.float32)
        ctaps = channelizer_taps(M5, K5)
        b5 = cuda_chan.make_chan_body(ctaps, M5, "x3", dev)
        b64 = cuda_chan.make_chan_body(ctaps, M5, "x3", "cpu", torch.float64)
        xt, tt = torch.from_numpy(xf).to(dev), torch.from_numpy(tail5).to(dev)
        y5 = cuda_chan.chan_fused_torch(b5, xt, tt)
        y64 = cuda_chan.chan_fused_torch(b64, torch.from_numpy(xf).double(),
                                         torch.from_numpy(tail5).double())
        snrs["config 5 K4 x3 vs plain"] = snr_db(
            cuda_chan.chan_fused_cuda(b5, xt, tt).cpu().numpy(),
            y5.cpu().numpy())
        snrs["config 5 K4 plain vs float64"] = snr_db(y5.cpu().numpy(),
                                                      y64.numpy())
        bank = channelizer_dft_bank(M5, K5)
        x2 = np.stack([xc.real, xc.imag]).astype(np.float32)
        t2 = np.zeros((2, K5 * M5 - 1), np.float32)
        yq, _ = channelizer_apply_planar(ctaps, bank, torch.from_numpy(t2).to(
            dev), torch.from_numpy(x2).to(dev), M5, precision="x3")
        yq64, _ = channelizer_apply_planar(ctaps, bank, torch.from_numpy(
            t2).double(), torch.from_numpy(x2).double(), M5, precision="x3")
        snrs["config 5 planar channelizer x3 vs float64"] = snr_db(
            yq.cpu().numpy(), yq64.numpy())
        xs = cnoise(rng, L_F64)
        hs = (rng.standard_normal(64) + 1j * rng.standard_normal(64)
              ).astype(np.complex64)
        yc = conv1d_mxu(torch.from_numpy(xs).to(dev), torch.from_numpy(hs).to(
            dev))
        yc64 = conv1d_mxu(torch.from_numpy(xs).to(torch.complex128),
                          torch.from_numpy(hs).to(torch.complex128))
        conv = snr_db(yc.cpu().numpy(), yc64.numpy())
        after = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32,
                 torch.get_float32_matmul_precision())
    finally:
        torch.set_float32_matmul_precision(prev)
    text = ", ".join(f"{k} {v:.1f} dB" for k, v in snrs.items())
    print(f"[26 x3 gates under the caller's float32 matmul precision 'high' "
          f"(cuBLAS TF32 {flags[0]}, cuDNN TF32 {flags[1]})] {text} (gate "
          f"{MIN_SNR_DB}); conv1d_mxu complex64 vs float64 {conv:.1f} dB "
          f"(gate {CONV_MIN_SNR_DB}); caller's flags after "
          f"{after}", flush=True)
    if not (flags == (True, True) and after == (True, True, "high")
            and all(v >= MIN_SNR_DB for v in snrs.values())
            and conv >= CONV_MIN_SNR_DB):
        fail("phase 26: an x3 product lost precision under the caller's "
             "TF32 settings")


def zero_stuff_model(x: np.ndarray, coefs: np.ndarray, P: int, Q: int):
    """Config 3's independent model in float64: interpolate by P with each
    branch's coefficients time-reversed, as the reference's bank applies
    them (out[n P + f] = sum_k eff[f + (L-1-k) P] x[n-k]), then keep every
    Q-th output (tests/test_snr_configs.py:160-176)."""
    c = np.asarray(coefs, np.complex128)
    sub_len = -(-len(c) // P)
    eff = np.zeros(sub_len * P, np.complex128)
    eff[:len(c)] = c
    up = np.empty(len(x) * P, np.complex128)
    for f in range(P):
        up[f::P] = np.convolve(x, eff[f::P][::-1])[:len(x)]
    return up[::Q]


def filter_phases(dev, smi):
    """Phases 27-28: config 1 (FIRFilter on a 2^20-sample tone) and config
    3 (RationalResampler 3/2 and 1/8 on 3 blocks of 2^22)."""
    from solid_dsp_tpu_torch.design import firdes
    from solid_dsp_tpu_torch.ops import fir as fir_ops

    rng = np.random.default_rng(SEED + 27)
    # 27. config 1, every method, four blocks with the tail carried
    n, blk = L_CFG1, L_CFG1 // N_CFG1
    k = np.arange(n)
    x = 0.5 * np.exp(2j * np.pi * 0.03 * k) + 0.01 * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
    taps = firdes.firdes_kaiser(64, 0.1, 60.0)
    ref = np.convolve(x, taps[::-1])[:n]
    xs = {torch.complex64: torch.from_numpy(x.astype(np.complex64)).to(dev),
          torch.complex128: torch.from_numpy(x).to(dev)}
    fir_ops._METHOD_CACHE.clear()
    out, snrs = {}, {}
    for method in ("matmul", "fft", "auto", "measure"):
        for dt, xt in xs.items():
            f = fir_ops.FIRFilter(taps, dtype=dt, method=method, device=dev)
            y = torch.cat([f.execute_block(xt[b * blk:(b + 1) * blk])
                           for b in range(N_CFG1)])
            out[method, dt] = y.cpu().numpy()
        snrs[method] = snr_db(out[method, torch.complex64], ref)
    m_snr = snr_db(out["fft", torch.complex128],
                   out["matmul", torch.complex128])
    measured = fir_ops._METHOD_CACHE.get((64, blk, "torch.complex64",
                                          torch.device(dev).type))
    auto = fir_ops._pick_method("auto", 64, blk, dev)
    rates = {}
    for method in ("matmul", "fft"):
        f = fir_ops.FIRFilter(taps, dtype=torch.complex64, method=method,
                              device=dev)
        xb = xs[torch.complex64][:blk]
        rates[method] = blk / (timed(lambda: f.execute_block(xb),
                                     N_TIMED)[0] * 1e3)
    print(f"[27 config 1: FIRFilter(kaiser 64, complex64), {N_CFG1} x 2^18 "
          f"with the tail carried] vs numpy float64: "
          + ", ".join(f"{m} {v:.1f} dB" for m, v in snrs.items())
          + f" (gate {CFG1_MIN_SNR_DB}); fft vs matmul in complex128 "
          f"{m_snr:.1f} dB (gate {METHODS_MIN_SNR_DB}); auto takes {auto}, "
          f"measure took {measured}; matmul {rates['matmul']:.1f}, fft "
          f"{rates['fft']:.1f} Msamples/s | {smi}", flush=True)
    if not (min(snrs.values()) >= CFG1_MIN_SNR_DB
            and m_snr >= METHODS_MIN_SNR_DB and measured in ("matmul", "fft")
            and all(o.shape == (n,) for o in out.values())):
        fail("phase 27: config 1 disagrees with its float64 reference")
    # the FIR route of the unfused chain: conv1d (cuDNN) against the
    # banded-Toeplitz matmul at stride 4 over 2^24 samples, with config 4's
    # 64 taps and with 4 taps, one on each side of
    # ops/fir.py::CARD_TOEPLITZ_MIN_TAPS (torch_kernel_sweep.py fir-route
    # measures the rest)
    xc = torch.from_numpy(cnoise(rng, L_FULL + 63, 0.1)).to(dev)
    for nt in (64, 4):
        tc = firdes.firdes_kaiser(nt, 0.1, 60.0)
        tc = (tc / np.sum(tc)).astype(np.complex64)
        xn = xc[: L_FULL + nt - 1]
        tct = torch.from_numpy(tc).to(dev)
        a = fir_ops.conv1d_mxu(xn, tct, stride=4)
        b = fir_ops.fir_toeplitz(xn, tc, stride=4)
        route_snr = snr_db(b.cpu().numpy(), a.cpu().numpy())
        conv_ms = graph_ms(lambda: fir_ops.conv1d_mxu(xn, tct, stride=4), 10)
        toep_ms = graph_ms(lambda: fir_ops.fir_toeplitz(xn, tc, stride=4), 10)
        takes = "toeplitz" if fir_ops._use_toeplitz(xn, nt) else "conv1d"
        print(f"[27 fir_decim_apply's route, {nt} taps, stride 4, 2^24] "
              f"conv1d {conv_ms:.4f} ms, banded-Toeplitz matmul "
              f"{toep_ms:.4f} ms (CUDA graph of 10 calls), {route_snr:.1f} "
              f"dB apart; the card takes {takes} | {smi}", flush=True)
        if route_snr < METHODS_MIN_SNR_DB:
            fail("phase 27: conv1d and the Toeplitz matmul disagree")
        del a, b
    del xc, xn

    # 28. config 3, both ratios, three blocks with the phase and tail
    for P, Q in ((3, 2), (1, 8)):
        taps3 = firdes.firdes_kaiser(48 * P, 0.4 / max(P, Q), 60.0)
        x3 = rng.standard_normal(N_CFG3 * L_CFG3) + 1j * rng.standard_normal(
            N_CFG3 * L_CFG3)
        want = zero_stuff_model(x3, taps3, P, Q)
        r128 = fir_ops.RationalResampler(taps3, P, Q, dtype=torch.complex128,
                                         device=dev)
        r64 = fir_ops.RationalResampler(taps3.astype(np.float32), P, Q,
                                        dtype=torch.complex64, device=dev)
        b128 = [torch.from_numpy(x3[b * L_CFG3:(b + 1) * L_CFG3]).to(dev)
                for b in range(N_CFG3)]
        b64 = [t.to(torch.complex64) for t in b128]
        y128 = torch.cat([r128.execute_block(t) for t in b128])
        y64 = torch.cat([r64.execute_block(t) for t in b64])
        s128 = snr_db(y128.cpu().numpy(), want)
        s64 = snr_db(y64.cpu().numpy(), y128.cpu().numpy())
        turn = iter(range(1 << 30))
        rate = L_CFG3 / (timed(lambda: r64.execute_block(
            b64[next(turn) % N_CFG3]), N_TIMED)[0] * 1e3)
        rate128 = L_CFG3 / (timed(lambda: r128.execute_block(
            b128[next(turn) % N_CFG3]), N_TIMED)[0] * 1e3)
        print(f"[28 config 3: RationalResampler({P}, {Q}), {N_CFG3} x 2^22 "
              f"with the phase and tail carried] complex128 vs the zero-stuff "
              f"model {s128:.1f} dB (gate {CFG3_MIN_SNR_DB}), complex64 vs "
              f"complex128 {s64:.1f} dB (gate {CFG3_C64_MIN_SNR_DB}), "
              f"{len(want)} outputs; complex64 {rate:.1f}, complex128 "
              f"{rate128:.1f} Msamples/s of input | {smi}", flush=True)
        if not (s128 >= CFG3_MIN_SNR_DB and s64 >= CFG3_C64_MIN_SNR_DB
                and y128.shape == y64.shape == want.shape
                and y64.dtype == torch.complex64):
            fail(f"phase 28: the {P}/{Q} resampler disagrees with its model")


def scan_phases(dev, smi) -> list:
    """Phases 29-31: S1 and S2 against their plain versions, the
    exact-AGC and parity chains (launches and host syncs counted), their
    throughput.  Returns the kernels' entries of S1 and S2."""
    from solid_dsp_tpu_torch.models import qpsk as qpsk_ops
    from solid_dsp_tpu_torch.models.rx_chain import (RxChainConfig,
                                                     make_rx_chain)
    from solid_dsp_tpu_torch.ops import agc as agc_ops
    from solid_dsp_tpu_torch.ops import cuda_ddc, cuda_scan
    from solid_dsp_tpu_torch.ops.nco import constrain

    rng = np.random.default_rng(SEED + 29)
    S = agc_ops.SquelchMode

    def rel(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())

    # 29. S1 in float32 on the card against its plain version
    x = torch.from_numpy(cnoise(rng, T_S1, 0.1)).to(dev)
    st = agc_ops.agc_init(torch.float32, dev)
    yk, sk = agc_ops.agc_apply(st, x, AGC_BW, 1.0, -1e30, 100)
    yp, sp = agc_ops.agc_scan_plain(st, x, AGC_BW, 1.0, -1e30, 100)
    e1 = rel(yk, yp)
    g1 = abs(float(sk["gain"]) / float(sp["gain"]) - 1.0)
    ok1 = (e1 <= S1_RTOL and g1 <= S1_RTOL
           and int(sk["mode"]) == int(sp["mode"])
           and int(sk["timer"]) == int(sp["timer"]))
    # float64 on the card against the plain version on the CPU, a random
    # block and the squelch walk (loud -> quiet, threshold -30, timeout 20)
    loud = np.exp(1j * rng.standard_normal(50))
    quiet = 1e-8 * np.exp(1j * rng.standard_normal(300))
    e64, modes = [], []
    for xs, mode0, alpha, thr, to in (
            (cnoise(rng, T_S1_F64, 0.3).astype(np.complex128), S.DISABLED,
             0.05, -1e30, 100),
            (np.concatenate([loud, quiet]), S.ENABLED, 0.1, -30.0, 20)):
        st64 = agc_ops.agc_init(torch.float64, "cpu")
        st64["mode"] = torch.tensor(mode0, dtype=torch.int32)
        yc, sc = agc_ops.agc_scan_plain(st64, torch.from_numpy(xs), alpha,
                                        1.0, thr, to)
        yg, sg = agc_ops.agc_apply({k: v.to(dev) for k, v in st64.items()},
                                   torch.from_numpy(xs).to(dev), alpha, 1.0,
                                   thr, to)
        e64.append(float(np.abs(yg.cpu().numpy() - yc.numpy()).max()))
        modes.append((int(sg["mode"]), int(sc["mode"]), int(sg["timer"]),
                       int(sc["timer"])))
    ok64 = max(e64) <= S1_F64_ATOL and all(a == b and c == d
                                           for a, b, c, d in modes)
    print(f"[29 S1 vs plain] float32 on the card, T=2^14: max|dy| "
          f"{e1:.3g} x max|y| (gate {S1_RTOL}), gain rel err {g1:.3g}, "
          f"bit-equal {torch.equal(yk, yp)}; float64 vs the plain version on "
          f"the CPU: max|dy| {max(e64):.3g} (gate {S1_F64_ATOL}), the squelch "
          f"walk's mode/timer (card, cpu) {modes[1]}", flush=True)
    if not (ok1 and ok64 and modes[1][0] == S.ENABLED):
        fail("phase 29: S1 disagrees with its plain version")

    # S1's FSM entry against its plain version on card tensors, over an
    # rssi walk across the threshold (-30 dB, timeout 20) that visits every
    # state: float32 at T = 2^16 (the shape phase 30's squelch path gives
    # it, the plain version timed there), float64 at 4096
    walk = rssi_walk(rng, T_SCAN)
    fsm = {}
    for dt, T in ((torch.float32, T_SCAN), (torch.float64, T_S1_F64)):
        r = torch.from_numpy(walk[:T]).to(device=dev, dtype=dt)
        m0 = torch.tensor(S.ENABLED, dtype=torch.int32, device=dev)
        t0 = torch.zeros((), dtype=torch.int32, device=dev)
        got = cuda_scan.squelch_fsm_cuda(r, m0, t0, SQ_THRESHOLD, SQ_TIMEOUT)
        box = {}

        def fsm_plain():
            box["m"] = agc_ops.squelch_fsm_plain(r, m0, t0, SQ_THRESHOLD,
                                                 SQ_TIMEOUT)
        plain_ms = cuda_ms_once(fsm_plain)
        want = box["m"]
        fsm[dt] = (int((got[0] - want[0]).abs().max()),
                   all(torch.equal(a, b) for a, b in zip(got, want)),
                   sorted(int(v) for v in torch.unique(got[0]).cpu()),
                   plain_ms, r, m0, t0)
    fsm_err, _, visited, fsm_plain_ms, r32, m0, t0 = fsm[torch.float32]
    print(f"[29 S1's FSM entry vs plain, rssi walk across -30 dB, timeout "
          f"20] float32 T=2^16: modes and final mode/timer equal "
          f"{fsm[torch.float32][1]} (max |dmode| {fsm_err}), states visited "
          f"{visited}; float64 T={T_S1_F64}: equal {fsm[torch.float64][1]}",
          flush=True)
    if not (fsm[torch.float32][1] and fsm[torch.float64][1]
            and visited == list(range(1, 7))):
        fail("phase 29: S1's FSM entry disagrees with its plain version")

    # agc_apply_parallel against S1 at T = 2^22; an all-zero block falls
    # back to S1, bit-equal to it (float32 alpha, as the fall-back has it)
    xp = torch.from_numpy(cnoise(rng, T_PAR, 0.1)).to(dev)
    fb0 = agc_ops.agc_apply_parallel.fallbacks
    ypar, spar = agc_ops.agc_apply_parallel(st, xp, AGC_BW, 1.0, -1e30, 100)
    iters, syncs = (agc_ops.agc_apply_parallel.newton_iters,
                    agc_ops.agc_apply_parallel.syncs)
    yex, sex = agc_ops.agc_apply(st, xp, AGC_BW, 1.0, -1e30, 100)
    ep = rel(ypar, yex)
    gp = abs(float(spar["gain"]) / float(sex["gain"]) - 1.0)
    no_fb = agc_ops.agc_apply_parallel.fallbacks == fb0
    z = torch.zeros(T_PAR, dtype=torch.complex64, device=dev)
    fl0 = cuda_scan.agc_scan_cuda.fallback_launches
    yz, sz = agc_ops.agc_apply_parallel(st, z, AGC_BW, 1.0, -1e30, 100)
    yz1, sz1 = agc_ops.agc_apply(st, z, np.float32(AGC_BW), 1.0, -1e30, 100)
    zero_ok = (torch.equal(yz, yz1) and torch.equal(sz["gain"], sz1["gain"])
               and torch.equal(sz["energy"], sz1["energy"])
               and cuda_scan.agc_scan_cuda.fallback_launches == fl0 + 1)
    print(f"[29 agc_apply_parallel vs S1, float32, T=2^22] max|dy| {ep:.3g} "
          f"x max|y| (gate {S1_RTOL}), gain rel err {gp:.3g}, Newton "
          f"iterations {iters}, host syncs {syncs}, no fall-back {no_fb}; "
          f"all-zero block: fall-back to S1 bit-equal {zero_ok} (gain "
          f"{float(sz['gain']):g})", flush=True)
    if not (ep <= S1_RTOL and gp <= S1_RTOL and no_fb and zero_ok):
        fail("phase 29: agc_apply_parallel disagrees with S1")

    # S2: 2^16 QPSK symbols with a carrier offset through
    # qpsk_demodulate(recovery="pll"), the entry point a user calls
    sym = rng.integers(0, 4, T_SCAN)
    xq = GRAY[sym] * np.exp(1j * (0.003 * np.arange(T_SCAN) + 0.4))
    xq = torch.from_numpy((xq + 0.05 * (rng.standard_normal(T_SCAN) + 1j
                                        * rng.standard_normal(T_SCAN))
                           ).astype(np.complex64)).to(dev)
    cuda_scan.costas_pll_cuda.launches = 0
    sk2, yk2 = qpsk_ops.qpsk_demodulate(xq, recovery="pll",
                                        bandwidth=PLL_BW)
    torch.cuda.synchronize()
    s2_launches = cuda_scan.costas_pll_cuda.launches
    zr = torch.zeros((), dtype=torch.float32, device=dev)
    box = {}

    def s2_plain():
        box["y"] = qpsk_ops.costas_pll_plain(xq, PLL_BW,
                                             float(np.sqrt(PLL_BW)), zr, zr)
    s2_plain_ms = cuda_ms_once(s2_plain)
    yp2 = box["y"][0]
    s2_err = float((yk2 - yp2).abs().max())
    s2_eq = torch.equal(sk2, qpsk_ops.qpsk_slice(yp2))
    lock = T_SCAN // 16                    # past the loop's pull-in
    ser2 = qpsk_ops.symbol_error_rate(sym[lock:], sk2.cpu().numpy()[lock:])
    print(f"[29 S2 vs plain, 2^16 QPSK symbols, 0.003 rad/symbol offset] "
          f"symbols equal {s2_eq}, max|dy| {s2_err:.3g}, SER {ser2:.3g} "
          f"(gate {MAX_SER}), launches {s2_launches}", flush=True)
    if not (s2_eq and ser2 < MAX_SER and s2_launches == 1):
        fail("phase 29: S2 disagrees with its plain version")

    # S1 at T = 2^16 (a 2^18 block decimated by 4, phase 30(c)'s shape)
    # against its plain version, which is timed once there; the kernels'
    # times: a CUDA graph of 5 launches
    xs1 = torch.from_numpy(cnoise(rng, T_SCAN, 0.1)).to(dev)
    box = {}

    def s1_plain():
        box["y"] = agc_ops.agc_scan_plain(st, xs1, AGC_BW, 1.0, -1e30, 100)
    s1_plain_ms = cuda_ms_once(s1_plain)
    yp16, sp16 = box["y"]
    yk16, sk16 = agc_ops.agc_apply(st, xs1, AGC_BW, 1.0, -1e30, 100)
    s1_err = float((yk16 - yp16).abs().max())
    e16 = rel(yk16, yp16)
    g16 = abs(float(sk16["gain"]) / float(sp16["gain"]) - 1.0)
    ok16 = (e16 <= S1_RTOL and g16 <= S1_RTOL
            and int(sk16["mode"]) == int(sp16["mode"])
            and int(sk16["timer"]) == int(sp16["timer"]))
    s1_ms = graph_ms(lambda: agc_ops.agc_apply(st, xs1, AGC_BW, 1.0, -1e30,
                                               100), 5)
    s2_ms = graph_ms(lambda: qpsk_ops.qpsk_carrier_pll(xq, PLL_BW), 5)
    fsm_ms = graph_ms(lambda: cuda_scan.squelch_fsm_cuda(
        r32, m0, t0, SQ_THRESHOLD, SQ_TIMEOUT), 5)
    # S1's FSM entry on one lane of 2^22 against its chunked plain version
    # (the kernel's three passes in torch ops) on the card
    r22 = torch.from_numpy(rssi_walk(np.random.default_rng(SEED + 129),
                                     T_FSM_LONG)).to(dev, torch.float32)
    got22 = cuda_scan.squelch_fsm_cuda(r22, m0, t0, SQ_THRESHOLD, SQ_TIMEOUT)
    box = {}

    def fsm_chunked():
        box["m"] = agc_ops.squelch_fsm_chunked_torch(r22, m0, t0,
                                                     SQ_THRESHOLD, SQ_TIMEOUT)
    chunked_ms = cuda_ms_once(fsm_chunked)
    eq22 = all(torch.equal(a, b) for a, b in zip(got22, box["m"]))
    fsm22_ms = graph_ms(lambda: cuda_scan.squelch_fsm_cuda(
        r22, m0, t0, SQ_THRESHOLD, SQ_TIMEOUT), 5)
    b22 = bound_ms(8 * T_FSM_LONG + 16, T_FSM_LONG, FP32_FLOPS)
    # bytes: each sample read and written once (8 + 8; the FSM 4 + 4), the
    # carry
    b1 = bound_ms(16 * T_SCAN + 20, 12 * T_SCAN, FP32_FLOPS)
    b2 = bound_ms(16 * T_SCAN + 8, 40 * T_SCAN, FP32_FLOPS)
    b3 = bound_ms(8 * T_SCAN + 16, T_SCAN, FP32_FLOPS)
    print(f"[29 S1 vs plain, float32 on the card, T=2^16] max|dy| {e16:.3g} "
          f"x max|y| (gate {S1_RTOL}), max |dy| {s1_err:.3g}, gain rel err "
          f"{g16:.3g}, bit-equal {torch.equal(yk16, yp16)}", flush=True)
    print(f"[29 scan times, T=2^16] S1 {s1_ms:.4f} ms ({s1_ms * 1e3 / T_SCAN:.4f} "
          f"us a sample), plain {s1_plain_ms:.1f} ms; S2 {s2_ms:.4f} ms "
          f"({s2_ms * 1e3 / T_SCAN:.4f} us a sample), plain "
          f"{s2_plain_ms:.1f} ms; bytes bounds {b1[0]:.5f} / {b2[0]:.5f} "
          f"ms, both latency-bound (one dependent step a sample) | {smi}",
          flush=True)
    print(f"[29 S1's FSM entry, chunk-and-join, three launches] T=2^16: "
          f"{fsm_ms:.4f} ms ({fsm_ms * 1e6 / T_SCAN:.3f} ns a step), bound "
          f"{b3[0]:.5f} ms ({b3[1]}), plain {fsm_plain_ms:.1f} ms, the "
          f"sequential kernel {SEQUENTIAL_FSM_MS} ms; one lane of 2^22: "
          f"{fsm22_ms:.4f} ms ({fsm22_ms * 1e6 / T_FSM_LONG:.3f} ns a "
          f"step), bound {b22[0]:.5f} ms ({b22[1]}), its chunked plain "
          f"version {chunked_ms:.1f} ms, bit-equal to it {eq22} | {smi}",
          flush=True)
    if not ok16:
        fail("phase 29: S1 disagrees with its plain version at T = 2^16")
    if not eq22:
        fail("phase 29: S1's FSM entry disagrees with its chunked plain "
             "version at 2^22")

    # 30. the exact-AGC and parity chains, 4 blocks each, state carried
    base = RxChainConfig(carrier_freq=0.2, decimation=4, fir_taps=64,
                         agc_mode="parallel", demod="fm", nco_mode="exact",
                         input_format="planar", fused_ddc="on",
                         fir_precision="x3")
    parity = replace(base, nco_mode="lut", fused_ddc="auto")
    qsym = qpsk_symbols(N_CHAIN, L_FULL)
    blocks = {L: [torch.from_numpy(make_block(rng, b, L)).to(dev)
                  for b in range(N_CHAIN)] for L in (L_FULL, L_EXACT)}
    qblocks = [torch.from_numpy(make_qpsk_block(rng, qsym, b, L_FULL)).to(dev)
               for b in range(N_CHAIN)]
    paths = {
        "a fused K2/K3, parallel AGC, FM": (base, L_FULL),
        "b parity (LUT, unfused), parallel AGC, FM": (parity, L_FULL),
        "b parity (LUT, unfused), parallel AGC, QPSK":
            (replace(parity, demod="qpsk"), L_FULL),
        "c fused K2/K3, exact AGC (S1), FM":
            (replace(base, agc_mode="exact"), L_EXACT),
        "c parity (LUT, unfused), exact AGC (S1), FM":
            (replace(parity, agc_mode="exact"), L_EXACT),
        "c fused K2/K3, parallel AGC, FM": (base, L_EXACT),
        "c parity (LUT, unfused), parallel AGC, FM": (parity, L_EXACT),
    }
    sq_blocks = [torch.from_numpy(b).to(dev)
                 for b in burst_blocks(rng, N_CHAIN, T_SCAN)]
    counters = (cuda_scan.agc_scan_cuda, cuda_ddc.ddc_body_cuda,
                cuda_ddc.ddc_body_unaligned_cuda, cuda_scan.squelch_fsm_cuda)
    for c in counters:
        c.launches = 0
    fb0 = agc_ops.agc_apply_parallel.fallbacks
    runs = {}
    for label, (ccfg, L) in paths.items():
        init, apply = make_rx_chain(ccfg, dev)
        st, outs, syncs, iters = init(), [], 0, 0
        blks = qblocks if ccfg.demod == "qpsk" else blocks[L]
        for xb in blks:
            out, st = apply(st, xb)
            outs.append(out)
            if ccfg.agc_mode == "parallel":
                syncs += agc_ops.agc_apply_parallel.syncs
                iters += agc_ops.agc_apply_parallel.newton_iters
        torch.cuda.synchronize()
        runs[label] = (torch.cat(outs), st, (init, apply), blks, L,
                       syncs / N_CHAIN, iters / N_CHAIN)
    # (d) the AGC class with the squelch on, float32, 2^16-sample bursts
    # (loud / 40 dB down): the parallel method runs S1's FSM entry after
    # each Newton solve; the "scan" method (S1) on the same blocks
    sq = {}
    for method in ("parallel", "scan"):
        a = agc_ops.AGC(torch.float32, method=method, device=dev)
        a.squelch_enable()
        a.squelch_set_threshold(SQ_THRESHOLD)
        a.squelch_set_timeout(SQ_TIMEOUT)
        ys, syncs, iters = [], 0, 0
        for xb in sq_blocks:
            ys.append(a.execute_block(xb))
            if method == "parallel":
                syncs += agc_ops.agc_apply_parallel.syncs
                iters += agc_ops.agc_apply_parallel.newton_iters
        torch.cuda.synchronize()
        sq[method] = (torch.cat(ys), a.state, syncs / N_CHAIN,
                      iters / N_CHAIN)
    s1_launches, k2, k3, fsm_launches = (c.launches for c in counters)
    fallbacks = agc_ops.agc_apply_parallel.fallbacks - fb0
    tone = 4 * 0.001 / base.fm_kf
    dtheta = int(constrain(0.2))
    ok30 = fallbacks == 0 and s1_launches == 3 * N_CHAIN and k3 == 0 \
        and k2 == 3 * N_CHAIN and fsm_launches == N_CHAIN
    for label, (out, st, _, blks, L, syncs, iters) in runs.items():
        o = out.cpu().numpy()
        theta_ok = int(st["nco_theta"]) == (N_CHAIN * L * dtheta) & 0xFFFFFFFF
        if "QPSK" in label:
            T = L // 4
            sers = [best_aligned_ser(
                qsym[b * T // 8:(b + 1) * T // 8],
                (o[b * T:(b + 1) * T][11::8].real < 0).astype(int)
                + 2 * (o[b * T:(b + 1) * T][11::8].imag < 0))
                for b in range(N_CHAIN)]
            check, good = f"SER per block {sers}", max(sers) < MAX_SER
        else:
            got = float(np.median(o[1000:]))
            check = f"tone {got:.6f} want {tone:.6f}"
            good = abs(got - tone) <= TONE_ATOL
        ok30 = ok30 and good and theta_ok and bool(np.all(np.isfinite(o)))
        print(f"[30 {label}, {N_CHAIN} x {L}] {check}, nco_theta ok "
              f"{theta_ok}, host syncs {syncs:g} a block (Newton iterations "
              f"{iters:g})", flush=True)
    for kind in ("fused K2/K3", "parity (LUT, unfused)"):
        ex = runs[f"c {kind}, exact AGC (S1), FM"]
        pa = runs[f"c {kind}, parallel AGC, FM"]
        e30 = rel(pa[0], ex[0])
        g30 = abs(float(pa[1]["agc"]["gain"]) / float(ex[1]["agc"]["gain"])
                  - 1.0)
        same_mode = int(pa[1]["agc"]["mode"]) == int(ex[1]["agc"]["mode"])
        print(f"[30 {kind}: parallel vs exact AGC on the same {N_CHAIN} x "
              f"2^18 blocks] max|dout| {e30:.3g} x max|out| (gate "
              f"{S1_RTOL}), gain rel err {g30:.3g}, mode equal {same_mode}",
              flush=True)
        ok30 = ok30 and e30 <= S1_RTOL and g30 <= S1_RTOL and same_mode
    (yd, sd, syncs, iters), (ye, se, _, _) = sq["parallel"], sq["scan"]
    e30 = rel(yd, ye)
    g30 = abs(float(sd["gain"]) / float(se["gain"]) - 1.0)
    same = (int(sd["mode"]), int(sd["timer"])) == (int(se["mode"]),
                                                   int(se["timer"]))
    print(f"[30 d AGC(parallel), squelch on (-30 dB, timeout 20), float32, "
          f"{N_CHAIN} x 2^16 bursts, vs AGC(scan)] max|dy| {e30:.3g} x "
          f"max|y| (gate {S1_RTOL}), gain rel err {g30:.3g}, final mode and "
          f"timer equal {same} (mode {int(sd['mode'])}), host syncs "
          f"{syncs:g} a block (Newton iterations {iters:g})", flush=True)
    ok30 = (ok30 and e30 <= S1_RTOL and g30 <= S1_RTOL and same
            and bool(torch.isfinite(yd).all()))
    print(f"[30 launches on these paths] S1 {s1_launches} (want "
          f"{3 * N_CHAIN}), K2 {k2} (want {3 * N_CHAIN}), K3 {k3}, S1's FSM "
          f"entry {fsm_launches} (want {N_CHAIN}), parallel fall-backs "
          f"{fallbacks}", flush=True)
    if not ok30:
        fail("phase 30: an exact-AGC or parity chain is wrong")

    # 31. throughput: Msamples/s of input over 20 blocks (5 for the exact
    # AGC); host enqueue, the profiler's device time and the idle share
    for label in list(paths)[:5]:
        _, _, (init, apply), blks, L, _, _ = runs[label]
        n = N_EXACT_TIMED if "exact" in label else N_TIMED
        box = {"st": init(), "i": 0}

        def step():
            _, box["st"] = apply(box["st"], blks[box["i"] % N_CHAIN])
            box["i"] += 1
        wall, host = timed(step, n)
        busy, top = profiled_busy(step, 3)
        print(f"[31 {label}, 2^{L.bit_length() - 1}-sample blocks] "
              f"{L / (wall * 1e3):.1f} Msamples/s (wall {wall:.4f} ms a "
              f"block over {n}), host {host:.4f} ms a block, device busy "
              f"{busy:.4f} ms, idle {max(0.0, 1 - busy / wall):.0%}; largest "
              f"kernels: {top} | {smi}", flush=True)
    a = agc_ops.AGC(torch.float32, method="parallel", device=dev)
    a.squelch_enable()
    a.squelch_set_threshold(SQ_THRESHOLD)
    a.squelch_set_timeout(SQ_TIMEOUT)
    turn = iter(range(1 << 30))

    def step_d():
        a.execute_block(sq_blocks[next(turn) % N_CHAIN])
    wall, host = timed(step_d, N_TIMED)
    busy, top = profiled_busy(step_d, 3)
    print(f"[31 d AGC(parallel), squelch on, float32, 2^16-sample blocks] "
          f"{T_SCAN / (wall * 1e3):.1f} Msamples/s (wall {wall:.4f} ms a "
          f"block over {N_TIMED}), host {host:.4f} ms a block, device busy "
          f"{busy:.4f} ms (with the sequential FSM kernel "
          f"{SEQUENTIAL_D_BUSY_MS} ms), idle {max(0.0, 1 - busy / wall):.0%};"
          f" largest kernels: {top} | {smi}", flush=True)

    entries = []
    for name, launches, err, ms, plain, bnd in (
            ("agc_scan", s1_launches, s1_err, s1_ms,
             s1_plain_ms, b1),
            ("squelch_fsm", fsm_launches, fsm_err, fsm_ms, fsm_plain_ms, b3),
            ("costas_pll", s2_launches, s2_err, s2_ms, s2_plain_ms, b2)):
        entries.append(kernel_entry(
            name, "seq_scan.cu",
            {"agc_scan": "solid_dsp_tpu/ops/agc.py:108 (a lax.scan, no TPU "
                         "kernel)",
             "squelch_fsm": "solid_dsp_tpu/ops/agc.py:343 (a lax.scan, no "
                            "TPU kernel)",
             "costas_pll": "solid_dsp_tpu/models/qpsk.py:101 (a lax.scan, "
                           "no TPU kernel)"}[name],
            launches, err, ms, plain, bnd))
    entries[1]["at_one_lane_2^22"] = {
        "ms": fsm22_ms, "plain_ms": chunked_ms, "bound_ms": b22[0],
        "max_abs_err": 0}
    return entries


def one_pole_gain(f: float, tau: float, fs: float) -> float:
    """|H| of the one-pole de-emphasis a / (1 - (1 - a) e^{-j 2 pi f / fs}),
    a = 1 - e^{-1 / (tau fs)}, at f Hz."""
    a = 1.0 - np.exp(-1.0 / (tau * fs))
    return float(abs(a / (1.0 - (1.0 - a) * np.exp(-2j * np.pi * f / fs))))


def tone_power(x: np.ndarray, f: float, fs: float, edge: int) -> float:
    """|mean(x e^{-j 2 pi f n / fs})|^2 past ``edge`` samples at each end:
    (A / 2)^2 for a real tone of amplitude A."""
    n = np.arange(len(x))[edge:len(x) - edge]
    return float(np.abs(np.mean(x[edge:len(x) - edge]
                                * np.exp(-2j * np.pi * f / fs * n))) ** 2)


def rate_line(label, fn, n, L, smi) -> str:
    """One throughput line: Msamples/s of input by CUDA events over n calls,
    host enqueue, the profiler's device busy time and the idle share.  The
    profiler records ~100 ms of calls (1 to 10): it drops the first
    records after it starts, so a single short call can show none."""
    wall, host = timed(fn, n)
    busy, top = profiled_busy(fn, max(1, min(10, int(100.0 / wall))))
    return (f"[{label}] {L / (wall * 1e3):.1f} Msamples/s (wall {wall:.4f} "
            f"ms a block over {n}), host {host:.4f} ms a block, device busy "
            f"{busy:.4f} ms, idle {max(0.0, 1 - busy / wall):.0%}; largest "
            f"kernels: {top} | {smi}")


def iir_phases(dev, smi) -> list:
    """Phases 32-34: S3 against its plain version, the IIR layer, the
    decimators and resamplers, the FM stereo back end and the DDC.  Returns
    S3's kernels entry."""
    import scipy.signal as sps

    from solid_dsp_tpu_torch.design import iirdes
    from solid_dsp_tpu_torch.models import ddc as ddc_models
    from solid_dsp_tpu_torch.models import fm as fm_models
    from solid_dsp_tpu_torch.ops import (autocorr, cic, cuda_scan, halfband,
                                         linrec)
    from solid_dsp_tpu_torch.ops import iir as iir_ops
    from solid_dsp_tpu_torch.ops import resample, zerophase

    rng = np.random.default_rng(SEED + 32)
    s3 = cuda_scan.iir_scan_cuda
    cascade = cuda_scan.sos_cascade_cuda
    C64, C128 = torch.complex64, torch.complex128

    def on(a, dt=None):
        return torch.from_numpy(np.asarray(a)).to(dev, dt)

    # 32 (i). S3 (the chunk-and-join kernel) against its plain version
    # iir_chunked_torch on the card (32-bit bit-equal or within S3_RTOL
    # max|w|, 64-bit S3_F64_RTOL, times g / 16 for a filter of transient
    # gain g above 16) and against the sequential walk
    # iir_scan_torch (64-bit within S3_WALK_RTOL max|w|, 32-bit >= 90 dB
    # against the float64 walk, or within 3 dB of the walk where that keeps
    # less): T = 2^12 as two blocks with the history carried, k = 1, 2, 8,
    # every type, 1 and 256 lanes
    results = []
    wide_of = {torch.float32: torch.float64, torch.float64: torch.float64,
               C64: C128, C128: C128}

    def db(got, ref):
        den = float(((got.to(ref.dtype) - ref).abs() ** 2).sum())
        return float("inf") if den == 0 else 10 * np.log10(
            float((ref.abs() ** 2).sum()) / den)
    for dt in (torch.float32, torch.float64, C64, C128):
        for k in (1, 2, 8):
            for lanes in ((), (S3_LANES,)):
                # stable: poles at radius 0.9 (real ones for a real type)
                z = np.exp(2j * np.pi * rng.random(k))
                a = np.poly(0.9 * (z if dt.is_complex else z.real))[1:]
                x = rng.standard_normal((T_S3, *lanes))
                h0 = rng.standard_normal((*lanes, k))
                if dt.is_complex:
                    x = x + 1j * rng.standard_normal(x.shape)
                a, x, h0 = on(a, dt), on(x, dt), on(h0, dt)
                h = T_S3 // 2
                w1, g1 = s3(a, h0, x[:h])
                w2, g2 = s3(a, g1, x[h:])
                p1, q1 = iir_ops.iir_chunked_torch(a, h0, x[:h])
                p2, q2 = iir_ops.iir_chunked_torch(a, q1, x[h:])
                wk, wp = torch.cat([w1, w2]), torch.cat([p1, p2])
                wide = wide_of[dt]
                wt, gt = iir_ops.iir_scan_torch(a.to(wide), h0.to(wide),
                                                x.to(wide))
                err = max(float((wk - wp).abs().max() / wp.abs().max()),
                          float((g2 - q2).abs().max() / q2.abs().max()))
                # a filter of transient gain g > 16 amplifies a start moved
                # by an ulp up to g times in its chunk's walk
                gain = max(1.0, linrec.transient_gain(linrec.companion(
                    a.to(wide).cpu().numpy())) / 16)
                if wide == dt:
                    walk = float((wk - wt).abs().max() / wt.abs().max())
                    good = (err <= S3_F64_RTOL * gain
                            and walk <= S3_WALK_RTOL)
                else:
                    # w and the state as one vector against the float64
                    # walk, beside the walk in the working type
                    def vec(w, h):
                        return torch.cat([w.reshape(-1), h.reshape(-1)])
                    truth = vec(wt, gt)
                    walk = db(vec(wk, g2), truth)
                    good = (err <= S3_RTOL * gain and walk >= min(
                        90.0, db(vec(*iir_ops.iir_scan_torch(a, h0, x)),
                                 truth) - 3.0))
                results.append((str(dt).replace("torch.", ""), k,
                                lanes[0] if lanes else 1, good, err,
                                torch.equal(wk, wp) and torch.equal(g2, q2),
                                walk, float((wk - wp).abs().max())))
    s3_good = all(r[3] for r in results)
    db32 = min(r[6] for r in results if r[0] in ("float32", "complex64"))
    rel64 = max(r[6] for r in results if r[0] in ("float64", "complex128"))
    print(f"[32 S3 vs plain, T=2^12 as two blocks with the history carried, "
          f"k=1/2/8, float32/float64/complex64/complex128, 1 and "
          f"{S3_LANES} lanes] all {len(results)} within the gates "
          f"{s3_good}; bit-equal to iir_chunked_torch in "
          f"{sum(r[5] for r in results)}, worst rel err "
          f"{max(r[4] for r in results):.3g} (gates {S3_RTOL} / "
          f"{S3_F64_RTOL}); against the walk: 32-bit {db32:.1f} dB, 64-bit "
          f"rel err {rel64:.3g} (gate {S3_WALK_RTOL}); outside: "
          f"{[r[:3] for r in results if not r[3]]}", flush=True)
    if not s3_good:
        fail("phase 32: S3 disagrees with its plain version")

    # 32 (ii). The risky pole (tests/test_iir.py:210-223): radius 0.9999,
    # b = [0.01, 0, 0], float32 IIRFilter under "auto" -> "scan" (S3);
    # truth S3 in float64, cross-checked against scipy's lfilter
    a_r = np.array([1.0, -2 * 0.9999 * np.cos(0.3), 0.9999 ** 2])
    b_r = np.array([0.01, 0.0, 0.0])
    xr = rng.standard_normal(T_RISKY)
    truth, _ = iir_ops.iir_apply(on(b_r), on(a_r[1:]),
                                 torch.zeros(2, dtype=torch.float64,
                                             device=dev), on(xr), "scan")
    truth = truth.cpu().numpy()
    snr_lf = snr_db(truth, sps.lfilter(b_r, a_r, xr))
    s3.launches = cascade.launches = 0
    fr = iir_ops.IIRFilter(list(b_r), list(a_r), dtype=torch.float32,
                           device=dev)
    yr = fr.execute_block(on(xr, torch.float32))
    torch.cuda.synchronize()
    risky_launches = s3.launches
    snr_r = snr_db(yr.cpu().numpy(), truth)
    # pll_active_lag(0.02, 1/sqrt(2), 1000) as a float32 SECOND_ORDER
    # filter (a pole at |z| = 1): S3 on the card against the same filter on
    # the CPU (the plain version), two blocks
    num, den = iirdes.pll_active_lag(0.02, 1.0 / np.sqrt(2.0), 1000.0)
    xp = rng.standard_normal(T_PLL).astype(np.float32)
    fk = iir_ops.IIRFilter(num, den, iir_ops.IIRFilterType.SECOND_ORDER,
                           torch.float32, device=dev)
    fc = iir_ops.IIRFilter(num, den, iir_ops.IIRFilterType.SECOND_ORDER,
                           torch.float32, device="cpu")
    yk = torch.cat([fk.execute_block(on(b)) for b in np.split(xp, 2)])
    torch.cuda.synchronize()
    pll_launches = cascade.launches
    yc = torch.cat([fc.execute_block(torch.from_numpy(b))
                    for b in np.split(xp, 2)])
    # the float64 cascade of the same float32 coefficients, on the CPU
    secs = fc.second_order_filters()
    y64, _ = iir_ops.sos_cascade_apply(
        torch.stack([sec._b for sec in secs]).double(),
        torch.stack([sec._a_tail for sec in secs]).double(),
        torch.zeros((len(secs), 2), dtype=torch.float64),
        torch.from_numpy(xp.astype(np.float64)), "scan")
    pll_db, pll_cpu_db = snr_db(yk.cpu().numpy(), y64.numpy()), snr_db(
        yc.numpy(), y64.numpy())
    pll_methods = [sec.method for sec in fk.second_order_filters()]
    print(f"[32 risky pole r=0.9999, T=2^20, IIRFilter float32 auto] method "
          f"{fr.method}, S3 launches {risky_launches}, {snr_r:.1f} dB against "
          f"float64 S3 (gate {RISKY_MIN_SNR_DB}); float64 S3 against scipy "
          f"lfilter {snr_lf:.1f} dB (gate {LFILTER_MIN_SNR_DB}); "
          f"pll_active_lag(0.02) float32 SECOND_ORDER (poles at 1 and "
          f"1 - 1.6e-6): methods {pll_methods}, fused cascade launches "
          f"{pll_launches}, {pll_db:.1f} dB against the float64 cascade of "
          f"its float32 coefficients, its "
          f"float32 CPU run (one sequential walk a section) {pll_cpu_db:.1f} "
          f"dB (gate: >= {PLL_MIN_SNR_DB} dB and no less than the CPU run)",
          flush=True)
    if not (fr.method == "scan" and risky_launches == 1
            and snr_r >= RISKY_MIN_SNR_DB and snr_lf >= LFILTER_MIN_SNR_DB
            and pll_methods == ["scan"] and pll_launches == 2
            and pll_db >= PLL_MIN_SNR_DB and pll_db >= pll_cpu_db):
        fail("phase 32: the risky-pole or PLL filter is wrong")
    s3_main, cascade_main = risky_launches, pll_launches

    # 32 (iii). The elliptic cascade (8th order, 4 sections) on complex64
    # 2^22-sample blocks by "scan" and by "parallel" (on the card both are
    # one pipeline of the fused cascade a block), against its plain version
    # and the float64 cascade; S3 over (2^16, 256) lanes and one lane at
    # 2^22, and the cascade kernel, timed beside their plain versions
    sos8 = iirdes.iirdes_sos("elliptic", 8, 0.05)
    ff, fb = iirdes.sos_to_iir_coeffs(sos8)
    xe = on(cnoise(rng, L_IIR))
    outs = {}
    for m in ("scan", "parallel"):
        f = iir_ops.IIRFilter(ff, fb, iir_ops.IIRFilterType.SECOND_ORDER,
                              C64, method=m, device=dev)
        before = cascade.launches
        outs[m] = f.execute_block(xe).cpu().numpy()
        cascade_main += cascade.launches - before
        print(rate_line(f"32 elliptic-8 IIRFilter(SECOND_ORDER, complex64) "
                        f"method {m}, 2^22-sample blocks",
                        lambda f=f: f.execute_block(xe), 2, L_IIR, smi),
              flush=True)
    sb8 = on(sos8[:, :3], torch.float32)
    sa8 = on(sos8[:, 4:], torch.float32)
    s8 = torch.zeros((4, 2), dtype=C64, device=dev)
    yc, _ = cascade(sb8, sa8, s8, xe)
    box = {}

    def cascade_plain():
        box["y"] = iir_ops.sos_cascade_chunked_torch(sb8, sa8, s8, xe)
    casc_plain_ms = cuda_ms_once(cascade_plain)
    casc_err = float((yc - box["y"][0]).abs().max())
    casc_rel = casc_err / float(box["y"][0].abs().max())
    y64, _ = iir_ops.sos_cascade_apply(sb8.double().cpu(), sa8.double().cpu(),
                                       s8.to(C128).cpu(),
                                       xe[:L_CASC_F64].to(C128).cpu(), "scan")
    snr_c64 = snr_db(yc[:L_CASC_F64].cpu().numpy(), y64.numpy())
    casc_ms = graph_ms(lambda: cascade(sb8, sa8, s8, xe), 5)
    n_c = 2 * L_IIR
    # bytes: each sample read and written once (8 + 8), the state and the
    # coefficients; operations: 9 FLOPs a section a real lane a row
    b_casc = bound_ms(16 * L_IIR + 2 * 8 * 8 + 20 * 4, 9 * 4 * n_c,
                      FP32_FLOPS)
    print(f"[32 elliptic-8, scan against parallel on the first block] "
          f"{snr_db(outs['parallel'], outs['scan']):.1f} dB (both the fused "
          f"cascade: equal {np.array_equal(outs['parallel'], outs['scan'])});"
          f" the cascade kernel against its plain version "
          f"sos_cascade_chunked_torch: max|dy| {casc_err:.3g} "
          f"({casc_rel:.3g} x max|y|, gate {S3_RTOL}), against the float64 "
          f"per-section cascade (first {L_CASC_F64} samples, on the CPU) "
          f"{snr_c64:.1f} dB (gate {CASCADE_MIN_SNR_DB}); kernel (CUDA graph "
          f"of 5) {casc_ms:.4f} ms a 2^22 block, bound {b_casc[0]:.5f} ms "
          f"({b_casc[1]}), plain {casc_plain_ms:.1f} ms | {smi}", flush=True)
    if not (casc_rel <= S3_RTOL and snr_c64 >= CASCADE_MIN_SNR_DB
            and np.array_equal(outs["parallel"], outs["scan"])):
        fail("phase 32: the fused cascade disagrees")
    a2 = on(sos8[0, 4:], C64)
    xl = on(cnoise(rng, (T_S3_LANES, S3_LANES)))
    hl = torch.zeros((S3_LANES, 2), dtype=C64, device=dev)
    s3_ms = graph_ms(lambda: s3(a2, hl, xl), 5)
    s3_one = graph_ms(lambda: s3(a2, hl[0], xe), 5)

    def s3_plain():
        box["w"] = iir_ops.iir_chunked_torch(a2, hl, xl)
    s3_plain_ms = cuda_ms_once(s3_plain)
    wk, _ = s3(a2, hl, xl)
    s3_err = float((wk - box["w"][0]).abs().max())
    s3_rel = s3_err / float(box["w"][0].abs().max())
    n_s3 = T_S3_LANES * S3_LANES
    # bytes: each sample read and written once (8 + 8), the history in and
    # out, the coefficients; operations: a complex multiply-add a tap
    b_s3 = bound_ms(16 * n_s3 + 2 * 16 * S3_LANES + 16, 8 * 2 * n_s3,
                    FP32_FLOPS)
    b_one = bound_ms(16 * L_IIR + 2 * 16 + 16, 8 * 2 * L_IIR, FP32_FLOPS)
    print(f"[32 S3 times, complex64, k=2] ({T_S3_LANES}, {S3_LANES}) lanes: "
          f"{s3_ms:.4f} ms (CUDA graph of 5), {s3_ms * 1e3 / T_S3_LANES:.4f} "
          f"us a step of all lanes, {s3_ms * 1e3 / n_s3:.6f} us a sample, "
          f"bound {b_s3[0]:.5f} ms ({b_s3[1]}), plain iir_chunked_torch "
          f"{s3_plain_ms:.1f} ms, max|dw| {s3_err:.3g} ({s3_rel:.3g} x "
          f"max|w|, gate {S3_RTOL}); one lane at 2^22: {s3_one:.4f} ms, "
          f"{s3_one * 1e6 / L_IIR:.4f} ns a sample, bound {b_one[0]:.5f} ms "
          f"| {smi}", flush=True)
    if not s3_rel <= S3_RTOL:
        fail("phase 32: S3 disagrees with its plain version at (2^16, 256)")

    # 33. Decimators and resamplers at the TPU sweep's sizes, complex64
    # against their own complex128 run on the card, two blocks each
    paths = (
        ("CICDecimator(8, 4)", lambda dt: cic.CICDecimator(
            8, 4, dtype=dt, device=dev), L_RS, "fir", "tests/test_cic.py:32-52"),
        ("HalfbandDecimator(8)", lambda dt: halfband.HalfbandDecimator(
            8, dtype=dt, device=dev), L_RS, "fir",
         "tests/test_halfband.py:136-158"),
        ("MultistageDecimator(16)", lambda dt: halfband.MultistageDecimator(
            16, dtype=dt, device=dev), L_RS, "fir",
         "tests/test_halfband.py:168-216"),
        ("HalfbandInterpolator(8)", lambda dt: resample.HalfbandInterpolator(
            8, dtype=dt, device=dev), L_RS_UP, "fir",
         "tests/test_resample.py:33-58"),
        ("CICInterpolator(8, 4)", lambda dt: cic.CICInterpolator(
            8, 4, dtype=dt, device=dev), L_RS_UP, "fir",
         "tests/test_cic.py:55-79"),
        ("ArbitraryResampler(0.37, block_len=2^22)",
         lambda dt: resample.ArbitraryResampler(0.37, dtype=dt,
                                                block_len=L_RS, device=dev),
         L_RS, "grid", "tests/test_resample.py:307-336"),
        ("ArbitraryResampler(2.5, block_len=2^21)",
         lambda dt: resample.ArbitraryResampler(2.5, dtype=dt,
                                                block_len=L_RS_UP,
                                                device=dev),
         L_RS_UP, "grid", "tests/test_resample.py:307-336"),
        ("ArbitraryResampler(0.37), host-anchored",
         lambda dt: resample.ArbitraryResampler(0.37, dtype=dt, device=dev),
         L_RS, "legacy", "tests/test_resample.py:171-174"),
        ("ArbitraryResampler(2.5), host-anchored",
         lambda dt: resample.ArbitraryResampler(2.5, dtype=dt, device=dev),
         L_RS_UP, "legacy", "tests/test_resample.py:171-174"),
    )
    ok33 = True
    for label, make, L, kind, test in paths:
        x2 = cnoise(rng, 2 * L)
        r64, r128 = make(C64), make(C128)
        y64 = torch.cat([r64.execute_block(on(b)) for b in np.split(x2, 2)])
        y128 = torch.cat([r128.execute_block(on(b, C128))
                          for b in np.split(x2, 2)])
        y64, y128 = y64.cpu().numpy(), y128.cpu().numpy()
        if kind == "fir":
            err = float(np.abs(y64 - y128).max() / np.abs(y128).max())
            good, gate = err <= FIR_C64_RTOL, (f"max|dy| {err:.3g} x max|y| "
                                               f"(gate {FIR_C64_RTOL})")
        elif kind == "grid":
            err = float(np.abs(y64 - y128).max())
            good, gate = err <= GRID_ATOL, (f"max|dy| {err:.3g} (gate "
                                            f"{GRID_ATOL})")
        else:
            err = snr_db(y64, y128)
            good, gate = err >= LEGACY_MIN_SNR_DB, (f"{err:.1f} dB (gate "
                                                    f"{LEGACY_MIN_SNR_DB})")
        good = good and y64.shape == y128.shape and bool(
            np.all(np.isfinite(y64)))
        ok33 = ok33 and good
        xb = on(x2[:L])
        print(f"[33 {label}, 2 x {L} complex64 vs its complex128 run] {gate}"
              f", {test}; outputs {y64.shape[-1]}", flush=True)
        print(rate_line(f"33 {label}", lambda r=r64: r.execute_block(xb), 3,
                        L, smi), flush=True)
    # F1: flush() in block_len mode drains the tail with whole zero blocks
    xt = (np.exp(2j * np.pi * 0.003 * np.arange(2 * L_RS))
          ).astype(np.complex64)
    rf = resample.ArbitraryResampler(0.37, block_len=L_RS, device=dev)
    yf = torch.cat([rf.execute_block(on(b)) for b in np.split(xt, 2)])
    tail = rf.flush().cpu().numpy()
    total = yf.shape[-1] + len(tail)
    f1_ok = (rf._grid is not None and total >= round(2 * L_RS * 0.37)
             and np.abs(tail[:max(1, len(tail) // 4)]).max() > 0.1
             and len(resample.ArbitraryResampler(1.0, block_len=L_RS,
                                                 device=dev).flush()) == 0)
    print(f"[33 F1 ArbitraryResampler(0.37, block_len=2^22).flush()] "
          f"{len(tail)} samples drained, {total} outputs for "
          f"{2 * L_RS} inputs (want >= {round(2 * L_RS * 0.37)}), the tail's "
          f"first quarter peaks at {np.abs(tail[:len(tail) // 4]).max():.3f} "
          f"(gate 0.1, tests/test_resample.py:186-202), identity flush "
          f"empty: {f1_ok}", flush=True)
    if not (ok33 and f1_ok):
        fail("phase 33: a decimator or resampler is wrong")

    # 34 (a). The stereo chain at fs = 192 kHz, 2^22 samples: L 1 kHz, R
    # 2.5 kHz through the multiplex and the decoder, without and with the
    # 75 us de-emphasis
    k = np.arange(L_STEREO)
    lt = on(np.sin(2 * np.pi * 1000 / FS_STEREO * k), torch.float32)
    rt = on(np.sin(2 * np.pi * 2500 / FS_STEREO * k), torch.float32)
    mpx = fm_models.fm_stereo_mpx(lt, rt, FS_STEREO)
    ok34 = True
    dec = {}
    for tau in (0.0, 75e-6):
        before = s3.launches
        l_o, r_o, pilot = fm_models.fm_stereo_decode(mpx, FS_STEREO,
                                                     deemphasis_tau=tau)
        torch.cuda.synchronize()
        s3_main += s3.launches - before
        ok34 = ok34 and s3.launches - before == (2 if tau else 0)
        dec[tau] = l_o
        l_o = l_o.cpu().numpy().astype(np.float64)
        r_o = r_o.cpu().numpy().astype(np.float64)
        g1 = one_pole_gain(1000, tau, FS_STEREO) if tau else 1.0
        g2 = one_pole_gain(2500, tau, FS_STEREO) if tau else 1.0
        p_l, p_r = (tone_power(l_o, 1000, FS_STEREO, 2000),
                    tone_power(r_o, 2500, FS_STEREO, 2000))
        sep_l = 10 * np.log10(p_l / tone_power(l_o, 2500, FS_STEREO, 2000))
        sep_r = 10 * np.log10(p_r / tone_power(r_o, 1000, FS_STEREO, 2000))
        good = (abs(float(pilot) - 0.1) < PILOT_ATOL
                and abs(p_l - 0.25 * g1 ** 2) < TONE_POW_ATOL
                and abs(p_r - 0.25 * g2 ** 2) < TONE_POW_ATOL
                and min(sep_l, sep_r) > SEPARATION_MIN_DB)
        ok34 = ok34 and good
        print(f"[34 stereo decode, fs 192 kHz, 2^22, de-emphasis "
              f"{tau * 1e6:g} us] pilot {float(pilot):.5f} (0.1 +- "
              f"{PILOT_ATOL}), tone powers L {p_l:.5f} R {p_r:.5f} (want "
              f"{0.25 * g1 ** 2:.5f} / {0.25 * g2 ** 2:.5f} +- "
              f"{TONE_POW_ATOL}), separation {sep_l:.1f} / {sep_r:.1f} dB "
              f"(gate {SEPARATION_MIN_DB}; tests/test_models.py:426-471)",
              flush=True)
    print(rate_line("34 fm_stereo_decode(deemphasis 75 us), 2^22 MPX samples",
                    lambda: fm_models.fm_stereo_decode(
                        mpx, FS_STEREO, deemphasis_tau=75e-6), 3, L_STEREO,
                    smi), flush=True)
    names = kernel_names(lambda: fm_models.fm_stereo_decode(
        mpx, FS_STEREO, deemphasis_tau=75e-6))
    gemms = [k for k in names if "gemm" in k.lower()]
    ok34 = ok34 and not gemms and any("chunk" in k for k in names)
    print(f"[34 fm_stereo_decode's kernels (profiler, one call)] "
          f"{len(names)} kernels, cuBLAS gemms {gemms} (want none), S3's "
          f"{[k[:40] for k in names if 'chunk' in k or 'group_starts' in k]}",
          flush=True)

    # 34 (b). The CLI's audio tail on the decoded left rail: resample to
    # 48 kHz (execute_block + flush), then the one-pole de-emphasis at the
    # audio rate through iir_apply
    def audio_tail():
        r = resample.ArbitraryResampler(48000 / FS_STEREO, dtype=C64,
                                        device=dev)
        a = torch.cat([r.execute_block(dec[75e-6].to(C64)), r.flush()])
        alpha = float(np.exp(-1.0 / (75e-6 * 48000)))
        return iir_ops.iir_apply(
            torch.tensor([1.0 - alpha], dtype=C64, device=dev),
            torch.tensor([-alpha], dtype=C64, device=dev),
            iir_ops.iir_init(1, device=dev), a)[0]
    au = audio_tail().cpu().numpy()
    want_p = 0.25 * (one_pole_gain(1000, 75e-6, FS_STEREO)
                     * one_pole_gain(1000, 75e-6, 48000)) ** 2
    p_au = tone_power(au.real, 1000, 48000, 1000)
    good = (len(au) >= round(L_STEREO / 4) and bool(np.all(np.isfinite(au)))
            and abs(p_au - want_p) < TONE_POW_ATOL)
    ok34 = ok34 and good
    print(f"[34 the CLI's audio tail: ArbitraryResampler(48000/192000) + "
          f"flush, one-pole de-emphasis by iir_apply] {len(au)} samples (want "
          f">= {round(L_STEREO / 4)}), the 1 kHz tone's power {p_au:.5f} "
          f"(want {want_p:.5f} +- {TONE_POW_ATOL})", flush=True)
    print(rate_line("34 the CLI's audio tail, 2^22 samples at 192 kHz",
                    audio_tail, 3, L_STEREO, smi), flush=True)

    # 34 (c). DDC(0.7, 8, 4, 2, 48000/44100) on two complex64 2^22-sample
    # blocks of a tone 0.0015 cycles/sample above the carrier, against its
    # complex128 run (tests/test_ddc.py:41-55)
    fc_ddc, delta = 0.7, 0.0015
    kk = np.arange(2 * L_RS)
    xd = np.exp(1j * (fc_ddc * kk + 2 * np.pi * delta * kk))
    ddcs = {dt: ddc_models.DDC(fc_ddc, cic_rate=8, cic_stages=4, fir_decim=2,
                               ratio=48000 / 44100, dtype=dt, device=dev)
            for dt in (C64, C128)}
    yd = {dt: torch.cat([d.execute_block(on(b, dt))
                         for b in np.split(xd, 2)]).cpu().numpy()
          for dt, d in ddcs.items()}
    snr_d = snr_db(yd[C64], yd[C128])
    steady = yd[C64][len(yd[C64]) // 2:]
    f_meas = float(np.mean(np.diff(np.unwrap(np.angle(steady))))
                   / (2 * np.pi))
    f_want = delta * ddcs[C64].decimation
    good = (snr_d >= DDC_MIN_SNR_DB and abs(f_meas - f_want) < DDC_F_ATOL
            and bool(np.all(np.isfinite(yd[C64]))))
    ok34 = ok34 and good
    print(f"[34 DDC(0.7, 8, 4, 2, 48000/44100), 2 x 2^22 complex64] "
          f"{len(yd[C64])} outputs, {snr_d:.1f} dB against complex128 (gate "
          f"{DDC_MIN_SNR_DB}), tone {f_meas:.7f} want {f_want:.7f} (gate "
          f"{DDC_F_ATOL})", flush=True)
    xd0 = on(xd[:L_RS], C64)
    print(rate_line("34 DDC complex64, 2^22-sample blocks",
                    lambda: ddcs[C64].execute_block(xd0), 3, L_RS, smi),
          flush=True)

    # 34 (d). filtfilt_sos, the elliptic cascade (4 sections) at 2^20 in
    # float64 by "scan" (the fused cascade, once a pass) against scipy's
    # sosfiltfilt
    sos = iirdes.iirdes_sos("elliptic", 8, 0.05)
    xs = rng.standard_normal(L_FILTFILT)
    pad = FILTFILT_PAD
    before = cascade.launches
    yff = zerophase.filtfilt_sos(sos[:, :3], sos[:, 3:], on(xs), pad=pad,
                                 method="scan")
    torch.cuda.synchronize()
    ff_launches = cascade.launches - before
    cascade_main += ff_launches
    yff = yff.cpu().numpy()
    ref = sps.sosfiltfilt(sos, xs, padtype="odd", padlen=pad)
    e_in = float(np.abs(yff - ref)[2 * pad:-2 * pad].max())
    e_all = float(np.abs(yff - ref).max())
    good = (ff_launches == 2 and e_in <= FILTFILT_ATOL
            and e_all <= FILTFILT_EDGE_ATOL)
    ok34 = ok34 and good
    print(f"[34 filtfilt_sos elliptic-8, float64, 2^20, method scan] fused "
          f"cascade launches {ff_launches} (want 2), interior max|dy| "
          f"{e_in:.3g} (gate {FILTFILT_ATOL}), whole {e_all:.3g} (gate "
          f"{FILTFILT_EDGE_ATOL}) against scipy sosfiltfilt "
          f"(tests/test_zerophase.py:22-42)", flush=True)
    sb, sa = on(sos[:, :3], torch.float32), on(sos[:, 3:], torch.float32)
    xs32 = on(xs, torch.float32)
    for m in ("scan", "parallel"):
        print(rate_line(f"34 filtfilt_sos elliptic-8, float32, 2^20, method "
                        f"{m}", lambda m=m: zerophase.filtfilt_sos(
                            sb, sa, xs32, pad=pad, method=m), 2, L_FILTFILT,
                        smi), flush=True)

    # 34 (e). AutoCorrelator(64, 16) on two 2^22-sample blocks, complex64
    # against its complex128 run (tests/test_autocorr.py: 1e-10 at
    # complex128)
    xa = cnoise(rng, 2 * L_RS)
    acs = {dt: autocorr.AutoCorrelator(AC_W, AC_D, dtype=dt, device=dev)
           for dt in (C64, C128)}
    ya = {dt: torch.cat([a.execute_block(on(b, dt))
                         for b in np.split(xa, 2)]).cpu().numpy()
          for dt, a in acs.items()}
    e_ac = float(np.abs(ya[C64] - ya[C128]).max() / np.abs(ya[C128]).max())
    e_en = abs(acs[C64].get_energy() / acs[C128].get_energy() - 1.0)
    good = e_ac <= FIR_C64_RTOL and e_en <= FIR_C64_RTOL
    ok34 = ok34 and good
    print(f"[34 AutoCorrelator({AC_W}, {AC_D}), 2 x 2^22 complex64 vs "
          f"complex128] max|dy| {e_ac:.3g} x max|y|, energy rel err "
          f"{e_en:.3g} (gate {FIR_C64_RTOL})", flush=True)
    xa0 = on(xa[:L_RS])
    print(rate_line(f"34 AutoCorrelator({AC_W}, {AC_D}), complex64, "
                    f"2^22-sample blocks",
                    lambda: acs[C64].execute_block(xa0), 3, L_RS, smi),
          flush=True)
    print(f"[34 S3 launches on the paths of phases 32-34] {s3_main} (risky "
          f"pole 1, the stereo de-emphasis 2); the fused cascade's "
          f"{cascade_main} (PLL 2, elliptic-8 2, filtfilt_sos "
          f"{ff_launches})", flush=True)
    if not ok34:
        fail("phase 34: the FM back end, the DDC, filtfilt or the "
             "autocorrelator is wrong")

    entry = kernel_entry(
        "iir_scan", "iir_scan.cu",
        "solid_dsp_tpu/ops/iir.py:117 _w_recurrence_scan and :129 "
        "_w_recurrence_parallel (a lax.scan and an associative scan, no TPU "
        "kernel)", s3_main, s3_err, s3_ms, s3_plain_ms, b_s3)
    entry["us_a_sample"] = s3_ms * 1e3 / n_s3
    entry["one_lane_2p22_ms"] = s3_one
    casc = kernel_entry(
        "sos_cascade", "iir_scan.cu",
        "solid_dsp_tpu/ops/iir.py:219 sos_cascade_apply (one recurrence a "
        "section, no TPU kernel)", cascade_main, casc_err, casc_ms,
        casc_plain_ms, b_casc)
    return [entry, casc]


def fast_phases(dev, smi, x3_ms: dict) -> list:
    """35-36: K1-K3's "fast" mode (fir_precision="default") against its
    plain versions, then the config-4 chains at "default".  ``x3_ms``: the
    x3 kernels' times of phases 3 and 7, printed beside.  Returns the
    kernels' entries of the three fast modes."""
    from solid_dsp_tpu_torch.models.rx_chain import RxChainConfig, make_rx_chain
    from solid_dsp_tpu_torch.ops import cuda_ddc
    from solid_dsp_tpu_torch.ops.nco import constrain

    cfg = RxChainConfig(carrier_freq=0.2, decimation=4, fir_taps=64,
                        agc_mode="block", demod="fm", nco_mode="exact",
                        input_format="planar", fused_ddc="on",
                        fir_precision="default")
    taps = cfg.design_taps()
    dtheta = constrain(cfg.carrier_freq)
    M, n = cfg.decimation, cfg.fir_taps
    D = n - M
    rng = np.random.default_rng(SEED + 35)
    fm = cuda_ddc.make_ddc_fm(taps, dtheta, M, cfg.fm_kf, dev, mode="fast")
    body = cuda_ddc.make_ddc_body(taps, dtheta, M, dev, mode="fast")
    fm64 = cuda_ddc.make_ddc_fm(taps, dtheta, M, cfg.fm_kf, "cpu",
                                torch.float64)
    body64 = cuda_ddc.make_ddc_body(taps, dtheta, M, "cpu", torch.float64)
    tail = torch.from_numpy(
        (0.1 * rng.standard_normal((2, D))).astype(np.float32)).to(dev)
    tail64 = tail.cpu().double()
    x1 = make_block(rng, 0, L_F64)
    x1_dev, x1_64 = torch.from_numpy(x1).to(dev), torch.from_numpy(x1).double()
    stats = {}

    # 35. K1 fast vs its plain version on the card, and vs float64
    x = torch.from_numpy(make_block(rng, 0, L_FULL)).to(dev)
    ak, sk = cuda_ddc.ddc_fm_cuda(fm, x, tail)
    ak2, sk2 = cuda_ddc.ddc_fm_cuda(fm, x, tail)
    ap, sp = cuda_ddc.ddc_fm_torch(fm, x, tail)
    torch.cuda.synchronize()
    same = torch.equal(ak, ak2) and torch.equal(sk, sk2)
    ak, sk, ap, sp = (t.cpu().numpy() for t in (ak, sk, ap, sp))
    snr = snr_db(ak, ap)
    err_e = abs(float(sk[0]) - float(sp[0])) / abs(float(sp[0]))
    err_z = float(np.max(np.abs(sk[1:] - sp[1:])))
    max_abs = float(np.max(np.abs(ak - ap)))
    a1, s1 = cuda_ddc.ddc_fm_cuda(fm, x1_dev, tail)
    a64, s64 = cuda_ddc.ddc_fm_torch(fm64, x1_64, tail64)
    snr64 = snr_db(a1.cpu().numpy(), a64.numpy())
    err64 = abs(float(s1[0]) - float(s64[0])) / float(s64[0])
    k_ms = graph_ms(lambda: cuda_ddc.ddc_fm_cuda(fm, x, tail), 20)
    p_ms = cuda_ms(lambda: cuda_ddc.ddc_fm_torch(fm, x, tail), 20)
    T = L_FULL // M
    bnd = bound_ms(4 * (2 * L_FULL + 2 * D + 2 * n + T + 5), 8 * n * T,
                   BF16_FLOPS)
    stats["ddc_fm_fast"] = (max_abs, k_ms, p_ms, None, bnd)
    print(f"[35 K1 fast vs plain fast f32, L=2^24] audio {snr:.1f} dB (gate "
          f"{MIN_SNR_DB}), max |err| {max_abs:.3g}, energy rel err "
          f"{err_e:.3g} (gate {ENERGY_RTOL}), z0/zlast err {err_z:.3g} (gate "
          f"{EDGE_ATOL}), two launches bit-equal {same}; vs plain f64 (CPU) "
          f"at 2^20 audio {snr64:.1f} dB (gate {FM_FAST_F64_MIN_SNR_DB}), "
          f"energy rel err {err64:.3g} (gate {FM_FAST_ENERGY_RTOL}); route "
          f"{cuda_ddc.fm_geometry(n, M, True)}; kernel (bf16 wgmma, CUDA "
          f"graph of 20 launches) {k_ms:.4f} ms, x3 {x3_ms['ddc_fm']:.4f} "
          f"ms, bound {bnd[0]:.4f} ms ({bnd[1]}), plain {p_ms:.4f} ms | "
          f"{smi}", flush=True)
    if not (snr >= MIN_SNR_DB and err_e <= ENERGY_RTOL and err_z <= EDGE_ATOL
            and same and snr64 >= FM_FAST_F64_MIN_SNR_DB
            and err64 <= FM_FAST_ENERGY_RTOL
            and np.all(np.isfinite(ak)) and ak.shape == (T,)):
        fail("phase 35: K1 fast disagrees with its plain version")

    # 35. K2 and K3 fast vs the plain version: aligned, unaligned, short
    for route, L, kernel in (
            ("ddc_body_fast", L_FULL, cuda_ddc.ddc_body_cuda),
            ("ddc_body_unaligned_fast", L_UNALIGNED,
             cuda_ddc.ddc_body_unaligned_cuda),
            ("short", L_SHORT, cuda_ddc.ddc_body_unaligned_cuda)):
        x = torch.from_numpy(make_block(rng, 0, L)).to(dev)
        before = kernel.fast_launches
        zk = kernel(body, x, tail)
        zk2 = kernel(body, x, tail)
        zp = cuda_ddc.ddc_body_torch(body, x, tail)
        torch.cuda.synchronize()
        twice = kernel.fast_launches == before + 2
        same = torch.equal(zk, zk2)
        zk, zp = zk.cpu().numpy(), zp.cpu().numpy()
        snr = snr_db(zk, zp)
        max_abs = float(np.max(np.abs(zk - zp)))
        timing = ""
        if route != "short":
            k7 = graph_ms(lambda: kernel(body, x, tail), 20)
            p7 = cuda_ms(lambda: cuda_ddc.ddc_body_torch(body, x, tail), 20)
            # the library call: one strided conv1d on bf16 tensors, the
            # tail and the block as 2 in-channels, the folded taps as a
            # (2, 2, n) weight
            x_ext = torch.cat([tail, x], dim=1)[None].to(torch.bfloat16)
            h = body.taps
            w = torch.stack([torch.stack([h[0], -h[1]]),
                             torch.stack([h[1], h[0]])]).to(torch.bfloat16)
            zl = torch.nn.functional.conv1d(x_ext, w, stride=M)[0]
            snr_lib = snr_db(zl.float().cpu().numpy(), zp)
            l7 = graph_ms(lambda: torch.nn.functional.conv1d(x_ext, w,
                                                             stride=M), 20)
            b7 = bound_ms(4 * (2 * L + 2 * D + 2 * n + 2 * (L // M)),
                          8 * n * (L // M), BF16_FLOPS)
            x3 = x3_ms[route[:-len("_fast")]]
            stats[route] = (max_abs, k7, p7, l7, b7)
            timing = (f"; kernel (bf16 wgmma, CUDA graph of 20 launches) "
                      f"{k7:.4f} ms, x3 {x3:.4f} ms, bound {b7[0]:.4f} ms "
                      f"({b7[1]}), plain {p7:.4f} ms, library strided conv1d "
                      f"in bf16 (CUDA graph) {l7:.4f} ms ({snr_lib:.1f} dB vs "
                      f"plain)")
        print(f"[35 {route} vs plain fast f32, L={L}] z {snr:.1f} dB (gate "
              f"{BODY_FAST_MIN_SNR_DB}), max |err| {max_abs:.3g}, two "
              f"launches bit-equal {same}, counted fast {twice}{timing} | "
              f"{smi}", flush=True)
        if not (snr >= BODY_FAST_MIN_SNR_DB and same and twice
                and zk.shape == (2, L // M) and np.all(np.isfinite(zk))):
            fail(f"phase 35: the fast body kernel disagrees on {route}")
    snr64 = snr_db(cuda_ddc.ddc_body_cuda(body, x1_dev, tail).cpu().numpy(),
                   cuda_ddc.ddc_body_torch(body64, x1_64, tail64).numpy())
    print(f"[35 body fast vs plain f64 (CPU), L=2^20] z {snr64:.1f} dB (gate "
          f"{FAST_F64_MIN_SNR_DB})", flush=True)
    if not snr64 >= FAST_F64_MIN_SNR_DB:
        fail("phase 35: the fast body is not within its bf16 contract")

    # 36. the config-4 chains at "default", kernel vs plain, state carried
    fast_counters = {"ddc_fm_fast": cuda_ddc.ddc_fm_cuda,
                     "ddc_body_fast": cuda_ddc.ddc_body_cuda,
                     "ddc_body_unaligned_fast":
                         cuda_ddc.ddc_body_unaligned_cuda}
    launches = dict.fromkeys(fast_counters, 0)

    def compare(ccfg, blks, want):
        """Kernel chain vs plain chain over blks: (out_k, out_p, ok,
        kernel chain, plain chain), the fast counts at 0 just before the
        kernel chain's run and ``want`` {counter: launches} after it."""
        chain_k = make_rx_chain(ccfg, dev)
        chain_p = make_rx_chain(replace(ccfg, ddc_engine="torch"), dev)
        for c in fast_counters.values():
            c.fast_launches = 0
            c.launches = 0
        st_k, outs_k = chain_k[0](), []
        for xb in blks:
            out, st_k = chain_k[1](st_k, xb)
            outs_k.append(out)
        torch.cuda.synchronize()
        counts = {k: c.fast_launches for k, c in fast_counters.items()}
        x3_counts = sum(c.launches for c in fast_counters.values())
        for k, v in counts.items():
            launches[k] += v
        st_p, outs_p = chain_p[0](), []
        for xb in blks:
            out, st_p = chain_p[1](st_p, xb)
            outs_p.append(out)
        out_k = torch.cat(outs_k).cpu().numpy()
        out_p = torch.cat(outs_p).cpu().numpy()
        theta_want = (N_CHAIN * int(blks[0].shape[-1]) * int(dtheta)
                      ) & 0xFFFFFFFF
        ok = (int(st_k["nco_theta"]) == int(st_p["nco_theta"]) == theta_want
              and torch.equal(st_k["fir_tail"], st_p["fir_tail"])
              and counts == {**dict.fromkeys(fast_counters, 0), **want}
              and x3_counts == 0 and np.all(np.isfinite(out_k)))
        return out_k, out_p, ok, counts, chain_k, chain_p

    tone = 4 * 0.001 / cfg.fm_kf
    fblocks = [torch.from_numpy(make_block(rng, b, L_FULL)).to(dev)
               for b in range(N_CHAIN)]
    f_k, f_p, fok, fc, fm_k, fm_p = compare(cfg, fblocks,
                                            {"ddc_fm_fast": N_CHAIN})
    snr_f = snr_db(f_k, f_p)
    tone_f = float(np.median(f_k[1000:]))
    print(f"[36 fm chain at default, kernel vs plain, {N_CHAIN} x 2^24] audio "
          f"{snr_f:.1f} dB (gate {MIN_SNR_DB}), tone {tone_f:.6f} want "
          f"{tone:.6f}, fast launches {fc}, state equal, no x3 launch {fok}",
          flush=True)
    if not (fok and snr_f >= MIN_SNR_DB and abs(tone_f - tone) <= TONE_ATOL):
        fail("phase 36: the FM chain at default is wrong")

    ublocks = [torch.from_numpy(make_block(rng, b, L_UNALIGNED)).to(dev)
               for b in range(N_CHAIN)]
    u_k, u_p, uok, uc, _, _ = compare(cfg, ublocks,
                                      {"ddc_body_unaligned_fast": N_CHAIN})
    snr_u = snr_db(u_k, u_p)
    tone_u = float(np.median(u_k[1000:]))
    print(f"[36 fm chain at default, kernel vs plain, {N_CHAIN} x (2^24 + 52)]"
          f" audio {snr_u:.1f} dB (gate {MIN_SNR_DB}), tone {tone_u:.6f} want "
          f"{tone:.6f}, fast launches {uc}, state equal, no x3 launch {uok}",
          flush=True)
    if not (uok and snr_u >= MIN_SNR_DB and abs(tone_u - tone) <= TONE_ATOL):
        fail("phase 36: the unaligned FM chain at default is wrong")

    ablocks = [torch.from_numpy(make_am_block(rng, b, L_FULL)).to(dev)
               for b in range(N_CHAIN)]
    a_k, a_p, aok, ac, am_k, am_p = compare(replace(cfg, demod="am"), ablocks,
                                            {"ddc_body_fast": N_CHAIN})
    snr_a = snr_db(a_k, a_p)
    env = a_k[T:2 * T].astype(np.float64)
    peak = int(np.argmax(np.abs(np.fft.rfft(env - env.mean()))[1:])) + 1
    print(f"[36 am chain at default, kernel vs plain, {N_CHAIN} x 2^24] "
          f"envelope {snr_a:.1f} dB (gate {MIN_SNR_DB}), tone at bin {peak} "
          f"want {round(AM_TONE * M * T)}, fast launches {ac}, state equal, "
          f"no x3 launch {aok}", flush=True)
    if not (aok and snr_a >= MIN_SNR_DB and peak == round(AM_TONE * M * T)):
        fail("phase 36: the AM chain at default is wrong")

    sym = qpsk_symbols(N_CHAIN, L_FULL)
    qblocks = [torch.from_numpy(make_qpsk_block(rng, sym, b, L_FULL)).to(dev)
               for b in range(N_CHAIN)]
    q_k, q_p, qok, qc, qp_k, qp_p = compare(replace(cfg, demod="qpsk"),
                                            qblocks,
                                            {"ddc_body_fast": N_CHAIN})
    snr_q = snr_db(q_k, q_p)
    sers = [best_aligned_ser(sym[b * T // 8:(b + 1) * T // 8],
                             (q_k[b * T:(b + 1) * T][11::8].real < 0)
                             .astype(int)
                             + 2 * (q_k[b * T:(b + 1) * T][11::8].imag < 0))
            for b in range(N_CHAIN)]
    print(f"[36 qpsk chain at default, kernel vs plain, {N_CHAIN} x 2^24] out "
          f"{snr_q:.1f} dB (gate {QPSK_MIN_SNR_DB}), SER per block "
          f"{[round(v, 6) for v in sers]} (gate {MAX_SER}), fast launches "
          f"{qc}, state equal, no x3 launch {qok}", flush=True)
    if not (qok and snr_q >= QPSK_MIN_SNR_DB and max(sers) < MAX_SER):
        fail("phase 36: the QPSK chain at default is wrong")

    # 36. throughput over N_TIMED blocks, in turns with the same chain at
    # x3 (x3, default, default, x3) and once with the plain bodies
    def step(chain, blks):
        box = {"st": chain[0](), "i": 0}

        def fn():
            _, box["st"] = chain[1](box["st"], blks[box["i"] % N_CHAIN])
            box["i"] += 1
        return fn

    for label, blks, ccfg, ck, cp in (
            ("fm", fblocks, cfg, fm_k, fm_p),
            ("am", ablocks, replace(cfg, demod="am"), am_k, am_p),
            ("qpsk", qblocks, replace(cfg, demod="qpsk"), qp_k, qp_p)):
        cx = make_rx_chain(replace(ccfg, fir_precision="x3"), dev)
        turns = [timed(step(c, blks), N_TIMED) for c in (cx, ck, ck, cx, cp)]
        rate = [L_FULL / (ms * 1e3) for ms, _ in turns]
        busy, top = profiled_busy(step(ck, blks))
        wall = 0.5 * (turns[1][0] + turns[2][0])
        print(f"[36 throughput {label} at default, {N_TIMED} x 2^24] chain "
              f"with kernel {rate[1]:.1f} / {rate[2]:.1f} Msamples/s, at x3 "
              f"in turns {rate[0]:.1f} / {rate[3]:.1f}, plain {rate[4]:.1f}; "
              f"host enqueue {turns[1][1]:.4f} / {turns[2][1]:.4f} ms a "
              f"block (x3 {turns[0][1]:.4f} / {turns[3][1]:.4f}), device "
              f"busy {busy:.4f} ms a block, wall {wall:.4f} ms, idle "
              f"{max(0.0, 1 - busy / wall):.0%}; largest kernels, ms a "
              f"block: {top} | {smi}", flush=True)

    # 36. complex128 (the float64 body) and 300 taps (no kernel's
    # predicate: the plain body): the card's chain against its CPU run
    for label, ccfg in (("complex128", replace(cfg, demod="fm",
                                               dtype=torch.complex128)),
                        ("300 taps", replace(cfg, fir_taps=300,
                                             fir_precision="x3"))):
        c128 = ccfg.dtype == torch.complex128
        blks = [make_block(rng, b, L_CPU_RUN) for b in range(N_CHAIN)]
        if c128:
            blks = [b.astype(np.float64) for b in blks]
        runs = {}
        for key, where in (("card", dev), ("cpu", torch.device("cpu"))):
            init, apply = make_rx_chain(ccfg, where)
            st, outs = init(), []
            xs = [torch.from_numpy(b).to(where) for b in blks]
            for c in fast_counters.values():
                c.fast_launches = c.launches = 0
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for xb in xs:
                out, st = apply(st, xb)
                outs.append(out)
            e1.record()
            torch.cuda.synchronize()
            if key == "card":
                ms = e0.elapsed_time(e1) / N_CHAIN
                none = all(c.fast_launches == c.launches == 0
                           for c in fast_counters.values())
            runs[key] = torch.cat(outs).cpu().numpy()
        snr = snr_db(runs["card"], runs["cpu"])
        print(f"[36 {label} fm chain, card vs its CPU run, {N_CHAIN} x 2^22] "
              f"{snr:.1f} dB (gate {CPU_RUN_MIN_SNR_DB}), dtype "
              f"{runs['card'].dtype}, no DDC kernel launched {none} (JAX's "
              f"XLA route: the plain body on the card); {ms:.4f} ms a block "
              f"(the first {N_CHAIN} blocks, CUDA events) | {smi}",
              flush=True)
        if not (snr >= CPU_RUN_MIN_SNR_DB and none
                and np.all(np.isfinite(runs["card"]))):
            fail(f"phase 36: the {label} chain disagrees with its CPU run")

    entries = []
    for name, line in (("ddc_fm_fast", 645), ("ddc_body_fast", 405),
                       ("ddc_body_unaligned_fast", 177)):
        err, kms, pms, lms, bnd = stats[name]
        entries.append(kernel_entry(
            name, "ddc_fm.cu" if name == "ddc_fm_fast" else "ddc_body.cu",
            f"solid_dsp_tpu/ops/pallas_ddc.py:{line}", launches[name], err,
            kms, pms, bnd, lms))
    return entries


def p4_phases(dev, smi) -> list:
    """37: P4 repaired, the DDC body's direct-form route at large
    decimations (128 taps at M = 200, 256 taps at M = 128), both modes:
    the kernel against its plain version on ~2^24-sample blocks, timed;
    the fused FM, AM and QPSK chains there, and the FM chains at 256 taps,
    M = 240 and 512, M = 256, kernel against plain body, x3 and "default";
    K1's direct route at K1_DIRECT_POINTS against its plain version,
    timed.  Returns the two direct routes' entries, each in both modes."""
    from solid_dsp_tpu_torch.models.rx_chain import RxChainConfig, make_rx_chain
    from solid_dsp_tpu_torch.ops import cuda_ddc
    from solid_dsp_tpu_torch.ops import ddc as ddc_ops
    from solid_dsp_tpu_torch.ops.nco import constrain

    rng = np.random.default_rng(SEED + 37)
    kernels = (cuda_ddc.ddc_body_cuda, cuda_ddc.ddc_body_unaligned_cuda)
    stats = {}
    ok = True
    # 37 (i). the kernel against its plain version, timed
    for n, M in P4_POINTS:
        taps = RxChainConfig(fir_taps=n, decimation=M).design_taps()
        L = (L_FULL // (64 * M)) * 64 * M
        x = torch.from_numpy(rng.standard_normal((2, L)).astype(
            np.float32)).to(dev)
        D = max(n - M, 0)
        tail = torch.from_numpy((0.1 * rng.standard_normal((2, D))).astype(
            np.float32)).to(dev)
        T = L // M
        for mode in ("x3", "fast"):
            body = cuda_ddc.make_ddc_body(taps, constrain(0.2), M, dev,
                                          mode=mode)
            kernel = body.route(L)
            field = "direct_fast_launches" if mode == "fast" else \
                "direct_launches"
            before = getattr(kernel, field)
            zk = kernel(body, x, tail)
            zk2 = kernel(body, x, tail)
            zp = ddc_ops.ddc_body_torch(body, x, tail)
            torch.cuda.synchronize()
            once = getattr(kernel, field) == before + 2
            same = torch.equal(zk, zk2)
            snr = snr_db(zk.cpu().numpy(), zp.cpu().numpy())
            err = float((zk - zp).abs().max())
            k_ms = graph_ms(lambda: kernel(body, x, tail), 20)
            p_ms = cuda_ms(lambda: ddc_ops.ddc_body_torch(body, x, tail), 5)
            ldt = torch.bfloat16 if mode == "fast" else torch.float32
            x_ext = torch.cat([tail, x], dim=1)[None].to(ldt)
            h = body.taps
            w = torch.stack([torch.stack([h[0], -h[1]]),
                             torch.stack([h[1], h[0]])]).to(ldt)
            if n <= M:       # no tail: the window of output t ends at tM + M
                x_ext = torch.nn.functional.pad(x_ext, (n - M, 0))
            l_ms = graph_ms(lambda: torch.nn.functional.conv1d(
                x_ext, w, stride=M), 20)
            bnd = bound_ms(4 * (2 * L + 2 * D + 2 * n + 2 * T), 8 * n * T,
                           BF16_FLOPS if mode == "fast" else FP32_FLOPS)
            stats[(n, M, mode)] = (err, k_ms, p_ms, l_ms, bnd)
            good = (snr >= BODY_FAST_MIN_SNR_DB and once and same
                    and bool(torch.isfinite(zk).all())
                    and zk.shape == (2, T))
            ok = ok and good
            print(f"[37 body direct route, {n} taps, M = {M}, {mode}, "
                  f"L={L} ({kernel.__name__})] z {snr:.1f} dB against the "
                  f"plain body (gate {BODY_FAST_MIN_SNR_DB}), max|err| "
                  f"{err:.3g}, two launches bit-equal {same}, counted "
                  f"{once}; kernel (CUDA graph of 20) {k_ms:.4f} ms, bound "
                  f"{bnd[0]:.4f} ms ({bnd[1]}), plain {p_ms:.4f} ms, "
                  f"library strided conv1d ({str(ldt)[6:]}) {l_ms:.4f} ms "
                  f"| {smi}", flush=True)
    if not ok:
        fail("phase 37: the body's direct route disagrees")

    # 37 (ii). the chains at P4's points, kernel against plain body, and
    # the FM chains where only K1's direct route takes the block
    launches = {"x3": 0, "fast": 0}
    k1_launches = {"x3": 0, "fast": 0}
    chain_points = [(n, M, ("fm", "am", "qpsk")) for n, M in P4_POINTS] + [
        (n, M, ("fm",)) for n, M in K1_CHAIN_POINTS]
    for n, M, demods in chain_points:
        L = L_P4_CHAIN // (64 * M) * 64 * M
        for precision in ("x3", "default"):
            for demod in demods:
                cfg = RxChainConfig(carrier_freq=0.2, decimation=M,
                                    fir_taps=n, agc_mode="block", demod=demod,
                                    nco_mode="exact", input_format="planar",
                                    fused_ddc="on", fir_precision=precision)
                if demod == "qpsk":
                    sym = qpsk_symbols(N_CHAIN, L)
                    blks = [make_qpsk_block(rng, sym, b, L)
                            for b in range(N_CHAIN)]
                else:
                    blks = [make_block(rng, b, L) for b in range(N_CHAIN)]
                blks = [torch.from_numpy(b).to(dev) for b in blks]
                outs = {}
                for engine in ("cuda", "torch"):
                    init, apply = make_rx_chain(replace(
                        cfg, ddc_engine=engine), dev)
                    st = init()
                    for c in kernels + (cuda_ddc.ddc_fm_cuda,):
                        c.direct_launches = c.direct_fast_launches = 0
                    got = []
                    for xb in blks:
                        out, st = apply(st, xb)
                        got.append(out)
                    torch.cuda.synchronize()
                    body = sum(c.direct_launches + c.direct_fast_launches
                               for c in kernels)
                    k1 = (cuda_ddc.ddc_fm_cuda.direct_launches
                          + cuda_ddc.ddc_fm_cuda.direct_fast_launches)
                    outs[engine] = (torch.cat(got).cpu().numpy(), st, body,
                                    k1)
                (yk, sk, bk, fk), (yp, sp, bp, fp) = outs["cuda"], \
                    outs["torch"]
                mode = "fast" if precision == "default" else "x3"
                launches[mode] += bk
                k1_launches[mode] += fk
                want = (0, N_CHAIN) if demod == "fm" and n > M else (
                    N_CHAIN, 0)
                snr = snr_db(yk, yp)
                gate = QPSK_MIN_SNR_DB if demod == "qpsk" else MIN_SNR_DB
                extra = ""
                good = ((bk, fk) == want and (bp, fp) == (0, 0)
                        and snr >= gate and bool(np.all(np.isfinite(yk)))
                        and int(sk["nco_theta"]) == int(sp["nco_theta"])
                        and torch.equal(sk["fir_tail"], sp["fir_tail"]))
                if demod == "qpsk":
                    def quad(v):
                        return (v.real < 0).astype(int) + 2 * (v.imag < 0)
                    ser = float(np.mean(quad(yk) != quad(yp)))
                    good = good and ser < MAX_SER
                    extra = f", decisions differing {ser:.3g} (gate {MAX_SER})"
                ok = ok and good
                print(f"[37 {demod} chain, {n} taps, M = {M}, {precision}, "
                      f"{N_CHAIN} x {L}] kernel vs plain body {snr:.1f} dB "
                      f"(gate {gate}){extra}, direct launches body/K1 "
                      f"{bk}/{fk} (want {want[0]}/{want[1]}), plain run "
                      f"{bp}/{fp}, state equal "
                      f"{int(sk['nco_theta']) == int(sp['nco_theta'])}",
                      flush=True)
    if not ok:
        fail("phase 37: a chain at a large decimation is wrong")

    # 37 (iii). K1's direct route against its plain version, timed
    k1 = {}
    kf = RxChainConfig().fm_kf
    for n, M in K1_DIRECT_POINTS:
        taps = RxChainConfig(fir_taps=n, decimation=M).design_taps()
        L = (L_FULL // (64 * M)) * 64 * M
        x = torch.from_numpy(make_block(rng, 0, L)).to(dev)
        D = n - M
        tail = torch.from_numpy((0.1 * rng.standard_normal((2, D))).astype(
            np.float32)).to(dev)
        T = L // M
        for mode in ("x3", "fast"):
            fast = mode == "fast"
            body = cuda_ddc.make_ddc_fm(taps, constrain(0.2), M, kf, dev,
                                        mode=mode)
            route = cuda_ddc.fm_geometry(n, M, fast)
            field = "direct_fast_launches" if fast else "direct_launches"
            before = getattr(cuda_ddc.ddc_fm_cuda, field)
            ak, sk = cuda_ddc.ddc_fm_cuda(body, x, tail)
            ak2, sk2 = cuda_ddc.ddc_fm_cuda(body, x, tail)
            ap, sp = cuda_ddc.ddc_fm_torch(body, x, tail)
            torch.cuda.synchronize()
            counted = getattr(cuda_ddc.ddc_fm_cuda, field) == before + 2
            same = torch.equal(ak, ak2) and torch.equal(sk, sk2)
            akn, apn = ak.cpu().numpy(), ap.cpu().numpy()
            skn, spn = sk.cpu().numpy(), sp.cpu().numpy()
            snr = snr_db(akn, apn)
            err = float(np.max(np.abs(akn - apn)))
            err_e = abs(float(skn[0]) - float(spn[0])) / abs(float(spn[0]))
            err_z = float(np.max(np.abs(skn[1:] - spn[1:])))
            k_ms = graph_ms(lambda: cuda_ddc.ddc_fm_cuda(body, x, tail), 20)
            p_ms = cuda_ms(lambda: cuda_ddc.ddc_fm_torch(body, x, tail), 5)
            # each input read once, the audio and stats written once; the
            # FIR's 8 operations a complex tap an output
            bnd = bound_ms(4 * (2 * L + 2 * D + 2 * n + T + 5), 8 * n * T,
                           BF16_FLOPS if fast else FP32_FLOPS)
            k1[(n, M, mode)] = (err, k_ms, p_ms, bnd)
            staged = STAGED_K1_MS.get((n, M, mode))
            good = (route[0] == "direct" and snr >= MIN_SNR_DB and counted
                    and same and err_e <= ENERGY_RTOL and err_z <= EDGE_ATOL
                    and bool(np.all(np.isfinite(akn))) and akn.shape == (T,))
            ok = ok and good
            print(f"[37 K1 direct route, {n} taps, M = {M}, {mode}, L={L}] "
                  f"route {route}; audio {snr:.1f} dB against the plain "
                  f"version (gate {MIN_SNR_DB}), max|err| {err:.3g}, energy "
                  f"rel err {err_e:.3g} (gate {ENERGY_RTOL}), z0/zlast err "
                  f"{err_z:.3g} (gate {EDGE_ATOL}), two launches bit-equal "
                  f"{same}, counted {counted}; kernel (CUDA graph of 20) "
                  f"{k_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), plain "
                  f"{p_ms:.4f} ms, the staged design "
                  f"{'raised' if staged is None else f'{staged:.4f} ms'} "
                  f"| {smi}", flush=True)
    if not ok:
        fail("phase 37: K1's direct route disagrees")
    entries = []
    for mode, name in (("x3", "ddc_body_direct"),
                       ("fast", "ddc_body_direct_fast")):
        err, k_ms, p_ms, l_ms, bnd = stats[(256, 128, mode)]
        e = kernel_entry(
            name, "ddc_body.cu",
            "solid_dsp_tpu/ops/pallas_ddc.py:405 make_pallas_ddc_full and "
            ":177 make_pallas_ddc_body at large decimations" + (
                " (mode=\"fast\")" if mode == "fast" else ""),
            launches[mode], err, k_ms, p_ms, bnd, l_ms)
        o = stats[(128, 200, mode)]
        e["at_128_taps_M200"] = {"ms": o[1], "plain_ms": o[2],
                                 "library_ms": o[3], "bound_ms": o[4][0],
                                 "max_abs_err": o[0]}
        entries.append(e)
    for mode, name in (("x3", "ddc_fm_direct"), ("fast", "ddc_fm_direct_fast")):
        err, k_ms, p_ms, bnd = k1[(256, 128, mode)]
        e = kernel_entry(
            name, "ddc_fm.cu",
            "solid_dsp_tpu/ops/pallas_ddc.py:645 make_pallas_ddc_fm at large "
            "decimations" + (" (mode=\"fast\")" if mode == "fast" else ""),
            k1_launches[mode], err, k_ms, p_ms, bnd)
        for n, M in K1_DIRECT_POINTS[1:]:
            o = k1[(n, M, mode)]
            e[f"at_{n}_taps_M{M}"] = {"ms": o[1], "plain_ms": o[2],
                                      "bound_ms": o[3][0],
                                      "max_abs_err": o[0]}
        entries.append(e)
    return entries


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs only on a GPU")
    from solid_dsp_tpu_torch.models import qpsk as qpsk_ops
    from solid_dsp_tpu_torch.models.rx_chain import RxChainConfig, make_rx_chain
    from solid_dsp_tpu_torch.ops import cuda_build, cuda_ddc
    from solid_dsp_tpu_torch.ops import ddc as ddc_ops
    from solid_dsp_tpu_torch.ops.nco import constrain

    dev = torch.device(DEVICE, 0)

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"[1 device] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {name}", flush=True)

    # 2. build
    t = time.perf_counter()
    cuda_build.build()
    print(f"[2 build] {', '.join(cuda_build.SOURCES)} built in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    for source, log in cuda_build.build_logs().items():
        usage = [ln.split("info    :")[-1].strip() for ln in log.splitlines()
                 if "Used" in ln or "spill" in ln]
        print(f"[2 build] {source}: {' | '.join(usage) or 'built earlier'}",
              flush=True)

    cfg = RxChainConfig(carrier_freq=0.2, decimation=4, fir_taps=64,
                        agc_mode="block", demod="fm", nco_mode="exact",
                        input_format="planar", fused_ddc="on",
                        fir_precision="x3")
    taps = cfg.design_taps()
    dtheta = constrain(cfg.carrier_freq)
    M = cfg.decimation
    rng = np.random.default_rng(SEED)

    # 3. kernel vs plain version, f32 on the card, full size
    body = cuda_ddc.make_ddc_fm(taps, dtheta, M, cfg.fm_kf, dev)
    x = torch.from_numpy(make_block(rng, 0, L_FULL)).to(dev)
    tail = torch.from_numpy(
        (0.1 * rng.standard_normal((2, cfg.fir_taps - M))).astype(np.float32)
    ).to(dev)
    ak, sk = cuda_ddc.ddc_fm_cuda(body, x, tail)
    ak2, sk2 = cuda_ddc.ddc_fm_cuda(body, x, tail)
    ap, sp = cuda_ddc.ddc_fm_torch(body, x, tail)
    torch.cuda.synchronize()
    same3 = torch.equal(ak, ak2) and torch.equal(sk, sk2)
    ak, sk = ak.cpu().numpy(), sk.cpu().numpy()
    ap, sp = ap.cpu().numpy(), sp.cpu().numpy()
    snr3 = snr_db(ak, ap)
    err_e = abs(float(sk[0]) - float(sp[0])) / abs(float(sp[0]))
    err_z = float(np.max(np.abs(sk[1:] - sp[1:])))
    max_abs = float(np.max(np.abs(ak - ap)))
    k_ms = graph_ms(lambda: cuda_ddc.ddc_fm_cuda(body, x, tail), 20)
    k_b2b = cuda_ms(lambda: cuda_ddc.ddc_fm_cuda(body, x, tail), 20)
    p_ms = cuda_ms(lambda: cuda_ddc.ddc_fm_torch(body, x, tail), 20)
    # bound: each input read once, each output written once; the FIR's 8
    # FLOPs a complex tap a decimated output in FP32 (x3)
    n, D, T = cfg.fir_taps, cfg.fir_taps - M, L_FULL // M
    b3 = bound_ms(4 * (2 * L_FULL + 2 * D + 2 * n + T + 5), 8 * n * T,
                  FP32_FLOPS)
    route3 = cuda_ddc.fm_geometry(n, M)
    print(f"[3 kernel vs plain f32, L=2^24] audio {snr3:.1f} dB (gate "
          f"{MIN_SNR_DB}), max |err| {max_abs:.3g}, energy rel err "
          f"{err_e:.3g} (gate {ENERGY_RTOL}), z0/zlast err {err_z:.3g} "
          f"(gate {EDGE_ATOL}), two launches bit-equal {same3}; route "
          f"{route3}; kernel (CUDA graph of 20 launches) {k_ms:.4f} ms, "
          f"bound {b3[0]:.4f} ms ({b3[1]}), back-to-back launches (the "
          f"earlier figure) {k_b2b:.4f} ms, plain {p_ms:.4f} ms | {smi}",
          flush=True)
    if not (snr3 >= MIN_SNR_DB and err_e <= ENERGY_RTOL and err_z <= EDGE_ATOL
            and same3 and np.all(np.isfinite(ak))
            and ak.shape == (L_FULL // M,)):
        fail("phase 3: kernel disagrees with the plain version")

    # 4. kernel vs the plain version in float64 on the CPU
    x1 = make_block(rng, 0, L_F64)
    tail1 = tail.cpu().numpy()
    ak1, _ = cuda_ddc.ddc_fm_cuda(body, torch.from_numpy(x1).to(dev),
                                  torch.from_numpy(tail1).to(dev))
    body64 = cuda_ddc.make_ddc_fm(taps, dtheta, M, cfg.fm_kf, "cpu",
                                  torch.float64)
    a64, _ = cuda_ddc.ddc_fm_torch(body64, torch.from_numpy(x1).double(),
                                   torch.from_numpy(tail1).double())
    snr4 = snr_db(ak1.cpu().numpy(), a64.numpy())
    print(f"[4 kernel vs plain f64 (CPU), L=2^20] audio {snr4:.1f} dB "
          f"(gate {MIN_SNR_DB})", flush=True)
    if not snr4 >= MIN_SNR_DB:
        fail("phase 4: kernel disagrees with the float64 plain version")

    # 5. the chain, kernel vs plain, over N_CHAIN blocks, state carried
    blocks = [torch.from_numpy(make_block(rng, b, L_FULL)).to(dev)
              for b in range(N_CHAIN)]
    init_k, apply_k = make_rx_chain(cfg, dev)
    init_p, apply_p = make_rx_chain(replace(cfg, ddc_engine="torch"), dev)
    st_k, st_p = init_k(), init_p()
    cuda_ddc.ddc_fm_cuda.launches = 0
    outs_k = []
    for xb in blocks:
        out, st_k = apply_k(st_k, xb)
        outs_k.append(out)
    torch.cuda.synchronize()
    launches = cuda_ddc.ddc_fm_cuda.launches
    outs_p = []
    for xb in blocks:
        out, st_p = apply_p(st_p, xb)
        outs_p.append(out)
    audio_k = torch.cat(outs_k).cpu().numpy()
    audio_p = torch.cat(outs_p).cpu().numpy()
    snr5 = snr_db(audio_k, audio_p)
    theta_eq = int(st_k["nco_theta"]) == int(st_p["nco_theta"])
    theta_want = (N_CHAIN * L_FULL * int(dtheta)) & 0xFFFFFFFF
    tail_eq = torch.equal(st_k["fir_tail"], st_p["fir_tail"])
    tone = 4 * 0.001 / cfg.fm_kf    # FM audio of a tone: its offset / kf
    tone_got = float(np.median(audio_k[1000:]))     # past the settling
    print(f"[5 chain kernel vs plain, {N_CHAIN} x 2^24] audio {snr5:.1f} dB "
          f"(gate {MIN_SNR_DB}), nco_theta equal {theta_eq} "
          f"({int(st_k['nco_theta'])}, want {theta_want}), fir_tail equal "
          f"{tail_eq}, kernel launches {launches}, tone {tone_got:.6f}"
          f" want {tone:.6f}, gain {float(st_k['agc']['gain']):.6f}", flush=True)
    if not (snr5 >= MIN_SNR_DB and theta_eq and tail_eq
            and int(st_k["nco_theta"]) == theta_want
            and launches == N_CHAIN and abs(tone_got - tone) <= TONE_ATOL
            and np.all(np.isfinite(audio_k))
            and audio_k.shape == (N_CHAIN * L_FULL // M,)):
        fail("phase 5: the chain through the kernel is wrong")

    # 6. throughput of the two chains (turns: plain, kernel, kernel, plain)
    def run_chain(init, apply, blocks):
        st = init()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        for xb in blocks:                              # warm-up
            _, st = apply(st, xb)
        e0.record()
        for i in range(N_TIMED):
            _, st = apply(st, blocks[i % N_CHAIN])
        e1.record()
        torch.cuda.synchronize()
        return N_TIMED * L_FULL / (e0.elapsed_time(e1) * 1e3)   # Msamples/s

    p1 = run_chain(init_p, apply_p, blocks)
    k1 = run_chain(init_k, apply_k, blocks)
    k2 = run_chain(init_k, apply_k, blocks)
    p2 = run_chain(init_p, apply_p, blocks)
    print(f"[6 throughput, {N_TIMED} x 2^24] chain with kernel {k1:.1f} / "
          f"{k2:.1f} Msamples/s, plain chain {p1:.1f} / {p2:.1f} Msamples/s | "
          f"{smi}", flush=True)

    # 7. body kernel vs plain version, f32 on the card: K2, K3, short
    dbody = cuda_ddc.make_ddc_body(taps, dtheta, M, dev)
    n7, D7 = cfg.fir_taps, cfg.fir_taps - M
    body_stats = {}
    for route, L, kernel in (
            ("ddc_body", L_FULL, cuda_ddc.ddc_body_cuda),
            ("ddc_body_unaligned", L_UNALIGNED,
             cuda_ddc.ddc_body_unaligned_cuda),
            ("short", L_SHORT, cuda_ddc.ddc_body_unaligned_cuda)):
        x = torch.from_numpy(make_block(rng, 0, L)).to(dev)
        before = kernel.launches
        zk = kernel(dbody, x, tail)
        zp = cuda_ddc.ddc_body_torch(dbody, x, tail)
        torch.cuda.synchronize()
        once = kernel.launches == before + 1
        zk, zp = zk.cpu().numpy(), zp.cpu().numpy()
        snr7 = snr_db(zk, zp)
        ek, ep = float(np.sum(zk.astype(np.float64) ** 2)), float(
            np.sum(zp.astype(np.float64) ** 2))
        err_e = abs(ek - ep) / ep
        max_abs7 = float(np.max(np.abs(zk - zp)))
        timing = ""
        if route != "short":
            k7 = graph_ms(lambda: kernel(dbody, x, tail), 20)
            p7 = cuda_ms(lambda: cuda_ddc.ddc_body_torch(dbody, x, tail), 20)
            # the library call: one strided conv1d over the tail and the
            # block as 2 in-channels, the folded complex taps as a
            # (2, 2, n) weight (TF32 off)
            x_ext = torch.cat([tail, x], dim=1)[None]
            h = dbody.taps
            w = torch.stack([torch.stack([h[0], -h[1]]),
                             torch.stack([h[1], h[0]])])
            zl = torch.nn.functional.conv1d(x_ext, w, stride=M)[0]
            snr_lib = snr_db(zl.cpu().numpy(), zp)
            l7 = graph_ms(lambda: torch.nn.functional.conv1d(x_ext, w,
                                                             stride=M), 20)
            b7 = bound_ms(4 * (2 * L + 2 * D7 + 2 * n7 + 2 * (L // M)),
                          8 * n7 * (L // M), FP32_FLOPS)
            body_stats[route] = (max_abs7, k7, p7, l7, L, b7)
            timing = (f"; kernel (TF32 x3 wgmma, CUDA graph of 20 launches) "
                     f"{k7:.4f} ms, bound {b7[0]:.4f} ms ({b7[1]}), plain "
                     f"{p7:.4f} ms, library strided conv1d (CUDA graph) "
                     f"{l7:.4f} ms ({snr_lib:.1f} dB vs plain)")
        print(f"[7 body kernel vs plain f32, {route}, L={L}] z {snr7:.1f} dB "
              f"(gate {MIN_SNR_DB}), max |err| {max_abs7:.3g}, energy rel "
              f"err {err_e:.3g} (gate {ENERGY_RTOL}), one launch {once}"
              f"{timing} | {smi}", flush=True)
        if not (snr7 >= MIN_SNR_DB and err_e <= ENERGY_RTOL and once
                and zk.shape == (2, L // M) and np.all(np.isfinite(zk))):
            fail(f"phase 7: the body kernel disagrees on {route}")

    # 8. body kernel vs the plain version in float64 on the CPU
    x1 = make_block(rng, 0, L_F64)
    zk1 = cuda_ddc.ddc_body_cuda(dbody, torch.from_numpy(x1).to(dev),
                                 torch.from_numpy(tail1).to(dev))
    dbody64 = cuda_ddc.make_ddc_body(taps, dtheta, M, "cpu", torch.float64)
    z64 = cuda_ddc.ddc_body_torch(dbody64, torch.from_numpy(x1).double(),
                                  torch.from_numpy(tail1).double())
    snr8 = snr_db(zk1.cpu().numpy(), z64.numpy())
    print(f"[8 body kernel vs plain f64 (CPU), L=2^20] z {snr8:.1f} dB "
          f"(gate {HIGHEST_MIN_SNR_DB})", flush=True)
    if not snr8 >= HIGHEST_MIN_SNR_DB:
        fail("phase 8: the body kernel disagrees with the float64 plain "
             "version")

    # 9. QPSK, AM and unaligned-FM chains, kernel vs plain, state carried
    counters = (cuda_ddc.ddc_fm_cuda, cuda_ddc.ddc_body_cuda,
                cuda_ddc.ddc_body_unaligned_cuda)
    launches_main = {"ddc_fm": launches, "ddc_body": 0,
                     "ddc_body_unaligned": 0}

    def compare_chains(ccfg, blks, want_counts):
        init_k, apply_k = make_rx_chain(ccfg, dev)
        init_p, apply_p = make_rx_chain(replace(ccfg, ddc_engine="torch"),
                                        dev)
        st_k, st_p = init_k(), init_p()
        for c in counters:
            c.launches = 0
        outs_k = []
        for xb in blks:
            out, st_k = apply_k(st_k, xb)
            outs_k.append(out)
        torch.cuda.synchronize()
        counts = tuple(c.launches for c in counters)
        for key, c in zip(launches_main, counts):
            launches_main[key] += c
        outs_p = []
        for xb in blks:
            out, st_p = apply_p(st_p, xb)
            outs_p.append(out)
        out_k = torch.cat(outs_k).cpu().numpy()
        out_p = torch.cat(outs_p).cpu().numpy()
        theta_want = (N_CHAIN * int(blks[0].shape[-1]) * int(dtheta)
                      ) & 0xFFFFFFFF
        ok = (int(st_k["nco_theta"]) == int(st_p["nco_theta"]) == theta_want
              and torch.equal(st_k["fir_tail"], st_p["fir_tail"])
              and counts == want_counts and np.all(np.isfinite(out_k)))
        return out_k, out_p, counts, ok, (init_k, apply_k), (init_p, apply_p)

    T = L_FULL // M
    sym = qpsk_symbols(N_CHAIN, L_FULL)
    qblocks = [torch.from_numpy(make_qpsk_block(rng, sym, b, L_FULL)).to(dev)
               for b in range(N_CHAIN)]
    qcfg = replace(cfg, demod="qpsk")
    q_k, q_p, qcounts, qok, q_kernel, q_plain = compare_chains(
        qcfg, qblocks, (0, N_CHAIN, 0))
    snr9q = snr_db(q_k, q_p)
    # output t's window ends at input sample 4t + 3 and is centred 31.5
    # samples earlier: symbol j's middle is output 8j + 11
    sers = [best_aligned_ser(sym[b * T // 8:(b + 1) * T // 8],
                             (q_k[b * T:(b + 1) * T][11::8].real < 0)
                             .astype(int)
                             + 2 * (q_k[b * T:(b + 1) * T][11::8].imag < 0))
            for b in range(N_CHAIN)]
    # the carrier estimate of block 0 from the rotated body output
    yr, yi, _, _ = ddc_ops.ddc_apply_planar(
        dbody, torch.zeros((2, cfg.fir_taps - 1), device=dev),
        torch.zeros((), dtype=torch.int64, device=dev), qblocks[0])
    _, f_hat, _ = qpsk_ops.qpsk_carrier_block(torch.complex(yr, yi))
    f_want = M * (QPSK_OFFSET + 0.2
                  - float(int(dtheta) * 2 * np.pi / 2 ** 32))
    f_err = abs(float(f_hat) - f_want)
    print(f"[9 qpsk chain kernel vs plain, {N_CHAIN} x 2^24] out "
          f"{snr9q:.1f} dB (gate {QPSK_MIN_SNR_DB}), SER per block "
          f"{[round(v, 6) for v in sers]} (gate {MAX_SER}), f_hat "
          f"{float(f_hat):.9f} want {f_want:.9f} (gate {F_HAT_ATOL}), "
          f"launches fm/body/unaligned {qcounts}, state equal {qok}",
          flush=True)
    if not (qok and snr9q >= QPSK_MIN_SNR_DB and max(sers) < MAX_SER
            and f_err <= F_HAT_ATOL and q_k.shape == (N_CHAIN * T,)):
        fail("phase 9: the QPSK chain through the kernel is wrong")

    ablocks = [torch.from_numpy(make_am_block(rng, b, L_FULL)).to(dev)
               for b in range(N_CHAIN)]
    acfg = replace(cfg, demod="am")
    a_k, a_p, acounts, aok, a_kernel, a_plain = compare_chains(
        acfg, ablocks, (0, N_CHAIN, 0))
    snr9a = snr_db(a_k, a_p)
    env = a_k[T:2 * T].astype(np.float64)
    peak = int(np.argmax(np.abs(np.fft.rfft(env - env.mean()))[1:])) + 1
    peak_want = round(AM_TONE * M * T)
    print(f"[9 am chain kernel vs plain, {N_CHAIN} x 2^24] envelope "
          f"{snr9a:.1f} dB (gate {MIN_SNR_DB}), tone at bin {peak} want "
          f"{peak_want}, launches fm/body/unaligned {acounts}, state equal "
          f"{aok}", flush=True)
    if not (aok and snr9a >= MIN_SNR_DB and peak == peak_want
            and a_k.shape == (N_CHAIN * T,)):
        fail("phase 9: the AM chain through the kernel is wrong")

    fblocks = [torch.from_numpy(make_block(rng, b, L_UNALIGNED)).to(dev)
               for b in range(N_CHAIN)]
    f_k, f_p, fcounts, fok, _, _ = compare_chains(
        cfg, fblocks, (0, 0, N_CHAIN))
    snr9f = snr_db(f_k, f_p)
    tone_got9 = float(np.median(f_k[1000:]))
    print(f"[9 fm chain kernel vs plain, {N_CHAIN} x (2^24 + 52)] audio "
          f"{snr9f:.1f} dB (gate {MIN_SNR_DB}), tone {tone_got9:.6f} want "
          f"{tone:.6f}, launches fm/body/unaligned {fcounts}, state equal "
          f"{fok}", flush=True)
    if not (fok and snr9f >= MIN_SNR_DB and abs(tone_got9 - tone) <= TONE_ATOL
            and f_k.shape == (N_CHAIN * L_UNALIGNED // M,)):
        fail("phase 9: the unaligned FM chain through the kernel is wrong")

    # 10. throughput of the QPSK and AM chains (plain, kernel, kernel, plain);
    # for them and the FM chain of phase 6 the host's enqueue time and the
    # device's busy time a block
    def chain_step(init, apply, blks):
        """fn() applying the chain to the blocks in turn, state carried."""
        box = {"st": init(), "i": 0}

        def fn():
            _, box["st"] = apply(box["st"], blks[box["i"] % N_CHAIN])
            box["i"] += 1
        return fn

    rates = {"fm": (k1, k2, p1, p2)}           # phase 6's turns
    for label, blks, kern, plain in (("qpsk", qblocks, q_kernel, q_plain),
                                     ("am", ablocks, a_kernel, a_plain),
                                     ("fm", blocks, (init_k, apply_k),
                                      (init_p, apply_p))):
        if label not in rates:
            p1 = run_chain(*plain, blks)
            k1 = run_chain(*kern, blks)
            k2 = run_chain(*kern, blks)
            rates[label] = (k1, k2, p1, run_chain(*plain, blks))
        k1, k2 = rates[label][:2]
        _, host_ms = timed(chain_step(*kern, blks), N_TIMED)
        busy, top = profiled_busy(chain_step(*kern, blks))
        wall = L_FULL / (0.5 * (k1 + k2) * 1e3)          # ms a block
        print(f"[10 {label} chain with kernel, 2^24-sample blocks] host "
              f"enqueue {host_ms:.4f} ms a block, device busy {busy:.4f} ms a "
              f"block, wall {wall:.4f} ms, idle {max(0.0, 1 - busy / wall):.0%}"
              f"; largest kernels, ms a block: {top}", flush=True)
    print(f"[10 throughput, {N_TIMED} x 2^24] qpsk chain with kernel "
          f"{rates['qpsk'][0]:.1f} / {rates['qpsk'][1]:.1f} Msamples/s, plain "
          f"{rates['qpsk'][2]:.1f} / {rates['qpsk'][3]:.1f}; am chain with "
          f"kernel {rates['am'][0]:.1f} / {rates['am'][1]:.1f}, plain "
          f"{rates['am'][2]:.1f} / {rates['am'][3]:.1f} | {smi}", flush=True)

    kernels = [kernel_entry(
        "ddc_fm", "ddc_fm.cu", "solid_dsp_tpu/ops/pallas_ddc.py:645",
        launches_main["ddc_fm"], max_abs, k_ms, p_ms, b3)]
    for route, line in (("ddc_body", 405), ("ddc_body_unaligned", 177)):
        err, kms, pms, lms, L, bnd = body_stats[route]
        kernels.append(kernel_entry(
            route, "ddc_body.cu", f"solid_dsp_tpu/ops/pallas_ddc.py:{line}",
            launches_main[route], err, kms, pms, bnd, lms))
    kernels += config5(dev, smi)
    kernels += config2(dev, smi)
    kernels += farrow_phases(dev, smi)
    kernels += parallel_phases(dev, smi)
    precision_phase(dev, smi)
    filter_phases(dev, smi)
    kernels += scan_phases(dev, smi)
    kernels += iir_phases(dev, smi)
    kernels += fast_phases(dev, smi, {
        "ddc_fm": k_ms, "ddc_body": body_stats["ddc_body"][1],
        "ddc_body_unaligned": body_stats["ddc_body_unaligned"][1]})
    kernels += p4_phases(dev, smi)
    if not all(k["launches"] > 0 for k in kernels):
        fail("a kernel of the main paths was never launched")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
