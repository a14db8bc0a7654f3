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
  direct-form routes (ddc_body.cu, ddc_fm.cu) in both modes;
* the system as users start it: the port's own command line
  (solid_dsp_tpu_torch.__main__.main, in this process) on a 2^26-sample
  ci16 recording of broadcast stereo FM at 2.4 Msps (~28 s of an rtl_sdr
  capture) that it writes first, the native runtime (StreamPump, a
  UdpSource fed on localhost) and chain composition (streaming.compose):
  rx through K1 and, for the recording's ragged end, K3; rx --demod am and
  qpsk through K2; monitor --backend fused through K4; demo, --wav and
  stage_iir through S3; stage_agc("exact") through S1;
* ROADMAP item 11 at the TPU sweep's sizes (bench_all.py's tracking,
  detection, resample and cyclo rows): the Kalman trackers (kalman_apply,
  rts_smooth, AlphaBetaTracker, make_kalman_lti) through S4, the Kalman
  recursions' chunk-and-join kernels (track_forward.cu, track_chunks.cu);
  LPC's synthesis lattice through S5 (track_scan.cu); the wavelets, the
  zoom FFT, the cyclostationary scan, the DCT/DST/MDCT, the ADC model and
  the G.711 codecs, the estimators and the RF measurements in torch ops;
* ROADMAP items 13a and 13b: the codes, modems and transmit DSP (turbo
  through S6's fused decode and walk, bcjr_scan.cu) and the link layer
  (the Viterbi decoder through S7, viterbi_scan.cu; RS, CCSDS, the block
  codes, CRC, BER,
  OFDM, MIMO, arrays) and the port's packets command;
* ROADMAP item 13c: the CVSD codec through S8 (cvsd_scan.cu), the Gardner
  timing loop through S9 (gardner_scan.cu), the port's tx, adsb and ais
  commands and the other modems (AM, SSB, GMSK, FSK, CSS, DSSS, FHSS, CW,
  the burst detector, the block symbol synchroniser);
* ROADMAP items 13c's rest and 13d and 14's fault.py as two receivers a
  user runs: a broadcast-FM station with RDS in a 1.824 Msps capture
  through config 4's chain (K1), the stereo decoder (S3's de-emphasis)
  and rds_receive, and a POCSAG pager channel cut out of a 2.4576 Msps
  capture by the DDC body (K2, M = 64) and decoded by pocsag_receive;
  DTMF, the modulation classifier, the channel sounder, the metrics and
  profiling utilities, and checkpointed, supervised crash recovery.

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
     bound, its plain version and the staged design it replaced;
 38. the CLI, the runtime and composition (cli_phases), on recordings in a
     temporary directory: StreamPump's read rate over the 2^26 + 3001-
     sample ci16 recording; rx at --block 2^20 (the CLI's default) and
     2^24 (config 4's), its output bit-equal to the same blocks through
     RxChain on the card and >= 90 dB against the plain body, the stereo
     multiplex read back (correlation > 0.8), K1 on every whole block and
     K3 on the ragged end, each timed file to file (two turns) and split
     a block under the profiler (pump wait, H2D copy, kernels, D2H copy,
     write; the idle share); rx --demod am and qpsk on 2^24 samples (K2;
     the AM tone, QPSK SER < 1e-3); rx --wav --stereo --rate 2400000 on
     2^24 (separation > 12 dB on both rails; S3); monitor --channels 256
     --backend fused --block 2^22 (K4; three bursts on their channels,
     timed and split) and at --block 2^22 + 256, a multiple of the
     channels but not of 8 x 256 (F2: the same events); demo (the golden
     head; S3), spectrum --nfft 4096 and 1009, convert ci16 -> cf32 ->
     ci16 (the same bytes), resample --rate 0.5 (length and tone); 2 s of
     the recording as ci16 datagrams at 2.4 Msps from a sender process
     into a UdpSource and RxChain on the card (nothing dropped or lost,
     the multiplex read back); the config-4 stages composed over 4 x 2^24
     samples against the fused RxChain (1e-5), and with
     stage_agc("exact") and stage_iir (S1, S3) against
     stage_agc("parallel").  Its launches are added to the kernels' line.
 39. item 11 (item11_phases): make_kalman_lti on cv_model(1, 0.05, 1) and
     AlphaBetaTracker "parallel" and "scan" (S4's LTI entry, one launch
     each, the scan's two blocks carried) over 2^22 float32 measurements,
     kalman_apply (S4 forward, two blocks carried) and rts_smooth (S4
     forward with the covariances kept, then backward) over 2^20, each
     within 1e-4 x max of the float64 walk on the host, the forward entry
     alone timed with and without the covariances kept beside its bytes
     bounds; denoise_soft("db4",
     4) on 2^21 float32 against its float64 CPU run (1e-4) and the wavelet
     round trip (1e-4, tests/test_wavelet.py:48); zoom_fft(x, 0.2, 0.3,
     1024) over 256 x 2^14 complex64 against complex128 on the CPU (1e-4)
     with the tone in its bin, czt on the DFT contour against
     torch.fft.fft; cycle_profile over 64 alphas (nfft 256, hop 64) on 2^20
     complex64, 8 alphas against complex128 on the CPU (1e-3), and
     estimate_symbol_rate on an RRC QPSK burst (1/6 within 2e-4,
     tests/test_cyclo.py); lpc and burg of order 16 over 256 frames of 2^14
     (reflection coefficients within 1e-3 of float64), lattice_fir then
     lattice_iir (S5) back to the input (1e-4), S5 at order 64 on one
     lane of 2^20 against scipy's lfilter(1, A) in float64 (1e-4); DCT and
     DST 1-4 (both backends where a type has two), MDCT and IMDCT over
     (4096, 1024) against float64 (1e-5: full float32); adc_model(12) on
     2^24 complex64 bit-equal to its CPU run, its subtractive dither's
     contract, the mu- and A-law codes (at most 1e-6 of them unlike the
     CPU's) and decodes; snr_m2m4, evm, tone_freq_kay / _fft and
     tdoa_gcc_phat on 2^20, and channel_power, acpr, occupied_bandwidth,
     sinad_db / enob / sfdr_db at nfft 4096 on 2^22 against their float64
     CPU runs; each timed; S4's three entries and S5 against their plain
     versions on the card (1e-4 x max) at T = 2^12 (S5: 256 lanes x 2^12,
     order 16), timed over a CUDA graph beside their plain versions and
     bounds; S4's three chunk-and-join entries against their chunked plain
     versions at T = 2^12 and at the main paths' 2^20 (forward, backward)
     and 2^22 (LTI): 1e-5, 1e-5 and 1e-6 x max.  S4 and S5's launches on
     these paths are the kernels' line's;
 40. ROADMAP item 13a (item13a_phases) at the TPU sweep's rows
     (bench_all.py:600-796), each timed by CUDA events (ms a call, the
     host's enqueue), with the profiler's device busy time and the idle
     share, its rate in the sweep's units, and checked: LDPC 648 (512
     frames, 25 iterations) and polar (256, 128) BP (2048 frames, 15
     iterations) bit-equal to their CPU runs and decoding every frame;
     the QAM-64 soft demapper (2^21 symbols), the ZC-127 preamble
     correlation (2^22), the K=7, Q=3 memory polynomial (2^22), ICF (4
     iterations, 2^22) and the 32-tap block RLS (2^20) against their
     float64 CPU runs; turbo (128 x 1024, 6 iterations) through S6's
     fused decode (bcjr_scan.cu, one launch a decode), bit-equal to
     turbo_decode_chunked_torch on the card and within S6's gate of the
     plain walks' decode (|dLLR| <= 1e-4 max(1, max|LLR|)), every bit
     back, and 4 x 8192 (above the fused decode's shared memory) through
     S6's walk entry, 12 launches, bit-equal to the chunked loop; the walk
     entry on the first walk's rows bit-equal to bcjr_maxlog_chunked_torch
     and within the gate of bcjr_maxlog_plain, timed over a CUDA graph at
     128 rows and one row beside its bound, and the fused decode timed
     the same way; CA-CFAR (2^22, guard 2, train 16) with F7 met:
     thresholds within 1e-5 of float64, detections float64's except
     within that of the threshold.  S6's launches on the two turbo paths
     are the kernels' line's;
 41. ROADMAP item 13b (item13b_phases) at the sizes of the standards its
     modules implement, each timed and checked like phase 40: the
     Viterbi walk through S7 (viterbi_scan.cu, the chunked walk) at 1024
     rows of a 64-byte packet (550 steps, soft, K = 7, Eb/N0 4 dB), one
     such row and 64 rows of a CCSDS frame (8166 steps), bits and final
     path metrics equal to its plain walk and to viterbi_chunked_torch on
     the card (all rows; 4 of the CCSDS rows), each timed by a CUDA graph
     beside the sequential kernel's recorded time, its bound, its chunk
     plan, its re-walked chunks and re-traced pieces, BER <= 1e-4, a
     CCSDSLink(4) frame at 2.8 dB; RS(255, 223) over 4096 codewords with
     1-16 byte errors in one in eight, all corrected; CRC-32 of 2^20 bits
     equal to binascii.crc32; Golay(24, 12) and Hamming(7, 4) over 2^20
     bits with errors within their radius, all corrected; ber_sweep (QPSK,
     2^20 bits x 8 points) within the binomial 99.9% interval of
     ber_theory; the packets command on a recording of 256 QPSK bursts
     of 64 bytes (conv FEC, Es/N0 12 dB), every CRC passing, one S7
     launch a burst (the kernels' line's launches), bursts/s by the
     host's clock; 64 OFDMModem bursts through multipath, CFO and AWGN;
     mmse_detect (2^20) and ml_detect (QPSK, 2^16) against complex128 on
     their first 2^12; MUSIC on a 16-antenna ULA (2^14 snapshots) within
     0.1 degrees of complex128.
 42. ROADMAP item 13c (item13c_phases): CVSD over 1024 lanes x 2^16
     samples (1 s of 1024 Bluetooth SCO voice channels at 64 kbit/s, a
     two-tone at 4x oversampling) through S8, one encode call (one
     launch) and one decode call (five launches: the chunk-and-join's
     three passes and two joins), in-band SNR > 20 dB on three lanes
     (tests/test_cvsd.py:59); over 1024 x 2^12 on the card the bits
     bit-equal to the plain walk and the trajectory bit-equal to
     cvsd_decode_chunked_torch and within CHUNKED_ATOL (1e-6) of the
     walk; the main path's own trajectory on 16 lanes at the full 2^16
     (the joins composing runs of 4 chunks) bit-equal to
     cvsd_decode_chunked_torch; against a float64 numpy walk on 4 lanes
     (bits agreeing on 99.9 %, its decode of S8's bits within 1e-5); each
     decode kernel's time (profiler, retried while a kernel shows fewer
     records than its launches, a short count flagged); the Gardner loop
     on a
     2^22-sample RRC QPSK stream (sps 8, offset 0.4) through S9: SER 0
     after lock, F8's gate (the EVM of the last 8000 symbols within 2 dB
     of that near sample 2^17), bit-equal to the plain walk over 2^12
     symbols; symbol_sync_block on 2^20 (SER < 1e-3); the CLI's tx --mod
     fm over 2^22 message samples read back by rx (correlation > 0.95,
     tests/test_tx_chain.py:26) and tx --mod qam --order 16 (95 % of the
     power in band; rx --demod none, the matched filter and a slicer: SER
     <= 1e-3); adsb's decode on 1024 DF17 frames at 2 Msps (every frame
     found at its true preamble passes its CRC, >= 99 % of the ICAOs back,
     the same rows as its CPU run) and the adsb command on the first 256
     (its frame limit), the same rows as the library; ais on 256 GMSK
     bursts, every CRC passing; AM, SSB, GMSK (both receivers), 4-FSK,
     CSS (SF 9), DSSS (Gold 31), FHSS, CW and the burst detector, each a
     round trip at 2^22 samples checked and timed like phase 41.  S8's and
     S9's launches on these paths are the kernels' line's.
 43. ROADMAP items 13c's rest, 13d and 14's fault.py (protocol_phases):
     (a) 4 x 2^24 IQ (36.8 s) of a 1.824 Msps capture holding a stereo FM
     station with RDS (PI/PS groups repeated) at +250 kHz, 30 dB CNR,
     through config 4's chain tuned to it, fm_stereo_decode (75 us) and
     rds_receive: PI and PS exact, >= 99 % of the whole groups sent
     decoded, the group list equal to the plain chain's, the separation
     >= 12 dB; (b) 4 x 2^24 IQ of a 2.4576 Msps capture holding 16 POCSAG
     pages (CPFSK 1200 baud, +-4.5 kHz) at +300 kHz, through the chain at
     M = 64, 256 taps, demod "none" (the body, K2) and pocsag_receive:
     every page exact, equal to the plain chain's; (c) 1024 DTMF digits
     at 20 dB SNR decoded exactly; (d) signal_moments over (1536, 4096)
     bursts (five classes and noise, 15 dB, random phase and gain), the
     labels equal to the CPU run's, the JAX tests' own bursts right and
     >= 90 % a class over 32 bursts of their 100k symbols; (e) the
     sounder (ZC 255, cp 64, 64 repeats) through an EVA channel: the
     strong taps significant, the PDP within 1 dB, the CIR within 1e-4 of
     its CPU run; (f) MetricsCollector over (a)'s blocks (rssi_db of the
     state's gain, outputs equal), benchmark() within 10 % of CUDA
     events, trace() holding K1's records, roofline against the card;
     (g) a worker (tests/torch_fault_worker.py) running the chain over 8
     x 2^20 on the card with a CheckpointManager, killed before block 4
     and relaunched by run_supervised: bit-identical to an uninterrupted
     run, no kernel rebuilt; save/load_distributed at world size 1.  K1's,
     K2's and S3's launches on (a), (b) and (f) are the kernels' line's.

A "[time]" line after each group of phases gives the script's elapsed
time.  Then the kernels' JSON line (each kernel's launches on the main paths; its
time, by CUDA events over a CUDA graph of 20 launches so that the host's
launch rate is not counted (K5 over back-to-back launches); its plain
version's time, the library call's where one PyTorch call computes the
same function, and its bound: the larger of its bytes over 3.35 TB/s and
its operations over the peak of their type), the nvidia-smi
line and, last, {"ok": true, "device": {...}}.  Any failed phase exits
non-zero.  Needs one CUDA GPU; imports neither jax nor solid_dsp_tpu.
"""

from __future__ import annotations

import contextlib
import io
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

# phase 38: the CLI, the runtime and composition on recordings
L_REC = 1 << 26           # ~28 s of a 2.4 Msps broadcast-FM capture, 256 MB
REC_TAIL = 3001           # its ragged end: the last block, which the CLI
#                           cuts to 3000 samples, takes K3
FS_REC = 2.4e6            # the capture's sample rate (Hz)
L_REC_SMALL = 1 << 24     # the am, qpsk, stereo, convert and resample inputs
RX_BLOCKS = (1 << 20, 1 << 24)   # rx's default --block, and config 4's
MON_BLOCK = 1 << 22       # monitor's --block at config 5's M = 256
MON_CHANNELS = 256
MON_BURSTS = ((64, 1, 4), (160, 5, 8), (200, 3, 6))   # (channel, on, off):
#                           from the middle of block `on` to that of `off`
BURST_AMP = 0.01
REC_NOISE = 1e-3
MSG_CORR_MIN = 0.8        # tests/test_cli.py:37-38
CLI_SEPARATION_MIN_DB = 12.0   # tests/test_cli.py:221-227
CLI_PEAK_DB_ATOL = 0.1    # F2: an event's peak at another cutting of blocks
UDP_SECONDS = 2.0
UDP_DATAGRAM = 1024       # ci16 samples a datagram
# phase 39 (item 11): the TPU sweep's sizes (bench_all.py)
T_LTI = 1 << 22           # kalman_lti_chunked_2state (:734-751)
T_KF = 1 << 20            # kalman_apply and rts_smooth
T_S4_TIMED = 1 << 12      # S4 and its plain versions timed side by side
L_WAVELET = 1 << 21       # wavelet_denoise_db4_l4 (:777-788)
ZOOM_ROWS, ZOOM_N, ZOOM_M = 256, 1 << 14, 1024   # zoom_fft_16k_to_1k_x256
L_CYCLO, CYCLO_ALPHAS = 1 << 20, 64              # cyclo_scan_64alpha
CYCLO_CHECKED = 8         # of the alphas also run in complex128 on the CPU
LPC_FRAMES, LPC_N, LPC_ORDER = 256, 1 << 14, 16
T_S5_TIMED = 1 << 12      # S5 and its plain version timed (256 lanes, p 16)
T_S5_LONG, S5_ORDER = 1 << 20, 64
TRIG_SHAPE = (4096, 1024)
L_ADC = 1 << 24           # config 4's block
L_EST = 1 << 20
L_MEAS, MEAS_NFFT = 1 << 22, 4096
S4_RTOL = 1e-4            # float32 against the float64 walk, x max|ref|
S4_LTI_RTOL = 1e-6        # S4's LTI entry against lti_chunked_torch, x max
S4_RTS_RTOL = 1e-5        # its backward entry against the chunked plain version
S4_FWD_RTOL = 1e-5        # its forward entry against the chunked plain version
# the one-thread entries these replaced, as this phase timed them on an
# NVIDIA H100 80GB HBM3 at 700 W: ms at T_S4_TIMED, and on the main path
# (AlphaBetaTracker "scan" over 2^22; rts_smooth over 2^20, both passes
# one-thread; kalman_apply over 2^20); and rts_smooth over 2^20 with the
# one-thread forward entry before the backward one
ONE_THREAD_MS = {"kalman_lti": (0.0987, 100.06), "rts_backward": (0.9246,
                                                                   378.40),
                 "kalman_filter": (0.5697, 113.28)}
ONE_THREAD_FORWARD_RTS_MS = 143.87
S5_RTOL = 1e-4
LPC_K_ATOL = 1e-3         # reflection coefficients, float32 vs float64
TRIG_RTOL = 1e-5          # full float32 products (TF32 keeps ~1e-3)
CZT_RTOL = 1e-4           # complex64 Bluestein, x max|ref|
CYCLO_ATOL = 1e-3         # coherence in [0, 1]
WAVELET_PR_ATOL = 1e-4    # tests/test_wavelet.py:48 (multilevel, float32)
DENOISE_RTOL = 1e-4
CODEC_MISMATCH = 1e-6     # codes off a chord boundary's rounding, a fraction
SYMBOL_RATE_ATOL = 2e-4   # tests/test_cyclo.py:66-82
EST_F_ATOL = 1e-6         # cycles a sample, float32 vs float64
MEAS_DB_ATOL = 0.01
SINAD_DB_ATOL = 0.1
# phase 40: item 13a at the TPU sweep's rows (bench_all.py:600-796)
LDPC_FRAMES = 512
L_DEMAP = 1 << 21
L_PREAMBLE = 1 << 22
POLAR_FRAMES = 2048
TURBO_ROWS, TURBO_K = 128, 1024
TURBO_LONG_ROWS, TURBO_LONG_K = 4, 8192   # above the fused decode's budget
L_TX = 1 << 22            # dpd_mp_apply_k7q3, cfr_icf_4iter
L_RLS = 1 << 20
L_CFAR = 1 << 22
L_LOCAL_F64 = 1 << 18     # a local function's float64 check: its first samples
S6_RTOL = 1e-4            # x max(1, max|LLR|): chunks vs radix-8 blocks
TX_RTOL = 1e-4            # x max|ref|: complex64 against complex128
RLS_RTOL = 1e-3           # complex64 normal equations over 2^20 samples
F7_RTOL = 1e-5            # CA-CFAR thresholds against float64

# phase 41: item 13b at the sizes of the standards it implements
VIT_ROWS = 1024           # packet rows: 64 bytes + CRC-32 = 544 bits
VIT_BITS = 544
VIT_BER = 1e-4            # K = 7 soft at Eb/N0 = 4 dB (~1e-5 expected)
CCSDS_ROWS = 64           # 4 x 255 bytes + 6 tail = 8166 steps a row
CCSDS_PLAIN = 4
# S7 as a sequential kernel (one warp walking a whole row; NVIDIA H100 80GB
# HBM3, 700 W, CUDA graph): ms a call at (rows, steps), a recorded figure
# and not a measurement of the run, printed beside the chunked walk's and
# kept out of the kernels line
S7_SEQUENTIAL_MS = {(1024, 550): 0.0663, (64, 8166): 0.7668, (1, 550): 0.0532}
RS_WORDS = 4096
L_BITS = 1 << 20
N_BURSTS = 256
N_OFDM = 64
L_MIMO = 1 << 20
L_ML = 1 << 16
L_CHECK = 1 << 12
MIMO_RTOL = 1e-4          # complex64 solves of the loaded normal equations
ML_MAX_DIFF = 2           # of 4096 vectors: a float32 near-tie at most
L_SNAP = 1 << 14
MUSIC_DOAS = (-20.3, 31.7)
DOA_ATOL = 0.1            # degrees
CVSD_LANES = 1024          # Bluetooth SCO voice channels
CVSD_N = 1 << 16          # 1 s at 64 kbit/s
CVSD_FS = 64000.0
CVSD_PLAIN_N = 1 << 12    # S8 against its plain walk: the timed shape
CVSD_F64_LANES = 4
CVSD_FULL_LANES = 16      # the main path's decode against its plain version
CVSD_MIN_SNR_DB = 20.0    # tests/test_cvsd.py:59
CVSD_ATOL = 1e-5          # tests/test_cvsd.py:47
CVSD_F64_AGREE = 0.999    # bits equal to the float64 walk's (float32 ties)
L_GARDNER = 1 << 22
GARDNER_SPS = 8
GARDNER_TAU = 0.4
GARDNER_BW = 0.01
GARDNER_PLAIN = 1 << 12   # symbols of S9 against its plain walk
F8_EVM_DB = 2.0           # the last symbols' EVM within this of sample 2^17's
L_TX_MSG = 1 << 22
TX_CORR_MIN = 0.95        # tests/test_tx_chain.py:26-48
QAM_INBAND_MIN = 0.95     # tests/test_tx_chain.py:51-62
N_ADSB = 1024
ADSB_CLI_FRAMES = 256     # the adsb command's frame limit (JAX's decode)
ADSB_MIN_FOUND = 0.99
N_AIS = 256
L_MODEM = 1 << 22
FS_BCAST = 1.824e6        # a broadcast-FM capture: 4 x the 456 kHz MPX rate
STATION_HZ = 250e3        # the station's offset in it
L43 = 1 << 24             # phase 43's blocks (config 4's)
N43 = 4                   # 4 x 2^24 = 36.8 s of broadcast
RDS_PI, RDS_PS = 0x52A1, "SOLIDDSP"
RDS_MIN_GROUPS = 0.99     # of the whole groups sent
FS_PAGER = 2.4576e6       # a pager capture: 64 x the 38.4 kHz channel rate
PAGER_HZ = 300e3
PAGER_M, PAGER_TAPS, PAGER_CUTOFF = 64, 256, 0.005
PAGER_SPS = 32            # 1200 baud at 38.4 kHz
N_PAGES = 16
N_DTMF = 1024             # digits, 80 ms tones and gaps at 8 kHz
MOD_BURSTS, MOD_SYMBOLS = 256, 4096
SOUNDER_REPEATS = 64
CIR_RTOL = 1e-4           # x max|cir|, the card against its CPU run
PDP_DB_ATOL = 1.0
BENCH_RTOL = 0.10         # benchmark() against the block's CUDA-event time
TRACE_BLOCKS = 10         # config-4 blocks inside trace()
MOD_MIN_ACC = 0.9         # a class, 32 random bursts of 100k symbols
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


def profiled_rows(fn, n: int = 10) -> list:
    """[(device ms a call, kernel name, records)] of fn()'s kernels, largest
    first, from torch.profiler: the kernels' rows only (an op's row repeats
    the time of the kernels it launched).  The device tracer misses the
    first records after it starts (7, 9 or 0 of 10 kernels seen), so n
    calls run in a warm-up step and n in the recorded one; a kernel's time a
    call is still its mean record times its records a call, rounded, in
    case one drops.  The step's own row (ProfilerStep*) spans the step, not
    a kernel."""
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
    return sorted(((e.self_device_time_total / 1e3 / e.count
                    * max(1, round(e.count / n)), e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.count
                   and not e.key.startswith("ProfilerStep")),
                  reverse=True)


def profiled_busy(fn, n: int = 10):
    """(device ms a call, its three largest kernels as text), from
    profiled_rows."""
    rows = profiled_rows(fn, n)
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


def fm_recording(dev, n: int):
    """The phase-38 recording: a broadcast stereo multiplex (L 700 Hz, R
    2100 Hz, fm_stereo_mpx at the demodulated rate FS_REC / 4, held for 4
    samples), FM-modulated with kf 0.1 at 0.9 of full deviation onto the
    carrier 0.2 rad/sample, at amplitude 0.5; the MON_BURSTS tones of
    BURST_AMP at their channels' centres; complex noise of REC_NOISE.
    Built on the card in float64.  Returns (the complex64 samples on the
    host, the normalized multiplex at FS_REC / 4 on the host)."""
    from solid_dsp_tpu_torch.models.fm import fm_modulate, fm_stereo_mpx
    nd = -(-n // 4)
    t = torch.arange(nd, device=dev, dtype=torch.float64) / (FS_REC / 4)
    mpx = fm_stereo_mpx(torch.sin(2 * np.pi * 700.0 * t).float(),
                        torch.sin(2 * np.pi * 2100.0 * t).float(),
                        FS_REC / 4).double()
    mpx = 0.9 * mpx / mpx.abs().max()
    iq, _ = fm_modulate(mpx.repeat_interleave(4)[:n], 0.1)
    k = torch.arange(n, device=dev, dtype=torch.float64)
    iq = 0.5 * iq * torch.exp(1j * (0.2 * k))
    for c, on, off in MON_BURSTS:
        s0, s1 = int((on + 0.5) * MON_BLOCK), int((off + 0.5) * MON_BLOCK)
        iq[s0:s1] += BURST_AMP * torch.exp(
            2j * np.pi * (c / MON_CHANNELS) * k[s0:s1])
    g = torch.Generator(device=dev).manual_seed(SEED + 38)
    w = torch.randn((2, n), generator=g, device=dev, dtype=torch.float64)
    iq += REC_NOISE * torch.complex(w[0], w[1])
    return iq.to(torch.complex64).cpu().numpy(), mpx.cpu().numpy()


def best_corr(y: np.ndarray, ref: np.ndarray, start: int = 1000,
              n: int = 1 << 20, max_lag: int = 40) -> float:
    """Largest correlation of y[start:start + n] with ref delayed by 0 to
    max_lag samples (the decimating filter's group delay)."""
    n = min(n, len(y) - start)
    a = y[start:start + n].astype(np.float64)
    return max(float(np.corrcoef(a, ref[start - d:start - d + n])[0, 1])
               for d in range(max_lag))


def cli_counters():
    """{name: (wrapper, attribute)} of the kernels the CLI and compose
    paths reach."""
    from solid_dsp_tpu_torch.ops import cuda_chan, cuda_ddc, cuda_scan
    return {"ddc_fm": (cuda_ddc.ddc_fm_cuda, "launches"),
            "ddc_body": (cuda_ddc.ddc_body_cuda, "launches"),
            "ddc_body_unaligned": (cuda_ddc.ddc_body_unaligned_cuda,
                                   "launches"),
            "channelizer": (cuda_chan.chan_fused_cuda, "launches"),
            "agc_scan": (cuda_scan.agc_scan_cuda, "launches"),
            "iir_scan": (cuda_scan.iir_scan_cuda, "launches"),
            "sos_cascade": (cuda_scan.sos_cascade_cuda, "launches")}


def reset_cli_counts():
    for fn, attr in cli_counters().values():
        setattr(fn, attr, 0)


def read_cli_counts() -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in cli_counters().items()}


def run_cli(cli_main, argv) -> tuple:
    """(exit code, its standard output, wall s) of the CLI's main(argv) in
    this process; the wall ends with a synchronize."""
    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    torch.cuda.synchronize()
    return rc, out.getvalue(), time.perf_counter() - t0


def cli_profiled(cli_main, argv, warm_argv) -> dict:
    """The CLI's main(argv) under torch.profiler (after warm_argv in the
    warm-up step), the host's time in StreamPump.next_block ("pump") and in
    write_iq ("write") summed by wrappers that only read the clock, and the
    device's records split into host-to-device copies, device-to-host
    copies and kernels (ms, summed over the run)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from solid_dsp_tpu_torch import runtime
    spans = {"pump": 0.0, "write": 0.0}
    next_block, write_iq = runtime.StreamPump.next_block, runtime.write_iq

    def timed_next(self):
        t = time.perf_counter()
        try:
            return next_block(self)
        finally:
            spans["pump"] += time.perf_counter() - t

    def timed_write(*a, **k):
        t = time.perf_counter()
        try:
            return write_iq(*a, **k)
        finally:
            spans["write"] += time.perf_counter() - t

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        run_cli(cli_main, warm_argv)
        prof.step()
        runtime.StreamPump.next_block = timed_next
        runtime.write_iq = timed_write
        try:
            rc, _, wall = run_cli(cli_main, argv)
        finally:
            runtime.StreamPump.next_block = next_block
            runtime.write_iq = write_iq
        prof.step()
    if rc != 0:
        fail(f"phase 38: {' '.join(argv[:1])} under the profiler returned "
             f"{rc}")
    dev_ms = {"h2d": 0.0, "d2h": 0.0, "kernels": 0.0}
    top = []
    for e in prof.key_averages():
        if (e.device_type != DeviceType.CUDA or not e.count
                or e.key.startswith("ProfilerStep")):
            continue
        ms = e.self_device_time_total / 1e3
        if e.key.startswith("Memcpy HtoD"):
            dev_ms["h2d"] += ms
        elif e.key.startswith("Memcpy DtoH"):
            dev_ms["d2h"] += ms
        else:
            dev_ms["kernels"] += ms
            top.append((ms, e.key, e.count))
    top = ", ".join(f"{k[:40]} {t:.3f} ms ({c})"
                    for t, k, c in sorted(top, reverse=True)[:3])
    return {"wall": wall, **spans, **dev_ms, "top": top}


def split_line(label: str, n_samples: int, n_blocks: int, wall_s: float,
               prof: dict, smi: str) -> str:
    """The file-to-file rate and the split of a block."""
    busy = prof["kernels"] + prof["h2d"] + prof["d2h"]
    pw = prof["wall"] * 1e3
    return (f"[38 {label}] {n_samples / wall_s / 1e6:.1f} Msamples/s file "
            f"to file ({n_samples} samples in {wall_s:.3f} s, {n_blocks} "
            f"blocks); a block (profiled run, {pw / n_blocks:.3f} ms): pump "
            f"wait {prof['pump'] * 1e3 / n_blocks:.3f} ms, H2D copy "
            f"{prof['h2d'] / n_blocks:.3f} ms, device busy (kernels) "
            f"{prof['kernels'] / n_blocks:.3f} ms, D2H copy "
            f"{prof['d2h'] / n_blocks:.3f} ms, write "
            f"{prof['write'] * 1e3 / n_blocks:.3f} ms; device idle "
            f"{max(0.0, 1 - prof['kernels'] / pw):.1%} (no kernel), "
            f"{max(0.0, 1 - busy / pw):.1%} (no kernel and no copy); "
            f"largest kernels: {prof['top']} | {smi}")


def fm_band(c: int) -> bool:
    """Whether channel c lies in the FM signal's band (the carrier's
    channel +- 0.1 cycles/sample and a margin)."""
    centre = 0.2 / (2 * np.pi) * MON_CHANNELS
    off = (c - centre + MON_CHANNELS / 2) % MON_CHANNELS - MON_CHANNELS / 2
    return abs(off) <= 0.1 * MON_CHANNELS + 8


UDP_SENDER = """
import socket, sys, time
rec, n, port, dg, fs = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \\
    int(sys.argv[4]), float(sys.argv[5])
with open(rec, "rb") as f:
    raw = f.read(4 * n)
tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
late, t0 = 0.0, time.perf_counter()
for i in range(n // dg):
    due = t0 + i * dg / fs
    now = time.perf_counter()
    if now < due:
        time.sleep(due - now)
    else:
        late = max(late, now - due)
    tx.sendto(raw[4 * dg * i:4 * dg * (i + 1)], ("127.0.0.1", port))
print(f"{time.perf_counter() - t0:.6f} {late:.6f}")
"""


def udp_phase(dev, rec: str, mpx: np.ndarray, smi: str):
    """38 (vi): the recording's first UDP_SECONDS as ci16 datagrams paced at
    FS_REC from a sender process (its own interpreter, so that this one's
    work cannot hold it back into bursts) to a UdpSource on localhost, each
    drained block through RxChain on the card (the remainder of 4
    carried)."""
    import socket

    from solid_dsp_tpu_torch.models.rx_chain import RxChain
    from solid_dsp_tpu_torch.runtime import UdpSource

    n = int(UDP_SECONDS * FS_REC) // UDP_DATAGRAM * UDP_DATAGRAM
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    chain = RxChain(carrier_freq=0.2, decimation=4, fir_taps=64, demod="fm",
                    nco_mode="exact", agc_mode="block", device=dev)
    outs, got, carry, blocks = [], 0, np.zeros(0, np.complex64), 0
    with UdpSource(port=port, fmt="ci16", bind_addr="127.0.0.1",
                   ring_samples=1 << 22) as src:
        t0 = time.perf_counter()
        sender = subprocess.Popen(
            [sys.executable, "-c", UDP_SENDER, rec, str(n), str(port),
             str(UDP_DATAGRAM), str(FS_REC)], stdout=subprocess.PIPE,
            text=True)
        try:
            idle_since = None
            while got < n:
                b = src.read(1 << 18)
                if not len(b):
                    now = time.perf_counter()
                    if sender.poll() is not None:
                        # the sender is done: whatever is still to come
                        # is in the socket or the ring within a moment
                        idle_since = idle_since or now
                        if now - idle_since > 0.5:
                            break
                    elif now - t0 > UDP_SECONDS + 30.0:
                        break
                    time.sleep(0.002)
                    continue
                idle_since = None
                got += len(b)
                b = np.concatenate([carry, b])
                take = len(b) // 4 * 4
                carry = b[take:]
                if take:
                    outs.append(chain.execute_block(b[:take]).cpu().numpy())
                    blocks += 1
            wall = time.perf_counter() - t0
            out, _ = sender.communicate(timeout=30)
        finally:
            if sender.poll() is None:
                sender.kill()
                sender.wait()
        dropped = src.dropped
    send_s, late = (float(v) for v in out.split()) if out.strip() else (
        0.0, 0.0)
    y = np.concatenate(outs) if outs else np.zeros(0, np.float32)
    corr = best_corr(y, mpx, n=min(len(y) - 1100, 1 << 18)) if len(y) > 4096 \
        else 0.0
    ok = (dropped == 0 and got == n and sender.returncode == 0
          and corr > MSG_CORR_MIN and np.all(np.isfinite(y)))
    print(f"[38 vi UdpSource -> RxChain on the card] {got} of {n} samples "
          f"({UDP_SECONDS} s of ci16 at {FS_REC / 1e6} Msps, datagrams of "
          f"{UDP_DATAGRAM}) in {blocks} blocks, sender process {send_s:.3f} "
          f"s (latest {late * 1e3:.2f} ms behind), dropped {dropped} (gate "
          f"0), message correlation {corr:.4f} (gate {MSG_CORR_MIN}), "
          f"{got / wall / 1e6:.2f} Msamples/s received | {smi}", flush=True)
    if not ok:
        fail("phase 38 (vi): the UDP stream into the chain lost samples or "
             "the message")


def cli_phases(dev, smi) -> dict:
    """Phase 38: the port's own CLI (``solid_dsp_tpu_torch.__main__.main``,
    in this process), its native runtime and chain composition on
    recordings written to a temporary directory: rx at two block sizes
    (against RxChain on the card bit for bit and against the plain body),
    am, qpsk, --wav --stereo, monitor --backend fused (and F2's block),
    demo, spectrum, convert, resample; StreamPump's read rate; a UdpSource
    into RxChain; the config-4 stages composed, and with the exact AGC and
    an IIR stage.  Returns the kernels' launches on these paths."""
    import tempfile

    from solid_dsp_tpu_torch.__main__ import main as cli_main
    from solid_dsp_tpu_torch.models.rx_chain import RxChain, RxChainConfig
    from solid_dsp_tpu_torch.runtime import StreamPump, read_iq, write_iq
    from solid_dsp_tpu_torch.streaming.compose import (
        compose, stage_agc, stage_fir_decim, stage_fm_demod, stage_iir,
        stage_nco_mix_down)

    counts = dict.fromkeys(cli_counters(), 0)

    def add(c):
        for k, v in c.items():
            counts[k] += v

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        n_rec = L_REC + REC_TAIL
        t = time.perf_counter()
        x, mpx = fm_recording(dev, n_rec)
        rec = os.path.join(tmp, "capture.ci16")
        write_iq(rec, x, "ci16")
        print(f"[38 recording] {n_rec} samples ci16 "
              f"({os.path.getsize(rec) / 2**20:.1f} MiB) written in "
              f"{time.perf_counter() - t:.2f} s", flush=True)
        small = os.path.join(tmp, "small.ci16")
        write_iq(small, x[:L_REC_SMALL], "ci16")
        tiny = os.path.join(tmp, "tiny.ci16")          # warm-up runs
        write_iq(tiny, x[:1 << 16], "ci16")
        del x

        # (vi, first) StreamPump alone, page cache warm
        for _ in range(2):
            t = time.perf_counter()
            nread = 0
            with StreamPump(rec, fmt="ci16", block=1 << 20) as pump:
                for b in pump:
                    nread += len(b)
            pump_s = time.perf_counter() - t
        print(f"[38 vi StreamPump, ci16 -> complex64, blocks of 2^20] "
              f"{os.path.getsize(rec) / pump_s / 1e9:.2f} GB/s read, "
              f"{nread / pump_s / 1e6:.1f} Msamples/s converted "
              f"({nread} samples, page cache warm) | {smi}", flush=True)
        if nread != n_rec:
            fail("phase 38: StreamPump read the wrong number of samples")

        # (ii) rx at the CLI's default block and at config 4's
        rec_c = read_iq(rec, "ci16")
        n_used = n_rec - n_rec % 4
        for B in RX_BLOCKS:
            out = os.path.join(tmp, f"rx_{B}.cf32")
            argv = ["rx", rec, "--format", "ci16", "--block", str(B),
                    "-o", out]
            run_cli(cli_main, ["rx", tiny, "--format", "ci16", "-o",
                               os.path.join(tmp, "warm.cf32")])
            reset_cli_counts()
            rc, _, wall = run_cli(cli_main, argv)
            c = read_cli_counts()
            add(c)
            y = read_iq(out)
            rc2, _, wall2 = run_cli(cli_main, argv)      # a second turn
            n_blocks = -(-n_rec // B)
            want_k1 = n_rec // B                      # whole blocks: K1
            direct = {}
            for engine in ("auto", "torch"):
                chain = RxChain(carrier_freq=0.2, decimation=4, fir_taps=64,
                                demod="fm", nco_mode="exact",
                                agc_mode="block", device=dev,
                                ddc_engine=engine)
                outs = []
                for i in range(0, n_rec, B):
                    b = rec_c[i:i + B]
                    b = b[:len(b) - len(b) % 4]
                    outs.append(chain.execute_block(b).cpu().numpy())
                direct[engine] = np.concatenate(outs)
            equal = (y.shape == (n_used // 4,) and np.all(y.imag == 0)
                     and np.array_equal(y.real, direct["auto"]))
            snr = snr_db(y.real, direct["torch"])
            corr = best_corr(y.real, mpx)
            prof = cli_profiled(cli_main, argv,
                                ["rx", tiny, "--format", "ci16", "-o",
                                 os.path.join(tmp, "warm.cf32")])
            print(f"[38 ii rx --block {B}] rc {rc}, {len(y)} outputs, "
                  f"bit-equal to RxChain(device='cuda') on the same blocks "
                  f"{equal}, {snr:.1f} dB against the plain body (gate "
                  f"{MIN_SNR_DB}), message correlation {corr:.4f} (gate "
                  f"{MSG_CORR_MIN}), launches K1 {c['ddc_fm']} (want "
                  f"{want_k1}), K3 {c['ddc_body_unaligned']}, K2 "
                  f"{c['ddc_body']}", flush=True)
            print(split_line(f"rx --block {B}, ci16 -> FM -> cf32", n_used,
                             n_blocks, wall, prof, smi)
                  + f"; second turn {n_used / wall2 / 1e6:.1f} Msamples/s",
                  flush=True)
            if not (rc == rc2 == 0 and equal and snr >= MIN_SNR_DB
                    and corr > MSG_CORR_MIN and c["ddc_fm"] == want_k1
                    and c["ddc_body_unaligned"] == 1 and c["ddc_body"] == 0
                    and np.all(np.isfinite(y.real))):
                fail(f"phase 38 (ii): rx --block {B} is wrong")
        del rec_c

        # (ii) am and qpsk on 2^24 samples
        rng = np.random.default_rng(SEED + 381)
        am = make_am_block(rng, 0, L_REC_SMALL)
        sym = qpsk_symbols(1, L_REC_SMALL)
        qp = make_qpsk_block(rng, sym, 0, L_REC_SMALL)
        for demod, planes in (("am", am), ("qpsk", qp)):
            src = os.path.join(tmp, f"{demod}.ci16")
            write_iq(src, (planes[0] + 1j * planes[1]).astype(np.complex64),
                     "ci16")
            out = os.path.join(tmp, f"{demod}.cf32")
            reset_cli_counts()
            rc, _, wall = run_cli(cli_main, ["rx", src, "--format", "ci16",
                                             "--demod", demod, "-o", out])
            c = read_cli_counts()
            add(c)
            y = read_iq(out)
            T = L_REC_SMALL // 4
            if demod == "am":
                env = y.real[T // 2:].astype(np.float64)
                peak = int(np.argmax(np.abs(np.fft.rfft(env - env.mean()))
                                     [1:])) + 1
                want = round(AM_TONE * 4 * len(env))
                ok = abs(peak - want) <= 1
                what = f"tone at bin {peak} want {want}"
            else:
                # per block of the CLI's 2^20 samples: each block has its
                # own carrier estimate and pi/2 ambiguity (as phase 9)
                Tb = (1 << 20) // 4
                sers = []
                for b in range(4):
                    q = y[b * Tb:(b + 1) * Tb][11::8]
                    sers.append(best_aligned_ser(
                        sym[b * Tb // 8:(b + 1) * Tb // 8],
                        (q.real < 0).astype(int) + 2 * (q.imag < 0)))
                ok = max(sers) < MAX_SER
                what = (f"SER of blocks 0-3 {[round(s, 6) for s in sers]} "
                        f"(gate {MAX_SER})")
            print(f"[38 ii rx --demod {demod}, 2^24 samples] rc {rc}, "
                  f"{len(y)} outputs, {what}, launches K2 {c['ddc_body']}, "
                  f"K1 {c['ddc_fm']}, {L_REC_SMALL / wall / 1e6:.1f} "
                  f"Msamples/s file to file | {smi}", flush=True)
            if not (rc == 0 and ok and c["ddc_body"] == L_REC_SMALL >> 20
                    and c["ddc_fm"] == 0 and y.shape == (T,)):
                fail(f"phase 38 (ii): rx --demod {demod} is wrong")

        # (iii) rx --wav --stereo on 2^24 samples
        wav = os.path.join(tmp, "stereo.wav")
        reset_cli_counts()
        rc, _, wall = run_cli(cli_main, ["rx", small, "--format", "ci16",
                                         "--wav", wav, "--rate", str(FS_REC),
                                         "--stereo"])
        c = read_cli_counts()
        add(c)
        import wave
        with wave.open(wav, "rb") as w:
            chans, rate = w.getnchannels(), w.getframerate()
            pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
        left, right = pcm[0::2].astype(float), pcm[1::2].astype(float)
        edge = 4800
        sep_l = 10 * np.log10(tone_power(left, 700.0, 48000.0, edge)
                              / tone_power(left, 2100.0, 48000.0, edge))
        sep_r = 10 * np.log10(tone_power(right, 2100.0, 48000.0, edge)
                              / tone_power(right, 700.0, 48000.0, edge))
        want_frames = round(L_REC_SMALL / FS_REC * 48000)
        s3 = c["iir_scan"] + c["sos_cascade"]
        print(f"[38 iii rx --wav --stereo --rate {FS_REC:.0f}, 2^24 samples]"
              f" rc {rc}, {chans} channels at {rate} Hz, {len(left)} frames "
              f"(~{want_frames}), separation L {sep_l:.1f} dB, R "
              f"{sep_r:.1f} dB (gate {CLI_SEPARATION_MIN_DB}), S3 launches "
              f"{s3}, {wall:.3f} s | {smi}", flush=True)
        if not (rc == 0 and chans == 2 and rate == 48000
                and abs(len(left) - want_frames) < 1500
                and sep_l > CLI_SEPARATION_MIN_DB
                and sep_r > CLI_SEPARATION_MIN_DB and s3 > 0):
            fail("phase 38 (iii): the stereo WAV is wrong")

        # (iv) monitor --backend fused, and F2's block
        mon = {}
        for B in (MON_BLOCK, MON_BLOCK + MON_CHANNELS):
            argv = ["monitor", rec, "--format", "ci16", "--channels",
                    str(MON_CHANNELS), "--backend", "fused", "--block",
                    str(B)]
            run_cli(cli_main, ["monitor", tiny, "--format", "ci16",
                               "--channels", str(MON_CHANNELS), "--backend",
                               "fused"])
            reset_cli_counts()
            rc, out, wall = run_cli(cli_main, argv)
            c = read_cli_counts()
            add(c)
            rows = [json.loads(line) for line in out.strip().splitlines()]
            events = [e for e in rows[:-1] if not fm_band(e["channel"])]
            mon[B] = events
            want = sorted((ch, on) for ch, on, _ in MON_BURSTS)
            got = sorted((e["channel"], e["start_block"]) for e in events)
            ends_ok = all(e["end_block"] > dict(
                (ch, off) for ch, _, off in MON_BURSTS)[e["channel"]]
                for e in events if e["channel"] in
                {ch for ch, _, _ in MON_BURSTS})
            n_fm = len(rows) - 1 - len(events)
            print(f"[38 iv monitor --channels {MON_CHANNELS} --backend "
                  f"fused --block {B}] rc {rc}, blocks "
                  f"{rows[-1]['blocks']}, events off the FM band "
                  f"{[(e['channel'], e['start_block'], e['end_block'], e['peak_rel_db']) for e in events]}"
                  f" (want channels and starts {want}), {n_fm} events in "
                  f"the FM band, K4 launches {c['channelizer']}", flush=True)
            if not (rc == 0 and got == want and ends_ok
                    and c["channelizer"] >= L_REC // B):
                fail(f"phase 38 (iv): monitor --block {B} is wrong")
            if B == MON_BLOCK:
                prof = cli_profiled(cli_main, argv,
                                    ["monitor", tiny, "--format", "ci16",
                                     "--channels", str(MON_CHANNELS),
                                     "--backend", "fused"])
                print(split_line(f"monitor --backend fused --block {B}, "
                                 f"256 channels", n_rec,
                                 rows[-1]["blocks"], wall, prof, smi),
                      flush=True)
        same = [(e["channel"], e["start_block"], e["end_block"])
                for e in mon[MON_BLOCK]] == [
            (e["channel"], e["start_block"], e["end_block"])
            for e in mon[MON_BLOCK + MON_CHANNELS]] and all(
            abs(a["peak_rel_db"] - b["peak_rel_db"]) <= CLI_PEAK_DB_ATOL
            for a, b in zip(mon[MON_BLOCK], mon[MON_BLOCK + MON_CHANNELS]))
        print(f"[38 iv F2: --block {MON_BLOCK + MON_CHANNELS}, a multiple of "
              f"{MON_CHANNELS} but not of 8 x {MON_CHANNELS}] runs, events "
              f"equal to --block {MON_BLOCK}'s {same} (peaks within "
              f"{CLI_PEAK_DB_ATOL} dB)", flush=True)
        if not same:
            fail("phase 38 (iv): F2's block changes the events")

        # (v) the small commands
        reset_cli_counts()
        rc, out, wall = run_cli(cli_main, ["demo"])
        c = read_cli_counts()
        add(c)
        s3 = c["iir_scan"] + c["sos_cascade"]
        head = "0.058167695961" in out
        print(f"[38 v demo] rc {rc}, golden head 0.058167695961 {head}, S3 "
              f"launches {s3} | {out.splitlines()[1].strip()}", flush=True)
        if not (rc == 0 and head and s3 > 0):
            fail("phase 38 (v): demo is wrong")
        tone_rec = os.path.join(tmp, "tone.cf32")
        k = np.arange(L_REC_SMALL)
        write_iq(tone_rec, (0.5 * np.exp(2j * np.pi * 0.1 * k)
                            + REC_NOISE * cnoise(rng, L_REC_SMALL)
                            ).astype(np.complex64))
        for nfft, atol, margin in ((4096, 1e-3, 40.0), (1009, 1e-2, 30.0)):
            rc, out, _ = run_cli(cli_main, ["spectrum", tone_rec, "--nfft",
                                            str(nfft)])
            r = json.loads(out)
            ok = (rc == 0 and abs(r["peak_freq"] - 0.1) < atol
                  and r["peak_db"] > r["noise_floor_db"] + margin)
            print(f"[38 v spectrum --nfft {nfft}] {out.strip()} (gates "
                  f"|peak - 0.1| < {atol}, {margin} dB over the floor) "
                  f"{ok}", flush=True)
            if not ok:
                fail(f"phase 38 (v): spectrum --nfft {nfft} is wrong")
        mid = os.path.join(tmp, "mid.cf32")
        back = os.path.join(tmp, "back.ci16")
        t = time.perf_counter()
        rc1, _, _ = run_cli(cli_main, ["convert", small, mid, "--format",
                                       "ci16", "--out-format", "cf32"])
        rc2, _, _ = run_cli(cli_main, ["convert", mid, back, "--format",
                                       "cf32", "--out-format", "ci16"])
        conv_s = time.perf_counter() - t
        with open(small, "rb") as f1, open(back, "rb") as f2:
            same = f1.read() == f2.read()
        print(f"[38 v convert ci16 -> cf32 -> ci16, 2^24 samples] bytes "
              f"identical {same}, {2 * L_REC_SMALL / conv_s / 1e6:.1f} "
              f"Msamples/s over both | {smi}", flush=True)
        if not (rc1 == rc2 == 0 and same):
            fail("phase 38 (v): convert does not round-trip")
        rs_out = os.path.join(tmp, "half.cf32")
        rc, _, wall = run_cli(cli_main, ["resample", tone_rec, rs_out,
                                         "--rate", "0.5"])
        y = read_iq(rs_out)
        seg = y[1 << 16:(1 << 16) + 8192]
        f_out = int(np.argmax(np.abs(np.fft.fft(seg)))) / 8192
        ok = (rc == 0 and len(y) == round(L_REC_SMALL * 0.5)
              and abs(f_out - 0.2) < 2e-3 and np.all(np.isfinite(y)))
        print(f"[38 v resample --rate 0.5, 2^24 samples] rc {rc}, {len(y)} "
              f"outputs (want {round(L_REC_SMALL * 0.5)}), tone at "
              f"{f_out:.5f} want 0.2, {L_REC_SMALL / wall / 1e6:.1f} "
              f"Msamples/s file to file | {smi}", flush=True)
        if not ok:
            fail("phase 38 (v): resample is wrong")

        # (vi) a live UDP stream into the chain
        reset_cli_counts()
        udp_phase(dev, rec, mpx, smi)
        add(read_cli_counts())

        # (vii) compose: the config-4 stages over 4 blocks of 2^24
        blocks = read_iq(rec, "ci16", count=4 * L_FULL).reshape(4, L_FULL)
        cfg = RxChainConfig(carrier_freq=0.2, decimation=4, fir_taps=64,
                            agc_mode="block", demod="fm", nco_mode="exact")
        taps = np.asarray(cfg.design_taps(), np.complex64)
        chain = RxChain(cfg, device=dev)
        want = np.concatenate([chain.execute_block(b).cpu().numpy()
                               for b in blocks])

        def composed(agc_mode, iir):
            stages = [stage_nco_mix_down(0.2, device=dev),
                      stage_fir_decim(taps, 4, device=dev),
                      stage_agc(cfg.agc_bandwidth, mode=agc_mode,
                                device=dev),
                      stage_fm_demod(cfg.fm_kf, device=dev)]
            if iir:
                stages.append(stage_iir([0.2, 0.3, 0.1], [1.0, -0.5],
                                        dtype=torch.float32, method="scan",
                                        device=dev))
            init, apply = compose(*stages)
            st, ys = init(), []
            torch.cuda.synchronize()
            t = time.perf_counter()
            for b in blocks:
                y, st = apply(st, torch.as_tensor(b, device=dev))
                ys.append(y.cpu().numpy())
            return np.concatenate(ys), time.perf_counter() - t

        reset_cli_counts()
        y_blk, s_blk = composed("block", False)
        c_blk = read_cli_counts()
        err = float(np.max(np.abs(y_blk - want)))
        reset_cli_counts()
        y_ex, s_ex = composed("exact", True)
        c = read_cli_counts()
        add(c)
        y_par, _ = composed("parallel", True)
        err_ex = float(np.max(np.abs(y_ex - y_par)))
        print(f"[38 vii compose, config-4 stages, 4 x 2^24 of the recording] "
              f"block AGC against the fused RxChain max |err| {err:.3g} (gate "
              f"1e-05), {4 * L_FULL / s_blk / 1e6:.1f} Msamples/s, kernels "
              f"{sum(c_blk.values())}; with stage_agc('exact') and stage_iir "
              f"(scan): S1 launches {c['agc_scan']}, S3 launches "
              f"{c['iir_scan']}, {4 * L_FULL / s_ex / 1e6:.1f} Msamples/s, "
              f"against stage_agc('parallel') max |err| {err_ex:.3g} (gate "
              f"{S1_RTOL} x max|y| = {S1_RTOL * np.abs(y_par).max():.3g}) "
              f"| {smi}", flush=True)
        if not (err <= 1e-5 and c["agc_scan"] >= 4 and c["iir_scan"] >= 4
                and err_ex <= S1_RTOL * np.abs(y_par).max()
                and np.all(np.isfinite(y_ex))):
            fail("phase 38 (vii): the composed chain is wrong")

    missing = [k for k in ("ddc_fm", "ddc_body", "ddc_body_unaligned",
                           "channelizer", "agc_scan") if not counts[k]]
    if not counts["iir_scan"] + counts["sos_cascade"]:
        missing.append("S3")
    print(f"[38 launches on the CLI, runtime and compose paths] {counts}, "
          f"phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    if missing:
        fail(f"phase 38: {missing} never launched")
    return counts


def kf_walk64(Z, A, C, Q, R, x0, P0):
    """The 2-state, 1-measurement Kalman filter (cv_model's shapes) walked
    in float64 on the CPU as plain Python floats: (X (T, 2), and the
    filtered covariances and the predictions (T, ...) for the RTS pass)."""
    (a00, a01), (a10, a11) = A.tolist()
    c0, c1 = C.ravel().tolist()
    (q00, q01), (q10, q11) = Q.tolist()
    r = float(R.ravel()[0])
    x0_, x1_ = (float(v) for v in x0)
    (p00, p01), (p10, p11) = P0.tolist()
    X, Pf, Xp, Pp = [], [], [], []
    for z in Z.tolist():
        xp0, xp1 = a00 * x0_ + a01 * x1_, a10 * x0_ + a11 * x1_
        ap00, ap01 = a00 * p00 + a01 * p10, a00 * p01 + a01 * p11
        ap10, ap11 = a10 * p00 + a11 * p10, a10 * p01 + a11 * p11
        pp00 = ap00 * a00 + ap01 * a01 + q00
        pp01 = ap00 * a10 + ap01 * a11 + q01
        pp10 = ap10 * a00 + ap11 * a01 + q10
        pp11 = ap10 * a10 + ap11 * a11 + q11
        pc0, pc1 = pp00 * c0 + pp01 * c1, pp10 * c0 + pp11 * c1
        s = c0 * pc0 + c1 * pc1 + r
        k0, k1 = pc0 / s, pc1 / s
        v = z - (c0 * xp0 + c1 * xp1)
        x0_, x1_ = xp0 + k0 * v, xp1 + k1 * v
        i00, i01, i10, i11 = 1 - k0 * c0, -k0 * c1, -k1 * c0, 1 - k1 * c1
        p00, p01 = i00 * pp00 + i01 * pp10, i00 * pp01 + i01 * pp11
        p10, p11 = i10 * pp00 + i11 * pp10, i10 * pp01 + i11 * pp11
        X.append((x0_, x1_))
        Pf.append((p00, p01, p10, p11))
        Xp.append((xp0, xp1))
        Pp.append((pp00, pp01, pp10, pp11))
    return X, Pf, Xp, Pp


def rts_walk64(A, X, Pf, Xp, Pp):
    """The RTS pass over kf_walk64's outputs in float64 Python floats, the
    2 x 2 solve by the adjugate: Xs (T, 2) as an array."""
    (a00, a01), (a10, a11) = A.tolist()
    xs0, xs1 = X[-1]
    s00, s01, s10, s11 = Pf[-1]
    out = [(xs0, xs1)]
    for t in range(len(X) - 2, -1, -1):
        f00, f01, f10, f11 = Pf[t]
        q00, q01, q10, q11 = Pp[t + 1]
        # B = P_f A', G = B (P-)^-1
        b00, b01 = f00 * a00 + f01 * a01, f00 * a10 + f01 * a11
        b10, b11 = f10 * a00 + f11 * a01, f10 * a10 + f11 * a11
        det = q00 * q11 - q01 * q10
        i00, i01, i10, i11 = q11 / det, -q01 / det, -q10 / det, q00 / det
        g00, g01 = b00 * i00 + b01 * i10, b00 * i01 + b01 * i11
        g10, g11 = b10 * i00 + b11 * i10, b10 * i01 + b11 * i11
        d0, d1 = xs0 - Xp[t + 1][0], xs1 - Xp[t + 1][1]
        xs0 = X[t][0] + g00 * d0 + g01 * d1
        xs1 = X[t][1] + g10 * d0 + g11 * d1
        e00, e01, e10, e11 = s00 - q00, s01 - q01, s10 - q10, s11 - q11
        h00, h01 = g00 * e00 + g01 * e10, g00 * e01 + g01 * e11
        h10, h11 = g10 * e00 + g11 * e10, g10 * e01 + g11 * e11
        s00 = f00 + h00 * g00 + h01 * g01
        s01 = f01 + h00 * g10 + h01 * g11
        s10 = f10 + h10 * g00 + h11 * g01
        s11 = f11 + h10 * g10 + h11 * g11
        out.append((xs0, xs1))
    return np.array(out[::-1])


def lti_walk64(F, K, z) -> np.ndarray:
    """x_t = F x_{t-1} + K z_t (2 states, x_{-1} = 0) in float64 Python
    floats."""
    (f00, f01), (f10, f11) = F.tolist()
    k0, k1 = K.ravel().tolist()
    x0_ = x1_ = 0.0
    out = []
    for zt in z.tolist():
        x0_, x1_ = f00 * x0_ + f01 * x1_ + k0 * zt, \
            f10 * x0_ + f11 * x1_ + k1 * zt
        out.append((x0_, x1_))
    return np.array(out)


def rel_err(got, ref) -> float:
    """max |got - ref| over max |ref| (host arrays or tensors)."""
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    ref = ref.detach().cpu().numpy() if torch.is_tensor(ref) else ref
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.max(np.abs(got.astype(ref.dtype) - ref))
                 / max(float(np.max(np.abs(ref))), 1e-300))


def item11_phases(dev, smi) -> list:
    """Phase 39: ROADMAP item 11 on the card at the TPU sweep's sizes (the
    Kalman trackers through S4, LPC through S5, the wavelets, the zoom FFT,
    the cyclostationary scan, the DCT/DST/MDCT, the quantizers and codecs,
    the estimators and the RF measurements), each held to its float64 CPU
    run (or its plain version); S4 and S5 against their plain versions on
    the card and timed.  Returns the kernels' entries of S4 and S5."""
    import importlib

    from solid_dsp_tpu_torch.analysis import cyclo, estimate, measurements
    from solid_dsp_tpu_torch.analysis import snr as snr_ops
    from solid_dsp_tpu_torch.design.firdes import firdes_rrcos
    from solid_dsp_tpu_torch.ops import (cuda_track, czt, kalman, quantize,
                                         trig_transforms, wavelet)
    lpc = importlib.import_module("solid_dsp_tpu_torch.analysis.lpc")

    rng = np.random.default_rng(SEED + 39)
    cpu = torch.device("cpu")
    counters = (cuda_track.kalman_filter_cuda, cuda_track.rts_backward_cuda,
                cuda_track.kalman_lti_cuda, cuda_track.lattice_iir_cuda)
    for c in counters:
        c.launches = 0
    main_launches = [0] * len(counters)
    t_phase = time.perf_counter()

    def main_path(fn):
        """fn() on the phase's main path: the kernel launches it makes are
        the kernels' line's (timing and comparison launches are not)."""
        before = [c.launches for c in counters]
        out = fn()
        for i, c in enumerate(counters):
            main_launches[i] += c.launches - before[i]
        return out

    def host(t):
        return t.detach().cpu().numpy()

    # (a) the steady-state trackers over 2^22 float32 measurements
    A, C, Q, R = kalman.cv_model(1.0, 0.05, 1.0)
    K, F = kalman.steady_state_gain(A, C, Q, R)
    z = rng.standard_normal(T_LTI).astype(np.float32)
    zt = torch.from_numpy(z).to(dev)
    x0 = torch.zeros(2, device=dev)
    modal = kalman.make_kalman_lti(K, F)
    before_modal = cuda_track.kalman_lti_cuda.launches
    X_modal, _ = main_path(lambda: modal(x0, zt))
    modal_launches = cuda_track.kalman_lti_cuda.launches - before_modal
    trk_p = kalman.AlphaBetaTracker(float(K[0, 0]), float(K[1, 0]),
                                    device=dev)
    # make_kalman_lti and both of the tracker's routes take S4's LTI entry
    # on the card, never affine_scan (torch ops): count its calls while
    # they run
    affine, scans = kalman.affine_scan, [0]

    def counted_affine(*args):
        scans[0] += 1
        return affine(*args)
    kalman.affine_scan = counted_affine
    try:
        X_par = main_path(lambda: trk_p.execute_block(zt, "parallel"))
        trk_s = kalman.AlphaBetaTracker(float(K[0, 0]), float(K[1, 0]),
                                        device=dev)
        h = T_LTI // 2
        X_scan = main_path(lambda: torch.cat([
            trk_s.execute_block(zt[:h], "scan"),
            trk_s.execute_block(zt[h:], "scan")]))
        torch.cuda.synchronize()
    finally:
        kalman.affine_scan = affine
    if scans[0] or modal_launches != 1 or main_launches[2] != 4:
        fail(f"phase 39: the trackers ran affine_scan {scans[0]} times and "
             f"S4's LTI entry {main_launches[2]} times, make_kalman_lti "
             f"{modal_launches} of them (want 0, 4 and 1)")
    ref = lti_walk64(F, K, z.astype(np.float64))
    errs = [rel_err(X, ref) for X in (X_modal, X_par, X_scan)]
    ms_modal = cuda_ms(lambda: modal(x0, zt), 3)
    ms_par = cuda_ms(lambda: trk_p.execute_block(zt, "parallel"), 3)
    ms_scan = cuda_ms(lambda: trk_s.execute_block(zt, "scan"), 2)
    print(f"[39 kalman LTI, cv_model(1, 0.05, 1), 2^22 float32] against the "
          f"float64 CPU walk, x max|ref|: make_kalman_lti (S4 LTI, "
          f"{modal_launches} launch) {errs[0]:.3g}, "
          f"AlphaBetaTracker parallel (S4) {errs[1]:.3g}, scan (S4, two "
          f"blocks) {errs[2]:.3g} (gate {S4_RTOL}); the one-thread entry's "
          f"scan took {ONE_THREAD_MS['kalman_lti'][1]} ms, the modal route "
          f"in torch ops 19.31-33.65 ms; "
          f"{ms_modal:.4f} / {ms_par:.4f} / "
          f"{ms_scan:.4f} ms a block ({T_LTI / (ms_modal * 1e3):.1f} / "
          f"{T_LTI / (ms_par * 1e3):.1f} / {T_LTI / (ms_scan * 1e3):.1f} "
          f"Msamples/s) | {smi}", flush=True)
    if not (max(errs) <= S4_RTOL and X_scan.shape == (T_LTI, 2)
            and torch.isfinite(X_modal).all()):
        fail("phase 39: the steady-state trackers disagree with the float64 "
             "walk")

    # (b) the full filter and the smoother over 2^20 (S4 forward, backward)
    zk = rng.standard_normal(T_KF)
    zkt = torch.from_numpy(zk.astype(np.float32)).to(dev)
    P0 = 10.0 * np.eye(2)
    st0 = kalman.kalman_init(np.zeros(2, np.float32),
                             P0.astype(np.float32), device=dev)
    Xk, (xk, Pk) = main_path(lambda: kalman.kalman_apply(
        st0, zkt[:T_KF // 2], A, C, Q, R))
    Xk2, _ = main_path(lambda: kalman.kalman_apply(
        (xk, Pk), zkt[T_KF // 2:], A, C, Q, R))
    Xk = torch.cat([Xk, Xk2])
    Xs, Ps = main_path(lambda: kalman.rts_smooth(st0, zkt, A, C, Q, R))
    torch.cuda.synchronize()
    W = kf_walk64(zk, A, C, Q, R, np.zeros(2), P0)
    e_kf = rel_err(Xk, np.array(W[0]))
    e_rts = rel_err(Xs, rts_walk64(A, *W))
    ms_kf = cuda_ms(lambda: kalman.kalman_apply(st0, zkt, A, C, Q, R), 3)
    ms_rts = cuda_ms(lambda: kalman.rts_smooth(st0, zkt, A, C, Q, R), 3)
    # the forward entry alone over 2^20, without and with the covariances
    # kept, beside its bytes bounds: Z read, X (and Pf, Xp, Pp) written
    ops = [torch.from_numpy(a).to(dev, torch.float32) for a in (A, C, Q, R)]
    xs0, Ps0 = st0
    n4 = 2
    ms_fwd = graph_ms(lambda: cuda_track.kalman_filter_cuda(
        xs0, Ps0, zkt[:, None], *ops), 5)
    ms_fwdk = graph_ms(lambda: cuda_track.kalman_filter_cuda(
        xs0, Ps0, zkt[:, None], *ops, keep=True), 5)
    b_fwd = bound_ms(4 * T_KF * (1 + n4) + 4 * 22, 2 * T_KF * 48, FP32_FLOPS)
    b_fwdk = bound_ms(4 * T_KF * (1 + 2 * n4 + 2 * n4 * n4) + 4 * 22,
                      2 * T_KF * 48, FP32_FLOPS)
    print(f"[39 kalman_apply (S4 forward, two blocks carried) and rts_smooth "
          f"(S4 both ways), cv_model, 2^20 float32] against the float64 CPU "
          f"walk, x max|ref|: filter {e_kf:.3g}, smoother {e_rts:.3g} (gate "
          f"{S4_RTOL}); {ms_kf:.4f} ms and {ms_rts:.4f} ms a call by events "
          f"(one-thread forward entry: {ONE_THREAD_MS['kalman_filter'][1]} "
          f"and {ONE_THREAD_FORWARD_RTS_MS} ms); the forward entry alone "
          f"(CUDA graph) {ms_fwd:.4f} ms, bytes bound {b_fwd[0]:.5f} ms "
          f"({b_fwd[0] / ms_fwd:.1%}), with the covariances kept "
          f"{ms_fwdk:.4f} ms, bound {b_fwdk[0]:.5f} ms "
          f"({b_fwdk[0] / ms_fwdk:.1%}) | {smi}", flush=True)
    if not (e_kf <= S4_RTOL and e_rts <= S4_RTOL and Ps.shape == (T_KF, 2, 2)):
        fail("phase 39: the Kalman filter or smoother disagrees with the "
             "float64 walk")

    # (c) wavelets: denoise_soft("db4", 4) on 2^21 float32, and the round trip
    xw = rng.standard_normal(L_WAVELET).astype(np.float32)
    xwt = torch.from_numpy(xw).to(dev)
    den = wavelet.denoise_soft(xwt, "db4", levels=4)
    den64 = wavelet.denoise_soft(torch.from_numpy(xw.astype(np.float64)),
                                 "db4", levels=4)
    rec = wavelet.waverec(wavelet.wavedec(xwt, "db4", 4), "db4")
    e_den, e_rec = rel_err(den, den64), float((rec - xwt).abs().max())
    ms_w = cuda_ms(lambda: wavelet.denoise_soft(xwt, "db4", levels=4), 5)
    print(f"[39 wavelets, 2^21 float32] denoise_soft(db4, 4) against its "
          f"float64 CPU run {e_den:.3g} x max (gate {DENOISE_RTOL}); wavedec/"
          f"waverec round trip max|err| {e_rec:.3g} (gate {WAVELET_PR_ATOL}); "
          f"denoise {ms_w:.4f} ms ({L_WAVELET / (ms_w * 1e3):.1f} Msamples/s)"
          f" | {smi}", flush=True)
    if not (e_den <= DENOISE_RTOL and e_rec <= WAVELET_PR_ATOL):
        fail("phase 39: the wavelets disagree")

    # (d) the zoom FFT over 256 x 2^14 complex64, and czt on the DFT contour
    f0 = 0.2537
    k = np.arange(ZOOM_N)
    xz = (np.exp(2j * np.pi * f0 * k)[None, :]
          + 0.1 * cnoise(rng, (ZOOM_ROWS, ZOOM_N))).astype(np.complex64)
    xzt = torch.from_numpy(xz).to(dev)
    Zc = czt.zoom_fft(xzt, 0.2, 0.3, ZOOM_M, fs=1.0)
    Z64 = czt.zoom_fft(torch.from_numpy(xz.astype(np.complex128)), 0.2, 0.3,
                       ZOOM_M, fs=1.0)
    peak = int(np.argmax(np.abs(host(Zc[0]))))
    want = round((f0 - 0.2) / (0.1 / ZOOM_M))
    e_zoom = rel_err(Zc, Z64)
    e_dft = rel_err(czt.czt(xzt), torch.fft.fft(xzt))
    ms_z = cuda_ms(lambda: czt.zoom_fft(xzt, 0.2, 0.3, ZOOM_M, fs=1.0), 5)
    print(f"[39 zoom FFT, 256 x 2^14 complex64 -> 1024 bins on [0.2, 0.3)] "
          f"against its complex128 CPU run {e_zoom:.3g} x max (gate "
          f"{CZT_RTOL}), tone at bin {peak} want {want}; czt on the DFT "
          f"contour against torch.fft.fft {e_dft:.3g}; {ms_z:.4f} ms "
          f"({ZOOM_ROWS * ZOOM_N / (ms_z * 1e3):.1f} Msamples/s) | {smi}",
          flush=True)
    if not (e_zoom <= CZT_RTOL and e_dft <= CZT_RTOL and abs(peak - want) <= 1):
        fail("phase 39: the zoom FFT disagrees")

    # (e) the cyclostationary scan (64 alphas, nfft 256, hop 64, 2^20) and
    # the symbol-rate search on an RRC-shaped QPSK burst
    xc = cnoise(rng, L_CYCLO)
    xct = torch.from_numpy(xc).to(dev)
    alphas = np.linspace(0.03, 0.4, CYCLO_ALPHAS).astype(np.float32)
    prof = cyclo.cycle_profile(xct, alphas, nfft=256, hop=64)
    sub = alphas[::CYCLO_ALPHAS // CYCLO_CHECKED]
    prof64 = cyclo.cycle_profile(torch.from_numpy(xc.astype(np.complex128)),
                                 sub, nfft=256, hop=64)
    e_cy = float(np.max(np.abs(host(prof)[::CYCLO_ALPHAS // CYCLO_CHECKED]
                               - host(prof64))))
    ms_cy = cuda_ms(lambda: cyclo.cycle_profile(xct, alphas, nfft=256,
                                                hop=64), 3)
    sps_ = 6
    n_sym = (1 << 16) // sps_ + 16
    up = np.zeros(n_sym * sps_, np.complex128)
    up[::sps_] = GRAY[rng.integers(0, 4, n_sym)]
    burst = np.convolve(up, firdes_rrcos(sps_, 8, 0.35))[:1 << 16]
    burst = (burst / np.std(burst) + 0.5 * cnoise(rng, 1 << 16)).astype(
        np.complex64)
    sr = cyclo.estimate_symbol_rate(torch.from_numpy(burst).to(dev), 0.05,
                                    0.3)
    print(f"[39 cyclostationary scan, 64 alphas, nfft 256, hop 64, 2^20 "
          f"complex64] profile against complex128 on the CPU at "
          f"{CYCLO_CHECKED} alphas: max|d| {e_cy:.3g} (gate {CYCLO_ATOL}); "
          f"{ms_cy:.3f} ms ({CYCLO_ALPHAS * L_CYCLO / (ms_cy * 1e3):.1f} "
          f"Malpha-samples/s); estimate_symbol_rate on an RRC QPSK burst at "
          f"6 samples a symbol: alpha_hat {sr['alpha_hat']:.6f} want "
          f"{1 / 6:.6f} (gate {SYMBOL_RATE_ATOL}) | {smi}", flush=True)
    if not (e_cy <= CYCLO_ATOL and abs(sr["alpha_hat"] - 1 / 6)
            <= SYMBOL_RATE_ATOL):
        fail("phase 39: the cyclostationary scan disagrees")

    # (f) LPC: order 16 over 256 frames of 2^14 (lpc, burg), the lattices
    # there and back (S5), S5 at order 64 on one lane of 2^20
    import scipy.signal as sps
    a_true = np.poly([0.9 * np.exp(0.6j), 0.9 * np.exp(-0.6j),
                      0.8 * np.exp(1.9j), 0.8 * np.exp(-1.9j)]).real
    xl = sps.lfilter([1.0], a_true, rng.standard_normal(
        (LPC_FRAMES, LPC_N))).astype(np.float32)
    xlt = torch.from_numpy(xl).to(dev)
    xl64 = torch.from_numpy(xl.astype(np.float64))
    e_k = []
    for fn in (lpc.lpc, lpc.burg):
        _, kg, _ = fn(xlt, LPC_ORDER)
        _, kc, _ = fn(xl64, LPC_ORDER)
        e_k.append(float(np.max(np.abs(host(kg) - host(kc)))))
    _, kl, _ = lpc.burg(xlt, LPC_ORDER)
    yl = lpc.lattice_fir(xlt, kl)
    back = main_path(lambda: lpc.lattice_iir(yl, kl))
    e_back = rel_err(back, xl)
    ms_s5 = cuda_ms(lambda: lpc.lattice_iir(yl, kl), 3)
    k64 = 0.6 * rng.uniform(-1, 1, S5_ORDER) / np.sqrt(np.arange(1, S5_ORDER
                                                                  + 1))
    y64 = rng.standard_normal(T_S5_LONG)
    y64t = torch.from_numpy(y64.astype(np.float32)).to(dev)
    k64t = torch.from_numpy(k64.astype(np.float32)).to(dev)
    x64 = main_path(lambda: lpc.lattice_iir(y64t, k64t))
    a64 = host(lpc.reflection_to_poly(torch.from_numpy(k64)))
    e_64 = rel_err(x64, sps.lfilter([1.0], a64, y64))
    ms_64 = cuda_ms_once(lambda: lpc.lattice_iir(y64t, k64t))
    print(f"[39 LPC, order 16, 256 frames of 2^14 float32] reflection "
          f"coefficients against float64 on the CPU: lpc {e_k[0]:.3g}, burg "
          f"{e_k[1]:.3g} (gate {LPC_K_ATOL}); lattice_fir then lattice_iir "
          f"(S5) back to the input {e_back:.3g} x max (gate {S5_RTOL}), S5 "
          f"{ms_s5:.3f} ms ({LPC_FRAMES * LPC_N / (ms_s5 * 1e3):.1f} "
          f"Msamples/s); S5 at order 64 on one lane of 2^20 against scipy's "
          f"lfilter(1, A) in float64 {e_64:.3g} (gate {S5_RTOL}), "
          f"{ms_64:.1f} ms ({ms_64 * 1e6 / T_S5_LONG:.1f} ns a sample) | "
          f"{smi}", flush=True)
    if not (max(e_k) <= LPC_K_ATOL and e_back <= S5_RTOL
            and e_64 <= S5_RTOL):
        fail("phase 39: LPC or the lattices disagree")

    # (g) DCT / DST 1-4 (both backends where a type has two), MDCT / IMDCT
    xg = rng.standard_normal(TRIG_SHAPE).astype(np.float32)
    xgt, xg64 = torch.from_numpy(xg).to(dev), torch.from_numpy(
        xg.astype(np.float64))
    trig = []
    for fn, ty, be in ([(trig_transforms.dct, t, "auto") for t in (1, 2, 3, 4)]
                       + [(trig_transforms.dct, t, "matmul") for t in (1, 2)]
                       + [(trig_transforms.dst, t, "auto") for t in (1, 2, 3, 4)]
                       + [(trig_transforms.dst, 1, "matmul")]):
        e = rel_err(fn(xgt, ty, be), fn(xg64, ty, be))
        ms = cuda_ms(lambda: fn(xgt, ty, be), 5)
        trig.append((f"{fn.__name__}{ty}/{be}", e, ms))
    w = trig_transforms.mdct_window(TRIG_SHAPE[1] // 2)
    Xm = trig_transforms.mdct(xgt, w)
    e_md = rel_err(Xm, trig_transforms.mdct(xg64, w))
    e_im = rel_err(trig_transforms.imdct(Xm, w),
                   trig_transforms.imdct(torch.from_numpy(host(Xm).astype(
                       np.float64)), w))
    trig += [("mdct", e_md, cuda_ms(lambda: trig_transforms.mdct(xgt, w), 5)),
             ("imdct", e_im, cuda_ms(lambda: trig_transforms.imdct(Xm, w),
                                     5))]
    print("[39 DCT/DST/MDCT, (4096, 1024) float32] against float64 on the "
          f"CPU, x max (gate {TRIG_RTOL}), ms: "
          + ", ".join(f"{n} {e:.2g} {ms:.4f}" for n, e, ms in trig)
          + f" | {smi}", flush=True)
    if not max(e for _, e, _ in trig) <= TRIG_RTOL:
        fail("phase 39: a trigonometric transform disagrees")

    # (h) the ADC model and the G.711 codecs on a 2^24 complex64 block
    bits = 12
    delta = 2.0 / (1 << bits)
    xa = (0.4 * cnoise(rng, L_ADC)).astype(np.complex64)
    xat = torch.from_numpy(xa).to(dev)
    adc = quantize.adc_model(xat, bits)
    adc_cpu = quantize.adc_model(torch.from_numpy(xa), bits)
    same_adc = bool(np.array_equal(host(adc), host(adc_cpu)))
    g = torch.Generator(device=dev).manual_seed(SEED)
    ed = host(quantize.adc_model(xat, bits, dither=True, generator=g)) - xa
    inside = (np.abs(xa.real) < 1 - delta) & (np.abs(xa.imag) < 1 - delta)
    e_in = ed[inside]
    n_in = e_in.size
    dith_ok = all(
        float(np.max(np.abs(p))) <= delta / 2 * (1 + 1e-3)
        and abs(float(np.mean(p))) < 5 * delta / np.sqrt(12 * n_in)
        and abs(float(np.corrcoef(p, q)[0, 1])) < 5 / np.sqrt(n_in)
        for p, q in ((e_in.real, xa.real[inside]),
                     (e_in.imag, xa.imag[inside])))
    codecs = []
    xr_ = np.clip(xa.real, -1, 1)
    xrt = torch.from_numpy(xr_).to(dev)
    allc = torch.arange(256, dtype=torch.uint8)
    for name in ("mulaw", "alaw"):
        enc, dec = (getattr(quantize, f"{name}_{s}") for s in ("encode",
                                                                "decode"))
        cg, cc = host(enc(xrt)), host(enc(torch.from_numpy(xr_)))
        codecs.append((name, int(np.sum(cg != cc)),
                       bool(np.array_equal(host(dec(allc.to(dev))),
                                           host(dec(allc)))),
                       cuda_ms(lambda: dec(enc(xrt)), 5)))
    ms_adc = cuda_ms(lambda: quantize.adc_model(xat, bits), 5)
    print(f"[39 ADC and G.711, 2^24 complex64] adc_model(12) bit-equal to its "
          f"CPU run {same_adc}, {ms_adc:.4f} ms; with subtractive dither "
          f"inside the rails: |err| <= delta/2, mean ~0, uncorrelated "
          f"{dith_ok}; codecs (name, codes unlike the CPU's of 2^24, "
          f"decodes of all 256 codes equal, encode+decode ms): {codecs} | "
          f"{smi}", flush=True)
    if not (same_adc and dith_ok and all(
            m <= CODEC_MISMATCH * L_ADC and d for _, m, d, _ in codecs)):
        fail("phase 39: the ADC model or a codec disagrees")

    # (i) the estimators on 2^20
    kq = np.arange(L_EST)
    sym = GRAY[rng.integers(0, 4, L_EST)]
    yq = (sym + 0.3 * cnoise(rng, L_EST)).astype(np.complex64)
    tone_ = (np.exp(2j * np.pi * 0.1234567 * kq + 0.7j)
             + 0.3 * cnoise(rng, L_EST)).astype(np.complex64)
    sg = np.convolve(rng.standard_normal(L_EST + 64), np.ones(4) / 4,
                     "same").astype(np.float32)
    xd, yd = sg[32:32 + L_EST], sg[25:25 + L_EST]        # y lags x by 7
    on = {k_: torch.from_numpy(v).to(dev) for k_, v in
          (("yq", yq), ("sym", sym.astype(np.complex64)), ("tone", tone_),
           ("xd", xd), ("yd", yd))}
    cp = {k_: torch.from_numpy(v.astype(np.complex128 if np.iscomplexobj(v)
                                        else np.float64))
          for k_, v in (("yq", yq), ("sym", sym), ("tone", tone_),
                        ("xd", xd), ("yd", yd))}
    ests = {}
    for label, fn in (
            ("snr_m2m4", lambda d: snr_ops.snr_m2m4(d["yq"])),
            ("evm", lambda d: snr_ops.evm(d["yq"], d["sym"])),
            ("tone_freq_kay", lambda d: estimate.tone_freq_kay(d["tone"])),
            ("tone_freq_fft", lambda d: estimate.tone_freq_fft(d["tone"])),
            ("tdoa", lambda d: estimate.tdoa_gcc_phat(d["xd"], d["yd"],
                                                      32)[0])):
        ests[label] = (float(fn(on)), float(fn(cp)),
                       cuda_ms(lambda fn=fn: fn(on), 5))
    ok_est = (abs(ests["snr_m2m4"][0] / ests["snr_m2m4"][1] - 1) <= 1e-3
              and abs(ests["evm"][0] / ests["evm"][1] - 1) <= 1e-4
              and abs(ests["tone_freq_kay"][0] - ests["tone_freq_kay"][1])
              <= EST_F_ATOL
              and abs(ests["tone_freq_fft"][0] - ests["tone_freq_fft"][1])
              <= EST_F_ATOL
              and abs(ests["tdoa"][0] - ests["tdoa"][1]) <= 0.01
              and abs(ests["tdoa"][0] - 7.0) < 0.5)
    print("[39 estimators, 2^20] (card, float64 CPU, card ms): "
          + ", ".join(f"{k_} ({a:.9g}, {b:.9g}, {m:.4f})"
                      for k_, (a, b, m) in ests.items())
          + f"; gates: snr rel 1e-3, evm rel 1e-4, frequencies {EST_F_ATOL}, "
          f"tdoa 0.01 | {smi}", flush=True)
    if not ok_est:
        fail("phase 39: an estimator disagrees with its float64 run")

    # (j) the RF measurements at nfft 4096 on 2^22
    km = np.arange(L_MEAS)
    spec = np.fft.fft(cnoise(rng, L_MEAS).astype(np.complex128))
    fgrid = np.fft.fftfreq(L_MEAS)
    xm = np.fft.ifft(spec * (np.abs(fgrid) < 0.1) + 0.003 * spec)
    xm = xm.astype(np.complex64)
    tone2 = (np.exp(2j * np.pi * 0.12 * km) + 0.01 * np.exp(
        2j * np.pi * 0.31 * km) + 1e-4 * cnoise(rng, L_MEAS)).astype(
            np.complex64)
    sine = np.sin(2 * np.pi * 75123.7 / L_MEAS * km)
    sine = (np.round(sine * 2047) / 2047).astype(np.float32)
    meas = {}
    dv = {"xm": torch.from_numpy(xm).to(dev),
          "tone2": torch.from_numpy(tone2).to(dev),
          "sine": torch.from_numpy(sine).to(dev)}
    cv = {"xm": torch.from_numpy(xm.astype(np.complex128)),
          "tone2": torch.from_numpy(tone2.astype(np.complex128)),
          "sine": torch.from_numpy(sine.astype(np.float64))}
    for label, fn in (
            ("channel_power", lambda v: float(measurements.channel_power(
                v["xm"], 1.0, 0.0, 0.2, nfft=MEAS_NFFT))),
            ("acpr_lower_db", lambda v: measurements.acpr(
                v["xm"], 1.0, 0.2, nfft=MEAS_NFFT)["lower_db"].tolist()),
            ("obw", lambda v: measurements.occupied_bandwidth(
                v["xm"], 1.0, nfft=MEAS_NFFT)),
            ("sinad_db", lambda v: measurements.sinad_db(v["sine"],
                                                         nfft=MEAS_NFFT)),
            ("enob", lambda v: measurements.enob(v["sine"], nfft=MEAS_NFFT)),
            ("sfdr_db", lambda v: measurements.sfdr_db(v["tone2"],
                                                       nfft=MEAS_NFFT))):
        t0 = time.perf_counter()
        got = fn(dv)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        meas[label] = (got, fn(cv), ms)
    cpw = meas["channel_power"]
    ok_meas = (abs(cpw[0] / cpw[1] - 1) <= 1e-4
               and max(abs(a - b) for a, b in zip(*meas["acpr_lower_db"][:2]))
               <= MEAS_DB_ATOL
               and abs(meas["obw"][0] - meas["obw"][1]) <= 1.0 / MEAS_NFFT
               and all(abs(meas[k_][0] - meas[k_][1]) <= SINAD_DB_ATOL
                       for k_ in ("sinad_db", "sfdr_db"))
               and abs(meas["enob"][0] - meas["enob"][1]) <= SINAD_DB_ATOL
               and abs(meas["sfdr_db"][0] - 40.0) < 1.5)
    print("[39 RF measurements, nfft 4096, 2^22] (card, float64 CPU, card ms "
          "on the host clock): "
          + ", ".join(f"{k_} ({a}, {b}, {m:.2f})"
                      for k_, (a, b, m) in meas.items())
          + f"; gates: power rel 1e-4, ACPR {MEAS_DB_ATOL} dB, OBW one bin, "
          f"SINAD/SFDR/ENOB {SINAD_DB_ATOL} | {smi}", flush=True)
    if not ok_meas:
        fail("phase 39: an RF measurement disagrees with its float64 run")

    # S4 and S5 against their plain versions on the card, timed side by side
    # at T_S4_TIMED steps (the plain walks take ~25 launches a step)
    zt_s = zkt[:T_S4_TIMED, None]
    got_f = cuda_track.kalman_filter_cuda(xs0, Ps0, zt_s, *ops, keep=True)
    box = {}

    def plain_f():
        box["f"] = kalman.kalman_walk_plain(xs0, Ps0, zt_s, *ops, keep=True)
    plain_f_ms = cuda_ms_once(plain_f)
    want_f = box["f"]
    err_f = float(max((g_ - w_).abs().max() for g_, w_ in
                      zip(got_f, want_f)))
    rel_fc = max(rel_err(g_, w_) for g_, w_ in zip(got_f, (
        kalman.kalman_forward_chunked_torch(xs0, Ps0, zt_s, *ops,
                                            keep=True))))
    got_b = cuda_track.rts_backward_cuda(*want_f[:1], *want_f[3:], ops[0])

    def plain_b():
        box["b"] = kalman.rts_backward_plain(want_f[0], *want_f[3:], ops[0])
    plain_b_ms = cuda_ms_once(plain_b)
    err_b = float(max((g_ - w_).abs().max() for g_, w_ in zip(got_b,
                                                               box["b"])))
    rel_bc = max(rel_err(g_, w_) for g_, w_ in zip(got_b, (
        kalman.rts_backward_chunked_torch(want_f[0], *want_f[3:], ops[0]))))
    Fg = torch.from_numpy(F).to(dev, torch.float32)
    Bl = zt[:T_S4_TIMED, None] @ torch.from_numpy(K.T).to(dev, torch.float32)
    got_l = cuda_track.kalman_lti_cuda(x0, Bl, Fg)

    def plain_l():
        box["l"] = kalman.lti_walk_plain(x0, Bl, Fg)
    plain_l_ms = cuda_ms_once(plain_l)
    err_l = float(max((g_ - w_).abs().max() for g_, w_ in zip(got_l,
                                                               box["l"])))
    rel_lc = max(rel_err(g_, w_) for g_, w_ in zip(got_l, (
        kalman.lti_chunked_torch(x0, Bl, Fg))))
    y5, k5 = yl[:, :T_S5_TIMED].contiguous(), kl
    got_5 = cuda_track.lattice_iir_cuda(y5, k5)

    def plain_5():
        box["5"] = lpc.lattice_iir_plain(y5, k5)
    plain_5_ms = cuda_ms_once(plain_5)
    err_5 = float((got_5 - box["5"]).abs().max())
    rel_5 = err_5 / float(box["5"].abs().max())
    rels = [err_f / float(max(w_.abs().max() for w_ in want_f)),
            err_b / float(max(w_.abs().max() for w_ in box["b"])),
            err_l / float(max(w_.abs().max() for w_ in box["l"])), rel_5]
    ms_f = graph_ms(lambda: cuda_track.kalman_filter_cuda(
        xs0, Ps0, zt_s, *ops, keep=True), 5)
    ms_b = graph_ms(lambda: cuda_track.rts_backward_cuda(
        *want_f[:1], *want_f[3:], ops[0]), 5)
    ms_l = graph_ms(lambda: cuda_track.kalman_lti_cuda(x0, Bl, Fg), 5)
    ms_5 = graph_ms(lambda: cuda_track.lattice_iir_cuda(y5, k5), 5)
    T = T_S4_TIMED
    # bytes: each input read once, each output written once; operations:
    # the float32 step's multiply-adds (2 each), from the step's algebra
    b_f = bound_ms(4 * T * (1 + 2 * n4 + 2 * n4 * n4) + 4 * 22,
                   2 * T * 48, FP32_FLOPS)
    b_b = bound_ms(4 * T * (2 * (n4 + n4 * n4) + n4 + n4 * n4) + 16,
                   2 * T * 36, FP32_FLOPS)
    b_l = bound_ms(4 * T * 2 * n4 + 4 * (n4 * n4 + 2 * n4),
                   2 * T * n4 * (n4 + 1), FP32_FLOPS)
    nl = LPC_FRAMES * T_S5_TIMED
    b_5 = bound_ms(4 * 2 * nl + 4 * LPC_FRAMES * LPC_ORDER,
                   2 * nl * 2 * LPC_ORDER, FP32_FLOPS)
    print(f"[39 S4 and S5 vs plain on the card, float32] forward (keep) at "
          f"T={T}: max|d| {err_f:.3g} ({rels[0]:.3g} x max), {ms_f:.4f} ms "
          f"(CUDA graph), plain {plain_f_ms:.1f} ms, bound {b_f[0]:.5f} ms "
          f"({b_f[1]}); backward: {err_b:.3g} ({rels[1]:.3g}), {ms_b:.4f} ms, "
          f"plain {plain_b_ms:.1f} ms, bound {b_b[0]:.5f}; LTI: {err_l:.3g} "
          f"({rels[2]:.3g}), {ms_l:.4f} ms, plain {plain_l_ms:.1f} ms, bound "
          f"{b_l[0]:.5f}; S5 (256 lanes x {T_S5_TIMED}, order 16): {err_5:.3g} "
          f"({rel_5:.3g}), {ms_5:.4f} ms, plain {plain_5_ms:.1f} ms, bound "
          f"{b_5[0]:.5f} (gate {S4_RTOL} x max); the chunk-and-join "
          f"entries against their chunked plain versions: forward "
          f"{rel_fc:.3g} x max (gate {S4_FWD_RTOL}), backward {rel_bc:.3g} "
          f"(gate {S4_RTS_RTOL}), LTI {rel_lc:.3g} (gate {S4_LTI_RTOL}); the "
          f"one-thread entries took {ONE_THREAD_MS['kalman_filter'][0]} / "
          f"{ONE_THREAD_MS['rts_backward'][0]} / "
          f"{ONE_THREAD_MS['kalman_lti'][0]} ms, three launches each "
          f"now | {smi}", flush=True)
    if not (max(rels) <= S4_RTOL and rel_fc <= S4_FWD_RTOL
            and rel_bc <= S4_RTS_RTOL and rel_lc <= S4_LTI_RTOL):
        fail("phase 39: S4 or S5 disagrees with its plain version")

    # S4's chunk-and-join entries at the main path's sizes (the LTI over
    # T_LTI, the backward walk over T_KF) against their chunked plain
    # versions, timed beside their bytes bounds
    Bm = zt[:, None] @ torch.from_numpy(K.T).to(dev, torch.float32)
    got_lm = cuda_track.kalman_lti_cuda(x0, Bm, Fg)

    def plain_lm():
        box["lm"] = kalman.lti_chunked_torch(x0, Bm, Fg)
    plain_lm_ms = cuda_ms_once(plain_lm)
    rel_lm = max(rel_err(g_, w_) for g_, w_ in zip(got_lm, box["lm"]))
    err_lm = float(max((g_ - w_).abs().max() for g_, w_ in zip(got_lm,
                                                                box["lm"])))
    kept = cuda_track.kalman_filter_cuda(xs0, Ps0, zkt[:, None], *ops,
                                         keep=True)

    def plain_fm():
        box["fm"] = kalman.kalman_forward_chunked_torch(
            xs0, Ps0, zkt[:, None], *ops, keep=True)
    plain_fm_ms = cuda_ms_once(plain_fm)
    rel_fm = max(rel_err(g_, w_) for g_, w_ in zip(kept, box["fm"]))
    err_fm = float(max((g_ - w_).abs().max() for g_, w_ in zip(kept,
                                                                box["fm"])))
    got_bm = cuda_track.rts_backward_cuda(kept[0], *kept[3:], ops[0])

    def plain_bm():
        box["bm"] = kalman.rts_backward_chunked_torch(kept[0], *kept[3:],
                                                      ops[0])
    plain_bm_ms = cuda_ms_once(plain_bm)
    rel_bm = max(rel_err(g_, w_) for g_, w_ in zip(got_bm, box["bm"]))
    err_bm = float(max((g_ - w_).abs().max() for g_, w_ in zip(got_bm,
                                                                box["bm"])))
    ms_lm = graph_ms(lambda: cuda_track.kalman_lti_cuda(x0, Bm, Fg), 5)
    ms_bm = graph_ms(lambda: cuda_track.rts_backward_cuda(
        kept[0], *kept[3:], ops[0]), 5)
    b_lm = bound_ms(4 * T_LTI * 2 * n4 + 4 * (n4 * n4 + 2 * n4),
                    2 * T_LTI * n4 * (n4 + 1), FP32_FLOPS)
    b_bm = bound_ms(4 * T_KF * (2 * (n4 + n4 * n4) + n4 + n4 * n4) + 16,
                    2 * T_KF * 36, FP32_FLOPS)
    print(f"[39 S4's chunk-and-join entries at the main path's sizes, "
          f"float32] forward over 2^20 (covariances kept) against "
          f"kalman_forward_chunked_torch: {rel_fm:.3g} x max (gate "
          f"{S4_FWD_RTOL}), {main_launches[0]} launches on the main path, "
          f"chunked plain {plain_fm_ms:.1f} ms; "
          f"LTI over 2^22 against lti_chunked_torch: {rel_lm:.3g} x "
          f"max (gate {S4_LTI_RTOL}), {ms_lm:.4f} ms (CUDA graph), "
          f"{main_launches[2]} launches on the main path, bytes bound "
          f"{b_lm[0]:.5f} ms ({b_lm[0] / ms_lm:.1%}), chunked plain "
          f"{plain_lm_ms:.1f} ms; backward over 2^20 against "
          f"rts_backward_chunked_torch: {rel_bm:.3g} (gate {S4_RTS_RTOL}), "
          f"{ms_bm:.4f} ms, {main_launches[1]} launches, bytes bound "
          f"{b_bm[0]:.5f} ms ({b_bm[0] / ms_bm:.1%}), chunked plain "
          f"{plain_bm_ms:.1f} ms | {smi}", flush=True)
    if not (rel_fm <= S4_FWD_RTOL and rel_lm <= S4_LTI_RTOL
            and rel_bm <= S4_RTS_RTOL and kept[3].shape == (T_KF, 2, 2)
            and got_lm[0].shape == (T_LTI, 2)
            and got_bm[1].shape == (T_KF, 2, 2)):
        fail("phase 39: S4's chunk-and-join entries disagree with their "
             "chunked plain versions at the main path's sizes")
    print(f"[39 phase time] {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    kf_src = "solid_dsp_tpu/ops/kalman.py:{} (a lax.scan, no TPU kernel)"
    entries = []
    # the chunk-and-join entries report their main-path sizes (their times
    # at T_S4_TIMED are launch-bound and kept beside; the forward entry's
    # with the covariances kept, as rts_smooth runs it and as its error and
    # plain time were taken, kalman_apply's run beside); no single PyTorch
    # call computes any of these recurrences, so library_ms stays null
    for (name, src, line, err, ms, plain, bnd, shape, extra), launches in zip((
            ("kalman_filter", "track_forward.cu", kf_src.format(66), err_fm,
             ms_fwdk, plain_fm_ms, b_fwdk, "T=2^20, covariances kept",
             {"main_path_ms": ms_kf, "ms_without_keep": ms_fwd,
              "bound_without_keep_ms": b_fwd[0], f"ms_T{T_S4_TIMED}": ms_f,
              f"walk_plain_ms_T{T_S4_TIMED}": plain_f_ms}),
            ("rts_backward", "track_chunks.cu", kf_src.format(110), err_bm,
             ms_bm, plain_bm_ms, b_bm, "T=2^20",
             {"main_path_ms": ms_rts, f"ms_T{T_S4_TIMED}": ms_b,
              f"walk_plain_ms_T{T_S4_TIMED}": plain_b_ms}),
            ("kalman_lti", "track_chunks.cu", kf_src.format(172), err_lm,
             ms_lm, plain_lm_ms, b_lm, "T=2^22",
             {"main_path_ms": ms_scan, f"ms_T{T_S4_TIMED}": ms_l,
              f"walk_plain_ms_T{T_S4_TIMED}": plain_l_ms}),
            ("lattice_iir", "track_scan.cu", "solid_dsp_tpu/analysis/lpc.py:"
             "233 (a lax.scan, no TPU kernel)", err_5, ms_5, plain_5_ms, b_5,
             f"256 lanes x {T_S5_TIMED}, order 16", {"main_path_ms": ms_s5})),
            main_launches):
        e = kernel_entry(name, src, line, launches, err, ms, plain, bnd)
        e["timed_shape"] = shape
        e.update(extra)
        entries.append(e)
    return entries


def item13a_phases(dev, smi) -> list:
    """Phase 40: ROADMAP item 13a on the card at the TPU sweep's rows, each
    timed and checked (a float64 CPU run, or the CPU or plain version where
    the gate is bit-level); turbo through S6's fused decode and, for
    codewords too long for it, its walk entry, both against the chunked and
    the plain versions.  Returns S6's two kernel entries."""
    from solid_dsp_tpu_torch.models import (cfr, dpd, equalizer, framesync,
                                            ldpc, linear_mod, polar, radar,
                                            turbo)
    from solid_dsp_tpu_torch.ops import cuda_bcjr
    from solid_dsp_tpu_torch.utils import sequences

    rng = np.random.default_rng(SEED + 40)
    cpu = torch.device("cpu")
    t_phase = time.perf_counter()

    def host(t):
        return t.detach().cpu().numpy()

    def rel(got, ref) -> float:
        got, ref = np.asarray(got), np.asarray(ref)
        return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))

    def row(label, fn, count, unit, n=5):
        """Rate in the sweep's unit over n calls (CUDA events), the host's
        enqueue, the profiler's device busy time and the idle share (a
        listing with no kernel record is taken again over more calls, and
        reads "not measured" if it stays empty)."""
        wall, enq = timed(fn, n)
        for n_prof in (max(1, min(5, int(100.0 / wall))), 20, 50):
            busy, top = profiled_busy(fn, n_prof)
            if busy > 0:
                break
        idle = (f"{max(0.0, 1 - busy / wall):.0%}" if busy > 0
                else "not measured")
        print(f"[40 {label}] {count / (wall * 1e3):.2f} {unit} (wall "
              f"{wall:.4f} ms a call over {n}), host {enq:.4f} ms a call, "
              f"device busy {busy:.4f} ms, idle {idle}; largest kernels: "
              f"{top} | {smi}", flush=True)

    ok = True

    # ldpc_decode_648_25it: 512 frames at Eb/N0 ~4.4 dB (BPSK, sigma 0.6)
    code = ldpc.wifi_ldpc_648(dev)
    info = rng.integers(0, 2, (LDPC_FRAMES, code.k))
    cw = host(code.encode(info))
    sig = 0.6
    llr = (2.0 * ((1 - 2.0 * cw) + sig * rng.standard_normal(cw.shape))
           / sig ** 2).astype(np.float32)
    llr_d = torch.from_numpy(llr).to(dev)
    bits_d, ok_d = code.decode(llr_d, 25)
    bits_c, ok_c = ldpc.LDPCCode(code.H, device=cpu).decode(llr, 25)
    good = (np.array_equal(host(bits_d), host(bits_c))
            and np.array_equal(host(ok_d), host(ok_c))
            and bool(ok_d.all()) and np.array_equal(host(bits_d), info))
    print(f"[40 ldpc 648, {LDPC_FRAMES} frames, 25 it] card = CPU run "
          f"(bits, syndromes) and every frame decoded: {good}", flush=True)
    ok &= good
    row(f"ldpc_decode_648_25it", lambda: code.decode(llr_d, 25),
        LDPC_FRAMES * code.k, "Minfobits/s")

    # llr_demap_qam64: 2^21 symbols, noise variance 0.1
    pts = linear_mod.constellation("qam", 64)
    ysym = (0.7 * (rng.standard_normal(L_DEMAP) + 1j
                   * rng.standard_normal(L_DEMAP))).astype(np.complex64)
    y_d = torch.from_numpy(ysym).to(dev)
    got = host(linear_mod.demap_soft(y_d, pts, 0.1))
    ref = host(linear_mod.demap_soft(torch.from_numpy(
        ysym[:L_LOCAL_F64].astype(np.complex128)), pts, 0.1))
    e_demap = rel(got[:ref.size], ref)
    print(f"[40 llr_demap_qam64, 2^21] LLRs vs complex128 CPU on the first "
          f"2^18 symbols: {e_demap:.3g} x max (gate {TX_RTOL})", flush=True)
    ok &= e_demap <= TX_RTOL
    row("llr_demap_qam64", lambda: linear_mod.demap_soft(y_d, pts, 0.1),
        L_DEMAP, "Msymbols/s")

    # preamble_correlate_127: ZC root 5 in 2^22 samples of noise
    zc = sequences.zadoff_chu(5, 127)
    x = (rng.standard_normal(L_PREAMBLE) + 1j
         * rng.standard_normal(L_PREAMBLE)) / np.sqrt(2)
    at = L_PREAMBLE // 3
    x[at:at + 127] += 3.0 * zc
    x = x.astype(np.complex64)
    x_d = torch.from_numpy(x).to(dev)
    rho2 = host(framesync.preamble_correlate(x_d, zc)[0])
    n_chk = L_LOCAL_F64
    ref = host(framesync.preamble_correlate(
        torch.from_numpy(x[:n_chk].astype(np.complex128)), zc)[0])
    e_pre = float(np.abs(rho2[:n_chk - 126] - ref[:n_chk - 126]).max())
    start = int(framesync.detect_preamble(x_d, zc)[0])
    print(f"[40 preamble_correlate_127, 2^22] |rho|^2 vs complex128 CPU on "
          f"the first 2^18: {e_pre:.3g} (gate 1e-5); detected at {start}, "
          f"planted at {at}", flush=True)
    ok &= e_pre <= 1e-5 and start == at
    row("preamble_correlate_127",
        lambda: framesync.preamble_correlate(x_d, zc), L_PREAMBLE,
        "Msamples/s")

    # polar_bp_decode_256_15it: 2048 frames, LLRs 4 (1 - 2x) + N(0, 1)
    pc = polar.PolarCode(256, 128, device=dev)
    bits = rng.integers(0, 2, (POLAR_FRAMES, 128))
    xcw = host(pc.encode(bits))
    llr = ((1 - 2.0 * xcw) * 4 + rng.standard_normal(xcw.shape)).astype(
        np.float32)
    llr_d = torch.from_numpy(llr).to(dev)
    out_d = polar.polar_decode_bp(llr_d, pc.frozen_mask, 15)
    out_c = polar.polar_decode_bp(torch.from_numpy(llr), pc.frozen_mask, 15)
    good = (all(np.array_equal(host(a), host(b))
                for a, b in zip(out_d, out_c))
            and np.array_equal(host(pc.decode(llr_d, 15)[0]), bits))
    print(f"[40 polar 256/128, {POLAR_FRAMES} frames, 15 it] card = CPU run "
          f"(u, x, ok) and every frame decoded: {good}", flush=True)
    ok &= good
    row("polar_bp_decode_256_15it",
        lambda: polar.polar_decode_bp(llr_d, pc.frozen_mask, 15),
        POLAR_FRAMES * 128, "Minfobits/s")

    # turbo_decode_1024_6it through S6's fused decode: 128 codewords, LLRs
    # 4 (1 - 2c) + N; then codewords too long for it (the walk route)
    def turbo_case(K, rows):
        code = turbo.TurboCode(K, n_iter=6, device=dev)
        bits = rng.integers(0, 2, (rows, K))
        cw = host(code.encode(bits))
        llr = torch.from_numpy(((1 - 2.0 * cw) * 4 + rng.standard_normal(
            cw.shape)).astype(np.float32)).to(dev)
        return code, bits, llr

    def s6_counts():
        return (cuda_bcjr.turbo_decode_cuda.launches,
                cuda_bcjr.bcjr_maxlog_cuda.launches)

    tc, tbits, tllr = turbo_case(TURBO_K, TURBO_ROWS)
    tl, lbits, lllr = turbo_case(TURBO_LONG_K, TURBO_LONG_ROWS)
    cuda_bcjr.turbo_decode_cuda.launches = 0
    cuda_bcjr.bcjr_maxlog_cuda.launches = 0
    b_k, l_k = tc.decode(tllr)                       # the main path
    fused_launches, walks_in_fused = s6_counts()
    cuda_bcjr.turbo_decode_cuda.launches = 0
    cuda_bcjr.bcjr_maxlog_cuda.launches = 0
    b_l, l_l = tl.decode(lllr)                       # long codewords
    fused_in_long, walk_launches = s6_counts()
    torch.cuda.synchronize()
    box = {}

    def plain_decode():
        box["p"] = turbo.turbo_decode(tllr, tc.perm, 6, engine="torch")

    def chunked_decode():
        box["c"] = turbo.turbo_decode_chunked_torch(tllr, tc.perm, 6)
    plain_decode_ms = cuda_ms_once(plain_decode)
    chunked_decode_ms = cuda_ms_once(chunked_decode)
    b_p, l_p = box["p"]
    b_c, l_c = box["c"]
    b_lc, l_lc = turbo.turbo_decode_chunked_torch(lllr, tl.perm, 6)
    tol = S6_RTOL * max(1.0, float(l_p.abs().max()))
    e_dec = float((l_k - l_p).abs().max())
    sure = l_p.abs() > tol
    same_fused = torch.equal(l_k, l_c) and torch.equal(b_k, b_c)
    same_long = torch.equal(l_l, l_lc) and torch.equal(b_l, b_lc)
    good = (e_dec <= tol and torch.equal((l_k < 0)[sure], (l_p < 0)[sure])
            and same_fused and same_long
            and np.array_equal(host(b_k), tbits)
            and np.array_equal(host(b_l), lbits)
            and (fused_launches, walks_in_fused) == (1, 0)
            and (fused_in_long, walk_launches) == (0, 12))
    # S6's walk entry on the first walk's rows, all of them and one
    T = TURBO_K
    Tm = T + 3
    ls = torch.cat([tllr[:, :T], tllr[:, 3 * T:3 * T + 3]], -1).contiguous()
    lp = torch.cat([tllr[:, T:2 * T], tllr[:, 3 * T + 3:3 * T + 6]],
                   -1).contiguous()
    tabs = turbo._rsc_tables(turbo.DEFAULT_FB, turbo.DEFAULT_FF, 3)[:4]
    got = cuda_bcjr.bcjr_maxlog_cuda(ls, lp, T, *tabs)

    def plain_walk():
        box["w"] = turbo.bcjr_maxlog_plain(ls, lp, T)

    def chunked_walk():
        box["wc"] = turbo.bcjr_maxlog_chunked_torch(ls, lp, T)
    plain_ms = cuda_ms_once(plain_walk)
    chunked_ms = cuda_ms_once(chunked_walk)
    want = box["w"]
    e_s6 = float((got - want).abs().max())
    tol6 = S6_RTOL * max(1.0, float(want.abs().max()))
    sure = want.abs() > tol6
    same_walk = torch.equal(got, box["wc"]) and torch.equal(
        cuda_bcjr.bcjr_maxlog_cuda(ls[:1], lp[:1], T, *tabs), box["wc"][:1])
    good &= (e_s6 <= tol6 and same_walk
             and torch.equal((got < 0)[sure], (want < 0)[sure]))
    ms_s6 = graph_ms(lambda: cuda_bcjr.bcjr_maxlog_cuda(ls, lp, T, *tabs),
                     20)
    ms_s6_row = graph_ms(lambda: cuda_bcjr.bcjr_maxlog_cuda(
        ls[:1], lp[:1], T, *tabs), 20)
    ms_fused = graph_ms(lambda: tc.decode(tllr), 5)

    # the bounds: bytes, ls and lp read once and the LLRs written once (a
    # walk), the codewords read once and the LLRs and bits written once (a
    # decode); operations a state a step: the forward's two gammas (4
    # each), two adds and a max, the backward's the same, the LLR's two
    # adds a branch and two maxima, the decode's three adds and
    # subtractions a bit a half-iteration beside them
    def walk_bound(rows):
        return bound_ms(4.0 * rows * (2 * Tm + T), 28.0 * rows * Tm * 8,
                        FP32_FLOPS)
    bnd, bnd_row = walk_bound(TURBO_ROWS), walk_bound(1)
    bnd_dec = bound_ms(4.0 * TURBO_ROWS * (3 * T + 12) + 8.0 * TURBO_ROWS * T,
                       12 * TURBO_ROWS * (28.0 * Tm * 8 + 3 * T), FP32_FLOPS)
    print(f"[40 turbo 1024, {TURBO_ROWS} rows, 6 it] fused decode launches "
          f"{fused_launches} (want 1; walk launches {walks_in_fused}); LLRs "
          f"and bits equal to turbo_decode_chunked_torch's on the card: "
          f"{same_fused}; vs the plain walks' decode {e_dec:.3g} (gate "
          f"{tol:.3g}); every bit back: {np.array_equal(host(b_k), tbits)}; "
          f"{TURBO_LONG_ROWS} x {TURBO_LONG_K} (above the fused decode's "
          f"shared memory): walk launches {walk_launches} (want 12), fused "
          f"{fused_in_long}, equal to the chunked loop's {same_long}, every "
          f"bit back {np.array_equal(host(b_l), lbits)} | {smi}", flush=True)
    print(f"[40 S6 walk entry, {TURBO_ROWS} x {Tm} and 1 x {Tm}] equal to "
          f"bcjr_maxlog_chunked_torch: {same_walk}; vs bcjr_maxlog_plain "
          f"{e_s6:.3g} (gate {tol6:.3g}); {ms_s6:.4f} ms a walk of "
          f"{TURBO_ROWS} rows (CUDA graph), bound {bnd[0]:.5f} ms "
          f"({bnd[1]}, {bnd[0] / ms_s6:.1%}); one row {ms_s6_row:.4f} ms, "
          f"bound {bnd_row[0]:.6f} ({bnd_row[0] / ms_s6_row:.2%}); plain "
          f"walk {plain_ms:.1f} ms, chunked plain walk {chunked_ms:.1f} ms | "
          f"{smi}", flush=True)
    print(f"[40 S6 fused decode, {TURBO_ROWS} x {TURBO_K}, 6 it] "
          f"{ms_fused:.4f} ms a decode (CUDA graph), bound {bnd_dec[0]:.5f} "
          f"ms ({bnd_dec[1]}, {bnd_dec[0] / ms_fused:.1%}); plain decode "
          f"{plain_decode_ms:.1f} ms, chunked plain decode "
          f"{chunked_decode_ms:.1f} ms | {smi}", flush=True)
    ok &= good
    row("turbo_decode_1024_6it", lambda: tc.decode(tllr),
        TURBO_ROWS * TURBO_K, "Minfobits/s", n=3)
    decode_ms = timed(lambda: tc.decode(tllr), 3)[0]

    # dpd_mp_apply_k7q3 and cfr_icf_4iter: 2^22 complex64
    xt = (0.2 * (rng.standard_normal(L_TX) + 1j
                 * rng.standard_normal(L_TX))).astype(np.complex64)
    xt_d = torch.from_numpy(xt).to(dev)
    c = np.r_[1.0, np.full(20, 1e-3)].astype(np.complex64)
    c_d = torch.from_numpy(c).to(dev)
    got = host(dpd.mp_apply(c_d, xt_d, 7, 3))
    ref = host(dpd.mp_apply(torch.from_numpy(c.astype(np.complex128)),
                            torch.from_numpy(xt[:L_LOCAL_F64].astype(
                                np.complex128)), 7, 3))
    e_dpd = rel(got[:L_LOCAL_F64], ref)
    mask = cfr.band_mask(L_TX, 0.25)
    got = host(cfr.cfr_icf(xt_d, 0.35, mask, 4))
    ref = host(cfr.cfr_icf(torch.from_numpy(xt.astype(np.complex128)), 0.35,
                           mask, 4))
    e_cfr = rel(got, ref)
    print(f"[40 dpd k7q3 / cfr icf 4 it, 2^22] vs complex128 CPU: mp_apply "
          f"{e_dpd:.3g} x max (first 2^18), cfr_icf {e_cfr:.3g} x max (gate "
          f"{TX_RTOL})", flush=True)
    ok &= e_dpd <= TX_RTOL and e_cfr <= TX_RTOL
    row("dpd_mp_apply_k7q3", lambda: dpd.mp_apply(c_d, xt_d, 7, 3), L_TX,
        "Msamples/s")
    m_d = torch.from_numpy(mask).to(dev)
    row("cfr_icf_4iter", lambda: cfr.cfr_icf(xt_d, 0.35, m_d, 4), L_TX,
        "Msamples/s")

    # rls_equalizer_32tap: one block of 2^20 from the initial state
    xr, dr = ((rng.standard_normal(L_RLS) + 1j * rng.standard_normal(L_RLS)
               ).astype(np.complex64) for _ in range(2))
    init, step = equalizer.make_rls(32, 0.9999, 1e-2, device=dev)
    st0 = init()
    xr_d, dr_d = torch.from_numpy(xr).to(dev), torch.from_numpy(dr).to(dev)
    y = host(step(*st0, xr_d, dr_d)[0])
    init64, step64 = equalizer.make_rls(32, 0.9999, 1e-2, torch.complex128,
                                        cpu)
    ref = host(step64(*init64(), torch.from_numpy(xr.astype(np.complex128)),
                      torch.from_numpy(dr.astype(np.complex128)))[0])
    e_rls = rel(y, ref)
    print(f"[40 rls 32 taps, 2^20] y vs complex128 CPU: {e_rls:.3g} x max "
          f"(gate {RLS_RTOL})", flush=True)
    ok &= e_rls <= RLS_RTOL
    row("rls_equalizer_32tap", lambda: step(*st0, xr_d, dr_d), L_RLS,
        "Msamples/s")

    # cfar_ca_g2t16 with F7 met: 2^22 exponential(1) cells
    pw = rng.exponential(1.0, L_CFAR).astype(np.float32)
    pw_d = torch.from_numpy(pw).to(dev)
    det, thr = (host(v) for v in radar.cfar_ca(pw_d, 2, 16, 1e-4))
    c64 = np.concatenate([[0.0], np.cumsum(pw.astype(np.float64))])
    i = np.arange(L_CFAR)

    def at_(off):
        return c64[np.clip(i + off, 0, L_CFAR)]
    total = at_(-2) - at_(-18) + at_(19) - at_(3)
    cnt = np.maximum((np.clip(i - 2, 0, L_CFAR) - np.clip(i - 18, 0, L_CFAR))
                     + (np.clip(i + 19, 0, L_CFAR)
                        - np.clip(i + 3, 0, L_CFAR)), 1).astype(np.float64)
    thr64 = cnt * (1e-4 ** (-1.0 / cnt) - 1.0) * total / cnt
    e_f7 = float(np.abs(thr.astype(np.float64) / thr64 - 1).max())
    clear = np.abs(pw - thr64) > F7_RTOL * thr64
    good = e_f7 <= F7_RTOL and np.array_equal(det[clear],
                                              (pw > thr64)[clear])
    print(f"[40 cfar g2 t16, 2^22] F7: thresholds vs float64 {e_f7:.3g} "
          f"relative (gate {F7_RTOL}); detections {int(det.sum())}, equal to "
          f"float64's away from the threshold: {good}", flush=True)
    ok &= good
    row("cfar_ca_g2t16", lambda: radar.cfar_ca(pw_d, 2, 16, 1e-4), L_CFAR,
        "Msamples/s")
    print(f"[40 phase time] {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    if not ok:
        fail("phase 40: an item-13a row disagrees with its reference")
    e = kernel_entry("bcjr_maxlog", "bcjr_scan.cu",
                     "solid_dsp_tpu/models/turbo.py:276 and :312 (lax.scans, "
                     "no TPU kernel)", walk_launches, e_s6, ms_s6, plain_ms,
                     bnd)
    e["timed_shape"] = f"{TURBO_ROWS} rows x {Tm} steps"
    e["one_row_ms"] = ms_s6_row
    e["chunked_plain_ms"] = chunked_ms
    f = kernel_entry("turbo_decode", "bcjr_scan.cu",
                     "solid_dsp_tpu/models/turbo.py:326-344 (_turbo_decode_"
                     "perm's loop over the lax.scans; no TPU kernel)",
                     fused_launches, e_dec, ms_fused, plain_decode_ms,
                     bnd_dec)
    f["timed_shape"] = f"{TURBO_ROWS} codewords x {TURBO_K} bits, 6 it"
    f["main_path_ms"] = decode_ms
    f["chunked_plain_ms"] = chunked_decode_ms
    return [e, f]


def item13b_phases(dev, smi) -> list:
    """Phase 41: ROADMAP item 13b on the card at the sizes of the standards
    its modules implement, each row checked and timed (CUDA events, the
    host's enqueue, the profiler's device busy time and the idle share);
    the Viterbi walk through S7 against its plain version, bits and path
    metrics equal; the packets command on a recording of 256 bursts, its
    S7 launches the kernels' line's.  Returns S7's kernel entry."""
    import binascii
    import tempfile

    from solid_dsp_tpu_torch.__main__ import main as cli_main
    from solid_dsp_tpu_torch.models import (array_proc, ber, block_codes,
                                            ccsds, channel, fec, mimo)
    from solid_dsp_tpu_torch.models.ofdm_link import OFDMModem
    from solid_dsp_tpu_torch.models.packet import PacketModem
    from solid_dsp_tpu_torch.ops import cuda_viterbi
    from solid_dsp_tpu_torch.runtime import write_iq
    from solid_dsp_tpu_torch.utils import bits as crc_bits

    rng = np.random.default_rng(SEED + 41)
    cpu = torch.device("cpu")
    t_phase = time.perf_counter()
    ok = True

    def host(t):
        return t.detach().cpu().numpy()

    def row(label, fn, count, unit, n=5):
        wall, enq = timed(fn, n)
        busy, top = profiled_busy(fn, max(1, min(5, int(100.0 / wall))))
        print(f"[41 {label}] {count / (wall * 1e3):.2f} {unit} (wall "
              f"{wall:.4f} ms a call over {n}), host {enq:.4f} ms a call, "
              f"device busy {busy:.4f} ms, idle "
              f"{max(0.0, 1 - busy / wall):.0%}; largest kernels: {top} | "
              f"{smi}", flush=True)

    def awgn_llr(c, ebn0_db, rate):
        """BPSK LLRs of code bits c through AWGN at Eb/N0 (float32)."""
        sigma = np.sqrt(1 / (2 * rate * 10 ** (ebn0_db / 10)))
        y = (1 - 2.0 * c) + sigma * rng.standard_normal(c.shape)
        return (2 * y / sigma ** 2).astype(np.float32)

    tabs = (fec._tables(fec.DEFAULT_POLYS, 7)[0], fec._predecessors(7))
    box = {}
    shapes = {}

    def s7_shape(label, r, plain_rows):
        """S7 on rows r against viterbi_plain and viterbi_chunked_torch (on
        the first plain_rows), its re-walked chunks and re-traced pieces in
        the checked call, its CUDA-graph time and bound; returns (equal,
        ms, bound, max |dpm| against the plain walk)."""
        B, T = r.shape[:2]
        plan = cuda_viterbi.chunk_plan(B, T, 64)
        fec.viterbi_walk(r, soft=True)                 # makes the counters
        cuda_viterbi.viterbi_cuda.fixups.zero_()
        bk, pk = fec.viterbi_walk(r, soft=True)
        rewalked, retraced = cuda_viterbi.viterbi_cuda.fixups.tolist()
        sub = r[:plain_rows]

        def plain():
            box["p"] = fec.viterbi_walk(sub, soft=True, engine="torch")

        def chunked():
            box["c"] = fec.viterbi_chunked_torch(sub, tabs[0], True,
                                                 plan[0], plan[1])
        plain_ms = cuda_ms_once(plain)
        chunked_ms = cuda_ms_once(chunked)
        bp, pp = box["p"]
        bc, pc, fix_c = box["c"]
        err = float((pk[:plain_rows] - pp).abs().max())
        same = (torch.equal(bk[:plain_rows], bp)
                and torch.equal(pk[:plain_rows], pp)
                and torch.equal(bk[:plain_rows], bc)
                and torch.equal(pk[:plain_rows], pc))
        ms = graph_ms(lambda: cuda_viterbi.viterbi_cuda(r, True, *tabs), 20)
        # bytes: the LLRs read once, the bits and final metrics written
        # once; operations a state a step: the branch metric (two adds a
        # branch), two subtractions, two adds, the compare
        bnd = bound_ms(4.0 * B * (2 * T + T + 64), 9.0 * B * T * 64,
                       FP32_FLOPS)
        before = S7_SEQUENTIAL_MS[(B, T)]
        print(f"[41 S7 {label}, {B} x {T} steps, soft] bit-equal to "
              f"viterbi_plain and viterbi_chunked_torch on {plain_rows} "
              f"rows (bits, metrics): {same}; L, W, F, C = {plan}; "
              f"re-walked chunks {rewalked} (chunked plain on its rows "
              f"{fix_c}), re-traced {retraced}; S7 {ms:.4f} ms a call (CUDA "
              f"graph, {ms / T * 1e6:.1f} ns a step; the sequential kernel's "
              f"recorded {before} ms, {before / ms:.2f}x), bound {bnd[0]:.5f} ms "
              f"({bnd[1]}, {bnd[0] / ms:.1%} of it); viterbi_plain "
              f"{plain_ms:.1f} ms, viterbi_chunked_torch {chunked_ms:.1f} "
              f"ms on {plain_rows} rows | {smi}", flush=True)
        shapes[label] = {"shape": f"{B} x {T}", "ms": ms,
                         "bound_ms": bnd[0],
                         "plan": list(plan), "rewalked": rewalked,
                         "retraced": retraced, "plain_ms": plain_ms,
                         "chunked_plain_ms": chunked_ms}
        return same, ms, bnd, err, plain_ms

    # viterbi_k7_packet: 1024 rows of a 64-byte packet + CRC-32 (544 bits +
    # 6 tail = 550 steps), soft, K = 7 (171, 133), Eb/N0 = 4 dB
    info = rng.integers(0, 2, (VIT_ROWS, VIT_BITS))
    coded = host(fec.conv_encode(torch.from_numpy(info).to(dev)))
    llr_d = torch.from_numpy(awgn_llr(coded, 4.0, 0.5)).to(dev)
    r = llr_d.reshape(VIT_ROWS, -1, 2)
    T = r.shape[1]
    dec = host(fec.viterbi_decode(llr_d, soft=True))
    ber7 = float(np.mean(dec != info))
    same, ms7, bnd, err7, plain_ms = s7_shape("viterbi_k7_packet", r,
                                              VIT_ROWS)
    print(f"[41 viterbi_k7_packet] BER at Eb/N0 = 4 dB {ber7:.3g} (gate "
          f"{VIT_BER}); {VIT_ROWS * VIT_BITS / (ms7 * 1e3):.1f} Minfobits/s "
          f"through S7", flush=True)
    ok &= same and ber7 <= VIT_BER
    row("viterbi_k7_packet", lambda: fec.viterbi_decode(llr_d, soft=True),
        VIT_ROWS * VIT_BITS, "Minfobits/s")
    same1 = s7_shape("one_packet", r[:1], 1)[0]
    ok &= same1

    # viterbi_k7_ccsds: 64 rows of a CCSDS frame at interleave depth 4
    # (4 x 255 bytes + 6 tail = 8166 steps); CCSDSLink(4) at 2.8 dB
    link = ccsds.CCSDSLink(4, dev)
    payload = rng.integers(0, 256, link.payload_bytes, dtype=np.uint8
                           ).tobytes()
    tx = host(link.encode(payload))
    R = len(payload) * 8 / len(tx)
    rc = torch.from_numpy(np.stack([awgn_llr(tx, 2.8, R)
                                    for _ in range(CCSDS_ROWS)])).to(dev)
    dec_c, ok_c = link.decode(host(rc[0]))
    rows_c = rc.reshape(CCSDS_ROWS, -1, 2)
    same_c = s7_shape("viterbi_k7_ccsds", rows_c, CCSDS_PLAIN)[0]
    print(f"[41 viterbi_k7_ccsds] CCSDSLink(4) at Eb/N0 = 2.8 dB: frame "
          f"back {dec_c == payload and ok_c} | {smi}", flush=True)
    ok &= same_c and dec_c == payload and ok_c
    row("viterbi_k7_ccsds", lambda: fec.viterbi_decode(rc, soft=True),
        CCSDS_ROWS * 4 * 255 * 8, "Minfobits/s", n=3)

    # rs_255_223: 4096 codewords, 1-16 byte errors in one in eight
    msg = rng.integers(0, 256, (RS_WORDS, 223)).astype(np.int32)
    cw = host(link.rs.encode(torch.from_numpy(msg)))
    for i in range(0, RS_WORDS, 8):
        ne = 1 + (i // 8) % 16
        cw[i, rng.choice(255, ne, replace=False)] ^= rng.integers(1, 256, ne)
    t0 = time.perf_counter()
    out, okw = link.rs.decode(cw)
    rs_s = time.perf_counter() - t0
    good = bool(okw.all()) and np.array_equal(host(out), msg)
    print(f"[41 rs_255_223, {RS_WORDS} codewords, 1-16 byte errors in one "
          f"in eight] every codeword corrected: {good}; decode "
          f"{RS_WORDS * 223 / rs_s / 1e6:.2f} Mbytes/s ({rs_s:.3f} s: "
          f"syndromes on the card, the locator on the host for "
          f"{RS_WORDS // 8} codewords) | {smi}", flush=True)
    ok &= good
    cw_d = torch.from_numpy(cw).to(dev)
    row("rs_255_223 syndromes", lambda: link.rs.syndromes(cw_d),
        RS_WORDS * 255, "Mbytes/s")

    # crc32_2e20, golay24 and hamming_7_4 over 2^20 bits
    data = rng.integers(0, 256, L_BITS // 8, dtype=np.uint8).tobytes()
    bits_d = torch.from_numpy(crc_bits._bytes_to_bits_lsb_first(data).astype(
        np.int32)).to(dev)

    def crc_d():
        return crc_bits.crc_compute(bits_d, 0xEDB88320, 32, 0xFFFFFFFF,
                                    0xFFFFFFFF, True)
    good_crc = int(crc_d()) == binascii.crc32(data)
    print(f"[41 crc32_2e20] equal to binascii.crc32: {good_crc}", flush=True)
    ok &= good_crc
    row("crc32_2e20", crc_d, L_BITS, "Mbits/s")
    for scheme, radius in (("g2412", 3), ("h74", 1)):
        code = block_codes.BlockCode(scheme, dev)
        nblk = L_BITS // code.k
        d = rng.integers(0, 2, nblk * code.k)
        c = host(code.encode(torch.from_numpy(d))).reshape(nblk, code.n)
        for w in range(1, radius + 1):     # w flips in a block, blocks w mod
            sel = np.nonzero(np.arange(nblk) % (radius + 1) == w)[0]
            for _ in range(w):
                c[sel, rng.integers(0, code.n, len(sel))] ^= 1
        # two flips on one bit cancel; such a block has fewer errors
        c_d = torch.from_numpy(c.reshape(-1)).to(dev)
        got, fail = code.decode(c_d)
        good = np.array_equal(host(got), d) and not bool(fail.any())
        print(f"[41 {scheme}, 2^20 bits] errors within the radius ({radius}) "
              f"in {1 - 1 / (radius + 1):.0%} of the blocks, all corrected: "
              f"{good}", flush=True)
        ok &= good
        row(f"{scheme} decode", lambda: code.decode(c_d), nblk * code.k,
            "Mbits/s")

    # ber_sweep_qpsk: 2^20 bits x 8 points against ber_theory
    grid = np.arange(8.0)
    got = ber.ber_sweep(grid, "psk", 4, L_BITS, seed=SEED, device=dev)
    want = channel.ber_theory("psk", 4, grid)
    half = 3.29 * np.sqrt(want * (1 - want) / L_BITS) + 1.0 / L_BITS
    good = bool(np.all(np.abs(got - want) <= half))
    print(f"[41 ber_sweep_qpsk, 2^20 bits x 8 points] BER {np.round(got, 6)}"
          f" within the binomial 99.9% interval of ber_theory: {good}",
          flush=True)
    ok &= good
    row("ber_sweep_qpsk", lambda: ber.ber_sweep(grid, "psk", 4, L_BITS,
                                                 device=dev),
        8 * L_BITS, "Mbits/s", n=3)

    # packets_cli_256: 256 QPSK bursts of 64 bytes (conv FEC) at Es/N0 =
    # 12 dB through the packets command
    pm = PacketModem(payload_bytes=64, device=dev)
    payloads = [rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
                for _ in range(N_BURSTS)]
    bursts = [host(pm.transmit(p)) for p in payloads]
    p_sig = float(np.mean(np.abs(bursts[0][2 * 127:]) ** 2))
    nv = p_sig * pm.modem.sps / 10 ** (12.0 / 10)
    gaps = rng.integers(200, 800, N_BURSTS + 1)
    parts = [np.zeros(gaps[0], np.complex64)]
    for b, g in zip(bursts, gaps[1:]):
        parts += [b, np.zeros(g, np.complex64)]
    rec = np.concatenate(parts)
    rec = (rec + np.sqrt(nv / 2) * (rng.standard_normal(len(rec)) + 1j
                                    * rng.standard_normal(len(rec)))
           ).astype(np.complex64)
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "bursts.cf32")
        write_iq(src, rec)
        argv = ["packets", src, "--payload-bytes", "64"]
        run_cli(cli_main, argv)                          # warm
        cuda_viterbi.viterbi_cuda.launches = 0
        rc_cli, out, wall = run_cli(cli_main, argv)      # the main path
        launches = cuda_viterbi.viterbi_cuda.launches
    rows = [json.loads(line) for line in out.strip().splitlines()]
    good = (rc_cli == 0 and rows[-1] == {"bursts": N_BURSTS,
                                         "crc_ok": N_BURSTS}
            and [bytes.fromhex(x["payload_hex"]) for x in rows[:-1]]
            == payloads and launches == N_BURSTS)
    print(f"[41 packets_cli_256, {len(rec)} samples] {rows[-1]}, payloads "
          f"back and S7 launches {launches} (one a burst): {good}; "
          f"{N_BURSTS / wall:.1f} bursts/s, "
          f"{N_BURSTS * 64 * 8 / wall / 1e6:.3f} payload Mbit/s ({wall:.3f} "
          f"s by the host's clock) | {smi}", flush=True)
    ok &= good
    main_ms = wall * 1e3 / N_BURSTS

    # ofdm_modem_64: 64 OFDMModem bursts (16-QAM, conv FEC) through
    # multipath, CFO and AWGN at 25 dB (tests/test_ofdm_link.py)
    om = OFDMModem(64, device=dev)
    n_ok = 0
    t0 = time.perf_counter()
    for _ in range(N_OFDM):
        p = rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
        txo = host(om.transmit(p))
        s = np.concatenate([np.zeros(int(rng.integers(100, 600)),
                                     np.complex64), txo,
                            np.zeros(200, np.complex64)])
        s = np.convolve(s, np.array([1.0, 0, 0.3 - 0.2j, 0, 0.1j]))[:len(s)]
        s = s * np.exp(2j * np.pi * rng.uniform(-2e-3, 2e-3)
                       * np.arange(len(s)))
        sig = np.sqrt(np.mean(np.abs(txo) ** 2) * 10 ** (-2.5) / 2)
        s = s + sig * (rng.standard_normal(len(s)) + 1j
                       * rng.standard_normal(len(s)))
        got, inf = om.receive(torch.from_numpy(s.astype(np.complex64)))
        n_ok += int(inf["crc_ok"] and got == p)
    ofdm_s = time.perf_counter() - t0
    print(f"[41 ofdm_modem_64] CRCs passed {n_ok} of {N_OFDM}; "
          f"{N_OFDM / ofdm_s:.1f} bursts/s with the host's channel | {smi}",
          flush=True)
    ok &= n_ok == N_OFDM

    # mimo_4x4: mmse_detect over 2^20 vectors, ml_detect (QPSK) over 2^16,
    # against complex128 on the CPU on their first 2^12
    H = ((rng.standard_normal((L_MIMO, 4, 4)) + 1j * rng.standard_normal(
        (L_MIMO, 4, 4))) / np.sqrt(2)).astype(np.complex64)
    qpsk = GRAY.astype(np.complex64)
    s_idx = rng.integers(0, 4, (L_MIMO, 4))
    y = (np.einsum("brt,bt->br", H, qpsk[s_idx]) + 0.2 * (
        rng.standard_normal((L_MIMO, 4)) + 1j * rng.standard_normal(
            (L_MIMO, 4)))).astype(np.complex64)
    H_d, y_d = torch.from_numpy(H).to(dev), torch.from_numpy(y).to(dev)
    m_d = host(mimo.mmse_detect(H_d, y_d, 0.08))
    m_64 = host(mimo.mmse_detect(torch.from_numpy(H[:L_CHECK]).to(
        torch.complex128), torch.from_numpy(y[:L_CHECK]).to(
        torch.complex128), 0.08))
    e_mmse = float(np.abs(m_d[:L_CHECK] - m_64).max() / np.abs(m_64).max())
    c_d = torch.from_numpy(qpsk).to(dev)
    i_d = host(mimo.ml_detect(H_d[:L_ML], y_d[:L_ML], c_d)[0])
    i_64 = host(mimo.ml_detect(torch.from_numpy(H[:L_CHECK]).to(
        torch.complex128), torch.from_numpy(y[:L_CHECK]).to(
        torch.complex128), torch.from_numpy(qpsk).to(torch.complex128))[0])
    ml_diff = int(np.any(i_d[:L_CHECK] != i_64, axis=-1).sum())
    print(f"[41 mimo_4x4] mmse_detect (2^20) vs complex128 on the first "
          f"2^12: {e_mmse:.3g} x max (gate {MIMO_RTOL}); ml_detect (QPSK, "
          f"2^16) vectors unlike complex128's on the first 2^12: {ml_diff} "
          f"(gate {ML_MAX_DIFF}); symbol errors {np.mean(i_d != s_idx[:L_ML]):.3g}",
          flush=True)
    ok &= e_mmse <= MIMO_RTOL and ml_diff <= ML_MAX_DIFF
    row("mmse_detect_4x4", lambda: mimo.mmse_detect(H_d, y_d, 0.08), L_MIMO,
        "Mvectors/s")
    row("ml_detect_4x4_qpsk", lambda: mimo.ml_detect(H_d[:L_ML], y_d[:L_ML],
                                                      c_d), L_ML,
        "Mvectors/s")

    # music_16: a 16-antenna ULA, 2^14 snapshots, 1801 angles
    k = np.arange(16)[:, None]
    X = np.zeros((16, L_SNAP), np.complex128)
    for th in MUSIC_DOAS:
        a = np.exp(2j * np.pi * 0.5 * np.sin(np.deg2rad(th)) * k)
        X += a * (rng.standard_normal(L_SNAP) + 1j * rng.standard_normal(
            L_SNAP))[None, :] / np.sqrt(2)
    X += np.sqrt(0.05) * (rng.standard_normal((16, L_SNAP)) + 1j
                          * rng.standard_normal((16, L_SNAP)))
    X_d = torch.from_numpy(X.astype(np.complex64)).to(dev)
    thetas = np.deg2rad(np.linspace(-90, 90, 1801))
    R_d = array_proc.spatial_covariance(X_d)
    doa = np.rad2deg(array_proc.music_doa(R_d, 2, grid=1801))
    doa64 = np.rad2deg(array_proc.music_doa(array_proc.spatial_covariance(
        torch.from_numpy(X)), 2, grid=1801))
    e_doa = float(np.abs(doa - doa64).max())
    print(f"[41 music_16, 2^14 snapshots, 1801 angles] DoAs {np.round(doa, 3)}"
          f" deg, vs complex128 {e_doa:.3g} deg (gate {DOA_ATOL}) | {smi}",
          flush=True)
    ok &= e_doa <= DOA_ATOL

    def music():
        R = array_proc.spatial_covariance(X_d)
        return array_proc.music_spectrum(R, thetas, 2)
    row("music_16", music, L_SNAP, "Msnapshots/s")
    print(f"[41 phase time] {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    if not ok:
        fail("phase 41: an item-13b row disagrees with its reference")
    e = kernel_entry("viterbi_acs", "viterbi_scan.cu",
                     "solid_dsp_tpu/models/fec.py:143 and :152 (lax.scans, "
                     "no TPU kernel)", launches, err7, ms7, plain_ms, bnd)
    e["timed_shape"] = f"{VIT_ROWS} rows x {T} steps"
    e["main_path_ms"] = main_ms
    e["shapes"] = shapes
    return [e]


def cvsd_walk64(v: np.ndarray, decode: bool, beta=0.9, gamma=0.01,
                dmin=0.001, dmax=0.2, n_history=3, leak=0.98) -> np.ndarray:
    """The CVSD walk in float64 numpy over lanes v (B, N) (a step at a
    time, vectorized over the lanes): bits (encode) or the trajectory."""
    B, N = v.shape
    ref = np.zeros(B)
    step = np.full(B, dmin)
    hist = np.zeros((B, n_history), np.int64)
    out = np.empty((B, N), np.float64 if decode else np.int64)
    for n in range(N):
        bit = v[:, n].astype(np.int64) if decode else (v[:, n] >= ref
                                                        ).astype(np.int64)
        hist = np.concatenate([hist[:, 1:], bit[:, None]], 1)
        agree = np.all(hist == hist[:, :1], 1)
        step = np.clip(beta * step + np.where(agree, gamma, 0.0), dmin, dmax)
        ref = np.clip(leak * ref + np.where(bit == 1, step, -step), -1, 1)
        out[:, n] = ref if decode else bit
    return out


def sco_lanes(B: int, N: int, dev) -> torch.Tensor:
    """cvsd_sco_1024's input: B SCO voice channels at 64 kbit/s (N samples
    each), lane b a two-tone at 4x oversampling of 16 kHz audio, float32
    on ``dev``."""
    t = torch.arange(N, device=dev, dtype=torch.float64) / CVSD_FS
    lane = torch.arange(B, device=dev, dtype=torch.float64)[:, None]
    f1, f2 = 300.0 + 37.0 * (lane % 9), 800.0 + 53.0 * (lane % 7)
    amp = 0.4 + 0.5 * (lane % 5) / 4
    return (amp * (0.5 * torch.sin(2 * np.pi * f1 * t + lane)
                   + 0.25 * torch.sin(2 * np.pi * f2 * t))).float()


def evm_db(y: np.ndarray) -> float:
    """EVM of QPSK symbols in dB: normalised by their RMS, against the
    nearest point."""
    z = y / np.sqrt(np.mean(np.abs(y) ** 2))
    d = (np.sign(z.real) + 1j * np.sign(z.imag)) / np.sqrt(2)
    return 10 * np.log10(np.mean(np.abs(z - d) ** 2))


def item13c_phases(dev, smi) -> list:
    """Phase 42: ROADMAP item 13c on the card: CVSD through S8 (1024 SCO
    voice lanes of 1 s), the Gardner loop through S9 (a 2^22-sample RRC
    QPSK stream, F8 met), the CLI's tx (fm, qam 16) read back by rx, adsb
    and ais on recordings, and the other modems' round trips, each timed
    (CUDA events, host enqueue, device busy, idle share) and checked.
    Returns S8's (encode, decode) and S9's kernel entries."""
    import tempfile

    import scipy.signal as sps_sig

    from solid_dsp_tpu_torch.ops.fir import conv1d_mxu

    from solid_dsp_tpu_torch.__main__ import main as cli_main
    from solid_dsp_tpu_torch.models import (adsb, ais, am, css, cvsd, cw,
                                            dsss, fhss, fsk, gmsk, linear_mod,
                                            timing)
    from solid_dsp_tpu_torch.models.detect import BurstDetector
    from solid_dsp_tpu_torch.ops import cuda_cvsd, cuda_timing
    from solid_dsp_tpu_torch.runtime import read_iq, write_iq
    from solid_dsp_tpu_torch.utils import sequences

    rng = np.random.default_rng(SEED + 42)
    t_phase = time.perf_counter()
    ok = True

    def host(t):
        return t.detach().cpu().numpy()

    def row(label, fn, count, unit, n=3):
        wall, enq = timed(fn, n)
        busy, top = profiled_busy(fn, max(1, min(5, int(100.0 / wall))))
        print(f"[42 {label}] {count / (wall * 1e3):.2f} {unit} (wall "
              f"{wall:.4f} ms a call over {n}), host {enq:.4f} ms a call, "
              f"device busy {busy:.4f} ms, idle "
              f"{max(0.0, 1 - busy / wall):.0%}; largest kernels: {top} | "
              f"{smi}", flush=True)

    B, N = CVSD_LANES, CVSD_N
    x = sco_lanes(B, N, dev)
    codec = cvsd.CVSD(device=dev)
    cuda_cvsd.cvsd_cuda.launches = 0
    cuda_cvsd.cvsd_cuda.decode_launches = 0
    cuda_cvsd.cvsd_cuda.pass_launches = 0
    bits = codec.encode(x)
    y = codec.decode(bits)
    torch.cuda.synchronize()
    l_dec = cuda_cvsd.cvsd_cuda.decode_launches
    l_enc = cuda_cvsd.cvsd_cuda.launches - l_dec
    l_pass = cuda_cvsd.cvsd_cuda.pass_launches
    lp = sps_sig.firwin(201, 1200, fs=CVSD_FS)
    snrs = []
    for b in (0, B // 2 + 3, B - 1):
        xf = sps_sig.lfilter(lp, 1, host(x[b]))[500:]
        yf = sps_sig.lfilter(lp, 1, host(y[b]))[500:]
        snrs.append(10 * np.log10(np.mean(xf ** 2) / np.mean((yf - xf) ** 2)))
    box = {}
    xs, bs = x[:, :CVSD_PLAIN_N], bits[:, :CVSD_PLAIN_N].contiguous()

    def plain_enc():
        box["b"] = cvsd.cvsd_encode(xs, engine="torch")

    def plain_dec():
        box["y"] = cvsd.cvsd_decode(bs, engine="torch")

    def chunked_dec():
        box["yc"] = cvsd.cvsd_decode_chunked_torch(bs)
    plain_enc_ms = cuda_ms_once(plain_enc)
    plain_dec_ms = cuda_ms_once(plain_dec)
    chunked_ms = cuda_ms_once(chunked_dec)
    xs_c, bs_c = xs.contiguous(), bs
    args = (0.9, 0.01, 0.001, 0.2, 3, 0.98)
    ys = cuda_cvsd.cvsd_cuda(bs_c, True, *args)
    same = (torch.equal(box["b"], bits[:, :CVSD_PLAIN_N])
            and torch.equal(box["yc"], ys))
    walk8 = float((ys - box["y"]).abs().max())
    x64 = host(x[:CVSD_F64_LANES]).astype(np.float64)
    b64 = cvsd_walk64(x64, False)
    bk = host(bits[:CVSD_F64_LANES])
    agree64 = float(np.mean(b64 == bk))
    y64 = cvsd_walk64(bk.astype(np.float64), True)
    e64 = float(np.abs(host(y[:CVSD_F64_LANES]) - y64).max())
    # the main path's own decode at its full length (its joins compose runs
    # of R > 1 chunks, which 2^12 does not reach) against the plain version
    same_full = torch.equal(y[:CVSD_FULL_LANES],
                            cvsd.cvsd_decode_chunked_torch(
                                bits[:CVSD_FULL_LANES]))
    enc_ms = graph_ms(lambda: cuda_cvsd.cvsd_cuda(xs_c, False, *args), 20)
    dec_ms = graph_ms(lambda: cuda_cvsd.cvsd_cuda(bs_c, True, *args), 20)
    enc_full = graph_ms(lambda: cuda_cvsd.cvsd_cuda(x, False, *args), 3)
    dec_full = graph_ms(lambda: cuda_cvsd.cvsd_cuda(bits, True, *args), 3)
    # the tracer can drop records of a short window: retry while a kernel
    # shows fewer records than its launches a call (two joins) times n
    def want_records(k, n):
        return n * (2 if "cvsd_join" in k else 1)
    for n_prof in (5, 10, 20, 40):
        rows = profiled_rows(lambda: cuda_cvsd.cvsd_cuda(bits, True, *args),
                             n_prof)
        if (len(rows) == cuda_cvsd.DECODE_PASSES - 1
                and all(c >= want_records(k, n_prof) for _, k, c in rows)):
            break
    passes = "; ".join(
        f"{k[:40]} {t:.4f} ms ({c} of {want_records(k, n_prof)} records"
        + (", short: not a full measurement)" if c < want_records(k, n_prof)
           else ")") for t, k, c in rows)
    # bytes: 4 in, 4 out a sample; operations a step: 2 multiplies, 2 adds,
    # 4 clamps, the compare and the history's 4 integer operations
    n_s = B * CVSD_PLAIN_N
    bnd8 = bound_ms(8.0 * n_s, 13.0 * n_s, FP32_FLOPS)
    print(f"[42 cvsd_sco_1024, {B} lanes x 2^16 at {CVSD_FS / 1e3:.0f} "
          f"kbit/s] S8 calls encode {l_enc}, decode {l_dec} ({l_pass} "
          f"kernels); in-band SNR {np.round(snrs, 2)} dB (gate "
          f"{CVSD_MIN_SNR_DB}); on the card over {B} x 2^12 the bits equal "
          f"the plain walk's and the trajectory cvsd_decode_chunked_torch's: "
          f"{same}, the trajectory within {walk8:.3g} of the walk's (gate "
          f"{cvsd.CHUNKED_ATOL}); over {CVSD_FULL_LANES} x 2^16 the main path's "
          f"trajectory equals cvsd_decode_chunked_torch's: {same_full}; the "
          f"float64 walk on {CVSD_F64_LANES} lanes: "
          f"bits agree {agree64:.6f} (gate {CVSD_F64_AGREE}), its decode of "
          f"S8's bits within {e64:.3g} (gate {CVSD_ATOL}); S8 encode "
          f"{enc_ms:.4f} ms, decode {dec_ms:.4f} ms at {B} x 2^12 (CUDA "
          f"graph, {enc_ms / CVSD_PLAIN_N * 1e6:.1f} / "
          f"{dec_ms / CVSD_PLAIN_N * 1e6:.1f} ns a step), at {B} x 2^16 "
          f"{enc_full:.4f} / {dec_full:.4f} ms ({B * N / (enc_full * 1e3):.1f}"
          f" / {B * N / (dec_full * 1e3):.1f} Msamples/s; decode's kernels "
          f"(profiler): {passes}); plain walks {plain_enc_ms:.1f} / "
          f"{plain_dec_ms:.1f} ms, cvsd_decode_chunked_torch {chunked_ms:.1f}"
          f" ms; bound at 2^12 {bnd8[0]:.5f} ms ({bnd8[1]}) | {smi}",
          flush=True)
    ok &= (l_enc == 1 and l_dec == 1 and l_pass == cuda_cvsd.DECODE_PASSES
           and min(snrs) > CVSD_MIN_SNR_DB and same and same_full
           and walk8 <= cvsd.CHUNKED_ATOL and agree64 >= CVSD_F64_AGREE
           and e64 <= CVSD_ATOL)
    row("cvsd_sco_1024 round trip", lambda: codec.decode(codec.encode(x)),
        B * N, "Msamples/s")
    err8 = float((box["yc"] - ys).abs().max())
    del x, y, bits, box, ys

    # gardner_qpsk_2e22: RRC QPSK at sps 8 with a 0.4-sample offset
    sps = GARDNER_SPS
    n_sym = L_GARDNER // sps
    idx = rng.integers(0, 4, n_sym)
    syms = torch.from_numpy(GRAY[idx].astype(np.complex64)).to(dev)
    shaped = linear_mod.pulse_shape(syms, sps)
    h = timing.fractional_delay_taps(torch.tensor(GARDNER_TAU, device=dev),
                                     33).to(torch.complex64)
    delayed = conv1d_mxu(torch.cat([shaped.new_zeros(32), shaped]), h)
    xg = linear_mod.matched_filter(delayed, sps).contiguous()
    cuda_timing.gardner_cuda.launches = 0
    gs, gmu = timing.gardner_scan(xg, sps, GARDNER_BW)
    torch.cuda.synchronize()
    l9 = cuda_timing.gardner_cuda.launches
    g = host(gs)
    dec = (g.real < 0).astype(int) + 2 * (g.imag < 0)
    lag = min(range(-24, 25), key=lambda d: np.mean(
        idx[2000 + d:2000 + d + 4096] != dec[2000:2000 + 4096]))
    tail = len(dec) - 16
    ser_all = float(np.mean(idx[2000 + lag:tail + lag] != dec[2000:tail]))
    k17 = (1 << 17) // sps
    evm_17 = evm_db(g[k17 - 4000:k17 + 4000])
    evm_end = evm_db(g[-8016:-16])
    x_short = xg[: sps * (GARDNER_PLAIN + 1) + 4].contiguous()
    box = {}

    def plain9():
        box["p"] = timing.gardner_scan(x_short, sps, GARDNER_BW,
                                       engine="torch")
    plain9_ms = cuda_ms_once(plain9)
    ks, kmu = timing.gardner_scan(x_short, sps, GARDNER_BW)
    same9 = (torch.equal(ks, box["p"][0]) and torch.equal(kmu, box["p"][1])
             and torch.equal(gs[:GARDNER_PLAIN], ks))
    err9 = float((ks - box["p"][0]).abs().max())
    alpha, beta = GARDNER_BW, GARDNER_BW ** 2 / 4
    ms9 = graph_ms(lambda: cuda_timing.gardner_cuda(
        x_short, sps, alpha, beta, 0.0, GARDNER_PLAIN), 20)
    full9 = graph_ms(lambda: cuda_timing.gardner_cuda(
        xg, sps, alpha, beta, 0.0, n_sym - 1), 2)
    # bytes: the samples read once, the symbols written once; operations
    # a symbol: two interpolations on two rails (~22 each), the error and
    # the loop filter
    bnd9 = bound_ms(8.0 * (len(x_short) + GARDNER_PLAIN),
                    100.0 * GARDNER_PLAIN, FP32_FLOPS)
    print(f"[42 gardner_qpsk_2e22, sps {sps}, offset {GARDNER_TAU}] S9 "
          f"launches {l9}; SER after lock {ser_all:.3g} over "
          f"{tail - 2000} symbols (lag {lag}), final mu {float(gmu):.4f}; "
          f"F8: EVM near "
          f"sample 2^17 {evm_17:.2f} dB, last 8000 symbols {evm_end:.2f} dB"
          f" (gate: within {F8_EVM_DB} dB); S9 = plain walk on the card over"
          f" 2^12 symbols: {same9}; S9 {ms9:.4f} ms at 2^12 symbols (CUDA "
          f"graph, {ms9 / GARDNER_PLAIN * 1e6:.1f} ns a symbol), "
          f"{full9:.3f} ms over the 2^22-sample stream "
          f"({L_GARDNER / (full9 * 1e3):.1f} Msamples/s); plain walk "
          f"{plain9_ms:.1f} ms; bound {bnd9[0]:.5f} ms ({bnd9[1]}) | {smi}",
          flush=True)
    ok &= (l9 == 1 and ser_all == 0.0 and same9
           and abs(evm_end - evm_17) <= F8_EVM_DB and np.isfinite(g).all()
           and g.shape == ((L_GARDNER - 4) // sps - 1,))
    xsb = xg[: 1 << 20]
    row("symbol_sync_block 2^20", lambda: timing.symbol_sync_block(xsb, sps),
        1 << 20, "Msamples/s")
    ssb_syms, _ = timing.symbol_sync_block(xsb, sps)
    d2 = host(ssb_syms)
    ser_ob = best_aligned_ser(idx[:len(d2)], (d2.real < 0).astype(int)
                              + 2 * (d2.imag < 0))
    print(f"[42 symbol_sync_block, 2^20] SER {ser_ob:.3g} (gate {MAX_SER})",
          flush=True)
    ok &= ser_ob < MAX_SER

    # the CLI: tx (fm, qam 16) read back by rx, adsb and ais
    with tempfile.TemporaryDirectory() as d:
        fm_f, fm_a = os.path.join(d, "fm.cf32"), os.path.join(d, "fm_a.cf32")
        rc1, line, w_tx = run_cli(cli_main, ["tx", fm_f, "--mod", "fm",
                                             "--samples", str(L_TX_MSG)])
        rc2, _, w_rx = run_cli(cli_main, ["rx", fm_f, "-o", fm_a])
        audio = read_iq(fm_a).real
        msg = np.sin(2 * np.pi * 0.002 * np.arange(L_TX_MSG))
        corr = best_corr(audio, msg)
        print(f"[42 tx fm, 2^22 message samples -> 2^24 IQ] {line.strip()}; "
              f"rx reads it back: correlation {corr:.5f} (gate "
              f"{TX_CORR_MIN}); tx {w_tx:.2f} s, rx {w_rx:.2f} s file to "
              f"file | {smi}", flush=True)
        ok &= rc1 == 0 and rc2 == 0 and corr > TX_CORR_MIN
        q_f, q_b = os.path.join(d, "qam.cf32"), os.path.join(d, "qam_b.cf32")
        rc1, line, w_tx = run_cli(cli_main, ["tx", q_f, "--mod", "qam",
                                             "--order", "16", "--samples",
                                             str(L_TX_MSG)])
        iq = read_iq(q_f)
        X = torch.fft.fft(torch.from_numpy(iq).to(dev)).abs() ** 2
        f = torch.fft.fftfreq(len(iq), device=dev)
        inband = ((f - 0.2 / (2 * np.pi) + 0.5) % 1.0 - 0.5).abs() < 0.1
        frac = float(X[inband].sum() / X.sum())
        rc2, _, w_rx = run_cli(cli_main, ["rx", q_f, "--demod", "none", "-o",
                                          q_b])
        bb = torch.from_numpy(read_iq(q_b)).to(dev)
        mf = host(linear_mod.matched_filter(bb, 4))
        ph = max(range(4), key=lambda p: float(np.mean(np.abs(mf[p::4]) ** 2)))
        z = mf[ph::4].copy()
        for c0 in range(0, len(z), 1 << 16):     # a gain a block of rx
            seg = z[c0:c0 + (1 << 16)]
            z[c0:c0 + (1 << 16)] = seg / np.sqrt(np.mean(np.abs(
                seg[min(1000, len(seg) // 2):]) ** 2))
        pts = linear_mod.constellation("qam", 16)
        got = np.argmin(np.abs(z[:, None] - pts[None, :]), 1)
        bits_tx = np.random.default_rng(0).integers(0, 2, L_TX_MSG)
        sym_tx = bits_tx.reshape(-1, 4) @ np.array([8, 4, 2, 1])
        ser_q = min(float(np.mean(sym_tx[1000 - lag2:len(got) - 100 - lag2]
                                  != got[1000:len(got) - 100]))
                    for lag2 in range(0, 40))
        print(f"[42 tx qam 16, 2^22 bits -> {len(iq)} IQ] {line.strip()}; "
              f"{frac:.4f} of the power within 0.1 of the carrier (gate "
              f"{QAM_INBAND_MIN}); rx --demod none, matched filter, slicer: "
              f"SER {ser_q:.3g} (gate {MAX_SER}); tx {w_tx:.2f} s, rx "
              f"{w_rx:.2f} s | {smi}", flush=True)
        ok &= (rc1 == 0 and rc2 == 0 and frac > QAM_INBAND_MIN
               and ser_q <= MAX_SER)
        del X, f, inband, bb

        # adsb_1024: 1024 DF17 frames at 2 Msps (480 samples each, 1100
        # apart with up to 100 of jitter), noise, random phases
        n_rec = N_ADSB * 1100 + 2000
        rec = (0.02 * (rng.standard_normal(n_rec) + 1j
                       * rng.standard_normal(n_rec))).astype(np.complex64)
        icaos = rng.choice(1 << 24, N_ADSB, replace=False)
        starts = []
        for i, ic in enumerate(icaos):
            env = adsb.ppm_modulate(adsb.encode_df17(int(ic), rng.integers(
                0, 2, 56)), 2)
            starts.append(1000 + i * 1100 + int(rng.integers(0, 100)))
            rec[starts[-1]:starts[-1] + len(env)] += (
                env * np.exp(2j * np.pi * rng.random())).astype(np.complex64)
        t0 = time.perf_counter()
        frames = adsb.decode(rec, limit=2 * N_ADSB, device=dev)
        w_lib = time.perf_counter() - t0
        frames_cpu = adsb.decode(rec, limit=2 * N_ADSB, device="cpu")
        same_a = [(f["start"], f["crc_ok"], f["icao"]) for f in frames] == [
            (f["start"], f["crc_ok"], f["icao"]) for f in frames_cpu]
        true_starts = set(starts)
        at_true = [f for f in frames if f["start"] in true_starts]
        found = {f["icao"] for f in frames if f["crc_ok"]}
        n_found = len(found & set(int(v) for v in icaos))
        cut = starts[ADSB_CLI_FRAMES] - 500
        a_f = os.path.join(d, "adsb.cf32")
        write_iq(a_f, rec[:cut])
        rc, out, w_a = run_cli(cli_main, ["adsb", a_f, "--all"])
        rows = [json.loads(r) for r in out.strip().splitlines()]
        want = [{"start": f["start"], "df": f["df"],
                 "icao": f"{f['icao']:06X}", "crc_ok": f["crc_ok"],
                 "confidence": round(f["confidence"], 3)}
                for f in adsb.decode(rec[:cut], device=dev)]
        print(f"[42 adsb_1024, {n_rec} samples at 2 Msps] decode: "
              f"{len(frames)} frames, {len(at_true)} at a true preamble, "
              f"all with their CRC {all(f['crc_ok'] for f in at_true)}, "
              f"{n_found} of {N_ADSB} ICAOs back (gate {ADSB_MIN_FOUND}; the "
              f"reference's frame walk lets a later candidate within one "
              f"frame span take a start), = its CPU run {same_a}; "
              f"{len(frames) / w_lib:.1f} frames/s by host ({w_lib:.3f} s); "
              f"the adsb command on the first {ADSB_CLI_FRAMES} frames "
              f"(its limit): {len(rows)} rows = the library's {rows == want}"
              f", {len(rows) / w_a:.1f} frames/s ({w_a:.3f} s) | {smi}",
              flush=True)
        ok &= (rc == 0 and same_a and all(f["crc_ok"] for f in at_true)
               and n_found >= ADSB_MIN_FOUND * N_ADSB and rows == want)

        # ais_256: 256 GMSK bursts (BT 0.4, sps 8); the receiver integrates
    # over symbols counted from the recording's start (no timing recovery,
    # as in JAX), so the gaps are whole symbols
        mmsi = rng.choice(10 ** 9, N_AIS, replace=False)
        parts = [np.zeros(512, np.complex64)]
        for m in mmsi:
            parts += [ais.ais_transmit(ais.build_type1_payload(
                int(m), rng.uniform(-80, 80), rng.uniform(-170, 170)),
                device=dev), np.zeros(8 * int(rng.integers(40, 100)),
                                      np.complex64)]
        rec = np.concatenate(parts)
        rec = (rec + 0.05 * (rng.standard_normal(len(rec)) + 1j
                             * rng.standard_normal(len(rec)))
               ).astype(np.complex64)
        s_f = os.path.join(d, "ais.cf32")
        write_iq(s_f, rec)
        rc, out, w_s = run_cli(cli_main, ["ais", s_f])
        rows = [json.loads(r) for r in out.strip().splitlines()]
        got_m = sorted(r["mmsi"] for r in rows)
        print(f"[42 ais_256, {len(rec)} samples] {len(rows)} frames with "
              f"their CRC, every MMSI back {got_m == sorted(int(m) for m in mmsi)}"
              f"; {len(rows) / w_s:.1f} bursts/s by host ({w_s:.3f} s) | "
              f"{smi}", flush=True)
        ok &= rc == 0 and got_m == sorted(int(m) for m in mmsi)

    # the other modems' round trips at 2^22 samples
    msg = torch.sin(2 * np.pi * 0.001 * torch.arange(L_MODEM, device=dev)
                    ).float()
    st_am = am.dc_blocker_init(device=dev)

    def am_rt():
        return am.am_demodulate_envelope(st_am, am.am_modulate(msg, 0.5),
                                         1e-4)[0]
    e = host(am_rt())[1 << 17:]
    c_am = float(np.corrcoef(e, host(msg)[1 << 17:])[0, 1])
    taps, tail = am.hilbert_init(127, device=dev)
    tone2 = torch.sin(2 * np.pi * 0.05 * torch.arange(L_MODEM, device=dev)
                      ).float()

    def ssb_rt():
        a, _ = am.ssb_modulate(taps, tail, tone2)
        return a, am.ssb_demodulate(a)
    a_ssb, r_ssb = ssb_rt()
    e_ssb = float((r_ssb[63:] - tone2[:-63]).abs().max())
    X = torch.fft.fft(a_ssb[256:]).abs() ** 2
    half = X.shape[0] // 2
    supp = 10 * np.log10(float(X[1:half].sum() / X[half + 1:].sum()))
    print(f"[42 am, ssb, 2^22] AM envelope correlation {c_am:.6f} (gate "
          f"0.999); SSB demodulated = the tone 63 samples late within "
          f"{e_ssb:.3g}, the lower sideband {supp:.1f} dB down (gate 30, "
          f"tests/test_models.py:193)", flush=True)
    ok &= c_am > 0.999 and e_ssb == 0.0 and supp > 30.0
    row("am envelope round trip", am_rt, L_MODEM, "Msamples/s")
    row("ssb round trip", ssb_rt, L_MODEM, "Msamples/s")

    gb = torch.from_numpy(rng.integers(0, 2, L_MODEM // 8)).to(dev)
    st_g = gmsk.gmsk_mod_init(0.4, 8, device=dev)
    st_gd = gmsk.gmsk_demod_init(0.4, 8, device=dev)

    def gmsk_rt():
        iq, _ = gmsk.gmsk_modulate(st_g, gb, 8, 0.4)
        return gmsk.gmsk_demod_discriminator(st_gd, iq, 8, 0.4)[0]
    dly = gmsk.gmsk_demod_delay_symbols(8)
    e_g = int((gmsk_rt()[dly:] != gb[:-dly]).sum())
    gm = gb[:1 << 16]
    iq_g, _ = gmsk.gmsk_modulate(gmsk.gmsk_mod_init(0.3, 8, device=dev), gm,
                                 8, 0.3)
    e_gm = int((gmsk.gmsk_demod_matched(iq_g, 8, 0.3)[:-4] != gm[:-4]).sum())
    fs_sym = torch.from_numpy(rng.integers(0, 4, L_MODEM // 16)).to(dev)
    st_f = torch.ones((), dtype=torch.complex64, device=dev)

    def fsk_rt():
        iq, _ = fsk.fsk_modulate(fs_sym, 16, 4, 0.05)
        return (fsk.fsk_demod_discriminator(st_f, iq, 16, 4, 0.05)[0],
                fsk.fsk_demod_matched(iq, 16, 4, 0.05))
    fd, fmt = fsk_rt()
    e_f = int((fd != fs_sym).sum() + (fmt != fs_sym).sum())
    print(f"[42 gmsk, fsk, 2^22 samples] GMSK (BT 0.4) discriminator "
          f"errors {e_g}, matched (BT 0.3, 2^16 bits) errors {e_gm}; 4-FSK "
          f"(sps 16) discriminator + matched errors {e_f} (gates 0)",
          flush=True)
    ok &= e_g == 0 and e_gm == 0 and e_f == 0
    row("gmsk_bt04 round trip", gmsk_rt, L_MODEM // 8, "Mbits/s")
    row("fsk4 round trip", fsk_rt, L_MODEM // 16, "Msymbols/s")

    cb = torch.from_numpy(rng.integers(0, 2, (L_MODEM >> 9) * 9)).to(dev)
    modem = css.CSSModem(9, device=dev)

    def css_rt():
        return modem.demodulate(modem.modulate(cb))
    e_c = int((css_rt() != cb).sum())
    code = torch.from_numpy(2.0 * np.asarray(sequences.gold_codes(5)[0])
                            - 1.0).to(dev)
    ds = torch.from_numpy(GRAY[rng.integers(0, 4, L_MODEM // 31)].astype(
        np.complex64)).to(dev)

    def dsss_rt():
        return dsss.dsss_despread(dsss.dsss_spread(ds, code), code)
    e_d = float((dsss_rt() - ds).abs().max())
    chips = dsss.dsss_spread(ds[:4096], code)
    k_acq, _ = dsss.dsss_acquire(torch.cat([chips.new_zeros(13), chips]),
                                 code, 62)
    hop = fhss.FHSS(64, 256, device=dev)
    xh = torch.from_numpy(cnoise(rng, L_MODEM).astype(np.complex64)).to(dev)

    def fhss_rt():
        return hop.dehop(hop.hop(xh))
    e_h = float((fhss_rt() - xh).abs().max())
    print(f"[42 css, dsss, fhss, 2^22] CSS (SF 9) bit errors {e_c} (gate 0); "
          f"DSSS (Gold 31) despread within {e_d:.3g} (gate 1e-5), acquired "
          f"offset {int(k_acq)} (want 13); FHSS (64 x 256) dehop(hop) within "
          f"{e_h:.3g} (gate 1e-5)", flush=True)
    ok &= e_c == 0 and e_d < 1e-5 and int(k_acq) == 13 and e_h < 1e-5
    row("css_sf9 round trip", css_rt, len(cb), "Mbits/s")
    row("dsss_gold31 round trip", dsss_rt, len(ds) * 31, "Mchips/s")
    row("fhss_64 round trip", fhss_rt, L_MODEM, "Msamples/s")

    text = "CQ CQ DE PORT K " * 8
    key = cw.cw_keyer(text, 64, 0.05, device=dev)
    key = key + torch.from_numpy(cnoise(rng, len(key), 0.2).astype(
        np.complex64)).to(dev)
    got_cw = cw.cw_decode(key)
    bursty = xh * 0.01
    for a0 in range(1 << 18, L_MODEM, 1 << 20):
        bursty[a0:a0 + (1 << 17)] *= 100.0
    bd = BurstDetector(256, -20.0, device=dev)
    det = bd.execute_block(bursty)
    rises = host(det["rises"])
    n_r = int((rises >= 0).sum())
    print(f"[42 cw, burst detector] CW decoded {got_cw == text.strip()} "
          f"({len(key)} samples); BurstDetector on 2^22: {n_r} rises "
          f"(want {len(range(1 << 18, L_MODEM, 1 << 20))})", flush=True)
    ok &= got_cw == text.strip() and n_r == len(range(1 << 18, L_MODEM,
                                                      1 << 20))
    row("cw decode", lambda: cw.cw_decode(key), len(key), "Msamples/s", n=2)
    row("burst_detector 2^22", lambda: bd.execute_block(bursty), L_MODEM,
        "Msamples/s")
    print(f"[42 phase time] {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    if not ok:
        fail("phase 42: an item-13c row disagrees with its reference")
    e_enc = kernel_entry("cvsd_encode", "cvsd_scan.cu",
                         "solid_dsp_tpu/models/cvsd.py:86 (lax.scan, no TPU "
                         "kernel)", l_enc, 0.0, enc_ms, plain_enc_ms, bnd8)
    e_dec = kernel_entry("cvsd_decode", "cvsd_scan.cu",
                         "solid_dsp_tpu/models/cvsd.py:119 (lax.scan, no TPU "
                         "kernel)", l_dec, err8, dec_ms, chunked_ms, bnd8)
    e_dec["pass_launches"] = l_pass
    e_dec["walk_ms"] = plain_dec_ms
    for e, full in ((e_enc, enc_full), (e_dec, dec_full)):
        e["timed_shape"] = f"{CVSD_LANES} lanes x {CVSD_PLAIN_N} samples"
        e["main_path_ms"] = full
    e9 = kernel_entry("gardner_loop", "gardner_scan.cu",
                      "solid_dsp_tpu/models/timing.py:124 (lax.scan, no TPU "
                      "kernel)", l9, err9, ms9, plain9_ms, bnd9)
    e9["timed_shape"] = f"{GARDNER_PLAIN} symbols at sps {sps}"
    e9["main_path_ms"] = full9
    return [e_enc, e_dec, e9]


def exact_cycles(n: int, freq: float, fs: float, dev) -> torch.Tensor:
    """(freq k / fs) mod 1 for k < n, float64 on the card, exact: freq / fs
    = p / q (a rational of floats) reduced in int64."""
    from fractions import Fraction
    r = Fraction(float(freq)) / Fraction(float(fs))
    k = torch.arange(n, device=dev, dtype=torch.int64)
    return torch.remainder(k * r.numerator, r.denominator).double() / \
        r.denominator


def broadcast_capture(dev, rng):
    """Phase 43 (a)'s capture, built on the card: the stereo multiplex at
    456 kHz (L a 1 kHz tone, R 3 kHz, pilot 0.1, fm_stereo_mpx) plus RDS at
    0.06 (rds_modulate of PS group sets for RDS_PI / RDS_PS, repeated),
    normalised, upsampled x4 by RationalResampler, FM-modulated at 75 kHz
    deviation onto +STATION_HZ of a FS_BCAST capture (the exact wrapped
    carrier phase), AWGN at 30 dB CNR.  Returns (N43 planar f32 blocks of
    L43 on the card, the whole groups sent)."""
    from solid_dsp_tpu_torch.design.firdes import firdes_kaiser
    from solid_dsp_tpu_torch.models import fm as fm_models
    from solid_dsp_tpu_torch.models import rds
    from solid_dsp_tpu_torch.ops.fir import RationalResampler
    fs = FS_BCAST / 4
    n = N43 * L43 // 4
    spb = int(round(fs / 1187.5))
    n_bits = n // spb
    sets = rds.make_ps_groups(RDS_PI, RDS_PS)
    bits = np.tile(sets, -(-n_bits // len(sets)))[:n_bits]
    sig = np.zeros(n, np.float32)
    sig[: n_bits * spb] = rds.rds_modulate(bits, fs)
    t = torch.arange(n, device=dev, dtype=torch.float64) / fs
    mpx = fm_models.fm_stereo_mpx(torch.sin(2 * np.pi * 1000.0 * t),
                                  torch.sin(2 * np.pi * 3000.0 * t), fs, 0.1)
    mpx = mpx + 0.06 * torch.from_numpy(sig).to(dev, torch.float64)
    mpx = mpx / mpx.abs().max()
    h = firdes_kaiser(129, 0.11, 80.0, 0.0)
    up = RationalResampler(4.0 * h / np.sum(h), 4, 1, dtype=torch.float64,
                           device=dev)
    m = up.execute_block(mpx)
    del mpx, t
    ph = (2 * np.pi * (75e3 / FS_BCAST)) * torch.cumsum(m, 0)
    ph += 2 * np.pi * exact_cycles(len(m), STATION_HZ, FS_BCAST, dev)
    del m
    g = torch.Generator(device=dev).manual_seed(SEED + 43)
    w = torch.randn((2, len(ph)), generator=g, device=dev,
                    dtype=torch.float64) * np.sqrt(10 ** (-30 / 10) / 2)
    planar = torch.stack([torch.cos(ph) + w[0], torch.sin(ph) + w[1]]).float()
    del ph, w
    return ([planar[:, i * L43:(i + 1) * L43].contiguous()
             for i in range(N43)], n_bits // 104)


def pager_capture(dev, rng):
    """Phase 43 (b)'s capture: N_PAGES POCSAG pages (distinct 21-bit
    addresses, two a frame slot, functions 0-3, alphanumeric messages at
    their slot's capacity), each a transmission (preamble + batch) keyed
    on a grid of 2048 bits, as CPFSK at 1200 baud, +-4.5 kHz (bit 0 the
    high tone) at +PAGER_HZ of a FS_PAGER capture, the carrier off between
    transmissions, AWGN 10 dB under the carrier over the whole band (28 dB
    in the 38.4 kHz channel).  Built on the card.  Returns (N43 planar f32
    blocks, the pages sent as (address, function, message))."""
    from solid_dsp_tpu_torch.models import pocsag
    alphabet = list("ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 .,-")
    sps = int(round(FS_PAGER / 1200.0))
    n_sym = N43 * L43 // sps
    grid = n_sym // N_PAGES
    sym = np.zeros(n_sym)
    pages, used = [], set()
    for k in range(N_PAGES):
        slot = k % 8
        addr = int(rng.integers(0, 1 << 18)) << 3 | slot
        while addr in used:
            addr = int(rng.integers(0, 1 << 18)) << 3 | slot
        used.add(addr)
        msg = "".join(rng.choice(alphabet, (15 - 2 * slot) * 20 // 7))
        pages.append((addr, k % 4, msg))
        b = pocsag.pocsag_encode(addr, msg, k % 4)
        sym[k * grid: k * grid + len(b)] = np.where(b == 0, 1.0, -1.0)
    s = torch.from_numpy(sym).to(dev)
    on = (s != 0).double().repeat_interleave(sps)
    ph = (2 * np.pi * 4500.0 / FS_PAGER) * torch.cumsum(
        s.repeat_interleave(sps), 0)
    ph += 2 * np.pi * exact_cycles(len(ph), PAGER_HZ, FS_PAGER, dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 431)
    w = torch.randn((2, len(ph)), generator=g, device=dev,
                    dtype=torch.float64) * np.sqrt(0.1 / 2)
    planar = torch.stack([on * torch.cos(ph) + w[0],
                          on * torch.sin(ph) + w[1]]).float()
    del ph, w, on
    return ([planar[:, i * L43:(i + 1) * L43].contiguous()
             for i in range(N43)], pages)


def chain_over(apply, init, blocks):
    """(the chain's outputs over the blocks, concatenated; its state)."""
    st, outs = init(), []
    for b in blocks:
        out, st = apply(st, b)
        outs.append(out)
    return torch.cat(outs), st


def protocol_phases(dev, smi) -> dict:
    """Phase 43: the last modules on the card as two real receivers and
    the tools around them: (a) a broadcast-FM station with RDS through
    config 4's chain (K1), the stereo decoder (S3's de-emphasis) and
    rds_receive; (b) a POCSAG pager channel cut out of a wideband capture
    by the DDC body (M = 64) and decoded by pocsag_receive; (c) DTMF;
    (d) the modulation classifier; (e) the channel sounder through a TDL
    channel; (f) MetricsCollector, benchmark, trace and roofline on
    config 4's blocks; (g) a crash of a checkpointing worker on the card
    resumed by run_supervised, and the distributed checkpoints at world
    size 1.  Returns the kernels' launches on the receivers' and the
    collector's paths."""
    import importlib.util
    import shutil
    import tempfile

    from solid_dsp_tpu_torch.models import (dtmf, linear_mod, modclass,
                                            pocsag, rds, sounder)
    from solid_dsp_tpu_torch.models import channel as channel_models
    from solid_dsp_tpu_torch.models import fm as fm_models
    from solid_dsp_tpu_torch.models.rx_chain import (RxChain, RxChainConfig,
                                                      make_rx_chain)
    from solid_dsp_tpu_torch.ops import cuda_build, cuda_ddc
    from solid_dsp_tpu_torch.parallel import fault
    from solid_dsp_tpu_torch.utils import (MetricsCollector, benchmark,
                                           profiling, rssi_db, trace)

    rng = np.random.default_rng(SEED + 43)
    t_phase = time.perf_counter()
    ok = True
    counts: dict = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v

    def wall_s(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def row(label, fn, count, unit, n=2):
        wall, enq = timed(fn, n)
        busy, top = profiled_busy(fn, max(1, n // 2))
        print(f"[43 {label}] {count / (wall * 1e3):.2f} {unit} (wall "
              f"{wall:.4f} ms a call over {n}), host {enq:.4f} ms a call, "
              f"device busy {busy:.4f} ms, idle "
              f"{max(0.0, 1 - busy / wall):.0%}; largest kernels: {top} | "
              f"{smi}", flush=True)
        return wall

    # (a) broadcast FM with RDS through K1
    (blocks, sent), t_cap = wall_s(lambda: broadcast_capture(dev, rng))
    fs_mpx = FS_BCAST / 4
    cfg = RxChainConfig(carrier_freq=2 * np.pi * STATION_HZ / FS_BCAST,
                        decimation=4, fir_taps=64, fir_cutoff=0.1,
                        agc_mode="block", demod="fm", nco_mode="exact",
                        input_format="planar", fused_ddc="on",
                        fir_precision="x3")
    init, apply = make_rx_chain(cfg, dev)
    init_p, apply_p = make_rx_chain(replace(cfg, ddc_engine="torch"), dev)
    reset_cli_counts()
    (mpx, _), t_chain = wall_s(lambda: chain_over(apply, init, blocks))
    (stereo, t_st) = wall_s(lambda: fm_models.fm_stereo_decode(
        mpx, fs_mpx, deemphasis_tau=75e-6))
    info, t_rds = wall_s(lambda: rds.rds_receive(mpx, fs_mpx))
    c_a = read_cli_counts()
    add(c_a)
    bits_k, t_demod = wall_s(lambda: rds.rds_demodulate_bits(mpx, fs_mpx))
    groups_k, t_sync = wall_s(lambda: rds.block_sync_decode(bits_k))
    mpx_p, _ = chain_over(apply_p, init_p, blocks)
    groups_p = rds.block_sync_decode(rds.rds_demodulate_bits(mpx_p, fs_mpx))
    left, right, pilot = (v.cpu().numpy() for v in stereo)
    mid = slice(len(left) // 4, len(left) // 4 + (1 << 22))
    l1, r1 = tone_power(left[mid], 1000.0, fs_mpx, 0), tone_power(
        right[mid], 1000.0, fs_mpx, 0)
    l3, r3 = tone_power(left[mid], 3000.0, fs_mpx, 0), tone_power(
        right[mid], 3000.0, fs_mpx, 0)
    sep_l, sep_r = 10 * np.log10(l1 / r1), 10 * np.log10(r3 / l3)
    n_iq = N43 * L43
    good_a = (info["pi"] == RDS_PI and info["ps"] == RDS_PS
              and info["n_groups"] >= RDS_MIN_GROUPS * sent
              and groups_k == groups_p and len(groups_k) == info["n_groups"]
              and min(sep_l, sep_r) >= CLI_SEPARATION_MIN_DB
              and c_a["ddc_fm"] == N43 and c_a["iir_scan"] > 0)
    ok &= good_a
    lg = f"{N43} x 2^{L43.bit_length() - 1}"
    print(f"[43 (a) broadcast FM + RDS, {lg} IQ at {FS_BCAST / 1e6:g} "
          f"Msps ({n_iq / FS_BCAST:.1f} s), station +{STATION_HZ / 1e3:g} "
          f"kHz] PI {info['pi']:#06x} PS {info['ps']!r}: {info['n_groups']} "
          f"of {sent} whole groups sent decoded (gate >= "
          f"{RDS_MIN_GROUPS:.0%}), the same group list as the plain chain's "
          f"MPX: {groups_k == groups_p}; stereo separation L {sep_l:.1f} dB, "
          f"R {sep_r:.1f} dB (gate {CLI_SEPARATION_MIN_DB}), pilot "
          f"{float(pilot):.4f}; K1 launches {c_a['ddc_fm']}, S3 "
          f"{c_a['iir_scan']}; capture built in {t_cap:.2f} s; first calls' "
          f"wall: chain {t_chain:.3f} s, stereo {t_st:.3f} s, rds_receive "
          f"{t_rds:.3f} s; then rds_demodulate_bits {t_demod:.3f} s (the "
          f"card and two copies), block sync {t_sync:.4f} s (host); at "
          f"{time.perf_counter() - t_phase:.1f} s | {smi}", flush=True)
    row(f"(a) chain, {lg} IQ", lambda: chain_over(apply, init, blocks),
        n_iq, "Msamples/s of IQ", n=2)
    row("(a) fm_stereo_decode", lambda: fm_models.fm_stereo_decode(
        mpx, fs_mpx, deemphasis_tau=75e-6), len(mpx), "Msamples/s of MPX",
        n=1)
    row("(a) rds_receive", lambda: rds.rds_receive(mpx, fs_mpx),
        len(mpx), "Msamples/s of MPX", n=2)
    del stereo, mpx_p

    # (f) metrics and profiling on the same blocks
    chain = RxChain(cfg, device=dev)
    mc = MetricsCollector()
    reset_cli_counts()
    outs = [mc.measure(chain, b) for b in blocks]
    add(read_cli_counts())
    gain = float(chain.state["agc"]["gain"])
    last = mc.history[-1]
    same_f = torch.equal(torch.cat(outs), mpx)
    good_f = (last.rssi_db == rssi_db(gain)
              and abs(last.rssi_db + 20.0 * np.log10(gain)) < 1e-9
              and len(mc.history) == N43 and same_f)
    # benchmark() and CUDA events around the same calls (the block's
    # time by events bracketing them, after a warm-up)
    st0 = init()
    benchmark(apply, st0, blocks[0], warmup=2, iters=1)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    bench = benchmark(apply, st0, blocks[0], warmup=0, iters=50,
                      samples=L43)
    e1.record()
    torch.cuda.synchronize()
    bench_ms = bench["seconds_per_call"] * 1e3
    ev_ms = e0.elapsed_time(e1) / 50
    good_f &= abs(bench_ms - ev_ms) <= BENCH_RTOL * ev_ms
    logdir = tempfile.mkdtemp(prefix="solid_trace_")
    try:
        with trace(logdir):      # the tracer may drop its first records
            for _ in range(TRACE_BLOCKS):
                apply(st0, blocks[0])
        files = [f for f in os.listdir(logdir) if f.endswith(".json")]
        with open(os.path.join(logdir, files[0])) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    knames = sorted({e["name"] for e in events
                     if e.get("cat") == "kernel"})
    k1_records = sum(1 for e in events if e.get("cat") == "kernel"
                     and "ddc_fm" in e["name"])
    good_f &= len(files) == 1 and k1_records > 0
    T = L43 // 4
    rl = profiling.roofline("config-4 block (K1 chain)", ev_ms / 1e3,
                            8.0 * cfg.fir_taps * T, 8.0 * L43 + 4.0 * T)
    ok &= good_f
    print(f"[43 (f) metrics, profiling] MetricsCollector over the {N43} "
          f"blocks: last {last.to_json()}; rssi_db = -20 log10(state gain "
          f"{gain:.6g}): {last.rssi_db == rssi_db(gain)}; outputs equal to "
          f"(a)'s: {same_f}; benchmark() {bench_ms:.4f} ms a block vs "
          f"CUDA events around the same 50 calls {ev_ms:.4f} ms (gate "
          f"{BENCH_RTOL:.0%}); trace wrote "
          f"{len(files)} file, {k1_records} K1 records of {TRACE_BLOCKS} "
          f"blocks, kernels {[k[:48] for k in knames]}; {rl!r} "
          f"against {profiling.DEFAULT_CHIP}; at "
          f"{time.perf_counter() - t_phase:.1f} s | {smi}", flush=True)
    del outs, chain

    # (b) a POCSAG pager channel through the DDC body
    (pblocks, pages), t_pcap = wall_s(lambda: pager_capture(dev, rng))
    cfg_p = RxChainConfig(carrier_freq=2 * np.pi * PAGER_HZ / FS_PAGER,
                          decimation=PAGER_M, fir_taps=PAGER_TAPS,
                          fir_cutoff=PAGER_CUTOFF, agc_mode="block",
                          demod="none", nco_mode="exact",
                          input_format="planar", fused_ddc="on",
                          fir_precision="x3")
    init_b, apply_b = make_rx_chain(cfg_p, dev)
    init_bp, apply_bp = make_rx_chain(replace(cfg_p, ddc_engine="torch"),
                                      dev)
    route_b = cuda_ddc.body_geometry(PAGER_TAPS, PAGER_M)
    fs_ch = FS_PAGER / PAGER_M
    sep = 9000.0 / fs_ch
    reset_cli_counts()
    (z, _), t_pchain = wall_s(lambda: chain_over(apply_b, init_b, pblocks))
    got, t_prx = wall_s(lambda: pocsag.pocsag_receive(z, PAGER_SPS, sep))
    c_b = read_cli_counts()
    add(c_b)
    zp, _ = chain_over(apply_bp, init_bp, pblocks)
    got_p = pocsag.pocsag_receive(zp, PAGER_SPS, sep)
    syms, t_disc = wall_s(lambda: pocsag.fsk.fsk_demod_discriminator(
        pocsag.fm_demod_init(device=dev), z, PAGER_SPS, 2, sep)[0].cpu())
    _, t_frame = wall_s(lambda: pocsag.pocsag_decode_bits(
        (1 - syms.numpy()).astype(np.int8)))
    decoded = [(p["address"], p["function"], p["message"]) for p in got]
    body_launches = c_b["ddc_body"] + c_b["ddc_body_unaligned"]
    good_b = decoded == pages and got == got_p and body_launches == N43
    ok &= good_b
    print(f"[43 (b) POCSAG, {lg} IQ at {FS_PAGER / 1e6:g} Msps "
          f"({N43 * L43 / FS_PAGER:.1f} s), channel +{PAGER_HZ / 1e3:g} kHz, "
          f"M = {PAGER_M}, {PAGER_TAPS} taps] {len(got)} pages decoded, all "
          f"{N_PAGES} exact (address, function, message): "
          f"{decoded == pages}; the same pages as the plain chain's output: "
          f"{got == got_p}; body route {route_b[0]} "
          f"({'K2' if c_b['ddc_body'] else 'K3'}: {body_launches} launches); "
          f"capture {t_pcap:.2f} s; wall: chain {t_pchain:.3f} s "
          f"({N43 * L43 / t_pchain / 1e6:.1f} Msamples/s of IQ), "
          f"pocsag_receive {t_prx:.3f} s (discriminator and copy "
          f"{t_disc:.3f} s, framing and BCH on the host {t_frame:.3f} s); at "
          f"{time.perf_counter() - t_phase:.1f} s | {smi}", flush=True)
    row(f"(b) chain, {lg} IQ", lambda: chain_over(apply_b, init_b,
                                                  pblocks),
        N43 * L43, "Msamples/s of IQ", n=2)
    del pblocks, zp

    # (c) DTMF: 1024 digits, all 16 keys, 20 dB SNR
    keys = "123A456B789C*0#D"
    digits = "".join(rng.permutation(list(keys * (N_DTMF // 16))))
    x = dtmf.dtmf_generate(digits)
    x = x + 0.05 * rng.standard_normal(len(x)).astype(np.float32)
    xd = torch.from_numpy(x).to(dev)
    got_d, t_d = wall_s(lambda: dtmf.dtmf_decode(xd))
    ok &= got_d == digits
    print(f"[43 (c) DTMF, {N_DTMF} digits, {len(x)} samples at 8 kHz, 20 dB "
          f"SNR] decoded == sent: {got_d == digits} ({len(got_d)} digits); "
          f"{t_d:.3f} s ({len(x) / t_d / 1e6:.2f} Msamples/s) | {smi}",
          flush=True)
    row("(c) dtmf_decode", lambda: dtmf.dtmf_decode(xd), len(x),
        "Msamples/s")

    # (d) the classifier: 256 bursts of 4096 symbols a class at 15 dB,
    # random phase and gain (+-20 dB), and 256 of noise; then the JAX
    # test's length (100k symbols, 16 bursts a class) for its accuracy
    def bursts(B, N):
        xs = []
        for scheme, m in modclass.DEFAULT_CLASSES:
            pts = linear_mod.constellation(scheme, m)
            pts = pts / np.sqrt(np.mean(np.abs(pts) ** 2))
            s = pts[rng.integers(0, m, (B, N))] * np.exp(
                2j * np.pi * rng.random((B, 1)))
            s += np.sqrt(10 ** -1.5 / 2) * (rng.standard_normal((B, N))
                                            + 1j * rng.standard_normal((B, N)))
            xs.append(10 ** rng.uniform(-1, 1, (B, 1)) * s)
        xs.append(10 ** rng.uniform(-1, 1, (B, 1)) * (
            rng.standard_normal((B, N)) + 1j * rng.standard_normal((B, N)))
            / np.sqrt(2))
        want = [c for c in modclass.DEFAULT_CLASSES for _ in range(B)] + \
            ["noise"] * B
        return torch.from_numpy(np.concatenate(xs).astype(np.complex64)), want

    def labels(xb):
        m = torch.stack([v.double() for v in modclass.signal_moments(xb)])
        m = m.cpu().numpy()
        return [modclass.classify_moments(m[:, i])[0]
                for i in range(m.shape[1])]

    xb, want_b = bursts(MOD_BURSTS, MOD_SYMBOLS)
    xbd = xb.to(dev)
    lab, t_lab = wall_s(lambda: labels(xbd))
    lab_cpu = labels(xb)
    acc = {str(c): float(np.mean([lab[i] == c for i in range(len(lab))
                                  if want_b[i] == c]))
           for c in list(modclass.DEFAULT_CLASSES) + ["noise"]}
    xl, want_l = bursts(32, 100_000)
    lab_l = labels(xl.to(dev))
    same_l = lab_l == labels(xl)
    acc_l = {str(c): float(np.mean([lab_l[i] == c
                                    for i in range(len(lab_l))
                                    if want_l[i] == c]))
             for c in list(modclass.DEFAULT_CLASSES) + ["noise"]}
    # the JAX tests' own bursts (tests/test_modclass.py:16-25, 42-47 and
    # 68-73: seed m, phase 0.3, 100k symbols; the noise burst of seed 5)
    jax_cases = []
    for scheme, m in modclass.DEFAULT_CLASSES:
        r = np.random.default_rng(m)
        pts = linear_mod.constellation(scheme, m)
        pts = pts / np.sqrt(np.mean(np.abs(pts) ** 2))
        sym = pts[r.integers(0, m, 100_000)] * np.exp(1j * 0.3)
        sym = sym + np.sqrt(10 ** -1.5 / 2) * (
            r.standard_normal(100_000) + 1j * r.standard_normal(100_000))
        jax_cases.append((sym.astype(np.complex64), (scheme, m)))
    r = np.random.default_rng(5)
    jax_cases.append((((r.standard_normal(100_000) + 1j * r.standard_normal(
        100_000)) / np.sqrt(2)).astype(np.complex64), "noise"))
    jax_ok = all(modclass.classify(torch.from_numpy(v).to(dev))[0] == want
                 for v, want in jax_cases)
    ok &= (lab == lab_cpu and same_l and jax_ok
           and min(acc_l.values()) >= MOD_MIN_ACC)
    print(f"[43 (d) classifier, ({len(want_b)}, {MOD_SYMBOLS}) bursts, 15 dB, "
          f"gain +-20 dB] labels equal to the CPU run's: {lab == lab_cpu}; "
          f"accuracy at 4096 symbols {acc}; the JAX tests' own bursts "
          f"(test_classify_at_15db, test_noise_rejected) right: {jax_ok}; "
          f"32 bursts a class and of noise at their 100k symbols, gain "
          f"+-20 dB: accuracy {acc_l} (gate {MOD_MIN_ACC} a class), equal "
          f"to the CPU run's: {same_l}; moments + labels {t_lab:.3f} s; at "
          f"{time.perf_counter() - t_phase:.1f} s | {smi}",
          flush=True)
    row("(d) signal_moments, (1536, 4096)", lambda: modclass.signal_moments(
        xbd), xbd.numel(), "Msymbols/s", n=5)
    del xbd, xl

    # (e) the sounder: ZC 255, cp 64, 64 repeats through a TDL channel
    tx = sounder.sound(255, 7, 64, SOUNDER_REPEATS, device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 435)
    y, h = channel_models.tdl_fading_channel(g, tx, "eva", 20e6,
                                             doppler=1e-5)
    # the gains the sounder sees: each tap's mean over the burst
    y = channel_models.awgn(g, y, snr_db=10.0)
    delays, _ = channel_models.tdl_taps("eva", 20e6)
    cir, cinfo = sounder.estimate_cir(y, 255, 7, 64, SOUNDER_REPEATS, 64)
    cir_c, cinfo_c = sounder.estimate_cir(y.cpu(), 255, 7, 64,
                                          SOUNDER_REPEATS, 64)
    true_p = (h.mean(dim=1).abs() ** 2).cpu().numpy()
    noise = 10 ** (cinfo["noise_floor_db"] / 10)
    sig = set(np.nonzero(cinfo["significant"])[0].tolist())
    dl = [int(d) for d in delays]
    strong = [d for d, p in zip(dl, true_p) if p >= 30 * noise]
    off = sorted(sig - set(dl))
    p_est = np.abs(cir) ** 2
    pdp_err = max(abs(10 * np.log10(p_est[d] / p))
                  for d, p in zip(dl, true_p) if p >= 1000 * noise)
    cir_err = float(np.max(np.abs(cir - cir_c)) / np.max(np.abs(cir_c)))
    good_e = (set(strong) <= sig and len(off) <= 2
              and all(p_est[d] < 18 * noise for d in off)
              and pdp_err <= PDP_DB_ATOL and cir_err <= CIR_RTOL)
    ok &= good_e
    print(f"[43 (e) sounder, ZC 255 cp 64 x {SOUNDER_REPEATS} through EVA at "
          f"20 MHz, 10 dB a body] channel delays {dl}, significant taps "
          f"{sorted(sig)} (every tap 15 dB over the floor among them: "
          f"{set(strong) <= sig}; off the delays {off}, gate <= 2 under 18 x "
          f"the floor); PDP of the taps 30 dB over the floor within "
          f"{pdp_err:.3f} dB of the channel's (gate {PDP_DB_ATOL}); SNR "
          f"{cinfo['snr_db']:.1f} dB; card vs CPU {cir_err:.2e} x max|cir| "
          f"(gate {CIR_RTOL}) | {smi}", flush=True)

    # (g) checkpoints and supervision on the card
    repo = os.path.dirname(os.path.abspath(__file__))
    worker = os.path.join(repo, "tests", "torch_fault_worker.py")
    spec = importlib.util.spec_from_file_location("torch_fault_worker",
                                                  worker)
    wmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(wmod)
    built = sorted((p.name, p.stat().st_mtime_ns)
                   for p in cuda_build.BUILD_DIR.glob("*.so"))
    out_dir = tempfile.mkdtemp(prefix="solid_fault_")
    crash = os.path.join(out_dir, "crash_once")
    open(crash, "w").close()
    env = {**os.environ, "PYTHONPATH": repo}
    logs = []

    def spawn(worker_id, attempt):
        p = subprocess.Popen(
            [sys.executable, worker, "chain", out_dir, crash, dev.type,
             str(1 << 20)], env=env, cwd=repo, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        logs.append(p)
        return p
    try:
        codes, t_g = wall_s(lambda: fault.run_supervised(
            spawn, 1, max_restarts=2, timeout=180.0))
        outs = [p.stdout.read() for p in logs]
        init_w, apply_w = make_rx_chain(wmod.CONFIG4, dev)
        st_w, same_g = init_w(), True
        for i, xb in enumerate(wmod.make_blocks(123, 8, 1 << 20)):
            out, st_w = apply_w(st_w, torch.from_numpy(xb).to(dev))
            same_g &= np.array_equal(out.cpu().numpy(), np.load(
                os.path.join(out_dir, f"block_{i}.npy")))
        fault.save_distributed(st_w, os.path.join(out_dir, "d"), 7)
        step = fault.latest_distributed_step(os.path.join(out_dir, "d"))
        back = fault.load_distributed(os.path.join(out_dir, "d"), step,
                                      like=init_w())
        same_d = all(torch.equal(back[k], st_w[k]) if k != "agc" else all(
            torch.equal(back[k][j], st_w[k][j]) for j in st_w[k])
            for k in st_w)
        on_card = all(v.device.type == dev.type for v in back.values()
                      if isinstance(v, torch.Tensor))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    rebuilt = sorted((p.name, p.stat().st_mtime_ns)
                     for p in cuda_build.BUILD_DIR.glob("*.so")) != built
    good_g = (codes == [0] and len(logs) == 2 and same_g and step == 7
              and same_d and on_card and not rebuilt
              and "resumed at block 4" in outs[-1])
    ok &= good_g
    print(f"[43 (g) checkpoints, supervision] the config-4 chain over 8 x "
          f"2^20 on the card in a worker, killed before block 4 and "
          f"relaunched by run_supervised: codes {codes}, {len(logs)} "
          f"starts, resumed from its checkpoint: "
          f"{'resumed at block 4' in outs[-1]}, output bit-identical to an "
          f"uninterrupted run on the card: {same_g}; {t_g:.1f} s for both "
          f"starts; kernels rebuilt by a worker: {rebuilt}; "
          f"save_distributed / latest_distributed_step ({step}) / "
          f"load_distributed at world size 1 on the card equal: {same_d} "
          f"| {smi}", flush=True)
    if not good_g:
        print("\n".join(o[-2000:] for o in outs), flush=True)
    print(f"[43 phase time] {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    if not ok:
        fail("phase 43: a receiver or tool of the last modules disagrees "
             "with its reference")
    return counts


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs only on a GPU")
    from solid_dsp_tpu_torch.models import qpsk as qpsk_ops
    from solid_dsp_tpu_torch.models.rx_chain import RxChainConfig, make_rx_chain
    from solid_dsp_tpu_torch.ops import cuda_build, cuda_ddc
    from solid_dsp_tpu_torch.ops import ddc as ddc_ops
    from solid_dsp_tpu_torch.ops.nco import constrain

    dev = torch.device(DEVICE, 0)
    t_run = time.perf_counter()

    def stamp(phases: str):
        """The script's elapsed time after a group of phases."""
        print(f"[time] phases {phases} done at "
              f"{time.perf_counter() - t_run:.1f} s", flush=True)

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
    stamp("1-10")
    kernels += config5(dev, smi)
    stamp("11-16")
    kernels += config2(dev, smi)
    kernels += farrow_phases(dev, smi)
    stamp("17-21")
    kernels += parallel_phases(dev, smi)
    stamp("22-25")
    precision_phase(dev, smi)
    filter_phases(dev, smi)
    stamp("26-28")
    kernels += scan_phases(dev, smi)
    stamp("29-31")
    kernels += iir_phases(dev, smi)
    stamp("32-34")
    kernels += fast_phases(dev, smi, {
        "ddc_fm": k_ms, "ddc_body": body_stats["ddc_body"][1],
        "ddc_body_unaligned": body_stats["ddc_body_unaligned"][1]})
    stamp("35-36")
    kernels += p4_phases(dev, smi)
    stamp("37")
    cli_counts = cli_phases(dev, smi)
    stamp("38")
    kernels += item11_phases(dev, smi)
    stamp("39")
    kernels += item13a_phases(dev, smi)
    stamp("40")
    kernels += item13b_phases(dev, smi)
    stamp("41")
    kernels += item13c_phases(dev, smi)
    stamp("42")
    protocol_counts = protocol_phases(dev, smi)
    stamp("43")
    for k in kernels:
        k["launches"] += (cli_counts.get(k["name"], 0)
                          + protocol_counts.get(k["name"], 0))
    if not all(k["launches"] > 0 for k in kernels):
        fail("a kernel of the main paths was never launched")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
