"""Design sweeps of the port's kernels and routes on one NVIDIA GPU.

    python3 torch_kernel_sweep.py            # K6, the DDC body, K1
    python3 torch_kernel_sweep.py fir-route  # the FIR's two card routes
    python3 torch_kernel_sweep.py s3         # S3's chunk length and join
    python3 torch_kernel_sweep.py s4         # S4's three entries: Lc, lanes
    python3 torch_kernel_sweep.py latency    # S1, S2, S5, S7-S9: bounds
    python3 torch_kernel_sweep.py s8         # S8: decode's Lc, encode's parts
    python3 torch_kernel_sweep.py s6         # S6: Lc, the passes, both entries
    python3 torch_kernel_sweep.py cfar-route # F7: CA-CFAR's two window sums
    python3 torch_kernel_sweep.py k1-direct  # K1's direct route: R, warps
    python3 torch_kernel_sweep.py k1-route   # K1 as routed, both modes
    python3 torch_kernel_sweep.py fsm        # S1's FSM entry: chunk, block
    python3 torch_kernel_sweep.py s7 [SEQ]   # S7: passes, L, W, D, the step
    python3 torch_kernel_sweep.py ci16-lib   # K1/K2 int16: one library or own

* K6 (csrc/iir_bank.cu) at T = 2^14, C = 256, S = 2 (ChannelBank's block):
  the chunk length Lc in {16, 32, 64, 128}, each timed over a CUDA graph of
  20 calls, with the profiler's time of each of its three kernels and the
  largest error against the plain version (shared and narrow cascades).
* The DDC body (csrc/ddc_body.cu) at n = 64, M = 4, L = 2^24 (config 4),
  in both modes (x3 and the bf16 bank's "fast"): the frame width P in
  {8, 16} (32 and more do not fit one block's shared memory), two
  warpgroups of two stages, one of two, two of one, each timed over a
  CUDA graph of 20 launches, with its SNR against the plain version of
  its mode.
* K1, the fused DDC + FM kernel (csrc/ddc_fm.cu, tensor-core route) at
  n = 64, M = 4, L = 2^24: the frame width P in {8, 16, 32} (32 does not
  fit) and one or two warpgroups a block, the same way; then variants of
  its epilogue built from the source by text substitution and timed in
  turns: the kernel as it is, a polynomial atan2 (Cephes' atanf, one
  reciprocal) in place of atan2f, and two that give wrong audio to show
  what a part costs: the seams' dots left out, the discriminator left out.

* ``fir-route``: the sliding correlation of ``ops/fir.py`` by its two
  routes on the card, ``conv1d_mxu`` (cuDNN) and ``fir_toeplitz`` (the
  banded-Toeplitz matmul), each timed over a CUDA graph of 10 calls, at
  the shapes the port gives them: the unfused chain's decimating FIR
  (4 to 300 complex64 taps at strides 2, 4 and 8 over 2^24 samples),
  config 1's FIRFilter (64 taps, stride 1, blocks of 2^18 and 2^22),
  short filters at stride 1, a 384-tap filter at stride 1 and a
  3-branch polyphase bank.  Then config 1's block (``fir_apply``, 64
  complex64 taps, 2^18 samples, the tail carried) by "matmul" with the
  taps given as numpy (the classes' host copy) and as a card tensor
  (copied to the host for the Toeplitz banks each block), and by "fft",
  in turns of 20 blocks (numpy, tensor, fft, fft, tensor, numpy): ms a
  block by CUDA events and the host's enqueue time.

* ``s3``: S3, the IIR w-recurrence (csrc/iir_scan.cu, the chunk-and-join
  kernel), k = 2: the chunk length Lc in {16, 32, 64, 128, 256} and the
  join's threads a block in {64, 128, 256} (the join's form: how many
  runs of groups a lane is cut into), at one lane of 2^22 samples
  (complex64, float32, complex128) and 256 complex64 lanes of 2^16, each
  timed over a CUDA graph of 5 calls with its largest difference from the
  chunk length as built; then the profiler's time of each of its three
  kernels at the chunk as built (``linrec.S3_CHUNK``).

* ``latency``: the nonlinear scans' latency bounds.  One thread on the card
  runs a dependent chain of 512 of each operation their steps use (FFMA,
  FMUL, FADD, MUFU's EX2, LG2 and SIN, expf, logf, log10f, atan2f,
  sincosf, DFMA, a compare and select) between two clock64 reads; each scan's
  loop-carried chain (``LATENCY_CHAINS``, read from its step in
  csrc/seq_scan.cu) summed over those latencies is one floor, the
  instructions a step of its main loop in seq_scan.cu's SASS
  (``cuobjdump -sass``, one warp issuing one a cycle) the other; the
  larger over the SM clock is its bound, printed beside its time a sample
  at T = 2^16.  The SASS is kept beside the built libraries
  (``solid_dsp_tpu_torch/_build/seq_scan.sass``).  The same for S5
  (csrc/track_scan.cu, float32, one lane of 2^16) at orders 16 and 64
  (``track_scan.sass``); S4's three entries are chunk-and-join kernels
  (csrc/track_forward.cu, csrc/track_chunks.cu), timed by ``s4``, and S6
  (csrc/bcjr_scan.cu) is a chunk-and-join bound by its work, timed by
  ``s6``; S7 (csrc/viterbi_scan.cu, soft, K = 7: its
  single-warp form) at one row of 8166 steps, 1024 x 550 and 64 x 8166,
  its chain a step (the probe adds REDUX, and a shared-memory exchange
  across a two-warp barrier, the block form's) and its ACS loop's SASS
  (``viterbi_scan.sass``); S8's encoder (csrc/cvsd_scan.cu: its walking
  warp's full chunk in the SASS) at one lane and 1024 lanes of 2^16 (its
  decoder is time-parallel: ``s8``), and S9 (csrc/gardner_scan.cu) on 2^19
  symbols at sps 8 (the probe adds floor-to-integer and a dependent shared
  read), each its chain and its walk's SASS (``cvsd_scan.sass``,
  ``gardner_scan.sass``).  S1's FSM entry is
  time-parallel (the chunk-and-join kernel): its row prints its bytes
  bound (4 in and 4 out a step over 3.35 TB/s) beside its time instead.

* ``s8``: S8's decoder (csrc/cvsd_scan.cu, the chunk-and-join of clamped
  affine maps): its chunk length Lc as built (64) and, in side builds of
  the source (``S8_DECODE_SIDE``), 32 and 128, at one lane and 1024 lanes
  of 2^16 (chip_smoke.py phase 42's input), each timed
  over a CUDA graph of 5 calls beside its bytes bound (4 in and 4 out a
  sample over 3.35 TB/s) with its largest difference from the chunk as
  built; the profiler's time of each of its five kernels; then the
  encoder as built and with one part changed (``S8_VARIANTS``: the first
  design's one-chain step, the moving warp idle), built beside the kernels
  by text substitution and timed at the same shapes.

* ``s6``: S6, turbo decoding's max-log BCJR walk (csrc/bcjr_scan.cu, the
  chunk-and-join in the max-plus semiring): its chunk length as built (32)
  and, in side builds of the source (``S6_SIDE``), 16 and 64, each with
  its registers and spills, the walk entry at 128 rows and one row of 1027
  steps (chip_smoke.py phase 40's first walk) beside its bytes bound and
  the fused decode of 128 and one codeword of 1024 bits at six iterations,
  each timed over a CUDA graph with its largest difference from the build
  as built; then each pass's time (pass 1, the join, pass 3) from side
  builds that leave passes out, and pass 1's generic (shuffle) layout
  against the shift-register one it takes for these tables.

* ``s7 [SEQ]``: S7, the Viterbi walk (csrc/viterbi_scan.cu, the chunked
  walk; soft, rate 1/2) at ``S7_SHAPES``: chip_smoke.py phase 41's shapes
  (K = 7: 1024 x 550 at Eb/N0 = 4 dB, 64 x 8166 at 2.8 dB, one row of
  550), the block form (K = 9) at 1024 x 550 and the CCSDS rows at 1 dB.
  Each as built (chunk_plan) with its re-walked chunks and re-traced
  pieces, bit-equal to viterbi_plain on ``S7_PLAIN_ROWS`` rows, and each
  of its three passes alone (side builds that leave the others out, on
  the scratch of a whole call); where SEQ is given (an earlier
  viterbi_scan.cu with the sequential kernel's C entry, as ``git show
  <commit>:solid_dsp_tpu_torch/csrc/viterbi_scan.cu`` writes it), that
  kernel on the same rows in the same run, checked bit-equal.  Then, at
  phase 41's shapes, pass 3 at the trace's lookaheads ``S7_D`` and the
  chunk length L and the warm-up W swept (``S7_L``, ``S7_W``), each with
  its counts and checked bit-equal to the call as built; then side
  builds of the source (``S7_VARIANTS``: a part of the ACS step taken
  away, timed with pass 1 alone since their wrong metrics would re-walk
  every chunk; pass 3's words loaded 8 or 32 steps ahead; 1, 2 or 8
  chunks a block), at the plans as built.  Every time is over a CUDA
  graph of 20 calls.  Keeps the SASS in _build/viterbi_scan.sass.

* ``cfar-route``: ``models/radar.py::cfar_ca``'s window sums at the
  sweep's 2^22 cells (F7): the box sum by conv1d (as built) against a
  float64 running sum cast back, timed in turns, each with its
  thresholds' error relative to float64.

* ``s4``: S4's chunk-and-join entries (csrc/track_forward.cu,
  csrc/track_chunks.cu), float32, n = 2 (the trackers' and the smoother's
  size): the forward entry's chunk length Lc in {16, 32, 64, 128} at one
  lane of 2^20 (kalman_apply's and rts_smooth's block) and at 16 lanes of
  2^16, with and without the covariances kept; the LTI entry's chunk
  length Lc in {16, 32, 64, 128, 256} at one lane of 2^22 (the
  AlphaBetaTracker's block) and at 64 lanes of 2^16, and the backward
  entry's in {8, 16, 32, 64, 128} at one lane of 2^20 (rts_smooth's
  block) and 16 lanes of 2^16, each timed over a CUDA graph of 5 calls
  with its largest difference from the chunk as built and its share of
  its bytes bound (each input read once, each output written once, over
  3.35 TB/s); then the profiler's time of each entry's three kernels at
  the main-path sizes as built.

* ``k1-direct``: K1's direct route (csrc/ddc_fm.cu, a warp a run of R
  outputs) at 256 taps and M = 128, 200, 240 and 512 taps, M = 256, ~2^24
  samples, x3 and fast: R in {4, 8, 16, 32} and warps a block in {4, 8,
  16}, each timed over a CUDA graph of 20 launches, its audio checked
  bit-equal to the geometry as built (``cuda_ddc.FM_DIRECT_RUN``,
  ``FM_DIRECT_WARPS``) and its SNR against the plain version.

* ``k1-route``: K1 as ``ddc_fm_cuda`` routes it (``fm_geometry``) at
  the same points and sizes, both modes, over a CUDA graph of 20 launches,
  or "raises" where the route refuses the geometry.  It calls only what
  every version of the port has, so a copy of this script and of
  chip_smoke.py beside an older checkout (run from there) times that
  checkout's K1 the same way.

* ``fsm``: S1's FSM entry (csrc/seq_scan.cu, the chunk-and-join kernel):
  the chunk length C in {32, 64, 128, 256} and chunks a block in {32, 64,
  128, 256, 512}, at one lane of 2^16 and of 2^22 float32 and 64 lanes of
  2^16, each timed over a CUDA graph of 5 calls and checked bit-equal to
  the geometry as built (``cuda_scan.fsm_geometry``: ``FSM_CHUNK`` and
  ``FSM_THREADS``, or ``FSM_SMALL`` for short tracks); then the profiler's
  time of each of its three kernels as built.

Prints one line a case with the card's name and power limit.  Needs one
CUDA GPU; imports neither jax nor solid_dsp_tpu.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

from chip_smoke import graph_ms, profiled_rows, sco_lanes, snr_db, timed


FIR_ROUTE_SHAPES = (          # (taps, stride, outputs a sample, samples)
    (64, 4, 1, 1 << 24), (4, 4, 1, 1 << 24), (300, 4, 1, 1 << 24),
    (64, 2, 1, 1 << 24), (64, 8, 1, 1 << 24), (64, 1, 1, 1 << 18),
    (64, 1, 1, 1 << 22), (384, 1, 1, 1 << 22), (48, 1, 3, 1 << 22),
    (8, 4, 1, 1 << 24), (12, 4, 1, 1 << 24), (16, 4, 1, 1 << 24),
    (24, 4, 1, 1 << 24), (32, 4, 1, 1 << 24), (4, 1, 1, 1 << 22),
    (8, 1, 1, 1 << 22), (16, 1, 1, 1 << 22), (8, 8, 1, 1 << 24),
    (16, 8, 1, 1 << 24), (32, 8, 1, 1 << 24), (16, 2, 1, 1 << 24))


def fir_route_sweep(dev, smi) -> None:
    """conv1d_mxu against fir_toeplitz at FIR_ROUTE_SHAPES, complex64 data
    and taps (the chains' and the classes' types)."""
    from solid_dsp_tpu_torch.ops import fir as fir_ops

    rng = np.random.default_rng(27)
    for n, stride, O, L in FIR_ROUTE_SHAPES:
        tn = (rng.standard_normal((n, O)) / n).astype(np.complex64)
        tn = tn[:, 0] if O == 1 else tn
        tt = torch.from_numpy(tn).to(dev)
        x = torch.from_numpy((rng.standard_normal(L + n - 1) + 1j
                              * rng.standard_normal(L + n - 1)
                              ).astype(np.complex64)).to(dev)
        a = fir_ops.conv1d_mxu(x, tt, stride=stride)
        b = fir_ops.fir_toeplitz(x, tn, stride=stride)
        conv = graph_ms(lambda: fir_ops.conv1d_mxu(x, tt, stride=stride), 10)
        toep = graph_ms(lambda: fir_ops.fir_toeplitz(x, tn, stride=stride),
                        10)
        print(f"[fir route n={n} stride={stride} O={O} L=2^"
              f"{L.bit_length() - 1}] conv1d {conv:.4f} ms, toeplitz "
              f"{toep:.4f} ms (CUDA graph of 10 calls), toeplitz/conv1d "
              f"{toep / conv:.3f}, {snr_db(b.cpu().numpy(), a.cpu().numpy()):.1f}"
              f" dB apart | {smi}", flush=True)
        del x, a, b

    taps = torch.from_numpy(rng.standard_normal(64).astype(np.complex64)
                            / 8).to(dev)
    host = taps.cpu().numpy()
    x = torch.from_numpy((rng.standard_normal(1 << 18) + 1j
                          * rng.standard_normal(1 << 18)
                          ).astype(np.complex64)).to(dev)
    cases = {"matmul, numpy taps": (host, "matmul"),
             "matmul, tensor taps": (taps, "matmul"),
             "fft": (taps, "fft")}
    got = {k: [] for k in cases}
    for label in (*cases, *reversed(cases)):
        t, method = cases[label]
        box = {"tail": torch.zeros(63, dtype=torch.complex64, device=dev)}

        def step():
            _, box["tail"] = fir_ops.fir_apply(t, box["tail"], x, 1.0,
                                               method)
        got[label].append(timed(step, 20))
    for label, runs in got.items():
        print(f"[config 1 block, 64 taps, 2^18, {label}] "
              + ", ".join(f"{w:.4f} ms a block (host {h:.4f})"
                          for w, h in runs)
              + f"; {(1 << 18) / (min(w for w, _ in runs) * 1e3):.1f} "
              f"Msamples/s at best | {smi}", flush=True)


S3_CHUNKS = (16, 32, 64, 128, 256)
S3_JOIN_THREADS = (64, 128, 256)


def s3_sweep(dev, smi) -> None:
    """S3's chunk length and the join's threads a block, at its two shapes,
    then the time of each of its three kernels at the chunk as built."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from solid_dsp_tpu_torch.ops import cuda_scan, linrec

    rng = np.random.default_rng(3)
    built = linrec.S3_CHUNK
    for dt, name in ((torch.complex64, "c64"), (torch.float32, "f32"),
                     (torch.complex128, "c128")):
        a = torch.tensor([-1.9 * np.cos(0.3), 0.9025], dtype=dt, device=dev)
        for T, B in ((1 << 22, 1), (1 << 16, 256)):
            if name != "c64" and B > 1:
                continue
            x = torch.from_numpy(rng.standard_normal((T, B))).to(dev, dt)
            h = torch.zeros((B, 2), dtype=dt, device=dev)
            want, _ = cuda_scan.iir_scan_cuda(a, h, x)
            for chunk in S3_CHUNKS:
                for jt in S3_JOIN_THREADS:
                    def run():
                        return cuda_scan.iir_scan_cuda(a, h, x, chunk=chunk,
                                                       join_threads=jt)
                    w, _ = run()
                    err = float((w - want).abs().max() / want.abs().max())
                    ms = graph_ms(run, 5)
                    print(f"[S3 {name} k=2, T=2^{T.bit_length() - 1}, {B} "
                          f"lane(s), Lc {chunk}, join threads {jt}] "
                          f"{ms:.4f} ms, {ms * 1e6 / (T * B):.4f} ns a "
                          f"sample, max|dw| {err:.3g} x max|w| against Lc "
                          f"{built} | {smi}", flush=True)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    cuda_scan.iir_scan_cuda(a, h, x)
                torch.cuda.synchronize()
            rows = [(e.self_device_time_total / 1e3 / e.count, e.key[:60])
                    for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and e.count]
            print(f"[S3 {name} k=2, T=2^{T.bit_length() - 1}, {B} lane(s), "
                  f"Lc {built}, kernels (profiler, ms a call)] "
                  + ", ".join(f"{k} {t:.4f}" for t, k in sorted(rows,
                                                              reverse=True))
                  + f" | {smi}", flush=True)


S4_LTI_CHUNKS = (16, 32, 64, 128, 256)
S4_RTS_CHUNKS = (8, 16, 32, 64, 128)
S4_FWD_CHUNKS = (16, 32, 64, 128)


def _profiled_kernels(fn, n: int = 5) -> str:
    """The profiler's ms a call of each kernel fn launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total / 1e3 / e.count, e.key[:50])
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.count]
    return ", ".join(f"{k} {t:.4f}" for t, k in sorted(rows, reverse=True))


def s4_sweep(dev, smi) -> None:
    """S4's chunk-and-join entries: the chunk length at the main-path sizes
    and at many lanes, then each entry's three kernels as built."""
    from solid_dsp_tpu_torch.ops import cuda_track, kalman

    rng = np.random.default_rng(4)
    model = kalman.cv_model(1.0, 0.05, 1.0)
    ops = [torch.from_numpy(a).to(dev, torch.float32) for a in model]
    for L, T in ((1, 1 << 20), (16, 1 << 16)):
        z = torch.from_numpy(rng.standard_normal((L, T, 1))).to(
            dev, torch.float32)
        x0 = torch.zeros((L, 2), device=dev)
        P0 = 10 * torch.eye(2, device=dev).expand(L, 2, 2).contiguous()
        for keep in (False, True):
            want = cuda_track.kalman_filter_cuda(x0, P0, z, *ops, keep=keep)
            # Z read; X (and Pf, Xp, Pp) written
            bound = 4 * L * T * (1 + (2 + 8 + 2 + 4 if keep else 2)) \
                / 3.35e12 * 1e3
            for chunk in S4_FWD_CHUNKS:
                def run():
                    return cuda_track.kalman_filter_cuda(x0, P0, z, *ops,
                                                         keep=keep,
                                                         chunk=chunk)
                err = max(float((g - w).abs().max() / w.abs().max())
                          for g, w in zip(run(), want))
                ms = graph_ms(run, 5)
                print(f"[S4 forward n=2 m=1, {L} lane(s) of "
                      f"2^{T.bit_length() - 1}, keep={keep}, Lc {chunk}] "
                      f"{ms:.4f} ms, {ms * 1e6 / (L * T):.4f} ns a step, bytes "
                      f"bound {bound:.5f} ms ({bound / ms:.1%}), max|d| "
                      f"{err:.3g} x max against Lc as built | {smi}",
                      flush=True)
            if L == 1:
                print(f"[S4 forward n=2, 2^20, keep={keep}, Lc "
                      f"{cuda_track.FWD_CHUNK}, kernels (profiler, ms a "
                      f"call)] " + _profiled_kernels(
                          lambda: cuda_track.kalman_filter_cuda(
                              x0, P0, z, *ops, keep=keep)) + f" | {smi}",
                      flush=True)
    K, F = kalman.steady_state_gain(*model)
    Ft = torch.from_numpy(F).to(dev, torch.float32)
    for L, T in ((1, 1 << 22), (64, 1 << 16)):
        B = torch.from_numpy(rng.standard_normal((L, T, 2))).to(
            dev, torch.float32)
        x0 = torch.zeros((L, 2), device=dev)
        want, _ = cuda_track.kalman_lti_cuda(x0, B, Ft)
        bound = 4 * L * T * 2 * 2 / 3.35e12 * 1e3
        for chunk in S4_LTI_CHUNKS:
            def run():
                return cuda_track.kalman_lti_cuda(x0, B, Ft, chunk=chunk)
            err = float((run()[0] - want).abs().max() / want.abs().max())
            ms = graph_ms(run, 5)
            print(f"[S4 LTI n=2, {L} lane(s) of 2^{T.bit_length() - 1}, Lc "
                  f"{chunk}] {ms:.4f} ms, {ms * 1e6 / (L * T):.4f} ns a step, "
                  f"bytes bound {bound:.5f} ms ({bound / ms:.1%}), max|dX| "
                  f"{err:.3g} x max against Lc as built | {smi}", flush=True)
    A = ops[0]
    for L, T in ((1, 1 << 20), (16, 1 << 16)):
        z = torch.from_numpy(rng.standard_normal((L, T, 1))).to(
            dev, torch.float32)
        out = cuda_track.kalman_filter_cuda(
            torch.zeros((L, 2), device=dev),
            10 * torch.eye(2, device=dev).expand(L, 2, 2).contiguous(), z,
            *ops, keep=True)
        kept = (out[0], *out[3:])
        want, _ = cuda_track.rts_backward_cuda(*kept, A)
        # Xf, Pf, Xp, Pp read (2n + 2n^2 a step), Xs, Ps written (n + n^2)
        bound = 4 * L * T * 18 / 3.35e12 * 1e3
        for chunk in S4_RTS_CHUNKS:
            def run():
                return cuda_track.rts_backward_cuda(*kept, A, chunk=chunk)
            err = float((run()[0] - want).abs().max() / want.abs().max())
            ms = graph_ms(run, 5)
            print(f"[S4 backward n=2, {L} lane(s) of 2^{T.bit_length() - 1}, "
                  f"Lc {chunk}] {ms:.4f} ms, {ms * 1e6 / (L * T):.4f} ns a "
                  f"step, bytes bound {bound:.5f} ms ({bound / ms:.1%}), "
                  f"max|dXs| {err:.3g} x max against Lc as built | {smi}",
                  flush=True)
        if L == 1:
            print(f"[S4 backward n=2, 2^20, Lc {cuda_track.RTS_CHUNK}, kernels "
                  f"(profiler, ms a call)] "
                  + _profiled_kernels(lambda: cuda_track.rts_backward_cuda(
                      *kept, A)) + f" | {smi}", flush=True)
    B = torch.from_numpy(rng.standard_normal((1 << 22, 2))).to(
        dev, torch.float32)
    x0 = torch.zeros(2, device=dev)
    print(f"[S4 LTI n=2, 2^22, Lc as built, kernels (profiler, ms a call)] "
          + _profiled_kernels(lambda: cuda_track.kalman_lti_cuda(x0, B, Ft))
          + f" | {smi}", flush=True)


K1_DIRECT_POINTS = ((256, 128), (256, 200), (256, 240), (512, 256))


def k1_direct_sweep(dev, smi) -> None:
    """K1's direct route: outputs a warp's run and warps a block at
    K1_DIRECT_POINTS, ~2^24 samples, x3 and fast."""
    from solid_dsp_tpu_torch.models.rx_chain import RxChainConfig
    from solid_dsp_tpu_torch.ops import cuda_ddc
    from solid_dsp_tpu_torch.ops.nco import constrain

    rng = np.random.default_rng(37)
    built = (cuda_ddc.FM_DIRECT_RUN, cuda_ddc.FM_DIRECT_WARPS)
    for n, M in K1_DIRECT_POINTS:
        L = ((1 << 24) // (64 * M)) * 64 * M
        xs = 0.5 * np.exp(1j * 0.21 * np.arange(L)) + 0.1 * (
            rng.standard_normal(L) + 1j * rng.standard_normal(L))
        x2 = torch.from_numpy(np.stack([xs.real, xs.imag]).astype(
            np.float32)).to(dev)
        tail = torch.from_numpy((0.3 * rng.standard_normal((2, n - M))).astype(
            np.float32)).to(dev)
        taps = RxChainConfig(fir_taps=n, decimation=M).design_taps()
        for mode in cuda_ddc.MODES:
            body = cuda_ddc.make_ddc_fm(taps, constrain(0.2), M, 0.1, dev,
                                        mode=mode)
            ap = cuda_ddc.ddc_fm_torch(body, x2, tail)[0].cpu().numpy()
            ref = cuda_ddc._launch_fm(body, x2, tail, "direct", built)[0]
            for R in (4, 8, 16, 32):
                for warps in (4, 8, 16):
                    geo = (R, warps)
                    audio = cuda_ddc._launch_fm(body, x2, tail, "direct",
                                                geo)[0]
                    ms = graph_ms(lambda: cuda_ddc._launch_fm(
                        body, x2, tail, "direct", geo), 20)
                    print(f"[K1 direct {mode}, n={n} M={M} L={L}, R={R}, "
                          f"{warps} warps a block] {ms:.4f} ms (CUDA graph "
                          f"of 20 launches), audio bit-equal to R, warps = "
                          f"{built}: {torch.equal(audio, ref)}, "
                          f"{snr_db(audio.cpu().numpy(), ap):.1f} dB vs "
                          f"plain | {smi}", flush=True)


def k1_route_times(dev, smi) -> None:
    """K1 as routed at K1_DIRECT_POINTS, ~2^24 samples, x3 and fast: ms
    over a CUDA graph of 20 launches and the SNR against the plain
    version, or "raises"."""
    from solid_dsp_tpu_torch.models.rx_chain import RxChainConfig
    from solid_dsp_tpu_torch.ops import cuda_ddc
    from solid_dsp_tpu_torch.ops.nco import constrain

    rng = np.random.default_rng(37)
    for n, M in K1_DIRECT_POINTS:
        L = ((1 << 24) // (64 * M)) * 64 * M
        xs = 0.5 * np.exp(1j * 0.21 * np.arange(L)) + 0.1 * (
            rng.standard_normal(L) + 1j * rng.standard_normal(L))
        x2 = torch.from_numpy(np.stack([xs.real, xs.imag]).astype(
            np.float32)).to(dev)
        tail = torch.from_numpy((0.3 * rng.standard_normal((2, n - M))).astype(
            np.float32)).to(dev)
        taps = RxChainConfig(fir_taps=n, decimation=M).design_taps()
        for mode in cuda_ddc.MODES:
            body = cuda_ddc.make_ddc_fm(taps, constrain(0.2), M, 0.1, dev,
                                        mode=mode)
            try:
                route = cuda_ddc.fm_geometry(n, M, mode == "fast")
                audio = cuda_ddc.ddc_fm_cuda(body, x2, tail)[0]
            except ValueError as exc:
                print(f"[K1 as routed, {mode}, n={n} M={M} L={L}] raises: "
                      f"{exc} | {smi}", flush=True)
                continue
            ap = cuda_ddc.ddc_fm_torch(body, x2, tail)[0].cpu().numpy()
            ms = graph_ms(lambda: cuda_ddc.ddc_fm_cuda(body, x2, tail), 20)
            print(f"[K1 as routed, {mode}, n={n} M={M} L={L}] route {route}: "
                  f"{ms:.4f} ms (CUDA graph of 20 launches), "
                  f"{snr_db(audio.cpu().numpy(), ap):.1f} dB vs plain | "
                  f"{smi}", flush=True)


def fsm_sweep(dev, smi) -> None:
    """S1's FSM entry: chunk length and chunks a block at one lane of 2^16
    and 2^22 and 64 lanes of 2^16, then its three kernels' times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import rssi_walk
    from solid_dsp_tpu_torch.ops import cuda_scan

    rng = np.random.default_rng(29)
    for B, T in ((1, 1 << 16), (1, 1 << 22), (64, 1 << 16)):
        built = cuda_scan.fsm_geometry(B, T)
        r = torch.from_numpy(np.stack([rssi_walk(rng, T) for _ in range(B)])
                             ).to(dev, torch.float32)
        m0 = torch.full((B,), 1, dtype=torch.int32, device=dev)   # ENABLED
        t0 = torch.zeros((B,), dtype=torch.int32, device=dev)
        want = cuda_scan.squelch_fsm_cuda(r, m0, t0, -30.0, 20)
        for chunk in (32, 64, 128, 256):
            for threads in (32, 64, 128, 256, 512):
                def run():
                    return cuda_scan.squelch_fsm_cuda(r, m0, t0, -30.0, 20,
                                                      chunk, threads)
                try:
                    got = run()
                except ValueError as exc:
                    print(f"[S1's FSM, C={chunk}, {threads} chunks a block] "
                          f"{exc}", flush=True)
                    continue
                same = all(torch.equal(a, b) for a, b in zip(got, want))
                ms = graph_ms(run, 5)
                print(f"[S1's FSM, {B} lane(s) of 2^{T.bit_length() - 1}, "
                      f"C={chunk}, {threads} chunks a block] {ms:.4f} ms "
                      f"(CUDA graph of 5 calls), {ms * 1e6 / (B * T):.4f} ns "
                      f"a step, bit-equal to C, chunks = {built}: {same} | "
                      f"{smi}", flush=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                cuda_scan.squelch_fsm_cuda(r, m0, t0, -30.0, 20)
            torch.cuda.synchronize()
        rows = [(e.self_device_time_total / 1e3 / e.count, e.key[:60])
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.count]
        print(f"[S1's FSM, {B} lane(s) of 2^{T.bit_length() - 1}, C, chunks "
              f"= {built} (as built), kernels (profiler, ms a call)] "
              + ", ".join(f"{k} {t:.4f}" for t, k in sorted(rows,
                                                          reverse=True))
              + f" | {smi}", flush=True)


# One thread runs a chain of 512 dependent operations of one kind between
# two clock64 reads: cycles an operation (the loop's own counter and branch,
# one every 16 operations, run beside the chain).  SHFL runs in a kernel of
# its own on one warp, every lane on its own value: each lane takes its
# neighbour's value and adds to it, the add taken off after.
LATENCY_PROBE = r"""
#include <cuda_runtime.h>
#define CHAIN(BODY)                                         \
  _Pragma("unroll 1") for (int i = 0; i < 32; ++i) {        \
    _Pragma("unroll") for (int j = 0; j < 16; ++j) { BODY } \
  }
__global__ void probe(int op, float a, double da, float* out, double* dout,
                      long long* cyc) {
  __shared__ int si[64];
  float v = a, s = 0.f, c = 0.f;
  double d = da;
  for (int i = 0; i < 64; ++i) si[i] = (i * 5 + op) & 63;
  __syncthreads();
  int k = op & 63;
  const long long t0 = clock64();
  switch (op) {
    case 0: CHAIN(v = __fmaf_rn(v, 0.999f, 1e-3f);) break;
    case 1: CHAIN(v = __fmul_rn(v, 1.0001f);) break;
    case 2: CHAIN(v = __fadd_rn(v, 1e-3f);) break;
    case 3: CHAIN(asm volatile("ex2.approx.ftz.f32 %0, %0;" : "+f"(v));) break;
    case 4: CHAIN(asm volatile("lg2.approx.ftz.f32 %0, %0;" : "+f"(v));) break;
    case 5: CHAIN(asm volatile("sin.approx.ftz.f32 %0, %0;" : "+f"(v));) break;
    case 6: CHAIN(v = expf(v) * 0.5f;) break;
    case 7: CHAIN(v = logf(v) + 2.f;) break;
    case 8: CHAIN(v = log10f(v) + 2.f;) break;
    case 9: CHAIN(v = atan2f(v, 1.3f) + 0.5f;) break;
    case 10: CHAIN(sincosf(v, &s, &c); v = s + c;) break;
    case 11: CHAIN(d = __fma_rn(d, 0.999, 1e-3);) break;
    case 12: CHAIN(v = v > 0.5f ? v * 0.75f : v + 0.1f;) break;
    case 13: CHAIN(v = __fdiv_rn(1.3f, v);) break;
    case 14: CHAIN(asm volatile("max.f32 %0, %0, %1;" : "+f"(v) : "f"(s));)
      break;
    // S9's sample index from mu: floor, to an integer, back (the FADD of
    // the float's return taken off as carried)
    case 18: CHAIN(v = (float)(int)floorf(v) + 0.5f;) break;
    // a shared-memory read whose address the previous read gave
    case 19: CHAIN(k = si[k];) break;
  }
  const long long t1 = clock64();
  out[0] = v + (float)k;
  dout[0] = d;
  cyc[0] = t1 - t0;
}
// A kernel of its own: a shuffle in probe's switch made the compiler fence
// the branched chains (FDIV, atan2f, sincosf) for reconvergence.  The
// values are lane-dependent, since a shuffle of a warp-uniform value folds.
__global__ void probe_shfl(float a, float* out, long long* cyc) {
  float v = a + 1e-3f * threadIdx.x;
  const long long t0 = clock64();
  CHAIN(v = __shfl_xor_sync(0xffffffffu, v, 1) + 1e-3f;)
  const long long t1 = clock64();
  if (threadIdx.x == 0) {
    out[0] = v;
    cyc[0] = t1 - t0;
  }
}
// Two warps, as S7's block at 64 states: a warp's integer minimum by
// REDUX, and the exchange of a value through a double-buffered shared array
// across a block barrier (store, bar.sync, load of the other warp's slot).
__global__ void probe_block(int op, float a, float* out, long long* cyc) {
  __shared__ float sm[2][64];
  const int tid = threadIdx.x;
  float v = a + 1e-3f * tid;
  int k = tid;
  int buf = 0;
  const long long t0 = clock64();
  if (op == 16) {
    CHAIN(k = __reduce_min_sync(0xffffffffu, k + (tid & 1));)
  } else {
    CHAIN(sm[buf][tid] = v; __syncthreads(); v = sm[buf][tid ^ 32] + 1e-3f;
          buf ^= 1;)
  }
  const long long t1 = clock64();
  if (tid == 0) {
    out[0] = v + k;
    cyc[0] = t1 - t0;
  }
}
extern "C" int probe_launch(int op, float a, double da, float* out,
                            double* dout, long long* cyc) {
  if (op == 15)
    probe_shfl<<<1, 32>>>(a, out, cyc);
  else if (op == 16 || op == 17)
    probe_block<<<1, 64>>>(op, a, out, cyc);
  else
    probe<<<1, 1>>>(op, a, da, out, dout, cyc);
  return (int)cudaGetLastError();
}
"""
LATENCY_OPS = ("FFMA", "FMUL", "FADD", "MUFU.EX2", "MUFU.LG2", "MUFU.SIN",
               "expf", "logf", "log10f", "atan2f", "sincosf", "DFMA",
               "compare+select", "FDIV", "FMNMX", "SHFL", "REDUX",
               "STS+BAR+LDS", "floor+F2I+I2F", "LDS")


def latency_probe(dev) -> dict:
    """{operation: cycles an operation}, one thread on the card."""
    from solid_dsp_tpu_torch.ops import cuda_build

    d = cuda_build.BUILD_DIR / "latency_probe"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    (d / "probe.cu").write_text(LATENCY_PROBE)
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                    str(d / "libprobe.so"), str(d / "probe.cu")], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(str(d / "libprobe.so")).probe_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_float, ctypes.c_double,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(1, device=dev)
    dout = torch.empty(1, dtype=torch.float64, device=dev)
    cyc = torch.empty(1, dtype=torch.int64, device=dev)
    res = {}
    for op, name in enumerate(LATENCY_OPS):
        best = None
        for _ in range(3):
            cuda_build.check_launch(fn(op, 0.7, 0.7, out.data_ptr(),
                                       dout.data_ptr(), cyc.data_ptr()),
                                    "latency probe")
            torch.cuda.synchronize()
            c = int(cyc.item()) / 512.0
            best = c if best is None else min(best, c)
        res[name] = best
    return res


def sass_dump(source: str) -> str:
    """cuobjdump -sass of a built library of ops/cuda_build.py."""
    from solid_dsp_tpu_torch.ops import cuda_build

    tool = shutil.which("cuobjdump") or str(
        cuda_build.Path(cuda_build._nvcc()).parent / "cuobjdump")
    return subprocess.run([tool, "-sass", str(cuda_build._target(source))],
                          check=True, capture_output=True, text=True).stdout


# The loop-carried chain of one step of each nonlinear scan (float32), read
# from its step in csrc/seq_scan.cu: {operation of LATENCY_OPS: count}.  A
# library function's probe chain carries one more FADD or FMUL (its
# "+ 2.f", "* 0.5f", "s + c"), taken off; a select whose condition is
# computed off the chain costs its FSEL, an FMUL's latency.
#   S1 (agc_walk, unlocked, squelch disabled): ore = x g, ee = fma(ore, ore,
#     oim^2), E = c1 E + ee c2, g = E > 1e-6 ? g exp(c3 ln E) : g, then
#     the clamp: FMUL, FFMA, FMUL + FADD, logf, FMUL, expf, FMUL, 2 FSEL;
#   S2 (costas_pll_kernel): sincos(theta), y = x conj(e^{j theta}) (FMUL +
#     FADD), the decision (compare and select on y), y conj(d) (FMUL +
#     FADD), atan2, dtheta += alpha e (FMUL + FADD), theta = (theta +
#     dtheta) + beta e (two FADDs, beta e off the chain).
#   S7 (viterbi_scan.cu's single-warp form, 64 states): the new metrics'
#     minimum (FMNMX of a lane's two), its key (compare and select), the
#     warp's minimum (REDUX), the key back to a float (compare and
#     select), pmn - min and + bm (two FADDs), the choice (compare and
#     select); the four shuffles that put the metrics back in place run
#     beside the key and REDUX, a shorter path;
#   S8's encoder (csrc/cvsd_scan.cu::enc_step, its SASS): both outcomes of
#     the bit come from the old state and the compare only selects, so the
#     longest loop-carried cycle spans two steps: ref -> FSETP (the bit) ->
#     FSEL (the step) (compare and select) -> FMUL (beta step) -> FADD (+
#     gamma) -> two FMNMX (the boosted step) -> FSEL (bit 1's candidate, by
#     its agreement) -> FADD (leak ref + it) -> FMNMX -> the ref's select by
#     the next bit: per step half a compare and select, 1.5 FMUL (one FMUL,
#     two selects at FMUL's latency), one FADD, 1.5 FMNMX; the step's own
#     cycle, the history's and ref's (FSETP, select) are shorter;
#   S9 (csrc/gardner_scan.cu, its SASS): mu -> F2I.FLOOR (floor+F2I+I2F)
#     -> IMAD, two VIMNMX, IADD3, ISETP (the index, its clip, the window
#     test: 5 integer ops at FADD's latency) -> LDS -> the Farrow
#     coefficient c2 (FMUL, three FADD) -> Horner (three FMUL and FADD) ->
#     d = prev - sym and mid.re d.re + mid.im d.im (FADD, FMUL, FADD) ->
#     alpha e, mu + (..), + rate (FMUL, two FADD);
#   S5 (lattice_iir_kernel, real): stage m of sample t + 1 needs b_m, which
#     stage m - 1 of sample t wrote, so the samples overlap as a wavefront:
#     b_m's update (FFMA), then stage m's g <- g - k_m b_m and stage m - 1's
#     (FFMA each) a sample, whatever p; its 2p FFMAs a sample are the SASS
#     floor.
LATENCY_CHAINS = {
    "S1": {"FMUL": 4 + 2, "FFMA": 1, "FADD": 1, "logf": 1, "expf": 1},
    "S2": {"sincosf": 1, "FMUL": 3, "FADD": 5, "compare+select": 1,
           "atan2f": 1},
    "S5 p=16": {"FFMA": 3},
    "S5 p=64": {"FFMA": 3},
    "S7": {"FMNMX": 1, "compare+select": 3, "REDUX": 1, "FADD": 2},
    "S8 encode": {"FMUL": 1.5, "FADD": 1, "FMNMX": 1.5,
                  "compare+select": 0.5},
    "S9": {"floor+F2I+I2F": 1, "LDS": 1, "FMUL": 6, "FADD": 15},
}
_CARRIED = {"logf": "FADD", "log10f": "FADD", "atan2f": "FADD",
            "sincosf": "FADD", "expf": "FMUL", "SHFL": "FADD",
            "STS+BAR+LDS": "FADD", "floor+F2I+I2F": "FADD"}


_SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                        r"([A-Z][A-Z0-9_.]*)\s*(.*?);")


def sass_step_instructions(sass: str, kernel: str, loads: int | None,
                           mufu: int | None = None, steps: int = 8) -> float:
    """Instructions a step of ``kernel``'s main loop in a cuobjdump -sass
    listing: among the loops (a backward branch's range) of the function
    whose name holds ``kernel`` that issue ``loads`` global loads (any
    number where ``loads`` is None; and,
    given ``mufu``, that many MUFU operations), the largest, or with
    ``mufu`` the one with the fewest branches; over the ``steps`` steps a
    loop holds (seq_scan.cu's walk: 8, CHUNK unrolled; track_scan.cu's: its
    chunk).  One warp issues at most one instruction a cycle,
    so this is a second floor beside the chain's."""
    loops = []
    for part in sass.split("Function : ")[1:]:
        if kernel not in part.splitlines()[0]:
            continue
        ins = [(int(a, 16), op, args)
               for a, op, args in _SASS_INSN.findall(part)]
        for addr, op, args in ins:
            target = re.search(r"0x([0-9a-f]+)", args) if op == "BRA" else None
            if target and int(target.group(1), 16) < addr:
                body = [i[1] for i in ins
                        if int(target.group(1), 16) <= i[0] <= addr]
                if ((loads is None
                     or sum(o.startswith("LDG") for o in body) == loads) and (
                        mufu is None
                        or sum(o.startswith("MUFU") for o in body) == mufu)):
                    loops.append((body.count("BRA"), len(body)))
    if not loops:
        raise ValueError(f"no main loop of {kernel} in the SASS")
    n = (min(loops)[1] if mufu is not None else max(b for _, b in loops))
    return n / float(steps)


def latency_sweep(dev, smi) -> None:
    """The nonlinear scans' latency bounds: the operations' latencies on
    this card (latency_probe), summed over each scan's loop-carried chain
    (LATENCY_CHAINS) and divided by the SM clock, beside each scan's time a
    sample at T = 2^16 (CUDA graph of 5 launches, as chip_smoke.py phase 29
    times them); seq_scan.cu's SASS is kept beside the built libraries."""
    from solid_dsp_tpu_torch.models import qpsk as qpsk_ops
    from solid_dsp_tpu_torch.ops import cuda_build
    from solid_dsp_tpu_torch.ops import agc as agc_ops
    from solid_dsp_tpu_torch.ops import cuda_scan

    lat = latency_probe(dev)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"[latency, cycles an operation, one thread (SHFL: a warp)] "
          + ", ".join(f"{k} {v:.1f}" for k, v in lat.items())
          + f" | SM clock now, max: {clocks} | {smi}", flush=True)
    sass = sass_dump("seq_scan.cu")
    out = cuda_build.BUILD_DIR / "seq_scan.sass"
    out.write_text(sass)
    print(f"[latency] seq_scan.cu SASS: {len(sass.splitlines())} lines, "
          f"kept in {out}", flush=True)
    mhz = float(clocks.split(",")[-1].split()[0])
    T = 1 << 16
    rng = np.random.default_rng(29)
    x = torch.from_numpy(0.1 * (rng.standard_normal(T) + 1j
                                * rng.standard_normal(T))).to(dev,
                                                              torch.complex64)
    st = agc_ops.agc_init(device=dev)
    r = torch.from_numpy(-30.0 + 10 * rng.standard_normal(T)).to(dev,
                                                                 torch.float32)
    m0 = torch.tensor(1, dtype=torch.int32, device=dev)      # ENABLED
    t0 = torch.zeros((), dtype=torch.int32, device=dev)
    runs = {"S1": lambda: agc_ops.agc_apply(st, x, 0.01, 1.0, -1e30, 100),
            "S2": lambda: qpsk_ops.qpsk_carrier_pll(x, 0.02)}
    # the float32 kernels' main loops: S1's unlocked walk without the FSM
    # (8 loads, 8 MUFU.EX2; the least branchy of its 8-load loops), S2's
    # walk (a float2 sample is two loads)
    issue = {"S1": sass_step_instructions(sass, "agc_scan_kernelIf", 8, 8),
             "S2": sass_step_instructions(sass, "costas_pll_kernelIf", 16)}
    for name in ("S1", "S2"):
        chain = LATENCY_CHAINS[name]
        cycles = sum(n * (lat[op] - (lat[_CARRIED[op]]
                                     if op in _CARRIED else 0.0))
                     for op, n in chain.items())
        bound_ns = max(cycles, issue[name]) / mhz * 1e3
        ns = graph_ms(runs[name], 5) * 1e6 / T
        print(f"[latency bound {name}] chain {chain}: {cycles:.1f} cycles a "
              f"step; its SASS main loop {issue[name]:.1f} instructions a "
              f"step; bound {bound_ns:.1f} ns at {mhz:.0f} MHz (the larger); "
              f"measured {ns:.1f} ns a sample (T = 2^16): {bound_ns / ns:.0%}"
              f" of the bound | {smi}", flush=True)
    # S1's FSM entry is time-parallel: its bound is its bytes, the rssi
    # read and the modes written once (4 + 4 a step) and the carry
    ms = graph_ms(lambda: cuda_scan.squelch_fsm_cuda(r, m0, t0, -30.0, 20), 5)
    bound = (8 * T + 16) / 3.35e12 * 1e3
    print(f"[bytes bound S1's FSM] chunk-and-join kernel, three launches: "
          f"bound {bound * 1e6 / T:.4f} ns a step ({bound:.5f} ms at T = "
          f"2^16, bytes over 3.35 TB/s); measured {ms * 1e6 / T:.2f} ns a "
          f"step ({ms:.4f} ms): {bound / ms:.1%} of the bound | {smi}",
          flush=True)
    track_latency(dev, smi, lat, mhz)
    viterbi_latency(dev, smi, lat, mhz)
    cvsd_gardner_latency(dev, smi, lat, mhz)


def viterbi_latency(dev, smi, lat: dict, mhz: float) -> None:
    """S7 (csrc/viterbi_scan.cu), soft, K = 7 (its single-warp form, pass
    1's acs_chunks_warp): the chain a step (LATENCY_CHAINS["S7"]) and the
    SASS instructions a step of the ACS loop (the unrolled round of 32
    steps, its instructions over its REDUXes), the larger over the SM
    clock, beside the time a step of a call at one row of 8166 steps, at
    the packet shape (1024 x 550) and the CCSDS frame's (64 x 8166), CUDA
    graph of 5 launches (the chunked walk: a step of a call is T steps'
    share of it, not one warp's step)."""
    from solid_dsp_tpu_torch.models import fec
    from solid_dsp_tpu_torch.ops import cuda_build, cuda_viterbi

    sass = sass_dump("viterbi_scan.cu")
    out = cuda_build.BUILD_DIR / "viterbi_scan.sass"
    out.write_text(sass)
    loops = []
    for part in sass.split("Function : ")[1:]:
        if "acs_chunks_warpILi2ELb1ELb1E" not in part.splitlines()[0]:
            continue
        ins = [(int(a, 16), op) for a, op, _ in _SASS_INSN.findall(part)]
        for addr, op, args in _SASS_INSN.findall(part):
            t = re.search(r"0x([0-9a-f]+)", args) if op == "BRA" else None
            if t and int(t.group(1), 16) < int(addr, 16):
                body = [o for a, o in ins
                        if int(t.group(1), 16) <= a <= int(addr, 16)]
                steps = sum(o.startswith("REDUX") for o in body)
                if steps:
                    loops.append((len(body), steps))
    # the unrolled round (the most steps a loop), of the two step codes
    # (four or two branch metrics) the shorter: K = 7's (171, 133) shares
    most = max(steps for _, steps in loops)
    n_ins, steps = min(loop for loop in loops if loop[1] == most)
    issue = n_ins / steps
    chain = LATENCY_CHAINS["S7"]
    cycles = sum(n * (lat[op] - (lat[_CARRIED[op]] if op in _CARRIED
                                 else 0.0)) for op, n in chain.items())
    bound_ns = max(cycles, issue) / mhz * 1e3
    tabs = (fec._tables(fec.DEFAULT_POLYS, 7)[0], fec._predecessors(7))
    rng = np.random.default_rng(41)
    for B, T in ((1, 8166), (1024, 550), (64, 8166)):
        r = torch.from_numpy(rng.standard_normal((B, T, 2))).to(
            dev, torch.float32)
        ms = graph_ms(lambda: cuda_viterbi.viterbi_cuda(r, True, *tabs), 5)
        ns = ms * 1e6 / T
        print(f"[latency bound S7, {B} x {T}] SASS kept in {out}; chain "
              f"{chain}: {cycles:.1f} cycles a step; its ACS loop "
              f"{issue:.1f} instructions a step ({n_ins} over {steps} "
              f"steps); bound {bound_ns:.1f} ns a step at {mhz:.0f} MHz "
              f"(the larger); measured {ns:.1f} ns a step ({ms:.4f} ms a "
              f"call): {bound_ns / ns:.0%} of the bound | {smi}", flush=True)


def _chain_cycles(lat: dict, chain: dict) -> float:
    return sum(n * (lat[op] - (lat[_CARRIED[op]] if op in _CARRIED else 0.0))
               for op, n in chain.items())


def _loop_sizes(sass: str, kernel: str, op_prefix: str) -> list:
    """(instructions, count of ``op_prefix`` ops) of each loop (a backward
    branch's range) of the function whose name holds ``kernel``."""
    loops = []
    for part in sass.split("Function : ")[1:]:
        if kernel not in part.splitlines()[0]:
            continue
        ins = [(int(a, 16), op) for a, op, _ in _SASS_INSN.findall(part)]
        for addr, op, args in _SASS_INSN.findall(part):
            t = re.search(r"0x([0-9a-f]+)", args) if op == "BRA" else None
            if t and int(t.group(1), 16) < int(addr, 16):
                body = [o for a, o in ins
                        if int(t.group(1), 16) <= a <= int(addr, 16)]
                loops.append((len(body), sum(o.startswith(op_prefix)
                                             for o in body)))
    return loops


def _walker_chunk(sass: str, kernel: str) -> int:
    """Instructions of S8's walking warp over a full chunk, in the function
    whose name holds ``kernel``: from its first staged read (an LDS.128
    that a compare follows, where the moving warp's are followed by
    stores) to the unconditional branch past the partial chunk's walk."""
    for part in sass.split("Function : ")[1:]:
        if kernel not in part.splitlines()[0]:
            continue
        ins = _SASS_INSN.findall(part)
        ops = [op for _, op, _ in ins]
        first = next(i for i, op in enumerate(ops) if op.startswith(
            "LDS.128") and any(o.startswith("FSETP") for o in ops[i:i + 4]))
        end = next(i for i in range(first, len(ops)) if ops[i] == "BRA")
        return end - first + 1
    raise ValueError(f"no {kernel} in the SASS")


def cvsd_gardner_latency(dev, smi, lat: dict, mhz: float) -> None:
    """S8's encoder (csrc/cvsd_scan.cu) and S9 (csrc/gardner_scan.cu): each
    chain a step (LATENCY_CHAINS); S8's bound the larger of it and its
    walking warp's full chunk in the SASS (``_walker_chunk``) over its 32
    steps, S9's the chain (its
    walker's loop also holds the untaken fall-back), over the SM clock,
    beside the time a step: S8 at one lane of 2^16 and 1024 lanes x 2^16
    (chip_smoke.py phase 42's), S9 on one stream of 2^19 symbols at sps 8
    (CUDA graph of 3 launches).  S8's decoder is time-parallel: ``s8``
    times it against its bytes bound.  The SASS is kept beside the built
    libraries."""
    from solid_dsp_tpu_torch.ops import cuda_build, cuda_cvsd, cuda_timing

    args = (0.9, 0.01, 0.001, 0.2, 3, 0.98)
    sass = sass_dump("cvsd_scan.cu")
    out = cuda_build.BUILD_DIR / "cvsd_scan.sass"
    out.write_text(sass)
    # the instantiation the codec's parameters take (clamps dropped)
    n_ins = _walker_chunk(sass, "cvsd_encode_kernelILb0E")
    issue = n_ins / 32.0
    cycles = _chain_cycles(lat, LATENCY_CHAINS["S8 encode"])
    bound_ns = max(cycles, issue) / mhz * 1e3
    rng = np.random.default_rng(42)
    for B, N in ((1, 1 << 16), (1024, 1 << 16)):
        x = sco_lanes(B, N, dev)
        ms = graph_ms(lambda: cuda_cvsd.cvsd_cuda(x, False, *args), 3)
        ns = ms * 1e6 / N
        print(f"[latency bound S8 encode, {B} x {N}] SASS kept in {out}; "
              f"chain {LATENCY_CHAINS['S8 encode']}: {cycles:.1f} cycles a "
              f"step; its walking warp's chunk {issue:.1f} instructions a "
              f"step ({n_ins} over 32 steps); bound {bound_ns:.1f} ns a step "
              f"at {mhz:.0f} MHz (the larger); measured {ns:.1f} ns a step "
              f"({ms:.4f} ms a call): {bound_ns / ns:.0%} of the bound | "
              f"{smi}", flush=True)
    sass = sass_dump("gardner_scan.cu")
    out = cuda_build.BUILD_DIR / "gardner_scan.sass"
    out.write_text(sass)
    # the walker's loop (the most shared reads) holds the fall-back's
    # untaken branch too, so its size is printed, not taken as a floor
    n_ins, k_lds = max(_loop_sizes(sass, "gardner_kernel", "LDS"),
                       key=lambda t: t[1])
    cycles = _chain_cycles(lat, LATENCY_CHAINS["S9"])
    bound_ns = cycles / mhz * 1e3
    n_sym = 1 << 19
    x = torch.from_numpy((rng.standard_normal(8 * n_sym + 12) + 1j
                          * rng.standard_normal(8 * n_sym + 12)).astype(
        np.complex64)).to(dev)
    ms = graph_ms(lambda: cuda_timing.gardner_cuda(x, 8, 0.01, 2.5e-5, 0.0,
                                                   n_sym), 3)
    ns = ms * 1e6 / n_sym
    print(f"[latency bound S9, 2^19 symbols at sps 8] SASS kept in {out}; "
          f"chain {LATENCY_CHAINS['S9']}: {cycles:.1f} cycles a symbol; its "
          f"walker's loop {n_ins} instructions with its fall-back's branch "
          f"({k_lds} shared reads); bound (the chain) {bound_ns:.1f} ns a "
          f"symbol at {mhz:.0f} MHz; "
          f"measured {ns:.1f} ns a symbol ({ms:.3f} ms a call): "
          f"{bound_ns / ns:.0%} of the bound | {smi}", flush=True)


# S8's encoder (csrc/cvsd_scan.cu) with one part changed at a time: the
# first design's one-chain step in the new loop, the next step selected by
# its boost flag instead of by the bit between the two candidates (both
# bit-equal), and the moving warp idle (no staging, no stores: wrong bits,
# only the walk's time is read).
S8_VARIANTS = {
    "as built": [],
    "the first design's step (one chain)": [
        ("  const unsigned h1 = ((hist << 1) | 1u) & p.mask;",
         "  { const unsigned bit = xv >= ref ? 1u : 0u;\n"
         "  hist = ((hist << 1) | bit) & p.mask;\n"
         "  const bool agree = (hist == 0u) | (hist == p.mask);\n"
         "  step = clampf(__fadd_rn(__fmul_rn(p.beta, step), agree ? p.gamma"
         " : 0.0f), p.dmin, p.dmax);\n"
         "  ref = clampf(__fadd_rn(__fmul_rn(p.leak, ref), bit ? step : "
         "-step), -1.0f, 1.0f);\n  return bit; }\n"
         "  const unsigned h1 = ((hist << 1) | 1u) & p.mask;")],
    "the step selected by its boost flag (bit ? a1 : a0)": [
        ("  step = bit ? s1 : s0;", "  step = (bit ? a1 : a0) ? boosted : plain;")],
    "the moving warp idle": [
        ("      if (k + 1 < nch) {\n        stage(buf ^ 1);",
         "      if (false) {\n        stage(buf ^ 1);"),
        ("      if (k > 0) expand(k - 1);", "")],
}


# S8's decoder built at other chunk lengths than the source's (DQ, its
# 32-sample groups a chunk, substituted): Lc 32 and 128 beside the 64 the
# package builds.
S8_DECODE_SIDE = {lc: [("constexpr int DQ = 2;",
                        f"constexpr int DQ = {lc // 32};")]
                  for lc in (32, 128)}


def _build_variants(source: str, out, variants: dict) -> dict:
    """Build csrc/``source`` with each variant's text substitutions under
    ``out``, all nvcc runs started together: {label: (ctypes library, the
    compiler's output)}."""
    from solid_dsp_tpu_torch.ops import cuda_build

    shutil.rmtree(out, ignore_errors=True)
    text0 = (cuda_build.CSRC / source).read_text()
    jobs = []
    for i, (label, subs) in enumerate(variants.items()):
        d = out / f"v{i}"
        d.mkdir(parents=True)
        text = text0
        for a, b in subs:
            if a not in text:
                sys.exit(f"{source} variant {label!r}: {a!r} is not in the "
                         "source")
            text = text.replace(a, b)
        (d / source).write_text(text)
        jobs.append((label, d / "libvariant.so", subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I",
             str(cuda_build.CSRC), "-o", str(d / "libvariant.so"),
             str(d / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for label, lib, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"{source} variant {label!r} did not build:\n"
                     f"{log[-4000:]}")
        libs[label] = (ctypes.CDLL(str(lib)), log)
    return libs


def ci16_library(dev, smi) -> None:
    """K1's and K2's int16 tensor-core entry points at config 4 (64 taps,
    M = 4, 2^24 samples), x3 and fast, from ddc_fm.cu and ddc_body.cu as
    they are (one library with the float32 entry points) and with the
    float32 entry points left out (the int16 instances in a library of
    their own), timed over a CUDA graph of 20 launches in turns: as is,
    alone, alone, as is; each launch bit-equal to the other build's."""
    from solid_dsp_tpu_torch.models.rx_chain import RxChainConfig
    from solid_dsp_tpu_torch.ops import cuda_build, cuda_ddc
    from solid_dsp_tpu_torch.ops.nco import constrain

    out = cuda_build.BUILD_DIR / "ci16_lib"
    cut = {"ddc_fm.cu": ("// The tensor-core route.  x (2, L), tail (2, n - M)",
                         "// ddc_fm_launch on the raw int16 block"),
           "ddc_body.cu": ("// The direct route: x (2, L), tail (2, max(n - M, 0))",
                           "// ddc_body_direct_launch on the raw int16")}
    libs = {}
    for source, (a, b) in cut.items():
        built = _build_variants(source, out / source, {
            "as is": [], "alone": [(a, "#if 0\n" + a), (b, "#endif\n" + b)]})
        for label, (lib, _) in built.items():
            libs.setdefault(label, {})[source] = lib

    def use(label):
        def typed(source, name, argtypes):
            fn = getattr(libs[label][source], name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            return fn
        cuda_ddc.launcher = typed

    L, n, M = 1 << 24, 64, 4
    rng = np.random.default_rng(44)
    x = torch.from_numpy(rng.integers(-16000, 16000, (L, 2),
                                      dtype=np.int16)).to(dev)
    tail = torch.from_numpy((0.1 * rng.standard_normal((2, n - M))).astype(
        np.float32)).to(dev)
    taps = RxChainConfig(fir_taps=n, decimation=M).design_taps()
    calls = {}
    for mode in cuda_ddc.MODES:
        fm = cuda_ddc.make_ddc_fm(taps, constrain(0.2), M, 0.1, dev, mode=mode)
        body = cuda_ddc.make_ddc_body(taps, constrain(0.2), M, dev, mode=mode)
        calls[f"K1 {mode}"] = lambda fm=fm: cuda_ddc.ddc_fm_cuda(fm, x, tail)
        calls[f"K2 {mode}"] = lambda body=body: cuda_ddc.ddc_body_cuda(
            body, x, tail)
    launcher0 = cuda_ddc.launcher
    try:
        outs = {}
        for label in ("as is", "alone", "alone", "as is"):
            use(label)
            times = []
            for key, fn in calls.items():
                got = fn()
                got = got[0] if isinstance(got, tuple) else got
                same = outs.setdefault(key, got.clone())
                times.append(f"{key} {graph_ms(fn, 20):.4f} ms"
                             f"{'' if torch.equal(got, same) else ' DIFFERS'}")
            print(f"[ci16-lib {label}] {', '.join(times)} | {smi}", flush=True)
    finally:
        cuda_ddc.launcher = launcher0


def s8_sweep(dev, smi) -> None:
    """S8's decoder (the chunk-and-join) at its chunk length as built and
    at the side builds' (S8_DECODE_SIDE), one lane and 1024 lanes of 2^16
    (phase 42's input), against its bytes bound; its five kernels as built
    (profiler); then the encoder's variants (S8_VARIANTS) at the same
    shapes.  The side builds and the variants build together, beside the
    kernels."""
    from solid_dsp_tpu_torch.ops import cuda_build, cuda_cvsd

    args = (0.9, 0.01, 0.001, 0.2, 3, 0.98)
    variants = {**{f"decode Lc {lc}": subs
                   for lc, subs in S8_DECODE_SIDE.items()}, **S8_VARIANTS}
    libs = {label: lib for label, (lib, _) in _build_variants(
        "cvsd_scan.cu", cuda_build.BUILD_DIR / "s8_variants",
        variants).items()}
    decoders = {cuda_cvsd.DECODE_CHUNK: None}
    for lc in S8_DECODE_SIDE:
        lib = libs[f"decode Lc {lc}"]
        if lib.cvsd_decode_chunk() != lc:
            sys.exit(f"S8's side build for Lc {lc} has chunks of "
                     f"{lib.cvsd_decode_chunk()}")
        fn = lib.cvsd_decode_f32
        fn.argtypes = list(cuda_cvsd._DEC_ARGS)
        fn.restype = ctypes.c_int
        decoders[lc] = fn
    for B, N in ((1, 1 << 16), (1024, 1 << 16)):
        words = cuda_cvsd.cvsd_cuda(sco_lanes(B, N, dev), False, *args)
        want = cuda_cvsd.cvsd_cuda(words, True, *args)
        y = torch.empty_like(want)
        bound = 8.0 * B * N / 3.35e12 * 1e3      # 4 in, 4 out a sample
        for lc in sorted(decoders):
            fn = decoders[lc]
            if fn is None:
                def run():
                    return cuda_cvsd.cvsd_cuda(words, True, *args)
                label = "as built"
            else:
                def run(fn=fn, lc=lc):
                    cuda_build.check_launch(cuda_cvsd.decode_launch(
                        fn, words, y, lc, *args), f"Lc {lc}")
                    return y
                label = "side build"
            err = float((run() - want).abs().max())
            ms = graph_ms(run, 5)
            print(f"[S8 decode, {B} x 2^16, Lc {lc}, {label}] {ms:.4f} ms, "
                  f"{ms * 1e6 / (B * N):.4f} ns a sample, bytes bound "
                  f"{bound:.5f} ms ({bound / ms:.1%}), max|dy| {err:.3g} "
                  f"against Lc {cuda_cvsd.DECODE_CHUNK} | {smi}", flush=True)
        rows = profiled_rows(lambda: cuda_cvsd.cvsd_cuda(words, True, *args),
                             5)
        print(f"[S8 decode, {B} x 2^16, Lc {cuda_cvsd.DECODE_CHUNK}, kernels "
              f"(profiler, ms a call)] "
              + "; ".join(f"{k[:48]} {t:.4f} ({c} records)"
                          for t, k, c in rows) + f" | {smi}", flush=True)
    f32 = np.float32
    for label in S8_VARIANTS:
        fn = libs[label].cvsd_encode_f32
        fn.argtypes = list(cuda_cvsd._ENC_ARGS)
        fn.restype = ctypes.c_int
        times = []
        for B, N in ((1, 1 << 16), (1024, 1 << 16)):
            x = sco_lanes(B, N, dev)
            bits = torch.empty((B, N), dtype=torch.int32, device=dev)

            def run():
                cuda_build.check_launch(fn(
                    x.data_ptr(), bits.data_ptr(), B, N, f32(0.9), f32(0.01),
                    f32(0.001), f32(0.2), f32(0.98), 7, 0,
                    torch.cuda.current_stream(dev).cuda_stream), label)
            ms = graph_ms(run, 3)
            times.append(f"{B} x 2^16: {ms:.4f} ms, {ms * 1e6 / N:.1f} ns a "
                         "step")
        print(f"[s8 encode variant] {label}: {'; '.join(times)} | {smi}",
              flush=True)


# S6 (csrc/bcjr_scan.cu) built at other chunk lengths than the source's (LC
# substituted: 16 and 64 beside the 32 the package builds) and with passes
# left out (wrong LLRs; only the times are read): what each pass costs.
_S6_CALL = "      chunk_matrices<Src, {}>(src, mats, slots, tr, C, last);\n"
_S6_PASS1 = ("    if (tr.shift)\n" + _S6_CALL.format("true") + "    else\n"
             + _S6_CALL.format("false"), "")
_S6_JOIN = ("    if (threadIdx.x < 32)\n      join(mats, bnd, C);\n    else\n",
            "    if (threadIdx.x >= 32)\n")
_S6_PASS3 = ("  chunk_llrs(src, bnd, slots, tr, C, last, T);\n"
             "  __syncthreads();\n}", "}")
_S6_GENERIC = ("    if (tr.shift)\n", "    if (false)\n")
S6_SIDE = {
    **{f"Lc {lc}": [("constexpr int LC = 32;", f"constexpr int LC = {lc};")]
       for lc in (16, 64)},
    "the generic layout": [_S6_GENERIC],
    "no pass 3": [_S6_PASS3],
    "pass 1 only": [_S6_JOIN, _S6_PASS3],
    "pass 1 only, the generic layout": [_S6_JOIN, _S6_PASS3, _S6_GENERIC],
    "no pass 1": [_S6_PASS1],
    "pass 3 only": [_S6_PASS1, _S6_JOIN],
    "no passes": [_S6_PASS1, _S6_JOIN, _S6_PASS3],
}
S6_ROWS, S6_K = 128, 1024     # turbo_decode_1024_6it's codewords


def s6_sweep(dev, smi) -> None:
    """S6 (the chunk-and-join) at its chunk length as built and at the side
    builds' (S6_SIDE), its walk entry at 128 rows and one row of 1027 steps
    (phase 40's first walk) against its bound, and its fused decode of 128
    and one codeword of 1024 bits at six iterations, each over a CUDA graph
    with its largest difference from the build as built; then the passes'
    times from the builds that leave passes out (pass 1 alone; the join,
    pass 1 and the join less pass 1; pass 3, the whole less pass 1 and the
    join).  Each side build's registers and spills are printed."""
    from solid_dsp_tpu_torch.models import turbo
    from solid_dsp_tpu_torch.ops import cuda_bcjr, cuda_build

    libs = _build_variants("bcjr_scan.cu",
                           cuda_build.BUILD_DIR / "s6_variants", S6_SIDE)
    for label, (_, log) in libs.items():
        use = [ln.strip() for ln in log.splitlines()
               if "registers" in ln or "spill" in ln]
        print(f"[S6 side build {label}] ptxas: {' / '.join(use)}", flush=True)
    tables = turbo._rsc_tables(turbo.DEFAULT_FB, turbo.DEFAULT_FF, 3)[:4]
    tabs = cuda_bcjr._trellis("s6 sweep", tables)
    B, K, n_iter = S6_ROWS, S6_K, 6
    code = turbo.TurboCode(K, n_iter=n_iter, device=dev)
    rng = np.random.default_rng(40)
    cw = code.encode(torch.from_numpy(rng.integers(0, 2, (B, K))).to(dev))
    rx = (4.0 * (1 - 2.0 * cw) + torch.from_numpy(
        rng.standard_normal(tuple(cw.shape))).to(dev)).to(torch.float32)
    ls = torch.cat([rx[:, :K], rx[:, 3 * K:3 * K + 3]], -1).contiguous()
    lp = torch.cat([rx[:, K:2 * K], rx[:, 3 * K + 3:3 * K + 6]],
                   -1).contiguous()
    perm = torch.from_numpy(code.perm.astype(np.int32)).to(dev)

    def stream():                 # the capturing stream inside a CUDA graph
        return torch.cuda.current_stream(dev).cuda_stream

    def walker(label, lib):
        if lib is None:
            return lambda a, b: cuda_bcjr.bcjr_maxlog_cuda(a, b, K, *tables)
        fn = lib.bcjr_maxlog_f32
        fn.argtypes = list(cuda_bcjr._ARGS)
        fn.restype = ctypes.c_int
        nf = lib.bcjr_scratch_floats
        nf.argtypes = [ctypes.c_int]
        nf.restype = ctypes.c_longlong

        def run(a, b):
            rows, Tm = a.shape
            llr = torch.empty((rows, K), dtype=torch.float32, device=dev)
            scratch = torch.empty((rows, nf(Tm)), dtype=torch.float32,
                                  device=dev)
            cuda_build.check_launch(fn(
                a.data_ptr(), b.data_ptr(), llr.data_ptr(),
                scratch.data_ptr(), ctypes.addressof(tabs), rows, Tm, K,
                dev.index, stream()), label)
            return llr
        return run

    def decoder(label, lib):
        if lib is None:
            return lambda r: code.decode(r)[1]
        fn = lib.turbo_decode_f32
        fn.argtypes = list(cuda_bcjr._DECODE_ARGS)
        fn.restype = ctypes.c_int

        def run(r):
            rows = r.shape[0]
            llr = torch.empty((rows, K), dtype=torch.float32, device=dev)
            bits = torch.empty((rows, K), dtype=torch.int32, device=dev)
            cuda_build.check_launch(fn(
                r.data_ptr(), perm.data_ptr(), llr.data_ptr(),
                bits.data_ptr(), ctypes.addressof(tabs), rows, K, n_iter,
                dev.index, stream()), label)
            return llr
        return run

    builds = {"Lc 32, as built": None, **{k: v[0] for k, v in libs.items()}}
    times = {}
    for rows in (B, 1):
        walk_ref = cuda_bcjr.bcjr_maxlog_cuda(ls[:rows], lp[:rows], K,
                                              *tables)
        dec_ref = code.decode(rx[:rows])[1]
        bound = (4.0 * rows * (3 * K + 6)) / 3.35e12 * 1e3
        for label, lib in builds.items():
            walk, dec = walker(label, lib), decoder(label, lib)
            a, b, r = ls[:rows], lp[:rows], rx[:rows]
            err_w = float((walk(a, b) - walk_ref).abs().max())
            err_d = float((dec(r) - dec_ref).abs().max())
            ms_w = graph_ms(lambda: walk(a, b), 20)
            ms_d = graph_ms(lambda: dec(r), 5)
            times[rows, label] = ms_w, ms_d
            print(f"[S6 {label}, {rows} x {K + 3}] walk {ms_w:.4f} ms "
                  f"(bytes bound {bound:.6f} ms, {bound / ms_w:.2%}), max|d| "
                  f"{err_w:.3g}; fused decode of {rows} x {K} at {n_iter} "
                  f"it {ms_d:.4f} ms ({ms_d / (2 * n_iter) * 1e3:.2f} us a "
                  f"half-iteration), max|d| {err_d:.3g} | {smi}", flush=True)
        t = {k[1]: v for k, v in times.items() if k[0] == rows}
        for i, what in ((0, "walk"), (1, "fused decode")):
            p1, no3 = t["pass 1 only"][i], t["no pass 3"][i]
            whole = t["Lc 32, as built"][i]
            print(f"[S6 passes, {rows} x {K + 3}, {what}, ms] pass 1 "
                  f"{p1:.4f} ({t['pass 1 only, the generic layout'][i]:.4f}"
                  f" in the generic layout), join {no3 - p1:.4f}, pass 3 "
                  f"{whole - no3:.4f} (alone {t['pass 3 only'][i]:.4f}), the "
                  f"launch with no pass {t['no passes'][i]:.4f}; whole "
                  f"{whole:.4f} | {smi}", flush=True)


# S7 (csrc/viterbi_scan.cu) in side builds: the passes alone (each on the
# scratch of a whole call, so that it reads what it would read), and the
# single-warp form (64 states) with one part of its step taken away at a
# time, built with pass 1 alone (each such variant is wrong, and its wrong
# metrics would re-walk every chunk in pass 2; only its time is read: what
# each part costs a step); pass 3's lookahead of words and the chunks a
# block, whole calls.
_S7_PASS = {1: ("  {  // pass 1\n", "  if (false) {  // pass 1\n"),
            2: ("  {  // pass 2\n", "  if (false) {  // pass 2\n"),
            3: ("  if (p.T > 0) {  // pass 3\n", "  if (false) {  // pass 3\n")}
_S7_PASS1_ALONE = [_S7_PASS[2], _S7_PASS[3]]
S7_VARIANTS = {
    "as built": [],
    **{f"pass {i} alone": [sub for k, sub in _S7_PASS.items() if k != i]
       for i in (1, 2, 3)},
    "pass 1 alone, no warp minimum (the lane's own)": [
        ("g = from_key(__reduce_min_sync(FULL, order_key(vmin)));",
         "g = vmin;")] + _S7_PASS1_ALONE,
    "pass 1 alone, no key conversions": [
        ("g = from_key(__reduce_min_sync(FULL, order_key(vmin)));",
         "g = __int_as_float(__reduce_min_sync(FULL, "
         "__float_as_int(vmin)));")] + _S7_PASS1_ALONE,
    "pass 1 alone, no ballots": [
        ("const unsigned wa = __ballot_sync(FULL, cha);",
         "const unsigned wa = cha;"),
        ("const unsigned wb = __ballot_sync(FULL, chb);",
         "const unsigned wb = chb;")] + _S7_PASS1_ALONE,
    "pass 1 alone, no shuffles back in place": [
        ("__shfl_sync(FULL, va, src)", "va"),
        ("__shfl_sync(FULL, vb, src)", "vb"),
        ("__shfl_sync(FULL, va, src + 16)", "va"),
        ("__shfl_sync(FULL, vb, src + 16)", "vb")] + _S7_PASS1_ALONE,
    "pass 1 alone, no shared-memory reads of the values": [
        ("for (int k = 0; k < NK; ++k) rn[k] = rc[inext + k];",
         "for (int k = 0; k < NK; ++k) rn[k] = rv[k];")] + _S7_PASS1_ALONE,
    "pass 1 alone, one shuffle back in place of four": [
        ("__shfl_sync(FULL, vb, src)", "vb"),
        ("__shfl_sync(FULL, va, src + 16)", "va"),
        ("__shfl_sync(FULL, vb, src + 16)", "vb")] + _S7_PASS1_ALONE,
    "pass 3 loads 8 steps ahead": [("constexpr int TA = 16;",
                                    "constexpr int TA = 8;")],
    "pass 3 loads 32 steps ahead": [("constexpr int TA = 16;",
                                     "constexpr int TA = 32;")],
    "CPB 1": [("constexpr int CPB = 4;", "constexpr int CPB = 1;")],
    "CPB 2": [("constexpr int CPB = 4;", "constexpr int CPB = 2;")],
    "CPB 8": [("constexpr int CPB = 4;", "constexpr int CPB = 8;")],
}
# label: (rows, steps, Eb/N0 dB, K, code rate): chip_smoke.py phase 41's
# three shapes, then the block form (K = 9, 256 states) at the packet
# shape and the CCSDS rows at 1 dB, below any operating point (the BER
# sweeps of models/ber.py go there), where seams fail and pass 2 re-walks
S7_SHAPES = {"1024 x 550": (1024, 550, 4.0, 7, 0.5),
             "64 x 8166": (64, 8166, 2.8, 7, 0.5 * 223 / 255),
             "1 x 550": (1, 550, 4.0, 7, 0.5),
             "1024 x 550, K = 9": (1024, 550, 4.0, 9, 0.5),
             "64 x 8166 at 1 dB": (64, 8166, 1.0, 7, 0.5 * 223 / 255)}
S7_POLYS = {7: (0o171, 0o133), 9: (0o561, 0o753)}
S7_PLAIN_ROWS = 4          # rows held against viterbi_plain at each shape
S7_W = (96, 132, 160)
S7_D = (32, 48, 66, 96, 132)
S7_L = {"1024 x 550": (104, 150, 209, 275, 418),
        "64 x 8166": (128, 192, 252, 384, 512),
        "1 x 550": (16, 32, 64, 128)}
# The sequential kernel's C entry (one warp a row walking all its steps):
# viterbi_acs(rx, soft, masks, bits, pm, dec, B, T, n, S, device, stream)
_S7_SEQUENTIAL_ARGS = ((ctypes.c_void_p, ctypes.c_int)
                       + (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 5
                       + (ctypes.c_void_p,))


def _s7_rows(dev, B: int, T: int, ebn0: float, K: int, rate: float,
             seed: int):
    """(B, T, 2) float32 LLRs of codewords of the rate-1/2 code S7_POLYS[K]
    through BPSK and AWGN at Eb/N0 for a code rate ``rate`` (chip_smoke.py
    phase 41's awgn_llr)."""
    from solid_dsp_tpu_torch.models import fec

    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, (B, T - K + 1))
    c = fec.conv_encode(torch.from_numpy(info), S7_POLYS[K], K).numpy()
    sigma = np.sqrt(1 / (2 * rate * 10 ** (ebn0 / 10)))
    y = (1 - 2.0 * c) + sigma * rng.standard_normal(c.shape)
    return torch.from_numpy((2 * y / sigma ** 2).astype(np.float32)).to(
        dev).reshape(B, T, 2)


class _S7Call:
    """One scratch for S7 calls on soft rows r (B, T, 2) of the code
    S7_POLYS[K] with the chunk plan (L, W, C) and the trace's lookahead D:
    run(fn) launches the library function fn (viterbi_acs's signature) on
    it; bits, pm and fix (re-walked chunks, re-traced pieces) are its
    outputs."""

    def __init__(self, r, K: int, plan, D: int):
        from solid_dsp_tpu_torch.models import fec
        from solid_dsp_tpu_torch.ops import cuda_viterbi

        dev = r.device
        B, T = r.shape[:2]
        S = 1 << (K - 1)
        out_tab = fec._tables(S7_POLYS[K], K)[0]
        self.r, self.S, self.plan, self.D = r, S, plan, D
        self.masks = torch.from_numpy(cuda_viterbi._masks(
            np.asarray(out_tab, np.int64).tobytes(), S, 2).view(
                np.int32)).to(dev)
        self.bits = torch.empty((B, T), dtype=torch.int32, device=dev)
        self.pm = torch.empty((B, S), dtype=torch.float32, device=dev)
        self.dec = torch.empty((B, T, max(1, S // 32)), dtype=torch.int32,
                               device=dev)
        self.vec = torch.empty((B, plan[2], 2, S), dtype=torch.float32,
                               device=dev)
        self.ends = torch.empty((B, -(-T // cuda_viterbi.TRACE_PIECE), 2),
                                dtype=torch.int32, device=dev)
        self.tick = torch.zeros(B, dtype=torch.int32, device=dev)
        self.fix = torch.zeros(2, dtype=torch.int64, device=dev)

    def run(self, fn) -> None:
        from solid_dsp_tpu_torch.ops import cuda_build, cuda_viterbi

        B, T = self.r.shape[:2]
        L, W, C = self.plan
        cuda_build.check_launch(fn(
            self.r.data_ptr(), 1, self.masks.data_ptr(), self.bits.data_ptr(),
            self.pm.data_ptr(), self.dec.data_ptr(), self.vec.data_ptr(),
            self.ends.data_ptr(), self.tick.data_ptr(), self.fix.data_ptr(),
            B, T, 2, self.S, L, W, C, cuda_viterbi.TRACE_PIECE, self.D,
            self.r.device.index, torch.cuda.current_stream().cuda_stream),
            "s7")

    def sequential(self, fn) -> None:
        """The sequential kernel fn on the same rows, bits, pm and dec."""
        from solid_dsp_tpu_torch.ops import cuda_build

        B, T = self.r.shape[:2]
        cuda_build.check_launch(fn(
            self.r.data_ptr(), 1, self.masks.data_ptr(), self.bits.data_ptr(),
            self.pm.data_ptr(), self.dec.data_ptr(), B, T, 2, self.S,
            self.r.device.index, torch.cuda.current_stream().cuda_stream),
            "s7 sequential")

    def counted(self, fn):
        """(bits, pm, [re-walked, re-traced]) of one call of fn."""
        self.fix.zero_()
        self.run(fn)
        torch.cuda.synchronize()
        return self.bits.clone(), self.pm.clone(), self.fix.tolist()


def s7_sweep(dev, smi, sequential: str | None = None) -> None:
    """S7 (the chunked walk) at S7_SHAPES: as built (chunk_plan), its
    re-walked chunks and re-traced pieces, bit-equal to viterbi_plain on
    S7_PLAIN_ROWS rows, and each pass alone (side builds, on the scratch of
    a whole call); the sequential kernel built from ``sequential`` (an
    earlier viterbi_scan.cu with its C entry, _S7_SEQUENTIAL_ARGS) on the
    same rows where given, checked bit-equal; pass 3 at the lookaheads
    S7_D; then L and W swept (S7_L, S7_W) at phase 41's three shapes; each
    time over a CUDA graph of 20 calls.  Then the step's variants
    (S7_VARIANTS) at the three shapes' plans as built.  The SASS is kept in
    _build/viterbi_scan.sass."""
    from solid_dsp_tpu_torch.models import fec
    from solid_dsp_tpu_torch.ops import cuda_build, cuda_viterbi

    seq_job = None
    if sequential:
        out = cuda_build.BUILD_DIR / "s7_sequential"
        shutil.rmtree(out, ignore_errors=True)
        out.mkdir(parents=True)
        seq_job = subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
             str(out / "libsequential.so"), sequential],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = _build_variants("viterbi_scan.cu",
                           cuda_build.BUILD_DIR / "s7_variants", S7_VARIANTS)
    seq = None
    if seq_job is not None:
        log, _ = seq_job.communicate()
        if seq_job.returncode:
            sys.exit(f"the sequential kernel did not build:\n{log[-4000:]}")
        seq = ctypes.CDLL(str(out / "libsequential.so")).viterbi_acs
        seq.argtypes = list(_S7_SEQUENTIAL_ARGS)
        seq.restype = ctypes.c_int
    fns = {}
    for label, (lib, _) in libs.items():
        fns[label] = lib.viterbi_acs
        fns[label].argtypes = list(cuda_viterbi._ARGS)
        fns[label].restype = ctypes.c_int
    (cuda_build.BUILD_DIR / "viterbi_scan.sass").write_text(
        sass_dump("viterbi_scan.cu"))
    built = cuda_viterbi.launcher("viterbi_scan.cu", "viterbi_acs",
                                  cuda_viterbi._ARGS)
    plans = {}
    for seed, (name, (B, T, ebn0, K, rate)) in enumerate(S7_SHAPES.items()):
        S = 1 << (K - 1)
        r = _s7_rows(dev, B, T, ebn0, K, rate, seed + 1)
        L, W, _, C = cuda_viterbi.chunk_plan(B, T, S)
        D = cuda_viterbi.trace_ahead(S)
        plans[name] = (r, K, (L, W, C), D)
        call = _S7Call(r, K, (L, W, C), D)
        bits, pm, fx = call.counted(built)
        sub = r[:S7_PLAIN_ROWS]
        bp, pp = fec.viterbi_plain(sub, fec._tables(S7_POLYS[K], K)[0], True)
        plain = (torch.equal(bits[:S7_PLAIN_ROWS], bp)
                 and torch.equal(pm[:S7_PLAIN_ROWS], pp))
        whole = graph_ms(lambda: call.run(built), 20)
        passes = "; ".join(
            f"pass {i} alone "
            f"{graph_ms(lambda: call.run(fns[f'pass {i} alone']), 20):.4f}"
            for i in (1, 2, 3))
        # chip_smoke.py phase 41's bound: the LLRs read once, the bits and
        # final metrics written once; 9 operations a state a step
        t_bytes = 4.0 * B * (2 * T + T + S) / 3.35e12 * 1e3
        t_ops = 9.0 * B * T * S / 67e12 * 1e3
        bound = (f"bound {max(t_bytes, t_ops):.5f} ms "
                 f"({'bytes' if t_bytes >= t_ops else 'operations'})")
        line = (f"[s7 {name}] as built L, W, C = {(L, W, C)}, D = {D}: "
                f"{whole:.4f} ms, {bound}; {passes} ms; re-walked chunks "
                f"{fx[0]} of "
                f"{B * (C - 1)} seams, re-traced pieces {fx[1]}; bit-equal "
                f"to viterbi_plain on {len(sub)} rows: {plain}")
        if seq is not None:
            call.sequential(seq)
            torch.cuda.synchronize()
            same = torch.equal(call.bits, bits) and torch.equal(call.pm, pm)
            seq_ms = graph_ms(lambda: call.sequential(seq), 20)
            again = graph_ms(lambda: call.run(built), 20)
            line += (f"; the sequential kernel {seq_ms:.4f} ms (bit-equal: "
                     f"{same}), the chunked walk again {again:.4f} ms")
        print(f"{line} | {smi}", flush=True)
        if name not in S7_L:
            continue
        for D2 in S7_D:
            c2 = _S7Call(r, K, (L, W, C), D2)
            b2, p2, f2 = c2.counted(built)
            same = torch.equal(b2, bits) and torch.equal(p2, pm)
            print(f"[s7 {name}] D = {D2}: pass 3 alone "
                  f"{graph_ms(lambda: c2.run(fns['pass 3 alone']), 20):.4f} "
                  f"ms, re-traced pieces {f2[1]}, bit-equal to as built: "
                  f"{same} | {smi}", flush=True)
        for W2 in S7_W:
            for L2 in S7_L[name]:
                C2 = cuda_viterbi.chunk_layout(T, L2, W2)[1]
                c2 = _S7Call(r, K, (L2, W2, C2), D)
                b2, p2, f2 = c2.counted(built)
                same = torch.equal(b2, bits) and torch.equal(p2, pm)
                ms = graph_ms(lambda: c2.run(built), 20)
                print(f"[s7 {name}] L = {L2}, W = {W2}, C = {C2}: {ms:.4f} "
                      f"ms, re-walked chunks and re-traced pieces {f2}, "
                      f"bit-equal to as built: {same} | {smi}", flush=True)
    for label, fn in fns.items():
        if label.startswith("pass ") and label.endswith(" alone"):
            continue
        times = []
        for name in S7_L:
            r, K, plan, D = plans[name]
            call = _S7Call(r, K, plan, D)
            call.run(built)
            times.append(f"{name} {graph_ms(lambda: call.run(fn), 20):.4f} "
                         "ms")
        print(f"[s7 variant] {label}: {'; '.join(times)} | {smi}",
              flush=True)


def cfar_route(dev, smi) -> None:
    """F7's two exact window sums for models/radar.py::cfar_ca at
    cfar_ca_g2t16's shape (2^22 exponential(1) cells, guard 2, train 16):
    the box sum by conv1d with ones (as built) and a float64 running sum
    cast back, each timed over a CUDA graph of 10 calls in turns (box,
    f64, f64, box) with its thresholds' largest error relative to a
    float64 evaluation on the CPU."""
    from solid_dsp_tpu_torch.models import radar

    N, guard, train, pfa = 1 << 22, 2, 16, 1e-4
    rng = np.random.default_rng(0)
    p_np = rng.exponential(1.0, N).astype(np.float32)
    p = torch.from_numpy(p_np).to(dev)

    def f64_route():
        c = torch.cat([p.new_zeros(1, dtype=torch.float64),
                       torch.cumsum(p.double(), 0)])
        i = torch.arange(N, device=dev)

        def at(off):
            return c[torch.clamp(i + off, 0, N)]
        total = ((at(-guard) - at(-guard - train))
                 + (at(1 + guard + train) - at(1 + guard))).float()
        count, alpha = radar._cfar_constants(N, guard, train, pfa,
                                             torch.float32, dev)
        thr = alpha * (total / count)
        return p > thr, thr

    routes = {"box (conv1d)": lambda: radar.cfar_ca(p, guard, train, pfa),
              "float64 running sum": f64_route}
    c = np.concatenate([[0.0], np.cumsum(p_np.astype(np.float64))])
    i = np.arange(N)
    at = lambda off: c[np.clip(i + off, 0, N)]  # noqa: E731
    total = (at(-guard) - at(-guard - train) + at(1 + guard + train)
             - at(1 + guard))
    left_n = np.clip(i - guard, 0, N) - np.clip(i - guard - train, 0, N)
    right_n = (np.clip(i + 1 + guard + train, 0, N)
               - np.clip(i + 1 + guard, 0, N))
    cnt = np.maximum(left_n + right_n, 1).astype(np.float64)
    ref = cnt * (pfa ** (-1.0 / cnt) - 1.0) * total / cnt
    times = {k: [] for k in routes}
    for name in ("box (conv1d)", "float64 running sum",
                 "float64 running sum", "box (conv1d)"):
        times[name].append(graph_ms(routes[name], 10))
    for name, fn in routes.items():
        err = float(np.abs(fn()[1].cpu().numpy() / ref - 1).max())
        print(f"[cfar route {name}] 2^22 cells, g2 t16: "
              + " / ".join(f"{t:.4f}" for t in times[name])
              + f" ms (CUDA graph of 10, in turns); thresholds' largest "
              f"error {err:.3g} relative to float64 | {smi}", flush=True)




def track_latency(dev, smi, lat: dict, mhz: float) -> None:
    """S5 (csrc/track_scan.cu, float32, one lane of T = 2^16): its
    loop-carried chain (LATENCY_CHAINS) over the probe's latencies and the
    main loop's SASS instructions a step, the larger over the SM clock
    beside the time a step (CUDA graph of 5 launches).  S4's entries are
    chunk-and-join kernels, bound by their bytes: ``s4`` times them."""
    import importlib

    from solid_dsp_tpu_torch.ops import cuda_build

    lpc = importlib.import_module("solid_dsp_tpu_torch.analysis.lpc")
    sass = sass_dump("track_scan.cu")
    out = cuda_build.BUILD_DIR / "track_scan.sass"
    out.write_text(sass)
    print(f"[latency] track_scan.cu SASS: {len(sass.splitlines())} lines, "
          f"kept in {out}", flush=True)
    T = 1 << 16
    rng = np.random.default_rng(39)
    y = torch.from_numpy(rng.standard_normal(T)).to(dev, torch.float32)
    k16 = torch.from_numpy(0.5 * rng.uniform(-1, 1, 16)).to(dev,
                                                            torch.float32)
    k64 = torch.from_numpy(0.5 * rng.uniform(-1, 1, 64)
                           / np.sqrt(np.arange(1, 65))).to(dev, torch.float32)
    runs = {
        "S5 p=16": (lambda: lpc.lattice_iir(y, k16),
                    "lattice_iir_kernelIfLi16EE", 8),
        "S5 p=64": (lambda: lpc.lattice_iir(y, k64),
                    "lattice_iir_kernelIfLi64EE", 8),
    }
    for name, (fn, kernel, steps) in runs.items():
        chain = LATENCY_CHAINS[name]
        cycles = sum(n * lat[op] for op, n in chain.items())
        # each kernel's main loop: a chunk of `steps` steps, unrolled
        # (track_scan.cu's LATTICE_CHUNK)
        issue = sass_step_instructions(sass, kernel, None, steps=steps)
        bound_ns = max(cycles, issue) / mhz * 1e3
        ns = graph_ms(fn, 5) * 1e6 / T
        print(f"[latency bound {name}] chain {chain}: {cycles:.1f} cycles a "
              f"step; its SASS main loop {issue:.1f} instructions a step; "
              f"bound {bound_ns:.1f} ns at {mhz:.0f} MHz (the larger); "
              f"measured {ns:.1f} ns a step (T = 2^16): {bound_ns / ns:.0%} "
              f"of the bound | {smi}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script runs only on a GPU")
    from torch.profiler import ProfilerActivity, profile

    from solid_dsp_tpu_torch.models.channel_bank import design_channel_sos
    from solid_dsp_tpu_torch.models.rx_chain import RxChainConfig
    from solid_dsp_tpu_torch.ops import cuda_build, cuda_ddc, cuda_iir
    from solid_dsp_tpu_torch.ops.nco import constrain

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    if sys.argv[1:] == ["fir-route"]:
        fir_route_sweep(dev, smi)
        return
    if sys.argv[1:] == ["s3"]:
        cuda_build.build()
        s3_sweep(dev, smi)
        return
    if sys.argv[1:] == ["s4"]:
        cuda_build.build()
        s4_sweep(dev, smi)
        return
    if sys.argv[1:] == ["latency"]:
        cuda_build.build()
        latency_sweep(dev, smi)
        return
    if sys.argv[1:] == ["cfar-route"]:
        cfar_route(dev, smi)
        return
    if sys.argv[1:] == ["k1-direct"]:
        cuda_build.build()
        k1_direct_sweep(dev, smi)
        return
    if sys.argv[1:] == ["k1-route"]:
        cuda_build.build()
        k1_route_times(dev, smi)
        return
    if sys.argv[1:] == ["fsm"]:
        cuda_build.build()
        fsm_sweep(dev, smi)
        return
    if sys.argv[1:] == ["s8"]:
        cuda_build.build()
        s8_sweep(dev, smi)
        return
    if sys.argv[1:] == ["s6"]:
        cuda_build.build()
        s6_sweep(dev, smi)
        return
    if sys.argv[1:] == ["ci16-lib"]:
        ci16_library(dev, smi)
        return
    if sys.argv[1:2] == ["s7"] and len(sys.argv) <= 3:
        cuda_build.build()
        s7_sweep(dev, smi, *sys.argv[2:])
        return
    cuda_build.build()

    M5, T = 256, 1 << 14
    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.standard_normal((T, M5)) + 1j * rng.standard_normal(
        (T, M5))).astype(np.complex64)).to(dev)
    chunk = cuda_iir.IIR_CHUNK
    for label, sos in (("shared", design_channel_sos()),
                       ("narrow", design_channel_sos(0.005))):
        sl = cuda_iir.iir_bank_lanes(sos, M5, dev)
        st0 = cuda_iir.iir_bank_init(sos.shape[0], M5, dev)
        yp, sp = cuda_iir.iir_bank_torch(sl, st0, x)
        for Lc in (16, 32, 64, 128):
            cuda_iir.IIR_CHUNK = Lc
            tables = cuda_iir.iir_join_tables(sl, Lc)
            y, st = cuda_iir.iir_bank_cuda(sl, st0, x, tables)
            ms = graph_ms(lambda: cuda_iir.iir_bank_cuda(sl, st0, x, tables), 20)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    cuda_iir.iir_bank_cuda(sl, st0, x, tables)
                torch.cuda.synchronize()
            parts = ", ".join(
                f"{e.key.split('::')[-1].split('<')[0]} "
                f"{e.self_device_time_total / 1e3 / e.count:.4f}"
                for e in prof.key_averages()
                if e.self_device_time_total > 0 and "iir_" in e.key)
            print(f"[K6 {label}, T=2^14 C=256 S=2, Lc={Lc}] {ms:.4f} ms (CUDA "
                  f"graph of 20 calls); kernels, ms: {parts}; max |err| y "
                  f"{float((y - yp).abs().max()):.3g}, state "
                  f"{float((st - sp).abs().max()):.3g} | {smi}", flush=True)
        cuda_iir.IIR_CHUNK = chunk

    n, M, L = 64, 4, 1 << 24
    rng = np.random.default_rng(3)
    xs = 0.5 * np.exp(1j * 0.21 * np.arange(L)) + 0.1 * (
        rng.standard_normal(L) + 1j * rng.standard_normal(L))
    x2 = torch.from_numpy(np.stack([xs.real, xs.imag]).astype(np.float32)).to(dev)
    tail = torch.from_numpy((0.3 * rng.standard_normal((2, n - M))).astype(
        np.float32)).to(dev)
    fn = cuda_build.launcher("ddc_body.cu", "ddc_body_launch",
                             cuda_ddc._DDC_BODY_ARGS)
    hpad = -(-(n - M) // 4) * 4
    for mode in cuda_ddc.MODES:          # x3, then the bf16 bank's "fast"
        body = cuda_ddc.make_ddc_body(RxChainConfig(fir_taps=n).design_taps(),
                                      constrain(0.2), M, dev, mode=mode)
        zp = cuda_ddc.ddc_body_torch(body, x2, tail).cpu().numpy()
        fast = mode == "fast"
        for P in (8, 16):
            KP = -(-(hpad + P * M) // 32) * 32
            SP = -(-(63 * P * M + KP + 4) // 4) * 4
            bank_bytes = (KP // 8 if fast else 2 * (KP // 4)) * 32 * 2 * P
            bank = cuda_ddc._tc_bank(body, P, hpad, KP)
            z = torch.empty((2, L // M), device=dev)
            for wgs, stages in ((2, 2), (1, 2), (2, 1)):
                smem = (bank_bytes + wgs * stages * 2 * SP * 4
                        + (1 + stages * wgs) * 8)

                def run():
                    cuda_build.check_launch(fn(
                        x2.data_ptr(), tail.data_ptr(), bank.data_ptr(),
                        z.data_ptr(), L, n, M, P, hpad, KP, wgs, stages, smem,
                        int(fast), 0, torch.cuda.current_stream().cuda_stream),
                        "ddc_body")
                run()
                torch.cuda.synchronize()
                print(f"[body {mode} n=64 M=4 L=2^24, P={P}, {wgs} "
                      f"warpgroup(s) of {stages} stage(s) a block] "
                      f"{graph_ms(run, 20):.4f} ms (CUDA graph of 20 "
                      f"launches), {snr_db(z.cpu().numpy(), zp):.1f} dB vs "
                      f"plain | {smi}", flush=True)

    k1_sweep(dev, smi, x2, tail)


# Cephes' atanf on [0, 1] after one reduction, as a drop-in for atan2f
POLY_ATAN2 = r"""
__device__ __forceinline__ float poly_atan2(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float mx = fmaxf(ax, ay), mn = fminf(ax, ay);
  const bool mid = mn > 0.41421356237f * mx;
  const float num = mid ? mn - mx : mn;
  const float den = mid ? mn + mx : mx;
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(den));
  float t = num * r;
  t = fmaf(r, fmaf(-den, t, num), t);
  const float z = t * t;
  const float p = fmaf(fmaf(fmaf(8.05374449538e-2f, z, -1.38776856032e-1f), z,
                            1.99777106478e-1f), z, -3.33329491539e-1f);
  float a = fmaf(p * z, t, t) + (mid ? 0.78539816339744831f : 0.f);
  if (ay > ax) a = 1.57079632679489662f - a;
  if (signbit(x)) a = 3.14159265358979324f - a;
  if (mx == 0.f) a = signbit(x) ? 3.14159265358979324f : 0.f;
  return copysignf(a, y);
}
"""
ATAN = "a[j] = atan2f(dim, dre) * scale;"
EPILOGUE = "// The FM epilogue of the tensor-core route"
SEAM = "for (int i = lane; i < n; i += 32) {"
K1_VARIANTS = {
    "the kernel (atan2f)": [],
    "polynomial atan2": [(ATAN, "a[j] = poly_atan2(dim, dre) * scale;"),
                         (EPILOGUE, POLY_ATAN2 + EPILOGUE)],
    "no seams (wrong audio)": [(SEAM, "for (int i = lane; i < 0; i += 32) {")],
    "no discriminator (wrong audio)": [(ATAN, "a[j] = (dim + dre) * scale;")],
}


def k1_variant_launchers():
    """{label: ddc_fm_launch of that variant}, built at once like the
    kernels (ops/cuda_build.py) into solid_dsp_tpu_torch/_build/."""
    from solid_dsp_tpu_torch.ops import cuda_build, cuda_ddc

    out = cuda_build.BUILD_DIR / "k1_variants"
    shutil.rmtree(out, ignore_errors=True)
    source = (cuda_build.CSRC / "ddc_fm.cu").read_text()
    jobs = []
    for i, (label, subs) in enumerate(K1_VARIANTS.items()):
        d = out / f"v{i}"
        d.mkdir(parents=True)
        for h in cuda_build.CSRC.glob("*.cuh"):
            shutil.copy(h, d)
        text = source
        for a, b in subs:
            if a not in text:
                sys.exit(f"K1 variant {label!r}: {a!r} is not in ddc_fm.cu")
            text = text.replace(a, b)
        (d / "ddc_fm.cu").write_text(text)
        jobs.append((label, d / "libk1.so", subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
             str(d / "libk1.so"), str(d / "ddc_fm.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    fns = {}
    for label, lib, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"K1 variant {label!r} did not build:\n{log[-4000:]}")
        fn = ctypes.CDLL(str(lib)).ddc_fm_launch
        fn.argtypes = list(cuda_ddc._DDC_FM_ARGS)
        fn.restype = ctypes.c_int
        fns[label] = fn
    return fns


def k1_sweep(dev, smi, x2, tail) -> None:
    """K1's frame widths and warpgroups, then its epilogue variants, at
    config 4 on the block x2 (2, 2^24) and tail (2, 60)."""
    from solid_dsp_tpu_torch.models.rx_chain import RxChainConfig
    from solid_dsp_tpu_torch.ops import cuda_build, cuda_ddc
    from solid_dsp_tpu_torch.ops.nco import constrain

    n, M, L = 64, 4, x2.shape[-1]
    body = cuda_ddc.make_ddc_fm(RxChainConfig(fir_taps=n).design_taps(),
                                constrain(0.2), M, 0.1, dev)
    ap = cuda_ddc.ddc_fm_torch(body, x2, tail)[0].cpu().numpy()
    for P in (8, 16, 32):
        for wgs in (2, 1):
            try:
                geo = cuda_ddc.fm_tc_geometry(n, M, P, wgs)
            except ValueError:
                print(f"[K1 n=64 M=4 L=2^24, P={P}, {wgs} warpgroup(s) a "
                      f"block] does not fit one block's shared memory",
                      flush=True)
                continue
            audio = cuda_ddc._launch_fm(body, x2, tail, "tc", geo)[0]
            ms = graph_ms(lambda: cuda_ddc._launch_fm(body, x2, tail, "tc",
                                                      geo), 20)
            print(f"[K1 n=64 M=4 L=2^24, P={P}, {wgs} warpgroup(s) a block] "
                  f"{ms:.4f} ms (CUDA graph of 20 launches), "
                  f"{snr_db(audio.cpu().numpy(), ap):.1f} dB vs plain | "
                  f"{smi}", flush=True)

    fns = k1_variant_launchers()
    P, hpad, KP, pre, wgs, stages, smem = cuda_ddc.fm_tc_geometry(n, M)
    bank = cuda_ddc._tc_bank(body, P, hpad, KP, fm=True)
    ticket = cuda_ddc._fm_ticket(body, dev)
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    audio = torch.empty(L // M, device=dev)
    scratch = torch.empty(5 + blocks, device=dev)

    def runner(fn):
        def run():
            cuda_build.check_launch(fn(
                x2.data_ptr(), tail.data_ptr(), bank.data_ptr(),
                body.taps.data_ptr(), audio.data_ptr(), scratch.data_ptr(),
                scratch.data_ptr() + 20, ticket.data_ptr(), L, n, M, P, hpad,
                KP, pre, wgs, stages, smem, blocks, body.cd, body.sd,
                body.scale, 0, 0, dev.index,
                torch.cuda.current_stream().cuda_stream), "ddc_fm variant")
        return run

    runs = {label: runner(fn) for label, fn in fns.items()}
    times = {label: [] for label in runs}
    for order in (list(runs), list(runs)[::-1]):      # turns: A B C D D C B A
        for label in order:
            times[label].append(graph_ms(runs[label], 20))
    for label, run in runs.items():
        run()
        torch.cuda.synchronize()
        print(f"[K1 epilogue variant: {label}] {times[label][0]:.4f} / "
              f"{times[label][1]:.4f} ms (CUDA graph of 20 launches), "
              f"{snr_db(audio.cpu().numpy(), ap):.1f} dB vs plain | {smi}",
              flush=True)


if __name__ == "__main__":
    main()
