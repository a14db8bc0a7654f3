"""Design sweeps of the port's kernels and routes on one NVIDIA GPU.

    python3 torch_kernel_sweep.py            # K6, the DDC body, K1
    python3 torch_kernel_sweep.py fir-route  # the FIR's two card routes
    python3 torch_kernel_sweep.py s3         # S3's chunk length and join
    python3 torch_kernel_sweep.py latency    # S1, S2, S4-S9: latency bounds
    python3 torch_kernel_sweep.py cfar-route # F7: CA-CFAR's two window sums
    python3 torch_kernel_sweep.py k1-direct  # K1's direct route: R, warps
    python3 torch_kernel_sweep.py k1-route   # K1 as routed, both modes
    python3 torch_kernel_sweep.py fsm        # S1's FSM entry: chunk, block
    python3 torch_kernel_sweep.py track-prefetch  # S4/S5: the L2 prefetch

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
  (``solid_dsp_tpu_torch/_build/seq_scan.sass``).  The same for S4 and S5
  (csrc/track_scan.cu, float32, one lane of 2^16): S4's forward entry at
  n = 2, m = 1 (its chain holds a division: FDIV in the probe), its
  backward and LTI entries at n = 2, S5 at orders 16 and 64
  (``track_scan.sass``); S6 (csrc/bcjr_scan.cu) at 128 rows of 1027
  steps, its chain a step a walk and its two walks' SASS loops
  (``bcjr_scan.sass``); S7 (csrc/viterbi_scan.cu, soft, K = 7: its
  single-warp form) at one row of 8166 steps, 1024 x 550 and 64 x 8166,
  its chain a step (the probe adds REDUX, and a shared-memory exchange
  across a two-warp barrier, the block form's) and its ACS loop's SASS
  (``viterbi_scan.sass``); S8 (csrc/cvsd_scan.cu), encode and decode, at
  one lane and 1024 lanes of 2^16, and S9 (csrc/gardner_scan.cu) on 2^19
  symbols at sps 8 (the probe adds floor-to-integer and a dependent shared
  read), each its chain and its walk's SASS (``cvsd_scan.sass``,
  ``gardner_scan.sass``).  S1's FSM entry is
  time-parallel (the chunk-and-join kernel): its row prints its bytes
  bound (4 in and 4 out a step over 3.35 TB/s) beside its time instead.

* ``s7-variants``: S7's single-warp form at 64 states (soft, K = 7) as
  built and with one part of its step taken away at a time (the warp
  minimum, its key conversions, the ballots, the shuffles that put the
  metrics back in place, the per-step reads of the values): text
  substitutions of csrc/viterbi_scan.cu built beside the kernels, each
  timed at one row of 8166 steps and at 1024 x 550 (wrong results; only
  the times are read).

* ``cfar-route``: ``models/radar.py::cfar_ca``'s window sums at the
  sweep's 2^22 cells (F7): the box sum by conv1d (as built) against a
  float64 running sum cast back, timed in turns, each with its
  thresholds' error relative to float64.

* ``track-prefetch``: S4's entries and S5 (csrc/track_scan.cu) as built
  (the L2 prefetch of the chunk after next in the LTI walk only) against
  two variants built beside them by text substitution, the prefetch in
  every walk and in none, in turns (as built, every, none, none, every,
  as built), at the main paths' shapes: the LTI walk over 2^22, the forward walk over 2^20 (with and
  without the kept covariances), the backward walk over 2^20, S5 over 256
  lanes of 2^14 at order 16 and one lane of 2^20 at order 64.

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

from chip_smoke import cuda_ms, graph_ms, snr_db, timed


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
#   S4 forward (kf_forward_kernel, n = 2, m = 1): P -> A P (FMUL + FFMA)
#     -> Pp = (A P) A' + Q (FMUL + FFMA + FADD) -> Pp C' (FMUL + FFMA) -> S
#     (FMUL + FFMA + FADD) -> K = (Pp C') / S (FDIV) -> I - K C (FMUL +
#     FADD) -> P = (I - K C) Pp (FMUL + FFMA); x's chain is shorter;
#   S4 backward (rts_backward_kernel, n = 2): the gain G comes from the
#     step's inputs only, so the chain is Ps -> Ps - Pp (FADD) -> G (Ps -
#     Pp) (FMUL + FFMA) -> Pf + (..) G' (FMUL + FFMA + FADD);
#   S4 LTI (kf_lti_kernel, n = 2): x -> F x (FMUL + FFMA) -> + b (FADD);
#   S6 (bcjr_scan.cu, either walk): the neighbouring state's metric by a
#     shuffle (SHFL), + gamma (FADD), the max of the two branches (FMNMX);
#     the renormalisation once a chunk of 16 steps (three SHFL + FMNMX and
#     an FADD) adds 0.19 SHFL, 0.19 FMNMX and 0.06 FADD a step;
#   S7 (viterbi_scan.cu's single-warp form, 64 states): the new metrics'
#     minimum (FMNMX of a lane's two), its key (compare and select), the
#     warp's minimum (REDUX), the key back to a float (compare and
#     select), pmn - min and + bm (two FADDs), the choice (compare and
#     select); the four shuffles that put the metrics back in place run
#     beside the key and REDUX, a shorter path;
#   S8 (csrc/cvsd_scan.cu, its SASS), encode: ref -> FSETP (the bit) ->
#     SEL, two LOP3 (the history word) -> ISETP (agreement) -> FSEL of
#     gamma -> FADD (step; beta step's FMUL is off the chain) -> two FMNMX
#     -> FSEL (+-step) -> FADD (ref) -> two FMNMX: 13 ops, the 7 integer
#     and select ops counted at a simple ALU op's latency (FADD's; the probe
#     has no integer chain); decode: the bits come from registers, so the
#     history and agreement are off the chain, and each recurrence (step:
#     FMUL, FADD, two FMNMX; ref: FMUL, FADD, two FMNMX after the select)
#     carries 4 ops a step;
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
    "S4 forward": {"FMUL": 6, "FFMA": 5, "FADD": 3, "FDIV": 1},
    "S4 backward": {"FMUL": 2, "FFMA": 2, "FADD": 2},
    "S4 LTI": {"FMUL": 1, "FFMA": 1, "FADD": 1},
    "S5 p=16": {"FFMA": 3},
    "S5 p=64": {"FFMA": 3},
    "S6": {"SHFL": 1 + 3 / 16, "FADD": 1 + 1 / 16, "FMNMX": 1 + 3 / 16},
    "S7": {"FMNMX": 1, "compare+select": 3, "REDUX": 1, "FADD": 2},
    "S8 encode": {"FADD": 9, "FMNMX": 4},
    "S8 decode": {"FMUL": 1, "FADD": 1, "FMNMX": 2},
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
    bcjr_latency(dev, smi, lat, mhz)
    viterbi_latency(dev, smi, lat, mhz)
    cvsd_gardner_latency(dev, smi, lat, mhz)


def bcjr_latency(dev, smi, lat: dict, mhz: float) -> None:
    """S6 (csrc/bcjr_scan.cu) at turbo_decode_1024_6it's shape, 128 rows
    of 1024 + 3 steps: the chain a step (LATENCY_CHAINS["S6"], the same
    in both walks) and the SASS instructions a step of the forward and the
    backward main loop (a chunk of 16 steps unrolled; 32 and 48 loads),
    the larger of the two walks' sums over the SM clock, beside the time
    a step (CUDA graph of 5 launches, two walks of 1027 steps)."""
    from solid_dsp_tpu_torch.models import turbo
    from solid_dsp_tpu_torch.ops import cuda_bcjr, cuda_build

    sass = sass_dump("bcjr_scan.cu")
    out = cuda_build.BUILD_DIR / "bcjr_scan.sass"
    out.write_text(sass)
    B, T = 128, 1024
    Tm = T + 3
    rng = np.random.default_rng(40)
    ls = torch.from_numpy(4 * rng.standard_normal((B, Tm))).to(dev,
                                                               torch.float32)
    lp = torch.from_numpy(4 * rng.standard_normal((B, Tm))).to(dev,
                                                               torch.float32)
    tabs = turbo._rsc_tables(turbo.DEFAULT_FB, turbo.DEFAULT_FF, 3)[:4]
    chain = LATENCY_CHAINS["S6"]
    cycles = sum(n * (lat[op] - (lat[_CARRIED[op]] if op in _CARRIED
                                 else 0.0)) for op, n in chain.items())
    issue = [sass_step_instructions(sass, "bcjr_kernel", loads, steps=16)
             for loads in (32, 48)]
    bound_ns = max(2 * cycles, sum(issue)) / mhz * 1e3
    ms = graph_ms(lambda: cuda_bcjr.bcjr_maxlog_cuda(ls, lp, T, *tabs), 5)
    ns_step = ms * 1e6 / Tm
    print(f"[latency bound S6] SASS kept in {out}; chain {chain}: "
          f"{cycles:.1f} cycles a step a walk; SASS main loops forward "
          f"{issue[0]:.1f}, backward {issue[1]:.1f} instructions a step; "
          f"bound {bound_ns:.1f} ns a step of both walks at {mhz:.0f} MHz "
          f"(the larger); measured {ns_step:.1f} ns ({ms:.4f} ms a call of "
          f"{B} x {Tm}): {bound_ns / ns_step:.0%} of the bound | {smi}",
          flush=True)


def viterbi_latency(dev, smi, lat: dict, mhz: float) -> None:
    """S7 (csrc/viterbi_scan.cu), soft, K = 7 (its single-warp form): the
    chain a step (LATENCY_CHAINS["S7"]) and the SASS instructions a step
    of the ACS loop (the innermost loop holding the warp minimum's REDUX,
    its instructions over its REDUXes, a step each), the larger over the
    SM clock, beside the time a step at one row of 8166 steps (the latency
    alone), at the packet shape (1024 x 550) and the CCSDS frame's (64 x
    8166), CUDA graph of 5 launches."""
    from solid_dsp_tpu_torch.models import fec
    from solid_dsp_tpu_torch.ops import cuda_build, cuda_viterbi

    sass = sass_dump("viterbi_scan.cu")
    out = cuda_build.BUILD_DIR / "viterbi_scan.sass"
    out.write_text(sass)
    loops = []
    for part in sass.split("Function : ")[1:]:
        if "viterbi_warp_kernelILi2ELb1ELb1E" not in part.splitlines()[0]:
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
    n_ins, steps = min(loops)
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


def cvsd_gardner_latency(dev, smi, lat: dict, mhz: float) -> None:
    """S8 (csrc/cvsd_scan.cu) and S9 (csrc/gardner_scan.cu): each chain a
    step (LATENCY_CHAINS); S8's bound the larger of it and its chunk
    loop's SASS instructions over its 32 steps, S9's the chain (its
    walker's loop also holds the untaken fall-back), over the SM clock,
    beside the time a step: S8 at
    one lane of 2^16 and 1024 lanes x 2^16 (chip_smoke.py phase 42's), S9
    on one stream of 2^19 symbols at sps 8 (CUDA graph of 3 launches).
    The SASS is kept beside the built libraries."""
    from solid_dsp_tpu_torch.ops import cuda_build, cuda_cvsd, cuda_timing

    args = (0.9, 0.01, 0.001, 0.2, 3, 0.98)
    sass = sass_dump("cvsd_scan.cu")
    out = cuda_build.BUILD_DIR / "cvsd_scan.sass"
    out.write_text(sass)
    rng = np.random.default_rng(42)
    for name, decode, template in (("S8 encode", False, "ILb1E"),
                                   ("S8 decode", True, "ILb0E")):
        # the chunk loop: its 32 steps unrolled (32 shared reads or more)
        n_ins, k_lds = min((n, k) for n, k in _loop_sizes(
            sass, "cvsd_kernel" + template, "LDS") if k >= 32)
        issue = n_ins / 32.0
        cycles = _chain_cycles(lat, LATENCY_CHAINS[name])
        bound_ns = max(cycles, issue) / mhz * 1e3
        for B, N in ((1, 1 << 16), (1024, 1 << 16)):
            x = torch.from_numpy(rng.uniform(-1, 1, (B, N)).astype(
                np.float32)).to(dev)
            v = cuda_cvsd.cvsd_cuda(x, False, *args) if decode else x
            ms = graph_ms(lambda: cuda_cvsd.cvsd_cuda(v, decode, *args), 3)
            ns = ms * 1e6 / N
            print(f"[latency bound {name}, {B} x {N}] SASS kept in {out}; "
                  f"chain {LATENCY_CHAINS[name]}: {cycles:.1f} cycles a "
                  f"step; its chunk loop {issue:.1f} instructions a step "
                  f"({n_ins} over 32 steps, {k_lds} shared reads); bound "
                  f"{bound_ns:.1f} ns a step at {mhz:.0f} MHz (the larger); "
                  f"measured {ns:.1f} ns a step ({ms:.4f} ms a call): "
                  f"{bound_ns / ns:.0%} of the bound | {smi}", flush=True)
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


# S7's single-warp form (csrc/viterbi_scan.cu, 64 states) with one part of
# its step taken away at a time (each variant is wrong; only its time is
# read): what each part costs a step.
S7_VARIANTS = {
    "as built": [],
    "no warp minimum (the lane's own)": [
        ("g = from_key(__reduce_min_sync(FULL, order_key(vmin)));",
         "g = vmin;")],
    "no key conversions": [
        ("g = from_key(__reduce_min_sync(FULL, order_key(vmin)));",
         "g = __int_as_float(__reduce_min_sync(FULL, "
         "__float_as_int(vmin)));")],
    "no ballots": [
        ("const unsigned wa = __ballot_sync(FULL, cha);",
         "const unsigned wa = cha;"),
        ("const unsigned wb = __ballot_sync(FULL, chb);",
         "const unsigned wb = chb;")],
    "no shuffles back in place": [
        ("__shfl_sync(FULL, va, src)", "va"),
        ("__shfl_sync(FULL, vb, src)", "vb"),
        ("__shfl_sync(FULL, va, src + 16)", "va"),
        ("__shfl_sync(FULL, vb, src + 16)", "vb")],
    "no shared-memory reads of the values": [
        ("for (int k = 0; k < NK; ++k) rn[k] = rc[inext + k];",
         "for (int k = 0; k < NK; ++k) rn[k] = rv[k];")],
}


def s7_variants(dev, smi) -> None:
    """S7's single-warp form at 64 states (soft, K = 7) as built and with
    one part of its step taken away (S7_VARIANTS: text substitutions of
    viterbi_scan.cu, built beside the kernels), each timed over a CUDA
    graph of 5 launches at one row of 8166 steps and at 1024 x 550."""
    from solid_dsp_tpu_torch.models import fec
    from solid_dsp_tpu_torch.ops import cuda_build, cuda_viterbi

    out = cuda_build.BUILD_DIR / "s7_variants"
    shutil.rmtree(out, ignore_errors=True)
    source = (cuda_build.CSRC / "viterbi_scan.cu").read_text()
    jobs = []
    for i, (label, subs) in enumerate(S7_VARIANTS.items()):
        d = out / f"v{i}"
        d.mkdir(parents=True)
        text = source
        for a, b in subs:
            if a not in text:
                sys.exit(f"S7 variant {label!r}: {a!r} is not in the source")
            text = text.replace(a, b)
        (d / "viterbi_scan.cu").write_text(text)
        jobs.append((label, d / "libs7.so", subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
             str(d / "libs7.so"), str(d / "viterbi_scan.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    out_tab = fec._tables(fec.DEFAULT_POLYS, 7)[0]
    masks = torch.from_numpy(cuda_viterbi._masks(
        np.asarray(out_tab, np.int64).tobytes(), 64, 2).view(np.int32)).to(
        dev)
    rng = np.random.default_rng(17)
    for label, lib, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"S7 variant {label!r} did not build:\n{log[-4000:]}")
        fn = ctypes.CDLL(str(lib)).viterbi_acs
        fn.argtypes = list(cuda_viterbi._ARGS)
        fn.restype = ctypes.c_int
        times = []
        for B, T in ((1, 8166), (1024, 550)):
            r = torch.from_numpy(rng.standard_normal((B, T, 2))).to(
                dev, torch.float32)
            bits = torch.empty((B, T), dtype=torch.int32, device=dev)
            pm = torch.empty((B, 64), dtype=torch.float32, device=dev)
            dec = torch.empty((B, T, 2), dtype=torch.int32, device=dev)

            def run():
                cuda_build.check_launch(fn(
                    r.data_ptr(), 1, masks.data_ptr(), bits.data_ptr(),
                    pm.data_ptr(), dec.data_ptr(), B, T, 2, 64, dev.index,
                    torch.cuda.current_stream(dev).cuda_stream), label)
            ms = graph_ms(run, 5)
            times.append(f"{B} x {T}: {ms * 1e6 / T:.1f} ns a step")
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
    """S4's three entries and S5 (csrc/track_scan.cu, float32, one lane of
    T = 2^16): each loop-carried chain (LATENCY_CHAINS) over the probe's
    latencies and the main loop's SASS instructions a step, the larger
    over the SM clock beside the time a step (CUDA graph of 5 launches)."""
    import importlib

    from solid_dsp_tpu_torch.ops import cuda_build, cuda_track, kalman

    lpc = importlib.import_module("solid_dsp_tpu_torch.analysis.lpc")
    sass = sass_dump("track_scan.cu")
    out = cuda_build.BUILD_DIR / "track_scan.sass"
    out.write_text(sass)
    print(f"[latency] track_scan.cu SASS: {len(sass.splitlines())} lines, "
          f"kept in {out}", flush=True)
    T = 1 << 16
    rng = np.random.default_rng(39)
    A, C, Q, R = (torch.from_numpy(a).to(dev, torch.float32)
                  for a in kalman.cv_model(1.0, 0.05, 1.0))
    z = torch.from_numpy(rng.standard_normal((T, 1))).to(dev, torch.float32)
    x0 = torch.zeros(2, device=dev)
    P0 = 10.0 * torch.eye(2, device=dev)
    kept = cuda_track.kalman_filter_cuda(x0, P0, z, A, C, Q, R, keep=True)
    Bz = torch.cat([z, 0.1 * z], dim=1)
    F = 0.9 * torch.eye(2, device=dev)
    y = z[:, 0].contiguous()
    k16 = torch.from_numpy(0.5 * rng.uniform(-1, 1, 16)).to(dev,
                                                            torch.float32)
    k64 = torch.from_numpy(0.5 * rng.uniform(-1, 1, 64)
                           / np.sqrt(np.arange(1, 65))).to(dev, torch.float32)
    runs = {
        "S4 forward": (lambda: cuda_track.kalman_filter_cuda(
            x0, P0, z, A, C, Q, R), "kf_forward_kernelIfLi2ELi1EE", 8),
        "S4 backward": (lambda: cuda_track.rts_backward_cuda(
            kept[0], *kept[3:], A), "rts_backward_kernelIfLi2EE", 4),
        "S4 LTI": (lambda: cuda_track.kalman_lti_cuda(x0, Bz, F),
                   "kf_lti_kernelIfLi2EE", 16),
        "S5 p=16": (lambda: lpc.lattice_iir(y, k16),
                    "lattice_iir_kernelIfLi16EE", 8),
        "S5 p=64": (lambda: lpc.lattice_iir(y, k64),
                    "lattice_iir_kernelIfLi64EE", 8),
    }
    for name, (fn, kernel, steps) in runs.items():
        chain = LATENCY_CHAINS[name]
        cycles = sum(n * lat[op] for op, n in chain.items())
        # each kernel's main loop: a chunk of `steps` steps, unrolled
        # (track_scan.cu's kf_chunk, rts_chunk, lti_chunk, LATTICE_CHUNK)
        issue = sass_step_instructions(sass, kernel, None, steps=steps)
        bound_ns = max(cycles, issue) / mhz * 1e3
        ns = graph_ms(fn, 5) * 1e6 / T
        print(f"[latency bound {name}] chain {chain}: {cycles:.1f} cycles a "
              f"step; its SASS main loop {issue:.1f} instructions a step; "
              f"bound {bound_ns:.1f} ns at {mhz:.0f} MHz (the larger); "
              f"measured {ns:.1f} ns a step (T = 2^16): {bound_ns / ns:.0%} "
              f"of the bound | {smi}", flush=True)


# track_scan.cu's walks as built pass no-op prefetch callbacks but the LTI
# walk's; one variant asks every walk's chunk after next into L2, the other
# none
TRACK_PREFETCH_NONE = (
    ("""  }, [&](long long t) { prefetch_l2(in + t * NP); });""",
     """  }, [](long long) {});"""),
)
TRACK_PREFETCH_EDITS = (
    ("""    store_rows(a.Pp + row * NP * NP, Pp);
    }
  }, [](long long) {});""", """    store_rows(a.Pp + row * NP * NP, Pp);
    }
  }, [&](long long t) { prefetch_l2(Z + t * MP); });"""),
    ("""    store_rows(a.Ps + t * NN, Ps);
  }, [](long long) {});""", """    store_rows(a.Ps + t * NN, Ps);
  }, [&](long long i) {
    const long long t = base + T - 2 - i;
    prefetch_l2(a.Xf + t * NP);
    prefetch_l2(a.Pf + t * NN);
    prefetch_l2(a.Xp + (t + 1) * NP);
    prefetch_l2(a.Pp + (t + 1) * NN);
  });"""),
    ("""  const auto ahead = [](long long) {};""",
     """  const auto ahead = [&](long long t) { prefetch_l2(yl + t); };"""),
)


def track_prefetch(dev, smi) -> None:
    """S4 and S5 as built against the variant with the L2 prefetch in every
    walk, in turns, at the main paths' shapes (CUDA events, 3 calls after
    2 warm-up calls each)."""
    import importlib

    from solid_dsp_tpu_torch.ops import cuda_build, cuda_track, kalman

    lpc = importlib.import_module("solid_dsp_tpu_torch.analysis.lpc")
    libs = cuda_build.build()
    d = cuda_build.BUILD_DIR / "track_prefetch"
    d.mkdir(parents=True, exist_ok=True)
    variants = {"as built": libs["track_scan.cu"]}
    for label, edits in (("every walk", TRACK_PREFETCH_EDITS),
                         ("no walk", TRACK_PREFETCH_NONE)):
        src = (cuda_build.CSRC / "track_scan.cu").read_text()
        for old, new in edits:
            if old not in src:
                raise ValueError("track_scan.cu changed: update "
                                 "TRACK_PREFETCH_EDITS / _NONE")
            src = src.replace(old, new)
        stem = label.replace(" ", "_")
        (d / f"{stem}.cu").write_text(src)
        subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                        str(d / f"lib{stem}.so"), str(d / f"{stem}.cu")],
                       check=True, capture_output=True)
        variants[label] = ctypes.CDLL(str(d / f"lib{stem}.so"))
    rng = np.random.default_rng(0)
    model = kalman.cv_model(1.0, 0.05, 1.0)
    A, C, Q, R = (torch.from_numpy(a).to(dev, torch.float32) for a in model)
    K, F = kalman.steady_state_gain(*model)
    z22 = torch.from_numpy(rng.standard_normal(1 << 22)).to(dev,
                                                            torch.float32)
    B22 = z22[:, None] @ torch.from_numpy(K.T).to(dev, torch.float32)
    Ft = torch.from_numpy(F).to(dev, torch.float32)
    z20 = z22[:1 << 20, None].contiguous()
    x0 = torch.zeros(2, device=dev)
    P0 = 10 * torch.eye(2, device=dev)
    kept = cuda_track.kalman_filter_cuda(x0, P0, z20, A, C, Q, R, keep=True)
    yl = torch.from_numpy(rng.standard_normal((256, 1 << 14))).to(
        dev, torch.float32)
    kl = torch.from_numpy(0.5 * rng.uniform(-1, 1, (256, 16))).to(
        dev, torch.float32)
    y1 = z22[:1 << 20].contiguous()
    k64 = torch.from_numpy(0.5 * rng.uniform(-1, 1, 64)
                           / np.sqrt(np.arange(1, 65))).to(dev, torch.float32)
    runs = {
        "LTI 2^22": lambda: cuda_track.kalman_lti_cuda(x0, B22, Ft),
        "forward 2^20": lambda: cuda_track.kalman_filter_cuda(
            x0, P0, z20, A, C, Q, R),
        "forward keep 2^20": lambda: cuda_track.kalman_filter_cuda(
            x0, P0, z20, A, C, Q, R, keep=True),
        "backward 2^20": lambda: cuda_track.rts_backward_cuda(
            kept[0], *kept[3:], A),
        "S5 256 x 2^14 p=16": lambda: lpc.lattice_iir(yl, kl),
        "S5 2^20 p=64": lambda: lpc.lattice_iir(y1, k64),
    }
    res = {name: {v: [] for v in variants} for name in runs}
    for turn in ("as built", "every walk", "no walk", "no walk",
                 "every walk", "as built"):
        cuda_build.launcher.cache_clear()
        libs["track_scan.cu"] = variants[turn]
        for name, fn in runs.items():
            res[name][turn].append(cuda_ms(fn, 3))
    cuda_build.launcher.cache_clear()
    libs["track_scan.cu"] = variants["as built"]
    for name, r in res.items():
        print(f"[track-prefetch] {name}: as built "
              + " / ".join(f"{v:.3f}" for v in r["as built"])
              + " ms, prefetch in every walk "
              + " / ".join(f"{v:.3f}" for v in r["every walk"])
              + " ms, in none "
              + " / ".join(f"{v:.3f}" for v in r["no walk"])
              + f" ms | {smi}", flush=True)


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
    if sys.argv[1:] == ["track-prefetch"]:
        track_prefetch(dev, smi)
        return
    if sys.argv[1:] == ["s7-variants"]:
        s7_variants(dev, smi)
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
