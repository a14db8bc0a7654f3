"""Design sweeps of the port's kernels and routes on one NVIDIA GPU.

    python3 torch_kernel_sweep.py            # K6, the DDC body, K1
    python3 torch_kernel_sweep.py fir-route  # the FIR's two card routes
    python3 torch_kernel_sweep.py s3         # S3's chunk length and join
    python3 torch_kernel_sweep.py latency    # S1 and S2's latency bounds
    python3 torch_kernel_sweep.py k1-direct  # K1's direct route: R, warps
    python3 torch_kernel_sweep.py k1-route   # K1 as routed, both modes
    python3 torch_kernel_sweep.py fsm        # S1's FSM entry: chunk, block

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
  (``solid_dsp_tpu_torch/_build/seq_scan.sass``).  S1's FSM entry is
  time-parallel (the chunk-and-join kernel): its row prints its bytes
  bound (4 in and 4 out a step over 3.35 TB/s) beside its time instead.

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

from chip_smoke import graph_ms, snr_db, timed


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
# one every 16 operations, run beside the chain).
LATENCY_PROBE = r"""
#include <cuda_runtime.h>
#define CHAIN(BODY)                                         \
  _Pragma("unroll 1") for (int i = 0; i < 32; ++i) {        \
    _Pragma("unroll") for (int j = 0; j < 16; ++j) { BODY } \
  }
__global__ void probe(int op, float a, double da, float* out, double* dout,
                      long long* cyc) {
  float v = a, s = 0.f, c = 0.f;
  double d = da;
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
  }
  const long long t1 = clock64();
  out[0] = v;
  dout[0] = d;
  cyc[0] = t1 - t0;
}
extern "C" int probe_launch(int op, float a, double da, float* out,
                            double* dout, long long* cyc) {
  probe<<<1, 1>>>(op, a, da, out, dout, cyc);
  return (int)cudaGetLastError();
}
"""
LATENCY_OPS = ("FFMA", "FMUL", "FADD", "MUFU.EX2", "MUFU.LG2", "MUFU.SIN",
               "expf", "logf", "log10f", "atan2f", "sincosf", "DFMA",
               "compare+select")


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
LATENCY_CHAINS = {
    "S1": {"FMUL": 4 + 2, "FFMA": 1, "FADD": 1, "logf": 1, "expf": 1},
    "S2": {"sincosf": 1, "FMUL": 3, "FADD": 5, "compare+select": 1,
           "atan2f": 1},
}
_CARRIED = {"logf": "FADD", "log10f": "FADD", "atan2f": "FADD",
            "sincosf": "FADD", "expf": "FMUL"}


_SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                        r"([A-Z][A-Z0-9_.]*)\s*(.*?);")


def sass_step_instructions(sass: str, kernel: str, loads: int,
                           mufu: int | None = None) -> float:
    """Instructions a step of ``kernel``'s main loop in a cuobjdump -sass
    listing: among the loops (a backward branch's range) of the function
    whose name holds ``kernel`` that issue ``loads`` global loads (and,
    given ``mufu``, that many MUFU operations), the largest, or with
    ``mufu`` the one with the fewest branches; over the walk's 8 steps
    (CHUNK, unrolled).  One warp issues at most one instruction a cycle,
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
                if (sum(o.startswith("LDG") for o in body) == loads and (
                        mufu is None
                        or sum(o.startswith("MUFU") for o in body) == mufu)):
                    loops.append((body.count("BRA"), len(body)))
    if not loops:
        raise ValueError(f"no main loop of {kernel} in the SASS")
    n = (min(loops)[1] if mufu is not None else max(b for _, b in loops))
    return n / 8.0


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
    print(f"[latency, cycles an operation, one thread] "
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
    for name, chain in LATENCY_CHAINS.items():
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
