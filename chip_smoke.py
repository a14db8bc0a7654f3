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
* parallel/, config 5's channels sharded over time and config 4 at scale,
  on an NCCL group of one rank (one card): the fused halo-exchange front
  end make_fused_channelizer_frontend through its kernel (K9,
  halo_frontend.cu), K9 as four shards on one card exchanging halos
  through each other's regions, make_sharded_channelizer ("xla", "fused"
  through K4) and make_sharded_rx_chain (planar FM through K1).

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
     FM at config 4 (2^24 samples) against make_rx_chain; bit-equal, or
     >= 115 dB where a reduction is reordered;
 25. K9's time over a CUDA graph of 20 launches beside K5's, its plain
     version, the grouped conv1d and its bound; the four-shard form's ms a
     block; the sharded entry points' Msamples/s against the unsharded
     ones (turns unsharded, sharded, sharded, unsharded);
 26. with the caller's torch.set_float32_matmul_precision("high") and
     cuDNN's TF32 at PyTorch's default: the x3 gates of configs 4 and 5
     (kernels against plain versions, plain versions against float64)
     and conv1d_mxu >= 100 dB against float64, the caller's flags the same
     afterwards.  The script leaves every TF32 flag at PyTorch's default:
     the port pins full float32 for its own products.

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
# H100 SXM peaks (NVIDIA's data sheet)
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
    make_sharded_channelizer ("xla", "fused" x3) at config 5 and
    make_sharded_rx_chain planar FM at config 4, 3 blocks each with the
    state carried, launches counted.  Returns their throughput turns."""
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
        "ddc_fm", "ddc_fm.cu", "solid_dsp_tpu/ops/pallas_ddc.py:590",
        launches_main["ddc_fm"], max_abs, k_ms, p_ms, b3)]
    for route, line in (("ddc_body", 359), ("ddc_body_unaligned", 135)):
        err, kms, pms, lms, L, bnd = body_stats[route]
        kernels.append(kernel_entry(
            route, "ddc_body.cu", f"solid_dsp_tpu/ops/pallas_ddc.py:{line}",
            launches_main[route], err, kms, pms, bnd, lms))
    kernels += config5(dev, smi)
    kernels += config2(dev, smi)
    kernels += farrow_phases(dev, smi)
    kernels += parallel_phases(dev, smi)
    precision_phase(dev, smi)
    if not all(k["launches"] > 0 for k in kernels):
        fail("a kernel of the main paths was never launched")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
