"""Design sweeps of two of the port's kernels on one NVIDIA GPU.

    python3 torch_kernel_sweep.py

* K6 (csrc/iir_bank.cu) at T = 2^14, C = 256, S = 2 (ChannelBank's block):
  the chunk length Lc in {16, 32, 64, 128}, each timed over a CUDA graph of
  20 calls, with the profiler's time of each of its three kernels and the
  largest error against the plain version (shared and narrow cascades).
* The DDC body (csrc/ddc_body.cu) at n = 64, M = 4, L = 2^24 (config 4):
  the frame width P in {8, 16} (32 and more do not fit one block's shared
  memory), one or two warpgroups a block, each timed over a CUDA graph of
  20 launches, with its SNR against the plain version.
* K1, the fused DDC + FM kernel (csrc/ddc_fm.cu, tensor-core route) at
  n = 64, M = 4, L = 2^24: the frame width P in {8, 16, 32} (32 does not
  fit) and one or two warpgroups a block, the same way; then variants of
  its epilogue built from the source by text substitution and timed in
  turns: the kernel as it is, a polynomial atan2 (Cephes' atanf, one
  reciprocal) in place of atan2f, and two that give wrong audio to show
  what a part costs: the seams' dots left out, the discriminator left out.

Prints one line a case with the card's name and power limit.  Needs one
CUDA GPU; imports neither jax nor solid_dsp_tpu.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys

import numpy as np
import torch

from chip_smoke import graph_ms, snr_db


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
    body = cuda_ddc.make_ddc_body(RxChainConfig(fir_taps=n).design_taps(),
                                  constrain(0.2), M, dev)
    rng = np.random.default_rng(3)
    xs = 0.5 * np.exp(1j * 0.21 * np.arange(L)) + 0.1 * (
        rng.standard_normal(L) + 1j * rng.standard_normal(L))
    x2 = torch.from_numpy(np.stack([xs.real, xs.imag]).astype(np.float32)).to(dev)
    tail = torch.from_numpy((0.3 * rng.standard_normal((2, n - M))).astype(
        np.float32)).to(dev)
    zp = cuda_ddc.ddc_body_torch(body, x2, tail).cpu().numpy()
    fn = cuda_build.launcher("ddc_body.cu", "ddc_body_launch",
                             cuda_ddc._DDC_BODY_ARGS)
    hpad = -(-(n - M) // 4) * 4
    for P in (8, 16):
        KP = -(-(hpad + P * M) // 32) * 32
        SP = -(-(63 * P * M + KP + 4) // 4) * 4
        bank_bytes = 2 * (KP // 4) * 32 * 2 * P
        bank = torch.from_numpy(cuda_ddc.body_tc_bank(body.h_bp, n, M, P, hpad,
                                                      KP)).to(dev)
        z = torch.empty((2, L // M), device=dev)
        for wgs in (2, 1):
            smem = bank_bytes + wgs * 2 * 2 * SP * 4 + (1 + 2 * wgs) * 8

            def run():
                cuda_build.check_launch(fn(
                    x2.data_ptr(), tail.data_ptr(), bank.data_ptr(),
                    z.data_ptr(), L, n, M, P, hpad, KP, wgs, 2, smem, 0,
                    torch.cuda.current_stream().cuda_stream), "ddc_body")
            run()
            torch.cuda.synchronize()
            print(f"[body n=64 M=4 L=2^24, P={P}, {wgs} warpgroup(s) a block] "
                  f"{graph_ms(run, 20):.4f} ms (CUDA graph of 20 launches), "
                  f"{snr_db(z.cpu().numpy(), zp):.1f} dB vs plain | {smi}",
                  flush=True)

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
                body.scale, dev.index, torch.cuda.current_stream().cuda_stream),
                "ddc_fm variant")
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
