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

Prints one line a case with the card's name and power limit.  Needs one
CUDA GPU; imports neither jax nor solid_dsp_tpu.
"""

from __future__ import annotations

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


if __name__ == "__main__":
    main()
