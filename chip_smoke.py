"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, the config-4 receive chain of bench.py
(solid_dsp_tpu_torch.models.rx_chain: 16M-sample planar f32 blocks, 64-tap
NCO-folded bandpass FIR decimating by 4, block AGC, collapsed FM
discriminator), through the fused DDC+FM kernel built from
solid_dsp_tpu_torch/csrc/.  Phases, one line each:

  1. device: GPU name and power limit, torch and CUDA versions;
  2. build: the extension from the repository's sources, in seconds;
  3. kernel vs its plain PyTorch version on the card, L = 2^24 (f32);
  4. kernel vs the plain version in float64 on the CPU, L = 2^20;
  5. chain (kernel) vs chain (plain version) over 4 blocks with the state
     carried, launches counted; the audio of the tone must be its frequency;
  6. throughput of both chains with CUDA events over 20 blocks.

Then the kernels' JSON line, the nvidia-smi line and, last,
{"ok": true, "device": {...}}.  Any failed phase exits non-zero.  Needs
one CUDA GPU; imports neither jax nor solid_dsp_tpu.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np
import torch

L_FULL = 1 << 24          # config 4's block length
L_F64 = 1 << 20
N_CHAIN = 4               # blocks of the chain comparison
N_TIMED = 20              # blocks of the throughput phase
SEED = 0
# the JAX package's own gates (tests/test_rx_chain_fused.py, test_epilogue.py)
MIN_SNR_DB = 90.0
ENERGY_RTOL = 1e-5
EDGE_ATOL = 1e-4
TONE_ATOL = 1e-3


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def snr_db(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
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


def cuda_ms(fn, n: int) -> float:
    """Mean ms of fn() over n calls, CUDA events, after 3 warm-up calls."""
    for _ in range(3):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs only on a GPU")
    from solid_dsp_tpu_torch.models.rx_chain import RxChainConfig, make_rx_chain
    from solid_dsp_tpu_torch.ops import cuda_ddc
    from solid_dsp_tpu_torch.ops.nco import constrain

    torch.backends.cuda.matmul.allow_tf32 = False   # TF32 would fail 90 dB
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

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
    cuda_ddc.build()
    print(f"[2 build] ddc_fm extension built in "
          f"{time.perf_counter() - t:.1f} s", flush=True)

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
    ap, sp = cuda_ddc.ddc_fm_torch(body, x, tail)
    torch.cuda.synchronize()
    ak, sk = ak.cpu().numpy(), sk.cpu().numpy()
    ap, sp = ap.cpu().numpy(), sp.cpu().numpy()
    snr3 = snr_db(ak, ap)
    err_e = abs(float(sk[0]) - float(sp[0])) / abs(float(sp[0]))
    err_z = float(np.max(np.abs(sk[1:] - sp[1:])))
    max_abs = float(np.max(np.abs(ak - ap)))
    k_ms = cuda_ms(lambda: cuda_ddc.ddc_fm_cuda(body, x, tail), 20)
    p_ms = cuda_ms(lambda: cuda_ddc.ddc_fm_torch(body, x, tail), 20)
    print(f"[3 kernel vs plain f32, L=2^24] audio {snr3:.1f} dB (gate "
          f"{MIN_SNR_DB}), max |err| {max_abs:.3g}, energy rel err "
          f"{err_e:.3g} (gate {ENERGY_RTOL}), z0/zlast err {err_z:.3g} "
          f"(gate {EDGE_ATOL}); kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms | "
          f"{smi}", flush=True)
    if not (snr3 >= MIN_SNR_DB and err_e <= ENERGY_RTOL and err_z <= EDGE_ATOL
            and np.all(np.isfinite(ak)) and ak.shape == (L_FULL // M,)):
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
    def run_chain(init, apply):
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

    p1 = run_chain(init_p, apply_p)
    k1 = run_chain(init_k, apply_k)
    k2 = run_chain(init_k, apply_k)
    p2 = run_chain(init_p, apply_p)
    print(f"[6 throughput, {N_TIMED} x 2^24] chain with kernel {k1:.1f} / "
          f"{k2:.1f} Msamples/s, plain chain {p1:.1f} / {p2:.1f} Msamples/s | "
          f"{smi}", flush=True)

    print(json.dumps({"kernels": [{
        "name": "ddc_fm",
        "route": "cuda",
        "source": "solid_dsp_tpu_torch/csrc/ddc_fm.cu",
        "replaces": "solid_dsp_tpu/ops/pallas_ddc.py:590",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
