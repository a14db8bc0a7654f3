"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths, the config-4 receive chain of bench.py and
BASELINE.json (solid_dsp_tpu_torch.models.rx_chain: 16M-sample planar f32
blocks, 64-tap NCO-folded bandpass FIR decimating by 4, block AGC, FM, QPSK
and AM demodulation), through the kernels built from
solid_dsp_tpu_torch/csrc/: the fused DDC+FM kernel (ddc_fm.cu) and the DDC
body kernel (ddc_body.cu), on its aligned (K2) and unaligned (K3) routes.
Phases, one line each:

  1. device: GPU name and power limit, torch and CUDA versions;
  2. build: the extension of both kernels from the repository's sources;
  3. FM kernel vs its plain PyTorch version on the card, L = 2^24 (f32);
  4. FM kernel vs the plain version in float64 on the CPU, L = 2^20;
  5. FM chain (kernel) vs chain (plain version) over 4 blocks with the state
     carried, launches counted; the audio of the tone must be its frequency;
  6. throughput of both FM chains with CUDA events over 20 blocks;
  7. body kernel vs its plain version on the card: L = 2^24 (K2's route),
     2^24 + 52 (K3's route) and 32 (a block shorter than the filter);
  8. body kernel vs the plain version in float64 on the CPU, L = 2^20;
  9. QPSK, AM and unaligned-FM chains (kernel vs plain version) over 4
     blocks each with the state carried, launches counted: QPSK symbols
     and carrier offset, the AM envelope's tone, the FM tone read back;
 10. throughput of the QPSK and AM chains with CUDA events over 20 blocks.

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
L_UNALIGNED = L_FULL + 4 * 13   # a multiple of M = 4, not of 64 * M
L_SHORT = 32              # shorter than the 63-sample filter tail
L_F64 = 1 << 20
N_CHAIN = 4               # blocks of the chain comparison
N_TIMED = 20              # blocks of the throughput phase
SEED = 0
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
    from solid_dsp_tpu_torch.models import qpsk as qpsk_ops
    from solid_dsp_tpu_torch.models.rx_chain import RxChainConfig, make_rx_chain
    from solid_dsp_tpu_torch.ops import cuda_ddc
    from solid_dsp_tpu_torch.ops import ddc as ddc_ops
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
    print(f"[2 build] ddc extension (ddc_fm.cu, ddc_body.cu) built in "
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
        timed = ""
        if route != "short":
            k7 = cuda_ms(lambda: kernel(dbody, x, tail), 20)
            p7 = cuda_ms(lambda: cuda_ddc.ddc_body_torch(dbody, x, tail), 20)
            body_stats[route] = (max_abs7, k7, p7)
            timed = f"; kernel {k7:.4f} ms, plain {p7:.4f} ms"
        print(f"[7 body kernel vs plain f32, {route}, L={L}] z {snr7:.1f} dB "
              f"(gate {MIN_SNR_DB}), max |err| {max_abs7:.3g}, energy rel "
              f"err {err_e:.3g} (gate {ENERGY_RTOL}), one launch {once}"
              f"{timed} | {smi}", flush=True)
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
          f"(gate {MIN_SNR_DB})", flush=True)
    if not snr8 >= MIN_SNR_DB:
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

    # 10. throughput of the QPSK and AM chains (plain, kernel, kernel, plain)
    rates = {}
    for label, blks, kern, plain in (("qpsk", qblocks, q_kernel, q_plain),
                                     ("am", ablocks, a_kernel, a_plain)):
        p1 = run_chain(*plain, blks)
        k1 = run_chain(*kern, blks)
        k2 = run_chain(*kern, blks)
        rates[label] = (k1, k2, p1, run_chain(*plain, blks))
    print(f"[10 throughput, {N_TIMED} x 2^24] qpsk chain with kernel "
          f"{rates['qpsk'][0]:.1f} / {rates['qpsk'][1]:.1f} Msamples/s, plain "
          f"{rates['qpsk'][2]:.1f} / {rates['qpsk'][3]:.1f}; am chain with "
          f"kernel {rates['am'][0]:.1f} / {rates['am'][1]:.1f}, plain "
          f"{rates['am'][2]:.1f} / {rates['am'][3]:.1f} | {smi}", flush=True)

    kernels = [{
        "name": "ddc_fm",
        "route": "cuda",
        "source": "solid_dsp_tpu_torch/csrc/ddc_fm.cu",
        "replaces": "solid_dsp_tpu/ops/pallas_ddc.py:590",
        "launches": launches_main["ddc_fm"],
        "max_abs_err": max_abs,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]
    for route, line in (("ddc_body", 359), ("ddc_body_unaligned", 135)):
        err, kms, pms = body_stats[route]
        kernels.append({
            "name": route,
            "route": "cuda",
            "source": "solid_dsp_tpu_torch/csrc/ddc_body.cu",
            "replaces": f"solid_dsp_tpu/ops/pallas_ddc.py:{line}",
            "launches": launches_main[route],
            "max_abs_err": err,
            "ms": kms,
            "plain_ms": pms,
        })
    if not all(k["launches"] > 0 for k in kernels):
        fail("a kernel of the main paths was never launched")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
