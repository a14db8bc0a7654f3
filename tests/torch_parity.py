"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_*.py).

The same inputs, made with numpy from a seed, go through the JAX package and
through the port; results come back as numpy and are compared there.  JAX is
imported only inside :func:`run_jax`: the card's tests
(tests/test_torch_cuda.py) import this module where JAX is not installed.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from solid_dsp_tpu_torch.models.rx_chain import RxChainConfig, make_rx_chain

# 65536 * 2: the block length tests/test_epilogue.py uses for interpret-mode
# K1; a multiple of 64 * M, so the port's chain takes its fused FM path.
L_SMALL = 65536 * 2

# config 4's chain, as bench.py builds it
CONFIG4 = dict(carrier_freq=0.2, decimation=4, fir_taps=64, agc_mode="block",
               demod="fm", nco_mode="exact", input_format="planar",
               fused_ddc="on", fir_precision="x3")


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


def make_blocks(n_blocks: int, L: int = L_SMALL, seed: int = 7):
    """Planar (2, L) f32 blocks: a tone at the carrier plus complex noise,
    the phase continuing from block to block (tests/test_epilogue.py)."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_blocks):
        x = rng.standard_normal(L) + 1j * rng.standard_normal(L)
        x = 0.1 * x + 0.5 * np.exp(1j * (0.2 * np.arange(b * L, (b + 1) * L)
                                         + 0.3))
        out.append(np.stack([x.real, x.imag]).astype(np.float32))
    return out


def make_qpsk_blocks(n_blocks: int, L: int = L_SMALL, seed: int = 7,
                     offset: float = 5e-4, sps: int = 32):
    """Planar (2, L) f32 QPSK blocks: Gray symbols held for ``sps`` input
    samples, mixed to the carrier 0.2 rad/sample plus ``offset``, with
    complex noise.  Returns (blocks, symbols)."""
    rng = np.random.default_rng(seed)
    n = n_blocks * L
    gray = np.array([1 + 1j, -1 + 1j, 1 - 1j, -1 - 1j]) / np.sqrt(2.0)
    sym = rng.integers(0, 4, -(-n // sps))
    x = 0.5 * np.repeat(gray[sym], sps)[:n] * np.exp(
        1j * ((0.2 + offset) * np.arange(n) + 0.4))
    x += 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    blocks = [np.stack([x[b * L:(b + 1) * L].real, x[b * L:(b + 1) * L].imag]
                       ).astype(np.float32) for b in range(n_blocks)]
    return blocks, sym


def as_format(blocks, input_format: str):
    """Planar (2, L) f32 blocks in another ingest format: complex64 (L,)
    for "cf32", interleaved int16 (L, 2) for "ci16" (scaled by 16000)."""
    if input_format == "cf32":
        return [(b[0] + 1j * b[1]).astype(np.complex64) for b in blocks]
    if input_format == "ci16":
        return [np.round(b.T * 16000.0).astype(np.int16) for b in blocks]
    return blocks


def run_jax(blocks, state=None, **overrides):
    """JAX chain over the blocks -> (audio, numpy state tree)."""
    import jax
    import jax.numpy as jnp

    from solid_dsp_tpu.models.rx_chain import RxChainConfig as JaxRxChainConfig
    from solid_dsp_tpu.models.rx_chain import make_rx_chain as jax_make_rx_chain

    cfg = JaxRxChainConfig(**{**CONFIG4, "dtype": jnp.complex64, **overrides})
    init, apply = jax_make_rx_chain(cfg)
    st = init() if state is None else state
    outs = []
    for xb in blocks:
        out, st = apply(st, jnp.asarray(xb))
        outs.append(np.asarray(out))
    return np.concatenate(outs), jax.tree_util.tree_map(np.asarray, st)


def run_torch(blocks, state=None, device="cpu", **overrides):
    """Port's chain over the blocks -> (audio, ChainState)."""
    init, apply = make_rx_chain(RxChainConfig(**{**CONFIG4, **overrides}),
                                device)
    st = init() if state is None else state
    outs = []
    for xb in blocks:
        out, st = apply(st, torch.from_numpy(xb).to(device))
        outs.append(out.cpu().numpy())
    return np.concatenate(outs), st


def require_cuda() -> torch.device:
    """The card, or skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc; run on the card")
    return torch.device("cuda", 0)


# The tensor-core DDC kernels' host side (csrc/ddc_tc.cuh runs only on the
# card): their packed TF32 hi/lo banks unpacked, and the frame product.

def unpack_tc_bank(packed, P, KP):
    """The packed bank (ops/cuda_ddc.py::body_tc_bank) -> (hi, lo), each
    (2, KP, 2P) float64 in window order, columns in the bank's order."""
    N, steps = 2 * P, KP // 8
    ks = np.arange(steps)
    k_idx = (16 * (ks // 2)[:, None, None] + 4 * np.arange(4)[None, None, :]
             + 2 * (ks % 2)[:, None, None] + np.arange(2)[None, :, None])
    out = []
    for half in packed.reshape(2, 2, steps, 2, N // 8, 8, 4):
        B = np.zeros((2, KP, N))
        # [plane][step][kc][grp][col][kk] -> [plane][step][kc][kk][col]
        v = half.transpose(0, 1, 2, 5, 3, 4).reshape(2, steps, 2, 4, N)
        B[:, k_idx, :] = v
        out.append(B)
    return out


def tc_frames(x2, tail2, n, M, P, hpad, KP, lhs):
    """z (2, T) of the frame product: frame f reads the window of KP
    samples from f*hop - hpad (the tail before the block, zeros before the
    tail and past the block); ``lhs(window)`` gives the planes' (F, KP)
    operands and bank pairs to sum."""
    L = x2.shape[1]
    T, hop, D = L // M, P * M, n - M
    F = -(-T // P)
    ext = np.zeros((2, hpad + F * hop + KP))
    ext[:, hpad - D:hpad] = tail2
    ext[:, hpad:hpad + L] = x2
    win = np.stack([ext[:, f * hop:f * hop + KP] for f in range(F)], axis=1)
    y = lhs(win)                                            # (F, 2P)
    return np.stack([y[:, :P].reshape(-1)[:T], y[:, P:].reshape(-1)[:T]])
