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
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
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
