"""Link-level Monte-Carlo simulation: BER/BLER sweeps on the device.

Port of ``solid_dsp_tpu/models/ber.py``:

* ``ber_sweep``: uncoded BER across an Eb/N0 grid.  The burst is modulated
  once; JAX vmaps the noise and slicing over keys, the port draws every
  point's noise from one generator in one batched call and slices the
  (points, symbols) batch at once.
* ``link_sim``: coded links, any ``encode``/``decode`` pair (BlockCode,
  ConvCode, LDPCCode, TurboCode, PolarCode or callables), BER and BLER a
  point, the Eb/N0 -> noise mapping rate-adjusted.

The data bits are the JAX package's (numpy, from ``seed``); the noise comes
from a ``torch.Generator`` seeded the same way (``seed`` for the sweep,
``seed + 7919 i`` for point i of ``link_sim``) on ``device`` (the card
unless told otherwise), so the counts agree with JAX's statistically, not
draw for draw.  Noise convention of ``models/channel.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import bind_device
from . import channel as ch
from . import linear_mod as lm

__all__ = ["ber_sweep", "link_sim"]


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def ber_sweep(ebn0_db, scheme: str = "psk", m: int = 4,
              n_bits: int = 1_000_000, seed: int = 0,
              device=None) -> np.ndarray:
    """Uncoded BER at each Eb/N0 point (dB array-like) -> BER array, on the
    symbol-rate AWGN channel ``channel.ber_theory`` describes; every
    point's noise in one draw."""
    dev = bind_device(device)
    ebn0_db = np.atleast_1d(np.asarray(ebn0_db, float))
    kmod = int(np.log2(m))
    n_bits -= n_bits % kmod
    if n_bits <= 0:
        raise ValueError("n_bits must be >= bits-per-symbol")
    rng = np.random.default_rng(seed)
    bits = torch.from_numpy(rng.integers(0, 2, n_bits).astype(np.int32)).to(
        dev)
    pts = lm.constellation(scheme, m)
    tx = lm.modulate_symbols(lm.bits_to_symbols(bits, kmod), pts).to(
        torch.complex64)
    nvs = np.array([ch.ebn0_to_noise_var(e, kmod) for e in ebn0_db])
    g = torch.Generator(device=dev).manual_seed(int(seed))
    P = len(ebn0_db)
    sigma = torch.from_numpy(np.sqrt(nvs / 2.0)).to(dev, torch.float32)
    noise = torch.complex(*(torch.randn((P, tx.shape[-1]), generator=g,
                                        device=dev) for _ in range(2)))
    rx = tx + sigma[:, None] * noise
    got = lm.symbols_to_bits(lm.slice_symbols(rx, pts), kmod).reshape(P, -1)
    errs = torch.sum(got != bits, dim=-1)
    return _host(errs).astype(float) / n_bits


def link_sim(encode, decode, k: int, n: int, ebn0_db, *,
             n_blocks: int = 200, scheme: str = "psk", m: int = 2,
             soft: bool = True, code_rate: float | None = None,
             seed: int = 0, device=None) -> dict:
    """Coded-link Monte Carlo: BER and BLER per Eb/N0 point.

    ``encode`` maps data bits (blocks, k) -> code bits (blocks, n);
    ``decode`` maps (blocks, n) LLRs (``soft=True``, positive favours bit 0)
    or hard bits back to (blocks, k) (a tuple's first element is taken).
    The noise variance is rate-adjusted (``code_rate`` defaults to k / n).
    Returns ``{"ebn0_db", "ber", "bler", "bits_per_point"}``."""
    dev = bind_device(device)
    ebn0_db = np.atleast_1d(np.asarray(ebn0_db, float))
    kmod = int(np.log2(m))
    rate = k / n if code_rate is None else float(code_rate)
    rng = np.random.default_rng(seed)
    pts = lm.constellation(scheme, m)
    ber = np.zeros(len(ebn0_db))
    bler = np.zeros(len(ebn0_db))
    for i, e in enumerate(ebn0_db):
        data = rng.integers(0, 2, (n_blocks, k)).astype(np.int32)
        coded = _host(encode(data)).reshape(-1)
        pad = (-len(coded)) % kmod
        flat = np.concatenate([coded, np.zeros(pad, coded.dtype)])
        syms = lm.bits_to_symbols(torch.from_numpy(flat).to(dev), kmod)
        tx = lm.modulate_symbols(syms, pts).to(torch.complex64)
        nv = ch.ebn0_to_noise_var(e, kmod, code_rate=rate)
        g = torch.Generator(device=dev).manual_seed(int(seed + 7919 * i))
        rx = ch.awgn(g, tx, noise_var=nv)
        if soft:
            obs = lm.demap_soft(rx, pts, nv)
        else:
            obs = lm.symbols_to_bits(lm.slice_symbols(rx, pts), kmod)
        obs = obs.reshape(-1)[: len(coded)].reshape(n_blocks, n)
        dec = decode(obs)
        if isinstance(dec, tuple):
            dec = dec[0]
        errs = _host(dec).reshape(n_blocks, k) != data
        ber[i] = errs.mean()
        bler[i] = errs.any(axis=1).mean()
    return {"ebn0_db": ebn0_db, "ber": ber, "bler": bler,
            "bits_per_point": n_blocks * k}
