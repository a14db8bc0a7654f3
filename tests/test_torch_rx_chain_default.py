"""The fused route's remaining settings: the port's chain vs the JAX chain.

Four blocks with the state carried, on the CPU.  The JAX side runs its
kernels in interpret mode (``ddc_engine="pallas"``) where its routing takes
them, its XLA path elsewhere.

* ``fir_precision="default"`` (the kernels' single bf16 pass): FM, AM and
  QPSK in the planar, cf32 and ci16 formats, on aligned blocks
  (L = 131072: every output inside K1 or K2 on both sides, >= 90 dB; QPSK
  >= 60 dB, BASELINE.json's bound) and unaligned ones (L = 131072 + 52:
  >= 40 dB, because JAX's CPU takes the XLA edge pieces around K3 in full
  float32 while the port rounds every piece to bf16, as the TPU does).
* ``dtype=complex128``: the float64 body on both sides (JAX keeps float64
  off its kernels), >= 200 dB (QPSK, through the complex64 oscillator of
  the rotated path, >= 140 dB).
* ``fir_taps`` 4 (n <= M: K3 on both sides) and 300 (n > 64 M + 1: JAX's
  XLA route and the port's plain body) at "highest", >= 100 dB.

State as tests/test_torch_rx_chain_parity.py::_check_state holds it: the
phase word bit-equal, the FIR tail exactly equal, gain, energy and fm_prev
rtol 1e-5 / 1e-4, 1e-2 at "default".
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_rx_chain_parity import _check_state
from torch_parity import (L_SMALL, as_format, make_blocks, make_qpsk_blocks,
                          run_jax, run_torch, snr_db)


def _blocks(demod, L, fmt, seed=31, c128=False):
    if demod == "qpsk":
        blocks = make_qpsk_blocks(4, L, seed=seed)[0]
    else:
        blocks = make_blocks(4, L=L, seed=seed)
    if c128:
        blocks = [b.astype(np.float64) for b in blocks]
    return as_format(blocks, fmt)


def _compare(setting, blocks, gate, c128=False):
    tov, jov = dict(setting), dict(setting)
    if c128:
        tov["dtype"], jov["dtype"] = torch.complex128, jnp.complex128
    want, jst = run_jax(blocks, ddc_engine="pallas", **jov)
    got, st = run_torch(blocks, **tov)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.all(np.isfinite(got))
    assert snr_db(got, want) >= gate
    _check_state(st, jst, setting)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("fmt", ["planar", "cf32", "ci16"])
@pytest.mark.parametrize("demod", ["fm", "am", "qpsk"])
def test_default_precision_chain_matches_jax(demod, fmt, aligned):
    """fir_precision="default": K1 (FM) or K2 (AM, QPSK) fast on aligned
    blocks, K3 fast and the XLA edges on unaligned ones."""
    L = L_SMALL if aligned else L_SMALL + 52
    gate = (60.0 if demod == "qpsk" else 90.0) if aligned else 40.0
    setting = dict(demod=demod, input_format=fmt, fir_precision="default")
    _compare(setting, _blocks(demod, L, fmt), gate)


@pytest.mark.parametrize("setting,gate", [
    (dict(fir_precision="highest"), 200.0),
    (dict(fir_precision="default"), 200.0),
    (dict(fir_precision="default", demod="am"), 200.0),
    (dict(fir_precision="x3", demod="qpsk"), 140.0)],
    ids=["fm-highest", "fm-default", "am-default", "qpsk-x3"])
def test_complex128_chain_matches_jax(setting, gate):
    """complex128 on the fused route: the float64 body and the collapsed
    epilogue (no K1) in float64, >= 200 dB whatever the precision.  QPSK
    takes the rotated path, whose "fast" oscillator is complex64 in both
    packages (a few float32 ulp apart, tests/test_torch_ddc_body.py's NCO
    tolerance): >= 140 dB there."""
    blocks = _blocks(setting.get("demod", "fm"), L_SMALL, "planar",
                     c128=True)
    _compare(setting, blocks, gate, c128=True)


@pytest.mark.parametrize("taps", [4, 300])
@pytest.mark.parametrize("demod", ["fm", "am"])
def test_tap_counts_outside_k1_match_jax(taps, demod):
    """Tap counts K1 does not take: 4 (n = M, K3's route), 300 (no kernel's
    predicate: JAX's XLA body, the port's plain body), >= 100 dB."""
    setting = dict(demod=demod, fir_taps=taps, fir_precision="highest")
    _compare(setting, _blocks(demod, L_SMALL, "planar"), 100.0)
