"""The port's chain on the rest of config 4 vs the JAX package's chain.

Four blocks with the state carried for each setting: AM (collapsed
epilogue, DDC body), QPSK and ``demod="none"`` (rotated path), FM and AM
with ``epilogue="rotate"``, FM on blocks that are not a multiple of 64*M
(the DDC body and the FM epilogue instead of K1; on the JAX side K3 runs
under ``engine="pallas"``), and the ``cf32`` and ``ci16`` ingest formats.
Gates, the JAX package's own (tests/test_rx_chain_fused.py,
test_epilogue.py): >= 90 dB at fir_precision="x3" against both JAX engines,
>= 100 dB at "highest" against XLA; QPSK >= 60 dB (BASELINE.json's bound:
its carrier estimate comes from float32 FFTs that round differently).
State as in tests/test_torch_rx_chain.py.
"""

import numpy as np
import pytest
import torch

from solid_dsp_tpu_torch.models import qpsk
from test_torch_rx_chain import _check_state
from torch_parity import (L_SMALL, as_format, make_blocks, make_qpsk_blocks,
                          run_jax, run_torch, snr_db)

SETTINGS = {
    "am": dict(demod="am"),
    "qpsk": dict(demod="qpsk"),
    "none": dict(demod="none"),
    "fm_rotate": dict(epilogue="rotate"),
    "am_rotate": dict(demod="am", epilogue="rotate"),
    "fm_unaligned": dict(),
    "cf32": dict(input_format="cf32"),
    "ci16": dict(input_format="ci16"),
}
# (JAX engine, fir_precision, gate in dB)
ENGINES = {"x3_pallas": ("pallas", "x3", 90.0),
           "x3_xla": ("xla", "x3", 90.0),
           "highest_xla": ("xla", "highest", 100.0)}


def _blocks(name, seed):
    if name == "qpsk":
        return make_qpsk_blocks(4, seed=seed)[0]
    L = L_SMALL + 52 if name == "fm_unaligned" else L_SMALL
    return as_format(make_blocks(4, L=L, seed=seed),
                     SETTINGS[name].get("input_format", "planar"))


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("name", list(SETTINGS))
def test_chain_setting_matches_jax(name, engine):
    jax_engine, precision, gate = ENGINES[engine]
    if name == "qpsk":
        gate = 60.0
    setting = {**SETTINGS[name], "fir_precision": precision}
    blocks = _blocks(name, seed=31)
    want, jst = run_jax(blocks, ddc_engine=jax_engine, **setting)
    got, st = run_torch(blocks, **setting)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.all(np.isfinite(got))
    assert snr_db(got, want) >= gate
    _check_state(st, jst)


@pytest.mark.parametrize("L", [1000, 4096 + 4, 128])
def test_unaligned_fm_block_matches_jax(L):
    """FM blocks that are not a multiple of 256 = 64*M take the DDC body
    and the FM epilogue (the JAX chain's pieces path): >= 90 dB over 4
    blocks, state carried."""
    blocks = make_blocks(4, L=L, seed=32)
    want, jst = run_jax(blocks, ddc_engine="xla")
    got, st = run_torch(blocks)
    assert got.shape == (4 * L // 4,)
    assert snr_db(got, want) >= 90.0
    _check_state(st, jst)


def test_qpsk_chain_recovers_symbols():
    """The QPSK chain slices the transmitted symbols: SER 0 at 8 decimated
    samples per symbol, sampled mid-symbol, each block resolving its own
    pi/2 ambiguity."""
    blocks, sym = make_qpsk_blocks(4, seed=33)
    got, _ = run_torch(blocks, demod="qpsk")
    T = L_SMALL // 4
    for b in range(4):
        y = got[b * T:(b + 1) * T]
        # output t's window ends at input sample 4t + 3; the filter's
        # centre is 31.5 samples earlier: symbol k's middle is t = 8k + 11
        k0 = b * T // 8
        rx = qpsk.qpsk_slice(torch.from_numpy(y[11::8][:-2])).numpy()
        ser = qpsk.symbol_error_rate(sym[k0:k0 + len(rx)], rx)
        assert ser == 0.0, (b, ser)
