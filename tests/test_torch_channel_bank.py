"""The port's IIR bank, ChannelBank, detector pieces and SpectrumMonitor vs
the JAX package's (config 5), on the CPU.

Inputs come from numpy with a seed; the JAX side runs ``iir_bank_apply``
(K6) and the fused channelizer in interpret mode, the port the kernels'
plain PyTorch versions.  Gates: the IIR bank atol 3e-5
(tests/test_pallas.py:118-201); ChannelBank >= 90 dB with the state
carried over 3 blocks and the squelch's gate masks equal; the AGC's gain
and energy rtol 1e-5 on the same block (float32 means in another order),
rtol 1e-4 after a ChannelBank run (its outputs agree to >= 90 dB, ~3e-5 in
amplitude, and the energy is their square); the sliding energy atol
5e-3 dB (a float32 cumsum in another order: the window mean is the
difference of two running sums that grow over the block, ~1e-3 dB apart
at quiet samples after loud ones); SpectrumMonitor's event lists equal;
taps and sections equal to 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.models import channel_bank as jcb
from solid_dsp_tpu.models import detect as jdetect
from solid_dsp_tpu.models.monitor import SpectrumMonitor as JaxMonitor
from solid_dsp_tpu.ops import agc as jagc
from solid_dsp_tpu.ops import pallas_kernels as jpk
from solid_dsp_tpu_torch.interop import (state_from_numpy, state_to_numpy,
                                         tensors_to_numpy)
from solid_dsp_tpu_torch.models import channel_bank as cb
from solid_dsp_tpu_torch.models import detect
from solid_dsp_tpu_torch.models.monitor import SpectrumMonitor
from solid_dsp_tpu_torch.ops import agc, cuda_iir
from torch_parity import snr_db

CPU = "cpu"


def _noise(seed, *shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


def _butter_sos():
    """tests/test_pallas.py's hand-computed 2-section lowpass."""
    return np.array([[0.0675, 0.1349, 0.0675, -1.1430, 0.4128],
                     [0.25, 0.5, 0.25, -0.9, 0.3]], dtype=np.float32)


@pytest.mark.parametrize("cutoff,order", [(0.25, 4), (0.1, 2), (0.33, 6)])
def test_design_channel_sos_matches_jax(cutoff, order):
    got = cb.design_channel_sos(cutoff, order)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, jcb.design_channel_sos(cutoff, order),
                               rtol=0, atol=1e-12)
    with pytest.raises(ValueError):
        cb.design_channel_sos(0.2, 3)


@pytest.mark.parametrize("case", ["shared", "per_channel", "split_blocks"])
def test_iir_bank_plain_matches_jax_interpret_kernel(case):
    """K6's plain version vs JAX's iir_bank_apply in interpret mode: shared
    (T = 300, C = 16), per channel (S = 2, C = 8, T = 200) and two blocks
    of T = 250 (not a multiple of the 64-row tile) with the state carried:
    atol 3e-5 on the outputs and the state."""
    if case == "per_channel":
        C, T = 8, 200
        sos = np.stack([cb.design_channel_sos(0.1 + 0.03 * c)
                        for c in range(C)], axis=-1)
    else:
        C, T = (16, 300) if case == "shared" else (8, 250)
        sos = _butter_sos()
    n_blocks = 2 if case == "split_blocks" else 1
    x = _noise(3, n_blocks * T, C)
    st = cuda_iir.iir_bank_init(sos.shape[0], C, CPU)
    jst = jpk.iir_bank_init(sos.shape[0], C)
    for blk in np.split(x, n_blocks):
        y, st = cuda_iir.iir_bank_apply(sos, st, torch.from_numpy(blk))
        jy, jst = jpk.iir_bank_apply(jnp.asarray(sos), jst, jnp.asarray(blk),
                                     tile_rows=64, interpret=True)
        assert y.dtype == torch.complex64 and y.shape == (T, C)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                                   atol=3e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), rtol=0,
                               atol=3e-5)


def test_iir_bank_rejects_bad_shapes():
    x = torch.zeros((10, 4), dtype=torch.complex64)
    st = cuda_iir.iir_bank_init(2, 4, CPU)
    with pytest.raises(ValueError):
        cuda_iir.iir_bank_apply(np.zeros((2, 5, 3), np.float32), st, x)
    with pytest.raises(ValueError):
        cuda_iir.iir_bank_apply(_butter_sos(), cuda_iir.iir_bank_init(
            3, 4, CPU), x)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_iir.iir_bank_apply(_butter_sos(), st, x, engine="cuda")


@pytest.mark.parametrize("gain", [1.0, 1.7])
def test_batched_block_agc_matches_jax(gain):
    """agc_init(batch_shape=(C,)) and the per-row gain broadcast of
    agc_apply_block_mode (JAX ops/agc.py:51-72, 390-402)."""
    C = 6
    x = _noise(4, C, 500) * np.linspace(0.1, 2.0, C, dtype=np.float32)[:, None]
    st = agc.agc_init(torch.float32, CPU, batch_shape=(C,))
    jst = jagc.agc_init(jnp.float32, batch_shape=(C,))
    for k in st:
        assert st[k].shape == (C,)
        assert st[k].numpy().dtype == np.asarray(jst[k]).dtype
    st["gain"] = st["gain"] * gain
    jst = {**jst, "gain": jnp.asarray(st["gain"].numpy())}
    for _ in range(3):
        out, st = agc.agc_apply_block_mode(st, torch.from_numpy(x), 0.05)
        jout, jst = jagc.agc_apply_block_mode(jst, jnp.asarray(x), 0.05)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                                   atol=1e-7)
        for k in ("gain", "energy"):
            np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]),
                                       rtol=1e-5)


def test_sliding_energy_and_hysteresis_gate_match_jax():
    """Per-channel sliding energy (float32 cumsum both sides) within
    5e-3 dB and the gate, batched over channels, equal, over two blocks."""
    M, T, W = 8, 400, 32
    rng = np.random.default_rng(5)
    env = np.where((np.arange(2 * T) // 60) % 3 == 0, 1.0, 0.05)
    x = (_noise(6, M, 2 * T) * env * rng.uniform(0.5, 2.0, (M, 1))
         ).astype(np.complex64)
    tail = torch.zeros((M, W), dtype=torch.complex64)
    on = torch.zeros(M, dtype=torch.bool)
    jtail = jnp.zeros((M, W), jnp.complex64)
    jon = jnp.zeros(M, bool)
    for blk in np.split(x, 2, axis=1):
        e_db, tail = detect.sliding_energy_db(torch.from_numpy(blk), tail, W)
        je_db, jtail = jdetect.sliding_energy_db(jnp.asarray(blk), jtail, W)
        np.testing.assert_allclose(e_db.numpy(), np.asarray(je_db), rtol=0,
                                   atol=5e-3)
        np.testing.assert_array_equal(tail.numpy(), np.asarray(jtail))
        gate, on = detect.hysteresis_gate(e_db, -3.0, -9.0, on)
        jgate, jon = jdetect.hysteresis_gate(je_db, -3.0, -9.0, jon)
        np.testing.assert_array_equal(gate.numpy(), np.asarray(jgate))
        np.testing.assert_array_equal(on.numpy(), np.asarray(jon))
        assert gate.any() and not gate.all()


def _bank_input(M, n_blocks, T, seed):
    """Noise, a tone in channel 3 and a burst in channel 5 that starts and
    stops inside the blocks."""
    L = n_blocks * T * M
    k = np.arange(L)
    x = 0.05 * _noise(seed, L)
    x = x + 0.5 * np.exp(2j * np.pi * 3 / M * k)
    burst = (k > L // 3) & (k < 2 * L // 3)
    x = x + burst * 0.8 * np.exp(2j * np.pi * 5 / M * k)
    return np.split(x.astype(np.complex64), n_blocks)


@pytest.mark.parametrize("backend,agc_bw,squelch,per_channel", [
    ("xla", 0.0, None, False), ("xla", 0.05, -10.0, False),
    ("fused", 0.05, None, False), ("fused", 0.0, -10.0, True),
    ("pallas", 0.02, -15.0, False)])
def test_channel_bank_matches_jax(backend, agc_bw, squelch, per_channel):
    """ChannelBank over 3 blocks with the state carried (M = 16): outputs
    >= 90 dB, the squelch's gate masks equal, the IIR state and the AGC
    carry as in the module docstring."""
    M, T = 16, 64
    sos = (np.stack([cb.design_channel_sos(0.1 + 0.02 * c)
                     for c in range(M)], axis=-1) if per_channel else None)
    kw = dict(sos=sos, agc_bandwidth=agc_bw, backend=backend,
              squelch_high_db=squelch)
    port = cb.ChannelBank(M, device=CPU, **kw)
    jbank = jcb.ChannelBank(M, **kw)
    for blk in _bank_input(M, 3, T, 7):
        Y = port.execute_block(blk)
        jY = jbank.execute_block(jnp.asarray(blk))
        assert Y.shape == (T, M) and Y.dtype == torch.complex64
        assert snr_db(Y.numpy(), np.asarray(jY)) >= 90.0
        if squelch is not None:
            np.testing.assert_array_equal(port.last_gate.numpy(),
                                          np.asarray(jbank.last_gate))
    got = state_to_numpy(port.state)
    want = jax.tree_util.tree_map(np.asarray, jbank.state)
    np.testing.assert_allclose(got["iir"], want["iir"], rtol=0, atol=3e-5)
    for k in ("gain", "energy"):
        np.testing.assert_allclose(got["agc"][k], want["agc"][k], rtol=1e-4)
    for k in ("lock", "mode", "timer"):
        np.testing.assert_array_equal(got["agc"][k], want["agc"][k])


def test_channel_bank_selects_and_levels():
    """A +c/M tone lands in channel c; the AGC brings it toward unit
    magnitude (test_channel_bank.py:22-37)."""
    M, c = 16, 3
    bank = cb.ChannelBank(M, agc_bandwidth=0.05, device=CPU)
    x = (0.05 * np.exp(2j * np.pi * (c / M) * np.arange(M * 400))
         ).astype(np.complex64)
    Y = bank.execute_block(x).numpy()
    assert np.mean(np.abs(Y[100:]) ** 2, axis=0).argmax() == c
    for _ in range(30):
        Y = bank.execute_block(x).numpy()
    assert 0.9 < np.mean(np.abs(Y[:, c])) < 1.1


def test_channel_bank_state_moves_both_ways():
    """A JAX ChannelBank's state after 2 blocks (IIR state, batched AGC,
    channelizer tail) loads into the port's, which then continues as the
    JAX bank does; the loaded state reads back unchanged."""
    M, T = 16, 64
    blocks = _bank_input(M, 3, T, 8)
    jbank = jcb.ChannelBank(M, agc_bandwidth=0.05)
    for blk in blocks[:2]:
        jbank.execute_block(jnp.asarray(blk))
    jstate = jax.tree_util.tree_map(np.asarray, jbank.state)
    port = cb.ChannelBank(M, agc_bandwidth=0.05, device=CPU)
    port.state = state_from_numpy(jstate, CPU)
    port.channelizer.state = np.asarray(jbank.channelizer._tail)
    back = state_to_numpy(port.state)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jstate)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tensors_to_numpy(port.channelizer.state),
                                  np.asarray(jbank.channelizer._tail))
    got = port.execute_block(blocks[2]).numpy()
    want = np.asarray(jbank.execute_block(jnp.asarray(blocks[2])))
    assert snr_db(got, want) >= 90.0
    with pytest.raises(ValueError, match="iir"):
        port.state = {"iir": np.zeros((2, M), np.complex64),
                      "agc": jstate["agc"]}


def test_channel_bank_validation_repr_reset():
    with pytest.raises(ValueError):
        cb.ChannelBank(8, squelch_low_db=-3.0, device=CPU)
    with pytest.raises(ValueError):
        cb.ChannelBank(8, squelch_high_db=-10.0, squelch_low_db=-5.0,
                       device=CPU)
    bank = cb.ChannelBank(8, device=CPU)
    assert "ChannelBank" in repr(bank)
    bank.execute_block(np.ones(8 * 64, np.complex64))
    bank.reset()
    assert float(bank.state["iir"].abs().max()) == 0.0


def _monitor_blocks(M, B, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n):
        x = 0.05 * (rng.standard_normal(B) + 1j * rng.standard_normal(B))
        if 3 <= b < 10:
            x = x + np.exp(2j * np.pi * 5 / M * np.arange(B))
        if 12 <= b < 16:
            x = x + 0.7 * np.exp(2j * np.pi * 11 / M * np.arange(B))
        out.append(x.astype(np.complex64))
    return out


@pytest.mark.parametrize("backend", ["xla", "fused"])
def test_spectrum_monitor_events_match_jax(backend):
    """Bursts on known channels: the port's events, active channels and
    summary equal the JAX monitor's (test_monitor.py:14-35)."""
    M, B = 16, 16 * 128
    port = SpectrumMonitor(M, high_db=10, low_db=6, backend=backend,
                           device=CPU)
    jmon = JaxMonitor(M, high_db=10, low_db=6, backend=backend)
    for x in _monitor_blocks(M, B, 20, 0):
        rel = port.execute_block(x)
        jrel = jmon.execute_block(x)
        assert rel.shape == (M,)
        np.testing.assert_allclose(rel, jrel, rtol=0, atol=1e-3)
    assert sorted(e["channel"] for e in port.events) == [5, 11]
    assert port.events == jmon.events
    assert port.active == jmon.active
    assert port.summary() == jmon.summary()
    assert "SpectrumMonitor" in repr(port)
    with pytest.raises(ValueError):
        port.execute_block(np.ones(M + 1, np.complex64))
    with pytest.raises(ValueError):
        SpectrumMonitor(high_db=5, low_db=6, device=CPU)
