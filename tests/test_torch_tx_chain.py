"""Port vs JAX package: models/tx_chain.py (TxChainConfig, make_tx_chain,
TxChain) on the CPU.

Gates: the anti-image taps equal to JAX's; the transmitted IQ within 1e-10
of JAX's in complex128 (every modulation; the "exact" oscillator in
float64) and 1e-4 in complex64 (a float32 FM phase summed in another
order); tests/test_tx_chain.py's properties: the passthrough's spectral
peak at the carrier plus the interpolated tone, the QAM spectrum > 95 % in
band, the message band passed with unit power; the streaming continuity
of tests/test_tx_chain.py:68 (1500 + 2596 samples against one block,
1e-10); the FM loopback into the port's RxChain (correlation > 0.95,
:26); the state built on the device, and carried across the packages
(``interop.state_from_numpy``: one block in JAX, the next in both, equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.models.tx_chain import TxChain as JTxChain
from solid_dsp_tpu.models.tx_chain import TxChainConfig as JTxChainConfig
from solid_dsp_tpu_torch.interop import state_from_numpy, state_to_numpy
from solid_dsp_tpu_torch.models import TxChain, TxChainConfig
from solid_dsp_tpu_torch.models.rx_chain import RxChain, RxChainConfig

CPU = "cpu"
JDT = {torch.complex64: jnp.complex64, torch.complex128: jnp.complex128}


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _pair(dtype=torch.complex128, **kw):
    return (TxChain(TxChainConfig(dtype=dtype, **kw), device=CPU),
            JTxChain(JTxChainConfig(dtype=JDT[dtype], **kw)))


def _msg(mod, n, rng):
    if mod == "fm":
        return rng.standard_normal(n)
    if mod in ("psk", "qam"):
        return rng.integers(0, 2, n)
    return np.exp(2j * np.pi * 0.01 * np.arange(n))


@pytest.mark.parametrize("mod,order", [("fm", 4), ("psk", 8), ("qam", 16),
                                       ("none", 4)])
@pytest.mark.parametrize("dtype,tol", [(torch.complex128, 1e-10),
                                       (torch.complex64, 1e-4)])
def test_tx_chain_matches_jax(mod, order, dtype, tol):
    rng = np.random.default_rng(order)
    tx, jtx = _pair(dtype, modulation=mod, order=order, carrier_freq=0.7)
    np.testing.assert_array_equal(tx.cfg.design_taps(),
                                  jtx.cfg.design_taps())
    msg = _msg(mod, 1200, rng)
    for _ in range(2):                      # the state carried
        iq = tx.execute_block(torch.from_numpy(msg))
        jiq = np.asarray(jtx.execute_block(jnp.asarray(msg)))
        assert iq.dtype == dtype and iq.shape == jiq.shape
        np.testing.assert_allclose(_np(iq), jiq, atol=tol)
    assert int(tx.state["nco_theta"]) == int(jtx.state.nco_theta)


def test_tx_state_on_device_and_carried_from_jax():
    rng = np.random.default_rng(4)
    for mod in ("fm", "qam"):
        tx, jtx = _pair(modulation=mod, order=16)
        st = tx.state
        assert set(st) == {"nco_theta", "fir_tail", "fm_phase", "rrc_tail"}
        assert all(v.device.type == "cpu" for v in st.values())
        assert st["nco_theta"].dtype == torch.int64
        m1, m2 = _msg(mod, 1000, rng), _msg(mod, 1600, rng)
        jtx.execute_block(jnp.asarray(m1))
        tx.state = state_from_numpy(
            jax.tree_util.tree_map(np.asarray, dict(jtx.state)), CPU)
        got = _np(tx.execute_block(torch.from_numpy(m2)))
        want = np.asarray(jtx.execute_block(jnp.asarray(m2)))
        np.testing.assert_allclose(got, want, atol=1e-10)
        back = state_to_numpy(tx.state)
        assert back["nco_theta"].dtype == np.uint32
        assert int(back["nco_theta"]) == int(jtx.state.nco_theta)
        np.testing.assert_allclose(back["fir_tail"],
                                   np.asarray(jtx.state.fir_tail), atol=1e-10)


def test_tx_streaming_continuity():
    msg = np.random.default_rng(2).standard_normal(4096)
    full = _np(TxChain(TxChainConfig(modulation="fm",
                                     dtype=torch.complex128),
                       device=CPU).execute_block(torch.from_numpy(msg)))
    t2 = TxChain(TxChainConfig(modulation="fm", dtype=torch.complex128),
                 device=CPU)
    a = _np(t2.execute_block(torch.from_numpy(msg[:1500])))
    b = _np(t2.execute_block(torch.from_numpy(msg[1500:])))
    np.testing.assert_allclose(np.concatenate([a, b]), full, atol=1e-10)
    t2.reset()
    np.testing.assert_allclose(
        _np(t2.execute_block(torch.from_numpy(msg))), full, atol=0)


def test_tx_spectra_and_passband():
    n = 2048
    bb = np.exp(2j * np.pi * 0.01 * np.arange(n))
    iq = _np(TxChain(TxChainConfig(modulation="none", carrier_freq=0.5,
                                   dtype=torch.complex128),
                     device=CPU).execute_block(torch.from_numpy(bb)))
    assert iq.shape == (4 * n,)
    f_peak = np.argmax(np.abs(np.fft.fft(iq))) / len(iq)
    assert abs(f_peak - (0.5 / (2 * np.pi) + 0.01 / 4) % 1.0) < 1e-3
    bits = np.random.default_rng(1).integers(0, 2, 4096)
    iq = _np(TxChain(TxChainConfig(modulation="qam", order=16,
                                   carrier_freq=1.0, interpolation=2,
                                   dtype=torch.complex128),
                     device=CPU).execute_block(torch.from_numpy(bits)))
    X = np.abs(np.fft.fft(iq))
    f = np.fft.fftfreq(len(X))
    inband = np.abs((f - 1.0 / (2 * np.pi) + 0.5) % 1.0 - 0.5) < 0.1
    assert np.sum(X[inband] ** 2) / np.sum(X ** 2) > 0.95
    for f_msg in (0.05, 0.38):
        bb = np.exp(2j * np.pi * f_msg * np.arange(4096))
        iq = _np(TxChain(TxChainConfig(modulation="none", carrier_freq=0.0,
                                       dtype=torch.complex128),
                         device=CPU).execute_block(torch.from_numpy(bb)))
        assert abs(np.mean(np.abs(iq[512:]) ** 2) - 1.0) < 0.1
    with pytest.raises(ValueError):
        TxChain(TxChainConfig(modulation="chirp"), device=CPU)


def test_tx_rx_fm_loopback_through_the_port():
    msg = np.sin(2 * np.pi * 0.002 * np.arange(1 << 14))
    tx = TxChain(TxChainConfig(modulation="fm", carrier_freq=0.2,
                               interpolation=4, fm_kf=0.02,
                               dtype=torch.complex128), device=CPU)
    iq = tx.execute_block(torch.from_numpy(msg))
    rx = RxChain(RxChainConfig(carrier_freq=0.2, decimation=4,
                               agc_mode="parallel", demod="fm",
                               fm_kf=0.02 / 4, dtype=torch.complex128),
                 device=CPU)
    a = _np(rx.execute_block(iq)).real[512:]
    best = max(abs(np.corrcoef(a, msg[512 - lag: 512 - lag + len(a)])[0, 1])
               for lag in range(40))
    assert best > 0.95
