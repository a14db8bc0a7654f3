"""Port vs JAX package: models/ofdm.py, models/ofdm_pilots.py and
models/ofdm_link.py (OFDMModem) on the CPU.

Gates: the host layout (active carriers, Schmidl-Cox preamble, pilot
positions and values, ``interp_matrix``, the modem's reference symbol,
interleaver and frame size) equal to JAX's exactly; modulation and
demodulation within 1e-5 of JAX's (complex64 FFTs); the Schmidl-Cox metric
within 1e-4 of max and its (start, cfo) equal (timing, away from ties) and
within 1e-6 cycles; the LS estimate, common phase and MMSE equaliser within
1e-5; the modem's bursts within 1e-5 of JAX's and decoded (CRC and bytes)
exactly as JAX decodes them through multipath + CFO + AWGN at
tests/test_ofdm_link.py's operating points, with ``conv`` (the soft
Viterbi) and ``ldpc``; ``receive_stream`` equal to JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.models import ofdm as jofdm
from solid_dsp_tpu.models import ofdm_pilots as jop
from solid_dsp_tpu.models.ofdm_link import OFDMModem as JOFDMModem
from solid_dsp_tpu_torch.models import ofdm as tofdm
from solid_dsp_tpu_torch.models import ofdm_pilots as top
from solid_dsp_tpu_torch.models.ofdm_link import OFDMModem

CPU = "cpu"


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _cn(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


def test_ofdm_layout_and_mod_demod_equal_jax():
    np.testing.assert_array_equal(tofdm.active_carrier_indices(64, 48),
                                  jofdm.active_carrier_indices(64, 48))
    np.testing.assert_array_equal(tofdm.schmidl_cox_preamble(64, 16),
                                  jofdm.schmidl_cox_preamble(64, 16))
    with pytest.raises(ValueError):
        tofdm.active_carrier_indices(64, 47)
    rng = np.random.default_rng(0)
    X = _cn(rng, 2, 5, 48)
    x_t = tofdm.ofdm_modulate(torch.from_numpy(X), 64, 16, 48)
    x_j = np.asarray(jofdm.ofdm_modulate(jnp.asarray(X), 64, 16, 48))
    assert x_t.shape == (2, 5 * 80)
    np.testing.assert_allclose(_np(x_t), x_j, atol=1e-5)
    Y = tofdm.ofdm_demodulate(x_t, 64, 16, 48)
    np.testing.assert_allclose(_np(Y), np.asarray(jofdm.ofdm_demodulate(
        jnp.asarray(x_j), 64, 16, 48)), atol=1e-5)
    np.testing.assert_allclose(_np(Y), X, atol=1e-5)
    tx, rx = torch.from_numpy(X[0, 0]), torch.from_numpy(X[0, 0] * X[1, 0])
    H = tofdm.estimate_channel(rx, tx)
    np.testing.assert_allclose(_np(H), X[1, 0], rtol=1e-5)
    np.testing.assert_allclose(_np(tofdm.equalize(rx, H)), X[0, 0],
                               rtol=1e-5)


@pytest.mark.parametrize("offset,cfo", [(130, 0.0), (421, 0.003),
                                        (57, -0.0061)])
def test_schmidl_cox_equals_jax(offset, cfo):
    rng = np.random.default_rng(offset)
    pre = tofdm.schmidl_cox_preamble(64, 16)
    body = np.asarray(jofdm.ofdm_modulate(jnp.asarray(
        np.exp(0.5j * np.pi * rng.integers(0, 4, (4, 48)))
        .astype(np.complex64)), 64, 16, 48))
    s = np.concatenate([np.zeros(offset, np.complex64), pre, body,
                        np.zeros(200, np.complex64)])
    s = s * np.exp(2j * np.pi * cfo * np.arange(len(s)))
    s = (s + 0.01 * _cn(rng, len(s))).astype(np.complex64)
    M_t, P_t = tofdm.schmidl_cox_metric(torch.from_numpy(s), 64)
    M_j, P_j = jofdm.schmidl_cox_metric(jnp.asarray(s), 64)
    np.testing.assert_allclose(_np(M_t), np.asarray(M_j),
                               atol=1e-4 * float(np.max(M_j)))
    np.testing.assert_allclose(_np(P_t), np.asarray(P_j),
                               atol=1e-4 * float(np.abs(P_j).max()))
    st_t, cfo_t = tofdm.schmidl_cox_sync(torch.from_numpy(s), 64, 16)
    st_j, cfo_j = jofdm.schmidl_cox_sync(jnp.asarray(s), 64, 16)
    assert int(st_t) == int(st_j)
    assert abs(float(cfo_t) - float(cfo_j)) < 1e-6
    assert abs(int(st_t) - (offset + 16)) <= 4 and abs(float(cfo_t) - cfo) \
        < 5e-4


def test_pilot_layout_and_receive_equal_jax():
    coords_t = top.active_carrier_coords(64, 48)
    np.testing.assert_array_equal(coords_t, jop.active_carrier_coords(64, 48))
    for spacing, offset in ((6, 0), (4, 1), (8, 3)):
        for a, b in zip(top.comb_pilot_indices(48, spacing, offset, coords_t),
                        jop.comb_pilot_indices(48, spacing, offset,
                                               coords_t)):
            np.testing.assert_array_equal(a, b)
    pil, dat = top.comb_pilot_indices(48, 6, coords=coords_t)
    np.testing.assert_array_equal(top.pilot_values(len(pil)),
                                  jop.pilot_values(len(pil)))
    W = top.interp_matrix(pil, 48, coords_t)
    np.testing.assert_array_equal(W, jop.interp_matrix(pil, 48, coords_t))
    np.testing.assert_array_equal(top.interp_matrix(pil, 48),
                                  jop.interp_matrix(pil, 48))
    with pytest.raises(ValueError):
        top.comb_pilot_indices(48, 1)
    rng = np.random.default_rng(3)
    pv = top.pilot_values(len(pil))
    data = _cn(rng, 6, len(dat))
    g_t = top.insert_pilots(torch.from_numpy(data), torch.from_numpy(pv),
                            pil, dat, 48)
    g_j = np.asarray(jop.insert_pilots(jnp.asarray(data), jnp.asarray(pv),
                                       pil, dat, 48))
    np.testing.assert_array_equal(_np(g_t), g_j)
    H = np.exp(1j * np.linspace(0, 2, 48)).astype(np.complex64) * 0.8
    rx = (g_j * H * np.exp(0.3j) + 0.01 * _cn(rng, 6, 48)).astype(
        np.complex64)
    out_t = top.ofdm_pilot_receive(torch.from_numpy(rx), torch.from_numpy(pv),
                                   pil, dat, torch.from_numpy(W), 1e3)
    out_j = jop.ofdm_pilot_receive(jnp.asarray(rx), jnp.asarray(pv), pil,
                                   dat, jnp.asarray(W), 1e3)
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-5)
    out0 = top.ofdm_pilot_receive(torch.from_numpy(rx), pv, pil, dat, W,
                                  cpe_track=False)
    assert not _np(out0[2]).any()


def _channel(tx, rng, delay=300, cfo=0.0012, snr_db=25.0):
    """tests/test_ofdm_link.py's channel: delay, a 5-tap multipath, CFO and
    AWGN at snr_db."""
    tx = np.asarray(tx)
    s = np.concatenate([np.zeros(delay, np.complex64), tx,
                        np.zeros(200, np.complex64)])
    s = np.convolve(s, np.array([1.0, 0, 0.3 - 0.2j, 0, 0.1j]))[: len(s)]
    s = s * np.exp(2j * np.pi * cfo * np.arange(len(s)))
    sigma = np.sqrt(np.mean(np.abs(tx) ** 2) * 10 ** (-snr_db / 10) / 2)
    return (s + sigma * (rng.standard_normal(len(s)) + 1j
                         * rng.standard_normal(len(s)))).astype(np.complex64)


@pytest.fixture(scope="module")
def modems():
    return {(s, m, f): (OFDMModem(48, scheme=s, m=m, fec_scheme=f,
                                  device=CPU),
                        JOFDMModem(48, scheme=s, m=m, fec_scheme=f))
            for s, m, f in (("psk", 4, "conv"), ("qam", 16, "conv"),
                            ("qam", 16, "ldpc"))}


@pytest.mark.parametrize("key,snr", [(("psk", 4, "conv"), 14.0),
                                     (("qam", 16, "conv"), 20.0),
                                     (("qam", 16, "ldpc"), 20.0)])
def test_ofdm_modem_equals_jax(modems, key, snr):
    t, j = modems[key]
    for name in ("pilot_idx", "data_idx", "pilots", "ref_syms", "preamble",
                 "points"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    for name in ("n_info", "n_coded", "ileave", "n_ofdm", "n_fill",
                 "n_data_syms", "frame_samples", "n_pad_bits"):
        assert getattr(t, name) == getattr(j, name), name
    assert repr(t) == repr(j)
    rng = np.random.default_rng(int(snr) + len(key[2]))
    for trial in range(2):
        data = rng.integers(0, 256, 48, dtype=np.uint8).tobytes()
        tx_t = t.transmit(data)
        tx_j = np.asarray(j.transmit(data))
        assert tx_t.dtype == torch.complex64
        np.testing.assert_allclose(_np(tx_t), tx_j, atol=1e-5)
        rx = _channel(tx_j, rng, int(rng.integers(100, 600)),
                      float(rng.uniform(-2e-3, 2e-3)), snr)
        out_t, info_t = t.receive(rx)
        out_j, info_j = j.receive(jnp.asarray(rx))
        assert info_t["crc_ok"] and out_t == data
        assert (out_t, info_t["crc_ok"], info_t["start"]) == (
            out_j, info_j["crc_ok"], info_j["start"])
        assert abs(info_t["cfo"] - info_j["cfo"]) < 1e-6
    with pytest.raises(ValueError):
        t.transmit(b"short")


def test_ofdm_modem_stream_and_flags_equal_jax(modems):
    t, j = modems[("psk", 4, "conv")]
    rng = np.random.default_rng(12)
    payloads = [rng.integers(0, 256, 48, dtype=np.uint8).tobytes()
                for _ in range(3)]
    parts = [np.zeros(250, np.complex64)]
    for p in payloads:
        parts += [np.asarray(j.transmit(p)), np.zeros(300, np.complex64)]
    s = np.concatenate(parts)
    s = (s + 0.02 * _cn(rng, len(s))).astype(np.complex64)
    res_t = t.receive_stream(s)
    res_j = j.receive_stream(jnp.asarray(s))
    assert [(d, i["crc_ok"], i["offset"]) for d, i in res_t] == \
        [(d, i["crc_ok"], i["offset"]) for d, i in res_j]
    assert [d for d, _ in res_t] == payloads
    # heavy noise is flagged, never silently wrong
    noisy = _channel(j.transmit(payloads[0]), rng, snr_db=-2.0)
    out, info = t.receive(noisy)
    assert info["crc_ok"] == j.receive(jnp.asarray(noisy))[1]["crc_ok"]
    assert not info["crc_ok"] or out == payloads[0]
    with pytest.raises(ValueError):
        OFDMModem(fec_scheme="turbo", device=CPU)
