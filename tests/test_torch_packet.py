"""Port vs JAX package: models/packet.py (PacketModem) on the CPU, with
every ``fec_scheme`` JAX takes.

Gates: the frame layout (interleaver dimensions, pilot positions and
symbols, preamble, sizes) equal to JAX's exactly; the transmitted burst
within 1e-5 of JAX's (complex64 RRC shaping; complex128 at 1e-12); a JAX
burst through tests/test_packet.py's channel (an offset, CFO, phase and
AWGN) decoded with every payload and its detected start back at those
operating points, for ``conv`` (the soft Viterbi walk), ``ldpc``,
``polar``, ``turbo`` and the block codes; for ``conv``, ``ldpc`` and
``g2412`` also exactly as JAX's receive decodes it (CRC flag, bytes,
start: JAX compiles each modem's receive afresh, some 7 s, and the polar
and turbo decoders are held against JAX in tests/test_torch_codes.py);
noise flagged, never passed; ``receive_stream`` equal to JAX's on several
bursts, and nothing found in a quiet stream.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.models import channel as jch
from solid_dsp_tpu.models.packet import PacketModem as JPacketModem
from solid_dsp_tpu_torch.models.packet import PacketModem

CPU = "cpu"


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _embed(burst, offset, n_total, rng, cfo, phase, sigma):
    """tests/test_packet.py's channel: the burst at ``offset`` in
    ``n_total`` samples, rotated by a CFO and phase, plus complex AWGN."""
    x = np.zeros(n_total, complex)
    x[offset: offset + len(burst)] = np.asarray(burst)
    x = np.array(jch.apply_cfo(jnp.asarray(x), cfo, phase))
    return (x + sigma * (rng.normal(size=n_total) + 1j
                         * rng.normal(size=n_total))).astype(np.complex64)


# (fec_scheme, payload bytes, scheme, m, offset, cfo, phase, sigma): the
# JAX tests' operating points (tests/test_packet.py)
CASES = {
    "conv": ("conv", 32, "psk", 4, 254, 6e-4, 1.1, 0.09),
    "conv_qam16": ("conv", 40, "qam", 16, 91, 0.0, 0.0, 0.02),
    "ldpc": ("ldpc", 48, "psk", 4, 150, -3e-4, 0.2, 0.1),
    "polar": ("polar", 64, "psk", 4, 233, -4e-4, 0.6, 0.12),
    "turbo": ("turbo", 24, "psk", 4, 120, 2e-4, -0.3, 0.1),
    "g2412": ("g2412", 32, "psk", 4, 301, 3e-4, 0.4, 0.10),
    "h128": ("h128", 16, "psk", 4, 77, 0.0, 0.0, 0.03),
    "none": ("none", 16, "psk", 4, 77, 0.0, 0.0, 0.03),
    "rep3": ("rep3", 16, "psk", 4, 60, 1e-4, 0.0, 0.08),
}
JAX_RX = ("conv", "ldpc", "g2412")


@pytest.mark.parametrize("case", list(CASES))
def test_packet_modem_equals_jax(case):
    fec, nb, scheme, m, off, cfo, ph, sigma = CASES[case]
    kw = dict(payload_bytes=nb, scheme=scheme, m=m, fec_scheme=fec,
              turbo_iters=4)
    t, j = PacketModem(**kw, device=CPU), JPacketModem(**kw)
    for name in ("n_info", "n_coded", "ileave", "n_pad", "n_symbols",
                 "flush", "payload_samples", "frame_samples"):
        assert getattr(t, name) == getattr(j, name), name
    for name in ("pilot_pos", "data_pos", "pilot_syms"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    np.testing.assert_array_equal(t.sync.full_preamble(),
                                  j.sync.full_preamble())
    rng = np.random.default_rng(len(case) + nb)
    data = bytes(rng.integers(0, 256, nb, dtype=np.uint8))
    tx_t = t.transmit(data)
    tx_j = np.asarray(j.transmit(data))
    assert tx_t.dtype == torch.complex64 and tx_t.shape == tx_j.shape
    np.testing.assert_allclose(_np(tx_t), tx_j, atol=1e-5)
    # the slice receive_stream cuts around a burst: 2 L = 254 each side
    x = _embed(tx_j, off, len(tx_j) + 508, rng, cfo, ph, sigma)
    got_t, info_t = t.receive(torch.from_numpy(x))
    assert info_t["crc_ok"] and got_t == data, case
    assert int(info_t["start"]) == off
    if case in JAX_RX:
        got_j, info_j = j.receive(jnp.asarray(x))
        assert (got_t, info_t["crc_ok"], int(info_t["start"])) == (
            got_j, info_j["crc_ok"], int(info_j["start"]))


def test_packet_complex128_and_validation():
    t = PacketModem(payload_bytes=32, dtype=torch.complex128, device=CPU)
    j = JPacketModem(payload_bytes=32, dtype=jnp.complex128)
    data = bytes(range(32))
    tx = t.transmit(data)
    np.testing.assert_allclose(_np(tx), np.asarray(j.transmit(data)),
                               atol=1e-12)
    got, info = t.receive(tx)
    assert info["crc_ok"] and got == data
    with pytest.raises(ValueError):
        t.transmit(b"short")
    with pytest.raises(ValueError):
        PacketModem(fec_scheme="nope", device=CPU)
    with pytest.raises(ValueError):
        PacketModem(pilot_every=1, device=CPU)
    p0 = PacketModem(payload_bytes=16, pilot_every=0, device=CPU)
    assert p0.n_symbols == p0.n_data_symbols
    got, info = p0.receive(p0.transmit(bytes(16)))
    assert info["crc_ok"] and got == bytes(16)


def test_packet_stream_and_garbage_equal_jax():
    t, j = PacketModem(payload_bytes=32, device=CPU), \
        JPacketModem(payload_bytes=32)
    rng = np.random.default_rng(21)
    payloads = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
                for _ in range(3)]
    parts = [np.zeros(500, np.complex64)]
    for p in payloads:
        parts += [np.asarray(j.transmit(p)),
                  np.zeros(int(rng.integers(200, 800)), np.complex64)]
    s = np.concatenate(parts)
    s = (s + 0.05 * (rng.standard_normal(len(s)) + 1j
                     * rng.standard_normal(len(s)))).astype(np.complex64)
    res_t = t.receive_stream(torch.from_numpy(s))
    res_j = j.receive_stream(jnp.asarray(s))
    assert [(d, i["crc_ok"], i["offset"]) for d, i in res_t] == \
        [(d, i["crc_ok"], i["offset"]) for d, i in res_j]
    assert [d for d, _ in res_t] == payloads
    q = (0.05 * (rng.standard_normal(3000) + 1j
                 * rng.standard_normal(3000))).astype(np.complex64)
    assert t.receive_stream(q) == []
    noise = (rng.normal(size=t.frame_samples + 300) + 1j * rng.normal(
        size=t.frame_samples + 300)).astype(np.complex64)
    assert not t.receive(noise)[1]["crc_ok"]
    assert not j.receive(jnp.asarray(noise))[1]["crc_ok"]
