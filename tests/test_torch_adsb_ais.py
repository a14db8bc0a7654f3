"""Port vs JAX package: the ADS-B / Mode S decoder and the AIS receiver on
the CPU.

Gates (tests/test_adsb.py and tests/test_ais.py): the CRC-24 matrices equal
to JAX's and to a bit-serial long division; every clean DF17 frame's
remainder zero, any flipped bit's not, the remainders equal to JAX's; the
PPM demodulation of a clean frame exact with confidence > 0.99 and within
1e-6 of JAX's; the preamble score within 1e-5 of JAX's; the decoded frames
of tests/test_adsb.py's noisy multi-frame stream, complex IQ and truncated
capture equal to JAX's (start, DF, ICAO, bits, CRC flag; confidence within
1e-5), every CRC passing.  AIS: the X.25 check value 0x906E, NRZI and
stuffing round trips and the flag framing equal to JAX's; the GMSK burst
within 1e-4 of JAX's (a float32 phase summed in another order); a noisy,
rotated burst and a two-frame stream received as JAX receives them, every
CRC passing and the position report's fields back.
"""

import jax.numpy as jnp
import numpy as np
import torch

from solid_dsp_tpu.models import adsb as jadsb
from solid_dsp_tpu.models import ais as jais
from solid_dsp_tpu_torch.models import adsb, ais

CPU = "cpu"


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _crc24_bitserial(bits):
    v = 0
    for b in bits:
        v = (v << 1) | int(b)
    v <<= 24
    for d in range(len(bits) - 1 + 24, 23, -1):
        if v >> d & 1:
            v ^= adsb.MODE_S_GENERATOR << (d - 24)
    return v


def _frames_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g["start"], g["df"], g["icao"], g["crc_ok"]) == (
            w["start"], w["df"], w["icao"], w["crc_ok"])
        np.testing.assert_array_equal(g["bits"], np.asarray(w["bits"]))
        assert abs(g["confidence"] - w["confidence"]) < 1e-5


def test_crc24_matches_jax_and_bitserial():
    np.testing.assert_array_equal(adsb._R112, jadsb._R112)
    np.testing.assert_array_equal(adsb._R88, jadsb._R88)
    rng = np.random.default_rng(0)
    for _ in range(5):
        data = rng.integers(0, 2, 88)
        par = data @ adsb._R88 % 2
        assert int(par @ (1 << np.arange(23, -1, -1, dtype=np.int64))) == \
            _crc24_bitserial(data)
    frames = np.stack([adsb.encode_df17(0xABC123 + s, rng.integers(0, 2, 56))
                       for s in range(6)])
    np.testing.assert_array_equal(
        frames[0], jadsb.encode_df17(0xABC123, frames[0][32:88]))
    bad = frames.copy()
    bad[np.arange(6), rng.integers(0, 112, 6)] ^= 1
    both = np.concatenate([frames, bad])
    rem = adsb.crc24_remainder(torch.from_numpy(both))
    assert rem.dtype == torch.int32
    np.testing.assert_array_equal(
        _np(rem), np.asarray(jadsb.crc24_remainder(jnp.asarray(both))))
    ok = ~_np(rem).any(-1)
    assert ok[:6].all() and not ok[6:].any()


def test_ppm_and_preamble_match_jax():
    rng = np.random.default_rng(2)
    f = adsb.encode_df17(0x4840D6, rng.integers(0, 2, 56))
    env = adsb.ppm_modulate(f, 2)
    np.testing.assert_array_equal(env, jadsb.ppm_modulate(f, 2))
    p = (env + 0.05 * rng.random(len(env))).astype(np.float32) ** 2
    bits, conf = adsb.ppm_demod_frame(torch.from_numpy(p[32:]), 2)
    jbits, jconf = jadsb.ppm_demod_frame(jnp.asarray(p[32:]), 2)
    np.testing.assert_array_equal(_np(bits), f)
    np.testing.assert_array_equal(_np(bits), np.asarray(jbits))
    assert float(conf) > 0.9 and abs(float(conf) - float(jconf)) < 1e-6
    clean, cconf = adsb.ppm_demod_frame(torch.from_numpy(env[32:] ** 2), 2)
    np.testing.assert_array_equal(_np(clean), f)
    assert float(cconf) > 0.99
    np.testing.assert_allclose(
        _np(adsb.preamble_score(torch.from_numpy(p), 2)),
        np.asarray(jadsb.preamble_score(jnp.asarray(p), 2)), atol=1e-5)


def test_decode_streams_match_jax():
    rng = np.random.default_rng(3)
    stream = 0.05 * rng.random(20000).astype(np.float32)
    icaos, starts = [0x4840D6, 0x3C6444, 0xA1B2C3], [1500, 6000, 12000]
    for icao, s in zip(icaos, starts):
        env = adsb.ppm_modulate(adsb.encode_df17(icao, rng.integers(0, 2, 56)))
        stream[s: s + len(env)] += env
    power = stream ** 2
    got = adsb.decode(power, threshold=0.6, device=CPU)
    _frames_equal(got, jadsb.decode(power, threshold=0.6))
    ok = [fr for fr in got if fr["crc_ok"]]
    assert sorted(fr["icao"] for fr in ok) == sorted(icaos)
    assert all(fr["df"] == 17 for fr in ok)
    # complex IQ at an arbitrary phase
    f = adsb.encode_df17(0x123456, rng.integers(0, 2, 56))
    env = adsb.ppm_modulate(f, 2)
    x = np.zeros(2000, np.complex64)
    x[300: 300 + len(env)] = env * np.exp(1j * 0.7)
    x += (0.02 * (rng.standard_normal(2000) + 1j * rng.standard_normal(2000))
          ).astype(np.complex64)
    got = adsb.decode(x, threshold=0.6, device=CPU)
    _frames_equal(got, jadsb.decode(x, threshold=0.6))
    assert any(fr["crc_ok"] and fr["icao"] == 0x123456 for fr in got)
    # a strong false preamble near the end of a truncated capture
    n = len(env) + 100
    y = 0.02 * rng.random(n).astype(np.float32)
    y[50: 50 + len(env)] += env
    y[n - 40: n - 8] += 5.0 * env[:32]
    got = adsb.decode(y, threshold=0.6, device=CPU)
    _frames_equal(got, jadsb.decode(y, threshold=0.6))
    assert any(fr["crc_ok"] and fr["icao"] == 0x123456 for fr in got)
    assert adsb.decode(np.zeros(500, np.float32), device=CPU) == []


def test_ais_framing_matches_jax():
    data = np.unpackbits(np.frombuffer(b"123456789", np.uint8)[:, None],
                         axis=1, bitorder="little").reshape(-1)
    fcs = ais.crc16_x25_bits(data.astype(np.int8))
    assert int(np.sum(fcs.astype(np.int64) << np.arange(16))) == 0x906E
    rng = np.random.default_rng(1)
    b = rng.integers(0, 2, 300).astype(np.int8)
    np.testing.assert_array_equal(ais.nrzi_decode(ais.nrzi_encode(b)), b)
    np.testing.assert_array_equal(ais.nrzi_encode(b), jais.nrzi_encode(b))
    st = ais.hdlc_stuff(b)
    np.testing.assert_array_equal(st, jais.hdlc_stuff(b))
    np.testing.assert_array_equal(ais.hdlc_destuff(st), b)
    payload = rng.integers(0, 2, 168).astype(np.int8)
    wire = ais.ais_build_frame(payload)
    np.testing.assert_array_equal(wire, jais.ais_build_frame(payload))
    bad = wire.copy()
    bad[24 + 8 + 3] ^= 1
    for w in (wire, bad):
        got, want = ais.ais_find_frames(w[24:]), jais.ais_find_frames(w[24:])
        assert [ok for _, ok in got] == [ok for _, ok in want]
        for (g, _), (h, _) in zip(got, want):
            np.testing.assert_array_equal(g, h)
    assert ais.ais_find_frames(wire[24:])[0][1]
    assert not ais.ais_find_frames(bad[24:])[0][1]


def test_ais_link_matches_jax():
    payload = ais.build_type1_payload(244660123, 52.371, 4.895, 12.3, 87.5)
    np.testing.assert_array_equal(
        payload, jais.build_type1_payload(244660123, 52.371, 4.895, 12.3,
                                          87.5))
    iq = ais.ais_transmit(payload, sps=8, device=CPU)
    jiq = jais.ais_transmit(payload, sps=8)
    np.testing.assert_allclose(iq, jiq, atol=1e-4)
    rng = np.random.default_rng(3)
    noisy = (jiq + 0.05 * (rng.standard_normal(len(jiq)) + 1j
                           * rng.standard_normal(len(jiq)))) * np.exp(1.1j)
    noisy = noisy.astype(np.complex64)
    got = ais.ais_receive(noisy, sps=8, device=CPU)
    want = jais.ais_receive(noisy, sps=8)
    assert [ok for _, ok in got] == [ok for _, ok in want]
    ok = [p for p, good in got if good]
    assert len(ok) == 1
    msg = ais.parse_type123(ok[0])
    assert msg == jais.parse_type123(ok[0])
    assert msg["mmsi"] == 244660123 and abs(msg["lat_deg"] - 52.371) < 1e-5
    assert abs(msg["lon_deg"] - 4.895) < 1e-5
    p1 = ais.build_type1_payload(111111111, 10.0, 20.0)
    p2 = ais.build_type1_payload(222222222, -33.9, 151.2)
    gap = np.zeros(400, np.complex64)
    stream = np.concatenate([gap, ais.ais_transmit(p1, device=CPU), gap,
                             ais.ais_transmit(p2, device=CPU), gap])
    got = ais.ais_receive(stream.astype(np.complex64), device=CPU)
    assert sorted(ais.parse_type123(p)["mmsi"] for p, ok in got if ok) == \
        [111111111, 222222222]
    assert len(got) == len(jais.ais_receive(stream.astype(np.complex64)))
