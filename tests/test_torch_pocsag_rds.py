"""Port vs JAX package on the CPU: POCSAG and RDS, alone and as receivers
behind the receive chain.

Every case of tests/test_pocsag.py and test_rds.py runs through both
packages.  Gates: BCH(31,21) codewords, syndrome decodes, POCSAG bits, RDS
checkwords, syndromes and group bits equal; ``pocsag_transmit`` and
``rds_modulate`` within 1e-6 (the port's FSK phase accumulates in float64
as JAX's does under 64-bit mode; ``rds_modulate`` is bit-equal);
``rds_demodulate_bits`` bit-equal to JAX's on test_rds.py's MPX and on
noisier ones; pages and groups identical.

The two composed receivers at small size, the JAX chain against the
port's on the CPU, each decoded by its own package:

* broadcast FM with RDS: a stereo MPX (L 1 kHz, R 3 kHz, pilot 0.1, RDS
  0.06 carrying PS group sets) FM-modulated at 75 kHz deviation at
  +250 kHz in a 1.824 Msps capture with AWGN at 30 dB CNR, through config
  4's geometry (M = 4, 64 taps, block AGC, FM, planar, fused, x3) tuned to
  the station, in 5 blocks of 2^18 with the state carried, then
  ``rds_receive`` at 456 kHz;
* a POCSAG pager channel: one page as CPFSK at 1200 baud, +-4.5 kHz, at
  +40 kHz in a 307.2 kHz capture with AWGN, through the chain with
  ``demod="none"`` at M = 8 (64 taps, cutoff 0.04), then
  ``pocsag_receive`` at 38.4 kHz (32 samples a bit).

The decoded results must be identical.
"""

import numpy as np
import pytest
import torch

from solid_dsp_tpu.models import pocsag as jpg
from solid_dsp_tpu.models import rds as jrds
from solid_dsp_tpu_torch.models import pocsag, rds
from torch_parity import run_jax, run_torch

WAVE_ATOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------- POCSAG

def test_constants_match_jax():
    assert pocsag.SYNC_WORD == jpg.SYNC_WORD
    assert pocsag.IDLE_WORD == jpg.IDLE_WORD
    assert pocsag.BCH_GEN == jpg.BCH_GEN


def test_bch_known_constants():
    for w in (pocsag.SYNC_WORD, pocsag.IDLE_WORD):
        data, ok = pocsag.bch3121_syndrome_decode(w)
        assert ok
        assert pocsag.bch3121_encode(data) == w


def test_bch_encode_and_decode_match_jax():
    """Codewords equal, and the decode of every 0-3 bit error pattern (and
    a flipped parity bit) equal to JAX's, flag included."""
    rng = np.random.default_rng(0)
    for _ in range(200):
        data = int(rng.integers(0, 1 << 21))
        cw = pocsag.bch3121_encode(data)
        assert cw == jpg.bch3121_encode(data)
        for n_err in (0, 1, 2, 3):
            bad = cw
            for p in rng.choice(32, n_err, replace=False):
                bad ^= 1 << int(p)
            assert (pocsag.bch3121_syndrome_decode(bad)
                    == jpg.bch3121_syndrome_decode(bad))


def test_bch_corrects_up_to_two_errors():
    rng = np.random.default_rng(0)
    for _ in range(50):
        data = int(rng.integers(0, 1 << 21))
        cw = pocsag.bch3121_encode(data)
        for n_err in (0, 1, 2):
            bad = cw
            for p in rng.choice(31, n_err, replace=False):
                bad ^= 1 << (int(p) + 1)
            got, ok = pocsag.bch3121_syndrome_decode(bad)
            assert ok and got == data, (data, n_err)


def test_three_errors_mostly_flagged_not_miscorrected():
    rng = np.random.default_rng(4)
    silent_wrong = 0
    for _ in range(500):
        data = int(rng.integers(0, 1 << 21))
        cw = pocsag.bch3121_encode(data)
        bad = cw
        for p in rng.choice(31, 3, replace=False):
            bad ^= 1 << (int(p) + 1)
        got, ok = pocsag.bch3121_syndrome_decode(bad)
        silent_wrong += ok and got != data
    assert silent_wrong == 0


@pytest.mark.parametrize("address,message,function", [
    (1300123, "HELLO POCSAG", 2), (0, "", 0), (7, "AB", 3),
    (2097151, "", 1), (8, "X" * 42, 0), (123456, "lower case ~{|}", 1)])
def test_pocsag_encode_matches_jax(address, message, function):
    got = pocsag.pocsag_encode(address, message, function)
    want = jpg.pocsag_encode(address, message, function)
    assert got.dtype == want.dtype == np.int8
    np.testing.assert_array_equal(got, want)


def test_bits_roundtrip_with_errors():
    bits = pocsag.pocsag_encode(1300123, "HELLO POCSAG", function=2)
    rng = np.random.default_rng(1)
    bad = bits.copy()
    for w in (1, 3, 5):
        bad[576 + 32 * w + int(rng.integers(1, 31))] ^= 1
    pages = pocsag.pocsag_decode_bits(bad[500:])
    assert pages == jpg.pocsag_decode_bits(bad[500:])
    assert len(pages) == 1
    pg = pages[0]
    assert (pg["address"], pg["function"], pg["message"]) == (
        1300123, 2, "HELLO POCSAG")


def test_decode_bits_matches_jax_on_streams():
    """Several transmissions back to back, noise bits between, errors
    inside: the same pages (corrections and failures included)."""
    rng = np.random.default_rng(7)
    parts = [rng.integers(0, 2, 61).astype(np.int8)]
    for k in range(6):
        b = pocsag.pocsag_encode(int(rng.integers(0, 1 << 21)),
                                 "MSG %d" % k, k & 3).copy()
        for _ in range(k):
            b[576 + int(rng.integers(0, 17 * 32))] ^= 1
        parts += [b, rng.integers(0, 2, int(rng.integers(0, 90)))
                  .astype(np.int8)]
    stream = np.concatenate(parts)
    for cut in (0, 33, len(stream) - 200):
        assert (pocsag.pocsag_decode_bits(stream[cut:])
                == jpg.pocsag_decode_bits(stream[cut:]))
    assert pocsag.pocsag_decode_bits(stream[:100]) == []


def test_address_and_capacity_validated():
    for mod in (pocsag, jpg):
        with pytest.raises(ValueError, match="21 bits"):
            mod.pocsag_encode(1 << 21, "X")
        with pytest.raises(ValueError, match="codewords"):
            mod.pocsag_encode(7, "X" * 50)


@pytest.mark.parametrize("sps,separation", [(8, 0.1), (32, 9000 / 38400)])
def test_pocsag_transmit_matches_jax(sps, separation):
    got = pocsag.pocsag_transmit(2080774, "PAGE ME", sps, separation)
    want = np.asarray(jpg.pocsag_transmit(2080774, "PAGE ME", sps,
                                          separation))
    assert got.dtype == np.complex64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=WAVE_ATOL)


@pytest.mark.parametrize("tail", [0, 5])
def test_full_fsk_link(tail):
    """tests/test_pocsag.py's link, and a ragged length cut to whole
    symbols as JAX cuts it."""
    iq = pocsag.pocsag_transmit(2080774, "PAGE ME", sps=8)
    rng = np.random.default_rng(2)
    noisy = ((iq + 0.1 * (rng.standard_normal(len(iq))
                          + 1j * rng.standard_normal(len(iq))))
             * np.exp(1j * 0.6)).astype(np.complex64)
    noisy = np.concatenate([noisy, noisy[:tail]])
    pages = pocsag.pocsag_receive(_t(noisy), sps=8)
    assert pages == jpg.pocsag_receive(noisy, sps=8)
    assert len(pages) == 1
    assert pages[0]["address"] == 2080774
    assert pages[0]["message"] == "PAGE ME"


def test_pocsag_receive_takes_numpy():
    iq = pocsag.pocsag_transmit(77, "NUMPY", sps=8)
    assert pocsag.pocsag_receive(iq, 8) == jpg.pocsag_receive(iq, 8)


# ---------------------------------------------------------------- RDS

def test_rds_constants_match_jax():
    assert rds.OFFSET_WORDS == jrds.OFFSET_WORDS
    assert rds.RDS_GEN == jrds.RDS_GEN


def test_checkword_syndrome_match_jax():
    rng = np.random.default_rng(0)
    for off in rds.OFFSET_WORDS:
        for _ in range(40):
            info = int(rng.integers(0, 1 << 16))
            cw = rds.rds_checkword(info, off)
            assert cw == jrds.rds_checkword(info, off)
            blk = (info << 10) | cw
            assert rds.rds_syndrome(blk, off) == 0
            bad = blk ^ (1 << int(rng.integers(0, 26)))
            assert rds.rds_syndrome(bad, off) == jrds.rds_syndrome(bad, off)
            assert rds.rds_syndrome(bad, off) != 0


def test_group_bits_match_jax():
    rng = np.random.default_rng(1)
    for _ in range(10):
        infos = [int(v) for v in rng.integers(0, 1 << 16, 4)]
        np.testing.assert_array_equal(rds.encode_group(infos),
                                      jrds.encode_group(infos))
    for pi, name in ((0x52A1, "SOLIDDSP"), (0xBEEF, "RADIO 99"),
                     (0x1234, "AB")):
        got = rds.make_ps_groups(pi, name)
        assert got.dtype == np.int8
        np.testing.assert_array_equal(got, jrds.make_ps_groups(pi, name))


def test_group_encode_and_block_sync():
    rng = np.random.default_rng(1)
    bits = rds.make_ps_groups(0x52A1, "SOLIDDSP")
    pre = rng.integers(0, 2, 37).astype(np.int8)
    post = rng.integers(0, 2, 23).astype(np.int8)
    stream = np.concatenate([pre, bits, post])
    groups = rds.block_sync_decode(stream)
    assert groups == jrds.block_sync_decode(stream)
    assert len(groups) == 4
    info = rds.parse_groups(groups)
    assert info == jrds.parse_groups(groups)
    assert info["pi"] == 0x52A1 and info["ps"] == "SOLIDDSP"


@pytest.mark.parametrize("seed", range(4))
def test_block_sync_matches_jax_walk(seed):
    """The vectorised sync against JAX's greedy walk: groups back to back
    and apart, bit errors inside, random filler, lengths around 104, and
    a group a few bits after another's start (the jump of 104 skips it)."""
    rng = np.random.default_rng(seed)
    parts = []
    for k in range(12):
        g = jrds.encode_group([int(v) for v in rng.integers(0, 1 << 16, 4)])
        if k % 4 == 1:
            g = g.copy()
            g[int(rng.integers(0, 104))] ^= 1
        parts.append(g)
        if k % 3 == 0:
            parts.append(rng.integers(0, 2, int(rng.integers(0, 40)))
                         .astype(np.int8))
    stream = np.concatenate(parts)
    overlap = np.concatenate([stream[:150], stream[:104], stream[:120]])
    for b in (stream, overlap, stream[:103], stream[:104], stream[:105],
              stream[7:], np.zeros(0, np.int8)):
        assert rds.block_sync_decode(b) == jrds.block_sync_decode(b)


def test_rds_modulate_matches_jax():
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, 300).astype(np.int8)
    for fs, ph in ((228000.0, 0.0), (456000.0, 0.37), (1824000.0, -1.1)):
        got = rds.rds_modulate(bits, fs, ph)
        want = jrds.rds_modulate(bits, fs, ph)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=WAVE_ATOL)
    assert rds.rds_modulate(np.zeros(0, np.int8), 228000.0).shape == (0,)


def test_modulate_validates_rate():
    for mod in (rds, jrds):
        with pytest.raises(ValueError):
            mod.rds_modulate(np.zeros(104, np.int8), 200000.0)
        with pytest.raises(ValueError):          # 57 samples a bit: odd
            mod.rds_modulate(np.zeros(104, np.int8), 1187.5 * 57)


def _test_mpx(fs, seed=2, noise=0.002, reps=2, n_extra=0):
    bits = np.tile(jrds.make_ps_groups(0xBEEF, "RADIO 99"), reps)
    sig = jrds.rds_modulate(bits, fs)
    n = np.arange(len(sig) + n_extra)
    sig = np.concatenate([sig, np.zeros(n_extra, np.float32)])
    rng = np.random.default_rng(seed)
    audio = 0.4 * np.sin(2 * np.pi * 1000.0 / fs * n)
    pilot = 0.1 * np.sin(2 * np.pi * 19000.0 / fs * n)
    return (audio + pilot + 0.06 * sig
            + noise * rng.standard_normal(len(sig))).astype(np.float32)


@pytest.mark.parametrize("fs,noise,n_extra", [
    (228000.0, 0.002, 0), (228000.0, 0.05, 77), (456000.0, 0.02, 1000),
    (228000.0, 0.3, 0)])
def test_rds_demodulate_bits_bit_equal_to_jax(fs, noise, n_extra):
    mpx = _test_mpx(fs, noise=noise, n_extra=n_extra)
    got = rds.rds_demodulate_bits(_t(mpx), fs)
    want = jrds.rds_demodulate_bits(mpx, fs)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)


def test_rds_demodulate_short_input():
    for n in (0, 100, 191):
        mpx = np.zeros(n, np.float32)
        assert rds.rds_demodulate_bits(mpx, 228000.0).shape == (0,)
        assert jrds.rds_demodulate_bits(mpx, 228000.0).shape == (0,)


def test_mpx_modem_roundtrip():
    fs = 228000.0
    mpx = _test_mpx(fs)
    out = rds.rds_receive(_t(mpx), fs)
    assert out == jrds.rds_receive(mpx, fs)
    assert out["pi"] == 0xBEEF and out["ps"] == "RADIO 99"
    assert out["n_groups"] >= 6
    none = rds.rds_receive(np.zeros(50000, np.float32), fs)
    assert none == jrds.rds_receive(np.zeros(50000, np.float32), fs)
    assert none == {"pi": None, "ps": "", "n_groups": 0}


@pytest.mark.parametrize("freq,fs", [(19000.0, 456000.0),
                                     (57000.0, 1824000.0),
                                     (19000.0, 250000.0 / 3.0)])
def test_oscillator_exact(freq, fs):
    """The exact wrapped oscillator (integer residues where f / fs is a
    small rational, the host's float64 otherwise) against float64
    numpy: within complex64's rounding."""
    n = 100_003
    got = rds._oscillator(n, freq, fs, -1.0, "cpu").numpy()
    want = np.exp(-2j * np.pi * ((freq / fs) * np.arange(n) % 1.0))
    assert got.dtype == np.complex64
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)


# ------------------------------------------- the composed receivers

FS_RDS = 1_824_000.0
STATION_HZ = 250_000.0
L_BLOCK = 1 << 18


def _rds_capture(rng, n_blocks: int) -> np.ndarray:
    """(2, n_blocks L_BLOCK) planar f32: stereo FM with RDS (PS group sets
    repeated) at +250 kHz, 30 dB CNR."""
    spb = int(FS_RDS / 1187.5)
    need = -(-n_blocks * L_BLOCK // spb)
    sets = jrds.make_ps_groups(0x52A1, "SOLIDDSP")
    bits = np.tile(sets, -(-need // len(sets)))[:need]
    rds_sig = jrds.rds_modulate(bits, FS_RDS).astype(np.float64)
    n = np.arange(len(rds_sig))
    th = 2 * np.pi * ((19000.0 / FS_RDS) * n % 1.0)
    left = np.sin(2 * np.pi * ((1000.0 / FS_RDS) * n % 1.0))
    right = np.sin(2 * np.pi * ((3000.0 / FS_RDS) * n % 1.0))
    mpx = (0.45 * (left + right) + 0.1 * np.sin(th)
           + 0.45 * (left - right) * np.sin(2 * th) + 0.06 * rds_sig)
    mpx = mpx / np.max(np.abs(mpx))
    phase = 2 * np.pi * (75e3 / FS_RDS) * np.cumsum(mpx)
    phase += 2 * np.pi * ((STATION_HZ / FS_RDS) * n % 1.0)
    iq = np.exp(1j * phase)
    sigma = np.sqrt(10 ** (-30 / 10) / 2)
    iq += sigma * (rng.standard_normal(len(n)) + 1j * rng.standard_normal(
        len(n)))
    L = n_blocks * L_BLOCK
    return np.stack([iq.real[:L], iq.imag[:L]]).astype(np.float32)


def test_rds_receiver_behind_the_chain_matches_jax():
    rng = np.random.default_rng(43)
    x = _rds_capture(rng, n_blocks=5)
    blocks = np.split(x, x.shape[1] // L_BLOCK, axis=1)
    cfg = dict(carrier_freq=2 * np.pi * STATION_HZ / FS_RDS, fir_taps=64,
               fir_cutoff=0.1)
    want_mpx, _ = run_jax(blocks, ddc_engine="xla", **cfg)
    got_mpx, _ = run_torch(blocks, **cfg)
    fs_mpx = FS_RDS / 4
    want = jrds.block_sync_decode(jrds.rds_demodulate_bits(want_mpx, fs_mpx))
    got = rds.block_sync_decode(rds.rds_demodulate_bits(_t(got_mpx),
                                                        fs_mpx))
    assert got == want
    info = rds.parse_groups(got)
    assert info["pi"] == 0x52A1 and info["ps"] == "SOLIDDSP"
    assert len(got) >= 6


FS_PAGER = 307_200.0
PAGER_HZ = 40_000.0
M_PAGER = 8
SPS_PAGER = 32


def _pager_capture(rng, address, message, function) -> np.ndarray:
    bits = jpg.pocsag_encode(address, message, function)
    sps = SPS_PAGER * M_PAGER
    pad = -(len(bits) + 40) % ((1 << 16) // sps)
    bits = np.concatenate([np.tile([1, 0], 20), bits, np.zeros(pad, int)])
    f = np.repeat(np.where(bits == 0, 4500.0, -4500.0), sps) / FS_PAGER
    n = np.arange(len(f))
    phase = 2 * np.pi * (np.cumsum(f) + (PAGER_HZ / FS_PAGER) * n % 1.0)
    iq = 0.3 * np.exp(1j * phase) + 0.01 * (
        rng.standard_normal(len(n)) + 1j * rng.standard_normal(len(n)))
    return np.stack([iq.real, iq.imag]).astype(np.float32)


def test_pocsag_receiver_behind_the_chain_matches_jax():
    rng = np.random.default_rng(44)
    x = _pager_capture(rng, 1234560, "CALL 555 0100", 3)
    blocks = np.split(x, x.shape[1] // (1 << 16), axis=1)
    cfg = dict(carrier_freq=2 * np.pi * PAGER_HZ / FS_PAGER,
               decimation=M_PAGER, fir_taps=64, fir_cutoff=0.04,
               demod="none")
    want_z, _ = run_jax(blocks, ddc_engine="xla", **cfg)
    got_z, _ = run_torch(blocks, **cfg)
    sep = 9000.0 / (FS_PAGER / M_PAGER)
    want = jpg.pocsag_receive(want_z, SPS_PAGER, sep)
    got = pocsag.pocsag_receive(_t(got_z), SPS_PAGER, sep)
    assert got == want
    assert [(p["address"], p["function"], p["message"]) for p in got] == [
        (1234560, 3, "CALL 555 0100")]
