"""The port's CLI (``python -m solid_dsp_tpu_torch``) against the JAX
package's, on the same recordings, with ``--device cpu``.

Tolerances: ``rx`` output >= 100 dB against the JAX CLI's for fm, am and
qpsk (tests/test_torch_rx_chain.py's gate at "highest", the CLI's
precision), on a recording whose last block is unaligned and whose end is
not a whole decimation period; the FM message correlates > 0.8
(tests/test_cli.py's gate).  ``--wav`` mono and ``--stereo``: equal frame
counts and PCM within 2 LSB.  ``demo``: the printed head equal to 1e-12.
``spectrum``: ``peak_freq`` equal, the dB figures within 0.01.
``convert``: identical bytes.  ``monitor`` (xla): events and summary equal.
``resample``: equal length and within 1e-5 of max|y| (the complex64 audio
tail's tolerance, tests/test_torch_fm_stereo_ddc.py), the tone read back.
``packets``: the JSON rows equal (offsets, CRC flags, payloads), on
tests/test_cli.py's recording and on OFDM bursts; an unsupported ``--fec``
for ``--phy ofdm`` returns 1 and a truncated OFDM capture prints JAX's error
row.  ``tx``: the JSON line equal and the recording within 1e-4 of the JAX
CLI's (cf32; ci16 within one count), at every ``--mod``; the port's ``rx``
reads its FM back (correlation > 0.8).  ``adsb`` and ``ais``: the JSON
lines and the stderr summary equal to the JAX CLI's on a recording of
DF17 frames (IQ, noise, ``--all``) and of two AIS bursts.
F2: the port's fused monitor takes blocks that are multiples of the channel
count but not of 8 channels' rows, which the JAX CLI's fused monitor
refuses.
"""

import json
import os
import re
import subprocess
import sys
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.__main__ import main as jax_main
from solid_dsp_tpu.models.fm import fm_modulate as jax_fm_modulate
from solid_dsp_tpu.models.fm import fm_stereo_mpx as jax_fm_stereo_mpx
from solid_dsp_tpu_torch.__main__ import main as port_main
from solid_dsp_tpu_torch.runtime import read_iq, write_iq
from torch_parity import snr_db

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RX = (1 << 15) + 1003          # an unaligned last block, a ragged end


def port(*argv):
    return port_main(["--device", "cpu", *argv])


def _fm_recording(n, carrier=0.2, tone=0.002, amp=0.5):
    msg = np.sin(2 * np.pi * tone * np.arange(n)).astype(np.float32)
    iq, _ = jax_fm_modulate(jnp.asarray(msg), 0.1)
    iq = np.asarray(iq) * amp * np.exp(1j * carrier * np.arange(n))
    return iq.astype(np.complex64), msg


def _am_recording(n):
    k = np.arange(n)
    x = 0.5 * (1 + 0.5 * np.cos(2 * np.pi * k / 4096)) * np.exp(0.2j * k)
    return x.astype(np.complex64)


def _qpsk_recording(n, seed=0):
    rng = np.random.default_rng(seed)
    gray = np.array([1 + 1j, -1 + 1j, 1 - 1j, -1 - 1j]) / np.sqrt(2.0)
    sym = rng.integers(0, 4, n // 32 + 1)
    k = np.arange(n)
    x = 0.5 * gray[sym[k // 32]] * np.exp(1j * (0.2 + 5e-4) * k)
    x += 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return x.astype(np.complex64)


def _run_both(argv_jax, argv_port, capsys):
    assert jax_main(argv_jax) == 0
    out_j = capsys.readouterr().out
    assert port(*argv_port) == 0
    out_p = capsys.readouterr().out
    return out_j, out_p


# ------------------------------------------------------------------- rx

@pytest.mark.parametrize("demod", ["fm", "am", "qpsk"])
def test_rx_matches_jax(tmp_path, capsys, demod):
    x = {"fm": lambda: _fm_recording(N_RX)[0], "am": lambda: _am_recording(
        N_RX), "qpsk": lambda: _qpsk_recording(N_RX)}[demod]()
    src = str(tmp_path / "in.ci16")
    write_iq(src, x, "ci16")
    args = [src, "--format", "ci16", "--demod", demod, "--block", "8192"]
    dj, dp = str(tmp_path / "j.cf32"), str(tmp_path / "p.cf32")
    _run_both(["rx", *args, "-o", dj], ["rx", *args, "-o", dp], capsys)
    want, got = read_iq(dj), read_iq(dp)
    assert got.shape == want.shape == (N_RX // 4,)
    assert snr_db(got, want) >= 100.0
    if demod == "fm":
        msg = _fm_recording(N_RX)[1][::4]
        assert np.corrcoef(got.real[512:], msg[512:len(got)])[0, 1] > 0.8


def test_rx_reads_stdin_through_a_pipe(tmp_path, capsys):
    """``rx -``: the recording piped into a fresh process equals the
    in-process run on the file, bit for bit."""
    x, _ = _fm_recording(1 << 14)
    src = str(tmp_path / "in.ci16")
    write_iq(src, x, "ci16")
    want = str(tmp_path / "file.cf32")
    assert port("rx", src, "--format", "ci16", "--block", "4096",
                "-o", want) == 0
    got = str(tmp_path / "pipe.cf32")
    env = {**os.environ, "PYTHONPATH": REPO}
    with open(src, "rb") as f:
        r = subprocess.run(
            [sys.executable, "-m", "solid_dsp_tpu_torch", "--device", "cpu",
             "rx", "-", "--format", "ci16", "--block", "4096", "-o", got],
            stdin=f, cwd=REPO, env=env, capture_output=True, text=True,
            timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "processed 16384 samples" in r.stderr
    assert open(got, "rb").read() == open(want, "rb").read()
    capsys.readouterr()


def _wav(path):
    with wave.open(path, "rb") as w:
        return (w.getnchannels(), w.getframerate(),
                np.frombuffer(w.readframes(w.getnframes()), "<i2"))


def test_rx_wav_mono_matches_jax(tmp_path, capsys):
    n, fs = 1 << 16, 240_000.0
    msg = np.sin(2 * np.pi * (1000.0 / fs) * np.arange(n)).astype(np.float32)
    iq, _ = jax_fm_modulate(jnp.asarray(msg), 0.1)
    iq = np.asarray(iq) * 0.5 * np.exp(0.2j * np.arange(n))
    src = str(tmp_path / "in.cf32")
    write_iq(src, iq.astype(np.complex64))
    wj, wp = str(tmp_path / "j.wav"), str(tmp_path / "p.wav")
    args = [src, "--rate", str(fs), "--audio-rate", "48000",
            "--block", "16384"]
    _run_both(["rx", *args, "--wav", wj], ["rx", *args, "--wav", wp], capsys)
    cj, rj, pj = _wav(wj)
    cp, rp, pp = _wav(wp)
    assert (cp, rp, len(pp)) == (cj, rj, len(pj)) == (1, 48000, len(pj))
    assert np.max(np.abs(pp.astype(int) - pj.astype(int))) <= 2
    # the error paths return 1, as the JAX CLI's do
    assert port("rx", src, "--wav", wp) == 1
    assert port("rx", src, "--stereo") == 1
    assert port("rx", src, "--demod", "qpsk", "--wav", wp,
                "--rate", "1e6") == 1
    capsys.readouterr()


def test_rx_wav_stereo_matches_jax(tmp_path, capsys):
    n, fs = 1 << 17, 960_000.0
    t = np.arange(n // 4) / (fs / 4)
    left = np.sin(2 * np.pi * 700.0 * t).astype(np.float32)
    right = np.sin(2 * np.pi * 2100.0 * t).astype(np.float32)
    mpx = np.asarray(jax_fm_stereo_mpx(jnp.asarray(left), jnp.asarray(right),
                                       fs / 4))
    mpx4 = np.repeat(mpx, 4)[:n].astype(np.float32)
    iq, _ = jax_fm_modulate(jnp.asarray(0.9 * mpx4 / np.abs(mpx4).max()), 0.1)
    iq = np.asarray(iq) * 0.5 * np.exp(0.2j * np.arange(n))
    src = str(tmp_path / "in.cf32")
    write_iq(src, iq.astype(np.complex64))
    wj, wp = str(tmp_path / "j.wav"), str(tmp_path / "p.wav")
    args = [src, "--rate", str(fs), "--stereo", "--audio-rate", "48000",
            "--block", "32768"]
    _run_both(["rx", *args, "--wav", wj], ["rx", *args, "--wav", wp], capsys)
    cj, _, pj = _wav(wj)
    cp, _, pp = _wav(wp)
    assert cp == cj == 2 and len(pp) == len(pj)
    assert np.max(np.abs(pp.astype(int) - pj.astype(int))) <= 2
    L, R = pp[0::2].astype(float), pp[1::2].astype(float)

    def tone_power(a, hz):
        A = np.abs(np.fft.rfft(a[2000:] * np.hanning(len(a) - 2000)))
        f = np.fft.rfftfreq(len(a) - 2000, 1 / 48000)
        return float(A[np.argmin(np.abs(f - hz))] ** 2)

    assert 10 * np.log10(tone_power(L, 700) / tone_power(L, 2100)) > 12
    assert 10 * np.log10(tone_power(R, 2100) / tone_power(R, 700)) > 12


# ------------------------------------------------------------ small ones

def _head(out):
    return [complex(m.replace(" ", "")) for m in
            re.findall(r"out\[\d\] = (\S+)", out)]


def test_demo_matches_jax(capsys):
    out_j, out_p = _run_both(["demo", "--samples", "1024"],
                             ["demo", "--samples", "1024"], capsys)
    hj, hp = _head(out_j), _head(out_p)
    assert len(hp) == len(hj) == 5
    np.testing.assert_allclose(hp, hj, rtol=0, atol=1e-12)
    # reference golden (src/filter/iir/mod.rs:267)
    assert "0.058167695961" in out_p


@pytest.mark.parametrize("n,f,nfft", [(8192, 0.1, 4096), (2048, 0.25, 1009)])
def test_spectrum_matches_jax(tmp_path, capsys, n, f, nfft):
    rng = np.random.default_rng(nfft)
    x = 0.5 * np.exp(2j * np.pi * f * np.arange(n)) + 1e-3 * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
    src = str(tmp_path / "t.cf32")
    write_iq(src, x.astype(np.complex64))
    out_j, out_p = _run_both(["spectrum", src, "--nfft", str(nfft)],
                             ["spectrum", src, "--nfft", str(nfft)], capsys)
    rj, rp = json.loads(out_j), json.loads(out_p)
    assert rp["peak_freq"] == rj["peak_freq"]
    assert abs(rp["peak_freq"] - f) < (1e-3 if nfft == 4096 else 1e-2)
    for k in ("peak_db", "noise_floor_db"):
        assert abs(rp[k] - rj[k]) <= 0.01
    assert port("spectrum", src, "--nfft", str(4 * n)) == 1
    capsys.readouterr()


@pytest.mark.parametrize("fmt_in,fmt_out", [("ci16", "cf32"),
                                            ("cf32", "ci16"),
                                            ("cu8", "cf64")])
def test_convert_bytes_identical(tmp_path, capsys, fmt_in, fmt_out):
    rng = np.random.default_rng(9)
    x = (rng.uniform(-0.9, 0.9, 3000)
         + 1j * rng.uniform(-0.9, 0.9, 3000)).astype(np.complex64)
    src = str(tmp_path / f"a.{fmt_in}")
    write_iq(src, x, fmt_in)
    dj, dp = str(tmp_path / "j.out"), str(tmp_path / "p.out")
    args = ["--format", fmt_in, "--out-format", fmt_out, "--block", "1000"]
    _run_both(["convert", src, dj, *args], ["convert", src, dp, *args],
              capsys)
    assert open(dp, "rb").read() == open(dj, "rb").read()
    # and back: the round trip through the port gives the source's bytes
    back = str(tmp_path / f"back.{fmt_in}")
    assert port("convert", dp, back, "--format", fmt_out,
                "--out-format", fmt_in) == 0
    if fmt_in == "ci16":
        assert open(back, "rb").read() == open(src, "rb").read()
    empty = str(tmp_path / "empty.cf32")
    open(empty, "wb").close()
    assert port("convert", empty, str(tmp_path / "e.ci16")) == 0
    assert os.path.getsize(str(tmp_path / "e.ci16")) == 0
    capsys.readouterr()


def _wideband(M=32, nb=12, B=32 * 256, on=(2, 6), ch=7, seed=3):
    rng = np.random.default_rng(seed)
    blocks = []
    for b in range(nb):
        x = 0.05 * (rng.standard_normal(B) + 1j * rng.standard_normal(B))
        if on[0] <= b < on[1]:
            x = x + np.exp(2j * np.pi * (ch / M) * np.arange(B))
        blocks.append(x.astype(np.complex64))
    return np.concatenate(blocks)


def _rows(out):
    return [json.loads(line) for line in out.strip().splitlines()]


def test_monitor_matches_jax(tmp_path, capsys):
    src = str(tmp_path / "wide.cf32")
    write_iq(src, _wideband())
    args = [src, "--channels", "32", "--block", str(32 * 256)]
    out_j, out_p = _run_both(["monitor", *args], ["monitor", *args], capsys)
    rj, rp = _rows(out_j), _rows(out_p)
    assert rp == rj
    assert rp[-1]["blocks"] == 12
    assert any(e["channel"] == 7 for e in rp[:-1])


def test_f2_fused_monitor_aligns_to_eight_channel_rows(tmp_path, capsys):
    """F2: blocks of 32 * 256 + 32 samples, a multiple of the 32 channels
    but not of 8 * 32.  The JAX CLI's fused monitor refuses them (it aligns
    to the channel count only); the port's carries the rest and runs, and
    its events are those of the "xla" backend on the same recording."""
    src = str(tmp_path / "wide.cf32")
    write_iq(src, _wideband())
    args = [src, "--channels", "32", "--block", str(32 * 256 + 32)]
    with pytest.raises(ValueError, match="multiple of"):
        jax_main(["monitor", *args, "--backend", "fused"])
    capsys.readouterr()
    assert port("monitor", *args, "--backend", "fused") == 0
    fused = _rows(capsys.readouterr().out)
    assert port("monitor", *args) == 0
    xla = _rows(capsys.readouterr().out)
    assert [(e["channel"], e["start_block"], e["end_block"])
            for e in fused[:-1]] == [(e["channel"], e["start_block"],
                                      e["end_block"]) for e in xla[:-1]]
    assert fused[-1]["duty_cycle"] == xla[-1]["duty_cycle"]
    assert any(e["channel"] == 7 for e in fused[:-1])


def test_resample_matches_jax(tmp_path, capsys):
    n, f_in = 1 << 15, 0.1
    x = (0.5 * np.exp(2j * np.pi * f_in * np.arange(n))).astype(np.complex64)
    src = str(tmp_path / "in.cf32")
    write_iq(src, x)
    dj, dp = str(tmp_path / "j.cf32"), str(tmp_path / "p.cf32")
    args = ["--rate", "0.4", "--block", "8192"]
    _run_both(["resample", src, dj, *args], ["resample", src, dp, *args],
              capsys)
    want, got = read_iq(dj), read_iq(dp)
    assert got.shape == want.shape == (round(0.4 * n),)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    k = np.argmax(np.abs(np.fft.fft(got[1000:9192])))
    assert abs(k / 8192 - f_in / 0.4) < 2e-3
    assert port("resample", src, dp, "--rate", "0") == 1
    capsys.readouterr()


# --------------------------------------------------------------- packets

def _packet_recording(tmp_path):
    """tests/test_cli.py::test_cli_packets's recording: two JAX PacketModem
    bursts of 16 bytes between gaps, AWGN of 0.05 a quadrature."""
    from solid_dsp_tpu.models.packet import PacketModem as JaxPacketModem

    rng = np.random.default_rng(5)
    pm = JaxPacketModem(payload_bytes=16)
    payloads = [rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
                for _ in range(2)]
    parts = [np.zeros(400, np.complex64)]
    for pl in payloads:
        parts += [np.asarray(pm.transmit(pl)), np.zeros(500, np.complex64)]
    s = np.concatenate(parts)
    s = s + 0.05 * (rng.standard_normal(len(s))
                    + 1j * rng.standard_normal(len(s)))
    src = str(tmp_path / "pk.cf32")
    write_iq(src, s.astype(np.complex64))
    return src, payloads


def test_packets_matches_jax(tmp_path, capsys):
    src, payloads = _packet_recording(tmp_path)
    args = [src, "--payload-bytes", "16"]
    out_j, out_p = _run_both(["packets", *args], ["packets", *args], capsys)
    rj, rp = _rows(out_j), _rows(out_p)
    assert rp == rj
    assert rp[-1] == {"bursts": 2, "crc_ok": 2}
    assert [bytes.fromhex(r["payload_hex"]) for r in rp[:-1]] == payloads
    # an unsupported fec for the ofdm phy fails cleanly, as in JAX
    assert port("packets", src, "--phy", "ofdm", "--fec", "turbo") == 1
    assert jax_main(["packets", src, "--phy", "ofdm", "--fec", "turbo"]) == 1
    capsys.readouterr()


def test_packets_ofdm_matches_jax(tmp_path, capsys):
    """``--phy ofdm`` (OFDMModem at QPSK, conv FEC) on two JAX bursts: the
    same rows; the capture cut inside its second burst makes both CLIs
    print the same error row and return 0."""
    from solid_dsp_tpu.models.ofdm_link import OFDMModem as JaxOFDMModem

    rng = np.random.default_rng(6)
    om = JaxOFDMModem(payload_bytes=16, m=4, scheme="psk")
    payloads = [rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
                for _ in range(2)]
    parts = [np.zeros(300, np.complex64)]
    for pl in payloads:
        parts += [np.asarray(om.transmit(pl)), np.zeros(400, np.complex64)]
    s = np.concatenate(parts)
    s = s + 0.02 * (rng.standard_normal(len(s))
                    + 1j * rng.standard_normal(len(s)))
    src = str(tmp_path / "ofdm.cf32")
    write_iq(src, s.astype(np.complex64))
    args = [src, "--phy", "ofdm", "--payload-bytes", "16"]
    out_j, out_p = _run_both(["packets", *args], ["packets", *args], capsys)
    rj, rp = _rows(out_j), _rows(out_p)
    assert rp == rj
    assert rp[-1] == {"bursts": 2, "crc_ok": 2}
    assert [bytes.fromhex(r["payload_hex"]) for r in rp[:-1]] == payloads
    cut = str(tmp_path / "cut.cf32")
    write_iq(cut, s[: len(s) - 400 - om.frame_samples // 2].astype(
        np.complex64))
    args = [cut, "--phy", "ofdm", "--payload-bytes", "16"]
    out_j, out_p = _run_both(["packets", *args], ["packets", *args], capsys)
    assert _rows(out_p) == _rows(out_j)
    assert _rows(out_p)[0]["bursts"] == 0 and "error" in _rows(out_p)[0]


# ---------------------------------------------------------------- parser

def test_help_names_the_commands_that_wait(capsys):
    with pytest.raises(SystemExit) as e:
        port_main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    waiting = out.split("wait for their modules")[1]
    for cmd in ("demo", "rx", "spectrum", "convert", "monitor", "resample",
                "packets", "tx", "adsb", "ais"):
        assert cmd in out and cmd not in waiting
    assert "item 6" in waiting and "bench" in waiting
    with pytest.raises(SystemExit):
        port_main(["bench", "x"])
    capsys.readouterr()


def test_default_device_is_the_card(tmp_path, capsys):
    """No ``--device``: the card, and without one PyTorch's own error (no
    fall-back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    src = str(tmp_path / "in.cf32")
    write_iq(src, _fm_recording(4096)[0])
    with pytest.raises((RuntimeError, AssertionError)):
        port_main(["rx", src])
    with pytest.raises((RuntimeError, AssertionError)):
        port_main(["demo", "--samples", "64"])
    capsys.readouterr()


# ------------------------------------------------------ tx, adsb, ais

@pytest.mark.parametrize("mod,extra", [("fm", []), ("qam", ["--order", "16"]),
                                       ("psk", ["--order", "8"]),
                                       ("none", ["--format", "ci16"])])
def test_tx_matches_jax(tmp_path, capsys, mod, extra):
    a, b = str(tmp_path / "j.iq"), str(tmp_path / "p.iq")
    args = ["--mod", mod, "--samples", "3001", "--carrier", "0.7", *extra]
    out_j, out_p = _run_both(["tx", a, *args], ["tx", b, *args], capsys)
    rj, rp = _rows(out_j), _rows(out_p)
    assert rp[0].pop("output") == b and rj[0].pop("output") == a
    assert rp == rj
    fmt = "ci16" if "ci16" in extra else "cf32"
    x, y = read_iq(a, fmt), read_iq(b, fmt)
    assert len(y) == rp[0]["samples"] == len(x)
    np.testing.assert_allclose(y, x, atol=1e-4 if fmt == "cf32" else 2.0
                               / 32767)


def test_tx_fm_reads_back_through_rx(tmp_path, capsys):
    src, out = str(tmp_path / "tx.cf32"), str(tmp_path / "rx.cf32")
    assert port("tx", src, "--samples", "16384") == 0
    assert port("rx", src, "-o", out, "--carrier", "0.2") == 0
    capsys.readouterr()
    audio = read_iq(out).real[200:]
    msg = np.sin(2 * np.pi * 0.002 * np.arange(16384))
    best = max(abs(np.corrcoef(audio, msg[200 - lag: 200 - lag + len(audio)]
                               )[0, 1]) for lag in range(40))
    assert best > 0.8


def _adsb_recording(tmp_path):
    from solid_dsp_tpu_torch.models import adsb

    rng = np.random.default_rng(5)
    x = (0.02 * (rng.standard_normal(30000) + 1j * rng.standard_normal(
        30000))).astype(np.complex64)
    for i, s in enumerate((900, 7000, 15000, 22000)):
        f = adsb.encode_df17(0x4840D6 + 17 * i, rng.integers(0, 2, 56))
        if i == 2:
            f[60] ^= 1                          # a frame that fails its CRC
        env = adsb.ppm_modulate(f, 2)
        x[s: s + len(env)] += env * np.exp(1j * (0.3 + i))
    src = str(tmp_path / "adsb.cf32")
    write_iq(src, x)
    return src


def test_adsb_matches_jax(tmp_path, capsys):
    src = _adsb_recording(tmp_path)
    for extra in ([], ["--all"]):
        assert jax_main(["adsb", src, "--threshold", "0.6", *extra]) == 0
        cj = capsys.readouterr()
        assert port("adsb", src, "--threshold", "0.6", *extra) == 0
        cp = capsys.readouterr()
        assert _rows(cp.out) == _rows(cj.out)
        assert json.loads(cp.err.strip().splitlines()[-1]) == \
            json.loads(cj.err.strip().splitlines()[-1])
    rows = _rows(cp.out)
    assert len(rows) >= 4 and sum(r["crc_ok"] for r in rows) == 3
    assert rows[0]["icao"] == "4840D6" and rows[0]["df"] == 17


def test_ais_matches_jax(tmp_path, capsys):
    from solid_dsp_tpu_torch.models import ais

    p1 = ais.build_type1_payload(111111111, 10.0, 20.0, 3.5, 45.0)
    p2 = ais.build_type1_payload(222222222, -33.9, 151.2)
    gap = np.zeros(400, np.complex64)
    s = np.concatenate([gap, ais.ais_transmit(p1, device="cpu"), gap,
                        ais.ais_transmit(p2, device="cpu"), gap])
    rng = np.random.default_rng(7)
    s = s + 0.03 * (rng.standard_normal(len(s)) + 1j
                    * rng.standard_normal(len(s)))
    src = str(tmp_path / "ais.ci16")
    write_iq(src, (0.5 * s).astype(np.complex64), "ci16")
    for extra in ([], ["--all"]):
        args = [src, "--format", "ci16", *extra]
        assert jax_main(["ais", *args]) == 0
        cj = capsys.readouterr()
        assert port("ais", *args) == 0
        cp = capsys.readouterr()
        assert _rows(cp.out) == _rows(cj.out)
        assert json.loads(cp.err.strip().splitlines()[-1]) == \
            json.loads(cj.err.strip().splitlines()[-1])
    rows = [r for r in _rows(cp.out) if r["crc_ok"]]
    assert sorted(r["mmsi"] for r in rows) == [111111111, 222222222]
