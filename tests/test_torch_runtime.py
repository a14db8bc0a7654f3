"""The port's native runtime against the JAX package's.

Both build the same ``native/solid_runtime.cc``; the port into its own
library under ``solid_dsp_tpu_torch/_build/`` (or the user cache), never
into ``native/``.  Tolerances: exact everywhere (the same C++ code on the
same bytes): the native ring gives the same results and raises on the same
operations for any op sequence (hypothesis), ``write_iq`` writes identical
bytes in all five formats, ``read_iq`` and ``StreamPump`` return equal
arrays.  The stdin, UDP, TCP and rtl_tcp tests mirror tests/test_runtime.py
on localhost (ports picked free); the UDP stream feeds the port's
``RxChain`` on the CPU, whose FM message must correlate > 0.8 (the JAX
test's gate).
"""

import os
import socket
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import solid_dsp_tpu.runtime as jrt
import solid_dsp_tpu_torch.runtime as prt
from solid_dsp_tpu_torch.runtime import build as port_build

FORMATS = ["cf32", "cf64", "ci16", "ci8", "cu8"]


def _iq(n, seed=0, amp=0.45):
    rng = np.random.default_rng(seed)
    x = amp * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    x = np.clip(x.real, -0.99, 0.99) + 1j * np.clip(x.imag, -0.99, 0.99)
    return x.astype(np.complex64)


def _free_port(kind=socket.SOCK_DGRAM):
    s = socket.socket(socket.AF_INET, kind)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ------------------------------------------------------------------ build

def test_library_is_the_ports_own_and_not_in_native():
    path = Path(port_build.ensure_built()).resolve()
    cache = Path(os.environ.get("XDG_CACHE_HOME",
                                Path.home() / ".cache")) / "solid_dsp_tpu_torch"
    assert (path.parent == port_build.BUILD_DIR.resolve()
            or path.parent == cache.resolve()), path
    assert path.name.startswith("libsolid_runtime-")
    native = (Path(port_build.__file__).resolve().parents[2] / "native")
    assert native not in path.parents
    assert port_build.source().resolve() == (native
                                             / "solid_runtime.cc").resolve()


def test_importing_the_port_builds_nothing():
    """``import solid_dsp_tpu_torch`` (and its runtime) runs no g++: the
    library is built at first use (fresh interpreter, g++ off the PATH)."""
    import subprocess
    import sys

    repo = str(Path(__file__).resolve().parents[1])
    code = ("import solid_dsp_tpu_torch, solid_dsp_tpu_torch.runtime as r\n"
            "import solid_dsp_tpu_torch.__main__\n"
            "assert r._lib.cache_info().currsize == 0\n"
            "assert r.build.ensure_built.cache_info().currsize == 0\n"
            "print('LAZY')\n")
    env = {**os.environ, "PYTHONPATH": repo, "PATH": "/nonexistent"}
    r = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                       capture_output=True, text=True, timeout=300)
    assert "LAZY" in r.stdout, r.stderr[-2000:]


def test_failed_build_raises_with_the_compilers_output(tmp_path,
                                                       monkeypatch):
    bad = tmp_path / "solid_runtime.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(port_build, "SOURCE_CANDIDATES", (bad,))
    monkeypatch.setattr(port_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="building the native runtime "
                                           "failed") as e:
        port_build.ensure_built.__wrapped__()
    assert "error" in str(e.value)
    assert not list((tmp_path / "_build").glob("*.so"))


# ------------------------------------------------------------ native ring

OPS = st.lists(st.one_of(
    st.tuples(st.just("push"), st.floats(-1e3, 1e3)),
    st.tuples(st.just("append"), st.integers(0, 9)),
    st.tuples(st.just("pop"), st.just(0)),
    st.tuples(st.just("read"), st.integers(0, 9)),
    st.tuples(st.just("release"), st.integers(0, 9)),
    st.tuples(st.just("pop_block"), st.integers(0, 9)),
    st.tuples(st.just("reset"), st.just(0)),
), max_size=40)


def _run_native(mod, ops, cap, dtype):
    cb = mod.CircularBuffer(cap, dtype=dtype)
    seq = 0.0
    log = []
    for op, arg in ops:
        try:
            if op == "push":
                cb.push(arg)
                r = None
            elif op == "append":
                r = cb.append(np.arange(seq, seq + arg))
                seq += arg
            elif op == "read":
                r = cb.read(arg).tolist()
            elif op in ("release", "pop_block"):
                r = getattr(cb, op)(arg)
                r = None if r is None else r.tolist()
            else:
                r = getattr(cb, op)()
            log.append(("ok", r, len(cb), cb.space(), cb.is_empty(),
                        cb.is_full()))
        except mod.BufferError_ as e:
            log.append(("err", str(e), len(cb)))
    return log


@settings(max_examples=60, deadline=None, database=None)
@given(ops=OPS, cap=st.integers(1, 12))
def test_native_ring_op_sequences_match_jax(ops, cap):
    for dtype in (np.float64, np.complex64):
        assert (_run_native(prt, ops, cap, dtype)
                == _run_native(jrt, ops, cap, dtype))


def test_native_ring_reference_semantics():
    cb = prt.CircularBuffer(4, dtype=np.int32)
    for round_ in range(10):                    # wrap-around
        cb.append([round_, round_ + 1])
        np.testing.assert_array_equal(cb.pop_block(2), [round_, round_ + 1])
    cb.append([1, 2, 3])
    with pytest.raises(prt.BufferError_):
        cb.append([4, 5])
    assert cb.capacity() == 4 and len(cb) == 3
    cb.reset()
    assert cb.is_empty() and cb.space() == 4
    with pytest.raises(prt.BufferError_, match="buffer empty"):
        cb.pop()


# ---------------------------------------------------------------- IQ files

@pytest.mark.parametrize("fmt", FORMATS)
def test_write_iq_bytes_identical_and_read_equal(tmp_path, fmt):
    x = _iq(1000, seed=FORMATS.index(fmt))
    pj, pp = str(tmp_path / f"j.{fmt}"), str(tmp_path / f"p.{fmt}")
    assert jrt.write_iq(pj, x, fmt) == prt.write_iq(pp, x, fmt) == 1000
    assert Path(pj).read_bytes() == Path(pp).read_bytes()
    yp = prt.read_iq(pj, fmt)
    assert yp.dtype == np.complex64
    np.testing.assert_array_equal(yp, jrt.read_iq(pp, fmt))
    np.testing.assert_array_equal(prt.read_iq(pp, fmt, offset=10, count=20),
                                  yp[10:30])


def test_write_iq_append_and_bad_format(tmp_path):
    p = str(tmp_path / "t.ci16")
    prt.write_iq(p, np.ones(10, np.complex64) * 0.25, "ci16")
    prt.write_iq(p, np.ones(5, np.complex64) * 0.5, "ci16", append=True)
    y = prt.read_iq(p, "ci16")
    np.testing.assert_array_equal(y, jrt.read_iq(p, "ci16"))
    assert y.shape == (15,)
    with pytest.raises(ValueError, match="unknown IQ format"):
        prt.write_iq(str(tmp_path / "x"), np.ones(4, np.complex64), "bogus")
    with pytest.raises(OSError):
        prt.read_iq(str(tmp_path / "missing.cf32"), count=4)


@pytest.mark.parametrize("fmt,block", [("ci16", 16384), ("cu8", 7000),
                                       ("cf32", 100_000)])
def test_stream_pump_blocks_equal_jax(tmp_path, fmt, block):
    n = 100_003
    p = str(tmp_path / f"s.{fmt}")
    prt.write_iq(p, _iq(n, seed=3), fmt)
    with prt.StreamPump(p, fmt=fmt, block=block) as pump:
        got = list(pump)
    with jrt.StreamPump(p, fmt=fmt, block=block) as pump:
        want = list(pump)
    assert [len(b) for b in got] == [len(b) for b in want]
    assert all(len(b) == block for b in got[:-1]) and len(got[-1]) <= block
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.concatenate(got), prt.read_iq(p, fmt))
    with pytest.raises(OSError):
        prt.StreamPump(str(tmp_path / "missing.iq"))


def test_pump_reads_from_pipe(tmp_path):
    """StreamPump on a FIFO (the CLI's '-' /dev/stdin path)."""
    fifo = str(tmp_path / "fifo")
    os.mkfifo(fifo)
    x = (0.25 * np.exp(2j * np.pi * 0.01 * np.arange(50_000))).astype(
        np.complex64)

    def feeder():
        with open(fifo, "wb") as f:
            f.write(x.tobytes())

    t = threading.Thread(target=feeder)
    t.start()
    with prt.StreamPump(fifo, fmt="cf32", block=8192) as pump:
        got = list(pump)
    t.join(timeout=30)
    assert not t.is_alive()
    np.testing.assert_array_equal(np.concatenate(got), x)


# ------------------------------------------------------------------ UDP

def test_udp_ci16_datagrams_roundtrip():
    port = _free_port()
    rng = np.random.default_rng(0)
    raw = rng.integers(-30000, 30000, size=4096 * 2, dtype=np.int16)
    want = (raw[0::2] + 1j * raw[1::2]).astype(np.complex64) / 32767.0
    with prt.UdpSource(port=port, fmt="ci16", bind_addr="127.0.0.1") as src:
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        payload = raw.tobytes()
        for i in range(4):
            tx.sendto(payload[i * 4096:(i + 1) * 4096], ("127.0.0.1", port))
        tx.close()
        deadline = time.time() + 5.0
        got = np.empty(0, np.complex64)
        while len(got) < 4096 and time.time() < deadline:
            got = np.concatenate([got, src.read(8192)])
            time.sleep(0.01)
        assert src.dropped == 0
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_udp_nonblocking_empty_read_and_bad_bind():
    with prt.UdpSource(port=_free_port(), fmt="cf32",
                       bind_addr="127.0.0.1") as src:
        assert src.read(1024).size == 0
        assert src.available == 0
    with pytest.raises(OSError):
        prt.UdpSource(port=5000, fmt="ci16", bind_addr="999.1.1.1")


def test_udp_source_feeds_rx_chain():
    """UDP datagrams -> the native ring -> the port's RxChain (CPU)."""
    from solid_dsp_tpu_torch.models.fm import fm_modulate
    from solid_dsp_tpu_torch.models.rx_chain import RxChain

    n = 16384
    msg = np.sin(2 * np.pi * 0.002 * np.arange(n))
    iq, _ = fm_modulate(torch.from_numpy(msg), 0.1)
    iq = (iq.numpy() * 0.5 * np.exp(1j * 0.2 * np.arange(n))
          ).astype(np.complex64)
    port = _free_port()
    chain = RxChain(carrier_freq=0.2, decimation=4, agc_mode="block",
                    demod="fm", device="cpu")
    audio = []
    with prt.UdpSource(port=port, fmt="cf32", bind_addr="127.0.0.1") as src:
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        payload = iq.tobytes()
        for i in range(0, len(payload), 8192):
            tx.sendto(payload[i:i + 8192], ("127.0.0.1", port))
            time.sleep(0.001)        # paced: no burst for a busy host
        tx.close()
        deadline = time.time() + 10.0
        got = 0
        while got < n and time.time() < deadline:
            block = src.read(4096)
            if block.size >= 4:
                take = (block.size // 4) * 4
                audio.append(chain.execute_block(block[:take]).numpy())
                got += take
            else:
                time.sleep(0.005)
        assert src.dropped == 0
    audio = np.concatenate(audio)
    a = audio[512:]
    c = np.corrcoef(a, msg[::4][512:512 + len(a)])[0, 1]
    assert c > 0.8, c


# ------------------------------------------------------------------ TCP

def _serve(srv, header, payload, stop_evt, cmds):
    conn, _ = srv.accept()
    try:
        if header:
            conn.sendall(header)
        conn.sendall(payload)
        conn.settimeout(0.2)
        while not stop_evt.is_set():
            try:
                d = conn.recv(5)
                if not d:
                    break
                cmds.append(d)
            except socket.timeout:
                pass
    finally:
        conn.close()
        srv.close()


def _listen():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    srv.settimeout(5.0)
    return srv, srv.getsockname()[1]


def test_rtl_tcp_client_end_to_end():
    rng = np.random.default_rng(0)
    iq_u8 = rng.integers(0, 256, 20000, dtype=np.uint8)
    hdr = b"RTL0" + (5).to_bytes(4, "big") + (29).to_bytes(4, "big")
    srv, port = _listen()
    stop_evt, cmds = threading.Event(), []
    th = threading.Thread(target=_serve,
                          args=(srv, hdr, iq_u8.tobytes(), stop_evt, cmds))
    th.start()
    try:
        with prt.RtlTcpSource("127.0.0.1", port) as sdr:
            assert sdr.tuner_type == 5          # R820T, from the greeting
            sdr.set_center_freq(100_300_000)
            sdr.set_sample_rate(2_048_000)
            deadline = time.time() + 5.0
            x = np.zeros(0, np.complex64)
            while len(x) < 10000 and time.time() < deadline:
                x = np.concatenate([x, sdr.read(1 << 16)])
                time.sleep(0.05)
            expect = (iq_u8.astype(np.float32) - 127.5) / 127.5
            assert len(x) == 10000
            np.testing.assert_allclose(x, expect[0::2] + 1j * expect[1::2],
                                       atol=1e-6)
            assert sdr.dropped == 0
            time.sleep(0.3)                     # let the commands land
    finally:
        stop_evt.set()
        th.join(timeout=10)
    assert not th.is_alive()
    # the 5-byte big-endian command wire format
    wire = b"".join(cmds)
    assert bytes.fromhex("0105fa74e0") in wire
    assert bytes.fromhex("02001f4000") in wire


def test_raw_tcp_ci16_and_orderly_eof():
    rng = np.random.default_rng(1)
    iq = rng.integers(-30000, 30000, 8192, dtype=np.int16)
    srv, port = _listen()
    stop_evt, cmds = threading.Event(), []
    th = threading.Thread(target=_serve,
                          args=(srv, b"", iq.tobytes(), stop_evt, cmds))
    th.start()
    try:
        with prt.TcpSource("127.0.0.1", port, fmt="ci16") as src:
            deadline = time.time() + 5.0
            x = np.zeros(0, np.complex64)
            while len(x) < 4096 and time.time() < deadline:
                x = np.concatenate([x, src.read(4096)])
                time.sleep(0.05)
            expect = iq.astype(np.float32) / 32767.0
            expect = expect[0::2] + 1j * expect[1::2]
            assert len(x) == 4096
            np.testing.assert_allclose(x, expect, atol=1e-6)
            stop_evt.set()                      # server closes: orderly EOF
            deadline = time.time() + 5.0
            while not src.eof and time.time() < deadline:
                src.read(4096)
                time.sleep(0.05)
            assert src.eof
            assert len(src.read(16)) == 0       # drained EOF: empty
    finally:
        stop_evt.set()
        th.join(timeout=10)
    assert not th.is_alive()


def test_tcp_connect_refused_raises():
    with pytest.raises(OSError):
        prt.TcpSource("127.0.0.1", _free_port(socket.SOCK_STREAM),
                      fmt="ci16")
