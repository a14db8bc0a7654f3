"""ci16 (interleaved int16 IQ) from the recording to the DDC bodies' loads.

The port's fused chain hands a ci16 block to its DDC bodies as raw int16
(L, 2); the kernels convert in registers on the card, and on the CPU the
plain bodies and the glue convert with ``ops/ddc.py::ci16_planes``, the
chain's own conversion.  Checked here at 64 taps, M = 4, L = 2^14 (K1's
and K2's lengths) and 2^14 + 52 (K3's), two blocks with the state carried:

* against the JAX package's ci16 chain with ``ddc_engine="pallas"`` (its
  kernels in interpret mode): >= 90 dB at x3 for FM and AM
  (tests/test_rx_chain_fused.py:70's gate), QPSK >= 60 dB (BASELINE.json's
  bound, as tests/test_torch_rx_chain_demods.py), the u32 phase words and
  the FIR tail exact (:52), the AGC as tests/test_torch_rx_chain.py;
* bit-equal to the port's own cf32 chain on ``read_iq`` of the same
  samples (the native runtime's conversion), in both precisions;
* ``ddc_fm_torch``, ``ddc_body_torch`` and the glue on int16 bit-equal to
  the same functions on the planes;
* the kernels' int16 conversion (csrc/ddc_tc.cuh) emulated in numpy over
  every int16 value, equal to the chain's;
* the raw reader's blocks equal to the file's int16 (a ragged end, a file
  shorter than a block), and ``rx --format ci16 --device cpu`` (the raw
  route) writing the same bytes as ``rx --format cf32`` on the samples as
  ``read_iq`` converts them (the pump's route).

The int16 kernels themselves run only on the card: tests/test_torch_cuda.py.
"""

import os
import re

import numpy as np
import pytest
import torch

from solid_dsp_tpu_torch.__main__ import main as port_main
from solid_dsp_tpu_torch.models import rx_chain as port_rx
from solid_dsp_tpu_torch.ops import cuda_ddc
from solid_dsp_tpu_torch.ops import ddc as ddc_ops
from solid_dsp_tpu_torch.ops.nco import constrain
from solid_dsp_tpu_torch.runtime import read_iq, write_iq
from solid_dsp_tpu_torch.runtime.raw import Ci16Reader
from test_torch_rx_chain import _check_state
from torch_parity import (CONFIG4, as_format, make_blocks, make_qpsk_blocks,
                          run_jax, run_torch, snr_db)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENGTHS = (1 << 14, (1 << 14) + 52)
DEMODS = ("fm", "am", "qpsk")
GATES = {"fm": 90.0, "am": 90.0, "qpsk": 60.0}


def _planar_blocks(demod: str, n_blocks: int, L: int, seed: int):
    if demod == "qpsk":
        return make_qpsk_blocks(n_blocks, L=L, seed=seed)[0]
    return make_blocks(n_blocks, L=L, seed=seed)


def _ci16_blocks(demod: str, L: int, seed: int = 3):
    return as_format(_planar_blocks(demod, 2, L, seed), "ci16")


def _as_read_iq(blocks, tmp_path):
    """The blocks' samples as the native runtime reads a ci16 file."""
    src = str(tmp_path / "blocks.ci16")
    np.concatenate(blocks).tofile(src)
    x = read_iq(src, "ci16")
    return np.split(x, np.cumsum([len(b) for b in blocks])[:-1])


@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("demod", DEMODS)
def test_ci16_chain_matches_jax_pallas(demod, L):
    """The port's ci16 chain (raw int16 into the bodies) against JAX's ci16
    chain with its kernels in interpret mode: the module's gates."""
    blocks = _ci16_blocks(demod, L)
    want, jst = run_jax(blocks, input_format="ci16", demod=demod,
                        ddc_engine="pallas")
    got, st = run_torch(blocks, input_format="ci16", demod=demod)
    assert got.shape == want.shape == (2 * L // 4,)
    assert snr_db(got, want) >= GATES[demod]
    _check_state(st, jst)


@pytest.mark.parametrize("precision", ["x3", "default"])
@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("demod", DEMODS)
def test_ci16_chain_bit_equal_to_cf32(tmp_path, demod, L, precision):
    """The ci16 chain gives the bits of the cf32 chain on the samples the
    native runtime's read_iq makes of the same file, state included."""
    blocks = _ci16_blocks(demod, L, seed=9)
    got, st = run_torch(blocks, input_format="ci16", demod=demod,
                        fir_precision=precision)
    want, wst = run_torch(_as_read_iq(blocks, tmp_path), input_format="cf32",
                          demod=demod, fir_precision=precision)
    assert np.array_equal(got, want)
    for key in ("nco_theta", "fir_tail", "fm_prev"):
        assert torch.equal(st[key], wst[key])
    assert torch.equal(st["agc"]["gain"], wst["agc"]["gain"])


def test_ci16_chain_never_takes_planar(monkeypatch):
    """The fused ci16 chain hands the int16 to the bodies: ``_planar`` is
    not called (the unfused route keeps ``_complex_in``)."""
    def refuse(cfg, x):
        raise AssertionError("the ci16 block went through _planar")

    monkeypatch.setattr(port_rx, "_planar", refuse)
    blocks = _ci16_blocks("fm", LENGTHS[1])
    for demod in DEMODS:
        run_torch(blocks, input_format="ci16", demod=demod)
    out, _ = run_torch(blocks, input_format="ci16", fused_ddc="off",
                       fir_precision="highest")
    assert np.all(np.isfinite(out))


@pytest.mark.parametrize("demod", DEMODS)
def test_ci16_chain_takes_a_block_off_alignment(demod):
    """A contiguous (L, 2) int16 view 2 bytes off a 4-byte boundary (the
    kernels read a sample as one word) gives the output and state of the
    same samples in an aligned block."""
    blk = _ci16_blocks(demod, LENGTHS[0])[0]
    flat = np.concatenate([np.zeros(1, np.int16), blk.reshape(-1)])
    off = torch.from_numpy(flat)[1:].view(-1, 2)
    assert off.is_contiguous() and off.data_ptr() % 4 == 2
    init, apply = port_rx.make_rx_chain(port_rx.RxChainConfig(
        **{**CONFIG4, "demod": demod, "input_format": "ci16"}), "cpu")
    want, wst = apply(init(), torch.from_numpy(blk))
    got, st = apply(init(), off)
    assert torch.equal(got, want)
    for key in ("nco_theta", "fir_tail", "fm_prev"):
        assert torch.equal(st[key], wst[key])
    assert torch.equal(st["agc"]["gain"], wst["agc"]["gain"])


def _bodies(mode, n=64, M=4):
    taps = port_rx.RxChainConfig(fir_taps=n).design_taps()
    return (cuda_ddc.make_ddc_fm(taps, constrain(0.2), M, 0.1, "cpu",
                                 mode=mode),
            cuda_ddc.make_ddc_body(taps, constrain(0.2), M, "cpu", mode=mode))


def _int16(L, seed=5):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-32768, 32768, (L, 2),
                                         dtype=np.int16))


@pytest.mark.parametrize("mode", cuda_ddc.MODES)
def test_bodies_on_int16_bit_equal_to_planes(mode):
    """ddc_fm_torch and ddc_body_torch (K2's and K3's lengths, and a block
    shorter than the filter) on raw int16 equal the same functions on
    ci16_planes of it."""
    fm, body = _bodies(mode)
    rng = np.random.default_rng(1)
    tail = torch.from_numpy((0.3 * rng.standard_normal((2, 60))).astype(
        np.float32))
    for L in (1 << 14, (1 << 14) + 52, 32):
        x = _int16(L)
        x2 = ddc_ops.ci16_planes(x, torch.float32)
        assert torch.equal(cuda_ddc.ddc_body_torch(body, x, tail),
                           cuda_ddc.ddc_body_torch(body, x2, tail))
        if L % 256 == 0:
            a, s = cuda_ddc.ddc_fm_torch(fm, x, tail)
            b, t = cuda_ddc.ddc_fm_torch(fm, x2, tail)
            assert torch.equal(a, b) and torch.equal(s, t)


@pytest.mark.parametrize("mode", cuda_ddc.MODES)
def test_glue_on_int16_bit_equal_to_planes(mode):
    """The glue around the bodies on raw int16: ddc_apply_planar_pieces,
    ddc_apply_planar and ddc_fm_fused equal their runs on the planes,
    the new tail (converting only the samples it keeps) included, also
    for a block shorter than the tail."""
    fm, body = _bodies(mode)
    rng = np.random.default_rng(2)
    tail2 = torch.from_numpy((0.3 * rng.standard_normal((2, 63))).astype(
        np.float32))
    theta = torch.tensor(123456789, dtype=torch.int64)
    for L in (1 << 14, (1 << 14) + 52, 32):
        x = _int16(L, seed=L)
        x2 = ddc_ops.ci16_planes(x, torch.float32)
        for fn in (ddc_ops.ddc_apply_planar_pieces, ddc_ops.ddc_apply_planar):
            for a, b in zip(fn(body, tail2, theta, x), fn(body, tail2, theta,
                                                          x2)):
                assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
        if L % 256 == 0:
            one = torch.tensor(1.0)
            got = ddc_ops.ddc_fm_fused(fm, tail2, theta, x, one, 0 * one, one,
                                       with_seams=True)
            want = ddc_ops.ddc_fm_fused(fm, tail2, theta, x2, one, 0 * one,
                                        one, with_seams=True)
            for a, b in zip(got, want):
                assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def test_ci16_planes_ranges_and_scale():
    """ci16_planes of a range equals that range of the whole block; the
    scale is the float32 1/32767 of the native runtime (1.0f / 32767.0f),
    and of the kernels' source; a float64 block is converted in float64,
    as the JAX chain converts it (P9: it was computed in float32)."""
    x = _int16(1000, seed=8)
    whole = ddc_ops.ci16_planes(x, torch.float32)
    for lo, hi in ((0, 1000), (3, 17), (937, None), (1000, None)):
        assert torch.equal(ddc_ops.ci16_planes(x, torch.float32, lo, hi),
                           whole[:, lo:hi])
    k = ddc_ops.ci16_scale(torch.float32)
    assert np.float32(k) == np.float32(1.0) / np.float32(32767.0)
    assert ddc_ops.ci16_scale(torch.float64) == 1.0 / 32767.0
    src = open(os.path.join(REPO, "solid_dsp_tpu_torch", "csrc",
                            "ddc_tc.cuh")).read()
    lit = re.search(r"kCi16Scale = (0x[0-9a-fp.+-]+)f;", src).group(1)
    assert float.fromhex(lit) == k
    x = torch.arange(-32768, 32768, dtype=torch.int16).reshape(-1, 2)
    want = x.numpy().astype(np.float64).T * (1.0 / 32767.0)
    assert np.array_equal(ddc_ops.ci16_planes(x, torch.float64).numpy(),
                          want)


def test_p9_complex128_ci16_chain_converts_in_float64():
    """P9: a complex128 chain on ci16 (the fused route's plain body, JAX's
    XLA) is bit-equal to the same chain on float64 planes of v / 32767
    computed in float64, and >= 200 dB against JAX's complex128 ci16 chain
    (tests/test_torch_rx_chain_default.py's complex128 gate)."""
    import jax.numpy as jnp

    blocks = _ci16_blocks("fm", LENGTHS[1], seed=4)
    over = dict(input_format="ci16", dtype=torch.complex128,
                fir_precision="highest")
    got, _ = run_torch(blocks, **over)
    planes = [b.astype(np.float64).T * (1.0 / 32767.0) for b in blocks]
    want, _ = run_torch(planes, **{**over, "input_format": "planar"})
    assert np.array_equal(got, want)
    ref, _ = run_jax(blocks, **{**over, "dtype": jnp.complex128,
                                "ddc_engine": "xla"})
    assert snr_db(got, ref) >= 200.0


def test_kernel_conversion_emulated_over_every_int16():
    """csrc/ddc_tc.cuh's ci16_half on every int16 value, in both halves of
    a word: the half's sign bit flipped (v + 32768) in the low bits of
    0x4B408000, read as float32, minus 12615680 (1.5 * 2^23 + 32768) is v
    exactly; then one rounded float32 product by the scale.  Equal, for
    all 65536 values, to the chain's conversion (torch.mul of int16 by the
    scale); the word's low half is the real part."""
    v = np.arange(-32768, 32768, dtype=np.int32)
    x = torch.from_numpy(np.stack([v, v[::-1]], axis=1).astype(np.int16))
    w = x.numpy().view(np.uint32)[:, 0]
    k = np.float32(ddc_ops.ci16_scale(torch.float32))
    chain = ddc_ops.ci16_planes(x, torch.float32).numpy()
    for half, want in ((w & np.uint32(0xFFFF), v), (w >> np.uint32(16),
                                                     v[::-1])):
        bits = half.astype(np.uint32) ^ np.uint32(0x4B408000)
        exact = bits.view(np.float32) - np.float32(12615680.0)
        assert np.array_equal(exact, want.astype(np.float32))
        kernel = exact * k                   # one float32 product
        assert np.array_equal(kernel, chain[0] if want is v else chain[1])


def _raw_blocks(path, block, device="cpu"):
    with Ci16Reader(path, block, device) as reader:
        return [b.clone() for b in reader]


@pytest.mark.parametrize("n,block,extra", [
    (10_000, 4096, 0),          # a short last block
    (10_000, 4096, 3),          # and a partial sample at the end
    (8192, 4096, 0),            # whole blocks only
    (1000, 4096, 2),            # the file shorter than one block
    (0, 4096, 0),               # an empty file
])
def test_raw_reader_blocks_equal_the_file(tmp_path, n, block, extra):
    """The raw reader's blocks, concatenated, are the file's int16 (a
    trailing partial sample dropped, as the pump drops it), each block of
    ``block`` samples but the last."""
    rng = np.random.default_rng(n + extra)
    raw = rng.integers(-32768, 32768, (n, 2), dtype=np.int16)
    src = str(tmp_path / "in.ci16")
    with open(src, "wb") as f:
        f.write(raw.tobytes() + bytes(range(extra)))
    got = _raw_blocks(src, block)
    assert [len(b) for b in got[:-1]] == [block] * (len(got) - 1)
    assert all(b.dtype == torch.int16 and b.shape[1] == 2 for b in got)
    cat = torch.cat(got).numpy() if got else np.zeros((0, 2), np.int16)
    assert np.array_equal(cat, raw)
    if n:
        assert np.array_equal(read_iq(src, "ci16"),
                              (raw.astype(np.float32)
                               * np.float32(1.0 / 32767.0)).view(
                                   np.complex64)[:, 0])


def test_raw_reader_stops_early(tmp_path):
    """Leaving the reader after one block stops its thread."""
    src = str(tmp_path / "in.ci16")
    np.zeros((1 << 16, 2), np.int16).tofile(src)
    with Ci16Reader(src, 1024, "cpu") as reader:
        first = reader.next_block()
    assert first.shape == (1024, 2)
    assert not reader._thread.is_alive()


@pytest.mark.parametrize("demod", DEMODS)
def test_rx_raw_route_bit_equal_to_pump(tmp_path, capsys, demod):
    """``rx --format ci16 --device cpu`` (the raw route) writes the same
    bytes as ``rx --format cf32`` on the samples as ``read_iq`` converts
    them (the pump's route), on a recording whose last block is unaligned
    and whose end is not a whole decimation period."""
    n = (1 << 15) + 1003
    x2 = _planar_blocks(demod, 1, n, 12)[0]
    src = str(tmp_path / "in.ci16")
    write_iq(src, (x2[0] + 1j * x2[1]).astype(np.complex64), "ci16")
    conv = str(tmp_path / "in.cf32")
    write_iq(conv, read_iq(src, "ci16"), "cf32")
    outs = {}
    for ingest, path, fmt in (("raw", src, "ci16"), ("pump", conv, "cf32")):
        out = str(tmp_path / f"{ingest}.out.cf32")
        assert port_main(["--device", "cpu", "rx", path, "--format", fmt,
                          "--demod", demod, "--block", "8192",
                          "-o", out]) == 0
        outs[ingest] = open(out, "rb").read()
    assert len(outs["raw"]) == 8 * (n // 4)
    assert outs["raw"] == outs["pump"]
    capsys.readouterr()
