"""Port vs JAX package: models/framesync.py on the CPU.

Seeded numpy bursts (a Zadoff-Chu preamble, an offset, CFO, phase and
noise) go through both packages.  Gates: |rho|^2 within 1e-5 (complex64:
conv1d sums in another order; tests/test_framesync.py's scale gate is
rtol 1e-6 on one side) and 1e-10 (complex128) of JAX's; the detected
start, ``found`` and the decoded payload bits equal; the CFO and phase
estimates within 1e-6 (complex64) and 1e-12 (complex128); the burst scan
calls equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.models import framesync as jfs
from solid_dsp_tpu.models import linear_mod as jlm
from solid_dsp_tpu_torch.models import framesync as tfs
from solid_dsp_tpu_torch.models import linear_mod as tlm
from solid_dsp_tpu_torch.utils import sequences as seq

CPU = "cpu"


def _np(t):
    return t.detach().cpu().numpy()


def _burst(rng, payload, offset, n_total, cfo=0.0, phase=0.0, noise=0.03,
           preamble=None):
    frame = np.concatenate([preamble, payload])
    x = np.zeros(n_total, complex)
    x[offset: offset + len(frame)] = frame
    t = np.arange(n_total)
    x = x * np.exp(1j * (2 * np.pi * cfo * t + phase))
    return x + noise * (rng.standard_normal(n_total)
                        + 1j * rng.standard_normal(n_total))


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("L", [63, 127])
def test_preamble_correlate_and_detect_equal_jax(dtype, L):
    rng = np.random.default_rng(L)
    p = seq.zadoff_chu(5, L)
    x = (37.0 * _burst(rng, np.zeros(0), 211, 1500, phase=1.2, noise=0.3,
                       preamble=p)).astype(dtype)
    r_t, c_t = tfs.preamble_correlate(torch.from_numpy(x), p)
    r_j, c_j = jfs.preamble_correlate(jnp.asarray(x), jnp.asarray(p))
    tol = 1e-5 if dtype == np.complex64 else 1e-10
    np.testing.assert_allclose(_np(r_t), np.asarray(r_j), rtol=0, atol=tol)
    np.testing.assert_allclose(_np(c_t), np.asarray(c_j), rtol=0,
                               atol=tol * np.abs(np.asarray(c_j)).max())
    i_t, pk_t, f_t = tfs.detect_preamble(torch.from_numpy(x), p, 0.4)
    i_j, pk_j, f_j = jfs.detect_preamble(jnp.asarray(x), jnp.asarray(p), 0.4)
    assert int(i_t) == int(i_j) == 211 and bool(f_t) == bool(f_j) is True
    assert i_t.dtype == torch.int32
    assert abs(float(pk_t) - float(pk_j)) <= tol


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_cfo_and_phase_estimators_equal_jax(dtype):
    rng = np.random.default_rng(3)
    p = seq.zadoff_chu(5, 127)
    pp = np.concatenate([p, p])
    t = np.arange(pp.size)
    x = (pp * np.exp(2j * np.pi * 7e-4 * t + 0.4j) + 0.02 * (
        rng.standard_normal(pp.size) + 1j * rng.standard_normal(pp.size))
         ).astype(dtype)
    tol = 1e-6 if dtype == np.complex64 else 1e-12
    xt = torch.from_numpy(x)
    for got, want in (
            (tfs.estimate_cfo_repeated(xt, 127),
             jfs.estimate_cfo_repeated(jnp.asarray(x), 127)),
            (tfs.estimate_cfo_kay(xt[:127], p),
             jfs.estimate_cfo_kay(jnp.asarray(x[:127]), jnp.asarray(p))),
            (tfs.estimate_phase(xt[:127], p),
             jfs.estimate_phase(jnp.asarray(x[:127]), jnp.asarray(p)))):
        assert abs(float(got) - float(want)) <= tol


@pytest.mark.parametrize("offset,n_total", [(313, 1200), (600, 1080)])
def test_framesync_extract_equals_jax(offset, n_total):
    """End to end on QPSK: the payload within 1e-5 of JAX's (complex64),
    every estimate, and the payload bits equal to the sent ones; the
    second burst ends at the capture's end."""
    rng = np.random.default_rng(offset)
    pts = jlm.constellation("psk", 4)
    bits = rng.integers(0, 2, 400).astype(np.int32)
    payload = pts[np.asarray(jlm.bits_to_symbols(bits, 2))]
    p = seq.zadoff_chu(5, 127)
    ts = tfs.FrameSync(p, payload_len=len(payload), threshold=0.4,
                       device=CPU)
    js = jfs.FrameSync(p, payload_len=len(payload), threshold=0.4)
    x = _burst(rng, payload, offset, n_total, 8e-4, 0.77,
               preamble=ts.full_preamble()).astype(np.complex64)
    got, info_t = ts.extract(x)
    want, info_j = js.extract(jnp.asarray(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-5)
    assert int(info_t["start"]) == int(info_j["start"]) == offset
    assert bool(info_t["found"]) and bool(info_j["found"])
    for key in ("rho2", "cfo", "phase"):
        assert abs(float(info_t[key]) - float(info_j[key])) <= 1e-5, key
    got_bits = tlm.symbols_to_bits(tlm.slice_symbols(got, pts), 2)
    np.testing.assert_array_equal(_np(got_bits), bits)


def test_scan_bursts_equals_jax():
    above = np.zeros(300, bool)
    above[[20, 40, 130, 290]] = True
    calls = {}
    for name, fn in (("torch", tfs.scan_bursts), ("jax", jfs.scan_bursts)):
        seen = []

        def decode(lo, hi, seen=seen):
            seen.append((lo, hi))
            return b"", {}
        out = fn(above, frame_samples=50, margin=5, n_total=300,
                 decode_fn=decode)
        calls[name] = (seen, [o[1]["offset"] for o in out])
    assert calls["torch"] == calls["jax"]
