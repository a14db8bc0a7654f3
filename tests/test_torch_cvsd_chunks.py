"""S8's decoder as a chunk-and-join of clamped affine maps, on the CPU.

``models/cvsd.py::cvsd_decode_chunked_torch`` (the association the kernel
``csrc/cvsd_scan.cu`` makes, bit for bit) against the sequential walk
``cvsd_walk_plain`` and JAX's ``cvsd_decode``; the repaired history (raw
words, as JAX keeps them) against the mapping the first kernel made; the
maps' composition law in numpy float64; the encoder's two-branch step in
numpy float32.

Gates: at the codec's defaults (beta 0.9, leak 0.98) the chunked decoder is
within ``CHUNKED_ATOL`` (1e-6) of the walk, at any chunk length, history
and word alphabet; at the edges (leak 1, a constant step, a boost below the
floor's decay, a loud input on the clamps) within tests/test_cvsd.py:47's
1e-5 of the walk and of JAX over 4096 samples (leak 1 lets the walk's own
float32 roundings drift: 1.5e-5 from float64 over 2^15 samples, against
4.2e-6 for the chunked form); JAX within 1e-5 everywhere.  The first
kernel's mapping (every word but 1 taken as 0) misses JAX by more than 1e-2
(a thousand times the gate) on +-1 and {0, 1, 2} words.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from solid_dsp_tpu.models import cvsd as jcvsd
from solid_dsp_tpu_torch.models import cvsd
from solid_dsp_tpu_torch.ops import cuda_cvsd
from test_torch_cvsd_timing import _s8_emulated

JAX_ATOL = 1e-5          # tests/test_cvsd.py:47
EDGES = {"leak 1": {"leak": 1.0},
         "dmin = dmax": {"delta_min": 0.05, "delta_max": 0.05},
         "small gamma": {"gamma": 1e-5},        # < delta_min (1 - beta)
         "loud": {}}


def _lanes(rng, B, N, gain=1.0):
    """Voice (a two-tone at 4x oversampling, scaled 0.2 to 1), random
    levels and voice plus noise, lane by lane, clipped to [-1, 1]."""
    t = np.arange(N) / 32000.0
    voice = 0.5 * np.sin(2 * np.pi * 300 * t) + 0.25 * np.sin(
        2 * np.pi * 800 * t)
    x = np.stack([voice * (0.2 + 0.8 * (b % 5) / 4) for b in range(B)])
    x[1::3] = rng.uniform(-1, 1, x[1::3].shape)
    x[2::3] += 0.02 * rng.standard_normal(x[2::3].shape)
    return np.clip(gain * x, -1, 1).astype(np.float32)


def _bits(x, **kw):
    return cvsd.cvsd_encode(torch.from_numpy(x), **kw)


def _jax(words, **kw):
    return np.asarray(jcvsd.cvsd_decode(np.asarray(words), **kw))


@pytest.mark.parametrize("chunk", [1, 2, 7, 32, 64])
@pytest.mark.parametrize("n_history", [1, 3, 32])
@pytest.mark.parametrize("B,N", [(1, 1), (3, 5), (4, 130), (33, 700)])
def test_chunked_matches_walk_and_jax(chunk, n_history, B, N):
    rng = np.random.default_rng(chunk * 100 + n_history + N)
    bits = _bits(_lanes(rng, B, N), n_history=n_history)
    y = cvsd.cvsd_decode_chunked_torch(bits, n_history=n_history,
                                       chunk=chunk)
    assert y.dtype == torch.float32 and y.shape == (B, N)
    walk = cvsd.cvsd_decode(bits, n_history=n_history)
    assert float((y - walk).abs().max()) <= cvsd.CHUNKED_ATOL
    np.testing.assert_allclose(y.numpy(), _jax(bits, n_history=n_history),
                               atol=JAX_ATOL, rtol=0)
    if N <= chunk:                   # one chunk: the walk itself
        assert torch.equal(y, walk)


@pytest.mark.parametrize("edge", list(EDGES))
@pytest.mark.parametrize("chunk", [2, 7, 32, 64])
@pytest.mark.parametrize("n_history", [1, 3, 32])
def test_chunked_edges(edge, chunk, n_history):
    kw = EDGES[edge]
    rng = np.random.default_rng(chunk + n_history)
    x = _lanes(rng, 3, 4096, gain=4.0 if edge == "loud" else 1.0)
    bits = _bits(x, n_history=n_history, **kw)
    y = cvsd.cvsd_decode_chunked_torch(bits, n_history=n_history,
                                       chunk=chunk, **kw).numpy()
    walk = cvsd.cvsd_decode(bits, n_history=n_history, **kw).numpy()
    np.testing.assert_allclose(y, walk, atol=JAX_ATOL, rtol=0)
    np.testing.assert_allclose(y, _jax(bits, n_history=n_history, **kw),
                               atol=JAX_ATOL, rtol=0)
    if edge == "loud":               # ref held on the clamps, exactly
        assert np.abs(y).max() == 1.0
    if edge == "dmin = dmax":        # a constant step: y_k = 0.98 y_k-1 +- 0.05
        inc = y[:, 1:50] - np.float32(0.98) * y[:, :49]
        assert np.abs(np.abs(inc) - 0.05).max() <= 1e-6


@pytest.mark.parametrize("chunk", [2, 7, 32, 64])
def test_chunked_default_bound_many_lanes(chunk):
    """The stated bound over 96 lanes of 2^12 at the defaults."""
    rng = np.random.default_rng(chunk)
    bits = _bits(_lanes(rng, 96, 4096))
    y = cvsd.cvsd_decode_chunked_torch(bits, chunk=chunk)
    assert float((y - cvsd.cvsd_decode(bits)).abs().max()) \
        <= cvsd.CHUNKED_ATOL


def _first_kernel_decode(words, beta=0.9, gamma=0.01, dmin=0.001, dmax=0.2,
                         n_history=3, leak=0.98):
    """The first kernel's decoder (before the repair) in numpy float32: every
    word other than 1 entered its history as 0."""
    return _s8_emulated((np.asarray(words) == 1).astype(np.int32), True,
                        beta, gamma, dmin, dmax, n_history, leak)


@pytest.mark.parametrize("alphabet", ["nrz", "ternary"])
@pytest.mark.parametrize("n_history", [3, 5])
def test_decode_of_any_words_repaired(alphabet, n_history):
    """+-1 (NRZ) and {0, 1, 2} words: JAX's history compares the raw words
    (-1 == -1 agrees) and signs by word == 1.  The first kernel's mapping
    misses JAX by more than 1e-2; the walk and the chunked decoder (the new
    kernel's association) stay within 1e-5."""
    rng = np.random.default_rng(n_history)
    B, N = 4, 3000
    words = (2 * rng.integers(0, 2, (B, N)) - 1 if alphabet == "nrz"
             else rng.integers(0, 3, (B, N))).astype(np.int32)
    # runs, so that histories of -1 (or 2) agree and the step grows
    words = np.repeat(words[:, : N // 6], 6, axis=1)
    want = _jax(words, n_history=n_history)
    old = _first_kernel_decode(words, n_history=n_history)
    assert np.abs(old - want).max() > 1e-2
    w = torch.from_numpy(words)
    walk = cvsd.cvsd_decode(w, n_history=n_history).numpy()
    np.testing.assert_allclose(walk, want, atol=JAX_ATOL, rtol=0)
    for chunk in (7, 32, 64):
        y = cvsd.cvsd_decode_chunked_torch(w, n_history=n_history,
                                           chunk=chunk).numpy()
        np.testing.assert_allclose(y, want, atol=JAX_ATOL, rtol=0)
        assert np.abs(y - walk).max() <= cvsd.CHUNKED_ATOL


def test_flags_of_raw_words():
    """Agreement over the last n words, zeros before the start."""
    w = torch.tensor([[-1, -1, -1, 0, 0, 2, 2, 2, 1, 1]], dtype=torch.int32)
    one, agree = cvsd._flags(w, 3)
    assert one.tolist() == [[False] * 8 + [True, True]]
    assert agree.tolist() == [[False, False, True, False, False, False,
                               False, True, False, False]]
    one, agree = cvsd._flags(torch.zeros((1, 4), dtype=torch.int32), 32)
    assert agree.all() and not one.any()
    assert cvsd._flags(w, 1)[1].all()


# ----------------------------------------------------- the composition law

def _compose(f, g):
    """Clamped affine maps (a, b, lo, hi), x -> clip(a x + b, lo, hi),
    a >= 0, in numpy float64: f then g."""
    a1, b1, l1, h1 = f
    a2, b2, l2, h2 = g
    return (a2 * a1, a2 * b1 + b2, np.clip(a2 * l1 + b2, l2, h2),
            np.clip(a2 * h1 + b2, l2, h2))


def _apply(f, x):
    return np.clip(f[0] * x + f[1], f[2], f[3])


_maps = st.tuples(st.floats(0.0, 1.0), st.floats(-2.0, 2.0),
                  st.floats(-2.0, 2.0), st.floats(0.0, 2.0)).map(
    lambda m: (m[0], m[1], m[2], m[2] + m[3]))


@settings(max_examples=200, deadline=None)
@given(st.lists(_maps, min_size=3, max_size=8),
       st.lists(st.floats(-3.0, 3.0), min_size=1, max_size=4))
def test_clamped_affine_maps_compose(maps, xs):
    """The composed map equals the maps applied one by one, and the
    composition is associative (to float64 rounding); torch's fold order
    (models/cvsd.py::_map_after) makes the same numbers as numpy's."""
    tol = 1e-12 * 4 ** len(maps)
    f, g, h = maps[:3]
    left = _compose(_compose(f, g), h)
    right = _compose(f, _compose(g, h))
    np.testing.assert_allclose(left, right, atol=tol, rtol=0)
    total = maps[0]
    for m in maps[1:]:
        total = _compose(total, m)
    for x in xs:
        v = x
        for m in maps:
            v = _apply(m, v)
        assert abs(_apply(total, x) - v) <= tol
    t = [torch.tensor(c, dtype=torch.float64) for c in zip(f, g)]
    got = cvsd._map_after(tuple(c[0] for c in t), tuple(c[1] for c in t))
    assert [float(c) for c in got] == [float(c) for c in _compose(f, g)]


def test_join_geometry_and_slopes():
    assert cuda_cvsd.join_geometry(1) == (1, 1)
    assert cuda_cvsd.join_geometry(3) == (4, 1)
    assert cuda_cvsd.join_geometry(256) == (256, 1)
    assert cuda_cvsd.join_geometry(1024) == (256, 4)
    assert cuda_cvsd.join_geometry(1025) == (256, 5)
    full, tail = cuda_cvsd.map_powers(0.9, 64, 64 * 3 + 5)
    a = float(np.float32(0.9))
    assert full == np.prod(np.full(64, a)) and tail == np.prod(np.full(5, a))
    assert cuda_cvsd.map_powers(1.0, 32, 100) == (1.0, 1.0)


# ----------------------------------------------- the encoder's two branches

@pytest.mark.parametrize("edge", list(EDGES))
@pytest.mark.parametrize("n_history", [1, 3, 32])
def test_two_branch_encode_emulated_at_edges(edge, n_history):
    """The encoder's two-branch step with its dropped clamps (numpy float32,
    ``_s8_emulated``) bit-equal to the plain walk at the edges."""
    kw = EDGES[edge]
    rng = np.random.default_rng(n_history)
    x = _lanes(rng, 3, 600, gain=4.0 if edge == "loud" else 1.0)
    want = _bits(x, n_history=n_history, **kw).numpy()
    par = dict(beta=kw.get("beta", 0.9), gamma=kw.get("gamma", 0.01),
               dmin=kw.get("delta_min", 0.001), dmax=kw.get("delta_max", 0.2),
               n_history=n_history, leak=kw.get("leak", 0.98))
    np.testing.assert_array_equal(_s8_emulated(x, False, **par), want)


# parameters outside the decoder's range: the encoder keeps every clamp
LOOSE = {"beta > 1": {"beta": 1.3}, "leak 0": {"leak": 0.0},
         "leak > 1": {"leak": 1.2}, "dmin < 0": {"delta_min": -0.05},
         "dmin > dmax": {"delta_min": 0.3, "delta_max": 0.2},
         "negative slopes": {"beta": -0.5, "leak": -0.9}}


@pytest.mark.parametrize("loose", list(LOOSE))
@pytest.mark.parametrize("n_history", [1, 3])
def test_all_clamps_encode_emulated_any_params(loose, n_history):
    """The encoder's instantiation that keeps every clamp (``_s8_emulated``
    with ``all_clamps``) bit-equal to the plain walk outside the range
    where clamps are dropped (``params_proved`` false there)."""
    kw = LOOSE[loose]
    par = dict(beta=kw.get("beta", 0.9), gamma=0.01,
               dmin=kw.get("delta_min", 0.001), dmax=kw.get("delta_max", 0.2),
               n_history=n_history, leak=kw.get("leak", 0.98))
    assert not cuda_cvsd.params_proved(par["beta"], par["dmin"],
                                       par["dmax"], par["leak"])
    rng = np.random.default_rng(n_history)
    x = _lanes(rng, 3, 400)
    want = _bits(x, n_history=n_history, **kw).numpy()
    np.testing.assert_array_equal(
        _s8_emulated(x, False, all_clamps=True, **par), want)


def test_dropped_clamps_bind_outside_the_range():
    """Why the encoder keeps a second instantiation: beyond beta 1, and
    with delta_min above delta_max, the two-branch step without the
    dropped clamps leaves the walk."""
    rng = np.random.default_rng(5)
    x = _lanes(rng, 3, 400)
    for kw, par in (({"beta": 1.3}, dict(beta=1.3)),
                    ({"delta_min": 0.3, "delta_max": 0.2},
                     dict(dmin=0.3, dmax=0.2))):
        want = _bits(x, **kw).numpy()
        assert np.any(_s8_emulated(x, False, **par) != want)


def test_kernel_parameter_limits():
    for bad in ((1.5, 0.001, 0.2, 0.98), (0.9, 0.3, 0.2, 0.98),
                (0.9, 0.001, 0.2, 0.0), (0.0, 0.001, 0.2, 0.98),
                (0.9, -0.1, 0.2, 0.98)):
        assert not cuda_cvsd.params_proved(*bad)
        with pytest.raises(ValueError, match="beta"):
            cuda_cvsd.check_params(*bad)
    cuda_cvsd.check_params(1.0, 0.05, 0.05, 1.0)
    assert cuda_cvsd.params_proved(0.9, 0.001, 0.2, 0.98)
    w = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_cvsd.cvsd_cuda(w, True, 0.9, 0.01, 0.001, 0.2, 3, 0.98)
    assert cvsd.cvsd_decode_chunked_torch(w[:, :0]).shape == (2, 0)
