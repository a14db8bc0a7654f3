"""S1's FSM entry as a time-parallel chunk-and-join scan, on the CPU.

``ops/agc.py::squelch_fsm_chunked_torch`` runs the three passes of the
card's kernel (csrc/seq_scan.cu, namespace fsm) in torch ops: every chunk's
map from its entry (mode, timer) to its exit summarised as eight tracks
plus its leading run of low steps, the summaries joined by composition,
every chunk walked again from its entry.  The FSM is integer arithmetic and
one compare a step, so the result must be bit-equal to the sequential walk
``squelch_fsm_plain`` (itself held against JAX's ``_squelch_update`` by
tests/test_torch_agc.py): over every hi/lo pattern of up to 10 steps from
every entry state, over seeded rssi walks whose chunk boundaries fall on a
timer's expiry, and inside ``agc_apply_parallel`` against JAX's.  The
kernel runs only on the card (tests/test_torch_cuda.py).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.ops import agc as jagc
from solid_dsp_tpu_torch.ops import agc, cuda_scan

S = agc.SquelchMode
THR, TIMEOUT = -30.0, 20


def _same(got, want):
    return all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("timeout", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("chunk", [1, 3, 4])
def test_chunked_fsm_exhaustive(chunk, timeout):
    """Every hi/lo pattern of length 1 to 10, from every entry mode 0-7 and
    entry timer -2 .. 12, as lanes of one call a length: modes, final mode
    and final timer equal to the sequential walk."""
    modes = torch.arange(8, dtype=torch.int32)
    timers = torch.arange(-2, 13, dtype=torch.int32)
    for T in range(1, 11):
        pats = torch.tensor(list(itertools.product([False, True], repeat=T)))
        p, m, t = torch.meshgrid(torch.arange(len(pats)), torch.arange(8),
                                 torch.arange(len(timers)), indexing="ij")
        rssi = torch.where(pats[p.reshape(-1)], 1.0, -1.0).double()
        m0, t0 = modes[m.reshape(-1)], timers[t.reshape(-1)]
        want = agc.squelch_fsm_plain(rssi, m0, t0, 0.0, timeout)
        got = agc.squelch_fsm_chunked_torch(rssi, m0, t0, 0.0, timeout,
                                            chunk=chunk)
        assert _same(got, want), T


def _walk(rng, T):
    """An rssi track (dB) crossing THR in runs of 1-59 samples, 2-15 dB to
    either side: long runs below it time the squelch out."""
    out, i, above = np.empty(T), 0, True
    while i < T:
        k = int(rng.integers(1, 60))
        out[i:i + k] = THR + (1.0 if above else -1.0) * rng.uniform(
            2.0, 15.0, k)[:T - i]
        i, above = i + k, not above
    return out


# (entry mode, entry timer) of the lanes: every mode, SIGNALLO with timers
# around and far from expiry, a mode outside 0-7
ENTRIES = [(S.ENABLED, 0), (S.RISE, 5), (S.SIGNALHI, 0), (S.FALL, 7),
           (S.SIGNALLO, 1), (S.SIGNALLO, 3), (S.SIGNALLO, 0),
           (S.SIGNALLO, -4), (S.SIGNALLO, 40), (S.TIMEOUT, 2), (S.UNKNOWN, 9),
           (S.DISABLED, 1), (11, 3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shift", [-1, 0, 1])
def test_chunked_fsm_seeded_walks(dtype, shift):
    """Seeded rssi walks (one a lane, 13 lanes in mixed entry states,
    4096 steps) that visit every state; the chunk length set so that chunk
    boundaries fall one step before, on and one step after the first
    timer expiry of lane 0; and the kernel's chunk length: bit-equal."""
    rng = np.random.default_rng(5)
    T = 4096
    rssi = torch.from_numpy(np.stack([_walk(rng, T) for _ in ENTRIES])).to(
        dtype)
    m0 = torch.tensor([m for m, _ in ENTRIES], dtype=torch.int32)
    t0 = torch.tensor([t for _, t in ENTRIES], dtype=torch.int32)
    want = agc.squelch_fsm_plain(rssi, m0, t0, THR, TIMEOUT)
    visited = set(torch.unique(want[0]).tolist())
    assert set(range(1, 8)) <= visited
    expiry = int(torch.nonzero(want[0][0] == S.TIMEOUT)[0])
    chunk = expiry + shift          # a boundary at expiry + shift
    for c in (chunk, cuda_scan.FSM_CHUNK):
        got = agc.squelch_fsm_chunked_torch(rssi, m0, t0, THR, TIMEOUT,
                                            chunk=c)
        assert _same(got, want), c


def test_chunked_fsm_short_and_ragged_blocks():
    """Blocks of 1, 33 and 1000 steps (not a multiple of the chunk) and a
    scalar lane: bit-equal; an empty block returns the entry state."""
    rng = np.random.default_rng(6)
    for T in (1, 33, 1000):
        r = torch.from_numpy(_walk(rng, T))
        m0 = torch.tensor(S.SIGNALLO, dtype=torch.int32)
        t0 = torch.tensor(2, dtype=torch.int32)
        want = agc.squelch_fsm_plain(r, m0, t0, THR, TIMEOUT)
        got = agc.squelch_fsm_chunked_torch(r, m0, t0, THR, TIMEOUT)
        assert _same(got, want) and got[0].shape == (T,)
    modes, m, t = agc.squelch_fsm_chunked_torch(
        torch.zeros((3, 0)), torch.tensor(S.FALL, dtype=torch.int32),
        torch.tensor(4, dtype=torch.int32), THR, TIMEOUT)
    assert modes.shape == (3, 0) and m.tolist() == [S.FALL] * 3
    assert t.tolist() == [4] * 3


@pytest.mark.parametrize("chunk", [3, cuda_scan.FSM_CHUNK])
def test_parallel_agc_with_chunked_fsm_matches_jax(monkeypatch, chunk):
    """agc_apply_parallel with the squelch on, its FSM pass by the chunked
    passes, against JAX's agc_apply_parallel (whose FSM is a lax.scan):
    bursts that squelch, time out and recover; y atol 1e-11 (the Newton
    solve's tolerance, tests/test_torch_agc.py), final mode and timer
    equal, and the modes equal to the sequential walk's."""
    rng = np.random.default_rng(8)
    parts = []
    for k in range(6):                  # loud, then 40 dB down, in turns
        n = int(rng.integers(300, 600))
        amp = 1.0 if k % 2 == 0 else 0.01
        parts.append(amp * np.exp(1j * rng.standard_normal(n)))
    x = np.concatenate(parts)
    calls = []

    def chunked(rssi, mode, timer, threshold, timeout):
        got = agc.squelch_fsm_chunked_torch(rssi, mode, timer, threshold,
                                            timeout, chunk=chunk)
        calls.append(_same(got, agc.squelch_fsm_plain(rssi, mode, timer,
                                                      threshold, timeout)))
        return got

    monkeypatch.setattr(agc, "_squelch_fsm", chunked)
    st = agc.agc_init(torch.float64, "cpu")
    st["mode"] = torch.tensor(S.ENABLED, dtype=torch.int32)
    fallbacks = agc.agc_apply_parallel.fallbacks
    y, s = agc.agc_apply_parallel(st, torch.from_numpy(x), 0.05, 1.0, THR,
                                  TIMEOUT)
    assert agc.agc_apply_parallel.fallbacks == fallbacks   # the Newton path
    jst = dict(jagc.agc_init(jnp.float64))
    jst["mode"] = jnp.asarray(S.ENABLED, dtype=jnp.int32)
    jy, js = jagc.agc_apply_parallel(jst, jnp.asarray(x), 0.05, 1.0, THR,
                                     TIMEOUT)
    assert calls == [True]
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-11)
    assert int(s["mode"]) == int(js["mode"])
    assert int(s["timer"]) == int(js["timer"])
