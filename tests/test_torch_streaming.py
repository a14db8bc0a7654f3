"""The port's streaming layer against the JAX package's: the reference's ring
buffer and window, chain composition and composed checkpoints.

Tolerances: ``ring.CircularBuffer`` and ``Window`` exact (the same op
sequences, drawn by hypothesis, give equal results and the same error
codes).  ``compose``: the config-4 stages (NCO 0.2, 64-tap decimating FIR
by 4, AGC, FM) over 4 blocks with the state carried within atol 1e-5 of
the JAX package's composed chain (tests/test_compose.py:42's gate) and of
the port's fused ``RxChain``; the exact and parallel AGC stages and the IIR
stage within 1e-5 of max|y| (float32 scans: the libraries' logf/expf differ
in the last ulp, tests/test_torch_agc.py); ``stream_scan`` bit-equal to
block-by-block application.  Composed checkpoints cross-load both ways with
every leaf equal in value, shape and dtype (the stage-named u32 phase word,
``()`` states, a nested compose).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from solid_dsp_tpu.streaming import ring as jring
from solid_dsp_tpu.streaming import state as jstate
from solid_dsp_tpu.streaming import window as jwindow
from solid_dsp_tpu_torch.models.rx_chain import RxChainConfig, make_rx_chain
from solid_dsp_tpu_torch.streaming import ring as pring
from solid_dsp_tpu_torch.streaming import state as pstate
from solid_dsp_tpu_torch.streaming import window as pwindow

# the modules: each package's ``streaming.compose`` attribute is the function
jc = importlib.import_module("solid_dsp_tpu.streaming.compose")
pc = importlib.import_module("solid_dsp_tpu_torch.streaming.compose")

CPU = "cpu"
L_BLOCK = 4096
N_BLOCKS = 4


# ---------------------------------------------------------------- ring

RING_OPS = st.lists(st.one_of(
    st.tuples(st.just("push"), st.integers(-50, 50)),
    st.tuples(st.just("append"), st.integers(0, 9)),
    st.tuples(st.just("pop"), st.just(0)),
    st.tuples(st.just("release"), st.integers(-2, 9)),
    st.tuples(st.just("linearize"), st.just(0)),
    st.tuples(st.just("to_vec"), st.just(0)),
    st.tuples(st.just("getitem"), st.integers(0, 11)),
    st.tuples(st.just("reset"), st.just(0)),
), max_size=40)


def _run_ring(mod, ops, cap):
    cb = mod.CircularBuffer(cap, dtype=np.complex128)
    seq, log = 0, []
    for op, arg in ops:
        try:
            if op == "push":
                r = cb.push(complex(arg, -arg))
            elif op == "append":
                r = cb.append(np.arange(seq, seq + arg) * (1 + 1j))
                seq += arg
            elif op == "release":
                r = cb.release(arg)
            elif op == "to_vec":
                r = cb.to_vec().tolist()
            elif op == "getitem":
                r = cb[arg % cap]
            else:
                r = getattr(cb, op)()
            log.append(("ok", r, len(cb), cb.reserved(), cb.read_index(),
                        cb.write_index(), cb.is_full(), repr(cb)))
        except mod.BufferError as e:
            log.append(("err", e.code, str(e)))
    return log


@settings(max_examples=80, deadline=None, database=None)
@given(ops=RING_OPS, cap=st.integers(1, 12))
def test_ring_op_sequences_match_jax(ops, cap):
    assert _run_ring(pring, ops, cap) == _run_ring(jring, ops, cap)


def test_ring_from_vec_and_codes():
    for mod in (pring, jring):
        cb = mod.CircularBuffer.from_vec([1.0, 2.0, 3.0])
        assert cb.is_full() and cb.to_vec().tolist() == [1.0, 2.0, 3.0]
        with pytest.raises(ValueError):
            mod.CircularBuffer(0)
    for k in ("FULL", "EMPTY", "NOT_ENOUGH", "NEGATIVE", "TOO_MANY_ELEMENTS"):
        assert getattr(pring.BufferErrorCode, k) == getattr(
            jring.BufferErrorCode, k)


# -------------------------------------------------------------- window

WINDOW_OPS = st.lists(st.one_of(
    st.tuples(st.just("push"), st.integers(-50, 50)),
    st.tuples(st.just("write"), st.integers(0, 6)),
    st.tuples(st.just("getitem"), st.integers(0, 15)),
    st.tuples(st.just("to_vec"), st.just(0)),
    st.tuples(st.just("reset"), st.just(0)),
), max_size=30)


def _run_window(mod, ops, cap, delay):
    w = mod.Window(cap, delay)
    log, seq = [], 0
    for op, arg in ops:
        if op == "push":
            r = w.push(complex(arg, 1))
        elif op == "write":
            r = w.write(np.arange(seq, seq + arg) + 0.5j)
            seq += arg
        elif op == "getitem":
            r = w[arg % (cap + delay)]
        elif op == "to_vec":
            r = w.to_vec().tolist()
        else:
            r = w.reset()
        log.append((r, len(w), w.capacity(), w.delay, repr(w)))
    return log


@settings(max_examples=80, deadline=None, database=None)
@given(ops=WINDOW_OPS, cap=st.integers(1, 8), delay=st.integers(0, 7))
def test_window_op_sequences_match_jax(ops, cap, delay):
    assert (_run_window(pwindow, ops, cap, delay)
            == _run_window(jwindow, ops, cap, delay))


def test_window_quirks_and_validation():
    w = pwindow.Window(4, delay=2)
    w.write([1, 2, 3, 4, 5])
    # the delayed view reads from offset 2; the 2 delay slots stay zero
    assert w.to_vec().tolist() == [3, 2, 0, 0]
    for mod in (pwindow, jwindow):
        with pytest.raises(ValueError):
            mod.Window(0)
        with pytest.raises(ValueError):
            mod.Window(2, delay=-1)


# ------------------------------------------------------------- compose

def _blocks(seed=0, n=N_BLOCKS, L=L_BLOCK):
    rng = np.random.default_rng(seed)
    k = np.arange(n * L)
    x = 0.1 * np.exp(2j * np.pi * (0.2 / (2 * np.pi) + 0.001) * k)
    x = x + 0.003 * (rng.standard_normal(n * L)
                     + 1j * rng.standard_normal(n * L))
    return x.astype(np.complex64).reshape(n, L)


def _taps():
    return np.asarray(RxChainConfig().design_taps(), np.complex64)


def _stages(mod, agc_mode="block", iir=False, **dev):
    st_ = [mod.stage_nco_mix_down(0.2, **dev),
           mod.stage_fir_decim(_taps(), 4, **dev),
           mod.stage_agc(0.01, mode=agc_mode, **dev),
           mod.stage_fm_demod(0.1, **dev)]
    if iir:
        st_.append(mod.stage_iir([0.2, 0.3, 0.1], [1.0, -0.5],
                                 method="scan", **dev))
    return st_


def _run_port(stages, blocks):
    init, apply = pc.compose(*stages)
    state, ys = init(), []
    for xb in blocks:
        y, state = apply(state, torch.from_numpy(xb))
        ys.append(y.numpy())
    return np.concatenate(ys), state


def _run_jax(stages, blocks):
    init, apply = jc.compose(*stages)
    state, ys = init(), []
    for xb in blocks:
        y, state = apply(state, jnp.asarray(xb))
        ys.append(np.asarray(y))
    return np.concatenate(ys), state


@pytest.mark.parametrize("agc_mode,iir", [("block", False),
                                          ("exact", False),
                                          ("parallel", False),
                                          ("exact", True)])
def test_composed_chain_matches_jax(agc_mode, iir):
    blocks = _blocks(seed=1)
    yp, sp = _run_port(_stages(pc, agc_mode, iir, device=CPU), blocks)
    yj, sj = _run_jax(_stages(jc, agc_mode, iir), blocks)
    assert yp.dtype == yj.dtype and yp.shape == yj.shape
    tol = 1e-5 if agc_mode == "block" else 1e-5 * np.abs(yj).max()
    np.testing.assert_allclose(yp, yj, rtol=0, atol=tol)
    assert int(sp["nco_down"]) == int(sj["nco_down"])
    assert int(sp["fir_decim"]["phase"]) == int(sj["fir_decim"]["phase"])


def test_composed_chain_matches_fused_rx_chain():
    """The composed config-4 stages against the port's fused chain, as
    tests/test_compose.py holds the JAX package's."""
    blocks = _blocks(seed=2)
    y, _ = _run_port(_stages(pc, device=CPU), blocks)
    init, apply = make_rx_chain(RxChainConfig(), CPU)
    state, want = init(), []
    for xb in blocks:
        out, state = apply(state, torch.from_numpy(xb))
        want.append(out.numpy())
    np.testing.assert_allclose(y, np.concatenate(want), atol=1e-5)


def test_stream_scan_equals_block_by_block():
    blocks = _blocks(seed=3)
    init, apply = pc.compose(*_stages(pc, device=CPU))
    ys, final = pc.stream_scan(apply, init(), torch.from_numpy(blocks))
    y1, s1 = _run_port(_stages(pc, device=CPU), blocks)
    assert ys.shape == (N_BLOCKS, L_BLOCK // 4)
    assert torch.equal(ys.reshape(-1), torch.from_numpy(y1))
    for a, b in zip(pstate._leaves(final), pstate._leaves(s1)):
        assert torch.equal(a, b)


def test_name_dedup_nesting_and_validation():
    f1 = pc.stage_fn(lambda x: x * 2, name="gain")
    f2 = pc.stage_fn(lambda x: x + 1, name="gain")
    init, apply = pc.compose(f1, f2)
    assert sorted(init().keys()) == ["gain", "gain_2"]
    y, _ = apply(init(), torch.tensor([1.0, 2.0]))
    assert y.tolist() == [3.0, 5.0]
    outer = pc.Stage("inner", *pc.compose(f1, f2))
    init2, apply2 = pc.compose(outer, pc.stage_fn(torch.abs, name="mag"))
    assert apply2(init2(), torch.tensor([-2.0]))[0].tolist() == [3.0]
    with pytest.raises(ValueError):
        pc.compose()
    with pytest.raises(ValueError):
        pc.stage_agc(0.01, mode="bogus")


def test_fir_stage_and_mix_inverse():
    from scipy.signal import lfilter

    rng = np.random.default_rng(0)
    x = (rng.standard_normal(1024) + 1j * rng.standard_normal(1024)
         ).astype(np.complex64)
    h = np.array([0.5, 0.25, 0.25], np.complex64)
    init, apply = pc.compose(pc.stage_fir(h, device=CPU))
    y, _ = apply(init(), torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), lfilter(h[::-1], [1.0], x),
                               atol=1e-5)
    init, apply = pc.compose(pc.stage_nco_mix_up(0.3, device=CPU),
                             pc.stage_nco_mix_down(0.3, device=CPU))
    xb = torch.from_numpy(_blocks()[0])
    np.testing.assert_allclose(apply(init(), xb)[0].numpy(), xb.numpy(),
                               atol=1e-5)


# --------------------------------------------------- composed checkpoints

def _nested(mod, **dev):
    """A composed chain with every tricky node: two NCO stages (the phase
    word under the stages' names), ``()`` states and a nested compose."""
    inner = mod.Stage("inner", *mod.compose(
        mod.stage_fn(lambda x: x, name="id"),
        mod.stage_nco_mix_down(0.1, **dev)))
    return (mod.stage_nco_mix_down(0.2, **dev), inner,
            mod.stage_fn(lambda x: x * 1, name="id"),
            mod.stage_fir_decim(_taps(), 4, **dev),
            mod.stage_nco_mix_down(0.05, **dev),
            mod.stage_agc(0.01, **dev), mod.stage_fm_demod(0.1, **dev))


def test_composed_treedef_matches_jax():
    blocks = _blocks(seed=4, n=2)
    _, sp = _run_port(_nested(pc, device=CPU), blocks)
    _, sj = _run_jax(_nested(jc), blocks)
    assert pstate.treedef_repr(sp) == str(jax.tree_util.tree_structure(sj))
    assert "nco_down_2" in sp and sp["inner"]["id"] == ()
    assert sp["nco_down_2"].dtype == torch.int64
    np.testing.assert_array_equal(
        pstate.treedef_bytes(pstate.treedef_repr(sp)),
        jstate.treedef_bytes(jax.tree_util.tree_structure(sj)))


def _assert_same_leaves(port_state, jax_state):
    got = pstate._leaves(pstate.to_numpy(port_state))
    want = [np.asarray(a) for a in jax.tree_util.tree_leaves(jax_state)]
    assert len(got) == len(want) == 11
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_jax_composed_checkpoint_loads_into_port(tmp_path):
    blocks = _blocks(seed=5, n=2)
    _, sj = _run_jax(_nested(jc), blocks)
    path = str(tmp_path / "jax_composed.npz")
    sj.save(path)
    init, apply = pc.compose(*_nested(pc, device=CPU))
    st_ = pstate.ChainState.load(path, like=init())
    assert st_["nco_down"].dtype == torch.int64
    assert isinstance(st_["inner"], pstate.ChainState)
    _assert_same_leaves(st_, sj)
    # the stream continues in the port as it does in JAX
    y, _ = apply(st_, torch.from_numpy(blocks[0]))
    _, japply = jc.compose(*_nested(jc))
    yj, _ = japply(sj, jnp.asarray(blocks[0]))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=1e-5)


def test_port_composed_checkpoint_loads_into_jax(tmp_path):
    blocks = _blocks(seed=6, n=2)
    _, sp = _run_port(_nested(pc, device=CPU), blocks)
    path = sp.save(str(tmp_path / "port_composed"))
    assert path.endswith(".npz")
    with np.load(path) as data:
        assert data["leaf_0"].dtype == np.float32     # agc energy
        words = [data[f] for f in data.files
                 if f.startswith("leaf_") and data[f].dtype == np.uint32]
        assert len(words) == 3                        # the three NCO words
    jinit, _ = jc.compose(*_nested(jc))
    sj = jstate.ChainState.load(path, like=jinit())
    _assert_same_leaves(sp, sj)
    # and round trip in the port
    back = pstate.ChainState.load(path, like=sp)
    for a, b in zip(pstate._leaves(back), pstate._leaves(sp)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_atomic_savez_matches_jax(tmp_path):
    data = {"a": np.arange(5), "b": np.ones((2, 3), np.float32)}
    p = pstate.atomic_savez(str(tmp_path / "ck"), **data)
    j = jstate.atomic_savez(str(tmp_path / "jk"), **data)
    assert p.endswith("ck.npz") and j.endswith("jk.npz")
    assert not list(tmp_path.glob(".tmp_*"))
    with np.load(p) as a, np.load(j) as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
