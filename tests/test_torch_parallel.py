"""The port's ``parallel/`` on gloo ranks vs the JAX package's on the fake
8-device CPU mesh, at the same mesh shapes.

Each mesh shape spawns its ranks once (tests/torch_dist.py); every case is
its own test.  Gates:

* halo primitives: JAX's values exactly (tests/test_parallel.py's
  test_halo_primitives on a (1, 4) mesh);
* the "xla" channelizer at complex128: rtol 1e-8 (JAX's own gate against
  the single-chip channelizer); tails exact;
* the "fused" channelizer at M = 256: >= 90 dB against JAX's x3 (the
  gate tests/test_torch_channelizer.py holds K4's plain version to) and >= 115 dB against the
  port's single-card fused channelizer (JAX's own gate);
* the sharded rx chain at complex64, x3, two blocks with the state carried:
  >= 90 dB (QPSK >= 60 dB), ``nco_theta`` and ``fir_tail`` equal, AGC gain
  and energy rtol 1e-5, ``fm_prev`` rtol 1e-4 for FM and unchanged for AM,
  QPSK and none (the gates of tests/test_torch_rx_chain*.py);
* ``sharded_fir`` at complex128: rtol 1e-9 (JAX's own gate); tails exact;
* interop: JAX's global sharded state to per-rank tensors and back exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import torch
import torch_dist
from solid_dsp_tpu import parallel
from solid_dsp_tpu.models.channelizer import channelizer_taps
from solid_dsp_tpu.models.rx_chain import RxChainConfig as JaxRxChainConfig
from solid_dsp_tpu_torch.models.channelizer import make_fused_channelizer
from torch_parity import snr_db

L_CHAN = 16 * 64                       # the "xla" channelizer, M = 16
M_FUSED = 256
L_FUSED = M_FUSED * 8 * 8 // 2         # a block: 8 frame rows a shard
RX_C = 4
RX_L = {"aligned": 4096, "pieces": 2000}   # per block; 64*M divides the
                                           # first's shards, not the second's
RX_DEMODS = ["fm", "am", "qpsk", "none"]
FIR_TAPS = np.hamming(33) / 33


def _cnoise(rng, shape, scale=1.0):
    return scale * (rng.standard_normal(shape)
                    + 1j * rng.standard_normal(shape))


def _tone_blocks(L, seed, f, C=None, n=2):
    """n consecutive blocks of a tone at f cycles/sample plus noise,
    complex128: (C, L) streams (one tone frequency a stream) or (L,)."""
    rng = np.random.default_rng(seed)
    k = np.arange(n * L)
    rows = [0.1 * np.exp(2j * np.pi * (f + 0.003 * c) * k)
            + _cnoise(rng, n * L, 0.01) for c in range(C or 1)]
    x = np.stack(rows) if C else rows[0]
    return [x[..., b * L:(b + 1) * L] for b in range(n)]


def _qpsk_blocks(L, seed, C, n=2):
    """C QPSK streams (symbols held for 32 samples) at 0.2 + 5e-4
    rad/sample plus noise, complex128 (C, L) blocks."""
    rng = np.random.default_rng(seed)
    gray = np.array([1 + 1j, -1 + 1j, 1 - 1j, -1 - 1j]) / np.sqrt(2.0)
    k = np.arange(n * L)
    x = np.stack([0.5 * gray[rng.integers(0, 4, n * L // 32 + 1)][k // 32]
                  * np.exp(1j * (0.2 + 5e-4) * k) + _cnoise(rng, n * L, 0.05)
                  for _ in range(C)])
    return [x[:, b * L:(b + 1) * L] for b in range(n)]


def _rx_blocks(demod, size):
    L = RX_L[size]
    if demod == "qpsk":
        return [b.astype(np.complex64) for b in _qpsk_blocks(L, 5, RX_C)]
    return [b.astype(np.complex64)
            for b in _tone_blocks(L, 4, 0.2 / (2 * np.pi) + 0.001, RX_C)]


def _planar_blocks():
    return [np.stack([b.real, b.imag]).astype(np.float32)
            for b in _tone_blocks(4 * 2048, 6, 0.2 / (2 * np.pi) + 0.001)]


def _rx_cfg(demod, planar=False, unfused=False):
    cfg = dict(agc_mode="block", demod=demod, nco_mode="exact",
               fused_ddc="auto", fir_precision="x3")
    if planar:
        cfg.update(fused_ddc="on", input_format="planar")
    if unfused:
        # the LUT-NCO parity staging; "highest", as JAX's CPU convolution
        # refuses "x3"
        cfg.update(nco_mode="lut", fir_precision="highest")
    return cfg


def _fir_blocks(mesh_shape):
    C = 2 * mesh_shape[0]
    return [np.stack(b) for b in zip(*[
        _tone_blocks(1024, 10 + c, 0.01 * (c + 1)) for c in range(C)])]


# ------------------------------------------------------------ the JAX side

@functools.lru_cache(maxsize=None)
def _jax_rx(demod, size, mesh_shape, planar=False, unfused=False):
    """The JAX sharded chain over the blocks: (outputs, global states as
    plain dicts of numpy)."""
    mesh = parallel.make_mesh(*mesh_shape)
    cfg = JaxRxChainConfig(dtype=jnp.complex64,
                           **_rx_cfg(demod, planar, unfused))
    init, apply = parallel.make_sharded_rx_chain(cfg, mesh)
    st = init() if planar else init(RX_C)
    blocks = _planar_blocks() if planar else _rx_blocks(demod, size)
    outs, states = [], []
    for x in blocks:
        out, st = apply(st, jnp.asarray(x))
        outs.append(np.asarray(out))
        states.append({k: ({kk: np.asarray(vv) for kk, vv in v.items()}
                           if isinstance(v, dict) else np.asarray(v))
                       for k, v in st.items()})
    return outs, states


@functools.lru_cache(maxsize=None)
def _jax_channelizer(mesh_shape):
    mesh = parallel.make_mesh(*mesh_shape)
    init, apply = parallel.make_sharded_channelizer(16, 8, mesh,
                                                    dtype=jnp.complex128)
    tail = init()
    out = []
    for x in _tone_blocks(L_CHAN, 7, 3.0 / 16):
        Y, tail = apply(tail, jnp.asarray(x))
        out.append((np.asarray(Y), np.asarray(tail)))
    return out


@functools.lru_cache(maxsize=None)
def _jax_fused():
    mesh = parallel.make_mesh(1, 4)
    init, apply = parallel.make_sharded_channelizer(
        M_FUSED, 8, mesh=mesh, frontend="fused", precision="x3",
        dtype=jnp.complex64)
    tail = init()
    out = []
    for x in _fused_blocks():
        Y, tail = apply(tail, jnp.asarray(x))
        out.append((np.asarray(Y), np.asarray(tail)))
    return out


def _fused_blocks():
    x = _cnoise(np.random.default_rng(13), 2 * L_FUSED).astype(np.complex64)
    return [x[:L_FUSED], x[L_FUSED:]]


@functools.lru_cache(maxsize=None)
def _jax_fir(mesh_shape):
    mesh = parallel.make_mesh(*mesh_shape)
    apply = parallel.sharded_fir(jnp.asarray(FIR_TAPS, jnp.complex128), mesh)
    blocks = _fir_blocks(mesh_shape)
    tail = jnp.zeros((blocks[0].shape[0], len(FIR_TAPS) - 1), jnp.complex128)
    out = []
    for x in blocks:
        y, tail = apply(tail, jnp.asarray(x))
        out.append((np.asarray(y), np.asarray(tail)))
    return out


@functools.lru_cache(maxsize=None)
def _jax_halo_primitives(n):
    mesh = parallel.make_mesh(channel=1, time=n)

    def f(x):
        return (parallel.left_halo(x, "time"), parallel.right_halo(x, "time"),
                parallel.from_last_shard(x, "time"),
                parallel.time_offset("time", x.shape[-1])[None])

    g = jax.shard_map(f, mesh=mesh, in_specs=P("time"),
                      out_specs=(P("time"),) * 4)
    return [np.asarray(a) for a in g(jnp.arange(16.0))]


# ------------------------------------------------------------ the port side

def _cases(shape):
    """Every case of the port on one mesh shape: (key, shape, name,
    kwargs), keyed by (shape, name) for the one spawn of both shapes."""
    cases = [
        ("prim", "halo_primitives", dict(x=np.arange(16.0))),
        ("chan", "channelizer", dict(M=16, K=8, frontend="xla",
                                     blocks=_tone_blocks(L_CHAN, 7, 3.0 / 16),
                                     dtype="complex128")),
        ("unfused", "rx_chain", dict(cfg=_rx_cfg("fm", unfused=True),
                                     blocks=_rx_blocks("fm", "aligned"),
                                     num_channels=RX_C)),
        ("fir", "fir", dict(taps=FIR_TAPS, blocks=_fir_blocks(shape))),
    ]
    if shape == (1, 4):
        cases += [
            ("fused", "channelizer", dict(M=M_FUSED, K=8, frontend="fused",
                                          blocks=_fused_blocks(),
                                          dtype="complex64")),
            ("planar", "rx_chain", dict(cfg=_rx_cfg("fm", planar=True),
                                        blocks=_planar_blocks())),
            ("interop", "state_round_trip", dict(
                tree=_jax_rx("fm", "aligned", shape, planar=True)[1][0],
                tails=_jax_tails()))]
    else:
        cases += [
            (f"rx_{d}_{s}", "rx_chain", dict(cfg=_rx_cfg(d),
                                             blocks=_rx_blocks(d, s),
                                             num_channels=RX_C))
            for d in RX_DEMODS for s in RX_L if s == "aligned" or d == "fm"]
        cases.append(("interop", "state_round_trip", dict(
            tree=_jax_rx("fm", "aligned", shape)[1][0], tails=_jax_tails())))
    return [((shape, key), shape, name, kw) for key, name, kw in cases]


def _jax_tails():
    """The JAX package's replicated tails: the "xla" channelizer's
    (K*M - 1,), the fused channelizer's (2, 8, M) rows and K9's (K, M)."""
    x = _fused_blocks()[1]
    return {"xla": _jax_channelizer((2, 2))[0][1],
            "fused": _jax_fused()[0][1],
            "k9": x[-8 * M_FUSED:].reshape(8, M_FUSED)}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Each of 4 ranks' results of every case on both mesh shapes."""
    return torch_dist.run_ranks(tmp_path_factory.mktemp("parallel"), 4,
                                _cases((1, 4)) + _cases((2, 2)))


def _on(spawned, shape):
    return shape, [{key: v for (s, key), v in r.items() if s == shape}
                   for r in spawned]


@pytest.fixture
def r14(spawned):
    return _on(spawned, (1, 4))


@pytest.fixture
def r22(spawned):
    return _on(spawned, (2, 2))


@pytest.fixture(params=["r14", "r22"])
def ranks(request):
    """(mesh shape, each rank's results) on each mesh shape in turn."""
    return request.getfixturevalue(request.param)


def _gather(res, shape, key, field, b, spec):
    return torch_dist.assemble([r[key][field][b] for r in res], shape, spec)


# ------------------------------------------------------------ the tests

@pytest.mark.parametrize("name", ["left", "right", "last", "offset"])
def test_halo_primitive_matches_jax(r14, name):
    """left_halo (shard 0 gets zeros), right_halo, from_last_shard and
    time_offset on arange(16) split over time: JAX's values exactly."""
    shape, res = r14
    want = dict(zip(["left", "right", "last", "offset"],
                    _jax_halo_primitives(4)))[name]
    parts = [np.atleast_1d(np.asarray(r["prim"][name])) for r in res]
    got = torch_dist.assemble(parts, shape, ("time",))
    np.testing.assert_array_equal(got, want)


def test_sharded_xla_channelizer_matches_jax(ranks):
    """Tap-parallel over channel, overlap-save over time, two blocks:
    complex128 within rtol 1e-8 of JAX's, tails exact."""
    shape, res = ranks
    for b, (Yj, tj) in enumerate(_jax_channelizer(shape)):
        Y = _gather(res, shape, "chan", "Y", b, ("time", "channel"))
        np.testing.assert_allclose(Y, Yj, rtol=1e-8, atol=1e-10)
        for r in res:
            np.testing.assert_array_equal(r["chan"]["tail"][b], tj)


def test_sharded_fir_matches_jax(ranks):
    """Two blocks of (C, L) streams: complex128 within rtol 1e-9 of JAX's
    sharded FIR, tails exact."""
    shape, res = ranks
    for b, (yj, tj) in enumerate(_jax_fir(shape)):
        y = _gather(res, shape, "fir", "y", b, ("channel", "time"))
        np.testing.assert_allclose(y, yj, rtol=1e-9, atol=1e-12)
        tail = _gather(res, shape, "fir", "tail", b, ("channel",))
        np.testing.assert_array_equal(tail, tj)


def test_local_unfused_raises(ranks):
    """local_unfused (fused_ddc="auto" with nco_mode="lut": the LUT mix,
    fir_decim_apply with the mixed stream's halo, the block AGC on the
    time-averaged energy, FM's seam), ported: C = 4 streams, two blocks
    with the state carried, on both mesh shapes: >= 90 dB against JAX's
    sharded chain; the phase word and fir_phase equal, the AGC as the
    single-card tests hold it, fm_prev rtol 1e-4, and the FIR tail (the
    MIXED stream, a complex product XLA's CPU takes with FMA) within 1e-6."""
    shape, res = ranks
    outs, states = _jax_rx("fm", "aligned", shape, unfused=True)
    for b, (want, jst) in enumerate(zip(outs, states)):
        got = _gather(res, shape, "unfused", "out", b, ("channel", "time"))
        assert got.shape == want.shape and got.dtype == want.dtype
        assert snr_db(got, want) >= 90.0
        st = res[0]["unfused"]["state"][b]
        np.testing.assert_allclose(st["fir_tail"], jst["fir_tail"], rtol=0,
                                   atol=1e-6)
        _check_state({**st, "fir_tail": jst["fir_tail"]}, jst, "fm")


def test_sharded_fused_channelizer(r14):
    """K4's plain version a time shard at M = 256, two blocks: >= 90 dB
    against JAX's sharded fused x3 and >= 115 dB against the port's
    single-card fused channelizer; tail rows exact."""
    shape, res = r14
    got = np.concatenate([_gather(res, shape, "fused", "Y", b, ("time",))
                          for b in range(2)])
    jax_out = _jax_fused()
    want = np.concatenate([Y for Y, _ in jax_out])
    assert snr_db(got, want) >= 90.0
    apply1 = make_fused_channelizer(channelizer_taps(M_FUSED, 8), M_FUSED,
                                    L_FUSED // M_FUSED, TF=32, mode="x3",
                                    device="cpu")
    t1 = torch.zeros((2, 8, M_FUSED))
    refs = []
    for x in _fused_blocks():
        Y2, t1 = apply1(t1, torch.from_numpy(np.stack([x.real, x.imag])))
        refs.append((Y2[:, :M_FUSED] + 1j * Y2[:, M_FUSED:]).numpy())
    assert snr_db(got, np.concatenate(refs)) >= 115.0
    for r in res:
        np.testing.assert_array_equal(r["fused"]["tail"][1],
                                      jax_out[1][1])


def _check_state(got, want, demod):
    assert got["nco_theta"].dtype == np.uint32
    np.testing.assert_array_equal(got["nco_theta"], want["nco_theta"])
    np.testing.assert_array_equal(got["fir_tail"], want["fir_tail"])
    for k in ("gain", "energy"):
        np.testing.assert_allclose(got["agc"][k], want["agc"][k], rtol=1e-5)
    for k in ("lock", "mode", "timer"):
        np.testing.assert_array_equal(got["agc"][k], want["agc"][k])
    if demod == "fm":
        np.testing.assert_allclose(got["fm_prev"], want["fm_prev"],
                                   rtol=1e-4)
    else:       # carried unchanged, as the single-card chain carries it
        np.testing.assert_array_equal(got["fm_prev"], want["fm_prev"])
        np.testing.assert_array_equal(got["fm_prev"], 1.0)
    np.testing.assert_array_equal(got["fir_phase"], want["fir_phase"])


@pytest.mark.parametrize("demod,size", [("fm", "aligned"), ("fm", "pieces"),
                                        ("am", "aligned"),
                                        ("qpsk", "aligned"),
                                        ("none", "aligned")])
def test_sharded_rx_chain_matches_jax(r22, demod, size):
    """C = 4 streams on the (2, 2) mesh, two blocks with the state carried:
    >= 90 dB (QPSK >= 60) against JAX's sharded chain, state as the
    single-card chain's tests hold it.  "aligned" FM shards take the fused FM body (K1's plain version),
    "pieces" shards the DDC body and the FM epilogue."""
    shape, res = r22
    outs, states = _jax_rx(demod, size, shape)
    key = f"rx_{demod}_{size}"
    for b, (want, jst) in enumerate(zip(outs, states)):
        got = _gather(res, shape, key, "out", b, ("channel", "time"))
        assert got.shape == want.shape and got.dtype == want.dtype
        assert np.all(np.isfinite(got))
        assert snr_db(got, want) >= (60.0 if demod == "qpsk" else 90.0)
        _check_state(res[0][key]["state"][b], jst, demod)


def test_sharded_planar_fm_matches_jax(r14):
    """The planar single stream (config 4's layout) over 4 time shards, two
    blocks: >= 90 dB against JAX's sharded planar chain, state as the
    single-card chain's tests hold it, on every rank."""
    shape, res = r14
    outs, states = _jax_rx("fm", "aligned", shape, planar=True)
    for b, (want, jst) in enumerate(zip(outs, states)):
        got = _gather(res, shape, "planar", "out", b, ("time",))
        assert got.shape == want.shape
        assert snr_db(got, want) >= 90.0
        for r in res:
            _check_state(r["planar"]["state"][b], jst, "fm")


def _assert_tree_equal(got: dict, want: dict):
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_tree_equal(got[k], v)
        else:
            assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
            np.testing.assert_array_equal(got[k], v)


def test_sharded_state_interop_round_trip(ranks):
    """JAX's global sharded ChainState -> each rank's part (its channel
    slice on (2, 2), the whole planar state on (1, 4)) -> back: every leaf
    exact, the phase word uint32."""
    shape, res = ranks
    tree = _jax_rx("fm", "aligned", shape, planar=shape == (1, 4))[1][0]
    for rank, r in enumerate(res):
        c = rank // shape[1]
        C_loc = RX_C // shape[0] if shape == (2, 2) else None
        want_tail = (tree["fir_tail"][c * C_loc:(c + 1) * C_loc] if C_loc
                     else tree["fir_tail"])
        np.testing.assert_array_equal(r["interop"]["local_fir_tail"],
                                      want_tail)
        assert r["interop"]["back"]["nco_theta"].dtype == np.uint32
        _assert_tree_equal(r["interop"]["back"], tree)


@pytest.mark.parametrize("name", ["xla", "fused", "k9"])
def test_sharded_tail_interop_round_trip(ranks, name):
    """The replicated tails (the "xla" channelizer's, the fused rows, K9's
    rows) to every rank's tensors and back: exact, same shape and dtype."""
    _, res = ranks
    want = _jax_tails()[name]
    for r in res:
        got = r["interop"]["tails"][name]
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
