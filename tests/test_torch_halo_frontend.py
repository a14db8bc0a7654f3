"""K9's plain version across gloo ranks vs the JAX package's fused-halo
front end in interpret mode on the fake CPU mesh.

The port's ``make_fused_channelizer_frontend`` on a CPU mesh runs
``halo_frontend_torch``: ``left_halo`` of each rank's last K rows over the
process group, the first shard's tail select, and K5's per-lane product.
The JAX side runs ``parallel/pallas_halo.py`` with ``interpret=True`` at
tests/test_pallas_halo.py's shapes and seeds.  Gates (that file's): the
channels and z within 2e-5 max|Y|, the new tail rows bit-equal.  One spawn
of 2 ranks and one of 4 run every case (tests/torch_dist.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import torch_dist
from solid_dsp_tpu.models.channelizer import channelizer_taps
from solid_dsp_tpu.ops.pallas_kernels import pfb_frontend, pfb_frontend_taps
from solid_dsp_tpu.parallel.pallas_halo import make_fused_channelizer_frontend

M, K = 16, 8


def _cnoise(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _inputs(n_dev):
    """The blocks and tails of every case at n_dev shards."""
    x = _cnoise(np.random.default_rng(0), M * 32 * n_dev)   # one block
    rng = np.random.default_rng(1)
    L = M * 16 * n_dev
    stream = _cnoise(rng, 2 * L)                            # two blocks
    tail = _cnoise(np.random.default_rng(2), (K, M))        # shard 0's
    return {"one": ([x], np.zeros((K, M), np.complex64)),
            "stream": ([stream[:L], stream[L:]],
                       np.zeros((K, M), np.complex64)),
            "tail": ([x], tail)}


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, tmp_path_factory):
    """(n_dev, inputs, each rank's results) of every case at n_dev."""
    n_dev = request.param
    inputs = _inputs(n_dev)
    mesh = (1, n_dev)
    cases = [(k, mesh, "k9_frontend", dict(M=M, K=K, blocks=b, tail=t))
             for k, (b, t) in inputs.items()]
    cases.append(("errors", mesh, "k9_errors", dict(M=M, K=K)))
    cases += [(f"hosts_{fake}", mesh, "k9_hosts", dict(M=M, K=K, fake=fake))
              for fake in (True, False)]
    res = torch_dist.run_ranks(tmp_path_factory.mktemp(f"k9_{n_dev}"),
                               n_dev, cases)
    return n_dev, inputs, res


def _port(res, key, n_dev):
    """Per block: the port's global z and every rank's new tail."""
    out = []
    for b in range(len(res[0][key]["z"])):
        z = torch_dist.assemble([r[key]["z"][b] for r in res], (1, n_dev),
                                ("time",))
        out.append((z, [r[key]["tail"][b] for r in res]))
    return out


@functools.lru_cache(maxsize=None)
def _jax(n_dev, key):
    """Interpret-mode K9 over the case's blocks: [(z, new tail)] a block."""
    blocks, tail = _inputs(n_dev)[key]
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("time",))
    apply_fn = make_fused_channelizer_frontend(mesh, M, K, interpret=True)
    t = jnp.asarray(tail)
    out = []
    for x in blocks:
        z, t = apply_fn(t, jnp.asarray(x))
        out.append((np.asarray(z), np.asarray(t)))
    return out


@pytest.mark.parametrize("key", ["one", "stream", "tail"])
def test_halo_frontend_matches_jax(ranks, key):
    """z and its channels within 2e-5 max|Y| of interpret-mode K9, block
    by block (the stream case carries the tail into shard 0)."""
    n_dev, _, res = ranks
    for (z, _), (zj, _) in zip(_port(res, key, n_dev), _jax(n_dev, key)):
        assert z.shape == zj.shape
        Y, Yj = np.fft.fft(z, axis=-1), np.fft.fft(zj, axis=-1)
        lim = 2e-5 * np.abs(Yj).max()
        np.testing.assert_allclose(Y, Yj, atol=lim, rtol=0)
        np.testing.assert_allclose(z, zj, atol=lim, rtol=0)


@pytest.mark.parametrize("key", ["one", "stream", "tail"])
def test_halo_frontend_tail_bit_equal(ranks, key):
    """Every rank's new tail rows equal JAX's and the stream's last K rows
    exactly."""
    n_dev, inputs, res = ranks
    blocks = inputs[key][0]
    for (_, tails), (_, tj), x in zip(_port(res, key, n_dev),
                                      _jax(n_dev, key), blocks):
        for t in tails:
            np.testing.assert_array_equal(t, tj)
            np.testing.assert_array_equal(t, x[-K * M:].reshape(K, M))


def test_halo_frontend_streaming_matches_single_device(ranks):
    """Two blocks with the tail carried == the single-device front end on
    the whole stream (tests/test_pallas_halo.py::test_fused_halo_streaming)."""
    n_dev, inputs, res = ranks
    blocks, tail = inputs["stream"]
    got = np.concatenate([z for z, _ in _port(res, "stream", n_dev)])
    h_il = pfb_frontend_taps(channelizer_taps(M, K), M)
    z_ref, _ = pfb_frontend(jnp.asarray(np.concatenate(blocks)), h_il,
                            jnp.asarray(tail), M, K, interpret=True)
    z_ref = np.asarray(z_ref)
    np.testing.assert_allclose(got, z_ref,
                               atol=2e-5 * np.abs(np.fft.fft(z_ref)).max())


def test_halo_frontend_shard0_takes_the_tail(ranks):
    """Only shard 0 reads the carried tail: with a non-zero tail its first
    K rows move and every other shard's rows stay as with a zero tail."""
    n_dev, _, res = ranks
    (z_tail, _), = _port(res, "tail", n_dev)
    (z_zero, _), = _port(res, "one", n_dev)
    assert not np.array_equal(z_tail[:K], z_zero[:K])
    np.testing.assert_array_equal(z_tail[K:], z_zero[K:])


@pytest.mark.parametrize("case,message", [
    ("ragged", "ValueError: per-shard length must be a multiple of M"),
    ("short", f"ValueError: per-shard rows ({K}) must exceed K ({K})")])
def test_halo_frontend_rejects_bad_blocks(ranks, case, message):
    """The JAX function's errors: a slab that M does not divide, and a slab
    of U <= K rows."""
    _, _, res = ranks
    for r in res:
        assert r["errors"][case] == message


def test_group_link_raises_across_hosts_before_allocating(ranks):
    """Ranks on different hosts (hostname patched in each rank): every rank
    raises the host error from the check and from group_link, and no
    region is allocated."""
    n_dev, _, res = ranks
    for r, got in enumerate(res):
        got = got["hosts_True"]
        assert got["allocated"] == 0
        for key in ("check", "link"):
            assert got[key].startswith("ValueError: K9's in-kernel halo "
                                       "exchange needs the whole time axis "
                                       "on one node")
        i = r if r < n_dev - 1 else 0     # its own pair, else the first
        assert f"'host-{i}'" in got["check"]
        assert f"'host-{i + 1}'" in got["check"]


def test_group_link_same_host_passes_the_check(ranks):
    """Ranks on one host: the check passes and group_link goes on to
    allocate its region."""
    _, _, res = ranks
    for got in res:
        got = got["hosts_False"]
        assert got["check"] == "no error"
        assert got["link"] == "NotImplementedError: region allocated"
        assert got["allocated"] == 1
