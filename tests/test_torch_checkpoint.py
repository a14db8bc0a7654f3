"""Checkpoints move both ways between the JAX package and the port.

Both write ``.npz`` files with ``__version__``, ``__treedef__`` (the bytes of
the JAX treedef's repr) and the leaves in sorted-key order, the phase word
as ``uint32``.  A state saved by one and loaded by the other is equal leaf
for leaf (exact: the leaves are copied, never recomputed).
"""

import jax
import numpy as np
import pytest
import torch

from solid_dsp_tpu.streaming.state import ChainState as JaxChainState
from solid_dsp_tpu_torch.interop import state_from_numpy, state_to_numpy
from solid_dsp_tpu_torch.models.rx_chain import RxChainConfig, make_rx_chain
from solid_dsp_tpu_torch.streaming.state import ChainState, treedef_repr
from torch_parity import CONFIG4, make_blocks, run_jax, run_torch


def _jax_like():
    from solid_dsp_tpu.models.rx_chain import RxChainConfig as JaxCfg
    from solid_dsp_tpu.models.rx_chain import rx_chain_init

    import jax.numpy as jnp
    return rx_chain_init(JaxCfg(**{**CONFIG4, "dtype": jnp.complex64}))


def _assert_equal_trees(a, b):
    la = jax.tree_util.tree_leaves(a)
    lb = jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb) == 9
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_treedef_repr_matches_jax():
    init, _ = make_rx_chain(RxChainConfig(**CONFIG4), "cpu")
    assert treedef_repr(init()) == str(
        jax.tree_util.tree_structure(_jax_like()))


def test_jax_checkpoint_loads_into_port(tmp_path):
    """Saved by the JAX package's ChainState.save, loaded by the port."""
    _, jst = run_jax(make_blocks(2, seed=21), ddc_engine="xla")
    path = str(tmp_path / "jax_ckpt.npz")
    JaxChainState(**jst).save(path)
    with np.load(path) as data:
        assert "__keys__" not in data and "__treedef__" in data
        assert data["leaf_8"].dtype == np.uint32
    init, _ = make_rx_chain(RxChainConfig(**CONFIG4), "cpu")
    st = ChainState.load(path, like=init())
    assert st["nco_theta"].dtype == torch.int64
    _assert_equal_trees(state_to_numpy(st), jst)


def test_port_checkpoint_loads_into_jax(tmp_path):
    """Saved by the port, loaded by the JAX package's ChainState.load."""
    _, st = run_torch(make_blocks(2, seed=22))
    path = st.save(str(tmp_path / "port_ckpt"))
    with np.load(path) as data:
        assert sorted(data.files) == sorted(
            ["__version__", "__treedef__"] + [f"leaf_{i}" for i in range(9)])
        assert data["leaf_8"].dtype == np.uint32
    back = JaxChainState.load(path, like=_jax_like())
    _assert_equal_trees(jax.tree_util.tree_map(np.asarray, back),
                        state_to_numpy(st))
    # and the port resumes from what the JAX package reads back
    again = state_from_numpy(jax.tree_util.tree_map(np.asarray, back), "cpu")
    _assert_equal_trees(state_to_numpy(again), state_to_numpy(st))


def test_load_rejects_other_structures(tmp_path):
    init, _ = make_rx_chain(RxChainConfig(**CONFIG4), "cpu")
    path = init().save(str(tmp_path / "ckpt"))
    extra = init().replace(impair={"dc": torch.zeros(())})
    with pytest.raises(ValueError, match="structure mismatch"):
        ChainState.load(path, like=extra)
    bad = init().replace(fm_prev=torch.ones((), dtype=torch.complex128))
    with pytest.raises(ValueError, match="fm_prev"):
        ChainState.load(path, like=bad)
