"""ChainState — the receive chain's streaming state as one mapping.

Port of ``solid_dsp_tpu/streaming/state.py::ChainState``: a string-keyed
mapping of per-component states (NCO phase word, FIR tail and phase, AGC
carry, FM carry) whose leaves are tensors on the chain's device.  It is the
block-to-block carry and the checkpoint format.

Phase words are int64 tensors in [0, 2^32) here and numpy ``uint32`` at the
numpy boundary (:func:`to_numpy`, :func:`from_numpy`, the checkpoint), as in
the JAX package: an int64 leaf is a phase word wherever it sits (the
chain's ``nco_theta``, or a composed chain's NCO stage under the stage's
name), and no other state holds int64.  Checkpoints are the JAX package's
``.npz`` format, so each package reads the other's: ``__version__``,
``__treedef__`` (the uint8 bytes of the JAX treedef's repr, which
:func:`treedef_repr` builds without JAX) and the leaves ``leaf_i`` in the
JAX flattening order (sorted keys; tuples and lists in order; ``()`` and
``None`` hold no leaf; a nested ChainState is a node of its own).
:func:`atomic_savez` and :func:`treedef_bytes` are the JAX package's
checkpoint writers' shared pieces.
"""

from __future__ import annotations

import os
from typing import Any, Iterator, Mapping

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["ChainState", "to_numpy", "from_numpy", "treedef_repr",
           "treedef_bytes", "atomic_savez"]


def _flatten(tree, prefix: str = "") -> list:
    """(path, leaf) pairs in the JAX flattening order; a path names the
    keys and indices down to the leaf ("agc/gain", "t/0")."""
    if isinstance(tree, Mapping):
        return [p for k in sorted(tree) for p in _flatten(tree[k],
                                                         f"{prefix}{k}/")]
    if isinstance(tree, (tuple, list)):
        return [p for i, v in enumerate(tree)
                for p in _flatten(v, f"{prefix}{i}/")]
    return [] if tree is None else [(prefix[:-1], tree)]


def _leaves(tree) -> list:
    """The leaves in the JAX flattening order."""
    return [leaf for _, leaf in _flatten(tree)]


def _map(fn, tree):
    """``tree`` with ``fn`` applied to each leaf in the JAX flattening
    order, its nodes kept (a ChainState stays a ChainState)."""
    if isinstance(tree, Mapping):
        out = {k: _map(fn, tree[k]) for k in sorted(tree)}
        out = {k: out[k] for k in tree}
        return ChainState(**out) if isinstance(tree, ChainState) else out
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def _node_repr(v) -> str:
    if isinstance(v, ChainState):
        keys = tuple(sorted(v))
        children = ", ".join(_node_repr(v[k]) for k in keys)
        return f"CustomNode(ChainState[{keys!r}], [{children}])"
    if isinstance(v, Mapping):
        return "{" + ", ".join(f"{k!r}: {_node_repr(v[k])}"
                               for k in sorted(v)) + "}"
    if isinstance(v, tuple):
        inner = ", ".join(_node_repr(c) for c in v)
        return f"({inner},)" if len(v) == 1 else f"({inner})"
    if isinstance(v, list):
        return "[" + ", ".join(_node_repr(c) for c in v) + "]"
    return "None" if v is None else "*"


def treedef_repr(state: Mapping) -> str:
    """The repr of the JAX treedef of a ChainState with the same structure,
    as the JAX package's checkpoints store it: the sorted component keys,
    then each component as a leaf ``*``, a dict of sorted keys, a tuple or
    list, ``None``, or a nested ChainState."""
    return f"PyTreeDef({_node_repr(ChainState(**state))})"


def treedef_bytes(treedef) -> np.ndarray:
    """A treedef's repr (a :func:`treedef_repr` string, or anything whose
    ``str`` is one) as a uint8 array, as every checkpoint writer stores
    it."""
    return np.frombuffer(str(treedef).encode(), dtype=np.uint8)


def atomic_savez(path: str, **data) -> str:
    """``np.savez`` written to a dot-prefixed temporary name in the same
    directory, then renamed: a crash mid-write leaves no ``*.npz`` that a
    recovery glob would take.  Returns the final path (``.npz`` appended
    if missing, as ``np.savez`` does)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    tmp = os.path.join(os.path.dirname(path) or ".",
                       ".tmp_" + os.path.basename(path))
    np.savez(tmp, **data)
    os.replace(tmp, path)
    return path


def _leaf_to_numpy(v) -> np.ndarray:
    a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return a.astype(np.uint32) if a.dtype == np.int64 else a


def _leaf_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(a.copy()).to(device)


class ChainState(Mapping):
    """An immutable string-keyed mapping of component states."""

    CHECKPOINT_VERSION = 1

    def __init__(self, **components: Any):
        self._d = dict(components)

    def __getitem__(self, key: str) -> Any:
        return self._d[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._d)

    def __len__(self) -> int:
        return len(self._d)

    def __getattr__(self, key: str) -> Any:
        try:
            return self.__dict__["_d"][key]
        except KeyError:
            raise AttributeError(key) from None

    def replace(self, **updates: Any) -> "ChainState":
        return ChainState(**{**self._d, **updates})

    def __repr__(self) -> str:
        parts = ", ".join(
            f"{k}={_map(lambda a: tuple(getattr(a, 'shape', ())), v)}"
            for k, v in self._d.items())
        return f"ChainState({parts})"

    def save(self, path: str) -> str:
        """Write every leaf to an ``.npz`` checkpoint in the JAX package's
        format (versioned; written to a temporary name, then renamed).
        Returns the path written."""
        leaves = _leaves(to_numpy(self))
        return atomic_savez(
            path, __version__=np.asarray(self.CHECKPOINT_VERSION),
            __treedef__=treedef_bytes(treedef_repr(self)),
            **{f"leaf_{i}": a for i, a in enumerate(leaves)})

    @classmethod
    def load(cls, path: str, like: "ChainState") -> "ChainState":
        """Read a checkpoint (the port's or the JAX package's) onto
        ``like``'s device, checking its treedef, leaf count, and each leaf's
        shape and dtype against ``like``."""
        want = _flatten(to_numpy(like))
        tensors = _leaves(like)
        device = tensors[0].device if tensors else torch.device("cpu")
        with np.load(path) as data:
            version = int(data["__version__"])
            if version > cls.CHECKPOINT_VERSION:
                raise ValueError(f"checkpoint {path!r} has version {version}, "
                                 f"newer than {cls.CHECKPOINT_VERSION}")
            saved = bytes(data["__treedef__"]).decode()
            if saved != treedef_repr(like):
                raise ValueError("checkpoint structure mismatch:\n"
                                 f"  saved:    {saved}\n"
                                 f"  expected: {treedef_repr(like)}")
            n_leaves = len(data.files) - 2
            if n_leaves != len(want):
                raise ValueError(f"checkpoint has {n_leaves} leaves, "
                                 f"expected {len(want)}")
            leaves = []
            for i, (key, ref) in enumerate(want):
                got = data[f"leaf_{i}"]
                if got.shape != ref.shape or got.dtype != ref.dtype:
                    raise ValueError(
                        f"checkpoint leaf {key}: {got.dtype}{got.shape} != "
                        f"expected {ref.dtype}{ref.shape}")
                leaves.append(got)
        it = iter(leaves)
        return ChainState(**_map(lambda _: _leaf_from_numpy(next(it), device),
                                 dict(like)))


def to_numpy(state: Mapping) -> dict:
    """State -> dict of numpy leaves, its nested nodes kept (phase words
    as ``uint32``)."""
    return _map(_leaf_to_numpy, dict(state))


def from_numpy(tree: Mapping, device=None) -> ChainState:
    """Mapping of numpy-compatible leaves (nested nodes kept) -> ChainState
    on ``device``, the card unless told otherwise (``uint32`` phase words
    as int64)."""
    device = resolve_device(device)
    return ChainState(**_map(lambda a: _leaf_from_numpy(a, device),
                             dict(tree)))
