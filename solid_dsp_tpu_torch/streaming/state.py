"""ChainState — the receive chain's streaming state as one mapping.

Port of ``solid_dsp_tpu/streaming/state.py::ChainState``: a string-keyed
mapping of per-component states (NCO phase word, FIR tail and phase, AGC
carry, FM carry) whose leaves are tensors on the chain's device.  It is the
block-to-block carry and the checkpoint format.

Phase words are int64 tensors in [0, 2^32) here and numpy ``uint32`` at the
numpy boundary (:func:`to_numpy`, :func:`from_numpy`, the checkpoint), as in
the JAX package.  Checkpoints are the JAX package's ``.npz`` format, so each
package reads the other's: ``__version__``, ``__treedef__`` (the uint8 bytes
of the JAX treedef's repr, which :func:`treedef_repr` builds without JAX)
and the leaves ``leaf_i`` in sorted-key order.
"""

from __future__ import annotations

import os
from typing import Any, Iterator, Mapping

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["ChainState", "to_numpy", "from_numpy", "treedef_repr"]

_PHASE_KEYS = ("nco_theta",)     # u32 phase words: int64 tensors in the port


def _flatten(tree: Mapping, prefix: str = ""):
    """(path, leaf) pairs in sorted-key order, nested mappings flattened."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            out += _flatten(v, f"{prefix}{k}/")
        else:
            out.append((f"{prefix}{k}", v))
    return out


def _node_repr(v) -> str:
    if isinstance(v, Mapping):
        return "{" + ", ".join(f"{k!r}: {_node_repr(v[k])}"
                               for k in sorted(v)) + "}"
    return "*"


def treedef_repr(state: Mapping) -> str:
    """The repr of the JAX treedef of a ChainState with the same keys, as
    the JAX package's checkpoints store it: the sorted component keys, then
    each component as a leaf ``*`` or a dict of sorted keys."""
    keys = tuple(sorted(state))
    children = ", ".join(_node_repr(state[k]) for k in keys)
    return f"PyTreeDef(CustomNode(ChainState[{keys!r}], [{children}]))"


def _leaf_to_numpy(key: str, v) -> np.ndarray:
    a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return a.astype(np.uint32) if key in _PHASE_KEYS else a


def _leaf_from_numpy(key: str, a, device) -> torch.Tensor:
    a = np.asarray(a)
    if key in _PHASE_KEYS:
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
        parts = ", ".join(f"{k}={tuple(getattr(v, 'shape', ()))}"
                          for k, v in _flatten(self))
        return f"ChainState({parts})"

    def save(self, path: str) -> str:
        """Write every leaf to an ``.npz`` checkpoint in the JAX package's
        format (versioned; written to a temporary name, then renamed).
        Returns the path written."""
        if not path.endswith(".npz"):
            path = path + ".npz"
        leaves = _flatten(to_numpy(self))
        tmp = os.path.join(os.path.dirname(path) or ".",
                           ".tmp_" + os.path.basename(path))
        np.savez(tmp, __version__=np.asarray(self.CHECKPOINT_VERSION),
                 __treedef__=np.frombuffer(treedef_repr(self).encode(),
                                           np.uint8),
                 **{f"leaf_{i}": a for i, (_, a) in enumerate(leaves)})
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str, like: "ChainState") -> "ChainState":
        """Read a checkpoint (the port's or the JAX package's) onto
        ``like``'s device, checking its treedef, leaf count, and each leaf's
        shape and dtype against ``like``."""
        want = _flatten(to_numpy(like))
        device = next(v for _, v in _flatten(like)).device
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
            tree: dict = {}
            for i, (key, ref) in enumerate(want):
                got = data[f"leaf_{i}"]
                if got.shape != ref.shape or got.dtype != ref.dtype:
                    raise ValueError(
                        f"checkpoint leaf {key}: {got.dtype}{got.shape} != "
                        f"expected {ref.dtype}{ref.shape}")
                *outer, last = key.split("/")
                node = tree
                for k in outer:
                    node = node.setdefault(k, {})
                node[last] = got
        return from_numpy(tree, device)


def to_numpy(state: Mapping) -> dict:
    """State -> nested dict of numpy leaves (phase words as ``uint32``)."""
    return {k: to_numpy(v) if isinstance(v, Mapping) else _leaf_to_numpy(k, v)
            for k, v in state.items()}


def from_numpy(tree: Mapping, device=None) -> ChainState:
    """Nested mapping of numpy-compatible leaves -> ChainState on
    ``device``, the card unless told otherwise (phase words as int64)."""
    device = resolve_device(device)

    def conv(t):
        return {k: conv(v) if isinstance(v, Mapping)
                else _leaf_from_numpy(k, v, device) for k, v in t.items()}

    return ChainState(**conv(tree))
