"""ChainState — the receive chain's streaming state as one mapping.

Port of ``solid_dsp_tpu/streaming/state.py::ChainState``: a string-keyed
mapping of per-component states (NCO phase word, FIR tail and phase, AGC
carry, FM carry) whose leaves are tensors on the chain's device.  It is the
block-to-block carry and the checkpoint format.

Phase words are int64 tensors in [0, 2^32) here and numpy ``uint32`` at the
numpy boundary (:func:`to_numpy`, :func:`from_numpy`, the checkpoint), as in
the JAX package.  Checkpoints are ``.npz`` files with the leaves in sorted-key
order; reading a checkpoint written by the JAX package is not supported yet
(ROADMAP queue 1).
"""

from __future__ import annotations

import os
from typing import Any, Iterator, Mapping

import numpy as np
import torch

__all__ = ["ChainState", "to_numpy", "from_numpy"]

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
        """Write every leaf to an ``.npz`` checkpoint (versioned; written to
        a temporary name, then renamed).  Returns the path written."""
        if not path.endswith(".npz"):
            path = path + ".npz"
        leaves = _flatten(to_numpy(self))
        tmp = os.path.join(os.path.dirname(path) or ".",
                           ".tmp_" + os.path.basename(path))
        np.savez(tmp, __version__=np.asarray(self.CHECKPOINT_VERSION),
                 __keys__=np.asarray([k for k, _ in leaves]),
                 **{f"leaf_{i}": a for i, (_, a) in enumerate(leaves)})
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str, like: "ChainState") -> "ChainState":
        """Read a checkpoint onto ``like``'s device, checking its keys, leaf
        shapes and dtypes against ``like``."""
        want = _flatten(to_numpy(like))
        device = next(v for _, v in _flatten(like)).device
        with np.load(path) as data:
            version = int(data["__version__"])
            if version > cls.CHECKPOINT_VERSION:
                raise ValueError(f"checkpoint {path!r} has version {version}, "
                                 f"newer than {cls.CHECKPOINT_VERSION}")
            keys = [str(k) for k in data["__keys__"]]
            if keys != [k for k, _ in want]:
                raise ValueError(f"checkpoint keys {keys} != expected "
                                 f"{[k for k, _ in want]}")
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
    ``device`` (phase words as int64)."""

    def conv(t):
        return {k: conv(v) if isinstance(v, Mapping)
                else _leaf_from_numpy(k, v, device) for k, v in t.items()}

    return ChainState(**conv(tree))
