"""Failure detection and elastic recovery for streaming chains.

Port of ``solid_dsp_tpu/parallel/fault.py``; both pieces are host work
(the compute path stays error-free):

* ``CheckpointManager`` — atomic, rotating ChainState checkpoints tagged
  with the stream position.  Writes go to a temporary file then
  ``os.replace``, so a crash mid-write can never corrupt the newest good
  checkpoint.
* ``run_supervised`` — gang-restart supervision for an SPMD worker set:
  if any worker dies, the whole set is torn down and relaunched (a
  ``torch.distributed`` group cannot lose a member either), and the workers
  resume from the newest shared checkpoint.

``save_distributed`` / ``load_distributed`` / ``latest_distributed_step``
keep one file a rank of ``torch.distributed`` (rank 0 of a world of 1
where no group is initialised), in the JAX package's layout: the file
names, ``__version__``, ``__treedef__`` (the JAX treedef's repr) and the
leaves ``leaf{i}_dev{id}``, ``id`` the rank's global device index, which
is its rank (one process a device).  So a one-process checkpoint written
by either package loads in the other.
"""

from __future__ import annotations

import glob
import os
import re
import subprocess
import time

import numpy as np

from ..streaming.state import (ChainState, _leaf_from_numpy, _leaf_to_numpy,
                               _leaves, _map, _node_repr, atomic_savez,
                               treedef_bytes)

__all__ = [
    "CheckpointManager", "run_supervised", "SupervisorError",
    "save_distributed", "load_distributed", "latest_distributed_step",
]


class SupervisorError(RuntimeError):
    pass


class CheckpointManager:
    """Atomic rotating checkpoints of (ChainState, stream position)."""

    def __init__(self, directory: str, keep: int = 2):
        self.directory = directory
        self.keep = max(1, int(keep))
        os.makedirs(directory, exist_ok=True)

    def _path(self, block_idx: int) -> str:
        return os.path.join(self.directory, f"ckpt_{block_idx:012d}.npz")

    _NAME_RE = re.compile(r"^ckpt_(\d{12})\.npz$")

    def save(self, state: ChainState, block_idx: int) -> str:
        """Atomically write the checkpoint for ``block_idx`` and prune.

        ChainState.save goes through atomic_savez (dot-prefixed temporary
        name + os.replace), so a crash mid-write leaves only a temporary
        file that the recovery glob and name check never match.
        """
        path = self._path(block_idx)
        state.save(path)
        self._prune()
        return path

    def _ckpts(self):
        out = []
        for f in glob.glob(os.path.join(self.directory, "ckpt_*.npz")):
            m = self._NAME_RE.match(os.path.basename(f))
            if m:  # strict name check: never parse stray/temp files
                out.append((int(m.group(1)), f))
        return sorted(out)

    def _prune(self) -> None:
        for _, old in self._ckpts()[: -self.keep]:
            try:
                os.remove(old)
            except OSError:
                pass
        # clear any crash-leftover temp files too
        for stray in glob.glob(os.path.join(self.directory,
                                            ".tmp_ckpt_*.npz")):
            try:
                os.remove(stray)
            except OSError:
                pass

    def latest(self, like: ChainState):
        """Return (state, next_block_idx); (None, 0) when no checkpoint.

        A checkpoint that fails validation (structure drift, torn file) is
        skipped and the next-newest is tried: a bad checkpoint must not
        take down recovery.
        """
        for idx, path in reversed(self._ckpts()):
            try:
                state = ChainState.load(path, like=like)
            except Exception:
                continue
            return state, idx + 1
        return None, 0


def _rank_world() -> tuple:
    """(rank, world size) of the default ``torch.distributed`` group;
    (0, 1) where none is initialised."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _step_path(directory: str, step: int, rank: int) -> str:
    return os.path.join(directory, f"step_{step:012d}_proc{rank}.npz")


def _tree_repr(tree) -> str:
    """The repr of the JAX treedef of a tree of this structure."""
    return f"PyTreeDef({_node_repr(tree)})"


def save_distributed(state, directory: str, step: int) -> str:
    """Per-rank checkpoint (orbax-style layout, no gathers).

    Each rank writes only its own tensors, keyed by its device index: no
    collective, no copy of another rank's data.  Every rank calls this.
    """
    rank, _ = _rank_world()
    os.makedirs(directory, exist_ok=True)
    data = {
        "__version__": np.asarray(ChainState.CHECKPOINT_VERSION),
        "__treedef__": treedef_bytes(_tree_repr(state)),
    }
    for i, leaf in enumerate(_leaves(_map(_leaf_to_numpy, state))):
        data[f"leaf{i}_dev{rank}"] = leaf
    return atomic_savez(_step_path(directory, step, rank), **data)


def load_distributed(directory: str, step: int, like):
    """Restore this rank's tensors of a distributed checkpoint.

    ``like`` is the rank's local state (for example the output of one
    warm-up step on the live group): its structure, each leaf's shape and
    dtype, and its leaves' devices, onto which the tensors load.
    """
    rank, _ = _rank_world()
    path = _step_path(directory, step, rank)
    with np.load(path) as data:
        version = int(data["__version__"]) if "__version__" in data else 0
        if version > ChainState.CHECKPOINT_VERSION:
            raise ValueError(
                f"distributed checkpoint {path!r} has version {version}, "
                f"newer than this build's {ChainState.CHECKPOINT_VERSION}")
        if bytes(data["__treedef__"]).decode() != _tree_repr(like):
            raise ValueError("distributed checkpoint structure mismatch")
        want = _leaves(_map(_leaf_to_numpy, like))
        got = []
        for i, ref in enumerate(want):
            a = data[f"leaf{i}_dev{rank}"]
            if a.shape != ref.shape or a.dtype != ref.dtype:
                raise ValueError(
                    f"distributed checkpoint leaf {i}: {a.dtype}{a.shape} "
                    f"!= expected {ref.dtype}{ref.shape}")
            got.append(a)
    it = iter(got)
    return _map(lambda leaf: _leaf_from_numpy(next(it), leaf.device), like)


def latest_distributed_step(directory: str) -> int:
    """Newest step for which every rank's file exists; -1 if none.

    A crash between two ranks' saves leaves a torn step: only steps with
    every rank's file are recoverable, so callers need the minimum over
    ranks.  A glob on the host; call it on any rank.
    """
    _, n = _rank_world()
    name_re = re.compile(r"^step_(\d+)_proc(\d+)\.npz$")
    steps: dict = {}
    for f in glob.glob(os.path.join(directory, "step_*_proc*.npz")):
        m = name_re.match(os.path.basename(f))
        if not m:  # strict: stray/temp files must not count as a save
            continue
        steps.setdefault(int(m.group(1)), set()).add(int(m.group(2)))
    good = [s for s, procs in steps.items() if len(procs) == n]
    return max(good) if good else -1


def run_supervised(spawn, num_workers: int, max_restarts: int = 3,
                   poll_interval: float = 0.2, timeout: float = 600.0):
    """Run an SPMD worker gang with death detection and gang restart.

    ``spawn(worker_id, attempt) -> subprocess.Popen`` launches one worker.
    If any worker exits nonzero, the remaining workers are terminated and
    the whole gang relaunched (workers resume from their
    CheckpointManager).  Returns the list of final return codes once every
    worker exits 0.  Raises SupervisorError after ``max_restarts`` failed
    attempts or on timeout.
    """
    deadline = time.monotonic() + timeout
    for attempt in range(max_restarts + 1):
        procs = [spawn(i, attempt) for i in range(num_workers)]
        while True:
            if time.monotonic() > deadline:
                for p in procs:
                    p.kill()
                raise SupervisorError("supervision timeout")
            codes = [p.poll() for p in procs]
            if any(c is not None and c != 0 for c in codes):
                for p in procs:  # death detected: tear down the gang
                    if p.poll() is None:
                        p.terminate()
                for p in procs:
                    try:
                        p.wait(timeout=10)
                    except subprocess.TimeoutExpired:
                        p.kill()
                break
            if all(c == 0 for c in codes):
                return codes
            time.sleep(poll_interval)
    raise SupervisorError(
        f"worker gang failed after {max_restarts + 1} attempts")
