"""Moving state between the JAX package and this port.

This system has no weights: its parameters are the taps designed on the host
(``design/``, ``models/channelizer.py::channelizer_taps``,
``models/channel_bank.py::design_channel_sos``), which the tests hold equal
to the JAX package's, the banks built from them, and the streaming state.
State crosses between the two packages as numpy:

* the receive chain's ``ChainState`` as a nested mapping of numpy leaves
  with the same keys (``nco_theta``, ``fir_tail``, ``fir_phase``,
  ``agc{gain,energy,lock,mode,timer}``, ``fm_prev``):
  ``state_from_numpy(tree, device)`` takes the JAX chain's state with its
  leaves fetched by ``np.asarray`` (for example
  ``jax.tree_util.tree_map(np.asarray, state)``) and returns the port's
  :class:`~solid_dsp_tpu_torch.streaming.state.ChainState`;
  ``state_to_numpy(state)`` returns the port's state as such a mapping,
  with the phase word as numpy ``uint32`` like the JAX package's;
* config 5's states, leaf for leaf with :func:`tensors_from_numpy` and
  :func:`tensors_to_numpy`, which keep every shape and dtype: the
  ``"xla"`` channelizer tail (K*M - 1,) complex, the fused channelizer's
  tail rows (2, 8, M) float32, the ``"pallas"`` tail rows (K, M)
  complex64, the synthesis carry (K-1, M), the oversampled bank's
  (tail, parity int32) pair, the IIR bank state (2S, C) complex64 and the
  batched AGC dict.  The port's objects take them through their
  ``.state`` setters (``PolyphaseChannelizer``, ``PolyphaseSynthesizer``,
  ``OversampledChannelizer``, ``ChannelBank``, which holds
  ``ChainState(iir=..., agc=...)``); the JAX objects keep them in
  ``_tail``, ``_state``, ``_iir_state`` and ``_agc_state``;
* the Farrow grid resampler's state ``(tail (3,) complex, t0 int32)``
  (``ops/farrow.py::make_farrow_resampler``,
  ``ops/cuda_resample.py::make_farrow_kernel_resampler``), as a tuple with
  the same two functions.

* the filters and resamplers of ``ops/iir.py``, ``ops/cic.py``,
  ``ops/halfband.py``, ``ops/resample.py``, ``ops/autocorr.py`` and
  ``models/ddc.py``: each class's ``state`` property reads and sets its
  carry as a mapping whose keys are the JAX object's attribute names
  without the underscore: the IIR w-state (``state``: (k,) for one
  recurrence, (S, 2) for a cascade, the sections' ``_state`` stacked, and
  ``index`` for the decimating filter); the CIC, halfband and FIR tails
  and phases (``tail``, ``phase``; ``stages`` and ``final`` for
  ``MultistageDecimator``); ``PfbArbitraryResampler``'s ``tail`` and
  position ``t_next``; ``ArbitraryResampler``'s ``stages``, ``rem`` and,
  with ``block_len``, ``grid`` (``make_arb_resampler``'s state, ``hb``
  tails and the ``pfb`` (tail, t0) pair); ``AutoCorrelator``'s ``x_tail``,
  ``e_tail`` and ``energy``; ``DDC``'s phase word ``theta`` (int64 in
  the port, ``uint32`` in JAX; the setter takes either) with its ``cic``,
  ``fir_tail``, ``fir_phase`` and ``farrow`` carries.  Such a mapping of
  the JAX object's values (numpy arrays and Python scalars) moves with
  :func:`tensors_from_numpy` into the setter, and the getter's back with
  :func:`tensors_to_numpy`, so a stream started in one package continues
  in the other.

The windowed FFT (K7) carries no state; its windows and tables, the FFT
plans and the grid plans are rebuilt from the same arguments on both sides,
and the tests hold the tables equal.  Every ``device`` defaults to the
card.

The sharded chains (``parallel/``) keep one copy of their state on each
rank where the JAX package keeps one global array:

* the sharded receive chain's ``ChainState``: its per-channel leaves
  (``fir_tail`` (C, n-1), the AGC carry and ``fm_prev``, (C,)) are split
  over the mesh's ``channel`` axis and the rest replicated;
  :func:`sharded_state_from_numpy` cuts this rank's part out of the JAX
  chain's global state, and :func:`sharded_state_to_numpy` gathers the
  parts back (collective over ``channel``).  The planar single stream's
  state has no channel dimension and is the same on every rank;
* the sharded channelizers' tails and K9's tail rows are replicated: the
  "xla" tail (K*M - 1,), the fused tail rows (2, 8, M) float32 and K9's
  (K, M) complex64 rows move with :func:`tensors_from_numpy` and
  :func:`tensors_to_numpy` on each rank, as the single-card tails do.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .device import resolve_device
from .parallel.halo import axis_gather
from .parallel.mesh import local_block, mesh_device
from .streaming.state import from_numpy as state_from_numpy
from .streaming.state import to_numpy as state_to_numpy

__all__ = ["state_from_numpy", "state_to_numpy", "tensors_from_numpy",
           "tensors_to_numpy", "sharded_state_from_numpy",
           "sharded_state_to_numpy"]

_REPLICATED = ("nco_theta", "fir_phase")


def tensors_from_numpy(tree, device=None):
    """numpy arrays, or tuples, lists and mappings of them -> the same
    structure of tensors on ``device``, each an exact copy (same shape and
    dtype)."""
    device = resolve_device(device)
    if isinstance(tree, Mapping):
        return {k: tensors_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tensors_from_numpy(v, device) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def tensors_to_numpy(tree):
    """Tensors, or tuples, lists and mappings of them -> the same
    structure of numpy arrays (exact copies on the host)."""
    if isinstance(tree, Mapping):
        return {k: tensors_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tensors_to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy().copy()


def _per_channel(tree: Mapping) -> bool:
    """A multi-stream chain state: its FIR tail has a channel dimension."""
    return np.ndim(tree["fir_tail"]) == 2


def sharded_state_from_numpy(tree: Mapping, mesh):
    """The JAX sharded chain's global state (numpy leaves) -> this rank's
    ChainState on the mesh's device: per-channel leaves cut to this rank's
    streams along ``channel``, the rest whole."""
    split = _per_channel(tree)

    def cut(key, v):
        if isinstance(v, Mapping):
            return {k: cut(k, a) for k, a in v.items()}
        a = np.asarray(v)
        return (local_block(a, mesh, ("channel",))
                if split and key not in _REPLICATED else a)

    return state_from_numpy({k: cut(k, v) for k, v in tree.items()},
                            mesh_device(mesh))


def sharded_state_to_numpy(state: Mapping, mesh) -> dict:
    """This rank's ChainState -> the global state as the JAX sharded chain
    holds it (numpy leaves, phase words ``uint32``): per-channel leaves
    gathered over ``channel``.  Every rank of the mesh calls it."""
    split = state["fir_tail"].dim() == 2

    def join(key, v):
        if isinstance(v, Mapping):
            return {k: join(k, a) for k, a in v.items()}
        return (axis_gather(v, mesh, "channel", dim=0)
                if split and key not in _REPLICATED else v)

    return state_to_numpy({k: join(k, v) for k, v in state.items()})
