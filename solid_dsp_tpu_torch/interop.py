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

The windowed FFT (K7) carries no state; its windows and tables, the FFT
plans and the grid plans are rebuilt from the same arguments on both sides,
and the tests hold the tables equal.  Every ``device`` defaults to the
card.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .device import resolve_device
from .streaming.state import from_numpy as state_from_numpy
from .streaming.state import to_numpy as state_to_numpy

__all__ = ["state_from_numpy", "state_to_numpy", "tensors_from_numpy",
           "tensors_to_numpy"]


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
