"""Moving chain state between the JAX package and this port.

This system has no weights: its parameters are the taps designed on the host
(``design/``), the banks built from them (``ops/cuda_ddc.py``) and the
streaming state.  The state crosses between the two packages as a nested
mapping of numpy leaves with the same keys (``nco_theta``, ``fir_tail``,
``fir_phase``, ``agc{gain,energy,lock,mode,timer}``, ``fm_prev``):

* ``state_from_numpy(tree, device)`` takes the JAX chain's state with its
  leaves fetched by ``np.asarray`` (for example
  ``jax.tree_util.tree_map(np.asarray, state)``) and returns the port's
  :class:`~solid_dsp_tpu_torch.streaming.state.ChainState` on ``device``;
* ``state_to_numpy(state)`` returns the port's state as such a mapping,
  with the phase word as numpy ``uint32`` like the JAX package's.
"""

from .streaming.state import from_numpy as state_from_numpy
from .streaming.state import to_numpy as state_to_numpy

__all__ = ["state_from_numpy", "state_to_numpy"]
