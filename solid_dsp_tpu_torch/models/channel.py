"""Channel-model helpers.

Port of ``solid_dsp_tpu/models/channel.py::host_wrapped_phase`` (:65), the
exact host-side oscillator phase that ``models/fm.py``'s stereo multiplex
and decoder use.  The rest of the JAX module (noise, CFO, fading) is not
ported yet.
"""

from __future__ import annotations

import numpy as np

__all__ = ["host_wrapped_phase"]


def host_wrapped_phase(n_samples: int, cycles_per_sample: float,
                       phase0: float = 0.0) -> np.ndarray:
    """(N,) float32 phase 2 pi ((f n) mod 1) + phase0, built on the host.

    2 pi f n taken directly in float32 loses integer resolution once n
    exceeds 2^24; reducing mod 1 in float64 first keeps the wrapped phase
    exact to ~1e-8 cycles for any practical block length."""
    frac = (float(cycles_per_sample) % 1.0) * np.arange(
        n_samples, dtype=np.float64)
    return (2.0 * np.pi * (frac % 1.0) + phase0).astype(np.float32)
