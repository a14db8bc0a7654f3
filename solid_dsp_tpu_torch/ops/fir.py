"""Host-side banded-Toeplitz bank builder (numpy).

Port of ``solid_dsp_tpu/ops/fir.py::_banks_np``.  The plain version of the
fused DDC+FM body (``ops/cuda_ddc.py``) runs its filter as matmuls of input
frames against these banks.
"""

from __future__ import annotations

import numpy as np


def _banks_np(taps2: np.ndarray, P: int, stride: int):
    """Body (hop, P*O) and head (n-1, P*O) rows of the banded-Toeplitz bank
    H[j, p*O + o] = taps2[j - p*stride, o], hop = P*stride: output p of a
    frame reads frame-local input rows [p*stride, p*stride + n)."""
    n, O = taps2.shape
    hop = P * stride
    H = np.zeros((hop + n - 1, P * O), taps2.dtype)
    for p in range(P):
        H[p * stride : p * stride + n, p * O : (p + 1) * O] = taps2
    return H[:hop], H[hop:]
