"""Host-side banded-Toeplitz banks (numpy).

Port of ``solid_dsp_tpu/ops/fir.py::_banks_np`` and ``_bank_rem_np``.  The
plain versions of the DDC bodies (``ops/cuda_ddc.py``, ``ops/ddc.py``) run
their filter as matmuls of input frames against these banks.
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


def _bank_rem_np(taps2: np.ndarray, Tr: int, stride: int):
    """Bank (width_r, Tr*O) of Tr outputs over the (Tr-1)*stride + n input
    samples they read: the head and straggler pieces of a block."""
    n, O = taps2.shape
    wr = (Tr - 1) * stride + n
    H = np.zeros((wr, Tr * O), taps2.dtype)
    for p in range(Tr):
        H[p * stride : p * stride + n, p * O : (p + 1) * O] = taps2
    return H
