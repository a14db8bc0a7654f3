"""AM modulation and demodulation: envelope, coherent DSB and SSB.

Port of ``solid_dsp_tpu/models/am.py``.  The envelope detector is |x|
followed by a one-pole DC tracker, m[n] = (1 - alpha) m[n-1] + alpha x[n],
y = x - m, whose carry is the scalar m.  JAX solves that recurrence by an
associative scan of (coefficient, value) pairs; here it is the port's IIR
layer, ``ops/iir.py::iir_apply`` with b = [1] and a = [1, -(1 - alpha)] on
alpha x, so its w-state is m itself (its "parallel" route; on the card
that is S3, ``csrc/iir_scan.cu``), as ``models/fm.py``'s de-emphasis runs.
The SSB rail is a streaming Hilbert FIR (``design/firdes.py::
firdes_hilbert``) through ``conv1d_mxu``, the real rail delayed to its
group delay.  Tensor functions run where their input lies;
``dc_blocker_init`` and ``hilbert_init`` take ``device`` (the card by
default).
"""

from __future__ import annotations

import numpy as np
import torch

from ..design.firdes import firdes_hilbert
from ..device import device_constant, resolve_device
from ..ops.fir import conv1d_mxu
from ..ops.iir import iir_apply
from ..streaming.framing import extend_with_tail, split_tail

__all__ = ["am_modulate", "am_demodulate_envelope", "am_demodulate_coherent",
           "dc_blocker_init", "dc_blocker_apply", "hilbert_init",
           "analytic_block", "ssb_modulate", "ssb_demodulate"]


def am_modulate(msg: torch.Tensor, modulation_index: float = 1.0,
                carrier_level: float = 1.0) -> torch.Tensor:
    """DSB-LC AM at complex baseband: carrier_level + modulation_index * msg
    as a real envelope (complex64, or complex128 for float64 input)."""
    msg = torch.as_tensor(msg)
    cd = torch.promote_types(msg.dtype, torch.complex64)
    return (carrier_level + modulation_index * msg).to(cd)


def dc_blocker_init(dtype=torch.float32, batch_shape: tuple = (),
                    device=None) -> torch.Tensor:
    """The DC tracker's carry m (zeros) on ``device``."""
    return torch.zeros(batch_shape, dtype=dtype,
                       device=resolve_device(device))


def dc_blocker_apply(state: torch.Tensor, x: torch.Tensor,
                     alpha: float = 0.01):
    """One-pole DC tracker over the last axis: m[n] = (1 - alpha) m[n-1] +
    alpha x[n], y = x - m.  Returns (y, m[..., -1])."""
    x = torch.as_tensor(x)
    a_tail = torch.tensor([-(1.0 - alpha)], dtype=x.dtype)
    b = torch.tensor([1.0], dtype=x.dtype)
    w0 = torch.as_tensor(state, device=x.device).to(x.dtype)[..., None]
    m, _ = iir_apply(b, a_tail, w0, (alpha * x).movedim(-1, 0))
    m = m.movedim(0, -1)
    return x - m, m[..., -1]


def am_demodulate_envelope(state, x: torch.Tensor, alpha: float = 0.01):
    """Envelope detector: |x| through the DC tracker.  Returns (y,
    new_state)."""
    return dc_blocker_apply(state, torch.abs(torch.as_tensor(x)), alpha)


def am_demodulate_coherent(x: torch.Tensor) -> torch.Tensor:
    """Coherent DSB demodulation at baseband: the in-phase rail."""
    return torch.as_tensor(x).real


def hilbert_init(ntaps: int = 63, dtype=torch.float32, device=None):
    """(taps, tail) of the streaming analytic-signal transformer: the
    Hilbert taps as host numpy in ``dtype``'s precision, the zero tail
    (ntaps - 1,) on ``device``."""
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    taps = np.asarray(firdes_hilbert(ntaps), dtype=np_dt)
    return taps, torch.zeros(ntaps - 1, dtype=dtype,
                             device=resolve_device(device))


def analytic_block(taps, tail: torch.Tensor, x: torch.Tensor):
    """Streaming analytic signal a[n] = x[n - (N-1)/2] + j H{x}[n] (the
    real rail delayed to the Hilbert FIR's group delay), ``taps`` the host
    numpy of :func:`hilbert_init`.  Returns (a, new_tail)."""
    x = torch.as_tensor(x, device=tail.device)
    n = len(taps)
    c = (n - 1) // 2
    x_ext = extend_with_tail(tail, x)
    # conv1d_mxu correlates; the Hilbert kernel is antisymmetric, so the
    # correlation applies -h: negated for the true convolution H{x}
    q = conv1d_mxu(x_ext, device_constant(-np.asarray(taps), x_ext.device,
                                          x_ext.dtype))
    i = x_ext[..., c: c + x.shape[-1]]
    return torch.complex(i, q), split_tail(x_ext, n - 1)


def ssb_modulate(taps, tail, msg, sideband: str = "upper"):
    """SSB at complex baseband: "upper" is the analytic signal of msg
    (positive frequencies), "lower" its conjugate.  Returns (iq,
    new_tail)."""
    if sideband not in ("upper", "lower"):
        raise ValueError("sideband must be 'upper' or 'lower'")
    a, tail = analytic_block(taps, tail, msg)
    return (torch.conj(a).resolve_conj() if sideband == "lower" else a), tail


def ssb_demodulate(x: torch.Tensor) -> torch.Tensor:
    """Coherent SSB demodulation at baseband: the real rail."""
    return torch.as_tensor(x).real
