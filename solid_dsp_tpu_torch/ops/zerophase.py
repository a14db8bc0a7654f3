"""Zero-phase (forward-backward) filtering: offline ``filtfilt``.

Port of ``solid_dsp_tpu/ops/zerophase.py``.  The filter runs forward, the
result is reversed, filtered again and reversed back: the magnitude response
applies twice (|H|^2) and the phase cancels.  Both passes are the block
filters of ``ops/fir.py`` and ``ops/iir.py`` (on the card an IIR pass
launches S3 once, an SOS pass the fused cascade once; IIR coefficients stay
where the caller gave them, so those taken from the host reach the kernels'
tables without a read-back from the card); the edges are
padded by odd reflection about the end samples (scipy's ``padtype="odd"``),
2 * ntaps for FIR and sized from the slowest pole for IIR, and the pad is
trimmed off.  Functions of tensors: they run where ``x`` lies.
"""

from __future__ import annotations

import numpy as np
import torch

from .fir import fir_apply, fir_init
from .iir import iir_apply, iir_init, max_pole_radius, sos_cascade_apply, \
    sos_init

__all__ = ["filtfilt_fir", "filtfilt_iir", "filtfilt_sos"]


def _transient_pad(base: int, r: float) -> int:
    """Pad long enough for the slowest pole's transient to decay to 1e-6
    (interior accuracy does not depend on it; edge accuracy does)."""
    if 0.0 < r < 0.9999:
        return max(base, int(np.ceil(np.log(1e-6) / np.log(r))))
    return base


def _odd_reflect(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Odd reflection about the end samples: 2 x[0] - x[pad:0:-1] before,
    2 x[-1] - x[-2:-pad-2:-1] after."""
    if pad <= 0:
        return x
    if x.shape[-1] <= pad:
        raise ValueError(f"signal length {x.shape[-1]} must exceed pad {pad}")
    n = x.shape[-1]
    head = 2 * x[..., :1] - torch.flip(x[..., 1:pad + 1], dims=(-1,))
    tail = 2 * x[..., -1:] - torch.flip(x[..., n - pad - 1:n - 1], dims=(-1,))
    return torch.cat([head, x, tail], dim=-1)


def _as_tensor(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def _reverse(y: torch.Tensor) -> torch.Tensor:
    return torch.flip(y, dims=(-1,))


def filtfilt_fir(taps, x, pad: int | None = None) -> torch.Tensor:
    """Zero-phase FIR filtering, taps (ntaps,), x (..., N): |H(f)|^2 with
    exactly zero phase.  ``pad`` defaults to 2 * ntaps (< N, >= ntaps - 1)."""
    x = _as_tensor(x)
    taps = _as_tensor(taps, x.device)
    ntaps = int(taps.shape[-1])
    if pad is None:
        pad = 2 * ntaps
    if pad < ntaps - 1:
        raise ValueError("pad must be at least ntaps-1")
    xe = _odd_reflect(x, int(pad))
    dtype = torch.promote_types(taps.dtype, xe.dtype)
    tail = fir_init(ntaps, dtype, device=x.device)
    y, _ = fir_apply(taps, tail, xe.to(dtype))
    y, _ = fir_apply(taps, tail, _reverse(y))
    y = _reverse(y)
    # the forward and the anticausal pass compose to the taps'
    # autocorrelation, symmetric about lag 0: only the pad is trimmed
    return y[..., pad: y.shape[-1] - pad]


def filtfilt_iir(b, a, x, pad: int | None = None,
                 method: str = "parallel") -> torch.Tensor:
    """Zero-phase IIR filtering with (b, a) coefficients (a[0] == 1) over
    x (N,).  Edge accuracy comes from the odd-reflection pad, sized by
    default from the slowest pole so its transient decays below 1e-6
    (interior samples agree with scipy's filtfilt to machine precision)."""
    x = _as_tensor(x)
    b = _as_tensor(b, x.device)
    a = _as_tensor(a)
    a_tail = a[..., 1:]
    if pad is None:
        pad = _transient_pad(6 * max(int(a_tail.shape[-1]), 1),
                             max_pole_radius(a.cpu().numpy()))
    xe = _odd_reflect(x, int(pad))
    dtype = torch.promote_types(b.dtype, xe.dtype)
    w0 = iir_init(int(a_tail.shape[-1]), dtype, device=x.device)
    y, _ = iir_apply(b, a_tail, w0, xe.to(dtype), method=method)
    y, _ = iir_apply(b, a_tail, w0, _reverse(y), method=method)
    y = _reverse(y)
    return y[..., pad: y.shape[-1] - pad]


def filtfilt_sos(sos_b, sos_a, x, pad: int | None = None,
                 method: str = "parallel") -> torch.Tensor:
    """Zero-phase filtering through an SOS cascade: sos_b (S, 3)
    numerators, sos_a (S, 3) denominators with a0 == 1 (as
    ``ops.iir.sos_cascade_apply`` takes them).  The default pad is sized
    from the slowest section pole."""
    x = _as_tensor(x)
    sos_b = _as_tensor(sos_b)
    sos_a = _as_tensor(sos_a)
    if pad is None:
        r = max(max_pole_radius(row) for row in sos_a.cpu().numpy())
        pad = _transient_pad(18 * int(sos_b.shape[0]), r)
    xe = _odd_reflect(x, int(pad))
    dtype = torch.promote_types(sos_b.dtype, xe.dtype)
    s0 = sos_init(int(sos_b.shape[0]), dtype, device=x.device)
    y, _ = sos_cascade_apply(sos_b, sos_a[..., 1:], s0, xe.to(dtype),
                             method=method)
    y, _ = sos_cascade_apply(sos_b, sos_a[..., 1:], s0, _reverse(y),
                             method=method)
    y = _reverse(y)
    return y[..., pad: y.shape[-1] - pad]
