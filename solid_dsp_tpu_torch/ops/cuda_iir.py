"""The multi-channel IIR biquad bank on Hopper: wrapper and plain version.

Port of the TPU kernel ``solid_dsp_tpu/ops/pallas_kernels.py::
iir_bank_apply`` (K6, :238-302) with ``iir_bank_init`` (:230-235): an
S-section direct-form-II biquad cascade run over C complex channels at
once, sequential in time, with the state (2S, C) complex64 rows
[w1_0, w2_0, w1_1, ...] carried from block to block.  ``sos`` is (S, 5)
[b0 b1 b2 a1 a2] shared by every channel or (S, 5, C) per channel.

* :func:`iir_bank_cuda` launches ``csrc/iir_bank.cu`` (one thread per real
  lane, state and coefficients in registers; 1 <= S <= 8, any T).
* :func:`iir_bank_torch` is the plain version: a Python loop over time,
  vectorised over the channels, in the kernel's order of operations (the
  spec of ``tests/test_pallas.py::_np_sos_ref``).

:func:`iir_bank_apply` takes the plain version for CPU tensors and the
kernel for CUDA tensors (``engine="auto"``); ``"torch"`` runs the plain
version on any device.
"""

from __future__ import annotations

import ctypes

import torch

from ..device import resolve_device
from .cuda_build import check_launch, launcher, stream_of, use_kernel

__all__ = ["iir_bank_init", "iir_bank_apply", "iir_bank_lanes",
           "iir_bank_torch", "iir_bank_cuda", "MAX_SECTIONS"]

MAX_SECTIONS = 8
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = (_P,) * 5 + (_LL, _I, _I, _I, _P)


def iir_bank_init(nsections: int, num_channels: int, device=None
                  ) -> torch.Tensor:
    """Zero cascade state (2S, C) complex64 on ``device`` (the card unless
    told otherwise)."""
    return torch.zeros((2 * nsections, num_channels), dtype=torch.complex64,
                       device=resolve_device(device))


def iir_bank_lanes(sos, num_channels: int, device) -> torch.Tensor:
    """(S, 5) or (S, 5, C) coefficients -> (5S, 2C) float32, row 5s + k
    holding coefficient k of section s for every interleaved re/im lane."""
    sos = torch.as_tensor(sos, dtype=torch.float32, device=device)
    S = sos.shape[0]
    if sos.dim() == 2:
        sos = sos[:, :, None].expand(S, 5, num_channels)
    if tuple(sos.shape) != (S, 5, num_channels):
        raise ValueError(f"sos must be (S, 5) or (S, 5, {num_channels}), "
                         f"got {tuple(sos.shape)}")
    return sos.reshape(5 * S, num_channels).repeat_interleave(2, dim=1
                                                              ).contiguous()


def _check(sos_l, state, x):
    if x.dim() != 2 or state.dim() != 2 or state.shape[1] != x.shape[1]:
        raise ValueError(f"x must be (T, C) and state (2S, C); got "
                         f"{tuple(x.shape)} and {tuple(state.shape)}")
    if state.shape[0] % 2 or tuple(sos_l.shape) != (
            5 * (state.shape[0] // 2), 2 * x.shape[1]):
        raise ValueError(f"coefficients {tuple(sos_l.shape)} do not match "
                         f"the state {tuple(state.shape)}")


def iir_bank_torch(sos_l: torch.Tensor, state: torch.Tensor,
                   x: torch.Tensor):
    """Plain version: (y (T, C) complex, new_state (2S, C)) from the lane
    coefficients of :func:`iir_bank_lanes`, in the dtype of x."""
    _check(sos_l, state, x)
    S = state.shape[0] // 2
    rdt = x.real.dtype
    co = sos_l.to(rdt).reshape(S, 5, -1)
    w = list(torch.view_as_real(state.to(x.dtype)).reshape(2 * S, -1
                                                           ).unbind(0))
    xs = torch.view_as_real(x).reshape(x.shape[0], -1)
    y = torch.empty_like(xs)
    for t in range(x.shape[0]):
        v = xs[t]
        for s in range(S):
            b0, b1, b2, a1, a2 = co[s]
            w1, w2 = w[2 * s], w[2 * s + 1]
            fb = a1 * w1 + a2 * w2
            ff = b1 * w1 + b2 * w2
            w0 = v - fb
            v = b0 * w0 + ff
            w[2 * s], w[2 * s + 1] = w0, w1
        y[t] = v
    new_state = torch.view_as_complex(
        torch.stack(w).reshape(2 * S, -1, 2).contiguous())
    return (torch.view_as_complex(y.reshape(x.shape[0], -1, 2)),
            new_state.to(state.dtype))


def iir_bank_cuda(sos_l: torch.Tensor, state: torch.Tensor,
                  x: torch.Tensor):
    """Launch K6 (``csrc/iir_bank.cu``): (y (T, C) complex64, new_state).
    Takes contiguous complex64 x and state and float32 lane coefficients on
    one card, 1 <= S <= 8; raises on anything else.  Adds one to
    ``iir_bank_cuda.launches``."""
    _check(sos_l, state, x)
    if not (x.is_cuda and state.device == x.device
            and sos_l.device == x.device):
        raise ValueError("iir_bank_cuda needs sos, state and x on one CUDA "
                         "device; CPU tensors take iir_bank_torch")
    if (x.dtype != torch.complex64 or state.dtype != torch.complex64
            or sos_l.dtype != torch.float32):
        raise TypeError("iir_bank_cuda takes complex64 x and state and "
                        "float32 coefficients")
    if not (x.is_contiguous() and state.is_contiguous()
            and sos_l.is_contiguous()):
        raise ValueError("iir_bank_cuda needs contiguous tensors")
    S = state.shape[0] // 2
    if not 1 <= S <= MAX_SECTIONS:
        raise ValueError(f"iir_bank_cuda takes 1 to {MAX_SECTIONS} "
                         f"sections, got {S}")
    T, C = x.shape
    y = torch.empty((T, C), dtype=torch.complex64, device=x.device)
    new_state = torch.empty_like(state)
    fn = launcher("iir_bank.cu", "iir_bank_launch", _ARGS)
    check_launch(fn(x.data_ptr(), sos_l.data_ptr(), state.data_ptr(),
                    y.data_ptr(), new_state.data_ptr(), T, C, S,
                    x.device.index, stream_of(x)), "iir_bank_cuda")
    iir_bank_cuda.launches += 1
    return y, new_state


iir_bank_cuda.launches = 0


def iir_bank_apply(sos, state: torch.Tensor, x: torch.Tensor,
                   engine: str = "auto"):
    """Run the cascade over x (T, C) complex from ``state`` (2S, C):
    returns (y (T, C), new_state).  ``sos`` is (S, 5) shared or (S, 5, C)
    per channel."""
    sos_l = iir_bank_lanes(sos, x.shape[-1], x.device)
    if use_kernel(engine, x):
        return iir_bank_cuda(sos_l, state, x)
    return iir_bank_torch(sos_l, state, x)
