"""The Farrow grid resampler on Hopper (K8): wrapper and engine.

Port of ``solid_dsp_tpu/ops/pallas_resample.py::
make_farrow_kernel_resampler`` (:114-173): the streaming Farrow resampler
of ``ops/farrow.py`` on the exact int32 grid, with the per-output work in
one kernel, ``csrc/farrow.cu`` (one thread an output; the source has the
design).  :func:`farrow_grid_cuda` launches it and counts
``farrow_grid_cuda.launches``; its plain version is
``ops/farrow.py::farrow_grid_plain``, the torch-ops engine of
``make_farrow_resampler``.  A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.  t0 and n_valid stay on the device as
int32 tensors: no block syncs with the host.
"""

from __future__ import annotations

import ctypes

import torch

from ..device import resolve_device
from .cuda_build import check_launch, launcher, stream_of, use_kernel
from .farrow import STENCIL, _init, farrow_grid_plain
from .gridresample import GridPlan, plan_ratio

__all__ = ["farrow_grid_cuda", "make_farrow_kernel_resampler"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = (_P,) * 6 + (_I,) * 12 + (_P,)


def farrow_grid_cuda(plan: GridPlan, tail: torch.Tensor, t0: torch.Tensor,
                     x: torch.Tensor):
    """Launch K8 on one block: (y_pad (n_pad,) complex64, n_valid int32
    0-d, (new_tail (3,) complex64, t0' int32 0-d)), as
    :func:`~solid_dsp_tpu_torch.ops.farrow.farrow_grid_plain`.  Takes
    contiguous complex64 x (L,) and tail (3,) and an int32 t0 on one card;
    raises on anything else.  Adds one to ``farrow_grid_cuda.launches``."""
    L = plan.L
    if x.dim() != 1 or int(x.shape[0]) != L:
        raise ValueError(f"block must be ({L},), got {tuple(x.shape)}")
    if tuple(tail.shape) != (STENCIL - 1,) or t0.numel() != 1:
        raise ValueError("state must be (tail (3,), t0 scalar)")
    if not (x.is_cuda and tail.device == x.device and t0.device == x.device):
        raise ValueError("farrow_grid_cuda needs x and the state on one "
                         "CUDA device; CPU tensors take farrow_grid_plain")
    if (x.dtype != torch.complex64 or tail.dtype != torch.complex64
            or t0.dtype != torch.int32):
        raise TypeError("farrow_grid_cuda takes complex64 x and tail and an "
                        "int32 t0")
    if not (x.is_contiguous() and tail.is_contiguous()):
        raise ValueError("farrow_grid_cuda needs contiguous tensors")
    y = torch.empty(plan.n_pad, dtype=torch.complex64, device=x.device)
    new_tail = torch.empty(STENCIL - 1, dtype=torch.complex64,
                           device=x.device)
    meta = torch.empty(2, dtype=torch.int32, device=x.device)
    fn = launcher("farrow.cu", "farrow_grid_launch", _ARGS)
    check_launch(fn(x.data_ptr(), tail.data_ptr(), t0.data_ptr(),
                    y.data_ptr(), new_tail.data_ptr(), meta.data_ptr(), L,
                    plan.n_pad, plan.R, plan.q0, plan.r0, *plan.C, *plan.D,
                    x.device.index, stream_of(x)), "farrow_grid_cuda")
    farrow_grid_cuda.launches += 1
    return y, meta[0], (new_tail, meta[1])


farrow_grid_cuda.launches = 0


def make_farrow_kernel_resampler(ratio: float, block_len: int,
                                 dtype: torch.dtype = torch.complex64,
                                 device=None, engine: str = "auto"):
    """``(init, apply, plan)`` like ``make_farrow_resampler``, with each
    block through K8 for CUDA tensors (``engine="auto"``): the same exact
    grid and cubic Lagrange taps, outputs equal to f32 rounding.
    ``apply(state, x) -> (y_pad, n_valid, state)``."""
    plan = plan_ratio(ratio, int(block_len))
    device = resolve_device(device)

    def apply(state, x):
        tail, t0 = state
        x = x.to(tail.dtype)
        if use_kernel(engine, x):
            return farrow_grid_cuda(plan, tail, t0, x.contiguous())
        return farrow_grid_plain(plan, tail, t0, x)

    return _init(dtype, device), apply, plan
