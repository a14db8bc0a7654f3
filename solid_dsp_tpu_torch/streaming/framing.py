"""Block framing and overlap-save bookkeeping.

Port of ``solid_dsp_tpu/streaming/framing.py`` (:17-39).  A stream is cut
into blocks; each block is extended by the carried tail (the last
``ntaps - 1`` inputs, the reference's shift-register ``Window``) and runs as
one batched product.  The FIR filters and resamplers share these helpers.
"""

from __future__ import annotations

import torch

__all__ = ["extend_with_tail", "split_tail", "frame_windows"]


def extend_with_tail(tail: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Prepend carried history to a block: [tail | x] along the last axis,
    in the type both promote to."""
    dt = torch.promote_types(tail.dtype, x.dtype)
    return torch.cat([tail.to(dt), x.to(dt)], dim=-1)


def split_tail(x_ext: torch.Tensor, tail_len: int) -> torch.Tensor:
    """New tail = the last ``tail_len`` samples of the extended block."""
    if tail_len == 0:
        return x_ext[..., :0]
    return x_ext[..., -tail_len:]


def frame_windows(x_ext: torch.Tensor, length: int,
                  stride: int = 1) -> torch.Tensor:
    """im2col framing: windows[..., t, i] = x_ext[..., t*stride + i], shape
    (..., T, length) with T = (n - length) // stride + 1 (a strided view,
    no copy)."""
    n = x_ext.shape[-1]
    T = (n - length) // stride + 1
    return x_ext.unfold(-1, length, stride)[..., :T, :]
