"""Neighbour halo exchange along a mesh axis.

Port of ``solid_dsp_tpu/parallel/halo.py``.  Under time sharding the
streaming ``Window`` state becomes the halo a rank receives from its LEFT
neighbour before it filters its block.  Where JAX calls ``lax.ppermute``
and ``lax.psum`` inside ``shard_map``, these run point-to-point operations
and collectives on the mesh axis's process group: every rank of the axis
calls each of them, in the same order, with tensors of the same shape.
Complex tensors travel as their real views.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops.nco import U32_MASK
from .mesh import axis_info

__all__ = ["left_halo", "right_halo", "from_last_shard", "time_offset",
           "axis_mean", "axis_sum", "axis_gather"]


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The view a collective moves: complex as (..., 2) reals, bool as
    bytes."""
    if t.is_complex():
        return torch.view_as_real(t)
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _shift(x: torch.Tensor, mesh: DeviceMesh, axis: str, step: int):
    """Rank i receives rank i - step's ``x`` along ``axis``; ranks with no
    such neighbour receive zeros (``ppermute``'s unmatched targets)."""
    group, i, n = axis_info(mesh, axis)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    if 0 <= i + step < n:
        ops.append(dist.P2POp(dist.isend, _wire(x),
                              dist.get_global_rank(group, i + step), group))
    if 0 <= i - step < n:
        ops.append(dist.P2POp(dist.irecv, _wire(out),
                              dist.get_global_rank(group, i - step), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def left_halo(x: torch.Tensor, mesh: DeviceMesh, axis: str = "time"):
    """Receive ``x`` from the left neighbour along ``axis``: rank i gets
    rank i-1's value, rank 0 gets zeros.  Pass the tail slice to ship,
    e.g. ``left_halo(block[..., -(ntaps - 1):], mesh)``."""
    return _shift(x, mesh, axis, 1)


def right_halo(x: torch.Tensor, mesh: DeviceMesh, axis: str = "time"):
    """Receive ``x`` from the right neighbour (the last rank gets zeros)."""
    return _shift(x, mesh, axis, -1)


def from_last_shard(x: torch.Tensor, mesh: DeviceMesh, axis: str = "time"):
    """The LAST rank's ``x`` along ``axis``, on every rank of it: one
    broadcast (JAX's masked ``psum``).  Turns state that lives on the final
    time shard (the new FIR tail) into a replicated carry."""
    group, _, n = axis_info(mesh, axis)
    out = x.contiguous().clone()
    if n > 1:
        dist.broadcast(_wire(out), src=dist.get_global_rank(group, n - 1),
                       group=group)
    return out


def axis_sum(x: torch.Tensor, mesh: DeviceMesh, axis: str):
    """``lax.psum``: the sum of ``x`` over the ranks of ``axis``."""
    _, _, n = axis_info(mesh, axis)
    out = x.contiguous().clone()
    if n > 1:
        dist.all_reduce(_wire(out), group=mesh.get_group(axis))
    return out


def axis_mean(x: torch.Tensor, mesh: DeviceMesh, axis: str):
    """``lax.pmean``: the mean of ``x`` over the ranks of ``axis``."""
    _, _, n = axis_info(mesh, axis)
    return axis_sum(x, mesh, axis) / n


def axis_gather(x: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int = -1):
    """``lax.all_gather(..., tiled=True)``: the ranks' ``x`` along ``axis``
    concatenated on ``dim`` in rank order."""
    group, _, n = axis_info(mesh, axis)
    if n == 1:
        return x.clone()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather([_wire(p) for p in parts], _wire(x), group=group)
    return torch.cat(parts, dim=dim)


def time_offset(mesh: DeviceMesh, local_len: int, axis: str = "time") -> int:
    """Global sample offset of this rank's block start, as a u32 word
    (``& 0xFFFFFFFF``, as ``ops/nco.py`` keeps phase words)."""
    _, i, _ = axis_info(mesh, axis)
    return (i * int(local_len)) & U32_MASK
