"""Process groups and ``(channel, time)`` device meshes for the sharded chains.

Port of ``solid_dsp_tpu/parallel/mesh.py``.  Where the JAX package lays
devices of one process out on a ``jax.sharding.Mesh``, the port runs one
process a device (a rank of ``torch.distributed``) and lays the ranks out
on a :class:`torch.distributed.device_mesh.DeviceMesh` with the same axis
names:

``channel``
    independent streams, or the channelizer's tap-parallel axis;
``time``
    overlap-save blocks of one stream: neighbour ranks exchange halos.

On cards the group is NCCL, one card a rank (``torchrun --nproc-per-node
N``, or :func:`init_distributed` with a ``FileStore`` path); on the CPU,
for the tests, it is gloo.  The backend follows the device that the caller
names (``device=None`` is the card), never what the machine has.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..device import resolve_device

__all__ = ["init_distributed", "make_mesh", "mesh_axes", "mesh_device",
           "axis_info", "local_block"]

AXES = ("channel", "time")


def init_distributed(device=None, store_path: str | None = None,
                     rank: int | None = None,
                     world_size: int | None = None) -> torch.device:
    """Initialise the default process group and return this rank's device.

    ``device``: the card unless told otherwise; a CUDA device gives an NCCL
    group and this rank's card (``LOCAL_RANK``, else the rank, modulo the
    cards present), ``"cpu"`` a gloo group.  ``store_path``: a file that
    every rank names (a ``FileStore``, nothing listens on a port), with
    ``rank`` and ``world_size``; without it the ``torchrun`` environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) is read.
    """
    dev = resolve_device(device)
    if store_path is None:
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                      else world_size)
        init_method = "env://"
    else:
        if rank is None or world_size is None:
            raise ValueError("a FileStore path needs rank and world_size")
        init_method = f"file://{store_path}"
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        index = dev.index if dev.index is not None else (
            local % torch.cuda.device_count())
        torch.cuda.set_device(index)
        dev = torch.device("cuda", index)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return dev


def make_mesh(channel: int = 1, time: int = 1, device=None) -> DeviceMesh:
    """A ``(channel, time)`` mesh over the first ``channel * time`` ranks of
    the initialised default group (extra ranks are left out of it, as JAX
    leaves out extra devices).  Every rank of the group calls it.

    ``device``: the card unless told otherwise ("cpu" for a gloo group)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(init_distributed)")
    need = channel * time
    have = dist.get_world_size()
    if have < need:
        raise ValueError(f"mesh ({channel} x {time}) needs {need} devices, "
                         f"have {have}")
    return DeviceMesh(resolve_device(device).type,
                      torch.arange(need).reshape(channel, time),
                      mesh_dim_names=AXES)


def mesh_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors live on: its current card for a CUDA
    mesh, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_info(mesh: DeviceMesh, axis: str):
    """(process group, this rank's index along ``axis``, the axis size)."""
    return (mesh.get_group(axis), mesh.get_local_rank(axis),
            mesh.size(mesh_axes(mesh).index(axis)))


def local_block(a, mesh: DeviceMesh, spec: tuple):
    """This rank's block of a global array (numpy or tensor): ``spec`` names,
    for each leading dim, the mesh axis it is split over, or None where it
    is replicated (``jax.sharding.PartitionSpec``'s meaning; dims past the
    spec are whole).  Each split dim must divide by its axis size."""
    index = []
    for d, axis in enumerate(spec):
        if axis is None:
            index.append(slice(None))
            continue
        _, i, n = axis_info(mesh, axis)
        if a.shape[d] % n:
            raise ValueError(f"dim {d} ({a.shape[d]}) does not divide by the "
                             f"{axis} axis ({n})")
        step = a.shape[d] // n
        index.append(slice(i * step, (i + 1) * step))
    return a[tuple(index)]
