"""The time-sharded channelizer front end with its halo exchange fused in.

Port of ``solid_dsp_tpu/parallel/pallas_halo.py`` (the name is kept so that
a reader finds the counterpart).  ``sharded.py`` exchanges halos with
``left_halo`` before it computes; here one kernel per block and rank (K9,
``ops/cuda_halo.py``, ``csrc/halo_frontend.cu``) ships the rank's last K
frame rows to its right neighbour, computes the interior branch-product
rows while they travel, and finishes the first K rows from the halo it
received (the carried tail rows on the first time shard).  The compute is
the channelizer front end K5's, so ``torch.fft.fft(z, dim=-1)`` gives the M
channel outputs.

On a CPU mesh (the tests' gloo ranks) :func:`halo_frontend_torch` runs the
same function in torch ops: ``left_halo`` of the last K rows, the first
shard's tail select, and the (K+1)-tap per-lane product on [halo | x].
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..models.channelizer import channelizer_taps
from ..ops.cuda_build import ENGINES, use_kernel
from ..ops.cuda_chan import pfb_frontend_taps, pfb_frontend_torch
from ..ops import cuda_halo
from .halo import from_last_shard, left_halo
from .mesh import axis_info, mesh_device

__all__ = ["make_fused_channelizer_frontend", "halo_frontend_torch"]


def _rows(x: torch.Tensor, M: int, K: int) -> int:
    L = int(x.shape[-1])
    if x.dim() != 1 or L % M:
        raise ValueError("per-shard length must be a multiple of M")
    U = L // M
    if U <= K:
        raise ValueError(f"per-shard rows ({U}) must exceed K ({K})")
    return U


def halo_frontend_torch(tail_rows: torch.Tensor, x: torch.Tensor,
                        h_il: torch.Tensor, num_channels: int,
                        taps_per_branch: int, mesh: DeviceMesh,
                        axis: str = "time") -> torch.Tensor:
    """Plain version of K9 with its exchange: this rank's z (U, M) from its
    slab x (L,), the carried tail rows (K, M) (used on the first shard) and
    h_il (K+1, 2M).  Collective over ``axis``."""
    M, K = num_channels, taps_per_branch
    U = _rows(x, M, K)
    halo = left_halo(x[(U - K) * M:].reshape(K, M), mesh, axis)
    _, i, _ = axis_info(mesh, axis)
    return pfb_frontend_torch(x, h_il, tail_rows if i == 0 else halo, M, K)


def make_fused_channelizer_frontend(mesh: DeviceMesh, num_channels: int,
                                    taps_per_branch: int,
                                    attenuation: float = 80.0,
                                    axis: str = "time", engine: str = "auto"):
    """Build ``apply(tail_rows, x) -> (z, new_tail_rows)`` on ``mesh``.

    ``x``: this rank's (L_loc,) complex64 slab of the stream along
    ``axis``, L_loc a multiple of M with more than K rows; ``tail_rows``
    (K, M) complex64, the carried tail, the same on every rank.  Returns
    this rank's branch products z (L_loc / M, M) complex64 and the new tail
    rows (the last rank's last K rows, on every rank).

    ``engine``: "auto" launches K9 on a CUDA mesh and runs
    :func:`halo_frontend_torch` on a CPU mesh; "cuda" always launches;
    "torch" always takes the plain version.  On a CUDA mesh the kernel's
    links are set up here (every rank of the mesh calls this once), and
    ``apply`` counts the blocks as the kernel's epochs.
    """
    M = int(num_channels)
    K = int(taps_per_branch)
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    device = mesh_device(mesh)
    h_il = torch.as_tensor(pfb_frontend_taps(
        channelizer_taps(M, K, attenuation), M), device=device)
    link = None
    if engine == "cuda" or (engine == "auto" and device.type == "cuda"):
        group, i, n = axis_info(mesh, axis)
        link = cuda_halo.group_link(group, i, n, M, K, device)
    epoch = 0

    def apply(tail_rows: torch.Tensor, x: torch.Tensor):
        nonlocal epoch
        U = _rows(x, M, K)
        if use_kernel(engine, x):
            # the epoch advances only with a launch: every rank's count
            # stays the same, or the neighbours would wait on each other
            z = cuda_halo.halo_frontend_cuda(x, tail_rows, h_il, M, K, link,
                                             epoch + 1)
            epoch += 1
        else:
            z = halo_frontend_torch(tail_rows, x, h_il, M, K, mesh, axis)
        new_tail = from_last_shard(x[(U - K) * M:].reshape(K, M), mesh, axis)
        return z, new_tail

    apply.link = link
    return apply
