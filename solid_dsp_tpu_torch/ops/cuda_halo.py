"""K9 on Hopper: the fused halo-exchange front end's wrapper and its links.

Port of the kernel of ``solid_dsp_tpu/parallel/pallas_halo.py``
(``make_fused_channelizer_frontend``, kernel body ``_fused_kernel``), built
from ``csrc/halo_frontend.cu``.  One launch a block and a shard: it ships the
shard's last K frame rows to its right neighbour's halo slot, computes the
interior branch-product rows meanwhile, and finishes rows [0, K) once its
own halo has arrived (the carried tail rows on shard 0).  Its arithmetic is
K5's (``ops/cuda_chan.py``), so its plain version on one shard is
``pfb_frontend_torch`` of x with the received halo as the tail rows; the
exchange's plain version, ``left_halo`` over the process group, is
``parallel/pallas_halo.py::halo_frontend_torch``.

A shard's :class:`HaloLink` holds its own region (a header of flag and ack
words and two halo slots, ``cudaMalloc``'d once by the C library) and the
right neighbour's:

* :func:`local_ring` builds the links of n shards that share one card:
  each neighbour's region is a plain pointer, and the shards launch on
  different streams;
* :func:`group_link` builds this rank's link in a process group: the
  regions' CUDA IPC handles go round the group once, each rank opens its
  right neighbour's, and one barrier ends the setup.  IPC handles open only
  on the node that made them, so :func:`check_one_host` first compares the
  ranks' hostnames and raises if the group crosses hosts (a transport
  between hosts is not written yet).

Each launch passes the block's epoch (1, 2, ... a stream); the kernel
publishes and waits on it, so no host synchronisation is needed between
blocks.
"""

from __future__ import annotations

import ctypes
import socket
import weakref
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from .cuda_build import check_launch, launcher, stream_of

__all__ = ["HEADER_BYTES", "region_bytes", "HaloRegion", "HaloLink",
           "local_ring", "check_one_host", "group_link",
           "halo_frontend_cuda"]

HEADER_BYTES = 256      # kHeaderBytes in csrc/halo_frontend.cu
MAX_TAPS = 8            # kMaxTaps
_SRC = "halo_frontend.cu"
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PP = ctypes.POINTER(ctypes.c_void_p)
_LAUNCH_ARGS = (_P,) * 4 + (_LL, _I, _I, _P, _P, ctypes.c_ulonglong, _I, _I,
                _P)


def region_bytes(num_channels: int, taps_per_branch: int) -> int:
    """Bytes of one shard's region: the header and two K x 2M f32 slots."""
    return HEADER_BYTES + 2 * taps_per_branch * 2 * num_channels * 4


def _call(name: str, argtypes: tuple, *args):
    check_launch(launcher(_SRC, name, argtypes)(*args), name)


def _release(name: str, ptr: int, index: int):
    """Free or unmap a region at the owner's close or collection; an error
    then (the context already torn down at exit) has nobody to report to."""
    launcher(_SRC, name, (_P, _I))(ptr, index)


class HaloRegion:
    """One shard's region on its card, zeroed, freed by :meth:`close` or
    when the object is collected."""

    def __init__(self, num_channels: int, taps_per_branch: int,
                 device: torch.device):
        if device.type != "cuda" or device.index is None:
            raise ValueError(f"a halo region lives on one card, got {device}")
        self.device = device
        out = ctypes.c_void_p()
        _call("halo_region_alloc", (_LL, _I, _PP),
              region_bytes(num_channels, taps_per_branch), device.index,
              ctypes.byref(out))
        self.ptr = int(out.value)
        self._close = weakref.finalize(self, _release, "halo_region_free",
                                       self.ptr, device.index)

    def ipc_handle(self) -> bytes:
        """The region's CUDA IPC handle, for another process to open."""
        buf = ctypes.create_string_buffer(64)
        _call("halo_ipc_handle", (_P, _I, _P), self.ptr, self.device.index,
              ctypes.addressof(buf))
        return buf.raw

    def close(self):
        self._close()


class _OpenedRegion:
    """Another process's region, mapped from its IPC handle until closed
    or collected."""

    def __init__(self, handle: bytes, device: torch.device):
        buf = ctypes.create_string_buffer(handle, 64)
        out = ctypes.c_void_p()
        _call("halo_ipc_open", (_P, _I, _PP), ctypes.addressof(buf),
              device.index, ctypes.byref(out))
        self.ptr = int(out.value)
        self._close = weakref.finalize(self, _release, "halo_ipc_close",
                                       self.ptr, device.index)

    def close(self):
        self._close()


@dataclass(eq=False)
class HaloLink:
    """Where one shard's halo lands (``mine``) and where its own last rows
    go (``right``, the neighbour's region pointer, None on the last
    shard); ``first`` marks shard 0, which reads the carried tail."""

    mine: HaloRegion
    right: int | None
    first: bool
    num_channels: int
    taps_per_branch: int
    # what keeps ``right`` valid: the neighbour's region on this card, or
    # this process's IPC mapping of it
    right_owner: object = field(default=None, repr=False)

    def close(self):
        """Free this shard's region and unmap the neighbour's (a region
        shared on one card is freed by its own shard's link)."""
        if isinstance(self.right_owner, _OpenedRegion):
            self.right_owner.close()
        self.mine.close()


def local_ring(n: int, num_channels: int, taps_per_branch: int,
               device) -> list:
    """Links of n time shards on one card, shard i sending to shard i + 1
    through plain pointers.  Launch each shard on its own stream."""
    device = torch.empty(0, device=device).device
    regions = [HaloRegion(num_channels, taps_per_branch, device)
               for _ in range(n)]
    return [HaloLink(regions[i], regions[i + 1].ptr if i + 1 < n else None,
                     i == 0, num_channels, taps_per_branch,
                     regions[i + 1] if i + 1 < n else None)
            for i in range(n)]


def check_one_host(group, index: int, n: int):
    """Gather the hostnames of the n ranks of ``group`` (collective) and
    raise ValueError if two neighbours along it run on different hosts:
    K9's CUDA IPC handles open only on the node that made them.  Every rank
    raises (each sees all the names), so none waits on the others."""
    hosts = [None] * n
    dist.all_gather_object(hosts, socket.gethostname(), group=group)
    pairs = [(i, i + 1) for i in range(n - 1) if hosts[i] != hosts[i + 1]]
    if pairs:
        mine = [p for p in pairs if p[0] == index]
        i, j = (mine or pairs)[0]
        raise ValueError(
            f"K9's in-kernel halo exchange needs the whole time axis on one "
            f"node: rank {i} of the group runs on host {hosts[i]!r} and its "
            f"right neighbour, rank {j}, on {hosts[j]!r} (CUDA IPC handles "
            f"do not cross hosts)")


def group_link(group, index: int, n: int, num_channels: int,
               taps_per_branch: int, device: torch.device) -> HaloLink:
    """This rank's link along a process group of n ranks (this one at
    ``index``), each on its own card: every rank calls it once, at setup.
    Raises ValueError (:func:`check_one_host`) before any region is
    allocated if the group crosses hosts."""
    check_one_host(group, index, n)
    region = HaloRegion(num_channels, taps_per_branch, device)
    handles = [None] * n
    dist.all_gather_object(handles, region.ipc_handle(), group=group)
    opened = (_OpenedRegion(handles[index + 1], device) if index + 1 < n
              else None)
    dist.barrier(group=group)
    return HaloLink(region, opened.ptr if opened else None, index == 0,
                    num_channels, taps_per_branch, opened)


def _check(x, tail_rows, h_il, M: int, K: int) -> int:
    L = int(x.shape[-1])
    if x.dim() != 1 or L % M:
        raise ValueError("per-shard length must be a multiple of M")
    U = L // M
    if U <= K:
        raise ValueError(f"per-shard rows ({U}) must exceed K ({K})")
    if tuple(tail_rows.shape) != (K, M):
        raise ValueError(f"tail_rows must be ({K}, {M}), got "
                         f"{tuple(tail_rows.shape)}")
    if tuple(h_il.shape) != (K + 1, 2 * M):
        raise ValueError(f"h_il must be ({K + 1}, {2 * M}), got "
                         f"{tuple(h_il.shape)}")
    return U


def halo_frontend_cuda(x: torch.Tensor, tail_rows: torch.Tensor,
                       h_il: torch.Tensor, num_channels: int,
                       taps_per_branch: int, link: HaloLink,
                       epoch: int) -> torch.Tensor:
    """Launch K9 for one shard's block: z (U, M) complex64 from its slab x
    (L,) complex64, the carried tail rows (K, M) (read on shard 0 only)
    and h_il (K+1, 2M) f32, exchanging the halo through ``link``.
    ``epoch``: the block's number on this link, from 1, one more each
    launch.  Takes contiguous tensors on the link's card and raises on
    anything else.  Adds one to ``halo_frontend_cuda.launches``."""
    M, K = num_channels, taps_per_branch
    U = _check(x, tail_rows, h_il, M, K)
    if K > MAX_TAPS:
        raise ValueError(f"K9 takes taps_per_branch <= {MAX_TAPS}")
    if (M, K) != (link.num_channels, link.taps_per_branch):
        raise ValueError(f"link built for (M, K) = ({link.num_channels}, "
                         f"{link.taps_per_branch}), block has ({M}, {K})")
    if not (x.is_cuda and x.device == link.mine.device
            and tail_rows.device == x.device and h_il.device == x.device):
        raise ValueError("halo_frontend_cuda needs x, tail_rows and h_il on "
                         "the link's card; CPU tensors take "
                         "halo_frontend_torch")
    if (x.dtype != torch.complex64 or tail_rows.dtype != torch.complex64
            or h_il.dtype != torch.float32):
        raise TypeError("halo_frontend_cuda takes complex64 x and tail rows "
                        "and float32 taps")
    if not (x.is_contiguous() and tail_rows.is_contiguous()
            and h_il.is_contiguous()):
        raise ValueError("halo_frontend_cuda needs contiguous tensors")
    if epoch < 1:
        raise ValueError("epochs count blocks from 1")
    z = torch.empty((U, M), dtype=torch.complex64, device=x.device)
    fn = launcher(_SRC, "halo_frontend_launch", _LAUNCH_ARGS)
    check_launch(fn(x.data_ptr(), tail_rows.data_ptr(), h_il.data_ptr(),
                    z.data_ptr(), U, M, K, link.mine.ptr, link.right,
                    int(epoch), int(link.first), x.device.index,
                    stream_of(x)), "halo_frontend_cuda")
    halo_frontend_cuda.launches += 1
    return z


halo_frontend_cuda.launches = 0
