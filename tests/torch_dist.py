"""Run the port's sharded functions on gloo ranks, for the CPU tests.

Imports no JAX: the ranks are fresh processes (``spawn``) that import this
module and the port only.  :func:`run_ranks` starts ``world`` ranks that
meet through a ``FileStore`` under the test's temporary directory (no port
to collide with other pytest-xdist workers), runs a list of cases
(functions of this module named in ``CASES``), each on a ``(channel,
time)`` mesh of the ranks, and returns each rank's results as numpy.  A rank that fails
fails the test with its traceback; ranks still running after the time
limit are killed and the test fails, so a lost rank never hangs the run.

One spawn serves many cases and mesh shapes: the tests call it from a
module-scoped fixture and keep each case its own test.
"""

from __future__ import annotations

import pickle
import socket
import time
from unittest import mock
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from solid_dsp_tpu_torch import interop
from solid_dsp_tpu_torch.models.channelizer import channelizer_taps
from solid_dsp_tpu_torch.models.rx_chain import RxChainConfig
from solid_dsp_tpu_torch.ops import cuda_halo
from solid_dsp_tpu_torch.ops.cuda_chan import pfb_frontend_taps
from solid_dsp_tpu_torch.parallel import (from_last_shard, init_distributed,
                                          left_halo, local_block, make_mesh,
                                          make_sharded_channelizer,
                                          make_sharded_rx_chain, right_halo,
                                          sharded_fir, time_offset)
from solid_dsp_tpu_torch.parallel.mesh import axis_info
from solid_dsp_tpu_torch.parallel.pallas_halo import (
    make_fused_channelizer_frontend)

TIMEOUT_S = 90.0


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    return tree


def _rank_main(rank: int, world: int, store: str, out_dir: str,
               cases: list):
    torch.set_num_threads(1)
    init_distributed("cpu", store_path=store, rank=rank, world_size=world)
    try:
        meshes, results = {}, {}
        for key, shape, name, kwargs in cases:    # the same order on all
            if shape not in meshes:
                meshes[shape] = make_mesh(*shape, device="cpu")
            results[key] = _numpy(CASES[name](meshes[shape], **kwargs))
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def run_ranks(tmp_path: Path, world: int, cases: list,
              timeout: float = TIMEOUT_S) -> list:
    """Run ``cases`` [(key, (channel, time), case name, kwargs)] on
    ``world`` gloo ranks, each case on a mesh of channel * time = world
    ranks; returns [rank r's {key: result}] in rank order."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    ctx = tmp.start_processes(
        _rank_main, args=(world, str(tmp_path / "store"), str(tmp_path),
                          cases),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    out = []
    for r in range(world):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))     # written by this test's ranks
    return out


def assemble(parts: list, mesh_shape: tuple, spec: tuple) -> np.ndarray:
    """The global array from the ranks' blocks: ``spec`` names the mesh
    axis each leading dim is split over, or None (``local_block``'s
    meaning); replicated axes take coordinate 0's block."""
    sizes = {"channel": mesh_shape[0], "time": mesh_shape[1]}

    def build(fixed: dict, d: int):
        if d == len(spec):
            return parts[fixed.get("channel", 0) * sizes["time"]
                         + fixed.get("time", 0)]
        if spec[d] is None:
            return build(fixed, d + 1)
        return np.concatenate([build({**fixed, spec[d]: i}, d + 1)
                               for i in range(sizes[spec[d]])], axis=d)

    return build({}, 0)


def _error(fn) -> str:
    """The message of the ValueError or NotImplementedError fn raises."""
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


# ------------------------------------------------------------------ cases

def halo_primitives(mesh, x):
    """left_halo, right_halo, from_last_shard and time_offset of this
    rank's block of the global x (split over time)."""
    xl = torch.from_numpy(local_block(x, mesh, ("time",)))
    return {"left": left_halo(xl, mesh), "right": right_halo(xl, mesh),
            "last": from_last_shard(xl, mesh),
            "offset": time_offset(mesh, xl.shape[-1])}


def k9_frontend(mesh, M, K, blocks, tail):
    """The fused-halo front end (its plain version on the CPU) over the
    global blocks with the tail carried: each block's z and new tail."""
    apply = make_fused_channelizer_frontend(mesh, M, K)
    t = torch.from_numpy(tail)
    zs, tails = [], []
    for x in blocks:
        z, t = apply(t, torch.from_numpy(local_block(x, mesh, ("time",))))
        zs.append(z)
        tails.append(t)
    return {"z": zs, "tail": tails}


def k9_errors(mesh, M, K):
    apply = make_fused_channelizer_frontend(mesh, M, K)
    tail = torch.zeros((K, M), dtype=torch.complex64)
    return {"ragged": _error(lambda: apply(
                tail, torch.zeros(M * (K + 2) + 1, dtype=torch.complex64))),
            "short": _error(lambda: apply(
                tail, torch.zeros(M * K, dtype=torch.complex64)))}


def k9_hosts(mesh, M, K, fake):
    """group_link's host check on the time axis, ``fake`` giving every
    rank its own hostname: the error it raises (or "no error") and whether
    it got as far as allocating a region (a stand-in that records the
    call; no region exists on a CPU rank)."""
    group, i, n = axis_info(mesh, "time")
    allocated = []

    def region(*args):
        allocated.append(args)
        raise NotImplementedError("region allocated")

    name = f"host-{dist.get_rank()}" if fake else socket.gethostname()
    with mock.patch.object(socket, "gethostname", return_value=name), \
            mock.patch.object(cuda_halo, "HaloRegion", region):
        check = _error(lambda: cuda_halo.check_one_host(group, i, n))
        link = _error(lambda: cuda_halo.group_link(
            group, i, n, M, K, torch.device("cpu")))
    return {"check": check, "link": link, "allocated": len(allocated)}


def channelizer(mesh, M, K, frontend, blocks, dtype, precision="x3"):
    """make_sharded_channelizer over the global blocks, tail carried:
    this rank's Y blocks and the tails."""
    init, apply = make_sharded_channelizer(
        M, K, mesh, dtype=getattr(torch, dtype), frontend=frontend,
        precision=precision)
    tail = init()
    ys, tails = [], []
    for x in blocks:
        y, tail = apply(tail, torch.from_numpy(local_block(x, mesh,
                                                           ("time",))))
        ys.append(y)
        tails.append(tail)
    return {"Y": ys, "tail": tails}


def rx_chain(mesh, cfg, blocks, num_channels=None):
    """make_sharded_rx_chain over the global blocks with the state carried:
    this rank's outputs and, after each block, the global state."""
    init, apply = make_sharded_rx_chain(RxChainConfig(**cfg), mesh)
    st = init(num_channels)
    spec = (None, "time") if cfg.get("input_format") == "planar" else (
        "channel", "time")
    outs, states = [], []
    for x in blocks:
        out, st = apply(st, torch.from_numpy(local_block(x, mesh, spec)))
        outs.append(out)
        states.append(interop.sharded_state_to_numpy(st, mesh))
    return {"out": outs, "state": states}


def fir(mesh, taps, blocks):
    """sharded_fir over the global (C, L) blocks with the tail carried."""
    apply = sharded_fir(taps, mesh)
    C = blocks[0].shape[0]
    tail = torch.from_numpy(local_block(
        np.zeros((C, len(taps) - 1), blocks[0].dtype), mesh, ("channel",)))
    ys, tails = [], []
    for x in blocks:
        y, tail = apply(tail, torch.from_numpy(local_block(
            x, mesh, ("channel", "time"))))
        ys.append(y)
        tails.append(tail)
    return {"y": ys, "tail": tails}


def state_round_trip(mesh, tree, tails):
    """A JAX sharded chain's global state to this rank's ChainState and
    back; the replicated tails to this rank's tensors and back."""
    st = interop.sharded_state_from_numpy(tree, mesh)
    return {"local_fir_tail": st.fir_tail,
            "back": interop.sharded_state_to_numpy(st, mesh),
            "tails": interop.tensors_to_numpy(
                interop.tensors_from_numpy(tails, "cpu"))}


def k9_ipc(mesh, M, K, blocks, tail):
    """K9 on card 0 in every rank, the halos through CUDA IPC mappings of
    the neighbours' regions, the handles exchanged over the gloo group:
    this rank's z of each global block."""
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    group, i, n = axis_info(mesh, "time")
    link = cuda_halo.group_link(group, i, n, M, K, dev)
    h_il = torch.from_numpy(pfb_frontend_taps(channelizer_taps(M, K), M)
                            ).to(dev)
    t = torch.from_numpy(tail).to(dev)
    zs = []
    for e, x in enumerate(blocks):
        zs.append(cuda_halo.halo_frontend_cuda(
            torch.from_numpy(local_block(x, mesh, ("time",))).to(dev), t,
            h_il, M, K, link, e + 1))
        t = torch.from_numpy(x[-K * M:].reshape(K, M)).to(dev)
    torch.cuda.synchronize()
    dist.barrier()              # no rank unmaps a region still written
    link.close()
    return zs


CASES = {f.__name__: f for f in (halo_primitives, k9_frontend, k9_errors,
                                 k9_hosts, channelizer, rx_chain,
                                 fir, state_round_trip, k9_ipc)}
