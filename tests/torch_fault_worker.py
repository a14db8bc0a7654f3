"""Crash-injection workers for the port's fault tests and its card run.

Imports torch and the port only (no JAX), so the same worker runs in the
CPU tests and on a card without JAX.

    python torch_fault_worker.py chain <out_dir> <crash_flag> <device> \
        <block_len> [<n_blocks>]

runs the config-4 receive chain (planar FM, fused, x3, block AGC) over
``n_blocks`` seeded blocks (8 unless given), saving each block's audio to
``out_dir/block_<i>.npy`` and the state through ``CheckpointManager``
after each block; if ``crash_flag`` exists it deletes it and hard-exits
before block 4.  A relaunch resumes from the newest checkpoint.

    python torch_fault_worker.py dist <rank> <world> <store> <out_dir> \
        <crash_flag>

is one rank of a gloo group (a ``FileStore`` at ``store``): each rank runs
its own channel of the chain over 4 chunks, writing its state through
``save_distributed`` after each and waiting at a barrier until every
rank has saved it; rank 1 hard-exits before chunk 2 if
``crash_flag`` exists.  A relaunched gang resumes from
``latest_distributed_step`` (read by every rank before any saves) through
``load_distributed`` and checks every
chunk it computes bit-equal to an uninterrupted run replayed in the
worker, then writes ``out_dir/PASS_rank<r>``.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from solid_dsp_tpu_torch.models.rx_chain import (  # noqa: E402
    RxChainConfig, make_rx_chain)
from solid_dsp_tpu_torch.parallel import fault  # noqa: E402

CONFIG4 = RxChainConfig(carrier_freq=0.2, decimation=4, fir_taps=64,
                        agc_mode="block", demod="fm", nco_mode="exact",
                        input_format="planar", fused_ddc="on",
                        fir_precision="x3")
CRASH_AT = 4
DIST_CHUNKS, DIST_CRASH_AT, DIST_BLOCK = 4, 2, 4096


def make_blocks(seed: int, n_blocks: int, L: int) -> np.ndarray:
    """(n_blocks, 2, L) planar f32: a tone at the carrier in noise, the
    phase continuing across blocks."""
    rng = np.random.default_rng(seed)
    k = np.arange(n_blocks * L)
    x = (0.5 * np.exp(1j * (0.2 * k + 0.3))
         + 0.1 * (rng.standard_normal(k.size)
                  + 1j * rng.standard_normal(k.size)))
    planar = np.stack([x.real, x.imag]).astype(np.float32)
    return planar.reshape(2, n_blocks, L).transpose(1, 0, 2).copy()


def chain_main(out_dir: str, crash_flag: str, device: str, L: int,
               n_blocks: int) -> int:
    init, apply = make_rx_chain(CONFIG4, device)
    cm = fault.CheckpointManager(os.path.join(out_dir, "ckpts"))
    state, start = cm.latest(like=init())
    if state is None:
        state = init()
    print(f"resumed at block {start}" if start else "cold start",
          flush=True)
    blocks = make_blocks(123, n_blocks, L)
    for i in range(start, n_blocks):
        if i == CRASH_AT and os.path.exists(crash_flag):
            os.remove(crash_flag)
            os._exit(17)   # a hard crash: no cleanup, no checkpoint
        out, state = apply(state, torch.from_numpy(blocks[i]).to(device))
        np.save(os.path.join(out_dir, f"block_{i}.npy"), out.cpu().numpy())
        cm.save(state, i)
    return 0


def dist_main(rank: int, world: int, store: str, out_dir: str,
              crash_flag: str) -> int:
    import torch.distributed as dist

    from solid_dsp_tpu_torch.parallel import init_distributed

    torch.set_num_threads(1)
    init_distributed("cpu", store_path=store, rank=rank, world_size=world)
    try:
        init, apply = make_rx_chain(CONFIG4, "cpu")
        x = make_blocks(77 + rank, DIST_CHUNKS, DIST_BLOCK)
        ckdir = os.path.join(out_dir, "dckpts")
        step = fault.latest_distributed_step(ckdir)
        dist.barrier()    # every rank has read it before any rank saves
        if step >= 0:
            state = fault.load_distributed(ckdir, step, like=init())
            start = step + 1
        else:
            state, start = init(), 0
        print(f"rank{rank}: start at chunk {start}", flush=True)
        ref_state, ref = init(), []
        for i in range(DIST_CHUNKS):       # the uninterrupted run
            out, ref_state = apply(ref_state, torch.from_numpy(x[i]))
            ref.append(out)
        for i in range(start, DIST_CHUNKS):
            if rank == 1 and i == DIST_CRASH_AT and os.path.exists(
                    crash_flag):
                os.remove(crash_flag)
                os._exit(21)
            out, state = apply(state, torch.from_numpy(x[i]))
            if not torch.equal(out, ref[i]):
                raise AssertionError(f"rank{rank}: chunk {i} differs")
            fault.save_distributed(state, ckdir, i)
            # a step ends when every rank has saved it (as a step with a
            # collective does): no rank runs ahead of another, so the
            # crash before chunk 2 always finds step 1 saved by both
            dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"PASS_rank{rank}"), "w") as f:
        f.write("ok")
    return 0


def main(argv) -> int:
    if argv[0] == "chain":
        out_dir, crash_flag, device, L = argv[1], argv[2], argv[3], argv[4]
        n_blocks = int(argv[5]) if len(argv) > 5 else 8
        return chain_main(out_dir, crash_flag, device, int(L), n_blocks)
    if argv[0] == "dist":
        return dist_main(int(argv[1]), int(argv[2]), argv[3], argv[4],
                         argv[5])
    raise SystemExit(f"unknown mode {argv[0]!r}")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
