"""Multi-rank execution: meshes, halo exchange, sharded chains.

Port of ``solid_dsp_tpu/parallel/`` on ``torch.distributed``: one process a
device, NCCL between cards, gloo between CPU processes (the tests' stand-in
for the JAX package's fake-device CPU mesh).

* ``mesh``        — process groups and ``(channel, time)`` device meshes;
* ``halo``        — neighbour exchange of filter tails and the collectives
  the chains need (``ppermute``, ``psum``, ``pmean``, ``all_gather``);
* ``pallas_halo`` — the time-sharded channelizer front end with its halo
  exchange inside one kernel (K9);
* ``sharded``     — the sharded FIR, receive chain and channelizer, where
  the carried state doubles as the inter-rank halo payload.

The checkpoint manager and gang supervision of the JAX package's
``parallel/fault.py`` are not ported yet (ROADMAP queue 1 item 14).
"""

from .mesh import init_distributed, local_block, make_mesh, mesh_axes  # noqa: F401
from . import pallas_halo  # noqa: F401
from .halo import (  # noqa: F401
    left_halo,
    right_halo,
    from_last_shard,
    time_offset,
)
from .sharded import (  # noqa: F401
    sharded_fir,
    make_sharded_rx_chain,
    make_sharded_channelizer,
)
