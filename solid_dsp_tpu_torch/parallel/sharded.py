"""DSP chains over a ``(channel, time)`` mesh of ranks.

Port of ``solid_dsp_tpu/parallel/sharded.py``.  Where JAX maps one function
over the mesh with ``shard_map``, every rank here calls the same function on
its own block, and the halo exchanges and reductions are the collectives
of ``halo.py`` on the mesh's process groups:

* ``channel`` — independent streams; for the channelizer a tensor-parallel
  axis: the prototype's tap rows are split across it (partial products
  summed) and so are the output channels (each rank extracts its own);
* ``time`` — overlap-save blocks of one stream: a rank receives the
  ``ntaps - 1`` raw samples it needs from its left neighbour instead of a
  carried tail, and only the first time shard reads the carried tail.

Sequential recurrences follow the JAX package: the AGC runs in block mode
on the block energy averaged over ``time`` (one gain a block, the same on
every shard, as the single-card block-mode AGC on the whole block); the FM
discriminator needs a one-sample seam from the left neighbour; the NCO
phase is closed-form, so each shard starts at theta0 + offset * dtheta.

Blocks and outputs are per rank: ``x`` is this rank's block and the result
its block of the global output, in the layout the JAX function's
``PartitionSpec`` gives (``mesh.local_block`` cuts a global array so).
Carried state is replicated over ``time`` and, where it has a channel
dimension, split over ``channel`` (``interop.py`` moves it to and from the
JAX package's global arrays).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..device import fp32_exact
from ..models import qpsk as qpsk_mod
from ..models.channelizer import channelizer_taps, fused_channelizer_complex
from ..models import fm as fm_mod
from ..models.rx_chain import (RxChainConfig, _check_config, _ddc_bodies,
                                _fused, _rdtype)
from ..ops import agc as agc_ops
from ..ops import cuda_chan
from ..ops import ddc as ddc_ops
from ..ops import fir as fir_ops
from ..ops import nco as nco_ops
from ..ops.cuda_chan import CHAN_HALO
from ..ops.fir import conv1d_mxu, fir_init
from ..ops.nco import U32_MASK
from ..streaming.state import ChainState
from .halo import (axis_gather, axis_mean, axis_sum, from_last_shard,
                   left_halo, time_offset)
from .mesh import axis_info, mesh_device

__all__ = ["sharded_fir", "make_sharded_rx_chain", "make_sharded_channelizer"]


# ---------------------------------------------------------------------------
# time-sharded FIR
# ---------------------------------------------------------------------------

def sharded_fir(taps, mesh: DeviceMesh, scale=1.0):
    """Build ``apply(tail, x) -> (y, new_tail)`` (``sharded.py:51-78``).

    ``x``: this rank's (C_loc, L_loc) block (channels over ``channel``,
    time over ``time``); ``tail``: its (C_loc, ntaps - 1) carried history,
    the same on every time shard.  The halo comes from the left neighbour;
    only the first time shard reads the tail.
    """
    taps_np = np.asarray(taps)
    n = int(taps_np.shape[-1])

    def apply(tail: torch.Tensor, x: torch.Tensor):
        taps_t = torch.as_tensor(taps_np, device=x.device)
        _, t_idx, _ = axis_info(mesh, "time")
        if n > 1:
            halo = left_halo(x[..., -(n - 1):], mesh)
            eff_tail = tail if t_idx == 0 else halo
            new_tail = from_last_shard(x[..., -(n - 1):], mesh)
        else:
            eff_tail, new_tail = tail, x[..., :0]
        x_ext = torch.cat([eff_tail.to(x.dtype), x], dim=-1)
        return conv1d_mxu(x_ext, taps_t) * scale, new_tail

    return apply


# ---------------------------------------------------------------------------
# sharded rx chain (config 4 at scale)
# ---------------------------------------------------------------------------

def _agc_block_sharded(state: dict, x: torch.Tensor, alpha: float,
                       mesh: DeviceMesh):
    """Block-mode AGC whose energy is averaged over ``time``: equal shards
    make the mean of the local means the whole block's mean, so this is
    the single-card ``agc_apply_block_mode`` (both end in
    ``block_gain_update``) (``sharded.py:554-566``)."""
    gain = state["gain"]
    out = x * gain[..., None].to(x.dtype)
    ee = axis_mean(torch.mean((out * out.conj()).real, dim=-1), mesh, "time")
    _, _, n_time = axis_info(mesh, "time")
    return out, agc_ops.block_gain_update(state, ee, alpha,
                                          x.shape[-1] * n_time)


def make_sharded_rx_chain(cfg: RxChainConfig, mesh: DeviceMesh):
    """Multi-rank RxChain: NCO -> decimating FIR -> AGC -> demod
    (``sharded.py:85-551``).

    Returns ``(init, apply)``:

    * ``init(num_channels)`` -> this rank's ChainState with per-channel
      leaves for ``num_channels`` streams in all (``init()`` for the
      planar single stream);
    * ``apply(state, x) -> (out, state)``: ``x`` is this rank's
      (C_loc, L_loc) complex block, ``out`` its (C_loc, L_loc / M); with
      ``cfg.input_format == "planar"`` (one stream, ``channel`` axis of
      size 1) ``x`` is this rank's (2, L_loc) planes and ``out`` (L_loc /
      M,).

    The per-shard front end is the single-card fused DDC, built by the
    same factories in the same mode and real type (K1 on blocks of 64*M
    samples for FM where its predicate holds, K2/K3 through the DDC body
    otherwise, the plain body where the JAX package runs XLA); the sharded
    additions are the raw-input left halo in place of the carried tail on
    shards > 0, the one-sample discriminator seam shipped right, and the
    AGC block energy averaged over ``time``.  QPSK gathers the decimated
    stream over ``time``, recovers the carrier on the whole block and keeps
    its own slice.

    The unfused reference-parity staging (``fused_ddc="off"``, or "auto"
    with ``nco_mode="lut"``; complex (C, L) blocks only) mixes each shard
    from its own closed-form phase, runs ``fir_decim_apply`` with the
    MIXED stream's left halo in place of the carried tail on shards > 0,
    the block AGC on the energy averaged over ``time``, and the
    demodulator with FM's one-sample seam from the left neighbour.
    """
    if cfg.demod not in ("fm", "qpsk", "am", "none"):
        raise ValueError(f"unknown demod {cfg.demod!r}")
    _check_config(cfg)        # ValueError where the JAX package refuses
    planar = cfg.input_format == "planar"
    if planar and not _fused(cfg):
        raise ValueError("planar sharded input requires the fused DDC path")
    if planar and axis_info(mesh, "channel")[2] != 1:
        raise ValueError("planar mode is single-stream: channel axis must "
                         "have size 1")
    if not planar and cfg.input_format != "cf32":
        raise ValueError("multi-stream blocks are complex (C, L): "
                         "input_format 'cf32' or 'planar'")
    device = mesh_device(mesh)
    taps = cfg.design_taps()
    n1 = len(taps) - 1
    M = int(cfg.decimation)
    dtheta = int(nco_ops.constrain(cfg.carrier_freq))
    _, _, n_time = axis_info(mesh, "time")
    _, _, n_chan = axis_info(mesh, "channel")
    engine = cfg.ddc_engine
    kf = cfg.fm_kf

    def init(num_channels: int | None = None) -> ChainState:
        if planar or num_channels is None:
            bs = ()
        elif num_channels % n_chan:
            raise ValueError(f"{num_channels} streams do not divide by the "
                             f"channel axis ({n_chan})")
        else:
            bs = (num_channels // n_chan,)
        return ChainState(
            nco_theta=torch.zeros((), dtype=torch.int64, device=device),
            fir_tail=fir_init(len(taps), cfg.dtype, bs, device),
            fir_phase=torch.zeros((), dtype=torch.int32, device=device),
            agc=agc_ops.agc_init(_rdtype(cfg), device, bs),
            fm_prev=torch.ones(bs, dtype=cfg.dtype, device=device),
        )

    if not _fused(cfg):
        return init, _sharded_unfused(cfg, mesh, taps, dtheta)
    rdt = _rdtype(cfg)
    body, fm_body = _ddc_bodies(cfg, taps, dtheta, device)
    if cfg.demod != "fm":
        fm_body = None

    def front(tail2, theta0, x2, gain):
        """One stream's DDC front end, its FM seam left to the caller."""
        if fm_body is not None and x2.shape[-1] % (fm_body.P * M) == 0:
            one = torch.ones((), dtype=rdt, device=x2.device)
            return "kernel", ddc_ops.ddc_fm_fused(
                fm_body, tail2, theta0, x2, one, one * 0, gain, engine,
                with_seams=True)
        return "pieces", ddc_ops.ddc_apply_planar_pieces(
            body, tail2, theta0, x2, engine)

    def planes(xc):
        return torch.stack([xc.real, xc.imag]).to(rdt)

    def apply(state: ChainState, x: torch.Tensor):
        L_loc = int(x.shape[-1])
        if L_loc % M:
            raise ValueError(
                "per-shard block length must be a multiple of the decimation")
        T_loc = L_loc // M
        _, t_idx, _ = axis_info(mesh, "time")
        theta0 = (state.nco_theta
                  + ((time_offset(mesh, L_loc) * dtheta) & U32_MASK)
                  ) & U32_MASK
        theta_end = (state.nco_theta
                     + ((n_time * L_loc * dtheta) & U32_MASK)) & U32_MASK
        # one stream (planar) or C_loc streams, each as (2, L) planes
        if planar:
            x2s = [x.to(rdt).contiguous()]
            halo2 = left_halo(x2s[0][:, -n1:], mesh)
            tails = [planes(state.fir_tail) if t_idx == 0 else halo2]
            gains = state.agc["gain"][None]
            prev = state.fm_prev[None]
        else:
            halo = left_halo(x[..., -n1:], mesh)
            x2b = torch.stack([x.real, x.imag], dim=1).to(rdt)
            x2s = list(x2b)
            src = state.fir_tail if t_idx == 0 else halo
            tails = list(torch.stack([src.real, src.imag], dim=1)
                         .to(rdt))
            gains = state.agc["gain"]
            prev = state.fm_prev
        fronts = [front(tails[c], theta0, x2s[c], gains[c])
                  for c in range(len(x2s))]

        if cfg.demod in ("fm", "am"):
            # collapsed epilogue; FM chains through a one-sample rotated,
            # gained seam shipped right
            outs, ees, seams, firsts = [], [], [], []
            for c, (kind, p) in enumerate(fronts):
                if kind == "kernel":
                    out_c, npr, npi, ee_c, _, _, z0re, z0im, w0 = p
                    outs.append(out_c)
                    seams.append(torch.stack([npr, npi]))
                    firsts.append((z0re, z0im, w0))
                else:
                    z, _, _, w0, dw = p
                    ee_c = ddc_ops.ddc_energy_pieces(z)
                    firsts.append(None)
                    if cfg.demod == "fm":
                        seams.append(torch.stack(
                            ddc_ops.ddc_pieces_last_rotated(z, w0, dw,
                                                            gains[c])))
                        outs.append(None)
                    else:
                        outs.append(ddc_ops.ddc_am_epilogue(z[0], z[1],
                                                            gains[c]))
                ees.append(ee_c)
            if cfg.demod == "fm":
                seams = torch.stack(seams)                  # (C, 2)
                prev_in = left_halo(seams, mesh)
                if t_idx == 0:
                    pr = prev.real.to(rdt)
                    pi = prev.imag.to(rdt)
                else:
                    pr, pi = prev_in[:, 0], prev_in[:, 1]
                for c, (kind, p) in enumerate(fronts):
                    if kind == "kernel":
                        z0re, z0im, w0 = firsts[c]
                        outs[c][0] = ddc_ops.fm_first_sample(
                            z0re, z0im, w0, pr[c], pi[c], kf)
                    else:
                        z, _, _, w0, dw = p
                        outs[c], _, _ = ddc_ops.ddc_fm_epilogue(
                            z[0], z[1], w0, dw, pr[c], pi[c], kf, gains[c])
                new_fm_prev = from_last_shard(
                    torch.complex(seams[:, 0], seams[:, 1]).to(cfg.dtype),
                    mesh)
            else:           # AM: memoryless, fm_prev carried through
                new_fm_prev = prev
            out = torch.stack(outs)
            ee = axis_mean(torch.stack(ees), mesh, "time")
            gain = state.agc["gain"]
            if planar:
                ee = ee[0]
            agc_state = agc_ops.block_gain_update(
                state.agc, (gain * gain) * ee, cfg.agc_bandwidth,
                T_loc * n_time)
        else:
            # QPSK / none: the rotated output, then the sharded block AGC
            ys = []
            for _, (z, _, _, w0, dw) in fronts:
                rot = nco_ops.nco_complex_exponential(w0, dw, T_loc,
                                                      mode="fast")
                cr = rot.real.to(rdt)
                sr = rot.imag.to(rdt)
                ys.append(torch.complex(z[0] * cr + z[1] * sr,
                                        z[1] * cr - z[0] * sr))
            y = torch.stack(ys).to(cfg.dtype)
            st_agc = ({k: v[None] for k, v in state.agc.items()} if planar
                      else state.agc)
            y, agc_state = _agc_block_sharded(st_agc, y, cfg.agc_bandwidth,
                                              mesh)
            if planar:
                agc_state = {k: v[0] for k, v in agc_state.items()}
            if cfg.demod == "qpsk":
                out_full, _, _ = qpsk_mod.qpsk_carrier_block(
                    axis_gather(y, mesh, "time"))
                out = out_full[..., t_idx * T_loc:(t_idx + 1) * T_loc]
            else:
                out = y
            # QPSK and none do not read fm_prev: carried unchanged, as the
            # single-card chain carries it
            new_fm_prev = prev
        if planar:
            out = out[0]
            new_fm_prev = new_fm_prev[0]

        # the RAW input tail (pre-mix), as the single-card fused chain
        if planar:
            tail_pl = from_last_shard(x2s[0][:, -n1:], mesh)
            new_fir_tail = torch.complex(tail_pl[0], tail_pl[1]).to(cfg.dtype)
        else:
            new_fir_tail = from_last_shard(x[..., -n1:], mesh)
        return out, ChainState(
            nco_theta=theta_end,
            fir_tail=new_fir_tail,
            fir_phase=state.fir_phase,
            agc=agc_state,
            fm_prev=new_fm_prev.to(cfg.dtype),
        )

    return init, apply


def _sharded_unfused(cfg: RxChainConfig, mesh: DeviceMesh, taps, dtheta):
    """``local_unfused`` (``sharded.py:461-526``): the LUT-NCO parity
    staging on one time shard of (C_loc, L_loc) complex streams."""
    n1 = len(taps) - 1
    M = int(cfg.decimation)
    _, _, n_time = axis_info(mesh, "time")
    taps_c = taps.astype(torch.empty(0, dtype=cfg.dtype).numpy().dtype)
    lut = nco_ops.make_sine_lut(
        torch.empty(0, dtype=_rdtype(cfg)).numpy().dtype)

    def apply(state: ChainState, x: torch.Tensor):
        L_loc = int(x.shape[-1])
        if L_loc % M:
            raise ValueError(
                "per-shard block length must be a multiple of the decimation")
        _, t_idx, _ = axis_info(mesh, "time")
        # the phase is closed-form: each shard starts at its own offset
        theta0 = (state.nco_theta
                  + ((time_offset(mesh, L_loc) * dtheta) & U32_MASK)
                  ) & U32_MASK
        mixed, _ = nco_ops.mix_down_block(x, theta0, dtheta, lut,
                                          cfg.nco_mode)
        theta_end = (state.nco_theta
                     + ((n_time * L_loc * dtheta) & U32_MASK)) & U32_MASK
        # the decimating FIR with the neighbour's mixed halo in place of
        # the carried tail; L_loc % M == 0, so every shard sees one phase
        halo = left_halo(mixed[..., -n1:], mesh)
        eff_tail = state.fir_tail if t_idx == 0 else halo
        y, _, fir_phase = fir_ops.fir_decim_apply(
            taps_c, eff_tail, state.fir_phase, mixed, 1.0, M,
            precision=cfg.fir_precision)
        new_fir_tail = from_last_shard(mixed[..., -n1:], mesh)
        y, agc_state = _agc_block_sharded(state.agc, y, cfg.agc_bandwidth,
                                          mesh)
        new_fm_prev = state.fm_prev
        if cfg.demod == "fm":
            prev_halo = left_halo(y[..., -1], mesh)
            fm_prev_l = state.fm_prev if t_idx == 0 else prev_halo
            out, _ = fm_mod.fm_demodulate(fm_prev_l, y, cfg.fm_kf)
            new_fm_prev = from_last_shard(y[..., -1], mesh)
        elif cfg.demod == "qpsk":
            T_loc = int(y.shape[-1])
            out_full, _, _ = qpsk_mod.qpsk_carrier_block(
                axis_gather(y, mesh, "time"))
            out = out_full[..., t_idx * T_loc:(t_idx + 1) * T_loc]
        elif cfg.demod == "am":
            out = torch.abs(y)
        else:
            out = y
        return out, ChainState(
            nco_theta=theta_end, fir_tail=new_fir_tail, fir_phase=fir_phase,
            agc=agc_state, fm_prev=new_fm_prev.to(cfg.dtype))

    return apply


# ---------------------------------------------------------------------------
# sharded channelizer (config 5)
# ---------------------------------------------------------------------------

def make_sharded_channelizer(num_channels: int, taps_per_branch: int = 8,
                             mesh: DeviceMesh | None = None,
                             attenuation: float = 80.0,
                             dtype=torch.complex64, frontend: str = "xla",
                             precision: str = "x3"):
    """The M-channel polyphase channelizer over a 2D mesh
    (``sharded.py:573-744``).

    ``frontend="xla"``: ``time`` splits the stream into overlap-save blocks,
    each rank receiving a K*M - 1 raw-sample halo from its left neighbour;
    ``channel`` splits the K tap rows of the polyphase matrix (partial
    branch products summed over the axis) and then the output channels
    (each rank extracts its M / n_channel with a partial inverse-DFT
    product), so no rank holds all M channels.

    ``frontend="fused"``: the fused channelizer K4 on complex samples
    (``models/channelizer.py::fused_channelizer_complex``, ``precision``
    "x3" or "fast") on each time shard, with the CHAN_HALO = 8 frame rows it
    needs from the left neighbour in place of the carried tail rows.  It
    computes all M channels locally: the ``channel`` axis must have size 1.

    Returns ``(init, apply)`` with ``apply(tail, x) -> (Y, new_tail)``:
    ``x`` is this rank's (L_loc,) slab (the same on every channel rank),
    ``Y`` its (L_loc / M, M_loc) block of the channel outputs; the tail
    (K*M - 1,) ``dtype`` for "xla", (2, 8, M) float32 rows for "fused",
    is the same on every rank.  "fused" runs K4 on a CUDA mesh and its
    plain version on a CPU mesh.
    """
    M = int(num_channels)
    K = int(taps_per_branch)
    if mesh is None:
        raise ValueError("make_sharded_channelizer requires a mesh")
    if frontend not in ("xla", "fused"):
        raise ValueError(f"unknown frontend {frontend!r}")
    device = mesh_device(mesh)
    if frontend == "fused":
        return _make_sharded_channelizer_fused(M, K, mesh, attenuation, dtype,
                                               precision, device)
    _, c_idx, n_cs = axis_info(mesh, "channel")
    if K % n_cs:
        raise ValueError(f"taps_per_branch ({K}) must divide by the channel "
                         f"axis size ({n_cs})")
    if M % n_cs:
        raise ValueError(f"num_channels ({M}) must divide by the channel "
                         f"axis size ({n_cs})")
    K_loc, M_loc = K // n_cs, M // n_cs
    # commutator form (models/channelizer.py): with P[u, q] = x_ext[u M + q]
    # and G = reverse(taps[:K M]).reshape(K, M), z2[t, q] =
    # sum_k G[k, q] P[t + k, q]; this rank sums its K_loc rows of G
    taps = channelizer_taps(M, K, attenuation)
    G = taps[: K * M][::-1].reshape(K, M)[c_idx * K_loc:(c_idx + 1) * K_loc]
    G_loc = torch.as_tensor(np.ascontiguousarray(G), device=device).to(dtype)
    # its channels of the inverse DFT in z2's q indexing:
    # Y[t, m] = sum_q z2[t, q] e^{+2 pi i (M-1-q) m / M}
    q = np.arange(M)[:, None]
    m = np.arange(c_idx * M_loc, (c_idx + 1) * M_loc)[None, :]
    W_loc = torch.as_tensor(np.exp(2j * np.pi * (M - 1 - q) * m / M),
                            device=device).to(dtype)
    halo_len = K * M - 1

    def init():
        return torch.zeros(halo_len, dtype=dtype, device=device)

    def apply(tail: torch.Tensor, x: torch.Tensor):
        L_loc = int(x.shape[-1])
        if L_loc % M:
            raise ValueError("per-shard length must be a multiple of M")
        T_loc = L_loc // M
        _, t_idx, _ = axis_info(mesh, "time")
        halo = left_halo(x[-halo_len:], mesh)
        x_ext = torch.cat([(tail if t_idx == 0 else halo).to(x.dtype), x])
        P = x_ext[: (T_loc + K - 1) * M].reshape(T_loc + K - 1, M)
        r0 = c_idx * K_loc
        z_part = G_loc[0] * P[r0: r0 + T_loc]
        for j in range(1, K_loc):
            z_part = z_part + G_loc[j] * P[r0 + j: r0 + j + T_loc]
        z2 = axis_sum(z_part, mesh, "channel")
        with fp32_exact():
            Y = z2 @ W_loc
        return Y, from_last_shard(x[-halo_len:], mesh)

    return init, apply


def _make_sharded_channelizer_fused(M: int, K: int, mesh: DeviceMesh,
                                    attenuation: float, dtype,
                                    precision: str, device: torch.device):
    """Time-sharded fused channelizer (``sharded.py:686-744``): each rank
    takes its slab as frame rows (U_loc, M) complex64, receives the
    previous CHAN_HALO rows from its left neighbour as (2, 8, M) planes
    (the fused kernel's tail-rows contract) and runs K4 on its frames.
    Same kernel, same halo values: bit-equal to the single-card fused
    channelizer at world size 1."""
    if axis_info(mesh, "channel")[2] != 1:
        raise ValueError("fused frontend computes the full output DFT "
                         "locally: channel mesh axis must have size 1 "
                         "(use frontend='xla' to split channels)")
    if K > CHAN_HALO:
        raise ValueError(f"fused frontend supports taps_per_branch <= "
                         f"{CHAN_HALO}")
    body = cuda_chan.make_chan_body(channelizer_taps(M, K, attenuation), M,
                                    precision, device)

    def init():
        return torch.zeros((2, CHAN_HALO, M), dtype=torch.float32,
                           device=device)

    def apply(tail: torch.Tensor, x: torch.Tensor):
        L_loc = int(x.shape[-1])
        if L_loc % (CHAN_HALO * M):
            raise ValueError(f"per-shard length must be a multiple of "
                             f"{CHAN_HALO * M}")
        _, t_idx, _ = axis_info(mesh, "time")
        xc = x.to(torch.complex64)
        last = xc[L_loc - CHAN_HALO * M:].reshape(CHAN_HALO, M)
        rows = torch.stack([last.real, last.imag]).contiguous()
        halo = left_halo(rows, mesh)
        Y, _ = fused_channelizer_complex(body, tail if t_idx == 0 else halo,
                                         xc)
        return Y.to(dtype), from_last_shard(rows, mesh)

    return init, apply
