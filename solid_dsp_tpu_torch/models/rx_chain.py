"""RxChain — the composed receive chain.

Port of ``solid_dsp_tpu/models/rx_chain.py``: NCO downconversion, decimating
FIR, AGC and demodulation (FM, QPSK, AM or none) as one block transform
``apply(state, x) -> (out, state)``.  Every branch of the JAX chain:

* the fused route (``fused_ddc="on"``, or "auto" with ``nco_mode="exact"``):
  the NCO mix folded into complex bandpass taps, the DDC body kernel (K2,
  K3's route for an unaligned block) and, with block AGC and FM or AM, the
  collapsed epilogue (FM blocks that are multiples of 64*M run the fused
  DDC + FM kernel, K1); otherwise the body, the decimated-rate rotation,
  the AGC and the demodulator.  The kernels run in the TPU kernels' mode
  of ``fir_precision``: "x3" for "highest" and "x3", the single bf16 pass
  ("fast") for "default".  Where the JAX package keeps to XLA (complex128,
  whose body stays off its kernels; tap counts no kernel's predicate
  takes, such as n > 64*M + 1) the port runs the plain body's torch ops,
  the counterpart of that XLA route, on every device;
* the unfused reference-parity route (``fused_ddc="off"``, or "auto" with
  ``nco_mode="lut"``): ``ops/nco.py::mix_down_block`` (the reference's
  1024-entry LUT or exact sin/cos), ``ops/fir.py::fir_decim_apply`` with the
  reference's phase counter, the AGC and the demodulator;
* the AGC in ``"block"`` mode, ``"exact"`` (the per-sample scan, S1 on the
  card) or ``"parallel"`` (the Newton solve, falling back to S1);
* the impairment stage (``impairment_bw > 0``: DC and IQ-imbalance
  correction before the mix, its estimates in the ``impair`` state), and
  ``debug_checks`` (a ``FloatingPointError`` naming the first of the five
  stages with a non-finite value, each stage read on the host).

Input is planar (2, L) float, complex (L,) (``cf32``) or raw interleaved
int16 IQ (L, 2) (``ci16``, scaled by 1/32767).  The fused route hands a
ci16 block to the DDC bodies as it is: the kernels read the int16 and
scale it in registers, and the glue converts only the samples it reads
(``ops/ddc.py::ci16_planes``), so no pass on the device writes the block
as float planes first.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import torch
from torch import nn

from ..design import firdes
from ..device import bind_device, resolve_device
from ..ops import agc as agc_ops
from ..ops import cuda_ddc
from ..ops import ddc as ddc_ops
from ..ops import fir as fir_ops
from ..ops import nco as nco_ops
from ..streaming.state import ChainState
from . import fm as fm_mod
from . import impairments as imp_mod
from . import qpsk as qpsk_mod

__all__ = ["RxChainConfig", "rx_chain_init", "make_rx_chain",
           "make_rx_chain_stream", "RxChain"]

_STAGES = ("input", "nco", "fir", "agc", "demod")


@dataclass
class RxChainConfig:
    """Chain configuration: the JAX package's fields and defaults."""

    carrier_freq: float = 0.2          # rad/sample NCO downconversion
    decimation: int = 4
    fir_taps: int = 64
    fir_cutoff: float = 0.1            # normalized (0, 0.5)
    fir_attenuation: float = 60.0      # dB
    agc_bandwidth: float = 0.01
    agc_mode: str = "block"            # "exact" | "parallel" | "block"
    demod: str = "fm"                  # "fm" | "qpsk" | "am" | "none"
    fm_kf: float = 0.1
    nco_mode: str = "exact"            # "lut" | "exact"
    dtype: torch.dtype = torch.complex64
    debug_checks: bool = False
    input_format: str = "cf32"         # "cf32" | "ci16" | "planar"
    fused_ddc: str = "auto"            # "auto" | "on" | "off"
    impairment_bw: float = 0.0
    # the DDC kernels' mode: "highest" and "x3" run TF32 x3 (~f32
    # accuracy), "default" the TPU kernels' single bf16 pass
    fir_precision: str = "highest"     # "highest" | "x3" | "default"
    # "auto": the CUDA kernels for CUDA tensors, the plain versions for CPU
    # tensors; "cuda" forces the kernels; "torch" the plain versions.
    ddc_engine: str = "auto"           # "auto" | "cuda" | "torch"
    epilogue: str = "auto"             # "auto" | "rotate"

    def design_taps(self) -> np.ndarray:
        taps = firdes.firdes_kaiser(
            self.fir_taps, self.fir_cutoff, self.fir_attenuation, 0.0)
        return taps / np.sum(taps)  # unity DC gain


def _fused(cfg: RxChainConfig) -> bool:
    """The JAX chain's route rule: fused for "on", and for "auto" with the
    exact NCO (LUT-quantized mixing cannot fold into taps)."""
    return cfg.fused_ddc == "on" or (cfg.fused_ddc == "auto"
                                     and cfg.nco_mode == "exact")


def _rdtype(cfg: RxChainConfig) -> torch.dtype:
    return torch.float64 if cfg.dtype == torch.complex128 else torch.float32


def _body_mode(cfg: RxChainConfig) -> str:
    """The DDC kernels' mode for ``fir_precision``, as the JAX package
    picks it (``mode = "x3" if precision != "default" else "fast"``); a
    complex128 chain's float64 body computes in float64."""
    if cfg.fir_precision == "default" and cfg.dtype == torch.complex64:
        return "fast"
    return "x3"


def _ddc_bodies(cfg: RxChainConfig, taps, dtheta, device):
    """The fused route's DDC bodies in the chain's mode and real type:
    (body, K1's body or None where the JAX package does not take K1: a
    float64 chain, or taps pallas_fm_supported refuses)."""
    rdt, mode, M = _rdtype(cfg), _body_mode(cfg), cfg.decimation
    body = cuda_ddc.make_ddc_body(taps, dtheta, M, device, rdt, mode)
    fm = (cuda_ddc.make_ddc_fm(taps, dtheta, M, cfg.fm_kf, device, mode=mode)
          if rdt == torch.float32 and cuda_ddc.fm_supported(len(taps), M)
          else None)
    return body, fm


def _check_config(cfg: RxChainConfig):
    """ValueError for values the JAX package rejects."""
    for name, allowed in (("agc_mode", ("exact", "parallel", "block")),
                          ("input_format", ("cf32", "ci16", "planar")),
                          ("fir_precision", ("highest", "x3", "default")),
                          ("fused_ddc", ("auto", "on", "off")),
                          ("ddc_engine", ("auto", "cuda", "torch")),
                          ("epilogue", ("auto", "rotate")),
                          ("nco_mode", ("exact", "lut")),
                          ("dtype", (torch.complex64, torch.complex128))):
        if getattr(cfg, name) not in allowed:
            raise ValueError(f"unknown {name} {getattr(cfg, name)!r}")
    if cfg.fused_ddc == "on" and cfg.nco_mode != "exact":
        raise ValueError("fused_ddc requires nco_mode='exact' "
                         "(LUT-quantized mixing cannot fold into taps)")


def rx_chain_init(cfg: RxChainConfig, device=None) -> ChainState:
    """Initial state on ``device`` (the card unless told otherwise): the JAX
    package's keys and dtypes, with the phase word as int64."""
    _check_config(cfg)
    device = resolve_device(device)
    parts = dict(
        nco_theta=torch.zeros((), dtype=torch.int64, device=device),
        fir_tail=torch.zeros(max(cfg.fir_taps - 1, 0), dtype=cfg.dtype,
                             device=device),
        fir_phase=torch.zeros((), dtype=torch.int32, device=device),
        agc=agc_ops.agc_init(_rdtype(cfg), device),
        fm_prev=torch.ones((), dtype=cfg.dtype, device=device),
    )
    if cfg.impairment_bw > 0.0:
        parts["impair"] = {
            "dc": torch.zeros((), dtype=cfg.dtype, device=device),
            "k": torch.zeros((), dtype=cfg.dtype, device=device),
            "primed": torch.zeros((), dtype=torch.bool, device=device),
        }
    return ChainState(**parts)


def _planar(cfg: RxChainConfig, x: torch.Tensor) -> torch.Tensor:
    """A planar block as (2, L) planes of the chain's real type: what the
    fused route hands its bodies for ``input_format="planar"`` (ci16
    blocks go to them as raw int16, cf32 ones as complex samples)."""
    return x.to(_rdtype(cfg))


def _complex_in(cfg: RxChainConfig, x: torch.Tensor) -> torch.Tensor:
    """The block as complex samples, as the JAX chain makes them: planar
    and ci16 become ``cfg.dtype`` (ci16 scaled in the real type), cf32 is
    taken as it comes."""
    rdt = _rdtype(cfg)
    if cfg.input_format == "ci16":
        xs = x.to(rdt) * ddc_ops.ci16_scale(rdt)
        return torch.complex(xs[..., 0], xs[..., 1]).to(cfg.dtype)
    if cfg.input_format == "planar":
        return torch.complex(x[0].to(rdt), x[1].to(rdt)).to(cfg.dtype)
    return x


def _check_stages(stages):
    """debug_checks: raise FloatingPointError naming the first of the
    five stages whose tensors (one, or a tuple) hold a NaN or Inf.  The
    flags are read on the host, one read a stage: debug mode only."""
    for name, ts in zip(_STAGES, stages):
        for t in ts if isinstance(ts, tuple) else (ts,):
            if not bool(torch.isfinite(t).all()):
                raise FloatingPointError(
                    f"non-finite values detected at chain stage {name!r}")


def make_rx_chain(cfg: RxChainConfig, device=None):
    """Build (init_state, apply) for ``device``: the card unless told
    otherwise (``device="cpu"`` runs the plain PyTorch bodies).

    ``apply(state, x)`` takes one block on ``device`` in the configured
    ``input_format``, its length L a multiple of the decimation M, and
    returns (out (L / M,), new_state): real audio or envelope for FM and
    AM, complex for QPSK (derotated symbols) and ``demod="none"``.  With
    ``debug_checks`` it raises ``FloatingPointError`` naming the first
    stage (input, nco, fir, agc, demod) that produced a NaN or Inf.
    """
    _check_config(cfg)
    device = bind_device(device)                      # None -> "cuda:0"
    M = cfg.decimation
    fused = _fused(cfg)
    impair = cfg.impairment_bw > 0.0
    dtheta = nco_ops.constrain(cfg.carrier_freq)
    taps = cfg.design_taps()
    rdt = _rdtype(cfg)
    taps_c = taps.astype(torch.empty(0, dtype=cfg.dtype).numpy().dtype)
    lut = nco_ops.make_sine_lut(torch.empty(0, dtype=rdt).numpy().dtype)
    collapse = (fused and cfg.agc_mode == "block"
                and cfg.demod in ("fm", "am") and cfg.epilogue == "auto")
    body, fm_body = (_ddc_bodies(cfg, taps, dtheta, device) if fused
                     else (None, None))
    if not (collapse and cfg.demod == "fm"):
        fm_body = None
    bw_c = torch.tensor(cfg.impairment_bw, dtype=cfg.dtype, device=device)

    def agc_stage(agc_state, y):
        if cfg.agc_mode == "exact":
            return agc_ops.agc_apply(agc_state, y, cfg.agc_bandwidth, 1.0,
                                     -1e30, 100)
        if cfg.agc_mode == "parallel":
            return agc_ops.agc_apply_parallel(agc_state, y,
                                              cfg.agc_bandwidth, 1.0, -1e30,
                                              100)
        return agc_ops.agc_apply_block_mode(agc_state, y, cfg.agc_bandwidth)

    def demod_stage(fm_prev, y):
        if cfg.demod == "fm":
            return fm_mod.fm_demodulate(fm_prev, y, cfg.fm_kf)
        if cfg.demod == "qpsk":
            return qpsk_mod.qpsk_carrier_block(y)[0], fm_prev
        if cfg.demod == "am":
            return torch.abs(y), fm_prev
        return y, fm_prev

    def apply(state: ChainState, x: torch.Tensor):
        if x.device != device:
            raise ValueError(f"block is on {x.device}, chain on {device}")
        L = int(x.shape[0] if cfg.input_format == "ci16" else x.shape[-1])
        if L % M or L == 0:
            raise ValueError(f"block length {L} must be a positive multiple "
                             f"of the decimation {M}")
        parts = {}
        planar_in = fused and not impair and cfg.input_format != "cf32"
        if planar_in and cfg.input_format == "ci16":
            # the raw int16 block goes to the bodies as it is; the kernels
            # read a sample as one 4-byte word, so a block 2 bytes off
            # (a view into a flat int16 buffer) is copied once, aligned
            x2 = x.contiguous()
            if x2.data_ptr() % 4:
                x2 = x2.clone()
        elif planar_in:
            x2 = _planar(cfg, x)
        else:
            x = _complex_in(cfg, x)
            if impair:
                st_i = state["impair"]
                x, dc, k = imp_mod.ema_correct(x, st_i["dc"], st_i["k"],
                                               bw_c, st_i["primed"])
                parts["impair"] = {"dc": dc, "k": k,
                                   "primed": torch.ones_like(st_i["primed"])}
            if fused:
                x2 = torch.stack([x.real, x.imag]).to(rdt)
        inp = x2 if planar_in else x      # debug_checks' input stage
        fm_prev = state.fm_prev
        if fused:
            tail2 = torch.stack([state.fir_tail.real, state.fir_tail.imag]
                                ).to(rdt)
            gain = state.agc["gain"]
            if fm_body is not None and L % (fm_body.P * M) == 0:
                # the fused DDC + FM kernel: the decimated complex signal
                # never reaches device memory
                out, pr, pi, ee_mean, tail2n, theta_end = \
                    ddc_ops.ddc_fm_fused(fm_body, tail2, state.nco_theta, x2,
                                         fm_prev.real, fm_prev.imag, gain,
                                         engine=cfg.ddc_engine)
                agc_state = agc_ops.block_gain_update(
                    state.agc, (gain * gain) * ee_mean, cfg.agc_bandwidth,
                    out.shape[-1])
                fm_prev = torch.complex(pr, pi)
                # debug_checks' five stages; the mix is folded into the body
                stages = (inp, inp, out, (out, agc_state["gain"]), out)
            elif collapse:
                z, tail2n, theta_end, w0, dw = \
                    ddc_ops.ddc_apply_planar_pieces(
                        body, tail2, state.nco_theta, x2,
                        engine=cfg.ddc_engine)
                agc_state = agc_ops.block_gain_update(
                    state.agc, (gain * gain) * ddc_ops.ddc_energy_pieces(z),
                    cfg.agc_bandwidth, z.shape[-1])
                if cfg.demod == "fm":
                    out, pr, pi = ddc_ops.ddc_fm_epilogue(
                        z[0], z[1], w0, dw, fm_prev.real, fm_prev.imag,
                        cfg.fm_kf, gain)
                    fm_prev = torch.complex(pr, pi)
                else:
                    out = ddc_ops.ddc_am_epilogue(z[0], z[1], gain)
                stages = (inp, inp, z, (z, agc_state["gain"]), out)
            else:
                out_re, out_im, tail2n, theta_end = ddc_ops.ddc_apply_planar(
                    body, tail2, state.nco_theta, x2, engine=cfg.ddc_engine)
                y_fir = torch.complex(out_re, out_im)
                y, agc_state = agc_stage(state.agc, y_fir)
                out, fm_prev = demod_stage(fm_prev, y)
                stages = (inp, inp, y_fir, y, out)
            fir_tail = torch.complex(tail2n[0], tail2n[1]).to(cfg.dtype)
            fir_phase = state.fir_phase      # stays 0: L % M == 0
        else:
            mixed, theta_end = nco_ops.mix_down_block(
                x, state.nco_theta, dtheta, lut, cfg.nco_mode)
            y_fir, fir_tail, fir_phase = fir_ops.fir_decim_apply(
                taps_c, state.fir_tail, state.fir_phase, mixed, 1.0, M,
                precision=cfg.fir_precision)
            y, agc_state = agc_stage(state.agc, y_fir)
            out, fm_prev = demod_stage(fm_prev, y)
            stages = (inp, mixed, y_fir, y, out)
        new_state = ChainState(
            nco_theta=theta_end, fir_tail=fir_tail, fir_phase=fir_phase,
            agc=agc_state, fm_prev=fm_prev.to(cfg.dtype), **parts)
        if cfg.debug_checks:
            _check_stages(stages)
        return out, new_state

    return partial(rx_chain_init, cfg, device), apply


def make_rx_chain_stream(cfg: RxChainConfig, block_size: int, device=None):
    """Long-stream loop: ``(init, apply_stream)`` where
    ``apply_stream(state, x)`` cuts ``x`` (n_blocks * block_size samples in
    the configured format) into blocks, runs the chain over them in a loop
    into one preallocated output and returns (out, state).  ``debug_checks``
    is refused, as in the JAX package."""
    if cfg.debug_checks:
        raise ValueError("debug_checks is incompatible with the stream scan")
    init, apply = make_rx_chain(cfg, device)
    block_size = int(block_size)

    def apply_stream(state: ChainState, x: torch.Tensor):
        n = int(x.shape[0] if cfg.input_format == "ci16" else x.shape[-1])
        if n % block_size:
            raise ValueError("stream length must be a multiple of block_size")
        n_blocks = n // block_size
        if cfg.input_format == "ci16":
            xb = x.reshape(n_blocks, block_size, 2)
        elif cfg.input_format == "planar":
            xb = x.reshape(2, n_blocks, block_size).transpose(0, 1)
        else:
            xb = x.reshape(n_blocks, block_size)
        out = None
        for i in range(n_blocks):
            y, state = apply(state, xb[i])
            if out is None:
                out = torch.empty((n_blocks, *y.shape), dtype=y.dtype,
                                  device=y.device)
            out[i] = y
        return out.reshape(-1), state

    return init, apply_stream


class RxChain(nn.Module):
    """Stateful streaming wrapper: the chain and its carried state on one
    device, fixed at construction (the card unless told otherwise)."""

    def __init__(self, cfg: RxChainConfig | None = None, device=None,
                 **overrides):
        super().__init__()
        self.cfg = cfg or RxChainConfig(**overrides)
        self.device = bind_device(device)
        self._init, self._step = make_rx_chain(self.cfg, self.device)
        self.state = self._init()

    def execute_block(self, x) -> torch.Tensor:
        """Demodulate one block in the configured ``input_format``: numpy
        input is copied to the chain's device, and any block is first cast
        to the format's dtype (real planes or complex of the chain's type,
        or int16 kept as int16)."""
        want = {"planar": _rdtype(self.cfg), "cf32": self.cfg.dtype,
                "ci16": torch.int16}[self.cfg.input_format]
        x = torch.as_tensor(x, device=self.device)
        if x.dtype != want:
            x = x.to(want)
        out, self.state = self._step(self.state, x)
        return out

    forward = execute_block

    def reset(self):
        self.state = self._init()

    def extra_repr(self) -> str:
        return (f"fc={self.cfg.carrier_freq}, M={self.cfg.decimation}, "
                f"taps={self.cfg.fir_taps}, demod={self.cfg.demod}, "
                f"device={self.device}")
