"""RxChain — the composed receive chain.

Port of ``solid_dsp_tpu/models/rx_chain.py``: NCO downconversion, decimating
FIR, block AGC and demodulation (FM, QPSK, AM or none) as one block
transform ``apply(state, x) -> (out, state)``.  The branches of config 4
(``bench.py``, ``BASELINE.json``) are ported: the NCO mix folded into complex
bandpass taps (``fused_ddc``), block-mode AGC, and

* the collapsed epilogue (``epilogue="auto"``, FM and AM): the
  demodulator runs on the unrotated body output, because the rotation and
  the positive gain cancel in a phase difference and scale an envelope.
  FM blocks whose length is a multiple of 64*M run the fused DDC + FM
  kernel (K1); other FM blocks and AM run the DDC body kernel (K2, or K3's
  route for an unaligned block) and the epilogue in torch ops;
* the rotated path (QPSK, ``demod="none"``, ``epilogue="rotate"``): the
  body, the decimated-rate rotation, ``agc_apply_block_mode`` and the
  demodulator.

Input is planar (2, L) float, complex (L,) (``cf32``) or raw interleaved
int16 IQ (L, 2) (``ci16``, scaled by 1/32767 in float32); all three feed
the same planar body.  Every other setting raises ``NotImplementedError``
naming the ROADMAP item that will port it.
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
from ..ops import nco as nco_ops
from ..streaming.state import ChainState
from . import fm as fm_mod
from . import qpsk as qpsk_mod

__all__ = ["RxChainConfig", "rx_chain_init", "make_rx_chain",
           "make_rx_chain_stream", "RxChain"]

_LATER = "ROADMAP.md queue 1 item 7 (the rest of the rx chain)"
_CI16_SCALE = float(np.float32(1.0 / 32767.0))
_IN_DTYPES = {"planar": torch.float32, "cf32": torch.complex64,
              "ci16": torch.int16}


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
    # "highest" and "x3" both run the body in FP32 FMA on Hopper: x3's
    # contract is ~f32 accuracy, which plain FP32 meets.
    fir_precision: str = "highest"     # "highest" | "x3" | "default"
    # "auto": the CUDA kernels for CUDA tensors, the plain versions for CPU
    # tensors; "cuda" forces the kernels; "torch" the plain versions.
    ddc_engine: str = "auto"           # "auto" | "cuda" | "torch"
    epilogue: str = "auto"             # "auto" | "rotate"

    def design_taps(self) -> np.ndarray:
        taps = firdes.firdes_kaiser(
            self.fir_taps, self.fir_cutoff, self.fir_attenuation, 0.0)
        return taps / np.sum(taps)  # unity DC gain


def _check_config(cfg: RxChainConfig):
    """ValueError for values the JAX package rejects, NotImplementedError
    for settings whose branch is not ported yet."""
    for name, allowed in (("agc_mode", ("exact", "parallel", "block")),
                          ("input_format", ("cf32", "ci16", "planar")),
                          ("fir_precision", ("highest", "x3", "default")),
                          ("fused_ddc", ("auto", "on", "off")),
                          ("ddc_engine", ("auto", "cuda", "torch")),
                          ("epilogue", ("auto", "rotate"))):
        if getattr(cfg, name) not in allowed:
            raise ValueError(f"unknown {name} {getattr(cfg, name)!r}")
    if cfg.fused_ddc == "on" and cfg.nco_mode != "exact":
        raise ValueError("fused_ddc requires nco_mode='exact' "
                         "(LUT-quantized mixing cannot fold into taps)")
    unported = [
        (f"agc_mode={cfg.agc_mode!r}", cfg.agc_mode != "block", _LATER),
        ("fused_ddc='off'", cfg.fused_ddc == "off", _LATER),
        (f"nco_mode={cfg.nco_mode!r}", cfg.nco_mode != "exact", _LATER),
        (f"impairment_bw={cfg.impairment_bw!r}", cfg.impairment_bw > 0.0,
         _LATER),
        ("debug_checks=True", cfg.debug_checks, _LATER),
        ("fir_precision='default'", cfg.fir_precision == "default", _LATER),
        (f"dtype={cfg.dtype}", cfg.dtype != torch.complex64, _LATER),
        (f"fir_taps={cfg.fir_taps}, decimation={cfg.decimation}",
         not cuda_ddc.fm_supported(cfg.fir_taps, cfg.decimation),
         _LATER + "; the kernels take M < fir_taps <= 64*M"),
    ]
    for setting, hit, item in unported:
        if hit:
            raise NotImplementedError(
                f"{setting} is not ported to solid_dsp_tpu_torch yet: "
                f"see {item}")


def rx_chain_init(cfg: RxChainConfig, device=None) -> ChainState:
    """Initial state on ``device`` (the card unless told otherwise): the JAX
    package's keys and dtypes, with the phase word as int64."""
    _check_config(cfg)
    device = resolve_device(device)
    return ChainState(
        nco_theta=torch.zeros((), dtype=torch.int64, device=device),
        fir_tail=torch.zeros(max(cfg.fir_taps - 1, 0), dtype=cfg.dtype,
                             device=device),
        fir_phase=torch.zeros((), dtype=torch.int32, device=device),
        agc=agc_ops.agc_init(torch.float32, device),
        fm_prev=torch.ones((), dtype=cfg.dtype, device=device),
    )


def _planar(cfg: RxChainConfig, x: torch.Tensor) -> torch.Tensor:
    """The block as contiguous (2, L) float32 planes."""
    if cfg.input_format == "ci16":
        # (L, 2) int16 -> float32 times float32(1/32767), written straight
        # into the planar layout: one pass
        x2 = torch.empty((2, x.shape[0]), dtype=torch.float32,
                         device=x.device)
        return torch.mul(x.T, _CI16_SCALE, out=x2)
    if cfg.input_format == "cf32":
        return torch.stack([x.real, x.imag]).to(torch.float32)
    return x.to(torch.float32)


def make_rx_chain(cfg: RxChainConfig, device=None):
    """Build (init_state, apply) for ``device``: the card unless told
    otherwise (``device="cpu"`` runs the plain PyTorch bodies).

    ``apply(state, x)`` takes one block on ``device`` in the configured
    ``input_format``, its length L a multiple of the decimation M, and
    returns (out (L / M,), new_state): float32 audio or envelope for FM and
    AM, complex64 for QPSK (derotated symbols) and ``demod="none"``.
    """
    _check_config(cfg)
    device = bind_device(device)                      # None -> "cuda:0"
    M = cfg.decimation
    dtheta = nco_ops.constrain(cfg.carrier_freq)
    taps = cfg.design_taps()
    body = cuda_ddc.make_ddc_body(taps, dtheta, M, device)
    collapse = cfg.demod in ("fm", "am") and cfg.epilogue == "auto"
    fm_body = (cuda_ddc.make_ddc_fm(taps, dtheta, M, cfg.fm_kf, device)
               if collapse and cfg.demod == "fm" else None)

    def apply(state: ChainState, x: torch.Tensor):
        if x.device != device:
            raise ValueError(f"block is on {x.device}, chain on {device}")
        L = int(x.shape[0] if cfg.input_format == "ci16" else x.shape[-1])
        if L % M or L == 0:
            raise ValueError(f"block length {L} must be a positive multiple "
                             f"of the decimation {M}")
        x2 = _planar(cfg, x)
        tail2 = torch.stack([state.fir_tail.real, state.fir_tail.imag])
        gain = state.agc["gain"]
        fm_prev = state.fm_prev
        if fm_body is not None and L % (fm_body.P * M) == 0:
            # the fused DDC + FM kernel: the decimated complex signal never
            # reaches device memory
            out, pr, pi, ee_mean, tail2n, theta_end = ddc_ops.ddc_fm_fused(
                fm_body, tail2, state.nco_theta, x2, fm_prev.real,
                fm_prev.imag, gain, engine=cfg.ddc_engine)
            agc_state = agc_ops.block_gain_update(
                state.agc, (gain * gain) * ee_mean, cfg.agc_bandwidth,
                out.shape[-1])
            fm_prev = torch.complex(pr, pi)
        elif collapse:
            z, tail2n, theta_end, w0, dw = ddc_ops.ddc_apply_planar_pieces(
                body, tail2, state.nco_theta, x2, engine=cfg.ddc_engine)
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
        else:
            out_re, out_im, tail2n, theta_end = ddc_ops.ddc_apply_planar(
                body, tail2, state.nco_theta, x2, engine=cfg.ddc_engine)
            y, agc_state = agc_ops.agc_apply_block_mode(
                state.agc, torch.complex(out_re, out_im), cfg.agc_bandwidth)
            if cfg.demod == "fm":
                out, fm_prev = fm_mod.fm_demodulate(fm_prev, y, cfg.fm_kf)
            elif cfg.demod == "qpsk":
                out, _, _ = qpsk_mod.qpsk_carrier_block(y)
            elif cfg.demod == "am":
                out = torch.abs(y)
            else:
                out = y
        return out, ChainState(
            nco_theta=theta_end,
            fir_tail=torch.complex(tail2n[0], tail2n[1]).to(cfg.dtype),
            fir_phase=state.fir_phase,
            agc=agc_state,
            fm_prev=fm_prev.to(cfg.dtype),
        )

    return partial(rx_chain_init, cfg, device), apply


def make_rx_chain_stream(cfg: RxChainConfig, block_size: int):
    """The JAX package's many-blocks-per-dispatch stream: not ported yet."""
    raise NotImplementedError(
        "make_rx_chain_stream is not ported to solid_dsp_tpu_torch yet: see "
        + _LATER)


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
        to the format's dtype (float32 planes, complex64, or int16 kept as
        int16)."""
        want = _IN_DTYPES[self.cfg.input_format]
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
