"""RxChain — the composed receive chain, collapsed FM path.

Port of ``solid_dsp_tpu/models/rx_chain.py``: NCO downconversion, decimating
FIR, block AGC and FM demodulation as one block transform
``apply(state, x) -> (audio, state)``.  Only the branch that config 4
(``bench.py``) takes is ported: planar (2, L) f32 input, the NCO mix folded into
complex bandpass taps (``fused_ddc``), block-mode AGC and the FM
discriminator collapsed onto the unrotated filter output, all in one pass of
the fused DDC+FM body (``ops/cuda_ddc.py``).  Every other setting raises
``NotImplementedError`` naming the ROADMAP item that will port it.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import torch
from torch import nn

from ..design import firdes
from ..ops import agc as agc_ops
from ..ops import cuda_ddc
from ..ops import ddc as ddc_ops
from ..ops import nco as nco_ops
from ..streaming.state import ChainState

__all__ = ["RxChainConfig", "rx_chain_init", "make_rx_chain", "RxChain"]

_LATER = "ROADMAP.md queue 1 item 7 (the rest of the rx chain)"


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
    # "auto": the CUDA kernel for CUDA tensors, the plain version for CPU
    # tensors; "cuda" forces the kernel; "torch" the plain version.
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
        (f"demod={cfg.demod!r}", cfg.demod != "fm",
         _LATER + "; AM and QPSK run on K2"),
        (f"agc_mode={cfg.agc_mode!r}", cfg.agc_mode != "block", _LATER),
        (f"input_format={cfg.input_format!r}", cfg.input_format != "planar",
         _LATER),
        ("fused_ddc='off'", cfg.fused_ddc == "off", _LATER),
        (f"nco_mode={cfg.nco_mode!r}", cfg.nco_mode != "exact", _LATER),
        (f"impairment_bw={cfg.impairment_bw!r}", cfg.impairment_bw > 0.0,
         _LATER),
        ("debug_checks=True", cfg.debug_checks, _LATER),
        (f"epilogue={cfg.epilogue!r}", cfg.epilogue != "auto", _LATER),
        ("fir_precision='default'", cfg.fir_precision == "default", _LATER),
        (f"dtype={cfg.dtype}", cfg.dtype != torch.complex64, _LATER),
        (f"fir_taps={cfg.fir_taps}, decimation={cfg.decimation}",
         not cuda_ddc.fm_supported(cfg.fir_taps, cfg.decimation),
         "ROADMAP.md queue 2 (K2, the DDC body without the FM epilogue)"),
    ]
    for setting, hit, item in unported:
        if hit:
            raise NotImplementedError(
                f"{setting} is not ported to solid_dsp_tpu_torch yet: "
                f"see {item}")


def rx_chain_init(cfg: RxChainConfig, device=None) -> ChainState:
    """Initial state on ``device``: the JAX package's keys and dtypes, with
    the phase word as int64."""
    _check_config(cfg)
    return ChainState(
        nco_theta=torch.zeros((), dtype=torch.int64, device=device),
        fir_tail=torch.zeros(max(cfg.fir_taps - 1, 0), dtype=cfg.dtype,
                             device=device),
        fir_phase=torch.zeros((), dtype=torch.int32, device=device),
        agc=agc_ops.agc_init(torch.float32, device),
        fm_prev=torch.ones((), dtype=cfg.dtype, device=device),
    )


def make_rx_chain(cfg: RxChainConfig, device=None):
    """Build (init_state, apply) for ``device``.

    ``apply(state, x)`` takes a planar (2, L) block on ``device``, L a
    multiple of 64 * decimation, and returns (audio (L / M,), new_state).
    """
    _check_config(cfg)
    device = torch.empty(0, device=device).device   # "cuda" -> "cuda:0"
    dtheta = nco_ops.constrain(cfg.carrier_freq)
    body = cuda_ddc.make_ddc_fm(cfg.design_taps(), dtheta, cfg.decimation,
                                cfg.fm_kf, device)

    def apply(state: ChainState, x: torch.Tensor):
        if x.device != device:
            raise ValueError(f"block is on {x.device}, chain on {device}")
        x2 = x.to(torch.float32)
        tail2 = torch.stack([state.fir_tail.real, state.fir_tail.imag])
        out, pr, pi, ee_mean, tail2n, theta_end = ddc_ops.ddc_fm_fused(
            body, tail2, state.nco_theta, x2, state.fm_prev.real,
            state.fm_prev.imag, state.agc["gain"], engine=cfg.ddc_engine)
        gain = state.agc["gain"]
        agc_state = agc_ops.block_gain_update(
            state.agc, (gain * gain) * ee_mean, cfg.agc_bandwidth,
            out.shape[-1])
        return out, ChainState(
            nco_theta=theta_end,
            fir_tail=torch.complex(tail2n[0], tail2n[1]).to(cfg.dtype),
            fir_phase=state.fir_phase,
            agc=agc_state,
            fm_prev=torch.complex(pr, pi).to(cfg.dtype),
        )

    return partial(rx_chain_init, cfg, device), apply


class RxChain(nn.Module):
    """Stateful streaming wrapper: the chain and its carried state on one
    device, fixed at construction."""

    def __init__(self, cfg: RxChainConfig | None = None, device=None,
                 **overrides):
        super().__init__()
        self.cfg = cfg or RxChainConfig(**overrides)
        self.device = torch.device(device or "cpu")
        self._init, self._step = make_rx_chain(self.cfg, self.device)
        self.state = self._init()

    def execute_block(self, x) -> torch.Tensor:
        """Demodulate one planar (2, L) block; numpy input is copied to the
        chain's device as float32."""
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        out, self.state = self._step(self.state, x)
        return out

    forward = execute_block

    def reset(self):
        self.state = self._init()

    def extra_repr(self) -> str:
        return (f"fc={self.cfg.carrier_freq}, M={self.cfg.decimation}, "
                f"taps={self.cfg.fir_taps}, demod={self.cfg.demod}, "
                f"device={self.device}")
