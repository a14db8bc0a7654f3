"""TxChain: the transmit counterpart of RxChain.

Port of ``solid_dsp_tpu/models/tx_chain.py``:

    message -> modulate (FM / M-PSK / M-QAM) -> interpolate (zero-stuff +
    anti-image FIR) -> NCO mix up to the carrier

Every stage is a block transform of the port (``fm_modulate``,
``linear_mod``'s mapper with an RRC pulse through ``conv1d_mxu``, the
anti-image FIR through ``conv1d_mxu``, ``ops/nco.py::mix_up_block``'s
"exact" oscillator); its state is a ``ChainState`` (``nco_theta``, the
u32 phase word as int64 as everywhere in the port; ``fir_tail``;
``fm_phase``; ``rrc_tail``) built by ``init`` on ``device`` (the card
unless told otherwise).  JAX's ``put_tree`` has no counterpart.  The state
moves between the packages with ``interop.state_from_numpy`` /
``state_to_numpy``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..design import firdes
from ..device import bind_device, device_constant
from ..ops import nco as nco_ops
from ..ops.fir import conv1d_mxu
from ..streaming.state import ChainState
from . import fm as fm_mod
from . import linear_mod

__all__ = ["TxChainConfig", "make_tx_chain", "TxChain"]


@dataclass
class TxChainConfig:
    """Static transmit-chain configuration."""

    carrier_freq: float = 0.2          # rad/sample NCO upconversion
    interpolation: int = 4
    fir_taps: int = 64                 # anti-image lowpass at the TX rate
    fir_attenuation: float = 60.0      # dB
    modulation: str = "fm"             # "fm" | "psk" | "qam" | "none"
    order: int = 4                     # constellation order for psk/qam
    sps: int = 4                       # samples/symbol for linear schemes
    fm_kf: float = 0.1
    dtype: object = torch.complex64

    def design_taps(self) -> np.ndarray:
        """The anti-image lowpass, cutoff at 0.5 / P (the zero-stuffed
        message fills +-0.5 / P and the first image starts there), its DC
        gain P (zero-stuffing loses a factor P)."""
        taps = firdes.firdes_kaiser(self.fir_taps, 0.5 / self.interpolation,
                                    self.fir_attenuation, 0.0)
        return taps / np.sum(taps) * self.interpolation


def _zero_stuff(x: torch.Tensor, P: int) -> torch.Tensor:
    up = x.new_zeros(x.shape[-1] * P)
    up[::P] = x
    return up


def make_tx_chain(cfg: TxChainConfig, device=None):
    """(init, apply): apply(state, msg) -> (iq, state).

    msg: real samples ("fm"), bits ("psk", "qam") or complex baseband
    ("none").  Output: ``interpolation`` samples a message sample for fm
    and none; ``interpolation * sps / log2(order)`` a bit for psk/qam."""
    if cfg.modulation not in ("fm", "psk", "qam", "none"):
        raise ValueError(f"unknown modulation {cfg.modulation!r}")
    dev = bind_device(device)
    cdt = cfg.dtype
    rdt = torch.float64 if cdt == torch.complex128 else torch.float32
    taps = device_constant(cfg.design_taps(), dev, rdt)
    n = taps.shape[0]
    dtheta = nco_ops.constrain(cfg.carrier_freq)
    P = int(cfg.interpolation)
    linear = cfg.modulation in ("psk", "qam")
    if linear:
        points = np.asarray(linear_mod.constellation(cfg.modulation,
                                                     cfg.order), np.complex128)
        k_bits = int(np.log2(cfg.order))
        rrc = device_constant(firdes.firdes_rrcos(cfg.sps, 6, 0.35), dev, rdt)

    def init() -> ChainState:
        return ChainState(
            nco_theta=torch.zeros((), dtype=torch.int64, device=dev),
            fir_tail=torch.zeros(n - 1, dtype=cdt, device=dev),
            fm_phase=torch.zeros((), dtype=rdt, device=dev),
            rrc_tail=torch.zeros(rrc.shape[0] - 1 if linear else 0,
                                 dtype=cdt, device=dev))

    def apply(state: ChainState, msg):
        msg = torch.as_tensor(msg)
        fm_phase, rrc_tail = state["fm_phase"], state["rrc_tail"]
        # 1. modulate to complex baseband
        if cfg.modulation == "fm":
            bb, fm_phase = fm_mod.fm_modulate(msg.to(dev, rdt), cfg.fm_kf,
                                              fm_phase)
            bb = bb.to(cdt)
        elif linear:
            syms = linear_mod.bits_to_symbols(msg.to(dev), k_bits)
            iq_sym = linear_mod.modulate_symbols(syms, points).to(cdt)
            ext = torch.cat([rrc_tail, _zero_stuff(iq_sym, cfg.sps)])
            bb = conv1d_mxu(ext, rrc)
            rrc_tail = ext[ext.shape[-1] - (rrc.shape[0] - 1):]
        else:
            bb = msg.to(dev, cdt)
        # 2. zero-stuff interpolation and the anti-image FIR
        ext = torch.cat([state["fir_tail"], _zero_stuff(bb, P)])
        tx = conv1d_mxu(ext, taps)
        # 3. mix up to the carrier (closed-form phases)
        iq, theta_end = nco_ops.mix_up_block(tx, state["nco_theta"], dtheta,
                                             mode="exact")
        return iq, ChainState(nco_theta=theta_end,
                              fir_tail=ext[ext.shape[-1] - (n - 1):],
                              fm_phase=fm_phase, rrc_tail=rrc_tail)

    return init, apply


class TxChain:
    """Stateful transmit chain on ``device`` (the card unless told
    otherwise)."""

    def __init__(self, cfg: TxChainConfig | None = None, device=None,
                 **overrides):
        self.cfg = cfg or TxChainConfig(**overrides)
        self._init, self._apply = make_tx_chain(self.cfg, device)
        self.state = self._init()

    def execute_block(self, msg) -> torch.Tensor:
        iq, self.state = self._apply(self.state, msg)
        return iq

    def reset(self):
        self.state = self._init()

    def __repr__(self):
        return (f"TxChain [fc={self.cfg.carrier_freq}] "
                f"[P={self.cfg.interpolation}] "
                f"[mod={self.cfg.modulation}]")
