"""ChannelBank: channelize a wideband stream, then filter every channel.

Port of ``solid_dsp_tpu/models/channel_bank.py`` (:29-129), the production
shape of BASELINE.json's config 5: the polyphase channelizer splits one
wideband stream into M critically-sampled channels, an IIR biquad cascade
(shared or per channel) runs over all M channels at once through the K6 kernel
(``ops/cuda_iir.py``; its lane coefficients and chunk tables are built when
the bank is made and again when ``sos`` is set, never once a block), then an optional per-channel energy squelch
(``models/detect.py``) and an optional per-channel block AGC.  ``.state``
carries the cascade state and the per-channel AGC as
``ChainState(iir=..., agc=...)``; the channelizer's tail is
``.channelizer.state``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import bind_device
from ..ops import agc as agc_ops
from ..ops.cuda_iir import IirBank, iir_bank_init
from ..streaming.state import ChainState
from . import detect
from .channelizer import PolyphaseChannelizer

__all__ = ["ChannelBank", "design_channel_sos"]


def design_channel_sos(cutoff: float = 0.25, order: int = 4) -> np.ndarray:
    """Butterworth lowpass as a biquad cascade (S, 5) [b0 b1 b2 a1 a2]
    float32: the bilinear transform of the order/2 conjugate pole pairs,
    unity DC gain per section; ``cutoff`` in (0, 0.5) of the channel rate
    (``channel_bank.py:29-49``)."""
    if order % 2:
        raise ValueError("order must be even (biquad pairs)")
    K = np.tan(np.pi * cutoff)  # prewarped
    sections = []
    n = order
    for k in range(n // 2):
        theta = np.pi * (2 * k + 1) / (2 * n)
        Q = 1.0 / (2.0 * np.cos(theta))
        norm = 1.0 / (1.0 + K / Q + K * K)
        b0 = K * K * norm
        sections.append([b0, 2 * b0, b0,
                         2.0 * (K * K - 1.0) * norm,
                         (1.0 - K / Q + K * K) * norm])
    return np.asarray(sections, dtype=np.float32)


class ChannelBank(nn.Module):
    """Channelizer + per-channel IIR cascade + optional squelch and AGC.

    ``sos``: (S, 5) shared by every channel or (S, 5, M) per channel.
    ``backend``: the channelizer's ("xla", "fused" or "pallas"; "fused"
    runs K4 at precision "x3").  ``device``: the card unless told
    otherwise.  ``engine``: "auto" runs the kernels on the card and their
    plain versions on the CPU; "torch" the plain versions on the card too.
    """

    def __init__(self, num_channels: int, taps_per_branch: int = 8,
                 sos: np.ndarray | None = None, agc_bandwidth: float = 0.0,
                 attenuation: float = 80.0, backend: str = "xla",
                 squelch_high_db: float | None = None,
                 squelch_low_db: float | None = None,
                 squelch_window: int = 32, device=None,
                 engine: str = "auto"):
        super().__init__()
        self.M = int(num_channels)
        self.device = bind_device(device)
        self.engine = engine
        self.channelizer = PolyphaseChannelizer(
            self.M, taps_per_branch, attenuation, dtype=torch.complex64,
            backend=backend, device=self.device, engine=engine)
        self.sos = sos if sos is not None else design_channel_sos()
        self.agc_bandwidth = float(agc_bandwidth)
        if squelch_low_db is not None and squelch_high_db is None:
            raise ValueError("squelch_low_db given without squelch_high_db")
        if (squelch_high_db is not None and squelch_low_db is not None
                and squelch_low_db > squelch_high_db):
            raise ValueError("squelch_low_db must not exceed squelch_high_db")
        self.squelch_high_db = squelch_high_db
        self.squelch_low_db = (squelch_low_db if squelch_low_db is not None
                               else (squelch_high_db - 3.0
                                     if squelch_high_db is not None else None))
        self.squelch_window = int(squelch_window)
        self.reset()

    @property
    def sos(self) -> np.ndarray:
        """The cascade's coefficients, (S, 5) or (S, 5, M) float32."""
        return self._iir.sos

    @sos.setter
    def sos(self, value):
        """New coefficients: rebuilds the lane coefficients and the chunk
        tables; a new number of sections restarts the cascade state."""
        old = getattr(self, "_iir", None)
        self._iir = IirBank(value, self.M, self.device)
        if old is not None and old.nsections != self._iir.nsections:
            self._iir_state = iir_bank_init(self._iir.nsections, self.M,
                                            self.device)

    @property
    def state(self) -> ChainState:
        return ChainState(iir=self._iir_state, agc=self._agc_state)

    @state.setter
    def state(self, value):
        """Load a ``ChainState(iir=..., agc=...)`` (or a mapping of numpy
        leaves with those keys) of the same shapes and dtypes."""
        iir = torch.as_tensor(value["iir"])
        if iir.shape != self._iir_state.shape or iir.dtype != torch.complex64:
            raise ValueError(f"iir state must be complex64"
                             f"{tuple(self._iir_state.shape)}")
        agc = {}
        for k, old in self._agc_state.items():
            new = torch.as_tensor(value["agc"][k])
            if new.shape != old.shape or new.dtype != old.dtype:
                raise ValueError(f"agc {k} must be {old.dtype}"
                                 f"{tuple(old.shape)}")
            agc[k] = new.to(self.device).clone()
        self._iir_state = iir.to(self.device).clone()
        self._agc_state = agc

    def execute_block(self, x) -> torch.Tensor:
        """x (L,) wideband complex64, L % M == 0 -> (T, M) channel outputs."""
        Y = self.channelizer.execute_block(x)               # (T, M)
        Y, self._iir_state = self._iir(
            self._iir_state, Y.to(torch.complex64).contiguous(), self.engine)
        if self.squelch_high_db is not None:
            e_db, self._det_tail = detect.sliding_energy_db(
                Y.T, self._det_tail, self.squelch_window)
            gate, self._det_on = detect.hysteresis_gate(
                e_db, self.squelch_high_db, self.squelch_low_db,
                self._det_on)
            self.last_gate = gate                            # (M, T)
            Y = torch.where(gate.T, Y, torch.zeros((), dtype=Y.dtype,
                                                   device=Y.device))
        if self.agc_bandwidth > 0.0:
            out, self._agc_state = agc_ops.agc_apply_block_mode(
                self._agc_state, Y.T, self.agc_bandwidth)
            Y = out.T
        return Y

    forward = execute_block

    def reset(self) -> None:
        self.channelizer.reset()
        self._iir_state = iir_bank_init(self.sos.shape[0], self.M,
                                        self.device)
        self._agc_state = agc_ops.agc_init(torch.float32, self.device,
                                           batch_shape=(self.M,))
        self._det_tail = torch.zeros((self.M, self.squelch_window),
                                     dtype=torch.complex64,
                                     device=self.device)
        self._det_on = torch.zeros(self.M, dtype=torch.bool,
                                   device=self.device)
        self.last_gate = None   # (M, T) bool after each block when enabled

    def __repr__(self) -> str:
        return (f"ChannelBank [M={self.M}] [sections={self.sos.shape[0]}] "
                f"[agc_bw={self.agc_bandwidth}] [device={self.device}]")
