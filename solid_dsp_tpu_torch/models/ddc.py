"""DDC: the digital down-converter, the classic SDR front end.

    NCO mix-down -> CIC bulk decimation -> droop-compensating FIR
    (+ final decimation) -> optional Farrow fine-ratio resample

Port of ``solid_dsp_tpu/models/ddc.py``: the CIC does the cheap bulk rate
change, the compensation FIR flattens the CIC's sinc^N passband droop and
selects the channel, and the Farrow stage absorbs a non-integer rate.  Each
stage is a block transform of the port (``ops/nco.py::mix_down_block``,
``ops/cic.py::CICDecimator``, ``ops/fir.py::fir_decim_apply``,
``ops/farrow.py::FarrowResampler``); the design of the inverse-sinc
compensator is the one new piece.
"""

from __future__ import annotations

import numpy as np
import torch

from ..design.windows import get_window
from ..device import resolve_device
from ..ops import fir as fir_ops
from ..ops import nco as nco_ops
from ..ops.cic import CICDecimator, _real_np, cic_frequency_response
from ..ops.farrow import FarrowResampler
from ..ops.fir import _ingest

__all__ = ["firdes_cic_compensation", "DDC"]


def firdes_cic_compensation(ntaps: int, cic_rate: int, cic_stages: int,
                            cutoff: float, cic_diff_delay: int = 1,
                            window: str = "hamming") -> np.ndarray:
    """Inverse-sinc^N compensator, designed at the CIC's output rate: the
    response 1 / |H_cic(f_out / R)| in the passband (|f_out| < cutoff of
    the output rate), 0 in the stopband, by frequency sampling and a
    window (linear phase, odd length enforced, unity DC gain)."""
    if ntaps % 2 == 0:
        ntaps += 1
    if not (0.0 < cutoff < 0.5):
        raise ValueError("cutoff must be in (0, 0.5) of the output rate")
    N = 1024
    f_out = np.fft.fftfreq(N)
    mag_cic = cic_frequency_response(f_out / cic_rate, cic_rate, cic_stages,
                                     cic_diff_delay)
    mag_cic = mag_cic / mag_cic.max()
    desired = np.where(np.abs(f_out) < cutoff, 1.0 / mag_cic, 0.0)
    h = np.real(np.fft.ifft(desired))
    h = np.roll(h, ntaps // 2)[:ntaps]
    h = h * np.asarray(get_window(window, ntaps), dtype=np.float64)
    return h / np.sum(h)


class DDC:
    """Streaming digital down-converter on ``device`` (the card unless told
    otherwise).

    freq: the carrier to remove, rad/sample at the input rate;
    cic_rate / cic_stages: the bulk CIC decimation; fir_decim: the final
    FIR decimation (the compensator runs before it); fir_taps / cutoff: the
    compensator's length and passband edge (of the CIC output rate);
    ratio: an extra Farrow ratio (input per output at the FIR's output
    rate), None for none.  Total decimation cic_rate * fir_decim *
    (ratio or 1).  A block's length must be a multiple of
    cic_rate * fir_decim.  ``state``: {"theta" (the u32 phase word, int64),
    "cic": {"tail", "phase"}, "fir_tail", "fir_phase", and "farrow":
    {"tail", "t_next"} with a ratio}, the JAX object's ``_theta``,
    ``cic._tail``/``_phase``, ``_fir_tail``, ``_fir_phase`` and
    ``farrow._tail``/``_t_next``."""

    def __init__(self, freq: float, cic_rate: int = 8, cic_stages: int = 4,
                 fir_decim: int = 2, fir_taps: int = 64,
                 cutoff: float | None = None, ratio: float | None = None,
                 dtype=torch.complex64, device=None):
        self.freq = float(freq)
        self.dtype = dtype
        self.device = resolve_device(device)
        self._dtheta = nco_ops.constrain(self.freq)
        self._lut = nco_ops.make_sine_lut(_real_np(dtype))
        self.cic = CICDecimator(cic_rate, cic_stages, dtype=dtype,
                                device=self.device)
        cutoff = cutoff if cutoff is not None else 0.4 / fir_decim
        comp = firdes_cic_compensation(fir_taps, cic_rate, cic_stages,
                                       cutoff)
        # real taps (the product's banks on the host), as the CIC's
        self._comp_np = comp.astype(_real_np(dtype))
        self.fir_decim = int(fir_decim)
        self.farrow = (FarrowResampler(ratio, dtype=dtype, device=self.device)
                       if ratio else None)
        self.decimation = cic_rate * fir_decim * (ratio or 1.0)
        self.reset()

    def reset(self):
        self._theta = torch.zeros((), dtype=torch.int64, device=self.device)
        self.cic.reset()
        self._fir_tail = fir_ops.fir_init(len(self._comp_np), self.dtype,
                                          device=self.device)
        self._fir_phase = torch.zeros((), dtype=torch.int32,
                                      device=self.device)
        if self.farrow is not None:
            self.farrow.reset()

    @property
    def state(self) -> dict:
        st = {"theta": self._theta, "cic": self.cic.state,
              "fir_tail": self._fir_tail, "fir_phase": self._fir_phase}
        if self.farrow is not None:
            st["farrow"] = {"tail": self.farrow._tail,
                            "t_next": torch.tensor(self.farrow._t_next,
                                                   dtype=torch.float64)}
        return st

    @state.setter
    def state(self, st: dict):
        self._theta = (st["theta"].to(self.device, torch.int64)
                       & nco_ops.U32_MASK)
        self.cic.state = st["cic"]
        self._fir_tail = st["fir_tail"].to(self.device)
        self._fir_phase = st["fir_phase"].to(self.device, torch.int32)
        if self.farrow is not None:
            self.farrow._tail = st["farrow"]["tail"].to(self.device)
            self.farrow._t_next = float(st["farrow"]["t_next"])

    def execute_block(self, x):
        x = _ingest(x, self.device).to(self.dtype)
        mixed, self._theta = nco_ops.mix_down_block(
            x, self._theta, self._dtheta, self._lut, "exact")
        y = self.cic.execute_block(mixed)
        y, self._fir_tail, self._fir_phase = fir_ops.fir_decim_apply(
            self._comp_np, self._fir_tail, self._fir_phase, y,
            torch.tensor(1.0, dtype=self.dtype), self.fir_decim)
        if self.farrow is not None:
            y = self.farrow.execute_block(y)
        return y

    def __repr__(self):
        return (f"DDC [freq={self.freq:.4f}] "
                f"[decim={self.decimation:.4f}]")
