"""Chain composition: custom streaming pipelines from stages.

Port of ``solid_dsp_tpu/streaming/compose.py``.  ``compose`` folds any
sequence of block-functional stages into one transform

    apply(state, x) -> (y, state)

over a merged ChainState, so checkpoints and block streaming work as they do
for the built-in chains.  A stage is anything with ``name`` / ``init()`` /
``apply(state, x)``; :class:`Stage` wraps plain functions, and the
``stage_*`` adapters wrap the port's functional cores (FIR, decimating FIR,
IIR, NCO mix, AGC, FM discriminator, stateless maps).  Their design
constants are held on the host (numpy) and each adapter's state lives on
its ``device``, the card unless told otherwise.  On the card the stages
reach the port's kernels: ``stage_agc(mode="exact")`` the exact AGC scan
(S1), ``stage_agc(mode="parallel")`` the Newton AGC with its fall-back to
S1, ``stage_iir`` the IIR w-recurrence (S3); ``stage_fir_decim`` is
``ops.fir.fir_decim_apply``'s matmul, as the JAX package computes it
outside its kernels::

    from solid_dsp_tpu_torch.streaming.compose import (
        compose, stage_nco_mix_down, stage_fir_decim, stage_agc,
        stage_fm_demod)
    init, apply = compose(stage_nco_mix_down(0.2),
                          stage_fir_decim(taps, 4),
                          stage_agc(0.01),
                          stage_fm_demod(0.1))
    state = init()
    y, state = apply(state, x)        # x: a complex64 block on the card
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ..device import device_constant, resolve_device
from .state import ChainState

__all__ = ["Stage", "compose", "stream_scan",
           "stage_fn", "stage_fir", "stage_fir_decim", "stage_iir",
           "stage_nco_mix_down", "stage_nco_mix_up", "stage_agc",
           "stage_fm_demod"]


@dataclass(frozen=True)
class Stage:
    """A named block-functional stage: apply(state, x) -> (y, state)."""

    name: str
    init: Callable[[], Any]
    apply: Callable[[Any, torch.Tensor], tuple]


def compose(*stages) -> tuple:
    """Fold stages into one ``(init, apply)`` pair over a ChainState.

    Duplicate stage names get ``_2``, ``_3``... suffixes.  The result is
    itself a valid stage body: compose(compose(...) stages) nests.
    """
    if not stages:
        raise ValueError("compose needs at least one stage")
    names: list[str] = []
    for s in stages:
        name, k = s.name, 2
        while name in names:
            name = f"{s.name}_{k}"
            k += 1
        names.append(name)

    def init() -> ChainState:
        return ChainState(**{n: s.init() for n, s in zip(names, stages)})

    def apply(state: ChainState, x):
        outs = {}
        y = x
        for n, s in zip(names, stages):
            y, outs[n] = s.apply(state[n], y)
        return y, ChainState(**outs)

    return init, apply


def stream_scan(apply, state, blocks):
    """Run ``apply`` over (B, ...) stacked blocks, the state carried from
    block to block.  Returns (ys (B, ...), final_state), as the JAX
    package's ``lax.scan`` form returns them."""
    ys = []
    for xb in blocks:
        yb, state = apply(state, xb)
        ys.append(yb)
    return torch.stack(ys), state


def _np_dtype(dtype: torch.dtype):
    return torch.empty(0, dtype=dtype).numpy().dtype


# ------------------------------------------------------------ adapters

def stage_fn(f: Callable, name: str = "fn") -> Stage:
    """A stateless elementwise or block map (e.g. torch.abs, a slicer)."""
    return Stage(name, lambda: (), lambda st, x: (f(x), st))


def stage_fir(coefficients, scale: float = 1.0, dtype=torch.complex64,
              name: str = "fir", device=None) -> Stage:
    """FIR (the reference's newest-first taps) with its tail carried."""
    from ..ops import fir as fir_ops

    taps = np.asarray(coefficients).astype(_np_dtype(dtype))
    device = resolve_device(device)

    def init():
        return fir_ops.fir_init(len(taps), dtype=dtype, device=device)

    def apply(tail, x):
        return fir_ops.fir_apply(taps, tail, x, scale)

    return Stage(name, init, apply)


def stage_fir_decim(coefficients, decimation: int, scale: float = 1.0,
                    dtype=torch.complex64, precision: str | None = None,
                    name: str = "fir_decim", device=None) -> Stage:
    """Decimating FIR with the reference's phase counter."""
    from ..ops import fir as fir_ops

    taps = np.asarray(coefficients).astype(_np_dtype(dtype))
    M = int(decimation)
    device = resolve_device(device)

    def init():
        return {"tail": fir_ops.fir_init(len(taps), dtype=dtype,
                                         device=device),
                "phase": torch.zeros((), dtype=torch.int32, device=device)}

    def apply(st, x):
        y, tail, phase = fir_ops.fir_decim_apply(
            taps, st["tail"], st["phase"], x, scale, M, precision=precision)
        return y, {"tail": tail, "phase": phase}

    return Stage(name, init, apply)


def stage_iir(feed_forward, feed_back, dtype=torch.complex64,
              method: str = "parallel", name: str = "iir",
              device=None) -> Stage:
    """The reference's DF-II IIR; "scan" and "parallel" both run S3 on the
    card."""
    from ..ops import iir as iir_ops

    b = np.asarray(feed_forward)
    a = np.asarray(feed_back)
    b0 = (b / a[0]).astype(_np_dtype(dtype))
    a_tail = ((a / a[0])[1:]).astype(_np_dtype(dtype))
    device = resolve_device(device)

    def init():
        return iir_ops.iir_init(len(a_tail), dtype=dtype, device=device)

    def apply(w, x):
        return iir_ops.iir_apply(device_constant(b0, x.device),
                                 device_constant(a_tail, x.device), w, x,
                                 method=method)

    return Stage(name, init, apply)


def _stage_nco(freq_rad: float, mode: str, down: bool, name: str,
               rdtype, device) -> Stage:
    from ..ops import nco as nco_ops

    dtheta = nco_ops.constrain(float(freq_rad))
    lut = nco_ops.make_sine_lut(np.dtype(rdtype)) if mode == "lut" else None
    device = resolve_device(device)
    mix = nco_ops.mix_down_block if down else nco_ops.mix_up_block

    def init():
        return torch.zeros((), dtype=torch.int64, device=device)

    def apply(theta, x):
        return mix(x, theta, dtheta, lut, mode)

    return Stage(name, init, apply)


def stage_nco_mix_down(freq_rad: float, mode: str = "exact",
                       rdtype=np.float32, name: str = "nco_down",
                       device=None) -> Stage:
    """Downconvert by ``freq_rad`` rad/sample (the u32 phase word carried,
    an int64 tensor in the port)."""
    return _stage_nco(freq_rad, mode, True, name, rdtype, device)


def stage_nco_mix_up(freq_rad: float, mode: str = "exact",
                     rdtype=np.float32, name: str = "nco_up",
                     device=None) -> Stage:
    return _stage_nco(freq_rad, mode, False, name, rdtype, device)


def stage_agc(bandwidth: float, mode: str = "block", scale: float = 1.0,
              name: str = "agc", device=None) -> Stage:
    """AGC stage; mode "block" (one gain a block), "parallel" (the exact
    semantics by the Newton solve) or "exact" (the sequential scan, S1 on
    the card), the knobs of RxChainConfig.  No squelch (threshold -1e30)."""
    from ..ops import agc as agc_ops

    if mode not in ("block", "parallel", "exact"):
        raise ValueError(f"unknown agc mode {mode!r}")
    device = resolve_device(device)

    def init():
        return agc_ops.agc_init(device=device)

    def apply(st, x):
        if mode == "block":
            return agc_ops.agc_apply_block_mode(st, x, bandwidth)
        f = (agc_ops.agc_apply_parallel if mode == "parallel"
             else agc_ops.agc_apply)
        return f(st, x, bandwidth, scale, -1e30, 100)

    return Stage(name, init, apply)


def stage_fm_demod(kf: float, dtype=torch.complex64, name: str = "fm",
                   device=None) -> Stage:
    """FM discriminator; its state is the last sample, 1 at the start (an
    angle against 0 is undefined), as the receive chain starts."""
    from ..models import fm as fm_mod

    device = resolve_device(device)

    def init():
        return torch.ones((), dtype=dtype, device=device)

    def apply(prev, x):
        return fm_mod.fm_demodulate(prev, x, kf)

    return Stage(name, init, apply)
