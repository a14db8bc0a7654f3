"""The multi-channel IIR biquad bank on Hopper: wrapper and plain version.

Port of the TPU kernel ``solid_dsp_tpu/ops/pallas_kernels.py::
iir_bank_apply`` (K6, :238-302) with ``iir_bank_init`` (:230-235): an
S-section direct-form-II biquad cascade run over C complex channels at
once, sequential in time, with the state (2S, C) complex64 rows
[w1_0, w2_0, w1_1, ...] carried from block to block.  ``sos`` is (S, 5)
[b0 b1 b2 a1 a2] shared by every channel or (S, 5, C) per channel.

* :func:`iir_bank_cuda` launches ``csrc/iir_bank.cu``: a time-parallel
  chunked recurrence (chunks of :data:`IIR_CHUNK` rows run from a zero
  state, their ends joined span by span through the per-lane tables
  Phi^(Lc j) of :func:`iir_join_tables`, then every chunk run again from its
  true start); 1 <= S <= 8, any T.
* :func:`iir_bank_torch` is the plain version: a Python loop over time,
  vectorised over the channels, in the kernel's order of operations (the
  spec of ``tests/test_pallas.py::_np_sos_ref``).

:class:`IirBank` holds one cascade's lane coefficients and join tables on
its device, built once (``models/channel_bank.py`` keeps one);
:func:`iir_bank_apply` builds them for each call and takes the plain
version for CPU tensors and the kernel for CUDA tensors
(``engine="auto"``); ``"torch"`` runs the plain version on any device.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import resolve_device
from .cuda_build import check_launch, launcher, stream_of, use_kernel

__all__ = ["iir_bank_init", "iir_bank_apply", "iir_bank_lanes",
           "iir_chunk_tables", "iir_join_tables", "join_span", "IirBank",
           "iir_bank_torch", "iir_bank_cuda", "MAX_SECTIONS", "IIR_CHUNK"]

MAX_SECTIONS = 8
IIR_CHUNK = 64           # rows a chunk of the kernel (csrc/iir_bank.cu note)
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = (_P,) * 7 + (_LL, _I, _I, _I, _I, _I, _P)


def iir_bank_init(nsections: int, num_channels: int, device=None
                  ) -> torch.Tensor:
    """Zero cascade state (2S, C) complex64 on ``device`` (the card unless
    told otherwise)."""
    return torch.zeros((2 * nsections, num_channels), dtype=torch.complex64,
                       device=resolve_device(device))


def iir_bank_lanes(sos, num_channels: int, device) -> torch.Tensor:
    """(S, 5) or (S, 5, C) coefficients -> (5S, 2C) float32, row 5s + k
    holding coefficient k of section s for every interleaved re/im lane."""
    sos = torch.as_tensor(sos, dtype=torch.float32, device=device)
    S = sos.shape[0]
    if sos.dim() == 2:
        sos = sos[:, :, None].expand(S, 5, num_channels)
    if tuple(sos.shape) != (S, 5, num_channels):
        raise ValueError(f"sos must be (S, 5) or (S, 5, {num_channels}), "
                         f"got {tuple(sos.shape)}")
    return sos.reshape(5 * S, num_channels).repeat_interleave(2, dim=1
                                                              ).contiguous()


def join_span(S: int) -> int:
    """Chunks a span of the kernel's join joins in registers (join_span in
    csrc/iir_bank.cu): 64 // 2S within [2, 32]."""
    return max(2, min(32, 64 // (2 * S)))


def _phi64(sos_l: torch.Tensor, Lc: int) -> torch.Tensor:
    """Phi^Lc of every lane in float64 on the CPU, (2S, 2S, 2C)."""
    S = sos_l.shape[0] // 5
    N = 2 * S
    co = sos_l.detach().to("cpu", torch.float64).reshape(S, 5, 1, -1)
    w = torch.eye(N, dtype=torch.float64)[:, :, None].expand(
        N, N, sos_l.shape[1]).clone()          # [state row][unit j][lane]
    w = list(w.unbind(0))
    for _ in range(Lc):
        v = torch.zeros_like(w[0])
        for s in range(S):
            b0, b1, b2, a1, a2 = co[s]
            w1, w2 = w[2 * s], w[2 * s + 1]
            fb = a1 * w1 + a2 * w2
            ff = b1 * w1 + b2 * w2
            w0 = v - fb
            v = b0 * w0 + ff
            w[2 * s], w[2 * s + 1] = w0, w1
    return torch.stack(w)


def iir_chunk_tables(sos_l: torch.Tensor, Lc: int = IIR_CHUNK
                     ) -> torch.Tensor:
    """Phi^Lc of every lane: (4 S^2, 2C) float32 on ``sos_l``'s device, row
    2S i + j holding entry (i, j) of the cascade's state transition over Lc
    rows with zero input, state order [w1_0, w2_0, w1_1, ...].  Column j is
    the plain recurrence (:func:`iir_bank_torch`'s order of operations) run
    in float64 from unit state j, rounded once to float32."""
    N = 2 * (sos_l.shape[0] // 5)
    return (_phi64(sos_l, Lc).reshape(N * N, -1).to(torch.float32)
            .to(sos_l.device).contiguous())


def iir_join_tables(sos_l: torch.Tensor, Lc: int = IIR_CHUNK
                    ) -> torch.Tensor:
    """The kernel's join tables: Phi^(Lc j) for j = 1 .. Q =
    :func:`join_span` (S), (Q 4 S^2, 2C) float32 on ``sos_l``'s device, row
    (j - 1) 4 S^2 + 2S r + c holding entry (r, c); powers of the float64
    Phi^Lc of :func:`iir_chunk_tables`, each rounded once to float32."""
    S = sos_l.shape[0] // 5
    N = 2 * S
    phi = _phi64(sos_l, Lc).permute(2, 0, 1)             # (lanes, N, N)
    powers, p = [], phi
    for _ in range(join_span(S)):
        powers.append(p.permute(1, 2, 0).reshape(N * N, -1))
        p = phi @ p
    return (torch.cat(powers).to(torch.float32).to(sos_l.device)
            .contiguous())


def _check(sos_l, state, x):
    if x.dim() != 2 or state.dim() != 2 or state.shape[1] != x.shape[1]:
        raise ValueError(f"x must be (T, C) and state (2S, C); got "
                         f"{tuple(x.shape)} and {tuple(state.shape)}")
    if state.shape[0] % 2 or tuple(sos_l.shape) != (
            5 * (state.shape[0] // 2), 2 * x.shape[1]):
        raise ValueError(f"coefficients {tuple(sos_l.shape)} do not match "
                         f"the state {tuple(state.shape)}")


def iir_bank_torch(sos_l: torch.Tensor, state: torch.Tensor,
                   x: torch.Tensor):
    """Plain version: (y (T, C) complex, new_state (2S, C)) from the lane
    coefficients of :func:`iir_bank_lanes`, in the dtype of x."""
    _check(sos_l, state, x)
    S = state.shape[0] // 2
    rdt = x.real.dtype
    co = sos_l.to(rdt).reshape(S, 5, -1)
    w = list(torch.view_as_real(state.to(x.dtype)).reshape(2 * S, -1
                                                           ).unbind(0))
    xs = torch.view_as_real(x).reshape(x.shape[0], -1)
    y = torch.empty_like(xs)
    for t in range(x.shape[0]):
        v = xs[t]
        for s in range(S):
            b0, b1, b2, a1, a2 = co[s]
            w1, w2 = w[2 * s], w[2 * s + 1]
            fb = a1 * w1 + a2 * w2
            ff = b1 * w1 + b2 * w2
            w0 = v - fb
            v = b0 * w0 + ff
            w[2 * s], w[2 * s + 1] = w0, w1
        y[t] = v
    new_state = torch.view_as_complex(
        torch.stack(w).reshape(2 * S, -1, 2).contiguous())
    return (torch.view_as_complex(y.reshape(x.shape[0], -1, 2)),
            new_state.to(state.dtype))


def iir_bank_cuda(sos_l: torch.Tensor, state: torch.Tensor,
                  x: torch.Tensor, tables: torch.Tensor | None = None):
    """Launch K6 (``csrc/iir_bank.cu``): (y (T, C) complex64, new_state).
    Takes contiguous complex64 x and state and float32 lane coefficients on
    one card, 1 <= S <= 8, and the join tables of :func:`iir_join_tables`
    at :data:`IIR_CHUNK` rows (built here, through the host, when
    ``tables`` is None); raises on anything else.  Adds one to
    ``iir_bank_cuda.launches`` (one call, up to three kernels)."""
    _check(sos_l, state, x)
    if not (x.is_cuda and state.device == x.device
            and sos_l.device == x.device):
        raise ValueError("iir_bank_cuda needs sos, state and x on one CUDA "
                         "device; CPU tensors take iir_bank_torch")
    if (x.dtype != torch.complex64 or state.dtype != torch.complex64
            or sos_l.dtype != torch.float32):
        raise TypeError("iir_bank_cuda takes complex64 x and state and "
                        "float32 coefficients")
    if not (x.is_contiguous() and state.is_contiguous()
            and sos_l.is_contiguous()):
        raise ValueError("iir_bank_cuda needs contiguous tensors")
    S = state.shape[0] // 2
    if not 1 <= S <= MAX_SECTIONS:
        raise ValueError(f"iir_bank_cuda takes 1 to {MAX_SECTIONS} "
                         f"sections, got {S}")
    if tables is None:
        tables = iir_join_tables(sos_l)
    want = (join_span(S) * 4 * S * S, sos_l.shape[1])
    if (tuple(tables.shape) != want or tables.dtype != torch.float32
            or tables.device != x.device or not tables.is_contiguous()):
        raise ValueError(f"join tables must be contiguous float32 {want} on "
                         f"the block's card")
    T, C = x.shape
    y = torch.empty((T, C), dtype=torch.complex64, device=x.device)
    new_state = torch.empty_like(state)
    n_chunks = max(1, -(-T // IIR_CHUNK))
    spans = -(-(n_chunks - 1) // join_span(S))
    ws = torch.empty((n_chunks - 1 + spans) * 2 * S * 2 * C,
                     dtype=torch.float32, device=x.device)
    fn = launcher("iir_bank.cu", "iir_bank_launch", _ARGS)
    check_launch(fn(x.data_ptr(), sos_l.data_ptr(), tables.data_ptr(),
                    state.data_ptr(), y.data_ptr(), new_state.data_ptr(),
                    ws.data_ptr(), T, C, S, IIR_CHUNK, join_span(S),
                    x.device.index, stream_of(x)), "iir_bank_cuda")
    iir_bank_cuda.launches += 1
    return y, new_state


iir_bank_cuda.launches = 0


class IirBank:
    """One cascade's constants on one device: the lane coefficients of
    :func:`iir_bank_lanes` and, on a card, the kernel's join tables, both
    built once.  ``sos`` is (S, 5) shared or (S, 5, C) per channel."""

    def __init__(self, sos, num_channels: int, device):
        self.sos = np.asarray(torch.as_tensor(sos).cpu(), dtype=np.float32)
        self.lanes = iir_bank_lanes(self.sos, num_channels, device)
        self.tables = (iir_join_tables(self.lanes) if self.lanes.is_cuda
                       else None)

    @property
    def nsections(self) -> int:
        return self.sos.shape[0]

    def __call__(self, state: torch.Tensor, x: torch.Tensor,
                 engine: str = "auto"):
        """(y (T, C), new_state) of x (T, C) complex from ``state``."""
        if use_kernel(engine, x):
            return iir_bank_cuda(self.lanes, state, x, self.tables)
        return iir_bank_torch(self.lanes, state, x)


def iir_bank_apply(sos, state: torch.Tensor, x: torch.Tensor,
                   engine: str = "auto"):
    """Run the cascade over x (T, C) complex from ``state`` (2S, C):
    returns (y (T, C), new_state).  ``sos`` is (S, 5) shared or (S, 5, C)
    per channel.  Builds the coefficients (and on a card the join tables)
    for this call: a caller with fixed coefficients keeps an
    :class:`IirBank` instead."""
    sos_l = iir_bank_lanes(sos, x.shape[-1], x.device)
    if use_kernel(engine, x):
        return iir_bank_cuda(sos_l, state, x)
    return iir_bank_torch(sos_l, state, x)
