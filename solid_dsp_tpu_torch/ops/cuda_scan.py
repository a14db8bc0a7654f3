"""The sequential scans on Hopper (S1, S2, S3): wrappers of
``csrc/seq_scan.cu``.

S1 is the exact per-sample AGC (``ops/agc.py::_agc_scan``, JAX
``ops/agc.py:108-149``) with a second entry point that runs the squelch FSM
alone over a given rssi track; S2 is the decision-directed QPSK Costas loop
(``models/qpsk.py::qpsk_carrier_pll``, JAX ``models/qpsk.py:101-126``); S3
is the IIR filters' direct-form-II w-recurrence (``ops/iir.py``'s
``"scan"`` method, JAX ``ops/iir.py:117-126``).  None replaces a TPU
kernel: in the JAX package each is a ``lax.scan``, and a per-sample
recurrence in eager torch ops would cost ~15-20 launches a sample.  One
thread walks one sequence in time order: a leading index for S1 and S2, a
lane (a trailing index; time runs along axis 0) for S3.  The source has the
design.

Each wrapper takes CUDA tensors only, checks types and shapes, launches the
kernel on the current stream, raises if the launch fails
(``cuda_build.check_launch``) and adds one to its ``launches`` count.  The
plain versions are ``ops/agc.py::agc_scan_plain`` and
``squelch_fsm_plain``, ``models/qpsk.py::costas_pll_plain`` and
``ops/iir.py::iir_scan_torch``; the dispatchers there take them for CPU
tensors only.  ``agc_scan_cuda.fallback_launches`` counts the S1 launches
made with ``fallback=True``, as ``agc_apply_parallel``'s fall-back makes
them (they count on ``launches`` too).
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import check_launch, launcher, stream_of

__all__ = ["agc_scan_cuda", "squelch_fsm_cuda", "costas_pll_cuda",
           "iir_scan_cuda"]

_P, _I, _LL, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_double
_AGC_ARGS = (_P,) * 7 + (_I, _LL) + (_D,) * 5 + (_I, _I, _P)
_FSM_ARGS = (_P,) * 4 + (_I, _LL, _D, _I, _I, _P)
_PLL_ARGS = (_P,) * 4 + (_I, _LL) + (_D,) * 3 + (_I, _P)
_S3_ARGS = (_P,) * 4 + (_I, _LL, _I, _I, _P)
_S3_SUFFIX = {torch.float32: "f32", torch.float64: "f64",
              torch.complex64: "c64", torch.complex128: "c128"}
_SUFFIX = {torch.complex64: "f32", torch.complex128: "f64",
           torch.float32: "f32", torch.float64: "f64"}
_REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}


def _check(x: torch.Tensor, name: str, complex_in: bool = True):
    if not x.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors; CPU tensors take the "
                         "plain version")
    ok = (torch.complex64, torch.complex128) if complex_in else (
        torch.float32, torch.float64)
    if x.dtype not in ok:
        raise TypeError(f"{name} takes {ok}, got {x.dtype}")
    if x.dim() == 0 or x.shape[-1] == 0:
        raise ValueError(f"{name} needs a non-empty time axis")


def _rows(t: torch.Tensor, lead: tuple, dtype, device) -> torch.Tensor:
    """A state leaf as a contiguous (B,) tensor of ``dtype`` (broadcast to
    the block's leading shape), a copy the kernel updates in place."""
    return (t.to(device=device, dtype=dtype).expand(lead).reshape(-1)
            .clone(memory_format=torch.contiguous_format))


def agc_scan_cuda(state: dict, x: torch.Tensor, c1: float, c2: float,
                  c3: float, scale: float, thr: float, timeout: int,
                  fallback: bool = False):
    """S1 over x (..., T) complex64 or complex128 on one card, each leading
    index its own carry: (y, new_state).  ``c1, c2, c3`` are the update's
    constants (1 - alpha, alpha, -alpha / 2) in the working real type, as
    ``ops/agc.py::agc_scan_consts`` makes them; ``scale`` is real.
    ``fallback``: the launch is a fall-back of the Newton solve (counted on
    ``fallback_launches`` as well)."""
    _check(x, "agc_scan_cuda")
    rdt = _REAL[x.dtype]
    lead = tuple(x.shape[:-1])
    T = int(x.shape[-1])
    B = max(1, int(torch.Size(lead).numel()))
    xc = x.contiguous()
    y = torch.empty_like(xc)
    gain = _rows(state["gain"], lead, rdt, x.device)
    energy = _rows(state["energy"], lead, rdt, x.device)
    lock = _rows(state["lock"], lead, torch.uint8, x.device)
    mode = _rows(state["mode"], lead, torch.int32, x.device)
    timer = _rows(state["timer"], lead, torch.int32, x.device)
    fn = launcher("seq_scan.cu", f"agc_scan_{_SUFFIX[x.dtype]}", _AGC_ARGS)
    check_launch(fn(xc.data_ptr(), y.data_ptr(), gain.data_ptr(),
                    energy.data_ptr(), lock.data_ptr(), mode.data_ptr(),
                    timer.data_ptr(), B, T, float(c1), float(c2), float(c3),
                    float(scale), float(thr), int(timeout), x.device.index,
                    stream_of(x)), "agc_scan_cuda")
    agc_scan_cuda.launches += 1
    if fallback:
        agc_scan_cuda.fallback_launches += 1
    out_state = {"gain": gain.reshape(lead).to(state["gain"].dtype),
                 "energy": energy.reshape(lead).to(state["energy"].dtype),
                 "lock": state["lock"].to(x.device).expand(lead).clone(),
                 "mode": mode.reshape(lead), "timer": timer.reshape(lead)}
    return y, out_state


agc_scan_cuda.launches = 0
agc_scan_cuda.fallback_launches = 0


def squelch_fsm_cuda(rssi: torch.Tensor, mode: torch.Tensor,
                     timer: torch.Tensor, thr: float, timeout: int):
    """S1's FSM alone over rssi (..., T) float32 or float64 on one card:
    (modes (..., T) int32, final mode, final timer)."""
    _check(rssi, "squelch_fsm_cuda", complex_in=False)
    lead = tuple(rssi.shape[:-1])
    T = int(rssi.shape[-1])
    B = max(1, int(torch.Size(lead).numel()))
    rs = rssi.contiguous()
    modes = torch.empty(rs.shape, dtype=torch.int32, device=rs.device)
    m = _rows(mode, lead, torch.int32, rs.device)
    t = _rows(timer, lead, torch.int32, rs.device)
    fn = launcher("seq_scan.cu", f"squelch_fsm_{_SUFFIX[rs.dtype]}",
                  _FSM_ARGS)
    check_launch(fn(rs.data_ptr(), modes.data_ptr(), m.data_ptr(),
                    t.data_ptr(), B, T, float(thr), int(timeout),
                    rs.device.index, stream_of(rs)), "squelch_fsm_cuda")
    squelch_fsm_cuda.launches += 1
    return modes, m.reshape(lead), t.reshape(lead)


squelch_fsm_cuda.launches = 0


def costas_pll_cuda(x: torch.Tensor, alpha: float, beta: float, h: float,
                    theta0: torch.Tensor, dtheta0: torch.Tensor):
    """S2 over x (..., T) complex64 or complex128 on one card, each leading
    index its own loop: (y, theta_end, dtheta_end).  ``alpha``, ``beta``
    and the constellation's half-side ``h`` are rounded to the working real
    type by the kernel."""
    _check(x, "costas_pll_cuda")
    rdt = _REAL[x.dtype]
    lead = tuple(x.shape[:-1])
    T = int(x.shape[-1])
    B = max(1, int(torch.Size(lead).numel()))
    xc = x.contiguous()
    y = torch.empty_like(xc)
    th = _rows(theta0, lead, rdt, x.device)
    dth = _rows(dtheta0, lead, rdt, x.device)
    fn = launcher("seq_scan.cu", f"costas_pll_{_SUFFIX[x.dtype]}", _PLL_ARGS)
    check_launch(fn(xc.data_ptr(), y.data_ptr(), th.data_ptr(),
                    dth.data_ptr(), B, T, float(alpha), float(beta), float(h),
                    x.device.index, stream_of(x)), "costas_pll_cuda")
    costas_pll_cuda.launches += 1
    return y, th.reshape(lead), dth.reshape(lead)


costas_pll_cuda.launches = 0


def iir_scan_cuda(a_tail: torch.Tensor, w_state: torch.Tensor,
                  x: torch.Tensor):
    """S3 over x (T, *lanes) on one card, float32, float64, complex64 or
    complex128: w[n] = x[n] - sum_i a_tail[i] w[n-1-i] for each lane, the
    history ``w_state`` (*lanes, k) = [w[-1], ..., w[-k]] carried in.
    ``a_tail`` (k,), k >= 1, is rounded to x's dtype.  Returns (w (T,
    *lanes), new w_state (*lanes, k)), in x's dtype.  An empty block
    launches nothing."""
    if not x.is_cuda:
        raise ValueError("iir_scan_cuda needs CUDA tensors; CPU tensors take "
                         "the plain version")
    if x.dtype not in _S3_SUFFIX:
        raise TypeError(f"iir_scan_cuda takes {tuple(_S3_SUFFIX)}, got "
                        f"{x.dtype}")
    if x.dim() == 0:
        raise ValueError("iir_scan_cuda needs a time axis (axis 0)")
    k = int(a_tail.shape[-1])
    if a_tail.dim() != 1 or k < 1:
        raise ValueError("iir_scan_cuda takes a_tail of shape (k,), k >= 1")
    lanes = tuple(x.shape[1:])
    T = int(x.shape[0])
    B = max(1, int(torch.Size(lanes).numel()))
    state = (w_state.to(device=x.device, dtype=x.dtype)
             .expand(*lanes, k).reshape(B, k)
             .clone(memory_format=torch.contiguous_format))
    if T == 0:
        return x.clone(), state.reshape(*lanes, k)
    xc = x.contiguous()
    w = torch.empty_like(xc)
    a = a_tail.to(device=x.device, dtype=x.dtype).contiguous()
    fn = launcher("seq_scan.cu", f"iir_scan_{_S3_SUFFIX[x.dtype]}", _S3_ARGS)
    check_launch(fn(xc.data_ptr(), w.data_ptr(), state.data_ptr(),
                    a.data_ptr(), B, T, k, x.device.index, stream_of(x)),
                 "iir_scan_cuda")
    iir_scan_cuda.launches += 1
    return w, state.reshape(*lanes, k)


iir_scan_cuda.launches = 0
