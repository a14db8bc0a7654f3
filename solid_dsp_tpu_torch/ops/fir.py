"""Block FIR filtering: plain, decimating, interpolating, polyphase bank and
the rational resampler.

Port of ``solid_dsp_tpu/ops/fir.py`` (reference ``src/filter/fir/``).  With
taps c[0..N) the reference's output is the sliding correlation
y[t] = sum_i c[i] x_ext[t + i] over x_ext = [tail | x_block], the tail being
the last N - 1 inputs.  Everything here is XLA-level in JAX and torch ops
here (no kernel): ``conv1d_mxu`` is a ``torch.nn.functional.conv1d``,
``fir_toeplitz`` the banded-Toeplitz product as ``torch.matmul`` over banks
built on the host, the "fft" method an overlap-save ``torch.fft`` on fixed
power-of-two tiles.  The products run in full float32 (``fp32_exact``)
unless the caller asks for ``precision="default"``, which rounds both
operands to bf16 first (the JAX package's single-pass bf16).

Where the JAX package takes the banded-Toeplitz form instead of a
convolution (``_use_toeplitz``: on its TPU, whose convolution lowering is
slow), the port takes it for CUDA tensors from ``CARD_TOEPLITZ_MIN_TAPS``
taps up, where the card measured it faster; CPU tensors take the
convolution, as the JAX package does on its CPU.
"""

from __future__ import annotations

import functools
import time
from math import gcd

import numpy as np
import torch

from ..analysis.freq_response import fir_frequency_response
from ..analysis.group_delay import fir_group_delay
from ..device import device_constant, fp32_exact, resolve_device
from ..streaming.framing import extend_with_tail, split_tail

__all__ = ["fir_init", "conv1d_mxu", "fir_toeplitz", "fir_apply",
           "fir_decim_apply", "fir_interp_apply", "pfb_branch_matrix",
           "pfb_apply_all", "FIRFilter", "DecimatingFIRFilter",
           "InterpolatingFIRFilter", "PolyPhaseFilterBank",
           "RationalResampler"]

# The card's route by tap count, from ``torch_kernel_sweep.py fir-route``
# (complex64, strides 1-8, 2^18-2^24 samples, one and three outputs a
# sample; PERF.md): conv1d (cuDNN) is faster up to 24 taps, the
# banded-Toeplitz matmul from 32 taps up (0.32-0.98 of conv1d's time).
CARD_TOEPLITZ_MIN_TAPS = 32


def fir_init(ntaps: int, dtype=torch.complex64, batch_shape: tuple = (),
             device=None) -> torch.Tensor:
    """Zero tail of length ntaps - 1 (the reference's zeroed Window), on
    ``device``: the card unless told otherwise."""
    return torch.zeros((*batch_shape, max(ntaps - 1, 0)), dtype=dtype,
                       device=resolve_device(device))


def conv1d_mxu(x: torch.Tensor, taps: torch.Tensor, stride: int = 1,
               precision=None) -> torch.Tensor:
    """Strided sliding correlation
    ``y[..., t(, o)] = sum_i taps[i(, o)] * x[..., t*stride + i]`` for
    taps (n,) or (n, O), over the valid outputs only.

    Complex data or taps run as a 2-channel real convolution, out_re =
    xr*kr - xi*ki and out_im = xr*ki + xi*kr, as in JAX.  ``precision``:
    None or "highest" computes in the working float type: the convolution
    runs under :func:`~solid_dsp_tpu_torch.device.fp32_exact`, so cuDNN's
    TF32 stays off whatever the caller set; "default" rounds both operands
    to bf16 first, the single-pass bf16 the JAX package names so.
    """
    if precision not in (None, "highest", "default"):
        raise ValueError(f"unknown precision {precision!r}")
    vec = taps.dim() == 1
    taps2 = taps[:, None] if vec else taps
    n, O = taps2.shape
    lead = x.shape[:-1]
    L = x.shape[-1]
    T = (L - n) // stride + 1
    cplx = x.is_complex() or taps2.is_complex()
    if cplx:
        cd = torch.promote_types(torch.promote_types(x.dtype, taps2.dtype),
                                 torch.complex64)
    if T <= 0:                   # no valid output: empty, as in JAX
        return x.new_zeros((*lead, 0) if vec else (*lead, 0, O),
                           dtype=cd if cplx else x.dtype)
    if cplx:
        xb = torch.view_as_real(
            x.reshape(-1, L).to(cd).resolve_conj()).transpose(1, 2)
        k = taps2.to(cd)
        kr, ki = k.real.T, k.imag.T                           # (O, n)
        w = torch.cat([torch.stack([kr, -ki], dim=1),
                       torch.stack([ki, kr], dim=1)])         # (2O, 2, n)
    else:
        xb = x.reshape(-1, 1, L)
        w = taps2.to(x.dtype).T[:, None, :]                   # (O, 1, n)
    if precision == "default":
        xb = xb.to(torch.bfloat16).to(xb.dtype)
        w = w.to(torch.bfloat16).to(w.dtype)
    with fp32_exact():
        y = torch.nn.functional.conv1d(xb.contiguous(), w.contiguous(),
                                       stride=stride)         # (B, C_out, T)
    if cplx:
        y = torch.complex(y[:, :O], y[:, O:])
    y = y.transpose(1, 2).reshape(*lead, T, O)
    return y[..., 0] if vec else y


def _banks_np(taps2: np.ndarray, P: int, stride: int):
    """Body (hop, P*O) and head (n-1, P*O) rows of the banded-Toeplitz bank
    H[j, p*O + o] = taps2[j - p*stride, o], hop = P*stride: output p of a
    frame reads frame-local input rows [p*stride, p*stride + n)."""
    n, O = taps2.shape
    hop = P * stride
    H = np.zeros((hop + n - 1, P * O), taps2.dtype)
    for p in range(P):
        H[p * stride : p * stride + n, p * O : (p + 1) * O] = taps2
    return H[:hop], H[hop:]


def _bank_rem_np(taps2: np.ndarray, Tr: int, stride: int):
    """Bank (width_r, Tr*O) of Tr outputs over the (Tr-1)*stride + n input
    samples they read: the head and straggler pieces of a block."""
    n, O = taps2.shape
    wr = (Tr - 1) * stride + n
    H = np.zeros((wr, Tr * O), taps2.dtype)
    for p in range(Tr):
        H[p * stride : p * stride + n, p * O : (p + 1) * O] = taps2
    return H


def _resolve_precision(precision) -> str:
    """The product's precision: "highest" (None, "highest" and "x3": full
    float32 on this card, x3's contract being ~f32 accuracy) or "default"
    (both operands rounded to bf16 first)."""
    if precision in (None, "highest", "x3"):
        return "highest"
    if precision == "default":
        return "default"
    raise ValueError(f"unknown precision {precision!r}")


def _auto_block(n: int, stride: int, O: int, T: int) -> int:
    """Outputs per frame P of the banded-Toeplitz product: the output tile
    (P*O >= ~128 columns) against the band's redundant MACs, which grow
    with P*stride (the JAX package's rule, kept as it is)."""
    floor_p = max(-(-max(n - 1, 1) // stride), 1)   # heads need n-1 <= hop
    tile = max(128 // max(O, 1), 8)
    redundancy_cap = max((4 * n) // stride, 8)
    return max(floor_p, min(tile, redundancy_cap, max(T, 1)))


@functools.lru_cache(maxsize=64)
def _bank_cached(kind: str, data: bytes, np_dtype: str, shape: tuple, P: int,
                 stride: int, dtype, device: str) -> tuple:
    taps2 = np.frombuffer(data, dtype=np.dtype(np_dtype)).reshape(shape)
    banks = (_banks_np(taps2, P, stride) if kind == "frame"
             else (_bank_rem_np(taps2, P, stride),))
    return tuple(torch.from_numpy(np.ascontiguousarray(b)).to(
        device=device, dtype=dtype) for b in banks)


def _bank_t(kind: str, taps2: np.ndarray, P: int, stride: int,
            dtype: torch.dtype, device) -> tuple:
    """The host-built banks as tensors of ``dtype`` on ``device``, built
    once per contents: ("frame", ...) -> (body, heads), ("rem", ...) ->
    (bank,)."""
    a = np.ascontiguousarray(taps2)
    return _bank_cached(kind, a.tobytes(), a.dtype.str, a.shape, P, stride,
                        dtype, str(device))


def _mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "default":
        a = a.to(torch.bfloat16).to(a.dtype)
        b = b.to(torch.bfloat16).to(b.dtype)
    with fp32_exact():
        return torch.matmul(a, b)


def _toep_real(xb: torch.Tensor, taps2: np.ndarray, P: int, stride: int,
               T: int, prec: str) -> torch.Tensor:
    """Real banded-Toeplitz core: xb (B, L) real, taps2 (n, O) real numpy;
    y (B, T, O) with y[b, t, o] = sum_i taps2[i, o] xb[b, t*stride + i].

    Bodies are a reshape of xb (no window matrix), heads one small shifted
    reshape, and the last partial frame its own small product."""
    n, O = taps2.shape
    B, L = xb.shape
    n1 = n - 1
    hop = P * stride
    Ff = min(max((L - n1) // hop, 0) if hop > 0 else 0, T // P)
    pieces = []
    if Ff > 0:
        Hb, Hh = _bank_t("frame", taps2, P, stride, xb.dtype, xb.device)
        ym = _mm(xb[:, : Ff * hop].reshape(B, Ff, hop), Hb, prec)
        if n1 > 0:
            if Ff > 1:
                heads = xb[:, hop: Ff * hop].reshape(B, Ff - 1, hop)[..., :n1]
                last = xb[:, Ff * hop: Ff * hop + n1].reshape(B, 1, n1)
                heads = torch.cat([heads, last], dim=1)
            else:
                heads = xb[:, hop: hop + n1].reshape(B, 1, n1)
            ym = ym + _mm(heads, Hh, prec)
        pieces.append(ym.reshape(B, Ff * P, O))
    Tr = T - Ff * P
    if Tr > 0:
        start = Ff * hop
        wr = (Tr - 1) * stride + n
        (Hr,) = _bank_t("rem", taps2, Tr, stride, xb.dtype, xb.device)
        pieces.append(_mm(xb[:, start: start + wr], Hr, prec
                          ).reshape(B, Tr, O))
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=1)


def _host_taps(taps) -> np.ndarray:
    return (taps.detach().cpu().numpy() if isinstance(taps, torch.Tensor)
            else np.asarray(taps))


def fir_toeplitz(x: torch.Tensor, taps, stride: int = 1, precision=None,
                 block: int | None = None) -> torch.Tensor:
    """Strided sliding correlation as banded-Toeplitz matmuls: the contract
    of :func:`conv1d_mxu` (y[..., t(, o)] = sum_i taps[i(, o)] *
    x[..., t*stride + i]), computed by ``torch.matmul`` over overlap-save
    frames against banks built on the host from ``taps`` (numpy, or a
    tensor copied to the host once per call).

    Complex data run as real planes; complex taps as two real banks (real
    and imaginary taps).  ``block``: outputs per frame (auto:
    :func:`_auto_block`); ``precision``: "highest" | "x3" | "default".
    """
    tn = _host_taps(taps)
    vec = tn.ndim == 1
    taps2 = tn[:, None] if vec else tn
    n, O = taps2.shape
    lead = x.shape[:-1]
    L = x.shape[-1]
    T = (L - n) // stride + 1
    if T <= 0:
        raise ValueError("signal shorter than the filter")
    P = (max(min(block, T), -(-max(n - 1, 1) // stride), 1) if block
         else _auto_block(n, stride, O, T))
    prec = _resolve_precision(precision)
    xb = x.reshape(-1, L)
    B = xb.shape[0]
    ck = np.iscomplexobj(taps2)
    t_dt = torch.from_numpy(taps2[:0].copy()).dtype
    if x.is_complex() or ck:
        cd = torch.promote_types(torch.promote_types(x.dtype, t_dt),
                                 torch.complex64)
    if ck:
        t_re, t_im = taps2.real.copy(), taps2.imag.copy()
    if x.is_complex():
        xc = xb.to(cd)
        planes = torch.cat([xc.real, xc.imag], dim=0)        # (2B, L)
        if ck:
            yr = _toep_real(planes, t_re, P, stride, T, prec
                            ).reshape(2, B, T, O)
            yi = _toep_real(planes, t_im, P, stride, T, prec
                            ).reshape(2, B, T, O)
            out = torch.complex(yr[0] - yi[1], yi[0] + yr[1])
        else:
            y = _toep_real(planes, taps2, P, stride, T, prec
                           ).reshape(2, B, T, O)
            out = torch.complex(y[0], y[1])
        out = out.to(cd)
    elif ck:
        xr = xb.to(torch.empty(0, dtype=cd).real.dtype)
        out = torch.complex(_toep_real(xr, t_re, P, stride, T, prec),
                            _toep_real(xr, t_im, P, stride, T, prec)).to(cd)
    else:
        out = _toep_real(xb, taps2, P, stride, T, prec)
    out = out.reshape(*lead, T, O)
    return out[..., 0] if vec else out


def _use_toeplitz(x: torch.Tensor, ntaps: int) -> bool:
    """The banded-Toeplitz form for CUDA tensors with at least
    ``CARD_TOEPLITZ_MIN_TAPS`` taps, where the card measured it faster;
    the convolution otherwise."""
    return x.is_cuda and ntaps >= CARD_TOEPLITZ_MIN_TAPS


def _taps_on(taps, x: torch.Tensor) -> torch.Tensor:
    """Taps as a tensor on x's device (numpy taps copied once)."""
    if isinstance(taps, torch.Tensor):
        return taps.to(x.device)
    return device_constant(taps, x.device)


def _correlate(x: torch.Tensor, taps, stride: int = 1, precision=None):
    """The sliding correlation by the route :func:`_use_toeplitz` picks.
    The Toeplitz route builds its banks from host taps: the port's callers
    pass numpy taps (the classes keep a host copy), since a tensor there
    costs a copy to the host and a wait for the card each call."""
    n = int(taps.shape[0])
    # fir_toeplitz refuses a block with no valid output, as JAX's does;
    # the route returns it empty, as conv1d_mxu does (P3)
    if _use_toeplitz(x, n) and x.shape[-1] >= n:
        return fir_toeplitz(x, taps, stride=stride, precision=precision)
    return conv1d_mxu(x, _taps_on(taps, x), stride=stride,
                      precision=_resolve_precision(precision))


def _fir_tile_nfft(ntaps: int, ext_len: int) -> int:
    """Tile of the segmented overlap-save: the smallest power of two
    covering 4x the kernel, at least 512, at most the whole block's."""
    whole = 1 << int(np.ceil(np.log2(max(ext_len, 2))))
    tile = max(512, 1 << int(np.ceil(np.log2(max(4 * ntaps, 2)))))
    return min(whole, tile)


def _fir_block_fft(taps: torch.Tensor, x_ext: torch.Tensor) -> torch.Tensor:
    """Segmented overlap-save convolution: the block cut into fixed
    power-of-two tiles of ``nfft`` with ntaps - 1 overlap, the tiles
    transformed as one batch."""
    n = taps.shape[-1]
    ext = x_ext.shape[-1]
    L = ext - (n - 1)
    if L <= 0:
        # F6: the JAX package's overlap-save raises on an empty block
        # (solid_dsp_tpu/ops/fir.py::_fir_block_fft); the port returns the
        # empty output, as the other routes do
        return conv1d_mxu(x_ext, taps)
    nfft = _fir_tile_nfft(int(n), int(ext))
    S = nfft - (n - 1)
    F = -(-L // S)
    batch = x_ext.shape[:-1]
    xp = torch.nn.functional.pad(x_ext, (0, F * S + (n - 1) - ext))
    bodies = xp[..., : F * S].reshape(*batch, F, S)
    if n > 1:
        if F > 1:
            heads = xp[..., S: S + (F - 1) * S].reshape(
                *batch, F - 1, S)[..., : n - 1]
            last = xp[..., F * S: F * S + (n - 1)].reshape(*batch, 1, n - 1)
            heads = torch.cat([heads, last], dim=-2)
        else:
            heads = xp[..., S: S + (n - 1)].reshape(*batch, 1, n - 1)
        frames = torch.cat([bodies, heads], dim=-1)
    else:
        frames = bodies
    kernel = torch.flip(taps, dims=(-1,))
    cd = torch.promote_types(torch.promote_types(x_ext.dtype, kernel.dtype),
                             torch.complex64)
    X = torch.fft.fft(frames.to(cd), n=nfft, dim=-1)
    H = torch.fft.fft(kernel.to(cd), n=nfft, dim=-1)
    y = torch.fft.ifft(X * H, dim=-1)[..., n - 1:].reshape(*batch, F * S)
    y = y[..., :L]
    if not x_ext.is_complex() and not taps.is_complex():
        y = y.real.to(x_ext.dtype)
    return y


def _pick_method(method: str, ntaps: int, block: int,
                 device: torch.device) -> str:
    """Resolve "auto": on the card "matmul" up to 384 taps and "measure"
    above (the JAX package's accelerator rule, ``ops/fir.py:419-433``); on
    the CPU the JAX package's CPU rule, "fft" once ntaps exceeds
    2 log2(block) + 8, so that the CPU tests take JAX's method."""
    if method != "auto":
        return method
    if device.type == "cuda":
        return "matmul" if ntaps <= 384 else "measure"
    return "fft" if ntaps > 2 * int(np.log2(max(block, 2))) + 8 else "matmul"


def _fir_apply_method(taps, host, tail, x, scale, method: str):
    """One block by ``method``: ``taps`` on x's device, ``host`` the same
    taps as numpy (None when the caller gave a tensor)."""
    x_ext = extend_with_tail(tail, x)
    if method == "fft":
        y = _fir_block_fft(taps, x_ext)
    elif method == "matmul":
        y = _correlate(x_ext, taps if host is None else host)
    else:
        raise ValueError(f"unknown FIR method {method!r}")
    return y * scale, split_tail(x_ext, taps.shape[-1] - 1)


_METHOD_CACHE: dict = {}


def _measured_method(taps, host, tail, x, scale) -> str:
    """Time "matmul" and "fft" once each (3 calls after a warm-up; CUDA
    events on the card, the host clock on the CPU) and cache the winner by
    (ntaps, block, dtype, device type)."""
    key = (int(taps.shape[-1]), int(x.shape[-1]), str(x.dtype),
           x.device.type)
    m = _METHOD_CACHE.get(key)
    if m is None:
        results = {}
        for cand in ("matmul", "fft"):
            _fir_apply_method(taps, host, tail, x, scale, cand)
            if x.is_cuda:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
            t0 = time.perf_counter()
            for _ in range(3):
                _fir_apply_method(taps, host, tail, x, scale, cand)
            if x.is_cuda:
                e1.record()
                e1.synchronize()
                results[cand] = e0.elapsed_time(e1)
            else:
                results[cand] = time.perf_counter() - t0
        m = _METHOD_CACHE[key] = min(results, key=results.get)
    return m


def fir_apply(taps, tail, x, scale=1.0, method: str = "auto"):
    """One FIR block: (y, new_tail), y[t] = scale * sum_i taps[i] *
    x_ext[t + i].  ``method``: "auto" | "matmul" | "fft" | "measure" (time
    both once, cache the winner); "auto" as :func:`_pick_method`.  Numpy
    ``taps`` spare the card's matmul route a copy to the host a block."""
    host = None if isinstance(taps, torch.Tensor) else np.asarray(taps)
    taps = _taps_on(taps, x)
    m = _pick_method(method, int(taps.shape[-1]), int(x.shape[-1]),
                     x.device)
    if m == "measure":
        m = _measured_method(taps, host, tail, x, scale)
    return _fir_apply_method(taps, host, tail, x, scale, m)


def _phase_window(x_ext: torch.Tensor, first: torch.Tensor,
                  width: int) -> torch.Tensor:
    """x_ext[..., first : first + width] for a device tensor ``first`` in
    [0, len - width]: the overlapping windows as a view, one row copied, so
    the host never reads the phase."""
    return x_ext.unfold(-1, width, 1).index_select(
        -2, first.reshape(1)).squeeze(-2)


def fir_decim_apply(taps, tail, phase, x, scale, decimation: int,
                    precision: str | None = None):
    """Decimating FIR block; the block length must be a multiple of
    ``decimation``.  The reference's counter: an output is emitted when
    (phase + k + 1) % M == 0 for the k-th sample of the block.  ``phase``
    is an int or an int32 tensor; a tensor on the card stays there (the
    strided product's window is selected on the device), so a chain block
    makes no host sync.  Returns (y, new_tail, new_phase), len(y) =
    len(x) // M, new_phase of the type ``phase`` came in."""
    L = x.shape[-1]
    M = int(decimation)
    if L % M != 0:
        raise ValueError("block length must be a multiple of the decimation")
    x_ext = extend_with_tail(tail, x)
    n = int(taps.shape[-1])
    T = L // M
    width = max((T - 1) * M + n, 0)
    if isinstance(phase, torch.Tensor) and phase.device.type != "cpu":
        ph = phase.to(torch.int64)
        x_sub = _phase_window(x_ext, (M - 1 - ph) % M, width)
        new_phase = ((ph + L) % M).to(phase.dtype)
    else:
        ph = int(phase)
        first = (M - 1 - ph) % M
        x_sub = x_ext[..., first: first + width]
        new_phase = (ph + L) % M
        if isinstance(phase, torch.Tensor):
            new_phase = torch.full_like(phase, new_phase)
    y = _correlate(x_sub, taps, stride=M, precision=precision) * scale
    return y, split_tail(x_ext, n - 1), new_phase


def pfb_branch_matrix(coefficients, branches: int,
                      device=None) -> torch.Tensor:
    """(sub_len, branches) matrix B[m, f] = c[f + m*branches] on ``device``
    (the card unless told otherwise): every branch of the reference's PFB
    in one multi-output correlation."""
    c = np.asarray(coefficients)
    sub_len = len(c) // branches
    return torch.from_numpy(c[: sub_len * branches].reshape(
        sub_len, branches).copy()).to(resolve_device(device))


def pfb_apply_all(branch_matrix, tail, x):
    """Every branch for each input sample: (out (..., T, branches),
    new_tail), out[t, f] = sum_m B[m, f] x_ext[t + m].  ``branch_matrix``
    is a tensor or, sparing the card's matmul route a copy to the host, a
    numpy array."""
    sub_len = branch_matrix.shape[0]
    x_ext = extend_with_tail(tail, x)
    return _correlate(x_ext, branch_matrix), split_tail(x_ext, sub_len - 1)


def fir_interp_apply(branch_matrix, tail, x, scale=1.0):
    """Interpolating FIR block (zero-stuffing polyphase): each input sample
    emits the P branch outputs in branch order.  Returns (y, new_tail),
    len(y) = P * len(x).  The default scale is 1, as the reference PFB's
    stored scale is never applied."""
    out, new_tail = pfb_apply_all(branch_matrix, tail, x)
    y = out.reshape(*out.shape[:-2], out.shape[-2] * out.shape[-1])
    return y * scale, new_tail


# ---------------------------------------------------------------------------
# stateful wrappers (the reference's API shape)
# ---------------------------------------------------------------------------

def _ingest(samples, device) -> torch.Tensor:
    """A block as a tensor on ``device``; numpy and Python values keep
    numpy's types (a Python complex is complex128)."""
    if isinstance(samples, torch.Tensor):
        return samples.to(device)
    return torch.from_numpy(np.array(samples, copy=True)).to(device)


def _widen(tail: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The tail in the type tail and block promote to."""
    return tail.to(torch.promote_types(tail.dtype, x.dtype))


class FIRFilter:
    """Streaming FIR filter with the reference's API shape, on ``device``
    (the card unless told otherwise).  ``coefficients()`` returns the
    REVERSED tap order (the reference reports its DotProduct's reversed
    storage), and the frequency response, group delay and Firdes-trait
    metrics are taken on that order, as in the reference."""

    def __init__(self, coefficients, scale=1.0, dtype=None,
                 method: str = "auto", device=None):
        c = np.asarray(coefficients)
        if c.size == 0:
            raise ValueError("coefficients length zero")
        self.device = resolve_device(device)
        self._taps = torch.from_numpy(c.copy()).to(self.device)
        if dtype is not None:
            self._taps = self._taps.to(dtype)
        self._taps_np = self._taps.cpu().numpy()     # the product's banks
        self.scale = scale
        self.method = method
        self._tail = fir_init(len(c), self._taps.dtype, device=self.device)

    def __len__(self) -> int:
        return int(self._taps.shape[-1])

    def is_empty(self) -> bool:
        return len(self) == 0

    def coefficients(self) -> np.ndarray:
        return self._taps_np[::-1].copy()

    def set_scale(self, scale) -> None:
        self.scale = scale

    def get_scale(self):
        return self.scale

    def autocorrelation(self, lag: int) -> float:
        from ..design import firdes

        return firdes.filter_autocorrelation(self.coefficients(), lag)

    def crosscorrelation(self, rhs: "FIRFilter", lag: int) -> float:
        from ..design import firdes

        return firdes.filter_crosscorrelation(
            self.coefficients(), rhs.coefficients(), lag)

    def isi(self, samples_per_symbol: int, delay: int) -> tuple:
        from ..design import firdes

        return firdes.filter_isi(self.coefficients(), samples_per_symbol,
                                 delay)

    def energy(self, cutoff_frequency: float, fft_size: int) -> float:
        from ..design import firdes

        try:
            return firdes.filter_energy(self.coefficients(),
                                        cutoff_frequency, fft_size)
        except ValueError:
            return 0.0      # the reference swallows the error

    def reset(self) -> None:
        self._tail = fir_init(len(self), self._taps.dtype,
                              device=self.device)

    @property
    def state(self):
        return self._tail

    @state.setter
    def state(self, tail):
        self._tail = tail

    def execute(self, sample):
        return self.execute_block(np.asarray([sample]))

    def execute_block(self, samples):
        samples = _ingest(samples, self.device)
        self._tail = _widen(self._tail, samples)
        y, self._tail = fir_apply(self._taps_np, self._tail, samples,
                                  self.scale, self.method)
        return y

    def frequency_response(self, frequency: float) -> complex:
        return fir_frequency_response(self.coefficients(), frequency,
                                      self.scale)

    def group_delay(self, frequency: float) -> float:
        return fir_group_delay(self.coefficients(), frequency)

    def __repr__(self) -> str:
        dt = str(self._taps.dtype).replace("torch.", "")
        return (f"FIR<{dt}> [Scale={self.scale:.5f}] "
                f"[Coefficients=DotProduct [Size={len(self)}]]")


class DecimatingFIRFilter(FIRFilter):
    """FIR that emits one of every ``decimation`` outputs (the reference's
    counter; ``execute`` pushes one sample at a time)."""

    def __init__(self, coefficients, scale=1.0, decimation: int = 1,
                 dtype=None, device=None):
        if decimation < 1:
            raise ValueError("decimation less than one")
        super().__init__(coefficients, scale, dtype, device=device)
        self.decimation = int(decimation)
        self._phase = 0

    def get_decimation(self) -> int:
        return self.decimation

    def execute(self, sample):
        """Push one sample; the filtered value on every ``decimation``-th
        push, else an empty block (the product runs only on that push)."""
        x = _ingest(np.asarray([sample]), self.device)
        self._tail = _widen(self._tail, x)
        if (self._phase + 1) % self.decimation == 0:
            y, self._tail = fir_apply(self._taps_np, self._tail, x,
                                      self.scale, method="matmul")
        else:
            self._tail = torch.cat([self._tail, x.to(self._tail.dtype)],
                                   dim=-1)[..., 1:]
            y = x[:0]
        self._phase = (self._phase + 1) % self.decimation
        return y

    def execute_block(self, samples):
        samples = _ingest(samples, self.device)
        self._tail = _widen(self._tail, samples)
        if int(samples.shape[-1]) % self.decimation:
            raise ValueError(
                "block length must be a multiple of the decimation; stage "
                "ragged blocks in a ring buffer")
        y, self._tail, self._phase = fir_decim_apply(
            self._taps_np, self._tail, self._phase, samples, self.scale,
            self.decimation)
        return y


class PolyPhaseFilterBank:
    """Polyphase filter bank over a shared input window, on ``device`` (the
    card unless told otherwise).  ``execute(i)`` gives one branch,
    ``execute_all`` every branch for the current window, ``push_block``
    every branch for each sample of a block."""

    def __init__(self, coefficients, filters: int, scale=1.0, dtype=None,
                 device=None):
        if filters == 0:
            raise ValueError("not enough filters")
        c = np.asarray(coefficients)
        if c.size == 0:
            raise ValueError("coefficients length zero")
        self.device = resolve_device(device)
        self.branches = int(filters)
        self._B = pfb_branch_matrix(c, filters, self.device)
        if dtype is not None:
            self._B = self._B.to(dtype)
        self._B_np = self._B.cpu().numpy()          # the product's banks
        self.scale = scale      # stored but, as in the reference, not applied
        self.sub_len = int(self._B.shape[0])
        self._tail = torch.zeros(self.sub_len - 1, dtype=self._B.dtype,
                                 device=self.device)
        self._win = None

    def __len__(self) -> int:
        return self.branches

    def is_empty(self) -> bool:
        return self.branches == 0

    def set_scale(self, scale) -> None:
        self.scale = scale

    def get_scale(self):
        return self.scale

    def coefficients(self) -> list:
        """Per-branch coefficients in the reference's stored (reversed)
        order."""
        return [self._B_np[::-1, f].copy() for f in range(self.branches)]

    def reset(self) -> None:
        self._tail = torch.zeros(self.sub_len - 1, dtype=self._B.dtype,
                                 device=self.device)
        self._win = None

    def push(self, sample) -> None:
        """Push one sample into the shared window."""
        s = _ingest(np.asarray([sample]), self.device)
        self._tail = _widen(self._tail, s)
        win = torch.cat([self._tail, s.to(self._tail.dtype)])
        self._tail = win[1:] if self.sub_len > 1 else self._tail
        self._win = win

    def _window(self) -> torch.Tensor:
        if self._win is None:      # nothing pushed: the zeroed window
            self._win = torch.zeros(self.sub_len, dtype=self._B.dtype,
                                    device=self.device)
        return self._win

    def execute(self, index: int):
        """One branch's output for the current window."""
        if not 0 <= index < self.branches:
            raise ValueError("filter index out of range")
        win = self._window()
        return torch.sum(self._B[:, index].to(win.dtype) * win)

    def execute_all(self):
        """Every branch's output for the current window, one product."""
        win = self._window()
        with fp32_exact():
            return torch.matmul(win, self._B.to(win.dtype))

    def push_block(self, samples):
        samples = _ingest(samples, self.device)
        x_pre = torch.cat([_widen(self._tail, samples),
                           samples.to(torch.promote_types(self._tail.dtype,
                                                          samples.dtype))])
        out, self._tail = pfb_apply_all(
            self._B_np, x_pre[: self.sub_len - 1] if self.sub_len > 1
            else x_pre[:0], samples)
        self._win = x_pre[-self.sub_len:]
        return out                                        # (T, branches)


class InterpolatingFIRFilter:
    """Zero-stuffing interpolator on the polyphase bank, on ``device`` (the
    card unless told otherwise): taps padded to ceil(N/P)*P, one input ->
    P branch outputs.  As in the reference, the branch sub-filters apply
    their coefficients time-REVERSED, so an asymmetric padded prototype
    gives a branch-dependent fractional shift."""

    def __init__(self, coefficients, interpolation: int, dtype=None,
                 device=None):
        c = np.asarray(coefficients)
        if c.size == 0:
            raise ValueError("coefficients length zero")
        if interpolation < 1:
            raise ValueError("interpolation less than one")
        self.device = resolve_device(device)
        self.interpolation = int(interpolation)
        sub_len = -(-len(c) // self.interpolation)
        eff = np.zeros(sub_len * self.interpolation, dtype=c.dtype)
        eff[: len(c)] = c
        self._eff = eff
        self._B = pfb_branch_matrix(eff, self.interpolation, self.device)
        if dtype is not None:
            self._B = self._B.to(dtype)
        self._B_np = self._B.cpu().numpy()          # the product's banks
        self.scale = 1.0
        self._tail = torch.zeros(self._B.shape[0] - 1, dtype=self._B.dtype,
                                 device=self.device)

    def __len__(self) -> int:
        return self.interpolation

    def coefficients(self) -> np.ndarray:
        """Flattened per-branch (reversed) coefficients, reference order."""
        return np.concatenate([self._B_np[::-1, f]
                               for f in range(self.interpolation)])

    def set_scale(self, scale) -> None:
        self.scale = scale

    def get_scale(self):
        return self.scale

    @property
    def state(self):
        return self._tail

    def execute(self, sample):
        return self.execute_block(np.asarray([sample]))

    def execute_block(self, samples):
        samples = _ingest(samples, self.device)
        self._tail = _widen(self._tail, samples)
        y, self._tail = fir_interp_apply(self._B_np, self._tail, samples)
        return y

    def frequency_response(self, frequency: float) -> complex:
        return fir_frequency_response(self.coefficients(), frequency,
                                      self.scale)

    def group_delay(self, frequency: float) -> float:
        return fir_group_delay(self.coefficients(), frequency)


class RationalResampler:
    """P/Q rational resampler: polyphase interpolation by P, decimation by
    Q, on ``device`` (the card unless told otherwise).

    The commutator is folded into the bank at design time: outputs repeat
    with period P0 = P/gcd(P, Q) in branch index while the input base
    advances by Q0 = Q/gcd(P, Q), so with u_r = first + r*Q, f_r = u_r mod
    P, d_r = u_r div P and H[d_r + m, r] = B[m, f_r] the whole resampler is
    one stride-Q0 multi-output banded-Toeplitz product
    y[j, r] = sum_i H[i, r] x_ext[j*Q0 + i] (:func:`fir_toeplitz`), the
    values of interpolate-then-select.  The commutator's phase is a host
    integer.  As in the JAX package, a ``dtype`` that is not a real float
    type leaves the float64 prototype as it is (a complex64 block then
    computes in complex128); float32 taps give a complex64 product.
    """

    def __init__(self, coefficients, interp: int, decim: int, dtype=None,
                 device=None):
        if interp < 1 or decim < 1:
            raise ValueError("interp and decim must be >= 1")
        self.P = int(interp)
        self.Q = int(decim)
        self._interp = InterpolatingFIRFilter(coefficients, self.P,
                                              dtype=dtype, device=device)
        self.device = self._interp.device
        self._phase = 0       # position within the zero-stuffed stream mod Q
        eff = np.asarray(self._interp._eff)
        if dtype is not None and torch.empty(0, dtype=dtype).is_floating_point():
            eff = eff.astype(torch.empty(0, dtype=dtype).numpy().dtype)
        self._B_np = eff.reshape(-1, self.P)
        g = gcd(self.P, self.Q)
        self._P0, self._Q0 = self.P // g, self.Q // g
        self._banks: dict = {}

    def _bank(self, first: int):
        """(H, width) of the folded bank for a commutator phase."""
        got = self._banks.get(first)
        if got is None:
            B = self._B_np
            sub = B.shape[0]
            us = first + np.arange(self._P0) * self.Q
            fs, ds = us % self.P, us // self.P
            width = int(ds.max()) + sub
            H = np.zeros((width, self._P0), B.dtype)
            for r in range(self._P0):
                H[ds[r]: ds[r] + sub, r] = B[:, fs[r]]
            got = self._banks[first] = (H, width)
        return got

    def execute_block(self, samples):
        x = _ingest(samples, self.device)
        it = self._interp
        it._tail = _widen(it._tail, x)
        first = (self.Q - self._phase) % self.Q
        H, width = self._bank(first)
        P, Q, P0, Q0 = self.P, self.Q, self._P0, self._Q0
        sub = self._B_np.shape[0]
        L = int(x.shape[-1])
        x_ext = torch.cat([it._tail, x.to(it._tail.dtype)], dim=-1)
        it._tail = (x_ext[..., x_ext.shape[-1] - (sub - 1):] if sub > 1
                    else x[..., :0])
        self._phase = (self._phase + L * P) % Q
        n_up = L * P
        n_out = (n_up - 1 - first) // Q + 1 if n_up > first else 0
        if n_out <= 0:
            return x[..., :0]
        F_tot = -(-n_out // P0)
        need = (F_tot - 1) * Q0 + width
        ext_len = int(x_ext.shape[-1])
        if need > ext_len:
            x_in = torch.nn.functional.pad(x_ext, (0, need - ext_len))
        else:
            x_in = x_ext[..., :need]
        out = fir_toeplitz(x_in, H, stride=Q0)               # (.., F, P0)
        return out.reshape(*out.shape[:-2], F_tot * P0)[..., :n_out]
