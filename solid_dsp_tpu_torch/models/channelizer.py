"""Polyphase channelizer: M-channel critically-sampled analysis filter bank.

Port of ``solid_dsp_tpu/models/channelizer.py``, BASELINE.json's config 5
(the 256-channel polyphase filterbank).  With the prototype h and
H[k, r] = h[k M + r],

    z[t, r] = sum_k H[k, r] x[(t - k) M - r]
    Y[t, m] = sum_r z[t, r] e^{+2 pi i m r / M}

puts the band centred at +m/M of the input rate into channel m, decimated
by M.  Three formulations, as in the JAX package:

* :func:`channelizer_apply`, the commutator form in torch ops: one
  reshape, K shifted multiply-adds and one batched ``torch.fft.fft``
  (``PolyphaseChannelizer(backend="xla")``; the name is the JAX
  package's);
* :func:`channelizer_apply_planar`, planar planes with the DFT as one
  matmul;
* the fused kernel K4 (:func:`make_fused_channelizer` on planes,
  :func:`fused_channelizer_complex` on complex samples, ``backend="fused"``)
  and the front-end kernel K5 with ``torch.fft.fft``
  (``backend="pallas"``), both in ``ops/cuda_chan.py``.

Also the synthesis bank (the transpose) and the 2x-oversampled WOLA bank
in torch ops.  Every constructor's ``device`` is the card unless told
otherwise.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..design import firdes
from ..device import bind_device, fp32_exact, resolve_device
from ..ops import cuda_chan
from ..ops.cuda_chan import CHAN_HALO

__all__ = ["channelizer_taps", "channelizer_init", "channelizer_apply",
           "channelizer_dft_bank", "channelizer_apply_planar",
           "fused_channelizer_init", "make_fused_channelizer",
           "fused_channelizer_complex",
           "PolyphaseChannelizer", "channelizer_synthesize",
           "synthesis_init", "PolyphaseSynthesizer",
           "os_channelizer_init", "os_channelizer_apply",
           "os_channelizer_synthesize", "os_reconstruction_taps",
           "OversampledChannelizer"]


def channelizer_taps(num_channels: int, taps_per_branch: int = 8,
                     attenuation: float = 80.0) -> np.ndarray:
    """Kaiser prototype lowpass for an M-channel bank (cutoff 1/(2M)),
    scaled to a DC gain of M (``channelizer.py:37-42``)."""
    n = num_channels * taps_per_branch
    h = firdes.firdes_kaiser(n, 0.5 / num_channels, attenuation, 0.0)
    return h * num_channels / np.sum(h)


def channelizer_init(num_channels: int, taps_per_branch: int,
                     dtype=torch.complex64, batch_shape: tuple = (),
                     device=None) -> torch.Tensor:
    """Raw-sample tail of length K*M - 1 (``channelizer.py:45-51``)."""
    return torch.zeros((*batch_shape, taps_per_branch * num_channels - 1),
                       dtype=dtype, device=resolve_device(device))


def _as_taps(taps, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(taps, dtype=like.dtype, device=like.device)


def channelizer_apply(taps, tail, x, num_channels: int):
    """One block of the commutator form (``channelizer.py:54-87``).

    x: (..., L) complex with L a multiple of M; tail (..., K*M - 1).
    Returns (Y (..., T, M), new_tail), T = L // M.  With base = K*M - 1
    and P[u, q] = x_ext[u*M + q], the branch sum becomes
    z2[t, q] = sum_k G[k, q] P[t + k, q] with G = reverse(taps).reshape(K, M),
    and Y[t, m] = e^{-2 pi i m / M} FFT_q(z2)[m].
    """
    M = num_channels
    taps = _as_taps(taps, x)
    K = taps.shape[-1] // M
    L = x.shape[-1]
    if L % M:
        raise ValueError("block length must be a multiple of the channel count")
    T = L // M
    x_ext = torch.cat([tail.to(x.dtype), x], dim=-1)
    P = x_ext[..., : (T + K - 1) * M].reshape(*x_ext.shape[:-1], T + K - 1, M)
    G = taps[: K * M].flip(0).reshape(K, M)
    z2 = G[0] * P[..., 0:T, :]
    for k in range(1, K):
        z2 = z2 + G[k] * P[..., k: k + T, :]
    phase = torch.as_tensor(np.exp(-2j * np.pi * np.arange(M) / M),
                            dtype=z2.dtype, device=z2.device)
    Y = torch.fft.fft(z2, dim=-1) * phase
    return Y, x_ext[..., -(K * M - 1):]


def channelizer_dft_bank(num_channels: int, taps_per_branch: int,
                         taps: np.ndarray | None = None,
                         attenuation: float = 80.0) -> np.ndarray:
    """Host-side folded DFT bank (2, M, 2M) float64 for the planar
    channelizer: W[q, m] = e^{-2 pi i (q+1) m / M} as [re | im] column
    blocks per plane (``channelizer.py:90-111``)."""
    M = int(num_channels)
    q = np.arange(M)[:, None]
    m = np.arange(M)[None, :]
    W = np.exp(-2j * np.pi * (q + 1) * m / M)
    B = np.zeros((2, M, 2 * M), np.float64)
    B[0, :, :M] = W.real
    B[0, :, M:] = W.imag
    B[1, :, :M] = -W.imag
    B[1, :, M:] = W.real
    return B


def channelizer_apply_planar(taps, bank, tail2, x2, num_channels: int,
                             precision: str = "x3"):
    """Planar block: branch multiply-adds over the (2, T', M) frame view,
    then the M-point DFT as one plane-folded matmul
    (``channelizer.py:114-161``).

    taps: concrete prototype (numpy); bank (2, M, 2M) from
    :func:`channelizer_dft_bank`; tail2 (2, K*M - 1); x2 (2, L) float.
    ``precision``: "x3" and "highest" run the matmul in full float32 (under
    ``device.fp32_exact``: TF32 off whatever the caller set); "default"
    rounds both operands to bf16 and accumulates in float32.  Returns
    (Y2 (T, 2M) [Re | Im], new_tail2).
    """
    if precision not in ("x3", "highest", "default"):
        raise ValueError(f"unknown precision {precision!r}")
    M = num_channels
    K = np.asarray(taps).shape[-1] // M
    L = x2.shape[-1]
    if L % M:
        raise ValueError("block length must be a multiple of the channel count")
    T = L // M
    rdtype = x2.dtype
    x_ext = torch.cat([tail2.to(rdtype), x2], dim=-1)
    P2 = x_ext[..., : (T + K - 1) * M].reshape(2, T + K - 1, M)
    G = torch.as_tensor(np.ascontiguousarray(
        np.asarray(taps)[: K * M].real[::-1].reshape(K, M)), dtype=rdtype,
        device=x2.device)
    z2 = G[0] * P2[:, 0:T, :]
    for k in range(1, K):
        z2 = z2 + G[k] * P2[:, k: k + T, :]
    B = torch.as_tensor(bank, dtype=rdtype, device=x2.device)
    if precision == "default":
        z2 = z2.to(torch.bfloat16).to(rdtype)
        B = B.to(torch.bfloat16).to(rdtype)
    with fp32_exact():
        Y2 = torch.matmul(z2[0], B[0]) + torch.matmul(z2[1], B[1])
    return Y2, x_ext[..., -(K * M - 1):]


def fused_channelizer_init(num_channels: int, device=None) -> torch.Tensor:
    """Tail-row carry of the fused channelizer: the last CHAN_HALO frame
    rows of the previous block as (2, CHAN_HALO, M) float32 planes
    (``channelizer.py:573-580``)."""
    return torch.zeros((2, CHAN_HALO, int(num_channels)), dtype=torch.float32,
                       device=resolve_device(device))


def make_fused_channelizer(taps, num_channels: int, n_frames: int,
                           TF: int = 512, mode: str = "fast", device=None,
                           engine: str = "auto"):
    """Build the fused channelizer ``apply(tail_rows, x2)`` on K4
    (``channelizer.py:583-621``).

    n_frames: the frame count U = L // M of every block, a multiple of the
    TPU tile TF (the JAX package's block rule, kept so that the two
    packages take the same blocks; the kernel's own tiles are fixed).
    mode: "fast" (bf16 branch products and bank, FP32 sums) | "x3" (three
    bf16 products, ~FP32).

    Returns apply(tail_rows, x2) -> (Y2 (U, 2M) [Re | Im], new_tail_rows)
    for x2 (2, L) float32 planes and tail_rows (2, CHAN_HALO, M).
    """
    M = int(num_channels)
    U = int(n_frames)
    if U % TF:
        raise ValueError("n_frames must be a multiple of TF")
    if TF % CHAN_HALO:
        raise ValueError(f"TF must be a multiple of {CHAN_HALO}")
    body = cuda_chan.make_chan_body(np.asarray(taps), M, mode, device)

    def apply(tail_rows, x2):
        xf = x2.reshape(2, U, M)
        Y2 = body(xf, tail_rows, engine)
        return Y2, xf[:, U - CHAN_HALO:, :].contiguous()

    return apply


def fused_channelizer_complex(body, tail_rows, x, engine: str = "auto"):
    """One block of the fused channelizer on complex samples, through K4's
    complex layout (no plane split or merge around the kernel): x (L,)
    complex64, L a multiple of 8*M, and the (2, 8, M) tail rows -> (Y
    (L // M, M) complex64, new tail rows), bit-equal to the planar route
    of :func:`make_fused_channelizer`."""
    M = body.M
    L = int(x.shape[-1])
    if L % M:
        raise ValueError("block length must be a multiple of the channel count")
    U = L // M
    if U % CHAN_HALO:
        raise ValueError(f"fused backend needs block length a multiple of "
                         f"{CHAN_HALO * M} samples")
    rows = x.reshape(U, M).contiguous()
    Y = body(rows, tail_rows, engine)
    last = rows[U - CHAN_HALO:]
    return Y, torch.stack([last.real, last.imag]).contiguous()


def _check_engine(engine: str):
    if engine not in cuda_chan.ENGINES:
        raise ValueError(f"unknown engine {engine!r}")


class _Stateful(nn.Module):
    """A block transform with one carried state on a fixed device."""

    def _set_state(self, name: str, value):
        old = getattr(self, name)
        olds = old if isinstance(old, tuple) else (old,)
        news = tuple(value) if isinstance(old, tuple) else (value,)
        if len(news) != len(olds):
            raise ValueError(f"state must have {len(olds)} parts")
        checked = []
        for o, n in zip(olds, news):
            n = (torch.from_numpy(np.array(n)) if isinstance(n, np.ndarray)
                 else torch.as_tensor(n))
            if tuple(n.shape) != tuple(o.shape) or n.dtype != o.dtype:
                raise ValueError(f"state {n.dtype}{tuple(n.shape)} != "
                                 f"{o.dtype}{tuple(o.shape)}")
            checked.append(n.to(self.device).clone())
        setattr(self, name, tuple(checked) if isinstance(old, tuple)
                else checked[0])


class PolyphaseChannelizer(_Stateful):
    """Stateful M-channel analysis channelizer (``channelizer.py:164-283``).

    Backends (the JAX package's names, so that the two packages read the
    same):

    * ``"xla"`` (default): :func:`channelizer_apply`, the commutator form
      in torch ops with ``torch.fft.fft``;
    * ``"fused"``: the fused kernel K4 (branch filter and DFT in one pass,
      on the complex samples as they come; ``ops/cuda_chan.py``);
      ``precision`` "x3" (~f32: three bf16 tensor-core products) or "fast"
      (bf16 branch products and bank).  The block length must be a
      multiple of 8*M, as in the JAX package;
    * ``"pallas"``: the front-end kernel K5 and ``torch.fft.fft``.

    ``device``: the card unless told otherwise.  ``engine``: "auto" runs
    the kernels for a card and their plain versions on the CPU; "torch"
    runs the plain versions on the card too; "cuda" always the kernels.
    ``.state`` is the carried tail: (K*M - 1,) ``dtype`` for "xla",
    (2, 8, M) float32 rows for "fused", (K, M) complex64 rows for
    "pallas".
    """

    def __init__(self, num_channels: int, taps_per_branch: int = 8,
                 attenuation: float = 80.0, dtype=torch.complex64,
                 backend: str = "xla", precision: str = "x3", device=None,
                 engine: str = "auto"):
        super().__init__()
        self.M = int(num_channels)
        self.K = int(taps_per_branch)
        if backend not in ("xla", "fused", "pallas"):
            raise ValueError(f"unknown backend {backend!r}")
        if precision not in ("x3", "fast"):
            raise ValueError(f"unknown precision {precision!r}")
        _check_engine(engine)
        self.backend = backend
        self.precision = precision
        self.engine = engine
        self.device = bind_device(device)
        self._taps_np = channelizer_taps(self.M, self.K, attenuation)
        self.taps = torch.as_tensor(self._taps_np, dtype=dtype,
                                    device=self.device)
        if backend == "pallas":
            self._h_il = torch.as_tensor(
                cuda_chan.pfb_frontend_taps(self._taps_np, self.M),
                device=self.device)
            self._tail = torch.zeros((self.K, self.M), dtype=torch.complex64,
                                     device=self.device)
        elif backend == "fused":
            if self.K > CHAN_HALO:
                raise ValueError(
                    f"fused backend supports taps_per_branch <= {CHAN_HALO}")
            self._tail = fused_channelizer_init(self.M, self.device)
            self._body = cuda_chan.make_chan_body(self._taps_np, self.M,
                                                  precision, self.device)
        else:
            self._tail = channelizer_init(self.M, self.K, dtype,
                                          device=self.device)

    @property
    def state(self) -> torch.Tensor:
        return self._tail

    @state.setter
    def state(self, value):
        self._set_state("_tail", value)

    def execute_block(self, x) -> torch.Tensor:
        """x (L,) complex, L a multiple of M -> Y (L // M, M) complex."""
        if self.backend == "pallas":
            x = torch.as_tensor(x, dtype=torch.complex64, device=self.device)
            Y, self._tail = cuda_chan.channelizer_apply_pallas(
                self._h_il, self._tail, x.contiguous(), self.M, self.K,
                self.engine)
            return Y
        if self.backend == "fused":
            x = torch.as_tensor(x, dtype=torch.complex64, device=self.device)
            Y, self._tail = fused_channelizer_complex(self._body, self._tail,
                                                      x, self.engine)
            return Y
        x = torch.as_tensor(x, dtype=self._tail.dtype, device=self.device)
        Y, self._tail = channelizer_apply(self.taps, self._tail, x, self.M)
        return Y

    forward = execute_block

    def reset(self):
        self._tail = torch.zeros_like(self._tail)

    def __repr__(self):
        return (f"PolyphaseChannelizer [M={self.M}] [K={self.K}] "
                f"[backend={self.backend}] [device={self.device}]")


# ----------------------------------------------------------- synthesis bank

def channelizer_synthesize(taps, tail_rows, Y, num_channels: int):
    """Polyphase synthesis bank, the transpose of :func:`channelizer_apply`
    (``channelizer.py:290-319``): Y (..., T, M) channel samples and the
    (..., K-1, M) carry of branch inputs -> (x (..., T*M), new_tail)::

        w[t, r] = sum_m Y[t, m] e^{+2 pi i m r / M}
        x[t*M + r] = sum_k h[k*M + r] w[t - k, r]
    """
    M = num_channels
    taps = _as_taps(taps, Y)
    K = taps.shape[-1] // M
    H = taps[: K * M].reshape(K, M)
    T = Y.shape[-2]
    w = torch.fft.ifft(Y, dim=-1) * M
    w_ext = torch.cat([tail_rows.to(w.dtype), w], dim=-2)
    acc = w_ext[..., K - 1: K - 1 + T, :] * H[0, :]
    for k in range(1, K):
        acc = acc + w_ext[..., K - 1 - k: K - 1 - k + T, :] * H[k, :]
    x = acc.reshape(*Y.shape[:-2], T * M)
    new_tail = w_ext[..., w_ext.shape[-2] - (K - 1):, :]
    return x, new_tail


def synthesis_init(num_channels: int, taps_per_branch: int,
                   dtype=torch.complex64, batch_shape: tuple = (),
                   device=None) -> torch.Tensor:
    """Branch-input carry: K-1 rows of M (``channelizer.py:322-328``)."""
    return torch.zeros((*batch_shape, taps_per_branch - 1, num_channels),
                       dtype=dtype, device=resolve_device(device))


class PolyphaseSynthesizer(_Stateful):
    """Stateful M-channel synthesis bank (``channelizer.py:331-359``);
    ``.state`` is the (K-1, M) branch-input carry."""

    def __init__(self, num_channels: int, taps_per_branch: int = 8,
                 attenuation: float = 80.0, dtype=torch.complex64,
                 device=None):
        super().__init__()
        self.M = int(num_channels)
        self.K = int(taps_per_branch)
        self.device = bind_device(device)
        self.taps = torch.as_tensor(
            channelizer_taps(self.M, self.K, attenuation), dtype=dtype,
            device=self.device)
        self._tail = synthesis_init(self.M, self.K, dtype, device=self.device)

    @property
    def state(self) -> torch.Tensor:
        return self._tail

    @state.setter
    def state(self, value):
        self._set_state("_tail", value)

    def execute_block(self, Y) -> torch.Tensor:
        Y = torch.as_tensor(Y, dtype=self.taps.dtype, device=self.device)
        x, self._tail = channelizer_synthesize(self.taps, self._tail, Y,
                                               self.M)
        return x

    forward = execute_block

    def reset(self):
        self._tail = torch.zeros_like(self._tail)

    def __repr__(self):
        return (f"PolyphaseSynthesizer [M={self.M}] [K={self.K}] "
                f"[device={self.device}]")


# ------------------------------------------------------ 2x oversampled bank

def os_reconstruction_taps(num_channels: int, taps_per_branch: int = 16,
                           rolloff: float = 1.0) -> np.ndarray:
    """Root-Nyquist(1/M) prototype for analysis -> synthesis round trips:
    a root-raised cosine at "symbol rate" 1/M, scaled to DC gain M
    (``channelizer.py:364-379``)."""
    M, K = num_channels, taps_per_branch
    h = np.asarray(firdes.firdes_rrcos(M, K // 2, rolloff))[: M * K]
    return h * M / np.sum(h)


def os_channelizer_init(num_channels: int, taps_per_branch: int,
                        dtype=torch.complex64, batch_shape: tuple = (),
                        device=None):
    """State: (raw tail of K*M - M/2 samples, global step parity as an
    int32 tensor) (``channelizer.py:382-389``)."""
    device = resolve_device(device)
    M, K = num_channels, taps_per_branch
    return (torch.zeros((*batch_shape, K * M - M // 2), dtype=dtype,
                        device=device),
            torch.zeros((), dtype=torch.int32, device=device))


def _m_sign(M: int, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.where(np.arange(M) % 2, -1.0, 1.0),
                           dtype=like.real.dtype, device=like.device)


def os_channelizer_apply(taps, state, x, num_channels: int):
    """One block of the 2x-oversampled (WOLA) analysis bank
    (``channelizer.py:392-454``): the commutator advances by R = M/2 per
    output step, and Y_p[m] = (-1)^{m p} DFT_q(v_p)[m] with
    v_p[q] = sum_k h[k M + q] x[p R - k M - q] and the global step parity
    p carried in the state.  x: (..., L), L a multiple of M.  Returns
    (Y (..., 2L/M, M), state)."""
    M = num_channels
    R = M // 2
    if M % 2:
        raise ValueError("oversampled bank needs an even channel count")
    taps = _as_taps(taps, x)
    K = taps.shape[-1] // M
    L = x.shape[-1]
    if L % M:
        raise ValueError("block length must be a multiple of the channel count")
    tail, p0 = state
    x_ext = torch.cat([tail.to(x.dtype), x], dim=-1)
    T = L // R
    hr = taps[: K * M].flip(0)
    lead = x_ext.shape[:-1]
    pieces = [x_ext[..., j * R: j * R + T * R].reshape(*lead, T, R)
              for j in range((K * M) // R)]
    Fr = torch.cat(pieces, dim=-1)                     # (..., T, K*M)
    S = (Fr * hr).reshape(*lead, T, K, M).sum(dim=-2)  # (..., T, M)
    v = S.flip(-1)                                     # v[q] = S[M-1-q]
    Y = torch.fft.ifft(v, dim=-1) * M
    p_idx = (p0 + torch.arange(T, device=x.device)) % 2
    sign = torch.where(p_idx[:, None] == 1, _m_sign(M, Y)[None, :],
                       torch.ones((), dtype=Y.real.dtype, device=x.device))
    Y = Y * sign.to(Y.dtype)
    new_tail = x_ext[..., x_ext.shape[-1] - (K * M - R):]
    return Y, (new_tail, ((p0 + T) % 2).to(torch.int32))


def os_channelizer_synthesize(taps, Y, num_channels: int):
    """Whole-block WOLA reconstruction from 2x-oversampled channel streams
    (``channelizer.py:512-570``): the adjoint of
    :func:`os_channelizer_apply`'s chain, normalised per sample by the
    overlap-added |h|^2 envelope.  Y (..., T, M), T even, starting at even
    parity -> x_hat (..., T*M/2) aligned with the analysis input."""
    M = num_channels
    R = M // 2
    taps = _as_taps(taps, Y)
    K = taps.shape[-1] // M
    T = Y.shape[-2]
    hr = taps[: K * M].flip(0)
    p_idx = torch.arange(T, device=Y.device) % 2
    sign = torch.where(p_idx[:, None] == 1, _m_sign(M, Y)[None, :],
                       torch.ones((), dtype=Y.real.dtype, device=Y.device))
    W = Y * sign.to(Y.dtype)
    v_adj = torch.fft.fft(W, dim=-1)
    S_adj = v_adj.flip(-1)
    Fr_adj = S_adj.repeat(*([1] * (S_adj.dim() - 1)), K) * hr

    def _ola(frames):
        """Overlap-add rows of (..., T, K*M) at hop R: (T-1)*R + K*M."""
        ks = (K * M) // R
        out = torch.zeros((*frames.shape[:-2], T + ks - 1, R),
                          dtype=frames.dtype, device=frames.device)
        pieces = frames.reshape(*frames.shape[:-1], ks, R)
        for j in range(ks):
            out[..., j: j + T, :] += pieces[..., j, :]
        return out.reshape(*frames.shape[:-2], (T + ks - 1) * R)

    x_acc = _ola(Fr_adj)
    h2 = (hr * hr.conj()).real * M
    env = _ola(h2[None, :].expand(T, K * M).to(Y.dtype)).real
    x_hat = x_acc / (env + 1e-30)
    return x_hat[..., K * M - R: K * M - R + T * R]


class OversampledChannelizer(_Stateful):
    """Stateful 2x-oversampled M-channel analysis bank (WOLA)
    (``channelizer.py:457-509``).  ``prototype="kaiser"`` for adjacent-
    channel rejection, ``"rrc"`` for near-perfect reconstruction with
    :meth:`synthesize`.  ``.state`` is (tail, parity)."""

    def __init__(self, num_channels: int, taps_per_branch: int = 8,
                 attenuation: float = 80.0, dtype=torch.complex64,
                 prototype: str = "kaiser", rolloff: float = 1.0,
                 device=None):
        super().__init__()
        self.M = int(num_channels)
        self.K = int(taps_per_branch)
        if prototype == "kaiser":
            taps_np = channelizer_taps(self.M, self.K, attenuation)
        elif prototype == "rrc":
            taps_np = os_reconstruction_taps(self.M, self.K, rolloff)
        else:
            raise ValueError(f"unknown prototype {prototype!r}")
        self.prototype = prototype
        self.device = bind_device(device)
        self.taps = torch.as_tensor(taps_np, dtype=dtype, device=self.device)
        self._state = os_channelizer_init(self.M, self.K, dtype,
                                          device=self.device)

    @property
    def state(self):
        return self._state

    @state.setter
    def state(self, value):
        self._set_state("_state", value)

    def synthesize(self, Y) -> torch.Tensor:
        """Whole-block reconstruction from this bank's channel streams."""
        Y = torch.as_tensor(Y, dtype=self.taps.dtype, device=self.device)
        return os_channelizer_synthesize(self.taps, Y, self.M)

    @property
    def oversample(self) -> int:
        return 2

    def execute_block(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=self.taps.dtype, device=self.device)
        Y, self._state = os_channelizer_apply(self.taps, self._state, x,
                                              self.M)
        return Y

    forward = execute_block

    def reset(self):
        self._state = os_channelizer_init(self.M, self.K, self.taps.dtype,
                                          device=self.device)

    def __repr__(self):
        return (f"OversampledChannelizer [M={self.M}] [K={self.K}] "
                f"[os=2] [device={self.device}]")
