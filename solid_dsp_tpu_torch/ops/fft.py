"""FFT engine: the reference's planner and its execution in torch ops.

Port of ``solid_dsp_tpu/ops/fft.py`` (reference ``src/fft/``: method
selection mod.rs:123-143, mixed radix mixed_radix/mod.rs:9-130, Rader
rader/mod.rs:9-89, Rader2 rader2/mod.rs:9-103).

Conventions: FORWARD is sum_n x[n] e^{-2 pi i n k / N}, REVERSE e^{+...};
neither direction normalizes (the Rader paths divide only to undo their own
internal inverse).  Backends of :func:`fft` / :func:`ifft`, in the JAX
package's routing order:

* ``"plan"``: the reference's plan tree executed structurally (DFT codelets
  as matrix products, the mixed-radix split as reshape -> batched sub-FFT
  -> twiddle -> batched sub-FFT -> transpose, Rader's permutations as
  gathers; Rader and Rader2 run their pow2 convolution through
  ``torch.fft``, as JAX does through ``jnp.fft``);
* ``"matmul"``: the four-step products of ``ops/matfft.py``;
* ``"xla"``, ``"auto"`` or any power of two: ``torch.fft`` (a pow2 n takes
  it even under ``"bluestein"``, as in JAX);
* ``"bluestein"``: chirp-z through two pow2 ``torch.fft`` transforms.

``"auto"`` is ``torch.fft`` for every size on both devices: cuFFT and
PocketFFT take any n, so the JAX package's TPU-only detour of non-pow2
sizes to the matrix products (``_xla_ok``) has no counterpart.

:func:`windowed_fft` routes, explicitly: ``"auto"`` takes K7
(``ops/cuda_fft.py``) for a CUDA tensor of fusable shape (N = 4096,
``nfft`` absent or N, 2-D, F % 8 == 0, complex64 class) and window times
``torch.fft`` for anything else, CPU tensors included; ``"fused"`` forces
K7's route (its plain version on a CPU tensor) and raises on a shape that
is not fusable; ``"xla"`` forces window times ``torch.fft``.  The window
and table cache is bounded (16 entries) and keyed without F.
"""

from __future__ import annotations

import time
from functools import lru_cache

import numpy as np
import torch

from ..design import resources
from ..design.windows import get_window
from ..device import fp32_exact, resolve_device
from .cuda_fft import N_FFT, windowed_fft_frames

__all__ = ["FFTDirection", "FFTMethod", "BACKENDS", "estimate_method",
           "FFTPlan", "FFT", "fft", "ifft", "windowed_fft",
           "windowed_fft_planar", "spectrogram", "welch_psd", "goertzel"]

BACKENDS = ("auto", "xla", "matmul", "bluestein", "plan")


class FFTDirection:
    FORWARD = "forward"
    REVERSE = "reverse"


class FFTMethod:
    DEFAULT = "default"
    RADIX2 = "radix2"
    MIXEDRADIX = "mixedradix"
    RADER = "rader"
    RADER2 = "rader2"
    DFT = "dft"
    UNKNOWN = "unknown"


def estimate_method(nfft: int) -> str:
    """Plan-method selection of the reference."""
    if nfft == 0:
        return FFTMethod.UNKNOWN
    if nfft <= 8 or nfft in (11, 13, 16, 17):
        return FFTMethod.DFT
    if resources.is_pow2(nfft):
        return FFTMethod.MIXEDRADIX  # sic: RADIX2 is unreachable in the ref
    if resources.is_prime(nfft):
        if resources.is_pow2(nfft - 1):
            return FFTMethod.RADER
        return FFTMethod.RADER2
    return FFTMethod.MIXEDRADIX


def _estimate_mixed_radix_q(nfft: int) -> int:
    """Radix pick of the reference's mixed-radix plan."""
    factors = resources.factor(nfft)
    if len(factors) < 2:
        return 0
    num_factors_2 = 0
    for i, j in enumerate(factors):
        num_factors_2 = i
        if j != 2:
            break
    if num_factors_2 > 0:
        for q in (16, 8, 4, 2):
            if nfft % q == 0:
                return q
    return factors[0]


def _dft_matrix(n: int, sign: float) -> np.ndarray:
    k = np.arange(n)
    return np.exp(sign * 2j * np.pi * np.outer(k, k) / n)


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A host complex128 table in ``like``'s complex type and device."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(like.device,
                                                        like.dtype)


class FFTPlan:
    """A printable plan tree mirroring the reference's recursive planner;
    its tables are host numpy arrays."""

    def __init__(self, nfft: int, direction: str = FFTDirection.FORWARD):
        self.nfft = int(nfft)
        self.direction = direction
        self.method = estimate_method(self.nfft)
        self.sign = -1.0 if direction == FFTDirection.FORWARD else 1.0
        d = self.sign
        if self.method == FFTMethod.DFT:
            self._W = _dft_matrix(self.nfft, d)
        elif self.method == FFTMethod.MIXEDRADIX:
            q = _estimate_mixed_radix_q(self.nfft)
            if q == 0:
                raise ValueError(
                    f"mixed radix plan with prime nfft {self.nfft}")
            self.q = q
            self.p = self.nfft // q
            self.p_plan = FFTPlan(self.p, direction)
            self.q_plan = FFTPlan(q, direction)
            jj, ii = np.meshgrid(np.arange(self.p), np.arange(q),
                                 indexing="ij")
            self._twiddle = np.exp(d * 2j * np.pi * (ii * jj) / self.nfft)
        elif self.method in (FFTMethod.RADER, FFTMethod.RADER2):
            n = self.nfft
            g = resources.primitive_root_prime(n)
            seq = np.array([resources.modpow(g, i + 1, n)
                            for i in range(n - 1)])
            self.seq = seq
            if self.method == FFTMethod.RADER:
                conv_n = n - 1
                tdb = np.exp(d * 2j * np.pi * seq / n)
                self._perm_in = seq[::-1].copy()
            else:
                conv_n = 1 << int(2 * n - 5).bit_length()
                tdb = np.exp(d * 2j * np.pi * seq[np.arange(conv_n) % (n - 1)]
                             / n)
            self.conv_n = conv_n
            self.fft_plan = FFTPlan(conv_n, FFTDirection.FORWARD)
            self.ifft_plan = FFTPlan(conv_n, FFTDirection.REVERSE)
            self._dft = np.fft.fft(tdb)
            self._scatter = seq.copy()
        elif self.method == FFTMethod.UNKNOWN:
            raise ValueError("nfft must be > 0")

    def execute(self, x: torch.Tensor) -> torch.Tensor:
        """Structural plan execution, batched over the leading axes; x
        complex."""
        if x.shape[-1] < self.nfft:
            raise ValueError("not enough buffer")
        x = x[..., : self.nfft]
        m = self.method
        if m == FFTMethod.DFT:
            with fp32_exact():
                return torch.matmul(x, _const(self._W, x).T)
        if m == FFTMethod.MIXEDRADIX:
            p, q = self.p, self.q
            A = x.reshape(*x.shape[:-1], p, q)           # A[j, i] = x[q j + i]
            B = self.p_plan.execute(A.transpose(-1, -2)).transpose(-1, -2)
            B = B * _const(self._twiddle, B)
            C = self.q_plan.execute(B)
            return C.transpose(-1, -2).reshape(*x.shape[:-1], self.nfft)
        n = self.nfft
        if m == FFTMethod.RADER:
            td = x[..., torch.from_numpy(self._perm_in).to(x.device)]
            F = torch.fft.fft(td, dim=-1) * _const(self._dft, x)
            td2 = torch.fft.ifft(F, dim=-1) * self.conv_n
            vals = td2 / (n - 1) + x[..., 0:1]
        else:
            conv_n = self.conv_n
            xp = torch.zeros((*x.shape[:-1], conv_n), dtype=x.dtype,
                             device=x.device)
            xp[..., 0] = x[..., int(self.seq[n - 2])]
            i = np.arange(1, n - 1)
            src = torch.from_numpy(self.seq[n - 2 - i]).to(x.device)
            dst = torch.from_numpy(i + conv_n - n + 1).to(x.device)
            xp[..., dst] = x[..., src]
            F = torch.fft.fft(xp, dim=-1) * _const(self._dft, x)
            xp = torch.fft.ifft(F, dim=-1) * conv_n
            vals = xp[..., : n - 1] / conv_n + x[..., 0:1]
        out = torch.zeros_like(x)
        out[..., 0:1] = torch.sum(x[..., :n], dim=-1, keepdim=True)
        out[..., torch.from_numpy(self._scatter).to(x.device)] = vals
        return out

    def __repr__(self) -> str:
        s = (f"FFT Plan [{self.direction.upper()}] [n={self.nfft}] "
             f"[{self.method.upper()}]")
        if self.method == FFTMethod.MIXEDRADIX:
            s += f" [P={self.p}, Q={self.q}]\n"
            s += f"PFFT:{self.p_plan!r}\nQFFT:{self.q_plan!r}"
        elif self.method in (FFTMethod.RADER, FFTMethod.RADER2):
            s += f" [conv={self.conv_n}]\nFFT:{self.fft_plan!r}"
        return s


@lru_cache(maxsize=256)
def _cached_plan(nfft: int, direction: str) -> FFTPlan:
    return FFTPlan(nfft, direction)


@lru_cache(maxsize=256)
def _bluestein_tables(n: int, sign: float):
    """Host chirp-z tables (chirp c, FFT of the padded conj chirp, pow2
    length L): X[k] = c[k] sum_n (x[n] c[n]) conj(c)[k - n] with
    c[m] = e^{sign i pi m^2 / n}, the phase reduced mod 2n in integers."""
    m = np.arange(n, dtype=np.int64)
    c = np.exp(sign * 1j * np.pi * ((m * m) % (2 * n)) / n)
    L = 1 << int(2 * n - 2).bit_length() if n > 1 else 1
    b = np.conj(c)
    b_pad = np.zeros(L, dtype=np.complex128)
    b_pad[:n] = b
    if n > 1:
        b_pad[L - (n - 1):] = b[1:][::-1]
    return c, np.fft.fft(b_pad), L


def _bluestein(x: torch.Tensor, n: int, sign: float) -> torch.Tensor:
    """Any-size unnormalized DFT through two pow2 ``torch.fft`` calls."""
    c, B, L = _bluestein_tables(n, sign)
    c_ = _const(c, x)
    a = x[..., :n] * c_
    A = torch.fft.fft(a, n=L, dim=-1)
    y = torch.fft.ifft(A * _const(B, x), dim=-1)[..., :n]
    return y * c_


# Precision of the matmul backend: the JAX package's "x3" (~f32), which is
# FP32 here (ops/matfft.py).
MATMUL_PRECISION = "x3"


def _as_complex(x) -> torch.Tensor:
    x = torch.as_tensor(x)
    return x.to(torch.promote_types(x.dtype, torch.complex64))


def _check_backend(backend: str):
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")


def _empty_rows(x: torch.Tensor, n: int):
    """The (..., n) result of a transform over a batch with no rows (a
    zero in a leading axis), or None: cuFFT, oneMKL and K7 refuse one,
    and JAX returns the empty array."""
    if x.shape[:-1].numel():
        return None
    return x.new_zeros((*x.shape[:-1], n),
                       dtype=torch.promote_types(x.dtype, torch.complex64))


def fft(x, nfft: int | None = None, backend: str = "auto") -> torch.Tensor:
    """Unnormalized forward DFT along the last axis (zero-padded to
    ``nfft``); ``backend`` as in the module docstring."""
    _check_backend(backend)
    x = _as_complex(x)
    n = int(nfft or x.shape[-1])
    empty = _empty_rows(x, n)
    if empty is not None:
        return empty
    if x.shape[-1] < n:
        x = torch.nn.functional.pad(x, (0, n - x.shape[-1]))
    if backend == "plan":
        return _cached_plan(n, FFTDirection.FORWARD).execute(x)
    if backend == "matmul":
        from .matfft import fft_mx
        return fft_mx(x, n, precision=MATMUL_PRECISION)
    if backend in ("xla", "auto") or resources.is_pow2(n):
        return torch.fft.fft(x[..., :n], dim=-1)
    return _bluestein(x, n, -1.0)


def ifft(x, nfft: int | None = None, backend: str = "auto") -> torch.Tensor:
    """UNNORMALIZED inverse DFT (no 1/N, the reference's convention)."""
    _check_backend(backend)
    x = _as_complex(x)
    n = int(nfft or x.shape[-1])
    empty = _empty_rows(x, n)
    if empty is not None:
        return empty
    if backend == "plan":
        return _cached_plan(n, FFTDirection.REVERSE).execute(x)
    if backend == "matmul":
        from .matfft import ifft_mx
        return ifft_mx(x, n, precision=MATMUL_PRECISION)
    if backend in ("xla", "auto") or resources.is_pow2(n):
        return torch.fft.ifft(x[..., :n], dim=-1, norm="forward")
    return _bluestein(x, n, 1.0)


class FFT:
    """Reference-like FFT object: ``FFT(nfft, direction, flags).execute(x)``.
    ``flags`` "estimate" or "measure"; "measure" times the "plan" and
    "xla" backends once on ``device`` (the card unless told otherwise) and
    keeps the faster."""

    def __init__(self, nfft: int, direction: str = FFTDirection.FORWARD,
                 flags: str = "estimate", device=None):
        if flags not in ("estimate", "measure"):
            raise ValueError(f"unknown flags {flags!r}")
        self.nfft = int(nfft)
        self.direction = direction
        self.flags = flags
        self.plan = _cached_plan(self.nfft, direction)
        self.method = self.plan.method
        self._backend = "auto"
        if flags == "measure":
            self._backend = self._measure(resolve_device(device))

    def _run(self, x, backend: str):
        if self.direction == FFTDirection.FORWARD:
            return fft(x, self.nfft, backend)
        return ifft(x, self.nfft, backend)

    def _measure(self, device: torch.device) -> str:
        x = torch.ones(self.nfft, dtype=torch.complex64, device=device)
        sync = (torch.cuda.synchronize if device.type == "cuda"
                else (lambda: None))
        results = {}
        for backend in ("plan", "xla"):
            self._run(x, backend)
            sync()
            t0 = time.perf_counter()
            for _ in range(3):
                self._run(x, backend)
            sync()
            results[backend] = time.perf_counter() - t0
        return min(results, key=results.get)

    def execute(self, x) -> torch.Tensor:
        return self._run(x, self._backend)

    def __repr__(self) -> str:
        return repr(self.plan)


# --------------------------------------------------------------------------
# spectral helpers (the windowed-FFT layer of config 2)
# --------------------------------------------------------------------------

@lru_cache(maxsize=16)
def _window_np(window: str, n: int, window_args: tuple) -> np.ndarray:
    """float64 window taps by name, built once per (name, n, args): the
    host builds no window on a call's path."""
    w = np.asarray(get_window(window, n, *window_args), np.float64)
    w.flags.writeable = False
    return w


def windowed_fft(x, window: str = "hamming", nfft: int | None = None,
                 *window_args, backend: str = "auto") -> torch.Tensor:
    """Window then FFT along the last axis; ``backend`` "auto", "fused" or
    "xla" as in the module docstring."""
    if backend not in ("auto", "fused", "xla"):
        raise ValueError(f"unknown backend {backend!r}")
    x = torch.as_tensor(x)
    n = int(x.shape[-1])
    n_out = int(nfft or n)
    empty = _empty_rows(x, n_out)
    if empty is not None:
        return empty
    fusable = (n == N_FFT and n_out == n and x.dim() == 2
               and int(x.shape[0]) % 8 == 0
               and torch.promote_types(x.dtype, torch.complex64)
               == torch.complex64)
    if backend == "fused" or (backend == "auto" and fusable and x.is_cuda):
        if not fusable:
            raise ValueError("fused windowed_fft needs (F, 4096) frames "
                             "with F a multiple of 8 and complex64 class "
                             "dtype")
        return windowed_fft_frames(x.to(torch.complex64),
                                   _window_np(window, n, tuple(window_args)),
                                   planar=False)
    w = torch.tensor(_window_np(window, n, tuple(window_args)),
                     device=x.device)
    cdtype = torch.promote_types(x.dtype, torch.complex64)
    return fft(x.to(cdtype) * w.to(cdtype), nfft or n)


def windowed_fft_planar(x2, window: str = "hamming", *window_args,
                        mode: str = "x3") -> torch.Tensor:
    """K7's planar route: (2, F, 4096) f32 re/im planes -> (F, 8192)
    [Re | Im] spectra, with no complex split or merge (the kernel for a
    CUDA tensor, its plain version for a CPU one)."""
    x2 = torch.as_tensor(x2)
    if x2.dim() != 3 or x2.shape[0] != 2 or x2.shape[-1] != N_FFT:
        raise ValueError("windowed_fft_planar takes (2, F, 4096) planes")
    if int(x2.shape[1]) % 8:
        raise ValueError("frame count must divide by 8")
    if mode not in ("x3", "fast"):
        raise ValueError(f"unknown mode {mode!r}")
    return windowed_fft_frames(x2.to(torch.float32),
                               _window_np(window, N_FFT, tuple(window_args)),
                               planar=True)


def spectrogram(x, frame: int, hop: int | None = None,
                window: str = "hamming", nfft: int | None = None):
    """Framed windowed FFT: (num_frames, nfft or frame); the frames are a
    strided view of x, copied once if K7 takes them."""
    x = torch.as_tensor(x)
    if x.shape[-1] < frame:          # no whole frame: (..., 0, nfft)
        return _empty_rows(x.new_empty((*x.shape[:-1], 0, frame)),
                           int(nfft or frame))
    frames = x.unfold(-1, frame, hop or frame)
    return windowed_fft(frames, window, nfft or frame)


def welch_psd(x, frame: int = 1024, overlap: float = 0.5,
              window: str = "hamming", nfft: int | None = None):
    """Welch PSD with the frame/overlap signature, normalized so the sum
    over bins of a unit tone's PSD is ~1 whatever the zero-padding
    (``analysis/spectral.py::welch_psd`` divided by the FFT length):
    (nfft or frame,) real, bins in FFT order."""
    from ..analysis.spectral import welch_psd as _welch
    hop = max(1, int(frame * (1.0 - overlap)))
    n_out = nfft or frame
    return _welch(torch.as_tensor(x), nfft=frame, hop=hop, window=window,
                  pad_to=None if n_out == frame else n_out) / n_out


def goertzel(x, freq) -> torch.Tensor:
    """Complex DFT value sum_n x[n] e^{-2 pi i f n} at normalized frequency
    ``freq`` (cycles a sample): one projection, not the recurrence."""
    x = torch.as_tensor(x)
    n = x.shape[-1]
    cdtype = torch.promote_types(x.dtype, torch.complex64)
    k = torch.arange(n, device=x.device).to(cdtype)
    f = torch.as_tensor(freq, dtype=torch.float64).to(x.device, cdtype)
    ph = torch.exp(torch.tensor(-2j * np.pi, dtype=cdtype, device=x.device)
                   * f * k)
    return torch.sum(x.to(cdtype) * ph, dim=-1)
