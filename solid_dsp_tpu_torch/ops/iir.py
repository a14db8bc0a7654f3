"""Block IIR filtering: direct-form II, biquad (SOS) cascades, decim/interp.

Port of ``solid_dsp_tpu/ops/iir.py`` (reference ``src/filter/iir/``:
IIRFilter mod.rs:68-413, SecondOrderFilter sos.rs:34-231,
DecimatingIIRFilter decim.rs:30-198, InterpolatingIIRFilter
interp.rs:29-190).  With a0-normalized coefficients a block is

    w[n] = x[n] - sum_{i>=1} a[i] w[n-i];   y[n] = sum_i b[i] w[n-i]

(SecondOrder: the same per 3-coefficient section, chained; the reference
stores a[1:] as "numerator_coefs" and b as "denominator_coefs", and the
analysis methods read those swapped stores, reproduced here).

The w-recurrence runs one of two ways, the JAX package's:

* ``"scan"``: sequential in time, exact streaming semantics; on a CPU
  tensor its plain version :func:`iir_scan_torch`, a torch loop over time
  vectorized over lanes;
* ``"parallel"``: the companion-matrix affine recurrence in O(log T) depth
  (``ops/linrec.py::affine_scan``, full float32 under ``fp32_exact`` as
  JAX's ``precision="highest"``) on a CPU tensor.

On a CUDA tensor both are S3, the time-parallel chunk-and-join kernel
(``ops/cuda_scan.py::iir_scan_cuda``, ``csrc/iir_scan.cu``): chunks run from
a zero state, their ends joined through float64 powers of the companion
matrix, each chunk run again from its true start -- a two-level block-
parallel evaluation of the same affine recurrence; :func:`iir_chunked_torch`
is its plain version (the same association in torch ops), held against the
kernel by the card tests.  :func:`sos_cascade_apply` runs a cascade of up to
8 real biquads on the card as one pipeline of the same kernel
(``cuda_scan.sos_cascade_cuda``; plain version
:func:`sos_cascade_chunked_torch`).

``"auto"`` (:func:`resolve_iir_method`) takes the parallel route for 64-bit
types and for 32-bit filters whose poles all lie within
``PARALLEL_SAFE_RADIUS_32BIT``, the scan otherwise.  The ``b`` taps run as a
``conv1d_mxu`` on the w sequence with the carried history as its tail.  The
classes hold their coefficients and carry on ``device`` (the card unless
told otherwise); ``state`` reads and sets the carry (``interop.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..analysis.freq_response import iir_frequency_response
from ..analysis.group_delay import iir_group_delay
from ..device import resolve_device
from . import cuda_scan, linrec
from .fir import _ingest, conv1d_mxu
from .linrec import affine_scan

__all__ = ["iir_init", "iir_apply", "iir_scan_torch", "iir_chunked_torch",
           "max_pole_radius", "resolve_iir_method",
           "PARALLEL_SAFE_RADIUS_32BIT", "sos_init", "sos_cascade_apply",
           "sos_cascade_chunked_torch", "IIRFilterType", "IIRFilter",
           "SecondOrderFilter", "DecimatingIIRFilter",
           "InterpolatingIIRFilter"]


class IIRFilterType:
    NORMAL = "normal"
    SECOND_ORDER = "second_order"


def _normalize(b, a):
    b = np.asarray(b, dtype=np.float64)
    a = np.asarray(a, dtype=np.float64)
    return b / a[0], a / a[0]


def iir_init(order: int, dtype=torch.complex64, batch_shape: tuple = (),
             device=None) -> torch.Tensor:
    """w-state [w[n-1], ..., w[n-order]] (zeros) on ``device`` (the card
    unless told otherwise)."""
    return torch.zeros((*batch_shape, order), dtype=dtype,
                       device=resolve_device(device))


# Largest pole radius for which the 32-bit parallel route keeps >= 90 dB
# against the sequential scan on million-sample blocks (the JAX package's
# measurement, tests/test_iir.py); beyond it "auto" takes the scan.  64-bit
# parallel stays >= 210 dB even at radius 0.99999.
PARALLEL_SAFE_RADIUS_32BIT = 0.99

_WIDE = (torch.float64, torch.complex128)


def max_pole_radius(a) -> float:
    """Largest |root| of the denominator polynomial (host, float64)."""
    a = np.asarray(a, dtype=np.float64)
    if a.size <= 1:
        return 0.0
    roots = np.roots(a)
    return float(np.max(np.abs(roots))) if roots.size else 0.0


def resolve_iir_method(method: str, a_full, dtype) -> str:
    """"auto" -> "parallel" for 64-bit ``dtype`` (a torch or numpy dtype)
    or poles within ``PARALLEL_SAFE_RADIUS_32BIT``, else "scan"; any other
    method is returned as given.  ``a_full``: the a0-normalized
    denominator, host-side."""
    if method != "auto":
        return method
    wide = (dtype in _WIDE if isinstance(dtype, torch.dtype)
            else np.dtype(dtype) in (np.float64, np.complex128))
    if wide:
        return "parallel"
    return ("parallel"
            if max_pole_radius(a_full) <= PARALLEL_SAFE_RADIUS_32BIT
            else "scan")


def iir_scan_torch(a_tail: torch.Tensor, w_state: torch.Tensor,
                   x: torch.Tensor):
    """S3's plain version: w[n] = x[n] - (a[0] w[n-1] + ... + a[k-1]
    w[n-k]) as a torch loop over time (axis 0 of x), vectorized over the
    lanes (the trailing axes), the sum taken left to right and each product
    and sum rounded on its own, as S3 takes them; a complex product is
    ar wr - ai wi, ar wi + ai wr.  ``a_tail`` (k,) is rounded to x's dtype,
    ``w_state`` (*lanes, k) is [w[-1], ..., w[-k]].  Returns (w, new
    w_state) in x's dtype."""
    k = int(a_tail.shape[-1])
    if a_tail.dim() != 1 or k < 1:
        raise ValueError("iir_scan_torch takes a_tail of shape (k,), k >= 1")
    lanes = tuple(x.shape[1:])
    a = a_tail.to(device=x.device, dtype=x.dtype)
    h = w_state.to(device=x.device, dtype=x.dtype).expand(*lanes, k)
    cplx = x.is_complex()
    if cplx:
        # planes (..., k, 2): h * ar gives (ar hr, ar hi), the flipped
        # planes times (-ai, ai) give (-ai hi, ai hr), each product exact
        # in sign, so their sum is S3's ar hr - ai hi, ar hi + ai hr
        ar = a.real[:, None]
        ai = torch.stack([-a.imag, a.imag], dim=-1)
        h = torch.view_as_real(h.contiguous())
        xs = torch.view_as_real(x)
    else:
        h = h.clone()
        xs = x
    ws = []
    for n in range(x.shape[0]):
        p = h * ar + h.flip(-1) * ai if cplx else h * a
        acc = p[..., 0, :] if cplx else p[..., 0]
        for i in range(1, k):
            acc = acc + (p[..., i, :] if cplx else p[..., i])
        w_n = xs[n] - acc
        h = torch.cat([w_n.unsqueeze(-2 if cplx else -1),
                       h[..., :-1, :] if cplx else h[..., :-1]],
                      dim=-2 if cplx else -1)
        ws.append(w_n)
    w = torch.stack(ws) if ws else xs.clone()
    if cplx:
        return torch.view_as_complex(w), torch.view_as_complex(h.contiguous())
    return w, h


def iir_chunked_torch(a_tail: torch.Tensor, w_state: torch.Tensor,
                      x: torch.Tensor, chunk: int | None = None):
    """S3's plain version on the card's association: the blocks of
    ``chunk`` rows (by default ``linrec.chunk_rows`` of the companion
    matrix, as the kernel takes) run from a zero state by
    :func:`iir_scan_torch`, their
    end states joined in float64 (complex128) through powers of the
    companion matrix of ``a_tail`` rounded to x's dtype, each block run
    again from its start rounded once to x's dtype.  The same arguments and
    results as :func:`iir_scan_torch`; it differs from it only by the
    rounding of the chunk starts, and from the kernel only by the order of
    the float64 join's sums."""
    k = int(a_tail.shape[-1])
    if a_tail.dim() != 1 or k < 1:
        raise ValueError("iir_chunked_torch takes a_tail of shape (k,), "
                         "k >= 1")
    lanes = tuple(x.shape[1:])
    a = a_tail.to(device=x.device, dtype=x.dtype)
    h0 = w_state.to(device=x.device, dtype=x.dtype).expand(*lanes, k)
    if x.shape[0] == 0:
        return x.clone(), h0.clone()
    A = linrec.companion(linrec.rounded(
        linrec.host_values(a_tail), x.dtype))
    return linrec.chunked_walk(lambda h, rows: iir_scan_torch(a, h, rows), A,
                               chunk or linrec.chunk_rows(A, x.dtype), h0,
                               x, linrec.WIDE[x.dtype])


def _w_recurrence_scan(a_tail, w_state, x, a_host=None):
    """The sequential route: S3 on a CUDA tensor, its plain version on a
    CPU tensor."""
    if x.is_cuda:
        return cuda_scan.iir_scan_cuda(a_tail, w_state, x, a_host)
    return iir_scan_torch(a_tail, w_state, x)


def _w_recurrence_parallel(a_tail, w_state, x, a_host=None):
    """s[n] = A s[n-1] + e0 x[n] with A the companion matrix of a_tail: on
    a CUDA tensor S3 (a two-level block-parallel evaluation of it); on a
    CPU tensor ``affine_scan`` (s[-1] = w_state folded into the first
    element), w being s[:, 0] and the new state s[-1] (companion form)."""
    if x.is_cuda:
        return cuda_scan.iir_scan_cuda(a_tail, w_state, x, a_host,
                                       parallel=True)
    k = int(a_tail.shape[-1])
    T = int(x.shape[0])
    if T == 0:
        # F6: the JAX package indexes s[-1] of an empty scan and raises
        # (solid_dsp_tpu/ops/iir.py::_w_recurrence_parallel); the port
        # returns the empty block and keeps the state, as "scan" does
        return x.clone(), w_state.to(x.dtype).expand(*x.shape[1:], k).clone()
    A = torch.zeros((k, k), dtype=x.dtype, device=x.device)
    A[0, :] = -a_tail.to(x.dtype)
    if k > 1:
        idx = torch.arange(1, k, device=x.device)
        A[idx, idx - 1] = 1.0
    lead = (1,) * (x.dim() - 1)
    As = A.expand(T, *lead, k, k)
    vs = torch.zeros((*x.shape, k), dtype=x.dtype, device=x.device)
    vs[..., 0] = x
    vs[0] = vs[0] + torch.einsum("ij,...j->...i", A, w_state.to(x.dtype))
    s = affine_scan(As, vs)
    return s[..., 0], s[-1]


def iir_apply(b, a_tail, w_state, x, method: str = "parallel"):
    """One IIR block in DF-II form: (y, new_w_state).

    b: a0-normalized numerator (nb,); a_tail: a0-normalized a[1:] (k,);
    w_state: (*lanes, k) carry; x: (T, *lanes), time along axis 0 as in the
    JAX package.  The recurrence runs in the type x, a_tail and w_state
    promote to; ``method`` "scan" (S3 on the card) or "parallel"."""
    x = torch.as_tensor(x)
    a_tail = torch.as_tensor(a_tail)
    a_host = a_tail     # S3 reads its values from the caller's tensor
    a_tail = a_tail.to(x.device)
    b = torch.as_tensor(b, device=x.device)
    w_state = torch.as_tensor(w_state, device=x.device)
    cd = torch.promote_types(torch.promote_types(x.dtype, a_tail.dtype),
                             w_state.dtype)
    x, a_tail, w_state = x.to(cd), a_tail.to(cd), w_state.to(cd)
    if method == "scan":
        w_seq, w_state_new = _w_recurrence_scan(a_tail, w_state, x, a_host)
    elif method == "parallel":
        w_seq, w_state_new = _w_recurrence_parallel(a_tail, w_state, x,
                                                    a_host)
    else:
        raise ValueError(f"unknown IIR method {method!r}")
    # y[n] = sum_i b[i] w[n-i]: an FIR on the w sequence (time moved last)
    # whose tail is the incoming history, oldest first
    nb = int(b.shape[-1])
    if nb == 1:
        return w_seq * b[0].to(w_seq.dtype), w_state_new
    tail = torch.flip(w_state[..., : nb - 1], dims=(-1,))
    w_ext = torch.cat([tail, w_seq.movedim(0, -1)], dim=-1)
    y = conv1d_mxu(w_ext, torch.flip(b, dims=(-1,)).to(w_seq.dtype))
    return y.movedim(-1, 0), w_state_new


def sos_init(nsections: int, dtype=torch.complex64, batch_shape: tuple = (),
             device=None) -> torch.Tensor:
    """Per-section DF-II state (*batch, nsections, 2) on ``device``."""
    return torch.zeros((*batch_shape, nsections, 2), dtype=dtype,
                       device=resolve_device(device))


def sos_cascade_apply(sos_b, sos_a_tail, state, x, method: str = "parallel"):
    """A cascade of biquads: one :func:`iir_apply` a section in order on a
    CPU tensor; on a CUDA tensor with real-valued coefficients and 1 to 8
    sections the whole cascade in one pipeline of S3's launches
    (``cuda_scan.sos_cascade_cuda``, "scan" and "parallel" alike; more
    sections or complex coefficients: one S3 pipeline a section).

    sos_b: (S, 3) normalized numerators; sos_a_tail: (S, 2) normalized
    a[1:]; state: (S, 2) per-section [w[n-1], w[n-2]] (or (S, *lanes,
    2)).  Returns (y, new_state (S, 2))."""
    y = torch.as_tensor(x)
    if y.is_cuda and 1 <= int(sos_b.shape[0]) <= 8:
        host = np.concatenate([linrec.host_values(sos_b),
                               linrec.host_values(sos_a_tail)], axis=1)
        if not np.any(np.imag(host)):
            if method not in ("scan", "parallel"):
                raise ValueError(f"unknown IIR method {method!r}")
            sb, sa = torch.as_tensor(sos_b), torch.as_tensor(sos_a_tail)
            st = torch.as_tensor(state, device=y.device)
            cd = torch.promote_types(torch.promote_types(
                torch.promote_types(y.dtype, sb.dtype), sa.dtype), st.dtype)
            return cuda_scan.sos_cascade_cuda(sb, sa, st.to(cd), y.to(cd),
                                              np.real(host))
    new_states = []
    for s in range(int(sos_b.shape[0])):
        y, st = iir_apply(sos_b[s], sos_a_tail[s], state[s], y, method)
        new_states.append(st)
    return y, torch.stack(new_states)


def _cascade_walk(co: torch.Tensor, h: torch.Tensor, x: torch.Tensor):
    """K6's cascade step (csrc/iir_scan.cu) over x (T, *lanes) real from the
    state h (*lanes, 2S) [w1_0, w2_0, ...], each product and sum rounded on
    its own: (y, new h)."""
    S = co.shape[0]
    w = list(h.unbind(-1))
    ys = []
    for t in range(x.shape[0]):
        v = x[t]
        for s in range(S):
            b0, b1, b2, a1, a2 = co[s]
            w1, w2 = w[2 * s], w[2 * s + 1]
            fb = a1 * w1 + a2 * w2
            ff = b1 * w1 + b2 * w2
            w0 = v - fb
            v = b0 * w0 + ff
            w[2 * s], w[2 * s + 1] = w0, w1
        ys.append(v)
    y = torch.stack(ys) if ys else x.clone()
    return y, torch.stack(w, dim=-1)


def sos_cascade_chunked_torch(sos_b, sos_a_tail, state, x):
    """The fused cascade's plain version, on the card kernel's association
    (``cuda_scan.sos_cascade_cuda``): K6's step a row, chunks of
    ``linrec.chunk_rows`` rows of the cascade's one-step map from a zero
    state, their 2S-vector ends joined in float64 through
    powers of the cascade's one-step map, each chunk again from its start
    rounded to the working type.  Real coefficients; the same arguments and
    results as :func:`sos_cascade_apply`, which it matches to rounding (its
    b taps run inside the step, not as a convolution after it)."""
    y = torch.as_tensor(x)
    sb = torch.as_tensor(sos_b, device=y.device)
    sa = torch.as_tensor(sos_a_tail, device=y.device)
    st = torch.as_tensor(state, device=y.device)
    cd = torch.promote_types(torch.promote_types(
        torch.promote_types(y.dtype, sb.dtype), sa.dtype), st.dtype)
    rdt = torch.empty(0, dtype=cd).real.dtype
    S = int(sb.shape[0])
    host = np.concatenate([linrec.host_values(sb),
                           linrec.host_values(sa)], axis=1)
    if np.any(np.imag(host)):
        raise TypeError("the fused cascade takes real coefficients")
    coef = linrec.rounded(np.real(host), rdt)
    co = torch.from_numpy(coef).to(y.device, rdt)
    y = y.to(cd)
    lanes = tuple(y.shape[1:])
    st = st.to(cd)
    st = st.reshape(S, *(1,) * (len(lanes) + 2 - st.dim()),
                    *st.shape[1:]).expand(S, *lanes, 2)
    cplx = y.is_complex()
    xr = torch.view_as_real(y) if cplx else y
    # (S, *lanes, 2) -> (*real lanes, 2S) rows [w1_0, w2_0, w1_1, ...]
    sr = torch.view_as_real(st) if cplx else st
    sr = sr.movedim(-2 if cplx else -1, 1).reshape(2 * S, *xr.shape[1:])
    A = linrec.cascade_matrix(coef)
    out, h = linrec.chunked_walk(lambda h, rows: _cascade_walk(co, h, rows),
                                 A, linrec.chunk_rows(A, rdt),
                                 sr.movedim(0, -1), xr, torch.float64)
    h = h.movedim(-1, 0).reshape(S, 2, *xr.shape[1:]).movedim(
        1, -2 if cplx else -1)
    if cplx:
        return (torch.view_as_complex(out.contiguous()),
                torch.view_as_complex(h.contiguous()))
    return out, h


# ---------------------------------------------------------------------------
# stateful wrappers (the reference's API shape)
# ---------------------------------------------------------------------------

def _coef(h: np.ndarray, dtype, device) -> torch.Tensor:
    """Host float64 coefficients rounded to ``dtype`` (None keeps float64)
    on ``device``."""
    t = torch.from_numpy(np.ascontiguousarray(h))
    return t.to(device=device, dtype=torch.float64 if dtype is None else dtype)


class SecondOrderFilter:
    """One DF-II biquad (ref src/filter/iir/sos.rs).  ``numerator_coefs()``
    returns a[1:] and ``denominator_coefs()`` b, the reference's swapped
    stores (sos.rs:72-73), so the analysis methods give its golden
    values."""

    def __init__(self, feed_forward, feed_back, dtype=None,
                 method: str = "auto", device=None):
        ff = np.asarray(feed_forward, dtype=np.float64)
        fb = np.asarray(feed_back, dtype=np.float64)
        if ff.size < 3 or fb.size < 3:
            raise ValueError("coefficients not in range")
        b, a = _normalize(ff[:3], fb[:3])
        self.device = resolve_device(device)
        self._b = _coef(b, dtype, self.device)
        self._a_tail = _coef(a[1:], dtype, self.device)
        self._state = torch.zeros(2, dtype=self._b.dtype, device=self.device)
        self.method = resolve_iir_method(method, a, self._b.dtype)

    @property
    def state(self) -> dict:
        """{"state": (2,)}, the JAX object's ``_state``."""
        return {"state": self._state}

    @state.setter
    def state(self, st: dict):
        self._state = st["state"].to(self.device)

    def numerator_coefs(self) -> np.ndarray:
        return self._a_tail.cpu().numpy()

    def denominator_coefs(self) -> np.ndarray:
        return self._b.cpu().numpy()

    def execute_block(self, samples):
        samples = _ingest(samples, self.device)
        st = self._state.to(torch.promote_types(self._state.dtype,
                                                samples.dtype))
        y, self._state = iir_apply(self._b, self._a_tail, st, samples,
                                   self.method)
        return y

    def execute(self, sample):
        return self.execute_block(np.asarray([sample]))[0]

    def frequency_response(self, frequency: float) -> complex:
        # parity quirk: probes the swapped stores (sos.rs:171-191)
        return iir_frequency_response(self.numerator_coefs(),
                                      self.denominator_coefs(), frequency)

    def group_delay(self, frequency: float) -> float:
        # parity quirk: swapped stores, +2 samples (sos.rs:208-231)
        return iir_group_delay(self.numerator_coefs(),
                               self.denominator_coefs(), frequency) + 2.0


class IIRFilter:
    """IIR filter, Normal (one DF-II recurrence) or SecondOrder (a biquad
    cascade, one recurrence a section).  Ref src/filter/iir/mod.rs:68-413."""

    def __init__(self, feed_forward, feed_back,
                 iirtype: str = IIRFilterType.NORMAL, dtype=None,
                 method: str = "auto", device=None):
        ff = np.asarray(feed_forward, dtype=np.float64)
        fb = np.asarray(feed_back, dtype=np.float64)
        self.iirtype = iirtype
        self.method = method
        self.device = resolve_device(device)
        self._sections: list[SecondOrderFilter] = []
        self._sos = None          # the sections' (b, a[1:]) stacked, on use
        if iirtype == IIRFilterType.NORMAL:
            if ff.size == 0:
                raise ValueError("numerator length zero")
            if fb.size == 0:
                raise ValueError("denominator length zero")
            b, a = _normalize(ff, fb)
            self._b = _coef(b, dtype, self.device)
            self._a_tail = _coef(a[1:], dtype, self.device)
            self.method = resolve_iir_method(method, a, self._b.dtype)
            # the recurrence carries len(a) - 1 entries; the b taps may read
            # older w's, so the carry is max(len(a), len(b)) - 1 long and the
            # recurrence runs on a[1:] padded with zeros to it
            k = max(len(a) - 1, len(b) - 1, 1)
            self._k = k
            self._state = torch.zeros(k, dtype=self._b.dtype,
                                      device=self.device)
            self._a_full = _coef(np.concatenate([a[1:], np.zeros(
                k - (len(a) - 1))]), dtype, self.device)
        elif iirtype == IIRFilterType.SECOND_ORDER:
            if ff.size != fb.size:
                raise ValueError("second order section size mismatch")
            if ff.size == 0:
                raise ValueError("second order section size zero")
            if ff.size % 3 != 0:
                raise ValueError("second order section size not multiple of 3")
            for i in range(ff.size // 3):
                self._sections.append(SecondOrderFilter(
                    ff[3 * i: 3 * i + 3], fb[3 * i: 3 * i + 3], dtype=dtype,
                    method=method, device=self.device))
            self._num_store = ff          # forward stores (mod.rs:162-167)
            self._den_store = fb
        else:
            raise ValueError(f"unknown IIR type {iirtype!r}")

    @property
    def state(self) -> dict:
        """{"state": (k,)} for NORMAL (the JAX object's ``_state``);
        {"state": (S, 2)} for SECOND_ORDER, its sections' ``_state``
        stacked."""
        if self.iirtype == IIRFilterType.NORMAL:
            return {"state": self._state}
        return {"state": torch.stack([s._state for s in self._sections])}

    @state.setter
    def state(self, st: dict):
        w = st["state"].to(self.device)
        if self.iirtype == IIRFilterType.NORMAL:
            self._state = w
        else:
            for sec, ws in zip(self._sections, w):
                sec._state = ws.clone()

    def iir_type(self) -> str:
        return self.iirtype

    def second_order_filters(self) -> list[SecondOrderFilter]:
        return self._sections

    def numerator_coefs(self) -> np.ndarray:
        if self.iirtype == IIRFilterType.NORMAL:
            return self._b.cpu().numpy()
        return self._num_store

    def denominator_coefs(self) -> np.ndarray:
        if self.iirtype == IIRFilterType.NORMAL:
            return self._a_tail.cpu().numpy()
        return self._den_store

    def execute_block(self, samples):
        samples = _ingest(samples, self.device)
        if self.iirtype == IIRFilterType.NORMAL:
            st = self._state.to(torch.promote_types(self._state.dtype,
                                                    samples.dtype))
            y, self._state = iir_apply(self._b, self._a_full, st, samples,
                                       self.method)
            return y
        if samples.is_cuda:
            return self._cascade_block(samples)
        y = samples
        for sec in self._sections:
            y = sec.execute_block(y)
        return y

    def _cascade_block(self, samples):
        """The sections as one cascade (``sos_cascade_apply``: on the card
        one pipeline of launches), their carries updated."""
        secs = self._sections
        if self._sos is None:
            self._sos = (torch.stack([s._b for s in secs]),
                         torch.stack([s._a_tail for s in secs]))
        st = torch.stack([s._state for s in secs])
        st = st.to(torch.promote_types(st.dtype, samples.dtype))
        y, new = sos_cascade_apply(*self._sos, st, samples, secs[0].method)
        for sec, ns in zip(secs, new):
            sec._state = ns
        return y

    def execute(self, sample):
        return self.execute_block(np.asarray([sample]))[0]

    def frequency_response(self, frequency: float) -> complex:
        if self.iirtype == IIRFilterType.NORMAL:
            # parity: the reference probes b against a[1:] (mod.rs:336-372)
            return iir_frequency_response(self.numerator_coefs(),
                                          self.denominator_coefs(), frequency)
        # parity quirk: the reference multiplies the sections' responses
        # into h = 0, so the cascade's response is always 0 (mod.rs:358-366)
        return complex(0.0, 0.0)

    def group_delay(self, frequency: float) -> float:
        if self.iirtype == IIRFilterType.NORMAL:
            return iir_group_delay(self.numerator_coefs(),
                                   self.denominator_coefs(), frequency)
        # parity: the sections' delays + 2 each, summed (mod.rs:392-413)
        return float(sum(s.group_delay(frequency) + 2.0
                         for s in self._sections))

    def __repr__(self) -> str:
        return f"IIR<{self.iirtype}>"


class _Delegating:
    """The inner filter's coefficient and analysis methods (ref
    decim.rs:72-142, interp.rs:70-140)."""

    filter: IIRFilter

    def numerator_coefs(self) -> np.ndarray:
        return self.filter.numerator_coefs()

    def denominator_coefs(self) -> np.ndarray:
        return self.filter.denominator_coefs()

    def second_order_filters(self) -> list:
        return self.filter.second_order_filters()

    def iir_type(self) -> str:
        return self.filter.iir_type()

    def frequency_response(self, frequency: float) -> complex:
        return self.filter.frequency_response(frequency)

    def group_delay(self, frequency: float) -> float:
        return self.filter.group_delay(frequency)


class DecimatingIIRFilter(_Delegating):
    """IIR run every sample, every ``decimation``-th output kept (the
    reference's counter increments first and emits when it wraps to 0,
    decim.rs:190-198)."""

    def __init__(self, feed_forward, feed_back, iirtype: str, decimation: int,
                 dtype=None, device=None):
        if decimation < 1:
            raise ValueError("decimation less than one")
        self.filter = IIRFilter(feed_forward, feed_back, iirtype, dtype=dtype,
                                device=device)
        self.decimation = int(decimation)
        self._index = 0

    @property
    def state(self) -> dict:
        """The inner filter's state and {"index": the counter}."""
        return {**self.filter.state, "index": torch.tensor(self._index)}

    @state.setter
    def state(self, st: dict):
        self.filter.state = st
        self._index = int(st["index"])

    def execute_block(self, samples):
        y = self.filter.execute_block(samples)
        n = int(y.shape[-1])
        first = (self.decimation - 1 - self._index) % self.decimation
        self._index = (self._index + n) % self.decimation
        return y[..., first::self.decimation]

    def execute(self, sample):
        """One sample: an empty block on pushes that emit nothing."""
        return self.execute_block(np.asarray([sample]))

    def get_decimation(self) -> int:
        return self.decimation


class InterpolatingIIRFilter(_Delegating):
    """Zero-stuffing IIR interpolator: each input followed by
    ``interpolation`` - 1 zeros through the filter (interp.rs:184-190)."""

    def __init__(self, feed_forward, feed_back, iirtype: str,
                 interpolation: int, dtype=None, device=None):
        if interpolation < 1:
            raise ValueError("interpolation less than one")
        self.filter = IIRFilter(feed_forward, feed_back, iirtype, dtype=dtype,
                                device=device)
        self.interpolation = int(interpolation)

    @property
    def state(self) -> dict:
        return self.filter.state

    @state.setter
    def state(self, st: dict):
        self.filter.state = st

    def execute_block(self, samples):
        x = _ingest(samples, self.filter.device)
        stuffed = torch.zeros((*x.shape[:-1], x.shape[-1] * self.interpolation),
                              dtype=x.dtype, device=x.device)
        stuffed[..., ::self.interpolation] = x
        return self.filter.execute_block(stuffed)

    def execute(self, sample):
        """One input -> ``interpolation`` outputs."""
        return self.execute_block(np.asarray([sample]))

    def get_interpolation(self) -> int:
        return self.interpolation
