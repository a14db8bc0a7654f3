"""AGC: automatic gain control with lock and the 7-state squelch FSM.

Port of ``solid_dsp_tpu/ops/agc.py`` (reference
``src/auto_gain_control/mod.rs``).  Per sample (the reference's semantics):

    out = x * gain;  E = (1 - alpha) E + alpha |out|^2
    locked:   emit out
    unlocked: gain *= exp(-alpha/2 ln E) if E > 1e-6; gain = min(gain, 1e6);
              step the squelch FSM on rssi = -20 log10(gain);
              emit x if the mode is ENABLED, else out * scale

Three ways to run it:

* ``agc_apply``: the exact per-sample scan.  On a CUDA tensor it is one
  launch of S1 (``ops/cuda_scan.py``, ``csrc/seq_scan.cu``); on a CPU
  tensor its plain version :func:`agc_scan_plain`, a torch loop over time
  vectorized over the leading axes;
* ``agc_apply_parallel``: the same semantics solved block-parallel by a
  clipped Newton/DEER iteration over (ln E, ln gain) whose linearized
  correction is a 2x2 affine recurrence taken by
  ``ops/linrec.py::associative_scan``; the squelch FSM runs after it (S1's
  FSM entry on the card) only when the mode is not DISABLED; it falls back
  to the exact scan (S1 on the card) when the residual or the 1e-6 / 1e6
  gates trip.  JAX's ``while_loop`` and its two ``lax.cond``s are host
  decisions on one scalar each here: ``agc_apply_parallel.syncs`` counts
  them for the last call, ``.newton_iters`` its iterations, and
  ``.fallbacks`` the fall-backs over all calls;
* ``agc_apply_block_mode``: one gain a block, updated from the block's mean
  energy (a carry with a batch shape holds one gain per leading index).

The carry is ``gain, energy, lock, mode, timer`` with the JAX package's
dtypes (``agc_init``), so checkpoints move both ways.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from . import cuda_scan
from .linrec import associative_scan

__all__ = ["SquelchMode", "agc_init", "agc_apply", "agc_apply_parallel",
           "agc_scan_plain", "squelch_fsm_plain", "squelch_fsm_chunked_torch",
           "agc_scan_consts",
           "block_gain_update", "agc_apply_block_mode", "AGC"]


class SquelchMode:
    UNKNOWN = 0
    ENABLED = 1
    RISE = 2
    SIGNALHI = 3
    FALL = 4
    SIGNALLO = 5
    TIMEOUT = 6
    DISABLED = 7


def agc_init(dtype=torch.float32, device=None, batch_shape: tuple = ()
             ) -> dict:
    """Initial AGC carry: gain, energy, lock, squelch mode and timer, each
    of shape ``batch_shape`` with the JAX package's dtypes, on ``device``
    (the card unless told otherwise)."""
    device = resolve_device(device)
    shape = tuple(batch_shape)
    return {
        "gain": torch.ones(shape, dtype=dtype, device=device),
        "energy": torch.ones(shape, dtype=dtype, device=device),
        "lock": torch.zeros(shape, dtype=torch.bool, device=device),
        "mode": torch.full(shape, SquelchMode.DISABLED, dtype=torch.int32,
                           device=device),
        "timer": torch.zeros(shape, dtype=torch.int32, device=device),
    }


def block_gain_update(state: dict, ee: torch.Tensor, alpha: float, T: int):
    """One block's gain/energy update from ``ee``, the mean |out|^2 over the
    T-sample block: energy tracks ee with the block's combined EMA weight
    1 - (1 - alpha)^T, and the gain is rescaled by energy^-1/2 (capped at
    1e6) when the energy is above 1e-6."""
    gain = state["gain"]
    beta = 1.0 - (1.0 - alpha) ** T
    energy = (1.0 - beta) * state["energy"] + beta * ee
    gain = torch.where(energy > 1e-6,
                       gain * torch.exp(-0.5 * torch.log(energy)), gain)
    gain = torch.clamp(gain, max=1e6)
    return {**state, "gain": gain, "energy": energy}


def agc_apply_block_mode(state: dict, x: torch.Tensor, alpha: float):
    """Block-mode AGC: scale the block by the carried gain, then update the
    gain from the mean |out|^2 of the scaled block.  A gain with a batch
    shape scales the matching leading dims of x (..., T), one gain per row.
    Returns (out, state)."""
    gain = state["gain"].to(x.dtype)
    out = x * (gain[..., None] if gain.dim() else gain)
    ee = torch.mean((out * out.conj()).real, dim=-1)
    return out, block_gain_update(state, ee, alpha, x.shape[-1])


# ---------------------------------------------------------------------------
# the exact per-sample scan (S1 and its plain version)
# ---------------------------------------------------------------------------

def _np_real(rdt: torch.dtype):
    return np.float64 if rdt == torch.float64 else np.float32


def agc_scan_consts(alpha, rdt: torch.dtype):
    """(1 - alpha, alpha, -alpha / 2) in the working real type, as the JAX
    package forms them: a Python float ``alpha`` is a weak constant (the
    expression is taken in float64, then rounded); a numpy scalar or a
    tensor is already of the working type (the expression in that type,
    as ``agc_apply_parallel`` hands its alpha to the fall-back)."""
    f = _np_real(rdt)
    if isinstance(alpha, (np.floating, torch.Tensor)):
        a = f(float(alpha))
        return float(f(1.0) - a), float(a), float(f(-0.5) * a)
    return float(f(1.0 - alpha)), float(f(alpha)), float(f(-0.5 * alpha))


def _squelch_update(mode, timer, rssi, threshold, timeout):
    """The 7-state FSM, vectorized (ref auto_gain_control/mod.rs:631-677):
    FALL arms the timer, SIGNALLO counts it down, then the transition."""
    S = SquelchMode
    thr = rssi > threshold
    timer = torch.where(mode == S.FALL, torch.full_like(timer, timeout),
                        timer)
    timer = torch.where(mode == S.SIGNALLO, timer - 1, timer)

    def pick(c, a, b):
        return torch.where(c, torch.full_like(mode, a),
                           torch.full_like(mode, b))

    new = torch.full_like(mode, S.DISABLED)
    for m, val in ((S.TIMEOUT, torch.full_like(mode, S.ENABLED)),
                   (S.SIGNALLO, torch.where(timer == 0,
                                            torch.full_like(mode, S.TIMEOUT),
                                            pick(thr, S.SIGNALHI,
                                                 S.SIGNALLO))),
                   (S.FALL, pick(thr, S.SIGNALHI, S.SIGNALLO)),
                   (S.SIGNALHI, pick(thr, S.SIGNALHI, S.FALL)),
                   (S.RISE, pick(thr, S.SIGNALHI, S.FALL)),
                   (S.ENABLED, pick(thr, S.RISE, S.ENABLED))):
        new = torch.where(mode == m, val, new)
    return new.to(torch.int32), timer


def agc_scan_plain(state: dict, x: torch.Tensor, alpha, scale,
                   squelch_threshold, squelch_timeout):
    """S1's plain version: the exact scan as a torch loop over time (the
    last axis), vectorized over the leading axes, in S1's arithmetic and
    order.  The FSM is skipped while every mode is DISABLED (DISABLED maps
    to DISABLED; one host read a call).  Returns (y, new_state)."""
    rdt = state["energy"].dtype
    c1, c2, c3 = agc_scan_consts(alpha, rdt)
    lead = x.shape[:-1]
    gain = state["gain"].to(x.device).expand(lead).clone()
    energy = state["energy"].to(x.device).expand(lead).clone()
    lock = state["lock"].to(x.device).expand(lead)
    mode = state["mode"].to(x.device).expand(lead).clone()
    timer = state["timer"].to(x.device).expand(lead).clone()
    fsm = bool((mode != SquelchMode.DISABLED).any())
    scale_c = torch.tensor(scale, dtype=x.dtype, device=x.device)
    ys = []
    for n in range(x.shape[-1]):
        x_n = x[..., n]
        out = x_n * gain.to(x_n.dtype)
        ee = (out * out.conj()).real.to(rdt)
        energy = c1 * energy + ee * c2
        gain_new = torch.where(energy > 1e-6,
                               gain * torch.exp(c3 * torch.log(energy)),
                               gain)
        gain_new = torch.clamp(gain_new, max=1e6)
        if fsm:
            rssi = torch.log10(gain_new) * -20.0
            mode_new, timer_new = _squelch_update(
                mode, timer, rssi, squelch_threshold, squelch_timeout)
            out_unlocked = torch.where(mode_new == SquelchMode.ENABLED, x_n,
                                       out * scale_c)
            mode = torch.where(lock, mode, mode_new)
            timer = torch.where(lock, timer, timer_new)
        else:
            out_unlocked = out * scale_c
        ys.append(torch.where(lock, out, out_unlocked))
        gain = torch.where(lock, gain, gain_new)
    y = torch.stack(ys, dim=-1) if ys else x.clone()
    return y, {"gain": gain, "energy": energy, "lock": lock.clone(),
               "mode": mode, "timer": timer}


def _exact_scan(state, x, alpha, scale, squelch_threshold, squelch_timeout,
                fallback: bool):
    if x.is_cuda:
        if complex(scale).imag != 0.0:
            raise ValueError("S1 takes a real scale")
        c1, c2, c3 = agc_scan_consts(alpha, state["energy"].dtype)
        return cuda_scan.agc_scan_cuda(state, x, c1, c2, c3,
                                       complex(scale).real,
                                       squelch_threshold, squelch_timeout,
                                       fallback=fallback)
    return agc_scan_plain(state, x, alpha, scale, squelch_threshold,
                          squelch_timeout)


def agc_apply(state: dict, x: torch.Tensor, alpha, scale,
              squelch_threshold, squelch_timeout):
    """Exact per-sample AGC over a block: x (..., T), time LAST, the
    leading axes independent carries.  S1 for a CUDA tensor (a real
    ``scale``), its plain version for a CPU tensor.  Returns
    (y, new_state)."""
    return _exact_scan(state, x, alpha, scale, squelch_threshold,
                       squelch_timeout, fallback=False)


def squelch_fsm_plain(rssi: torch.Tensor, mode, timer, threshold, timeout):
    """S1's FSM entry, plain: the FSM over rssi (..., T) in a torch loop.
    Returns (modes (..., T) int32, final mode, final timer)."""
    m = mode.to(rssi.device).expand(rssi.shape[:-1]).to(torch.int32)
    t = timer.to(rssi.device).expand(rssi.shape[:-1]).to(torch.int32)
    modes = []
    for n in range(rssi.shape[-1]):
        m, t = _squelch_update(m, t, rssi[..., n], threshold, timeout)
        modes.append(m)
    return torch.stack(modes, dim=-1), m, t


# S1's FSM entry, chunked (the association of csrc/seq_scan.cu's fsm
# namespace, whose note derives the form): a track is (mode, keep, v), its
# timer the entry's minus v where keep, else v.  Tracks 0-4 enter ENABLED,
# RISE, SIGNALHI, FALL, TIMEOUT; 5-7 SIGNALLO (any timer but the next two;
# timer L; timer L + 1, L the run's leading steps at or below the threshold).
_TRACK_MODE = (1, 2, 3, 4, 6, 5, 5, 5)
_NEXT_LO = (7, 1, 4, 4, 5, 5, 1, 7)     # next mode per mode, rssi <= thr
_NEXT_HI = (7, 2, 3, 3, 3, 3, 1, 7)     # and rssi > thr


def _fsm_step(m, keep, v, hi, timeout: int, tables):
    """One step of tracks (or, keep False, of the FSM itself): FALL arms the
    timer, SIGNALLO counts it down, then the transition."""
    S = SquelchMode
    fall, low = m == S.FALL, m == S.SIGNALLO
    v = torch.where(fall, timeout, torch.where(low & keep, v + 1,
                                               torch.where(low, v - 1, v)))
    keep = keep & ~fall
    lo_tab, hi_tab = tables
    nxt = torch.where(hi, hi_tab[m.long()], lo_tab[m.long()])
    m = torch.where(low & ~keep & (v == 0), S.TIMEOUT, nxt)
    return m, keep, v


def _fsm_apply(summary, m, keep, v):
    """States (m, keep, v) of shape (..., K) through summaries of shape
    (...,) (their tracks (..., 8)), each run n >= 1 steps."""
    S = SquelchMode
    _, L, sm, sk, sv = summary
    L = L[..., None]
    low = m == S.SIGNALLO
    timed = low & ~keep & (v >= 1) & (v <= L - 1)   # times out in L's run
    j_low = torch.where(keep | ~((v == L) | (v == L + 1) | timed), 5,
                        torch.where(timed, 0, torch.where(v == L, 6, 7)))
    j = torch.where((m >= S.ENABLED) & (m <= S.FALL), m - 1,
                    torch.where(m == S.TIMEOUT, 4, -1))
    j = torch.where(low, j_low, j).long()
    v = torch.where(timed, 0, v)
    valid = j >= 0
    jc = j.clamp(min=0)
    cm = torch.gather(sm, -1, jc)
    ck = torch.gather(sk, -1, jc)
    cv = torch.gather(sv, -1, jc)
    new_v = torch.where(ck, torch.where(keep, v + cv, v - cv), cv)
    return (torch.where(valid, cm, S.DISABLED),
            torch.where(valid, keep & ck, keep),
            torch.where(valid, new_v, v))


def _fsm_tracks(L):
    """The tracks' entry states for runs whose leading low run is L."""
    shape = (*L.shape, 8)
    m = torch.tensor(_TRACK_MODE, dtype=torch.int32,
                     device=L.device).expand(shape)
    keep = torch.tensor([True] * 6 + [False] * 2,
                        device=L.device).expand(shape)
    v = torch.zeros(shape, dtype=torch.int32, device=L.device)
    v = torch.cat([v[..., :6], L[..., None], L[..., None] + 1], dim=-1)
    return m, keep, v


def _fsm_compose(a, b):
    """The summary of run a, then run b (both n >= 1): tracks 0-5 leave a
    as a's own tracks, tracks 6 and 7 (timers L and L + 1 of the joined
    run) are taken through a; then all through b."""
    n = a[0] + b[0]
    L = torch.where(a[1] == a[0], a[0] + b[1], a[1])
    m, keep, v = _fsm_tracks(L)
    m7, k7, v7 = _fsm_apply(a, m[..., 6:], keep[..., 6:], v[..., 6:])
    m, keep, v = (torch.cat([x[..., :6], y], dim=-1) for x, y in
                  ((a[2], m7), (a[3], k7), (a[4], v7)))
    m, keep, v = _fsm_apply(b, m, keep, v)
    return n, L, m, keep, v


def squelch_fsm_chunked_torch(rssi: torch.Tensor, mode, timer, threshold,
                              timeout, chunk: int = cuda_scan.FSM_CHUNK):
    """S1's FSM entry by the kernel's three passes in torch ops: each chunk
    of ``chunk`` steps summarised (its tracks walked), the summaries joined
    by a doubling scan of compositions, each chunk walked again from its
    entry state.  Returns (modes (..., T) int32, final mode, final timer),
    equal to :func:`squelch_fsm_plain` (the FSM is integer arithmetic and
    one compare a step; any grouping of the summaries gives the same)."""
    lead = rssi.shape[:-1]
    T = int(rssi.shape[-1])
    dev = rssi.device
    m0 = mode.to(dev).expand(lead).to(torch.int32).reshape(-1)
    t0 = timer.to(dev).expand(lead).to(torch.int32).reshape(-1)
    if T == 0:
        return (torch.empty((*lead, 0), dtype=torch.int32, device=dev),
                m0.reshape(lead), t0.reshape(lead))
    B = m0.shape[0]
    C = int(chunk)
    nc = -(-T // C)
    hi = torch.zeros((B, nc * C), dtype=torch.bool, device=dev)
    hi[:, :T] = (rssi > threshold).reshape(B, T)
    hi = hi.reshape(B, nc, C)
    n = torch.clamp(T - C * torch.arange(nc, device=dev), max=C).to(
        torch.int32).expand(B, nc)
    tables = (torch.tensor(_NEXT_LO, dtype=torch.int32, device=dev),
              torch.tensor(_NEXT_HI, dtype=torch.int32, device=dev))
    # pass 1: each chunk's summary
    L = torch.where(hi.any(-1), hi.to(torch.int32).argmax(-1).to(torch.int32),
                    n)
    m, keep, v = _fsm_tracks(L)
    for s in range(C):
        live = (s < n)[..., None]
        step = _fsm_step(m, keep, v, hi[..., s, None], timeout, tables)
        m, keep, v = (torch.where(live, a, b)
                      for a, b in zip(step, (m, keep, v)))
    summ = (n, L, m, keep, v)
    # pass 2: inclusive prefixes of the chunks by doubling, then each
    # chunk's entry state
    d = 1
    while d < nc:
        left = tuple(f[:, :nc - d] for f in summ)
        right = tuple(f[:, d:] for f in summ)
        summ = tuple(torch.cat([f[:, :d], g], dim=1) for f, g in
                     zip(summ, _fsm_compose(left, right)))
        d *= 2
    em = m0[:, None].expand(B, nc).clone()
    ek = torch.zeros((B, nc), dtype=torch.bool, device=dev)
    ev = t0[:, None].expand(B, nc).clone()
    if nc > 1:
        pm, pk, pv = _fsm_apply(tuple(f[:, :-1] for f in summ),
                                em[:, 1:, None], ek[:, 1:, None],
                                ev[:, 1:, None])
        em[:, 1:], ek[:, 1:], ev[:, 1:] = pm[..., 0], pk[..., 0], pv[..., 0]
    # pass 3: every chunk walked from its entry (a mode outside 0-7 steps
    # as UNKNOWN does)
    m = torch.where((em < 0) | (em > SquelchMode.DISABLED),
                    SquelchMode.UNKNOWN, em)
    keep, v = ek, ev
    modes = torch.empty((B, nc, C), dtype=torch.int32, device=dev)
    for s in range(C):
        live = s < n
        step = _fsm_step(m, keep, v, hi[..., s], timeout, tables)
        m, keep, v = (torch.where(live, a, b)
                      for a, b in zip(step, (m, keep, v)))
        modes[..., s] = m
    modes = modes.reshape(B, nc * C)[:, :T]
    return (modes.reshape(*lead, T), m[:, -1].reshape(lead),
            v[:, -1].reshape(lead))


def _squelch_fsm(rssi, mode, timer, threshold, timeout):
    if rssi.is_cuda:
        return cuda_scan.squelch_fsm_cuda(rssi, mode, timer, threshold,
                                          timeout)
    return squelch_fsm_plain(rssi, mode, timer, threshold, timeout)


# ---------------------------------------------------------------------------
# the block-parallel Newton solve
# ---------------------------------------------------------------------------

def _newton_combine(left, right):
    """(A2, b2) o (A1, b1) = (A2 A1, A2 b1 + b2) for 2x2 affine maps held
    as six arrays (a11, a12, a21, a22, b1, b2): elementwise work only."""
    a11, a12, a21, a22, b1, b2 = left
    c11, c12, c21, c22, d1, d2 = right
    return (c11 * a11 + c12 * a21, c11 * a12 + c12 * a22,
            c21 * a11 + c22 * a21, c21 * a12 + c22 * a22,
            c11 * b1 + c12 * b2 + d1, c21 * b1 + c22 * b2 + d2)


def _affine1_comb(left, right):
    al, bl = left
    ar, br = right
    return ar * al, ar * bl + br


def _affine1_scan(a, b):
    """Prefix of s[t] = a[t] s[t-1] + b[t] (s[-1] folded into b[0])."""
    _, s = associative_scan(_affine1_comb, (a, b))
    return s


def agc_apply_parallel(state: dict, x: torch.Tensor, alpha, scale,
                       squelch_threshold, squelch_timeout,
                       newton_iters: int = 24, coarse_stride: int = 32):
    """Exact-semantics AGC solved block-parallel (scalar state, x (T,)).

    The recurrence E_n = (1-a) E_{n-1} + a |x_n|^2 g_{n-1}^2,
    g_n = g_{n-1} E_n^{-a/2} is a smooth 2-state recurrence in (ln E,
    ln g): a coarse per-group fixed-point guess, then Newton/DEER passes
    whose linearized corrections are 2x2 affine scans, clipped to +-2,
    until the residual is at most 100 eps or after ``newton_iters``.  The
    squelch FSM only selects the output, so it runs afterwards, and only
    when the mode is not DISABLED.  If the final residual exceeds sqrt(eps)
    or the trajectory reaches either gate (E <= 1e-6, g >= 1e6) the exact
    scan runs instead: S1 on the card, whose launch for it is counted on
    ``cuda_scan.agc_scan_cuda.fallback_launches``; ``.fallbacks`` counts
    the decisions on any device.  Host reads: the lock
    and mode together, each iteration's residual and the gate test
    (``.syncs``).  Returns (y, new_state) like :func:`agc_apply`.
    """
    rdt = state["energy"].dtype
    f = _np_real(rdt)
    dev = x.device
    T = x.shape[-1]
    alpha_np = f(alpha)
    alpha_t = torch.tensor(alpha_np, dtype=rdt, device=dev)
    scale_c = torch.tensor(scale, dtype=x.dtype, device=dev)
    u = (x * x.conj()).real.to(rdt)
    tiny = float(f(np.finfo(f).tiny * 1e3))
    eps = float(np.finfo(f).eps)
    tol = float(f(np.sqrt(eps)))
    one_m = 1.0 - alpha_t
    lock_mode = torch.stack([state["lock"].to(torch.int32),
                             state["mode"].to(torch.int32)]).tolist()
    syncs = 1
    agc_apply_parallel.newton_iters = 0

    if lock_mode[0]:
        # gain frozen: y = x g exactly; E_T is a weighted reduction
        g0 = state["gain"]
        y = x * g0.to(x.dtype)
        kk = torch.arange(T - 1, -1, -1, device=dev).to(rdt)
        w = torch.pow(one_m, kk)
        e_t = (torch.pow(one_m, torch.tensor(float(T), dtype=rdt,
                                             device=dev)) * state["energy"]
               + alpha_t * g0 * g0 * torch.dot(w, u))
        agc_apply_parallel.syncs = syncs
        return y, {**state, "energy": e_t}

    G0 = torch.log(torch.clamp(state["gain"], min=tiny))
    F0 = torch.log(torch.clamp(state["energy"], min=tiny))
    ln_clamp = float(f(np.log(1e6)))

    # coarse initializer: per-group fixed-point blend, both recurrences
    # scalar affine, so two log-depth scans
    S = int(coarse_stride)
    Tc = -(-T // S)
    ubar = torch.mean(torch.nn.functional.pad(u, (0, Tc * S - T)
                                              ).reshape(Tc, S), dim=-1)
    rho = torch.pow(one_m, torch.tensor(float(S), dtype=rdt, device=dev))
    lnu = torch.log(torch.clamp(ubar, min=tiny))
    g_fp = torch.clamp(-0.5 * lnu, max=ln_clamp)
    aG = rho.expand(g_fp.shape)
    bG = (1.0 - rho) * g_fp
    bG = torch.cat([bG[:1] + rho * G0, bG[1:]])
    Gc = _affine1_scan(aG, bG)
    f_t = lnu + 2.0 * Gc
    bF = (1.0 - rho) * f_t
    bF = torch.cat([bF[:1] + rho * F0, bF[1:]])
    Fc = _affine1_scan(aG, bF)
    Fhat = torch.repeat_interleave(Fc, S)[:T]
    Ghat = torch.repeat_interleave(Gc, S)[:T]

    def f_eval(Fh, Gh):
        F_in = torch.cat([F0.reshape(1), Fh[:-1]])
        G_in = torch.cat([G0.reshape(1), Gh[:-1]])
        t1 = one_m * torch.exp(F_in)
        t2 = alpha_t * u * torch.exp(2.0 * G_in)
        den = torch.clamp(t1 + t2, min=tiny)
        fF = torch.log(den)
        fG = G_in - 0.5 * alpha_t * fF
        return G_in, fF, fG, t1 / den, 2.0 * t2 / den

    tol_iter = float(f(100.0 * eps))
    res, it = float("inf"), 0
    while res > tol_iter and it < newton_iters:
        _, fF, fG, j11, j12 = f_eval(Fhat, Ghat)
        rF = fF - Fhat
        rG = fG - Ghat
        dF, dG = associative_scan(
            _newton_combine,
            (j11, j12, -0.5 * alpha_t * j11, 1.0 - 0.5 * alpha_t * j12,
             rF, rG))[4:]
        Fhat = Fhat + torch.clamp(dF, -2.0, 2.0)
        Ghat = Ghat + torch.clamp(dG, -2.0, 2.0)
        res = float(torch.maximum(rF.abs().max(), rG.abs().max()))
        syncs += 1
        it += 1
    agc_apply_parallel.newton_iters = it

    G_in, fF, fG, _, _ = f_eval(Fhat, Ghat)
    res_f = (fF - Fhat).abs().max()
    res_g = (fG - Ghat).abs().max()
    ln_gate = float(f(np.log(1.01e-6)))
    bad = ((res_f > tol) | (res_g > tol) | torch.isnan(res_f)
           | torch.isnan(res_g) | (fF.min() <= ln_gate)
           | (Ghat.max() >= ln_clamp - 10 * eps))
    syncs += 1
    if bool(bad):
        agc_apply_parallel.syncs = syncs
        agc_apply_parallel.fallbacks += 1
        return _exact_scan(state, x, alpha_np, scale, squelch_threshold,
                           squelch_timeout, fallback=True)

    mode0, timer0 = state["mode"], state["timer"]
    if lock_mode[1] == SquelchMode.DISABLED:
        modes, mode_t, timer_t = None, mode0, timer0
    else:
        rssi = Ghat * float(f(-20.0 / np.log(10.0)))
        modes, mode_t, timer_t = _squelch_fsm(
            rssi, mode0, timer0, squelch_threshold, squelch_timeout)
    out = x * torch.exp(G_in).to(x.dtype)
    y = (out * scale_c if modes is None
         else torch.where(modes == SquelchMode.ENABLED, x, out * scale_c))
    agc_apply_parallel.syncs = syncs
    return y, {"gain": torch.exp(Ghat[-1]).to(rdt),
               "energy": torch.exp(fF[-1]).to(rdt),
               "lock": state["lock"], "mode": mode_t.to(torch.int32),
               "timer": timer_t.to(torch.int32)}


agc_apply_parallel.syncs = 0
agc_apply_parallel.newton_iters = 0
agc_apply_parallel.fallbacks = 0


# ---------------------------------------------------------------------------
# the stateful AGC
# ---------------------------------------------------------------------------

class AGC:
    """Stateful AGC with the reference's API shape, its carry on ``device``
    (the card unless told otherwise).  ``method``: "scan" (the exact scan,
    S1 on the card) or "parallel" (the Newton solve with its fall-back)."""

    def __init__(self, dtype=None, method: str = "scan", device=None):
        if method not in ("scan", "parallel"):
            raise ValueError(f"unknown AGC method {method!r}")
        self._method = method
        self._dtype = dtype or torch.float64
        self.device = resolve_device(device)
        self.bandwidth = 0.1
        self.alpha = 0.1
        self.scale = 1.0
        self.squelch_threshold = 0.0
        self.squelch_timeout = 100
        self._st = agc_init(self._dtype, self.device)

    @property
    def state(self) -> dict:
        return self._st

    @state.setter
    def state(self, st: dict):
        self._st = dict(st)

    def _scalar(self, v, dtype=None):
        return torch.tensor(v, dtype=dtype or self._dtype,
                            device=self.device)

    def reset(self) -> None:
        mode = int(self._st["mode"])
        new = agc_init(self._dtype, self.device)
        if mode != SquelchMode.DISABLED:
            new["mode"] = self._scalar(SquelchMode.ENABLED, torch.int32)
        self._st = new

    def lock(self) -> None:
        self._st = {**self._st, "lock": self._scalar(True, torch.bool)}

    def unlock(self) -> None:
        self._st = {**self._st, "lock": self._scalar(False, torch.bool)}

    def is_unlocked(self) -> bool:
        # the reference's quirk: is_unlocked returns the lock flag itself
        return bool(self._st["lock"])

    def get_bandwidth(self) -> float:
        return self.bandwidth

    def set_bandwidth(self, bw: float) -> float:
        if not (0.0 <= bw <= 1.0):
            raise ValueError("bandwidth not in range [0, 1]")
        self.bandwidth = bw
        self.alpha = bw
        return bw

    def get_signal_level(self) -> float:
        return 1.0 / float(self._st["gain"])

    def set_signal_level(self, level: float) -> float:
        if level <= 0.0:
            raise ValueError("level is too low (0, inf)")
        self._st = {**self._st, "gain": self._scalar(1.0 / level),
                    "energy": self._scalar(1.0)}
        return level

    def get_rssi(self) -> float:
        return float(np.log10(float(self._st["gain"])) * -20.0)

    def set_rssi(self, rssi: float) -> None:
        gain = max(10.0 ** (-rssi / 20.0), 1e-16)
        self._st = {**self._st, "gain": self._scalar(gain),
                    "energy": self._scalar(1.0)}

    def get_gain(self) -> float:
        return float(self._st["gain"])

    def set_gain(self, gain: float) -> float:
        if gain <= 0.0:
            raise ValueError("gain is below threshold (0, inf)")
        self._st = {**self._st, "gain": self._scalar(gain)}
        return gain

    def get_scale(self) -> float:
        return self.scale

    def set_scale(self, scale: float) -> float:
        if scale <= 0.0:
            raise ValueError("scale is below threshold (0, inf)")
        self.scale = scale
        return scale

    def init(self, samples) -> float:
        """Seed the gain from the RMS of a block, summed sample by sample
        in float64 as the reference's loop does."""
        samples = (samples.detach().cpu().numpy()
                   if isinstance(samples, torch.Tensor)
                   else np.asarray(samples))
        if samples.size == 0:
            raise ValueError("need more than 0 samples to operate")
        e2 = np.real(samples * np.conj(samples)).astype(np.float64)
        x2 = 0.0
        for v in e2:
            x2 += float(v)
        return self.set_signal_level(np.sqrt(x2 / samples.size) + 1e-16)

    def squelch_enable(self) -> None:
        self._st = {**self._st,
                    "mode": self._scalar(SquelchMode.ENABLED, torch.int32)}

    def squelch_disable(self) -> None:
        self._st = {**self._st,
                    "mode": self._scalar(SquelchMode.DISABLED, torch.int32)}

    def is_squelch_enabled(self) -> bool:
        return int(self._st["mode"]) != SquelchMode.DISABLED

    def squelch_get_threshold(self) -> float:
        return self.squelch_threshold

    def squelch_set_threshold(self, t: float) -> None:
        self.squelch_threshold = t

    def squelch_get_timeout(self) -> int:
        return self.squelch_timeout

    def squelch_set_timeout(self, t: int) -> None:
        self.squelch_timeout = t

    def squelch_get_mode(self) -> int:
        return int(self._st["mode"])

    def execute_block(self, samples):
        if not isinstance(samples, torch.Tensor):
            samples = torch.from_numpy(np.array(samples, copy=True))
        samples = samples.to(self.device)
        fn = agc_apply_parallel if self._method == "parallel" else agc_apply
        y, self._st = fn(self._st, samples, self.alpha, self.scale,
                         self.squelch_threshold, self.squelch_timeout)
        return y

    def execute(self, sample):
        return self.execute_block(np.asarray([sample]))[0]

    def __repr__(self) -> str:
        return (f"AGC [Gain={self.get_gain():.5f}] [Scale={self.scale:.5f}] "
                f"[Bandwidth={self.bandwidth:.5f}] [Alpha={self.alpha:.5f}] "
                f"[Energy={float(self._st['energy']):.5f}]")
