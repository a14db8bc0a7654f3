"""Port vs JAX package: models/equalizer.py on the CPU.

Seeded QPSK through a multipath channel goes through both packages, block
after block with the state carried.  Gates: complex64 outputs and carried
taps within 1e-5 x max of JAX's (conv1d and matmul sums in another order),
complex128 within 1e-10; RLS in complex64 within 1e-4 (its block solve
amplifies the sums' rounding by the normal equations' condition); the
trainer's taps after 20 steps of optax's Adam (and of SGD against
``torch.optim.SGD``) within 1e-5; FDAF's error and weights within 1e-5
(complex64 FFTs) after 8 sub-blocks, the canceller's within 1e-4 after
some 60 (the FFTs' rounding fed back through every update).  Every
class's state moves from the JAX object to the port's through ``interop``
and the two continue alike.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from solid_dsp_tpu.models import equalizer as jeq
from solid_dsp_tpu.models import linear_mod as jlm
from solid_dsp_tpu_torch.interop import tensors_from_numpy, tensors_to_numpy
from solid_dsp_tpu_torch.models import equalizer as teq

CPU = "cpu"
H = np.array([1.0, 0.0, 0.35 - 0.2j, 0.0, -0.1j])


def _np(t):
    return np.asarray(t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                      else t)


def _close(got, want, tol):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (
        got.shape, want.shape, got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _link(n, seed=0, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    tx = ((rng.integers(0, 2, n) * 2 - 1)
          + 1j * (rng.integers(0, 2, n) * 2 - 1)) / np.sqrt(2)
    rx = np.convolve(tx, H)[:n] + 0.01 * (rng.standard_normal(n)
                                          + 1j * rng.standard_normal(n))
    return rx.astype(dtype), np.roll(tx, 5).astype(dtype)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("kind", ["lms", "nlms", "cma", "dd"])
def test_block_steps_equal_jax(kind, dtype):
    rx, d = _link(4000, 1, dtype)
    tol = 1e-5 if dtype == np.complex64 else 1e-10
    tdt = torch.complex64 if dtype == np.complex64 else torch.complex128
    taps_t, tail_t = teq.eq_init(11, tdt, CPU)
    taps_j, tail_j = jeq.eq_init(11, dtype)
    _close(taps_t, taps_j, 0)
    pts = jlm.psk_constellation(4).astype(dtype)
    for b in range(4):
        sl = slice(b * 1000, (b + 1) * 1000)
        x, dd = rx[sl], d[sl]
        if kind == "lms":
            out_t = teq.lms_step(taps_t, tail_t, _t(x), _t(dd), 0.1)
            out_j = jeq.lms_step(taps_j, tail_j, jnp.asarray(x),
                                 jnp.asarray(dd), 0.1)
        elif kind == "nlms":
            out_t = teq.nlms_step(taps_t, tail_t, _t(x), _t(dd))
            out_j = jeq.nlms_step(taps_j, tail_j, jnp.asarray(x),
                                  jnp.asarray(dd))
        elif kind == "cma":
            out_t = teq.cma_step(taps_t, tail_t, _t(x), 0.05)
            out_j = jeq.cma_step(taps_j, tail_j, jnp.asarray(x), 0.05)
        else:
            out_t = teq.dd_lms_step(taps_t, tail_t, _t(x), pts, 0.05)
            out_j = jeq.dd_lms_step(taps_j, tail_j, jnp.asarray(x),
                                    jnp.asarray(pts), 0.05)
        for a, b_ in zip(out_t, out_j):
            _close(a, b_, tol)
        _, taps_t, tail_t = out_t
        _, taps_j, tail_j = out_j
    y_t, _ = teq.eq_apply(taps_t, tail_t, _t(rx[:300]))
    _close(y_t, jeq.eq_apply(taps_j, tail_j, jnp.asarray(rx[:300]))[0], tol)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_rls_equals_jax(dtype):
    rx, d = _link(3000, 2, dtype)
    tol = 1e-4 if dtype == np.complex64 else 1e-10
    tdt = torch.complex64 if dtype == np.complex64 else torch.complex128
    init_t, step_t = teq.make_rls(8, 0.99, 1e-2, tdt, CPU)
    init_j, step_j = jeq.make_rls(8, 0.99, 1e-2, dtype)
    st_t, st_j = init_t(), init_j()
    for a, b in zip(st_t, st_j):
        _close(a, b, 0)
    for lo, hi in ((0, 1000), (1000, 1700), (1700, 3000)):
        out_t = step_t(*st_t, _t(rx[lo:hi]), _t(d[lo:hi]))
        out_j = step_j(*st_j, jnp.asarray(rx[lo:hi]), jnp.asarray(d[lo:hi]))
        for a, b in zip(out_t, out_j):
            _close(a, b, tol)
        st_t, st_j = out_t[1:], out_j[1:]


def test_trainer_matches_jax_optax_after_20_steps():
    """The default trainer (optax's Adam semantics, the gradient's
    convention) against JAX + optax: loss, output and taps every step, and
    the Adam moments after 20 steps, within 1e-5."""
    rx, d = _link(20 * 256, 3)
    init_t, step_t = teq.make_equalizer_trainer(7, device=CPU)
    init_j, step_j = jeq.make_equalizer_trainer(7)
    taps_t, opt_t, tail_t = init_t()
    taps_j, opt_j, tail_j = init_j()
    for b in range(20):
        sl = slice(b * 256, (b + 1) * 256)
        y_t, taps_t, opt_t, tail_t, loss_t = step_t(taps_t, opt_t, tail_t,
                                                    _t(rx[sl]), _t(d[sl]))
        y_j, taps_j, opt_j, tail_j, loss_j = step_j(
            taps_j, opt_j, tail_j, jnp.asarray(rx[sl]), jnp.asarray(d[sl]))
        _close(y_t, y_j, 1e-5)
        assert abs(float(loss_t) - float(loss_j)) <= 1e-5 * float(loss_j)
    _close(taps_t, taps_j, 1e-5)
    adam = opt_j[0]
    assert int(opt_t["count"]) == int(adam.count) == 20
    _close(opt_t["mu"], adam.mu, 1e-5)
    _close(opt_t["nu"], adam.nu, 1e-5)
    assert float(loss_t) < 0.5 * float(np.mean(np.abs(d[:256]) ** 2))


def test_trainer_takes_a_torch_optimizer_and_continues_jax_state():
    """``optimizer``: torch.optim.SGD against optax.sgd (the same step on
    dL/dw*); and a JAX trainer's taps and Adam moments moved halfway
    (interop) continue in the port as in JAX."""
    rx, d = _link(8 * 256, 4)
    init_t, step_t = teq.make_equalizer_trainer(
        5, optimizer=lambda p: torch.optim.SGD(p, lr=0.05), device=CPU)
    init_j, step_j = jeq.make_equalizer_trainer(5, optax.sgd(0.05))
    (taps_t, opt_t, tail_t), (taps_j, opt_j, tail_j) = init_t(), init_j()
    for b in range(8):
        sl = slice(b * 256, (b + 1) * 256)
        _, taps_t, opt_t, tail_t, _ = step_t(taps_t, opt_t, tail_t,
                                             _t(rx[sl]), _t(d[sl]))
        _, taps_j, opt_j, tail_j, _ = step_j(taps_j, opt_j, tail_j,
                                             jnp.asarray(rx[sl]),
                                             jnp.asarray(d[sl]))
    _close(taps_t, taps_j, 1e-5)

    init_t, step_t = teq.make_equalizer_trainer(5, device=CPU)
    init_j, step_j = jeq.make_equalizer_trainer(5)
    taps_j, opt_j, tail_j = init_j()
    for b in range(8):
        sl = slice(b * 256, (b + 1) * 256)
        _, taps_j, opt_j, tail_j, _ = step_j(taps_j, opt_j, tail_j,
                                             jnp.asarray(rx[sl]),
                                             jnp.asarray(d[sl]))
        if b == 3:
            adam = opt_j[0]
            taps_t, opt_t, tail_t = tensors_from_numpy(
                (np.asarray(taps_j), {"count": np.asarray(adam.count),
                                      "mu": np.asarray(adam.mu),
                                      "nu": np.asarray(adam.nu)},
                 np.asarray(tail_j)), CPU)
        elif b > 3:
            _, taps_t, opt_t, tail_t, _ = step_t(taps_t, opt_t, tail_t,
                                                 _t(rx[sl]), _t(d[sl]))
    _close(taps_t, taps_j, 1e-5)


@pytest.mark.parametrize("name", ["lms", "rls", "cma", "fdaf"])
def test_classes_equal_jax_and_carry_state_across(name):
    """Three blocks in both; the JAX object's carry moved to a fresh port
    object (``state`` through interop), and a fourth block in both."""
    rx, d = _link(4096, 5)
    pts = jlm.psk_constellation(4)
    make = {
        "lms": (lambda: teq.LMSEqualizer(9, 0.1, device=CPU),
                lambda: jeq.LMSEqualizer(9, 0.1),
                lambda o, x, dd: o.execute_block(x, dd),
                ("taps", "tail")),
        "rls": (lambda: teq.RLSEqualizer(9, 0.99, device=CPU),
                lambda: jeq.RLSEqualizer(9, 0.99),
                lambda o, x, dd: o.execute_block(x, dd),
                ("R", "p", "tail")),
        "cma": (lambda: teq.CMAEqualizer(9, 0.05, device=CPU),
                lambda: jeq.CMAEqualizer(9, 0.05),
                lambda o, x, dd: o.execute_block(x, pts),
                ("taps", "tail")),
        "fdaf": (lambda: teq.FDAFCanceller(64, 0.5, device=CPU),
                 lambda: jeq.FDAFCanceller(64, 0.5),
                 lambda o, x, dd: o.execute_block(x, dd),
                 ("state", "xbuf", "dbuf")),
    }[name]
    new_t, new_j, run, keys = make
    tol = 1e-4 if name in ("rls", "fdaf") else 1e-5
    t, j = new_t(), new_j()
    cuts = (0, 1000, 1333, 2900, 4096)
    for lo, hi in zip(cuts[:3], cuts[1:4]):
        x, dd = rx[lo:hi], d[lo:hi]
        _close(run(t, x, dd), run(j, jnp.asarray(x), jnp.asarray(dd)), tol)
    t2 = new_t()
    t2.state = tensors_from_numpy(
        {k: (tuple(np.asarray(v) for v in getattr(j, "_" + k))
             if k == "state" else np.asarray(getattr(j, "_" + k)))
         for k in keys}, CPU)
    assert set(tensors_to_numpy(t2.state)) == set(keys)
    x, dd = rx[2900:], d[2900:]
    _close(run(t2, x, dd), run(j, jnp.asarray(x), jnp.asarray(dd)), tol)
    np.testing.assert_allclose(t2.taps, np.asarray(j.taps), rtol=0,
                               atol=tol * np.abs(np.asarray(j.taps)).max())


def test_fdaf_step_equals_jax_unconstrained_too():
    rx, d = _link(8 * 32, 6)
    for constrained in (True, False):
        st_t = teq.fdaf_init(32, torch.complex64, CPU)
        st_j = jeq.fdaf_init(32)
        y_t, e_t, st_t = teq.fdaf_step(st_t, _t(rx), _t(d), 0.4,
                                       constrained=constrained)
        y_j, e_j, st_j = jeq.fdaf_step(st_j, jnp.asarray(rx), jnp.asarray(d),
                                       0.4, constrained=constrained)
        for a, b in zip((y_t, e_t, *st_t), (y_j, e_j, *st_j)):
            _close(a, b, 1e-5)
