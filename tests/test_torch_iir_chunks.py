"""K6's time-parallel form on the CPU: the chunk tables and the join.

``csrc/iir_bank.cu`` runs the biquad cascade in chunks of Lc rows: each
chunk from a zero state, the chunk ends joined span by span through the
per-lane tables Phi^(Lc j) (``ops/cuda_iir.py::iir_join_tables``, powers of
``iir_chunk_tables``' Phi^Lc), then each chunk again from its true start.  The kernel runs only on the card; here the same three
steps run in torch, vectorised over chunks and lanes:

* in float64 with the float32 tables: against the plain version in float64
  (``iir_bank_torch``), atol 2^-23 N^2 max(1, max|Phi|) max(1, max|state|)
  (the tables' and stored starts' float32 rounding: 2^-24 on each of the
  N^2 entries, N = 2S, and on each stored slot);
* in the kernel's arithmetic (chunks in float32 in the plain version's order,
  the join in float64): against the plain version in float32 at the gate of
  tests/test_pallas.py, atol 3e-5, on outputs and state.  The narrow cascade
  (``design_channel_sos(0.005)``) carries a state of some 270 in float32,
  where one ulp is 3e-5 and the plain version itself is 2e-3 from float64,
  so its state is held at 3e-5 relative to max|state|;
* against the JAX package's ``iir_bank_apply`` in interpret mode at atol
  3e-5 (the gate of test_iir_bank_plain_matches_jax_interpret_kernel).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.ops import pallas_kernels as jpk
from solid_dsp_tpu_torch.models.channel_bank import (ChannelBank,
                                                     design_channel_sos)
from solid_dsp_tpu_torch.ops import cuda_iir

CPU = torch.device("cpu")
LC = cuda_iir.IIR_CHUNK
C = 4
IIR_ATOL = 3e-5
# "spans": more chunks than two spans of the join (its three steps)
TS = [1, LC - 1, LC, LC + 1, 3 * LC + 7, "spans"]


def _rows_of(T, S):
    return (2 * cuda_iir.join_span(S) + 3) * LC + 5 if T == "spans" else T


def _sos(kind: str, S: int) -> np.ndarray:
    if kind == "shared":
        return design_channel_sos(0.2, 2 * S)
    if kind == "narrow":
        return design_channel_sos(0.005, 2 * S)
    return np.stack([design_channel_sos(0.1 + 0.3 * c / C, 2 * S)
                     for c in range(C)], axis=-1)


def _noise(seed, T):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((T, C)) + 1j * rng.standard_normal((T, C))
            ).astype(np.complex64)


def _rows(co, w, xs):
    """The plain recurrence over rows xs (R, ..., lanes) from the state list
    w (2S entries of (..., lanes)): (y, w)."""
    y = torch.empty_like(xs)
    for t in range(xs.shape[0]):
        v = xs[t]
        for s in range(co.shape[0]):
            b0, b1, b2, a1, a2 = co[s]
            w1, w2 = w[2 * s], w[2 * s + 1]
            fb = a1 * w1 + a2 * w2
            ff = b1 * w1 + b2 * w2
            w0 = v - fb
            v = b0 * w0 + ff
            w[2 * s], w[2 * s + 1] = w0, w1
        y[t] = v
    return y, w


def chunked(sos_l, tables, state, x, dt):
    """The kernel's steps: chunks of LC rows in ``dt`` from a zero state;
    their ends joined in float64 span by span as the kernel does (each span
    of Q chunks from a zero start, the spans' starts in order through
    Phi^(Lc Q), every chunk's start from its span's through Phi^(Lc j)),
    rounded to float32 where the kernel stores them; the chunks again from
    their starts.  The last chunk's end is the new state."""
    S = sos_l.shape[0] // 5
    N = 2 * S
    Q = cuda_iir.join_span(S)
    T = x.shape[0]
    nc = max(1, -(-T // LC))
    co = sos_l.to(dt).reshape(S, 5, 1, -1)
    xs = torch.zeros((nc * LC, 2 * C), dtype=dt)
    xs[:T] = torch.view_as_real(x).reshape(T, -1).to(dt)
    xc = xs.reshape(nc, LC, -1).transpose(0, 1)             # (LC, nc, lanes)
    _, e = _rows(co, [torch.zeros((nc, 2 * C), dtype=dt)] * N, xc)
    slots = torch.stack(e, dim=1)[: nc - 1].double()        # (nc-1, N, lanes)
    pw = tables.double().reshape(Q, N, N, -1)

    def mv(j, v):                                            # Phi^(Lc j) v
        return torch.einsum("icl,cl->il", pw[j - 1], v)

    def rnd(v):                                              # a stored slot
        return v.to(dt).double()

    steps = nc - 1
    spans = -(-steps // Q)
    for m in range(spans):                   # each span from a zero start
        v = torch.zeros_like(slots[0])
        for k in range(m * Q, min(steps, m * Q + Q)):
            v = mv(1, v) + slots[k]
            slots[k] = rnd(v)
    s0 = torch.view_as_real(state).reshape(N, -1).double()
    ss, v = [], s0                           # the spans' starts in order
    for m in range(spans):
        ss.append(rnd(v))
        if m + 1 < spans:
            v = mv(Q, v) + slots[m * Q + Q - 1]
    for k in range(1, nc):                   # every chunk's start
        m, j = divmod(k - 1, Q)
        slots[k - 1] = rnd(slots[k - 1] + mv(j + 1, ss[m]))
    st = torch.cat([s0[:, None], slots.transpose(0, 1)], dim=1).to(dt)
    y, _ = _rows(co, list(st.unbind(0)), xc)
    y = y.transpose(0, 1).reshape(nc * LC, -1)[:T]
    rem = T - (nc - 1) * LC
    _, w = _rows(co, list(st[:, -1:].unbind(0)), xc[:rem, -1:])
    new_state = torch.view_as_complex(torch.stack(w).reshape(N, C, 2)
                                      .contiguous())
    return torch.view_as_complex(y.reshape(T, C, 2).contiguous()), new_state


def _two_blocks(fn, sos, T, dt_state):
    """fn(state, block) over two blocks of T rows: (y, end state)."""
    x = torch.from_numpy(_noise(T, 2 * T))
    st = cuda_iir.iir_bank_init(sos.shape[0], C, CPU).to(dt_state)
    ys = []
    for blk in (x[:T], x[T:]):
        y, st = fn(st, blk)
        ys.append(y)
    return torch.cat(ys), st


CASES = [("shared", 1), ("shared", 2), ("shared", 8), ("per_channel", 2),
         ("narrow", 2)]


@pytest.mark.parametrize("T", TS)
@pytest.mark.parametrize("kind,S", CASES)
def test_chunk_join_float64_matches_plain(kind, S, T):
    """The tables joined chunk by chunk in float64 reproduce the plain
    version in float64 over two blocks with the state carried."""
    T = _rows_of(T, S)
    sos = _sos(kind, S)
    sos_l = cuda_iir.iir_bank_lanes(sos, C, CPU)
    phi = cuda_iir.iir_chunk_tables(sos_l)
    tables = cuda_iir.iir_join_tables(sos_l)
    x64 = torch.complex128
    got_y, got_st = _two_blocks(
        lambda st, b: chunked(sos_l, tables, st, b.to(x64), torch.float64),
        sos, T, x64)
    want_y, want_st = _two_blocks(
        lambda st, b: cuda_iir.iir_bank_torch(sos_l.double(), st, b.to(x64)),
        sos, T, x64)
    tol = (2.0 ** -23 * (2 * S) ** 2 * max(1.0, float(phi.abs().max()))
           * max(1.0, float(want_st.abs().max())))
    np.testing.assert_allclose(got_y.numpy(), want_y.numpy(), rtol=0,
                               atol=tol)
    np.testing.assert_allclose(got_st.numpy(), want_st.numpy(), rtol=0,
                               atol=tol)


@pytest.mark.parametrize("T", TS)
@pytest.mark.parametrize("kind,S", CASES)
def test_chunked_float32_matches_plain(kind, S, T):
    """The kernel's arithmetic (float32 chunks, float64 join) against the
    plain version in float32: atol 3e-5 on the outputs and the state (the
    narrow cascade's state relative to its size, module docstring)."""
    T = _rows_of(T, S)
    sos = _sos(kind, S)
    sos_l = cuda_iir.iir_bank_lanes(sos, C, CPU)
    tables = cuda_iir.iir_join_tables(sos_l)
    c64 = torch.complex64
    got_y, got_st = _two_blocks(
        lambda st, b: chunked(sos_l, tables, st, b, torch.float32), sos, T,
        c64)
    want_y, want_st = _two_blocks(
        lambda st, b: cuda_iir.iir_bank_torch(sos_l, st, b), sos, T, c64)
    np.testing.assert_allclose(got_y.numpy(), want_y.numpy(), rtol=0,
                               atol=IIR_ATOL)
    st_tol = IIR_ATOL * (max(1.0, float(want_st.abs().max()))
                         if kind == "narrow" else 1.0)
    np.testing.assert_allclose(got_st.numpy(), want_st.numpy(), rtol=0,
                               atol=st_tol)


@pytest.mark.parametrize("kind,S", [("shared", 2), ("per_channel", 2),
                                    ("narrow", 2)])
def test_chunked_float32_matches_jax_interpret_kernel(kind, S):
    """The kernel's arithmetic against JAX's iir_bank_apply in interpret
    mode over two blocks of 3 Lc + 7 rows: atol 3e-5 on the outputs."""
    sos = _sos(kind, S)
    T = 3 * LC + 7
    sos_l = cuda_iir.iir_bank_lanes(sos, C, CPU)
    tables = cuda_iir.iir_join_tables(sos_l)
    x = _noise(T, 2 * T)
    st = cuda_iir.iir_bank_init(S, C, CPU)
    jst = jpk.iir_bank_init(S, C)
    for blk in np.split(x, 2):
        y, st = chunked(sos_l, tables, st, torch.from_numpy(blk),
                        torch.float32)
        jy, jst = jpk.iir_bank_apply(jnp.asarray(sos), jst, jnp.asarray(blk),
                                     tile_rows=64, interpret=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                                   atol=IIR_ATOL)


@pytest.mark.parametrize("kind,S", CASES)
def test_chunk_tables_are_the_one_row_transition_to_the_power_lc(kind, S):
    """Phi^Lc from the tables equals the one-row table raised to the Lc-th
    power in float64, to the tables' float32 rounding."""
    sos_l = cuda_iir.iir_bank_lanes(_sos(kind, S), C, CPU)
    N = 2 * S
    one = cuda_iir.iir_chunk_tables(sos_l, 1).double().reshape(N, N, -1)
    want = torch.linalg.matrix_power(one.permute(2, 0, 1), LC)
    got = cuda_iir.iir_chunk_tables(sos_l).double().reshape(N, N, -1)
    scale = max(1.0, float(want.abs().max()))
    np.testing.assert_allclose(got.permute(2, 0, 1).numpy(), want.numpy(),
                               rtol=0, atol=1e-6 * scale)


def test_channel_bank_builds_coefficients_once():
    """ChannelBank builds its IirBank at construction and again only when
    ``sos`` is set; a new number of sections restarts the cascade state."""
    bank = ChannelBank(8, backend="xla", device=CPU)
    iir = bank._iir
    x = _noise(1, 8 * 64).reshape(-1)
    bank.execute_block(x)
    bank.execute_block(x)
    assert bank._iir is iir
    np.testing.assert_array_equal(bank.sos, design_channel_sos())
    bank.sos = design_channel_sos(0.1)
    assert bank._iir is not iir
    np.testing.assert_array_equal(bank.sos, design_channel_sos(0.1))
    bank.sos = design_channel_sos(0.1, 6)
    assert bank.state["iir"].shape == (6, 8)
    assert not bool(bank.state["iir"].abs().max())
    assert bank.execute_block(x).shape == (x.size // 8, 8)


@pytest.mark.parametrize("S", [1, 2, 3, 8])
def test_join_tables_are_powers_of_the_chunk_table(S):
    """The join's tables: Q = join_span(S) entries, the first Phi^Lc of
    iir_chunk_tables, entry j its j-th power, to float32 rounding."""
    sos_l = cuda_iir.iir_bank_lanes(design_channel_sos(0.2, 2 * S), C, CPU)
    N, Q = 2 * S, cuda_iir.join_span(S)
    tables = cuda_iir.iir_join_tables(sos_l)
    assert tables.shape == (Q * N * N, 2 * C) and tables.dtype == torch.float32
    phi = cuda_iir.iir_chunk_tables(sos_l)
    assert torch.equal(tables[:N * N], phi)
    one = phi.double().reshape(N, N, -1).permute(2, 0, 1)
    for j, entry in enumerate(tables.double().reshape(Q, N, N, -1), start=1):
        want = torch.linalg.matrix_power(one, j)
        np.testing.assert_allclose(entry.permute(2, 0, 1).numpy(),
                                   want.numpy(), rtol=0,
                                   atol=1e-6 * max(1.0, float(
                                       want.abs().max())))
