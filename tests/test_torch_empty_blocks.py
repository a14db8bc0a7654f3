"""P3: a block with no valid output, in the port and in the JAX package.

Every streaming class whose product is a sliding correlation runs the
block sequence 1000, 7, 1, 333, 64, 0, 129 (times the class's block
quantum: its decimation) with its state carried, on the CPU, against the
JAX package on the same seeded numpy inputs.  The empty block returns an
empty output in both, and the next block runs as JAX runs it.  Tolerance:
outputs and carried state within 1e-10 of max|y| in complex128 (the
classes' own parity tolerance, tests/test_torch_resample.py and
tests/test_torch_fir.py), the integer phase words and counters exactly.

F6, a fault of the reference: JAX raises on the empty block by
``FIRFilter(method="fft")`` (``_fir_block_fft``, TypeError) and by the IIR
classes' "parallel" route (``_w_recurrence_parallel``, IndexError:
``IIRFilter`` in both types, ``SecondOrderFilter`` and the decimating and
interpolating IIR filters, whose "auto" takes "parallel" here).  There
the JAX side is asserted to raise, the port returns the empty output, and
the following blocks are held against JAX run over the sequence without
the empty block, which changes no state.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.models import ddc as jddc
from solid_dsp_tpu.ops import autocorr as jac
from solid_dsp_tpu.ops import cic as jcic
from solid_dsp_tpu.ops import fir as jfir
from solid_dsp_tpu.ops import halfband as jhb
from solid_dsp_tpu.ops import iir as jiir
from solid_dsp_tpu.ops import resample as jrs
from solid_dsp_tpu_torch.models import ddc
from solid_dsp_tpu_torch.ops import autocorr, cic, fir, halfband, iir, resample

CPU = "cpu"
C128 = torch.complex128
J128 = jnp.complex128
SEQ = (1000, 7, 1, 333, 64, 0, 129)
TAPS = np.hanning(31)
B_IIR, A_IIR = np.array([0.2, 0.3, 0.2]), np.array([1.0, -0.5, 0.2])
SOS_B = np.array([0.2, 0.3, 0.2, 0.5, 0.1, 0.4])
SOS_A = np.array([1.0, -0.5, 0.2, 1.0, 0.3, 0.1])


def _np(v):
    return np.asarray(v.cpu().numpy() if isinstance(v, torch.Tensor) else v)


def _iir_state(f):
    return [_np(f._state)]


# name: (port object, JAX object, block quantum, port state, JAX state)
CASES = {
    "fir_matmul": (
        lambda: fir.FIRFilter(TAPS, method="matmul", dtype=C128, device=CPU),
        lambda: jfir.FIRFilter(TAPS, method="matmul", dtype=J128), 1,
        lambda f: [f.state], lambda f: [f.state]),
    "decimating_fir": (
        lambda: fir.DecimatingFIRFilter(TAPS, decimation=2, dtype=C128,
                                        device=CPU),
        lambda: jfir.DecimatingFIRFilter(TAPS, decimation=2, dtype=J128), 2,
        lambda f: [f._tail, f._phase], lambda f: [f._tail, f._phase]),
    "interpolating_fir": (
        lambda: fir.InterpolatingFIRFilter(TAPS, 3, dtype=C128, device=CPU),
        lambda: jfir.InterpolatingFIRFilter(TAPS, 3, dtype=J128), 1,
        lambda f: [f.state], lambda f: [f.state]),
    "iir_scan": (
        lambda: iir.IIRFilter(B_IIR, A_IIR, method="scan", device=CPU),
        lambda: jiir.IIRFilter(B_IIR, A_IIR, method="scan"), 1,
        lambda f: [f.state["state"]], _iir_state),
    "cic_decimator": (
        lambda: cic.CICDecimator(4, 3, dtype=C128, device=CPU),
        lambda: jcic.CICDecimator(4, 3, dtype=J128), 4,
        lambda f: [f._tail, f._phase], lambda f: [f._tail, f._phase]),
    "cic_interpolator": (
        lambda: cic.CICInterpolator(4, 3, dtype=C128, device=CPU),
        lambda: jcic.CICInterpolator(4, 3, dtype=J128), 1,
        lambda f: [f._tail], lambda f: [f._tail]),
    "halfband_decimator": (
        lambda: halfband.HalfbandDecimator(8, dtype=C128, device=CPU),
        lambda: jhb.HalfbandDecimator(8, dtype=J128), 2,
        lambda f: [f._tail], lambda f: [f._tail]),
    "multistage_decimator": (
        lambda: halfband.MultistageDecimator(12, dtype=C128, device=CPU),
        lambda: jhb.MultistageDecimator(12, dtype=J128), 12,
        lambda f: [s._tail for s in f.stages] + [f.final._tail,
                                                  f.final._phase],
        lambda f: [s._tail for s in f.stages] + [f.final._tail,
                                                  f.final._phase]),
    "halfband_interpolator": (
        lambda: resample.HalfbandInterpolator(8, dtype=C128, device=CPU),
        lambda: jrs.HalfbandInterpolator(8, dtype=J128), 1,
        lambda f: [f._tail], lambda f: [f._tail]),
    "autocorrelator": (
        lambda: autocorr.AutoCorrelator(16, 4, dtype=C128, device=CPU),
        lambda: jac.AutoCorrelator(16, 4, dtype=J128), 1,
        lambda f: [f._st["x_tail"], f._st["e_tail"]],
        lambda f: [f._st["x_tail"], f._st["e_tail"]]),
    "ddc": (
        lambda: ddc.DDC(0.3, dtype=C128, device=CPU),
        lambda: jddc.DDC(0.3, dtype=J128), 16,
        lambda f: [f._theta, f.cic._tail, f.cic._phase, f._fir_tail,
                   f._fir_phase],
        lambda f: [f._theta, f.cic._tail, f.cic._phase, f._fir_tail,
                   f._fir_phase]),
}

# F6's routes: the JAX side raises on the empty block
F6_CASES = {
    "fir_fft": (
        lambda: fir.FIRFilter(TAPS, method="fft", dtype=C128, device=CPU),
        lambda: jfir.FIRFilter(TAPS, method="fft", dtype=J128), 1,
        lambda f: [f.state], lambda f: [f.state], TypeError),
    "iir_parallel": (
        lambda: iir.IIRFilter(B_IIR, A_IIR, method="parallel", device=CPU),
        lambda: jiir.IIRFilter(B_IIR, A_IIR, method="parallel"), 1,
        lambda f: [f.state["state"]], _iir_state, IndexError),
    "sos_parallel": (
        lambda: iir.IIRFilter(SOS_B, SOS_A, iir.IIRFilterType.SECOND_ORDER,
                              method="parallel", device=CPU),
        lambda: jiir.IIRFilter(SOS_B, SOS_A, jiir.IIRFilterType.SECOND_ORDER,
                               method="parallel"), 1,
        lambda f: [f.state["state"]],
        lambda f: [np.stack([np.asarray(s._state)
                             for s in f.second_order_filters()])],
        IndexError),
    "decimating_iir_parallel": (
        lambda: iir.DecimatingIIRFilter(B_IIR, A_IIR, "normal", 2, device=CPU),
        lambda: jiir.DecimatingIIRFilter(B_IIR, A_IIR, "normal", 2), 2,
        lambda f: [f.filter.state["state"], f._index],
        lambda f: [f.filter._state, f._index], IndexError),
    "interpolating_iir_parallel": (
        lambda: iir.InterpolatingIIRFilter(B_IIR, A_IIR, "normal", 3,
                                           device=CPU),
        lambda: jiir.InterpolatingIIRFilter(B_IIR, A_IIR, "normal", 3), 1,
        lambda f: [f.filter.state["state"]],
        lambda f: [f.filter._state], IndexError),
    "second_order_parallel": (
        lambda: iir.SecondOrderFilter(B_IIR, A_IIR, device=CPU),
        lambda: jiir.SecondOrderFilter(B_IIR, A_IIR), 1,
        lambda f: [f.state["state"]], _iir_state, IndexError),
}


def _blocks(q: int, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n * q) + 1j * rng.standard_normal(n * q)
            for n in SEQ]


def _close(got, want, scale):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got.astype(np.int64) & 0xFFFFFFFF,
                                      want.astype(np.int64) & 0xFFFFFFFF)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * scale)


@pytest.mark.parametrize("name", sorted(CASES))
def test_p3_empty_block_matches_jax(name):
    """P3: the port returns the empty output on the 0-sample block (and
    on every block shorter than the filter's reach) and carries its state
    through it, as JAX does; every block's output and state match."""
    make_t, make_j, q, st_t, st_j = CASES[name]
    t, j = make_t(), make_j()
    for x in _blocks(q, len(name)):
        want = np.asarray(j.execute_block(jnp.asarray(x)))
        got = t.execute_block(x)
        scale = max(float(np.abs(want).max()) if want.size else 0.0, 1.0)
        _close(got, want, scale)
        if x.size == 0:
            assert got.shape[-1] == 0
        for a, b in zip(st_t(t), st_j(j), strict=True):
            _close(a, b, scale)


@pytest.mark.parametrize("name", sorted(F6_CASES))
def test_f6_empty_block_returns_empty_where_jax_raises(name):
    """F6: JAX raises on the empty block on this route; the port returns
    it empty, keeps its state, and the blocks after it match JAX run over
    the sequence without the empty block."""
    make_t, make_j, q, st_t, st_j, exc = F6_CASES[name]
    t, j = make_t(), make_j()
    for x in _blocks(q, len(name)):
        got = t.execute_block(x)
        if x.size == 0:
            with pytest.raises(exc):
                make_j().execute_block(jnp.asarray(x))
            assert got.shape[-1] == 0
            continue
        want = np.asarray(j.execute_block(jnp.asarray(x)))
        scale = max(float(np.abs(want).max()), 1.0)
        _close(got, want, scale)
        for a, b in zip(st_t(t), st_j(j), strict=True):
            _close(a, b, scale)


@pytest.mark.parametrize("L,n,stride,O", [(7, 8, 1, None), (30, 31, 2, None),
                                          (3, 4, 1, 3), (5, 9, 3, 2)])
def test_p3_conv_routes_return_empty(L, n, stride, O, monkeypatch):
    """conv1d_mxu and the card's banded-Toeplitz route (taken here by
    forcing ``_use_toeplitz``): T = (L - n) // stride + 1 <= 0 gives the
    empty (..., 0(, O)) result in the working type, as JAX's conv1d_mxu
    gives shape (0,) for 7 samples with 8 taps; fir_toeplitz itself
    refuses the block, as JAX's does."""
    from solid_dsp_tpu.ops.fir import conv1d_mxu as jconv
    from solid_dsp_tpu.ops.fir import fir_toeplitz as jtoep

    rng = np.random.default_rng(L + n)
    x = (rng.standard_normal((2, L)) + 1j * rng.standard_normal((2, L)))
    taps = rng.standard_normal(n if O is None else (n, O))
    want = np.asarray(jconv(jnp.asarray(x), jnp.asarray(taps), stride=stride))
    monkeypatch.setattr(fir, "_use_toeplitz", lambda x, n: True)
    for got in (fir.conv1d_mxu(torch.from_numpy(x), torch.from_numpy(taps),
                               stride=stride),
                fir._correlate(torch.from_numpy(x), taps, stride=stride)):
        assert tuple(got.shape) == want.shape == (
            (2, 0) if O is None else (2, 0, O))
        assert got.dtype == torch.complex128
    for toeplitz, xs in ((fir.fir_toeplitz, torch.from_numpy(x)),
                         (jtoep, jnp.asarray(x))):
        with pytest.raises(ValueError, match="shorter"):
            toeplitz(xs, taps, stride=stride)


@pytest.mark.parametrize("call", ["fft", "ifft", "fft_pad", "windowed_fft",
                                  "windowed_fft_4096", "spectrogram",
                                  "spectrogram_rows"])
def test_p7_transforms_of_no_rows_return_empty(call):
    """P7: ``fft``, ``ifft`` and ``windowed_fft`` over a batch with no rows,
    and ``spectrogram`` of a block shorter than one frame, return the empty
    result with JAX's shape and dtype (oneMKL, cuFFT and K7 refuse a
    transform with no rows, and ``unfold`` one with no frame)."""
    from solid_dsp_tpu.ops import fft as jfft
    from solid_dsp_tpu_torch.ops import fft as tfft

    x, args = {
        "fft": (np.zeros((0, 64), np.complex64), ()),
        "ifft": (np.zeros((0, 64), np.complex64), ()),
        "fft_pad": (np.zeros((0, 3, 40), np.float32), (64,)),
        "windowed_fft": (np.zeros((0, 64), np.complex64), ()),
        "windowed_fft_4096": (np.zeros((0, 4096), np.complex64), ()),
        "spectrogram": (np.ones(10, np.float32), (64,)),
        "spectrogram_rows": (np.ones((3, 10), np.complex64), (64, 32)),
    }[call]
    name = call.split("_")[0] if call.startswith(("fft", "spec")) else (
        "windowed_fft" if call.startswith("windowed") else call)
    want = np.asarray(getattr(jfft, name)(jnp.asarray(x), *args))
    got = getattr(tfft, name)(torch.from_numpy(x), *args)
    assert tuple(got.shape) == want.shape and got.numel() == 0
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
