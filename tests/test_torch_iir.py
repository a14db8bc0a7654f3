"""The port's IIR layer (ops/iir.py: S3's plain version iir_scan_torch, the
parallel route on ops/linrec.py, iir_apply, the SOS cascade and the four
classes) vs the JAX package's, on the CPU.

Tolerances: the goldens of tests/test_iir.py (first SOS step 1e-15, the
IIR block 1e-14, group delays 1e-10, the decimating golden 1e-14); both
methods against JAX in float64 (and complex128) 1e-10 absolute, as
tests/test_iir.py holds them against the reference; iir_scan_torch against
JAX's _w_recurrence_scan 1e-12 of max|w| (both float64, sums in another
order); float32 parallel >= 90 dB and float32 scan >= 80 dB against float64
truth (tests/test_iir.py:180-223, at 2^16 and 2^14 samples here: the plain
scan is a Python loop on the CPU).  The plain version's summation order
is held bit-equal to an explicit float32 numpy loop.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.ops import iir as jiir
from solid_dsp_tpu_torch.design import iirdes
from solid_dsp_tpu_torch.interop import tensors_from_numpy, tensors_to_numpy
from solid_dsp_tpu_torch.ops import cuda_scan, iir

CPU = "cpu"


def _pll():
    return iirdes.pll_active_lag(0.02, 1.0 / np.sqrt(2.0), 1000.0)


def _pole_pair(r, theta=0.3):
    return np.array([1.0, -2 * r * np.cos(theta), r * r])


def _snr_db(ref, test):
    ref = np.asarray(ref)
    err = ref - np.asarray(test)
    return 10 * np.log10(np.mean(np.abs(ref) ** 2)
                         / (np.mean(np.abs(err) ** 2) + 1e-300))


def test_sos_goldens():
    num, den = _pll()
    f = iir.SecondOrderFilter(num, den, device=CPU)
    assert abs(float(f.execute(1.0)) - 0.05816769596076701) < 1e-15
    g = iir.SecondOrderFilter(num, den, device=CPU)
    assert abs(g.numerator_coefs()[1] - 0.99999840000128) < 1e-14
    assert abs(g.denominator_coefs()[1] - 0.003199997440002048) < 1e-15
    assert abs(g.group_delay(0.0) - 17.6774211296624) < 1e-10


def test_iir_block_and_cascade_goldens():
    num, den = _pll()
    f = iir.IIRFilter(num, den, iir.IIRFilterType.SECOND_ORDER, device=CPU)
    out = f.execute_block(np.array([1.0, 0.0, 1.0, 0.0, 1.0])).numpy()
    np.testing.assert_allclose(out, [0.05816769596076701, 0.119535296293297,
                                     0.18410279587774706, 0.2518701895942824,
                                     0.32283747232307686], rtol=0, atol=1e-14)
    assert abs(f.group_delay(0.0) - 19.6774211296624) < 1e-10
    assert f.frequency_response(0.0) == 0.0
    assert repr(f) == "IIR<second_order>"


def test_decimating_golden_and_interp_length():
    num, den = _pll()
    f = iir.DecimatingIIRFilter(num, den, iir.IIRFilterType.SECOND_ORDER, 2,
                                device=CPU)
    out = f.execute_block(np.array([1.0, 0.0, 1.0, 0.0])).numpy()
    np.testing.assert_allclose(out, [0.119535296293297, 0.2518701895942824],
                               rtol=0, atol=1e-14)
    g = iir.InterpolatingIIRFilter(num, den, iir.IIRFilterType.SECOND_ORDER,
                                   4, device=CPU)
    assert g.execute_block(np.arange(5.0)).shape[-1] == 20
    assert g.get_interpolation() == 4 and f.get_decimation() == 2


@pytest.mark.parametrize("method", ["scan", "parallel"])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_normal_filter_matches_jax(method, dtype):
    rng = np.random.default_rng(5)
    b = rng.standard_normal(4)
    a = np.array([1.0, -0.4, 0.22, -0.05])
    x = rng.standard_normal(300).astype(dtype)
    if dtype == np.complex128:
        x = x + 1j * rng.standard_normal(300)
    jf = jiir.IIRFilter(b, a, method=method)
    pf = iir.IIRFilter(b, a, method=method, device=CPU)
    want = np.concatenate([np.asarray(jf.execute_block(jnp.asarray(x[:77]))),
                           np.asarray(jf.execute_block(jnp.asarray(x[77:])))])
    got = np.concatenate([pf.execute_block(x[:77]).numpy(),
                          pf.execute_block(x[77:]).numpy()])
    np.testing.assert_allclose(got, want, atol=1e-10)
    np.testing.assert_allclose(pf.state["state"].numpy(),
                               np.asarray(jf._state), atol=1e-10)


@pytest.mark.parametrize("method", ["scan", "parallel"])
def test_sos_filter_matches_jax(method):
    rng = np.random.default_rng(6)
    num, den = _pll()
    x = rng.standard_normal(150) + 1j * rng.standard_normal(150)
    jf = jiir.SecondOrderFilter(num, den)
    jf.method = method
    pf = iir.SecondOrderFilter(num, den, device=CPU)
    pf.method = method
    want = np.concatenate([np.asarray(jf.execute_block(jnp.asarray(x[:50]))),
                           np.asarray(jf.execute_block(jnp.asarray(x[50:])))])
    got = np.concatenate([pf.execute_block(x[:50]).numpy(),
                          pf.execute_block(x[50:]).numpy()])
    np.testing.assert_allclose(got, want, atol=1e-10)


@pytest.mark.parametrize("method", ["scan", "parallel"])
@pytest.mark.parametrize("design", ["butterworth", "elliptic"])
def test_designed_cascades_match_jax(method, design):
    rng = np.random.default_rng(7)
    ff, fb = iirdes.sos_to_iir_coeffs(iirdes.iirdes_sos(design, 6, 0.1))
    x = rng.standard_normal(256)
    jf = jiir.IIRFilter(ff, fb, jiir.IIRFilterType.SECOND_ORDER,
                        method=method)
    pf = iir.IIRFilter(ff, fb, iir.IIRFilterType.SECOND_ORDER, method=method,
                       device=CPU)
    np.testing.assert_allclose(pf.execute_block(x).numpy(),
                               np.asarray(jf.execute_block(jnp.asarray(x))),
                               atol=1e-10)
    np.testing.assert_allclose(
        pf.state["state"].numpy(),
        np.stack([np.asarray(s._state) for s in jf.second_order_filters()]),
        atol=1e-10)


def test_normal_vs_sos_same_filter():
    num, den = _pll()
    x = np.random.default_rng(8).standard_normal(64)
    fa = iir.IIRFilter(num, den, iir.IIRFilterType.NORMAL, device=CPU)
    fb = iir.IIRFilter(num, den, iir.IIRFilterType.SECOND_ORDER, device=CPU)
    np.testing.assert_allclose(fa.execute_block(x).numpy(),
                               fb.execute_block(x).numpy(), atol=1e-10)


@pytest.mark.parametrize("k", [1, 2, 3, 8, 12])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("lanes", [(), (3,)])
def test_iir_scan_torch_matches_jax_scan(k, dtype, lanes):
    rng = np.random.default_rng(k)
    # stable: the poles of a product of first-order sections at radius 0.9
    poly = np.poly(0.9 * np.exp(2j * np.pi * rng.random(k)))
    a = poly[1:].astype(dtype) if dtype == np.complex128 else \
        np.poly(0.9 * np.cos(2 * np.pi * rng.random(k)))[1:]
    x = rng.standard_normal((200, *lanes)).astype(dtype)
    w0 = rng.standard_normal((*lanes, k)).astype(dtype)
    if dtype == np.complex128:
        x = x + 1j * rng.standard_normal(x.shape)
    w, st = iir.iir_scan_torch(torch.from_numpy(a), torch.from_numpy(w0),
                               torch.from_numpy(x))
    jw, jst = jiir._w_recurrence_scan(jnp.asarray(a), jnp.asarray(w0),
                                      jnp.asarray(x))
    scale = np.abs(np.asarray(jw)).max()
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0,
                               atol=1e-12 * scale)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), rtol=0,
                               atol=1e-12 * scale)


def _scan_f32_numpy(a, h, x):
    """S3's order in float32 numpy, one rounding an operation: acc = p0;
    acc = acc + p_i; w = x - acc; p = a w as ar wr - ai wi, ar wi + ai wr."""
    cplx = np.iscomplexobj(x)
    f = np.float32
    ar, ai = a.real.astype(f), (a.imag if cplx else np.zeros_like(a.real)
                               ).astype(f)
    hr, hi = list(h.real.astype(f)), list((h.imag if cplx else 0 * h.real
                                           ).astype(f))
    out = []
    for xn in x:
        accr = acci = None
        for i in range(len(ar)):
            pr = f(f(ar[i] * hr[i]) - f(ai[i] * hi[i]))
            pi = f(f(ar[i] * hi[i]) + f(ai[i] * hr[i]))
            accr = pr if accr is None else f(accr + pr)
            acci = pi if acci is None else f(acci + pi)
        wr, wi = f(f(xn.real) - accr), f(f(xn.imag if cplx else 0) - acci)
        hr, hi = [wr] + hr[:-1], [wi] + hi[:-1]
        out.append(wr + 1j * wi if cplx else wr)
    return np.asarray(out, np.complex64 if cplx else np.float32)


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("k", [1, 2, 5])
def test_iir_scan_torch_summation_order(cplx, k):
    """The plain version's sums are S3's: left to right, each operation
    rounded on its own, so S3 can be bit-equal to it on the card."""
    rng = np.random.default_rng(20 + k)
    a = (0.3 * rng.standard_normal(k)).astype(np.float32)
    x = rng.standard_normal(300).astype(np.float32)
    h = rng.standard_normal(k).astype(np.float32)
    if cplx:
        a = (a + 0.2j * rng.standard_normal(k)).astype(np.complex64)
        x = (x + 1j * rng.standard_normal(300)).astype(np.complex64)
        h = (h + 1j * rng.standard_normal(k)).astype(np.complex64)
    w, _ = iir.iir_scan_torch(torch.from_numpy(a), torch.from_numpy(h),
                              torch.from_numpy(x))
    np.testing.assert_array_equal(w.numpy(), _scan_f32_numpy(a, h, x))


def test_scan_on_cpu_takes_the_plain_version():
    """A CPU tensor takes iir_scan_torch (no launch); S3's wrapper refuses
    CPU tensors instead of falling back."""
    before = cuda_scan.iir_scan_cuda.launches
    f = iir.IIRFilter([1.0, 0, 0], list(_pole_pair(0.9999)),
                      dtype=torch.float32, device=CPU)
    assert f.method == "scan"
    f.execute_block(np.ones(16, np.float32))
    assert cuda_scan.iir_scan_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        cuda_scan.iir_scan_cuda(torch.ones(2), torch.zeros(2),
                                torch.ones(8))


def test_parallel_f32_safe_radius_guarantee():
    """float32 parallel >= 90 dB against float64 truth at radius 0.99."""
    rng = np.random.default_rng(5)
    T = 1 << 16
    a = _pole_pair(iir.PARALLEL_SAFE_RADIUS_32BIT)
    b = np.array([1.0, 0.0, 0.0])
    x = rng.standard_normal(T)
    truth, _ = jiir.iir_apply(jnp.asarray(b), jnp.asarray(a[1:]),
                              jnp.zeros(2), jnp.asarray(x), method="scan")
    yp, _ = iir.iir_apply(torch.tensor(b, dtype=torch.float32),
                          torch.tensor(a[1:], dtype=torch.float32),
                          torch.zeros(2), torch.from_numpy(
                              x.astype(np.float32)), method="parallel")
    assert _snr_db(truth, yp.numpy()) >= 90.0


@pytest.mark.parametrize("r", [0.99, 0.9999])
def test_parallel_f64_agrees_with_scan_near_unit_circle(r):
    rng = np.random.default_rng(int(r * 1e4))
    a = torch.tensor(_pole_pair(r)[1:])
    b = torch.tensor([1.0, 0.0, 0.0])
    x = torch.from_numpy(rng.standard_normal(4096))
    ys, ss = iir.iir_apply(b, a, torch.zeros(2, dtype=torch.float64), x,
                           "scan")
    yp, sp = iir.iir_apply(b, a, torch.zeros(2, dtype=torch.float64), x,
                           "parallel")
    assert _snr_db(ys.numpy(), yp.numpy()) >= 120.0


def test_auto_method_selection():
    safe, risky, b3 = _pole_pair(0.9), _pole_pair(0.9999), [1.0, 0.0, 0.0]
    for a, dt, want in ((safe, None, "parallel"), (risky, None, "parallel"),
                        (safe, torch.float32, "parallel"),
                        (risky, torch.float32, "scan"),
                        (risky, torch.complex64, "scan"),
                        (risky, torch.complex128, "parallel")):
        f = iir.IIRFilter(b3, list(a), dtype=dt, device=CPU)
        assert f.method == want, (a, dt)
        assert f.method == jiir.IIRFilter(
            b3, list(a), dtype=None if dt is None else
            str(dt).replace("torch.", "")).method
    f = iir.IIRFilter(b3, list(risky), dtype=torch.float32, method="parallel",
                      device=CPU)
    assert f.method == "parallel"
    num, den = _pll()
    assert iir.max_pole_radius(np.asarray(den) / den[0]) > 0.999
    f = iir.IIRFilter(num, den, iir.IIRFilterType.SECOND_ORDER,
                      dtype=torch.float32, device=CPU)
    assert all(s.method == "scan" for s in f.second_order_filters())
    f64 = iir.IIRFilter(num, den, iir.IIRFilterType.SECOND_ORDER, device=CPU)
    assert all(s.method == "parallel" for s in f64.second_order_filters())


def test_risky_pole_f32_scan_accuracy():
    """float32 "auto" (the scan) >= 80 dB against float64 truth at pole
    radius 0.9999 (tests/test_iir.py:210-223 at 2^14 samples)."""
    rng = np.random.default_rng(6)
    T = 1 << 14
    a = _pole_pair(0.9999)
    b = np.array([0.01, 0.0, 0.0])
    x = rng.standard_normal(T)
    truth, _ = jiir.iir_apply(jnp.asarray(b), jnp.asarray(a[1:]),
                              jnp.zeros(2), jnp.asarray(x), method="scan")
    f = iir.IIRFilter(list(b), list(a), dtype=torch.float32, device=CPU)
    assert f.method == "scan"
    y = f.execute_block(x.astype(np.float32))
    assert y.dtype == torch.float32
    assert _snr_db(truth, y.numpy()) >= 80.0


def test_sos_cascade_apply_matches_jax():
    rng = np.random.default_rng(9)
    sos = iirdes.iirdes_sos("chebyshev1", 6, 0.15)
    x = rng.standard_normal(200) + 1j * rng.standard_normal(200)
    st0 = rng.standard_normal((3, 2)) * 0.1
    y, st = iir.sos_cascade_apply(torch.from_numpy(sos[:, :3]),
                                  torch.from_numpy(sos[:, 4:]),
                                  torch.from_numpy(st0), torch.from_numpy(x),
                                  "scan")
    jy, jst = jiir.sos_cascade_apply(jnp.asarray(sos[:, :3]),
                                     jnp.asarray(sos[:, 4:]),
                                     jnp.asarray(st0.astype(np.complex128)),
                                     jnp.asarray(x), method="scan")
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-10)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), atol=1e-10)
    assert iir.sos_init(3, device=CPU).shape == (3, 2)


@pytest.mark.parametrize("iirtype", ["normal", "second_order"])
def test_state_interop_both_ways(iirtype):
    """A stream started in one package continues in the other: JAX block 1,
    its state into the port, port block 2 == JAX block 2; and back."""
    rng = np.random.default_rng(11)
    ff, fb = iirdes.sos_to_iir_coeffs(iirdes.iirdes_sos("butterworth", 4,
                                                        0.1))
    if iirtype == "normal":
        ff, fb = np.array([0.2, 0.3, 0.1]), np.array([1.0, -0.5, 0.2])
    x1, x2, x3 = (rng.standard_normal(100) for _ in range(3))
    jf = jiir.IIRFilter(ff, fb, iirtype)
    pf = iir.IIRFilter(ff, fb, iirtype, device=CPU)
    jf.execute_block(jnp.asarray(x1))

    def jax_state(f):
        if f.iirtype == "normal":
            return {"state": np.asarray(f._state)}
        return {"state": np.stack([np.asarray(s._state)
                                   for s in f.second_order_filters()])}

    pf.state = tensors_from_numpy(jax_state(jf), CPU)
    np.testing.assert_allclose(pf.execute_block(x2).numpy(),
                               np.asarray(jf.execute_block(jnp.asarray(x2))),
                               atol=1e-12)
    back = tensors_to_numpy(pf.state)["state"]
    if iirtype == "normal":
        jf._state = jnp.asarray(back)
    else:
        for s, w in zip(jf.second_order_filters(), back):
            s._state = jnp.asarray(w)
    np.testing.assert_allclose(pf.execute_block(x3).numpy(),
                               np.asarray(jf.execute_block(jnp.asarray(x3))),
                               atol=1e-12)


def test_decimating_state_interop_and_streaming():
    num, den = _pll()
    x = np.random.default_rng(12).standard_normal(101)
    jf = jiir.DecimatingIIRFilter(num, den, "second_order", 3)
    pf = iir.DecimatingIIRFilter(num, den, "second_order", 3, device=CPU)
    want = np.concatenate([np.asarray(jf.execute_block(jnp.asarray(b)))
                           for b in np.split(x, [7, 50])])
    got = np.concatenate([pf.execute_block(b).numpy()
                          for b in np.split(x, [7, 50])])
    np.testing.assert_allclose(got, want, atol=1e-12)
    st = tensors_to_numpy(pf.state)
    assert int(st["index"]) == jf._index
    q = iir.DecimatingIIRFilter(num, den, "second_order", 3, device=CPU)
    q.state = tensors_from_numpy(st, CPU)
    np.testing.assert_array_equal(q.execute_block(x[:9]).numpy(),
                                  pf.execute_block(x[:9]).numpy())


def test_validation():
    with pytest.raises(ValueError):
        iir.SecondOrderFilter([1.0], [1.0, 2.0, 3.0], device=CPU)
    with pytest.raises(ValueError):
        iir.IIRFilter([1.0, 2.0], [1.0, 2.0, 3.0], "second_order",
                      device=CPU)
    with pytest.raises(ValueError):
        iir.IIRFilter([1.0], [1.0], "bogus", device=CPU)
    with pytest.raises(ValueError):
        iir.iir_apply(torch.ones(1), torch.zeros(1), torch.zeros(1),
                      torch.ones(4), method="bogus")


def test_entry_points_default_to_the_card():
    """No device: the coefficients and carry go to the card, or PyTorch's
    own error where there is none (nothing falls back to the CPU)."""
    if torch.cuda.is_available():
        assert iir.IIRFilter([1.0], [1.0, -0.5]).device.type == "cuda"
        assert iir.iir_init(2).device.type == "cuda"
    else:
        for make in (lambda: iir.IIRFilter([1.0], [1.0, -0.5]),
                     lambda: iir.SecondOrderFilter(*_pll()),
                     lambda: iir.iir_init(2), lambda: iir.sos_init(2)):
            with pytest.raises((AssertionError, RuntimeError)):
                make()
