"""Port vs JAX package: the FFT planner and its backends (ops/fft.py).

The same complex128 inputs, made with numpy from a seed, go through both
packages.  Gates: the plan's method and printed tree equal for n = 1..128;
every backend within a relative error of 1e-9 of the JAX package's (the
gate of tests/test_fft.py's exhaustive size tests); Bluestein round trip
>= 120 dB (tests/test_fft.py::test_bluestein_roundtrip_scaling); the
inverse unnormalized.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.design import resources as jresources
from solid_dsp_tpu.ops import fft as jfft
from solid_dsp_tpu_torch.design import resources
from solid_dsp_tpu_torch.ops import fft as tfft
from torch_parity import snr_db

# every plan method: DFT codelets, mixed radix (pow2 and not), Rader,
# Rader2; primes above 256 for matmul's Bluestein route
SIZES = [1, 2, 3, 7, 8, 11, 12, 13, 16, 17, 24, 31, 37, 45, 64, 97, 100,
         127, 128, 257, 1009, 4096]


def _x(n, seed=0, batch=()):
    rng = np.random.default_rng(seed + n)
    shape = (*batch, n)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _rel(got, want):
    return np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30)


def test_resources_match_jax():
    """The planner's integer helpers: equal to the JAX package's for
    n = 0..600 (and a 64-bit prime)."""
    for n in range(0, 601):
        for name in ("msb_index", "factor", "unique_prime_factors",
                     "is_prime", "is_pow2", "next_pow2"):
            assert getattr(resources, name)(n) == \
                getattr(jresources, name)(n), (name, n)
        if n > 2 and resources.is_prime(n):
            assert resources.primitive_root_prime(n) == \
                jresources.primitive_root_prime(n)
            assert resources.modpow(2, n - 1, n) == 1 == \
                jresources.modpow(2, n - 1, n)
    p = (1 << 61) - 1
    assert resources.is_prime(p) and not resources.is_prime(p - 2)


def test_estimate_method_and_plan_repr_match_jax():
    """estimate_method and the printed plan tree, both directions: equal
    for n = 1..128 (and 0's method)."""
    assert tfft.estimate_method(0) == jfft.estimate_method(0)
    for n in range(1, 129):
        assert tfft.estimate_method(n) == jfft.estimate_method(n), n
        assert tfft._estimate_mixed_radix_q(n) == \
            jfft._estimate_mixed_radix_q(n), n
        for d in ("forward", "reverse"):
            assert repr(tfft.FFTPlan(n, d)) == repr(jfft.FFTPlan(n, d)), n
    with pytest.raises(ValueError):
        tfft.FFTPlan(0)


@pytest.mark.parametrize("backend", ["plan", "bluestein", "matmul", "xla",
                                     "auto"])
@pytest.mark.parametrize("direction", ["fft", "ifft"])
def test_backends_match_jax_c128(backend, direction):
    """Every size of SIZES through one backend, batched over 2 rows:
    relative error < 1e-9 against the JAX package's same backend and
    against numpy's unnormalized transform."""
    for n in SIZES:
        x = _x(n, batch=(2,))
        want_np = (np.fft.fft(x) if direction == "fft"
                   else np.fft.ifft(x) * n)
        got = getattr(tfft, direction)(torch.from_numpy(x),
                                       backend=backend).numpy()
        ref = np.asarray(getattr(jfft, direction)(
            jnp.asarray(x, jnp.complex128), backend=backend))
        assert got.dtype == np.complex128 and got.shape == (2, n)
        assert _rel(got, ref) < 1e-9, (n, backend, _rel(got, ref))
        assert _rel(got, want_np) < 1e-9, (n, backend)


def test_bluestein_roundtrip_scaling():
    """fft then ifft through Bluestein at the prime 1009, divided by n:
    >= 120 dB against x; both directions equal to JAX's (1e-9)."""
    n = 1009
    x = _x(n, seed=4)
    X = tfft.fft(torch.from_numpy(x), backend="bluestein")
    y = tfft.ifft(X, backend="bluestein").numpy() / n
    assert snr_db(y, x) >= 120.0
    Xj = jfft.fft(jnp.asarray(x, jnp.complex128), backend="bluestein")
    assert _rel(X.numpy(), np.asarray(Xj)) < 1e-9


@pytest.mark.parametrize("backend", ["plan", "bluestein", "matmul", "xla"])
@pytest.mark.parametrize("n", [12, 17, 64, 97])
def test_ifft_is_unnormalized(backend, n):
    """ifft(fft(x)) == n x (no 1/N in either direction)."""
    x = _x(n, seed=5)
    X = tfft.fft(torch.from_numpy(x), backend=backend)
    y = tfft.ifft(X, backend=backend).numpy()
    np.testing.assert_allclose(y, n * x, rtol=0, atol=1e-9 * n)


def test_pow2_takes_the_native_fft_under_bluestein():
    """A power-of-two size takes torch.fft even under "bluestein", as the
    JAX routing does: bit-equal to torch.fft.fft."""
    x = torch.from_numpy(_x(64, seed=6))
    assert torch.equal(tfft.fft(x, backend="bluestein"), torch.fft.fft(x))


def test_fft_zero_pads_to_nfft_and_casts_real_input():
    """nfft above the length zero-pads; a float32 input becomes
    complex64; both as in JAX."""
    x = _x(20, seed=7)
    got = tfft.fft(torch.from_numpy(x), nfft=30, backend="plan").numpy()
    ref = np.asarray(jfft.fft(jnp.asarray(x), nfft=30, backend="plan"))
    assert _rel(got, ref) < 1e-9
    xr = np.random.default_rng(8).standard_normal(48).astype(np.float32)
    got = tfft.fft(torch.from_numpy(xr))
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), np.asarray(jfft.fft(
        jnp.asarray(xr))), rtol=0, atol=1e-4)


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="backend"):
        tfft.fft(torch.ones(8, dtype=torch.complex64), backend="cufft")


@pytest.mark.parametrize("flags", ["estimate", "measure"])
@pytest.mark.parametrize("n,direction", [(12, "forward"), (37, "reverse"),
                                         (64, "forward"), (121, "reverse")])
def test_fft_object_matches_jax(flags, n, direction):
    """FFT(n, direction, flags) on the CPU: the same repr and method as
    JAX's, and execute() within 1e-9 of JAX's; "measure" keeps one of the
    timed backends."""
    obj = tfft.FFT(n, direction, flags, device="cpu")
    jobj = jfft.FFT(n, direction, "estimate")
    assert repr(obj) == repr(jobj) and obj.method == jobj.method
    x = _x(n, seed=9)
    got = obj.execute(torch.from_numpy(x)).numpy()
    ref = np.asarray(jobj.execute(jnp.asarray(x, jnp.complex128)))
    assert _rel(got, ref) < 1e-9
    if flags == "measure":
        assert obj._backend in ("plan", "xla")


def test_goertzel_matches_jax_and_fft_bin():
    """goertzel at bin-centred frequencies equals the FFT bin (1e-9) and
    JAX's goertzel at an off-bin frequency."""
    x = _x(512, seed=10)
    X = np.fft.fft(x)
    for kbin in (0, 7, 100):
        got = complex(tfft.goertzel(torch.from_numpy(x), kbin / 512))
        assert abs(got - X[kbin]) < 1e-9
    got = complex(tfft.goertzel(torch.from_numpy(x), 0.1234))
    ref = complex(jfft.goertzel(jnp.asarray(x, jnp.complex128), 0.1234))
    assert abs(got - ref) < 1e-9 * abs(ref)
