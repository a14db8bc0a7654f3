"""Port vs JAX package: the windowed 4096-point FFT (K7) and config 2's
spectral helpers (ops/cuda_fft.py, ops/fft.py).

The same inputs, made with numpy from a seed, go through both packages; the
JAX side runs K7 in interpret mode as tests/test_fft.py does.  Gates: K7's
plain version >= 90 dB against interpret-mode K7 at x3 (tests/test_fft.py's
fused gate); at "fast" the JAX kernel is one bf16 pass (50.8 dB against
float64 at these inputs, measured on the CPU), the port's is FP32, so the
two agree to the JAX kernel's own accuracy: >= 45 dB (the fast gate of
tests/test_models.py) and within 1 dB of JAX's SNR against float64.
>= 100 dB against the direct float64 DFT on config 2's chirp
(tests/test_snr_configs.py).  The windowed_fft, spectrogram and welch_psd
paths: within 1e-9 (relative) of JAX's at complex128, >= 100 dB at
complex64.  Windows, banks and twiddles equal to the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.design import windows as jwindows
from solid_dsp_tpu.ops import fft as jfft
from solid_dsp_tpu.ops import pallas_fft as jpallas_fft
from solid_dsp_tpu_torch.design import windows
from solid_dsp_tpu_torch.ops import cuda_fft
from solid_dsp_tpu_torch.ops import fft as tfft
from torch_parity import snr_db

N = 4096


def _frames(F, seed=0, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((F, N))
            + 1j * rng.standard_normal((F, N))).astype(dtype)


def _planar(x):
    return np.stack([x.real, x.imag]).astype(np.float32)


def _rel(got, want):
    return np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30)


@pytest.mark.parametrize("window", ["hamming", "blackman_harris"])
@pytest.mark.parametrize("mode", ["x3", "fast"])
def test_k7_plain_matches_interpret_pallas(window, mode):
    """make_fused_windowed_fft on CPU planes (the plain version) vs the
    JAX kernel in interpret mode, F = 16."""
    F = 16
    x = _frames(F, seed=1)
    w = windows.get_window(window, N)
    got = cuda_fft.make_fused_windowed_fft(N, F, w, TF=8, mode=mode)(
        torch.from_numpy(_planar(x))).numpy()
    ref = np.asarray(jpallas_fft.make_fused_windowed_fft(
        N, F, window=np.asarray(w, np.float32), TF=8, mode=mode,
        interpret=True)(jnp.asarray(_planar(x))))
    truth = np.fft.fft(x.astype(np.complex128) * w)
    truth2 = np.concatenate([truth.real, truth.imag], axis=1)
    assert got.shape == (F, 2 * N) and got.dtype == np.float32
    assert snr_db(got, truth2) >= 120.0
    if mode == "x3":
        assert snr_db(got, ref) >= 90.0
    else:
        own = snr_db(ref, truth2)
        assert snr_db(got, ref) >= 45.0
        assert abs(snr_db(got, ref) - own) <= 1.0


def test_k7_plain_inverse_sign_matches_interpret_pallas():
    """sign = +1 (the unnormalized inverse) vs interpret-mode K7: >= 90
    dB."""
    F = 8
    x = _frames(F, seed=2)
    got = cuda_fft.make_fused_windowed_fft(N, F, None, TF=8, sign=1)(
        torch.from_numpy(_planar(x))).numpy()
    ref = np.asarray(jpallas_fft.make_fused_windowed_fft(
        N, F, None, TF=8, sign=1, interpret=True)(jnp.asarray(_planar(x))))
    assert snr_db(got, ref) >= 90.0


@pytest.mark.parametrize("window", ["hamming", "blackman_harris"])
def test_k7_plain_vs_direct_dft_on_chirp(window):
    """Config 2's chirp e^{j pi 0.4 k^2 / n}, 8 frames through the fused
    route (plain version on the CPU) vs the O(N^2) direct float64 windowed
    DFT: >= 100 dB."""
    k = np.arange(N)
    chirp = np.exp(1j * np.pi * 0.4 * k * k / N)
    w = np.asarray(windows.get_window(window, N), np.float64)
    W = np.exp(-2j * np.pi * np.outer(k, k) / N)
    want = W @ (w * chirp)
    frames = np.tile(chirp.astype(np.complex64), (8, 1))
    got = tfft.windowed_fft(torch.from_numpy(frames), window,
                            backend="fused").numpy()
    for f in range(8):
        assert snr_db(got[f], want) >= 100.0


@pytest.mark.parametrize("backend", ["auto", "xla"])
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_windowed_fft_matches_jax(backend, dtype):
    """windowed_fft against JAX's (its CPU auto path is window x jnp.fft):
    Hamming frames, a zero-padded nfft, and Kaiser with its beta."""
    x = _frames(8, seed=3, dtype=dtype)
    cases = [(("hamming",), {}), (("hann", 5000), {}),
             (("kaiser", None, 8.0), {})]
    for args, kw in cases:
        got = tfft.windowed_fft(torch.from_numpy(x), *args, backend=backend,
                                **kw).numpy()
        ref = np.asarray(jfft.windowed_fft(jnp.asarray(x), *args,
                                           backend=backend, **kw))
        assert got.dtype == ref.dtype and got.shape == ref.shape
        if dtype == np.complex128:
            assert _rel(got, ref) < 1e-9
        else:
            assert snr_db(got, ref) >= 100.0


def test_windowed_fft_fused_matches_jax_fused_and_checks_shape():
    """backend="fused" (K7's route; the plain version on the CPU) vs JAX's
    fused route in interpret mode: >= 90 dB; a 1000-point frame or F not a
    multiple of 8 raises the same ValueError on both sides."""
    x = _frames(16, seed=4)
    got = tfft.windowed_fft(torch.from_numpy(x), "hamming",
                            backend="fused").numpy()
    ref = np.asarray(jfft.windowed_fft(jnp.asarray(x), "hamming",
                                       backend="fused"))
    assert got.dtype == np.complex64 and snr_db(got, ref) >= 90.0
    for bad in (x[:, :1000], x[:12]):
        with pytest.raises(ValueError, match="fused windowed_fft"):
            tfft.windowed_fft(torch.from_numpy(bad), "hamming",
                              backend="fused")
        with pytest.raises(ValueError, match="fused windowed_fft"):
            jfft.windowed_fft(jnp.asarray(bad), "hamming", backend="fused")


@pytest.mark.parametrize("mode", ["x3", "fast"])
def test_windowed_fft_planar_matches_jax(mode):
    """windowed_fft_planar (2, F, 4096) -> (F, 8192) vs JAX's, Blackman-
    Harris: x3 >= 90 dB, fast >= 45 dB; bad shapes raise."""
    x2 = _planar(_frames(8, seed=5))
    got = tfft.windowed_fft_planar(torch.from_numpy(x2), "blackman_harris",
                                   mode=mode).numpy()
    ref = np.asarray(jfft.windowed_fft_planar(jnp.asarray(x2),
                                              "blackman_harris", mode=mode))
    assert got.shape == (8, 2 * N)
    assert snr_db(got, ref) >= (90.0 if mode == "x3" else 45.0)
    with pytest.raises(ValueError, match="planes"):
        tfft.windowed_fft_planar(torch.from_numpy(x2[:, :, :1000]))
    with pytest.raises(ValueError, match="divide by 8"):
        tfft.windowed_fft_planar(torch.from_numpy(x2[:, :4]))


@pytest.mark.parametrize("frame,hop,nfft", [(256, 128, None),
                                            (4096, None, None),
                                            (100, 50, 128)])
def test_spectrogram_matches_jax(frame, hop, nfft):
    """ops/fft.py::spectrogram on a chirp plus noise: 1e-9 (relative) at
    complex128, >= 100 dB at complex64."""
    rng = np.random.default_rng(6)
    n = 8 * 4096 + 100
    k = np.arange(n)
    x = np.exp(1j * np.pi * 0.4 * k * k / n) + 0.1 * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for dtype in (np.complex128, np.complex64):
        xd = x.astype(dtype)
        got = tfft.spectrogram(torch.from_numpy(xd), frame, hop,
                               nfft=nfft).numpy()
        ref = np.asarray(jfft.spectrogram(jnp.asarray(xd), frame, hop,
                                          nfft=nfft))
        assert got.shape == ref.shape
        if dtype == np.complex128:
            assert _rel(got, ref) < 1e-9
        else:
            assert snr_db(got, ref) >= 100.0


@pytest.mark.parametrize("nfft", [None, 2048])
def test_welch_psd_matches_jax(nfft):
    """ops/fft.py::welch_psd on a tone in noise: within 1e-9 of JAX's at
    complex128, the tone's bin on top."""
    rng = np.random.default_rng(7)
    n = 1 << 15
    x = np.exp(2j * np.pi * 0.125 * np.arange(n)) + 0.01 * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
    got = tfft.welch_psd(torch.from_numpy(x), frame=1024, nfft=nfft).numpy()
    ref = np.asarray(jfft.welch_psd(jnp.asarray(x), frame=1024, nfft=nfft))
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-12 * ref.max())
    assert int(np.argmax(got)) == int(0.125 * (nfft or 1024))


def test_auto_on_a_cpu_tensor_takes_torch_fft():
    """windowed_fft(auto) on fusable frames that lie on the CPU takes
    window x torch.fft (bit-equal to "xla") and launches nothing; the
    card's route is in tests/test_torch_cuda.py."""
    x = torch.from_numpy(_frames(8, seed=8))
    before = cuda_fft.windowed_fft_cuda.launches
    got = tfft.windowed_fft(x, "hamming")
    assert torch.equal(got, tfft.windowed_fft(x, "hamming", backend="xla"))
    assert cuda_fft.windowed_fft_cuda.launches == before
    with pytest.raises(ValueError):
        cuda_fft.windowed_fft_cuda(x, torch.ones(N), torch.ones(N, 2),
                                   planar=False)


def test_kernel_tables_cache_is_bounded_and_ignores_frame_count():
    """The window/twiddle cache holds at most 16 entries and one entry
    serves every F."""
    assert cuda_fft._tables.cache_info().maxsize == 16
    w = windows.get_window("hann", N)
    cuda_fft.windowed_fft_frames(torch.from_numpy(_planar(_frames(8))), w)
    hits = cuda_fft._tables.cache_info().hits
    cuda_fft.windowed_fft_frames(torch.from_numpy(_planar(_frames(16))), w)
    assert cuda_fft._tables.cache_info().hits == hits + 1


@pytest.mark.parametrize("sign", [-1, 1])
def test_tables_match_jax(sign):
    """Both sides build equal tables from the same arguments: the plain
    version's stage-C bank and twiddle are the JAX kernel's (float32), and
    the kernel's table is e^{sign 2 pi i m / N} rounded once."""
    fa, fc, tw = cuda_fft._four_step_np(sign)
    bc = jpallas_fft._stage_c_bank_np(sign)
    np.testing.assert_array_equal(fc.real.astype(np.float32),
                                  bc[:128, :128])
    np.testing.assert_array_equal(fc.imag.astype(np.float32),
                                  bc[:128, 128:])
    twj = jpallas_fft._twiddle_big_np(1, sign)
    np.testing.assert_array_equal(tw.real.astype(np.float32), twj[0])
    np.testing.assert_array_equal(tw.imag.astype(np.float32), twj[1])
    bar, bai = jpallas_fft._stage_a_bank_np(1, sign)
    np.testing.assert_array_equal(fa.real.astype(np.float32), bar)
    np.testing.assert_array_equal(fa.imag.astype(np.float32), bai)
    t = cuda_fft.twiddle_table_np(sign)
    m = np.arange(N)
    np.testing.assert_array_equal(
        t, np.stack([np.cos(2 * np.pi * m / N),
                     sign * np.sin(2 * np.pi * m / N)], 1).astype(np.float32))


@pytest.mark.parametrize("name,args", [("kaiser", (8.6,)),
                                       ("kaiser_bessel", (4.0,)),
                                       ("hamming", ()), ("hann", ()),
                                       ("blackman_harris", ()),
                                       ("blackman_harris7", ()),
                                       ("flattop", ()),
                                       ("triangular", (63,)),
                                       ("rcostaper", (10,))])
def test_windows_match_jax(name, args):
    """Every window family by name: 1e-15 against the JAX package's; the
    same errors on bad arguments."""
    n = 64
    np.testing.assert_allclose(windows.get_window(name, n, *args),
                               jwindows.get_window(name, n, *args), rtol=0,
                               atol=1e-15)
    with pytest.raises(ValueError, match="unknown window"):
        windows.get_window("boxcar", n)
    for fn, bad in ((windows.kaiser_bessel, (63, 4.0)),
                    (windows.triangular, (64, 70)),
                    (windows.rcostaper, (64, 40))):
        with pytest.raises(ValueError):
            fn(*bad)
