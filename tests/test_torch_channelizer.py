"""The port's channelizers vs the JAX package's (config 5), on the CPU.

Inputs are made with numpy from a seed; the JAX side runs its Pallas
kernels in interpret mode at the sizes its own tests use, the port its
kernels' plain PyTorch versions (CPU tensors).  Gates, the JAX package's
own (tests/test_models.py:515-600, test_pallas.py:22-84,
test_synthesis.py:57, test_os_channelizer.py:84):

* the commutator form, the planar form ("highest" JAX run), the
  ``PolyphaseChannelizer`` backends at x3, the synthesis and oversampled
  banks: >= 90 dB against JAX (float32 sums in another order);
* the fused channelizer (K4): x3 >= 90 dB, fast >= 45 dB against JAX's
  interpret-mode kernel (bf16 rounding of the branch products);
* the front end (K5): atol 2e-5 max|Y|;
* round trips in the port alone: synthesis -> analysis > 30 dB, the
  oversampled bank's "rrc" reconstruction > 60 dB;
* taps equal to 1e-12 (the same float64 numpy design), tails and carried
  state equal exactly (they are copies of input samples).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.design import firdes as jfirdes
from solid_dsp_tpu.models import channelizer as jch
from solid_dsp_tpu.ops import pallas_kernels as jpk
from solid_dsp_tpu_torch.design import firdes
from solid_dsp_tpu_torch.interop import tensors_from_numpy, tensors_to_numpy
from solid_dsp_tpu_torch.models import channelizer as ch
from solid_dsp_tpu_torch.ops import cuda_chan
from torch_parity import snr_db

CPU = "cpu"


def _noise(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("M,K,att", [(16, 8, 80.0), (256, 8, 80.0),
                                     (64, 4, 60.0), (8, 7, 80.0)])
def test_channelizer_taps_match_jax(M, K, att):
    np.testing.assert_allclose(ch.channelizer_taps(M, K, att),
                               jch.channelizer_taps(M, K, att), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("M,K,rolloff", [(16, 16, 1.0), (16, 8, 0.5),
                                         (32, 12, 0.35)])
def test_os_reconstruction_taps_and_rrcos_match_jax(M, K, rolloff):
    np.testing.assert_allclose(ch.os_reconstruction_taps(M, K, rolloff),
                               jch.os_reconstruction_taps(M, K, rolloff),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(firdes.firdes_rrcos(M, 3, rolloff),
                               jfirdes.firdes_rrcos(M, 3, rolloff), rtol=0,
                               atol=1e-12)
    with pytest.raises(ValueError):
        firdes.firdes_rrcos(M, 3, 0.0)


@pytest.mark.parametrize("M", [16, 64])
def test_kernel_constants_equal_jax(M):
    """K4's permuted filter and folded banks, K5's interleaved taps and the
    planar DFT bank: equal to the JAX package's, value for value."""
    taps = ch.channelizer_taps(M, 8)
    hp, K = cuda_chan.chan_hp2_np(taps, M)
    jhp, jK = jpk._chan_hp2_np(taps, M)
    assert K == jK == 8
    np.testing.assert_array_equal(hp, jhp)
    for got, want in zip(cuda_chan.chan_banks_np(M), jpk._chan_banks_np(M)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(cuda_chan.pfb_frontend_taps(taps, M),
                                  jpk.pfb_frontend_taps(taps, M))
    np.testing.assert_array_equal(ch.channelizer_dft_bank(M, 8),
                                  jch.channelizer_dft_bank(M, 8))


@pytest.mark.parametrize("M,K", [(16, 8), (32, 4)])
def test_channelizer_apply_matches_jax(M, K):
    """Commutator form over two blocks with the tail carried, and a batch
    of two streams: >= 90 dB, tails equal."""
    x = _noise(1, 2 * M * 48).reshape(2, -1)
    taps = np.asarray(ch.channelizer_taps(M, K), np.complex64)
    tail = ch.channelizer_init(M, K, batch_shape=(2,), device=CPU)
    jtail = jch.channelizer_init(M, K, jnp.complex64, batch_shape=(2,))
    half = x.shape[-1] // 2
    for blk in (x[:, :half], x[:, half:]):
        Y, tail = ch.channelizer_apply(taps, tail, _t(blk), M)
        jY, jtail = jch.channelizer_apply(jnp.asarray(taps), jtail,
                                          jnp.asarray(blk), M)
        assert Y.shape == (2, half // M, M)
        assert snr_db(Y.numpy(), np.asarray(jY)) >= 90.0
        np.testing.assert_array_equal(tail.numpy(), np.asarray(jtail))
    with pytest.raises(ValueError, match="multiple of the channel count"):
        ch.channelizer_apply(taps, tail, _t(x[:, :M + 1]), M)


@pytest.mark.parametrize("precision", ["x3", "highest"])
def test_channelizer_apply_planar_matches_jax_highest(precision):
    """Planar form with the matmul DFT against the "highest" JAX run
    (test_models.py:515-541), two blocks: >= 90 dB, tails equal; and the
    port's "default" (bf16 operands) within 45 dB of it."""
    M, K = 16, 8
    x = _noise(3, M * 64)
    taps = np.asarray(ch.channelizer_taps(M, K), np.complex64)
    bank = ch.channelizer_dft_bank(M, K)
    tail = torch.zeros((2, K * M - 1))
    tail_d = tail
    jtail = jnp.zeros((2, K * M - 1), jnp.float32)
    for blk in (x[: x.size // 2], x[x.size // 2:]):
        x2 = np.stack([blk.real, blk.imag])
        Y2, tail = ch.channelizer_apply_planar(taps, bank, tail, _t(x2), M,
                                               precision=precision)
        Yd, tail_d = ch.channelizer_apply_planar(taps, bank, tail_d, _t(x2),
                                                 M, precision="default")
        jY2, jtail = jch.channelizer_apply_planar(
            taps, bank, jtail, jnp.asarray(x2), M, precision="highest")
        assert snr_db(Y2.numpy(), np.asarray(jY2)) >= 90.0
        assert snr_db(Yd.numpy(), np.asarray(jY2)) >= 45.0
        np.testing.assert_array_equal(tail.numpy(), np.asarray(jtail))


@pytest.mark.parametrize("mode,gate", [("x3", 90.0), ("fast", 45.0)])
def test_fused_plain_matches_jax_interpret_kernel(mode, gate):
    """K4's plain version vs JAX's make_fused_channelizer in interpret mode
    (M = 64, K = 8, TF = 16, two blocks with the tail rows carried,
    test_models.py:544-582); the tail rows equal."""
    M, K, TF = 64, 8, 16
    L = M * 64
    x = _noise(5, L)
    taps = ch.channelizer_taps(M, K)
    U = (L // 2) // M
    apply = ch.make_fused_channelizer(taps, M, U, TF=TF, mode=mode,
                                      device=CPU)
    japply = jch.make_fused_channelizer(taps, M, U, TF=TF, mode=mode,
                                        interpret=True)
    tail = ch.fused_channelizer_init(M, CPU)
    jtail = jnp.zeros((2, jpk.CHAN_HALO, M), jnp.float32)
    for blk in (x[: L // 2], x[L // 2:]):
        x2 = np.stack([blk.real, blk.imag]).astype(np.float32)
        Y2, tail = apply(tail, _t(x2))
        jY2, jtail = japply(jtail, jnp.asarray(x2))
        assert Y2.shape == (U, 2 * M)
        assert snr_db(Y2.numpy(), np.asarray(jY2)) >= gate
        np.testing.assert_array_equal(tail.numpy(), np.asarray(jtail))


def test_fused_channelizer_block_rules():
    """The JAX package's block rules: K <= 8, U a multiple of TF."""
    taps = ch.channelizer_taps(16, 8)
    with pytest.raises(ValueError, match="multiple of TF"):
        ch.make_fused_channelizer(taps, 16, 20, TF=16, device=CPU)
    with pytest.raises(ValueError, match="<= 8"):
        ch.make_fused_channelizer(ch.channelizer_taps(16, 9), 16, 16, TF=16,
                                  device=CPU)
    with pytest.raises(ValueError, match="taps_per_branch <= 8"):
        ch.PolyphaseChannelizer(16, 9, backend="fused", device=CPU)
    fused = ch.PolyphaseChannelizer(16, 8, backend="fused", device=CPU)
    with pytest.raises(ValueError, match="multiple of 128 samples"):
        fused.execute_block(np.zeros(16 * 12, np.complex64))
    with pytest.raises(ValueError, match="multiple of the channel count"):
        fused.execute_block(np.zeros(100, np.complex64))
    with pytest.raises(ValueError):
        ch.PolyphaseChannelizer(16, backend="mosaic", device=CPU)
    with pytest.raises(ValueError):
        ch.PolyphaseChannelizer(16, precision="bf16", device=CPU)
    with pytest.raises(ValueError):
        ch.PolyphaseChannelizer(16, engine="triton", device=CPU)


@pytest.mark.parametrize("M,K", [(16, 8), (64, 4), (8, 7)])
def test_frontend_plain_matches_jax_interpret_kernel(M, K):
    """K5's plain version + FFT vs JAX channelizer_apply_pallas in interpret
    mode (test_pallas.py:22-67), two blocks: atol 2e-5 max|Y|, tail rows
    equal."""
    x = _noise(0, 2 * M * 150)
    h_il = cuda_chan.pfb_frontend_taps(ch.channelizer_taps(M, K), M)
    tail = torch.zeros((K, M), dtype=torch.complex64)
    jtail = jnp.zeros((K, M), jnp.complex64)
    for blk in np.split(x, 2):
        Y, tail = cuda_chan.channelizer_apply_pallas(_t(h_il), tail, _t(blk),
                                                     M, K)
        jY, jtail = jpk.channelizer_apply_pallas(
            jnp.asarray(h_il), jtail, jnp.asarray(blk), M, K, interpret=True)
        jY = np.asarray(jY)
        np.testing.assert_allclose(Y.numpy(), jY, rtol=0,
                                   atol=2e-5 * np.abs(jY).max())
        np.testing.assert_array_equal(tail.numpy(), np.asarray(jtail))


def test_frontend_short_block_tail():
    """A block of fewer than K frames keeps the older tail rows, as JAX."""
    M, K = 8, 7
    h_il = cuda_chan.pfb_frontend_taps(ch.channelizer_taps(M, K), M)
    tail0 = _noise(2, K * M).reshape(K, M)
    x = _noise(3, 3 * M)
    _, tail = cuda_chan.pfb_frontend(_t(x), _t(h_il), _t(tail0), M, K)
    _, jtail = jpk.pfb_frontend(jnp.asarray(x), jnp.asarray(h_il),
                                jnp.asarray(tail0), M, K, interpret=True)
    np.testing.assert_array_equal(tail.numpy(), np.asarray(jtail))


@pytest.mark.parametrize("backend", ["xla", "fused", "pallas"])
def test_polyphase_channelizer_matches_jax(backend):
    """The product class over split blocks, each backend against the same
    JAX backend and against JAX's "xla" (x3): >= 90 dB; reset restarts."""
    M, K = 64, 8
    x = _noise(11, M * 32)
    port = ch.PolyphaseChannelizer(M, K, backend=backend, device=CPU)
    jax_same = jch.PolyphaseChannelizer(M, K, backend=backend)
    jax_xla = jch.PolyphaseChannelizer(M, K, backend="xla")
    got, same, ref = [], [], []
    for blk in np.split(x, 2):
        got.append(port.execute_block(blk).numpy())
        same.append(np.asarray(jax_same.execute_block(jnp.asarray(blk))))
        ref.append(np.asarray(jax_xla.execute_block(jnp.asarray(blk))))
    got = np.concatenate(got)
    assert got.shape == (x.size // M, M) and got.dtype == np.complex64
    assert snr_db(got, np.concatenate(same)) >= 90.0
    assert snr_db(got, np.concatenate(ref)) >= 90.0
    port.reset()
    again = port.execute_block(x[: x.size // 2]).numpy()
    np.testing.assert_array_equal(again, got[: len(again)])
    assert f"backend={backend}" in repr(port)


def test_fused_fast_class_matches_jax():
    M, K = 16, 8
    x = _noise(12, M * 64)
    port = ch.PolyphaseChannelizer(M, K, backend="fused", precision="fast",
                                   device=CPU)
    jax_ = jch.PolyphaseChannelizer(M, K, backend="fused", precision="fast")
    assert snr_db(port.execute_block(x).numpy(),
                  np.asarray(jax_.execute_block(jnp.asarray(x)))) >= 45.0


def test_tone_lands_in_its_channel():
    """A +c/M tone lands in channel c, 20x above the others
    (test_pallas.py:70-84), through each backend."""
    M, K, c = 32, 8, 5
    x = np.exp(2j * np.pi * (c / M) * np.arange(M * 256)).astype(np.complex64)
    for backend in ("xla", "fused", "pallas"):
        Y = ch.PolyphaseChannelizer(M, K, backend=backend,
                                    device=CPU).execute_block(x).numpy()
        power = np.mean(np.abs(Y)[2 * K:], axis=0)
        assert power.argmax() == c
        assert power[c] > 20 * np.delete(power, c).max()


def test_synthesizer_matches_jax_and_round_trips():
    """Synthesis over two blocks against JAX (>= 90 dB, carry equal), and
    the port's synthesis -> analysis round trip > 30 dB
    (test_synthesis.py:25-57)."""
    M, K, T = 16, 8, 512
    rng = np.random.default_rng(0)
    Y = (rng.standard_normal((T, M)) + 1j * rng.standard_normal((T, M)))
    h = np.hamming(9)
    h = h / h.sum()
    for m in range(M):
        Y[:, m] = np.convolve(Y[:, m], h, mode="same")
    Y = Y.astype(np.complex64)
    syn = ch.PolyphaseSynthesizer(M, K, device=CPU)
    jsyn = jch.PolyphaseSynthesizer(M, K, dtype=jnp.complex64)
    parts = [syn.execute_block(b).numpy() for b in (Y[:200], Y[200:])]
    jparts = [np.asarray(jsyn.execute_block(jnp.asarray(b)))
              for b in (Y[:200], Y[200:])]
    x = np.concatenate(parts)
    assert x.shape == (T * M,)
    assert snr_db(x, np.concatenate(jparts)) >= 90.0
    assert snr_db(syn.state.numpy(), np.asarray(jsyn._tail)) >= 90.0
    Y2 = ch.PolyphaseChannelizer(M, K, device=CPU).execute_block(x).numpy()
    best = -1.0
    for d in range(0, 2 * K):
        a, b = Y[: T - d], Y2[d:]
        n = min(len(a), len(b))
        seg = slice(n // 4, 3 * n // 4)
        g = np.vdot(b[seg], a[seg]) / (np.vdot(b[seg], b[seg]).real + 1e-30)
        best = max(best, snr_db(g * b[seg], a[seg]))
    assert best > 30.0, best
    assert "PolyphaseSynthesizer" in repr(syn)


def test_oversampled_matches_jax_and_parity_carry():
    """The 2x-oversampled bank over blocks of 3, 5 and 8 M-chunks (odd
    counts exercise the parity carry): >= 90 dB against JAX, state equal."""
    M, K = 16, 8
    x = _noise(4, M * 16)
    osc = ch.OversampledChannelizer(M, K, device=CPU)
    josc = jch.OversampledChannelizer(M, K)
    cuts = [0, 3 * M, 8 * M, 16 * M]
    for a, b in zip(cuts[:-1], cuts[1:]):
        Y = osc.execute_block(x[a:b]).numpy()
        jY = np.asarray(josc.execute_block(jnp.asarray(x[a:b])))
        assert Y.shape == (2 * (b - a) // M, M)
        assert snr_db(Y, jY) >= 90.0
        tail, parity = osc.state
        assert parity.dtype == torch.int32
        assert int(parity) == int(josc._state[1])
        np.testing.assert_array_equal(tail.numpy(), np.asarray(josc._state[0]))
    assert osc.oversample == 2 and "os=2" in repr(osc)
    with pytest.raises(ValueError):
        ch.os_channelizer_apply(osc.taps, osc.state,
                                torch.zeros(M + 1, dtype=torch.complex64), M)
    with pytest.raises(ValueError):
        ch.OversampledChannelizer(M, K, prototype="hann", device=CPU)


def test_oversampled_rrc_reconstruction():
    """synthesize(execute_block(x)) with the "rrc" prototype: > 60 dB in
    the core (test_os_channelizer.py:72-84), and >= 90 dB against JAX's
    reconstruction."""
    M, N = 16, 16 * 512
    x = _noise(1, N)
    osc = ch.OversampledChannelizer(M, 16, prototype="rrc", rolloff=1.0,
                                    device=CPU)
    xh = osc.synthesize(osc.execute_block(x)).numpy()
    josc = jch.OversampledChannelizer(M, 16, prototype="rrc", rolloff=1.0)
    jxh = np.asarray(josc.synthesize(josc.execute_block(jnp.asarray(x))))
    assert xh.shape == x.shape
    core = slice(2 * 16 * M, N - 2 * 16 * M)
    assert snr_db(xh[core], x[core]) > 60.0
    assert snr_db(xh, jxh) >= 90.0


@pytest.mark.parametrize("backend", ["xla", "fused", "pallas"])
def test_channelizer_state_moves_both_ways(backend):
    """A JAX channelizer's tail after one block loads into the port's (its
    shape and dtype kept), the port continues as the JAX object does, and
    its state comes back to numpy unchanged."""
    M, K = 16, 8
    x = _noise(7, M * 128)
    jobj = jch.PolyphaseChannelizer(M, K, backend=backend)
    jobj.execute_block(jnp.asarray(x[: x.size // 2]))
    jstate = np.asarray(jobj._tail)
    port = ch.PolyphaseChannelizer(M, K, backend=backend, device=CPU)
    port.state = tensors_from_numpy(jstate, CPU)
    back = tensors_to_numpy(port.state)
    assert back.dtype == jstate.dtype and back.shape == jstate.shape
    np.testing.assert_array_equal(back, jstate)
    got = port.execute_block(x[x.size // 2:]).numpy()
    want = np.asarray(jobj.execute_block(jnp.asarray(x[x.size // 2:])))
    assert snr_db(got, want) >= 90.0
    np.testing.assert_array_equal(tensors_to_numpy(port.state),
                                  np.asarray(jobj._tail))
    with pytest.raises(ValueError):
        port.state = np.zeros((3, 3), jstate.dtype)


def test_synthesis_and_oversampled_state_move_both_ways():
    M, K = 16, 8
    Y = _noise(8, 64 * M).reshape(64, M)
    jsyn = jch.PolyphaseSynthesizer(M, K, dtype=jnp.complex64)
    jsyn.execute_block(jnp.asarray(Y[:32]))
    syn = ch.PolyphaseSynthesizer(M, K, device=CPU)
    syn.state = tensors_from_numpy(np.asarray(jsyn._tail), CPU)
    np.testing.assert_array_equal(tensors_to_numpy(syn.state),
                                  np.asarray(jsyn._tail))
    got = syn.execute_block(Y[32:]).numpy()
    assert snr_db(got, np.asarray(jsyn.execute_block(jnp.asarray(Y[32:])))
                  ) >= 90.0
    # the carry is the IDFT of the last rows: computed, not copied
    assert snr_db(syn.state.numpy(), np.asarray(jsyn._tail)) >= 90.0

    x = _noise(9, 24 * M)
    josc = jch.OversampledChannelizer(M, K)
    josc.execute_block(jnp.asarray(x[: 3 * M]))         # odd parity now
    jstate = tuple(np.asarray(a) for a in josc._state)
    osc = ch.OversampledChannelizer(M, K, device=CPU)
    osc.state = tensors_from_numpy(jstate, CPU)
    back = tensors_to_numpy(osc.state)
    for a, b in zip(back, jstate):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    got = osc.execute_block(x[3 * M:]).numpy()
    want = np.asarray(josc.execute_block(jnp.asarray(x[3 * M:])))
    assert snr_db(got, want) >= 90.0


def _unpack_bank_tiles(tiles: np.ndarray, num_channels: int) -> tuple:
    """The inverse of ``cuda_chan.chan_bank_tiles``: the split banks (M, 2M)
    a plane and part, in ``chan_split_np``'s order."""
    M = int(num_channels)
    n_tiles, n_chunks, hl, _ = tiles.shape
    t = tiles.reshape(n_tiles, n_chunks, hl, cuda_chan.TILE_DEPTH // 8,
                      cuda_chan.TILE_COLS // 8, 8, 8)
    B = t.transpose(2, 0, 4, 5, 1, 3, 6).reshape(
        hl, n_tiles * cuda_chan.TILE_COLS, n_chunks * cuda_chan.TILE_DEPTH)
    plane, q, _ = cuda_chan._chunk_lanes(M)
    out = []
    for p in (0, 1):
        cols = np.array([np.flatnonzero((plane == p) & (q == j))[0]
                         for j in range(M)])
        for h in range(hl):
            sub = B[h][:2 * M][:, cols]         # (2M, M): rows n, cols q
            out.append(np.concatenate([sub[0::2].T, sub[1::2].T], axis=1))
    return tuple(out)


@pytest.mark.parametrize("M", [8, 12, 16, 48, 256])
@pytest.mark.parametrize("mode", ["x3", "fast"])
def test_fused_bf16_banks_equal_jax_split(M, mode):
    """The bf16 banks K4 multiplies by equal JAX's host split bit for bit
    (``make_pallas_channelizer``: x3 hi = bf16(a), lo = bf16(a - hi); fast
    bf16(a)), both as ``chan_split_np`` gives them and as the kernel reads
    them from ``make_chan_body``'s packed tiles."""
    import ml_dtypes

    bf16 = ml_dtypes.bfloat16
    want = []
    for a in jpk._chan_banks_np(M):
        if mode == "x3":
            hi = np.asarray(a, bf16)
            lo = np.asarray(a - np.asarray(hi, np.float32), bf16)
            want += [hi, lo]
        else:
            want.append(np.asarray(jnp.asarray(a, jnp.bfloat16)))
    want = [w.view(np.uint16) for w in want]
    got = cuda_chan.chan_split_np(M, mode)
    body = cuda_chan.make_chan_body(ch.channelizer_taps(M, 8), M, mode, CPU)
    unpacked = _unpack_bank_tiles(
        body.tiles.numpy().view(np.uint16), M)
    assert len(got) == len(unpacked) == len(want)
    for g, u, w in zip(got, unpacked, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(u, w)


@pytest.mark.parametrize("M,U", [(16, 64), (12, 40), (64, 48)])
@pytest.mark.parametrize("mode,gate", [("x3", 90.0), ("fast", 45.0)])
def test_fused_complex_layout_equals_planar_and_matches_jax(M, U, mode, gate):
    """K4's plain version on complex64 frame rows (U, M) equals its planar
    route bit for bit, and both match JAX's interpret-mode kernel on the
    same rows and tail rows at the JAX gates (x3 >= 90 dB, fast >= 45)."""
    x = _noise(M + U, U * M).reshape(U, M)
    tail = np.random.default_rng(U).standard_normal((2, 8, M)).astype(
        np.float32)
    xf = np.stack([x.real, x.imag])
    taps = ch.channelizer_taps(M, 8)
    body = cuda_chan.make_chan_body(taps, M, mode, CPU)
    yc = cuda_chan.chan_fused_torch(body, _t(x), _t(tail))
    y2 = cuda_chan.chan_fused_torch(body, _t(xf), _t(tail))
    assert yc.dtype == torch.complex64 and yc.shape == (U, M)
    assert torch.equal(yc.real, y2[:, :M]) and torch.equal(yc.imag, y2[:, M:])
    run = jpk.make_pallas_channelizer(taps, M, U // 8, TF=8, mode=mode,
                                      interpret=True)
    jy = np.asarray(run(jnp.asarray(xf), jnp.asarray(tail)))
    assert snr_db(y2.numpy(), jy) >= gate


@pytest.mark.parametrize("precision", ["x3", "fast"])
def test_fused_class_complex_route_equals_planar_route(precision):
    """PolyphaseChannelizer(fused) (K4's complex layout) over two blocks
    with the tail rows carried equals make_fused_channelizer (the planar
    JAX contract) bit for bit, outputs and tail rows."""
    M, K = 16, 8
    L = M * 64
    x = _noise(11, 2 * L)
    cls = ch.PolyphaseChannelizer(M, K, backend="fused", precision=precision,
                                  device=CPU)
    apply = ch.make_fused_channelizer(ch.channelizer_taps(M, K), M, L // M,
                                      TF=16, mode=precision, device=CPU)
    tail = ch.fused_channelizer_init(M, CPU)
    for blk in (x[:L], x[L:]):
        Y = cls.execute_block(blk)
        Y2, tail = apply(tail, _t(np.stack([blk.real, blk.imag])))
        assert torch.equal(Y.real, Y2[:, :M]) and torch.equal(Y.imag,
                                                              Y2[:, M:])
        assert torch.equal(cls.state, tail)
