"""The receive chain's exact-AGC and reference-parity branches: the port vs
the JAX package's chain, on the CPU.

Four blocks of L = 16384 samples (T = 4096 decimated, so the exact scan's
plain loop stays short) with the state carried.  The JAX side runs K2/K3 in
interpret mode (``ddc_engine="pallas"``) where its route reaches them (the
fused route with exact or parallel AGC), its XLA path otherwise.  The
unfused cases run at ``fir_precision="highest"``: JAX's CPU convolution
refuses "x3".

Gates (tests/test_rx_chain_fused.py:50,70 and this port's chain tests):
the output >= 90 dB against JAX at x3 and >= 100 dB at "highest" (QPSK
>= 60 dB, BASELINE.json's bound); "default" >= 40 dB (JAX's CPU ignores
DEFAULT and runs full float32, the port rounds both operands to bf16 on
every device: single-pass bf16's ~45 dB); the phase word bit-equal; the
FIR tail exactly equal on the fused route (copies of input samples) and
within 1e-6 on the unfused route and after the impairment stage (there it
is the mixed or corrected stream, a complex product that XLA's CPU takes
with FMA); fir_phase, lock, mode and timer equal; gain and energy rtol
1e-5 (float32 sums in another order) and fm_prev rtol 1e-4, both 1e-2 at
"default" (its output error moves the gain by ~1e-3); the impairment
estimates within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.models.rx_chain import RxChainConfig as JaxRxChainConfig
from solid_dsp_tpu.models.rx_chain import make_rx_chain as jax_make_rx_chain
from solid_dsp_tpu.models.rx_chain import \
    make_rx_chain_stream as jax_make_rx_chain_stream
from solid_dsp_tpu.streaming.state import ChainState as JaxChainState
from solid_dsp_tpu_torch.interop import state_from_numpy, state_to_numpy
from solid_dsp_tpu_torch.models.rx_chain import (RxChain, RxChainConfig,
                                                  make_rx_chain,
                                                  make_rx_chain_stream)
from solid_dsp_tpu_torch.streaming.state import ChainState
from torch_parity import (CONFIG4, as_format, make_blocks, make_qpsk_blocks,
                          run_jax, run_torch, snr_db)

L = 16384
C128 = dict(dtype="c128")


def _unfused(**kw):
    return dict(fir_precision="highest", **kw)


def _lut(**kw):
    """The reference-parity chain: the LUT NCO, so "auto" is unfused."""
    return _unfused(nco_mode="lut", fused_ddc="auto", **kw)


# the 8 settings the chain raised on before they were ported, then more
PORTED = [
    dict(agc_mode="exact"),
    dict(agc_mode="parallel"),
    dict(agc_mode="exact", demod="qpsk"),
    _unfused(fused_ddc="off"),
    _unfused(fused_ddc="off", demod="am", input_format="ci16"),
    _lut(),
    dict(impairment_bw=0.1),
    dict(debug_checks=True),
    _lut(agc_mode="parallel"),
    _lut(agc_mode="exact", demod="qpsk"),
    _lut(demod="none", input_format="cf32"),
    _unfused(fused_ddc="off", agc_mode="parallel", demod="am"),
    _lut(impairment_bw=0.2, agc_mode="exact"),
    dict(agc_mode="parallel", demod="qpsk", input_format="cf32"),
    dict(agc_mode="exact", epilogue="rotate", demod="am",
         input_format="ci16"),
    dict(fir_precision="default", fused_ddc="off"),
    _unfused(fused_ddc="off", **C128),
    _unfused(fused_ddc="off", fir_taps=4),
    _unfused(fused_ddc="off", fir_taps=300, demod="am"),
]


def _ids(o):
    return "-".join(f"{k}={v}" for k, v in o.items()) or "default"


def _split(override):
    """(port overrides, JAX overrides, input dtype) from one case."""
    o = dict(override)
    c128 = o.pop("dtype", None) == "c128"
    tov, jov = dict(o), dict(o)
    if c128:
        tov["dtype"], jov["dtype"] = torch.complex128, jnp.complex128
    return tov, jov, c128


def _blocks(o, c128, n=4, seed=7):
    if o.get("demod") == "qpsk":
        blocks, _ = make_qpsk_blocks(n, L, seed=seed)
    else:
        blocks = make_blocks(n, L, seed=seed)
    if c128:
        blocks = [b.astype(np.float64) for b in blocks]
    return as_format(blocks, o.get("input_format", "planar"))


def _fused(o) -> bool:
    f = o.get("fused_ddc", CONFIG4["fused_ddc"])
    return f == "on" or (f == "auto" and o.get("nco_mode", "exact") == "exact")


def _check_state(st, jst, o):
    got = state_to_numpy(st)
    assert got["nco_theta"].dtype == np.uint32
    assert got["nco_theta"] == jst["nco_theta"]
    assert got["fir_tail"].dtype == jst["fir_tail"].dtype
    if _fused(o) and not o.get("impairment_bw"):
        np.testing.assert_array_equal(got["fir_tail"], jst["fir_tail"])
    else:
        np.testing.assert_allclose(got["fir_tail"], jst["fir_tail"], rtol=0,
                                   atol=1e-6)
    assert got["fir_phase"] == jst["fir_phase"]
    # "default": the port's bf16 product against JAX's float32 one moves
    # the gain by ~1e-3
    bf16 = o.get("fir_precision") == "default"
    for k in ("gain", "energy"):
        assert got["agc"][k].dtype == jst["agc"][k].dtype
        np.testing.assert_allclose(got["agc"][k], jst["agc"][k],
                                   rtol=1e-2 if bf16 else 1e-5)
    for k in ("lock", "mode", "timer"):
        assert got["agc"][k] == jst["agc"][k]
    np.testing.assert_allclose(got["fm_prev"], jst["fm_prev"],
                               rtol=1e-2 if bf16 else 1e-4)
    assert ("impair" in got) == ("impair" in jst)
    if "impair" in got:
        for k in ("dc", "k"):
            np.testing.assert_allclose(got["impair"][k], jst["impair"][k],
                                       rtol=0, atol=1e-6)
        assert got["impair"]["primed"] == jst["impair"]["primed"]


def _gate(o) -> float:
    if o.get("demod") == "qpsk":
        return 60.0
    if o.get("fir_precision") == "default":
        return 40.0
    return 100.0 if o.get("fir_precision") == "highest" else 90.0


@pytest.mark.parametrize("override", PORTED, ids=_ids)
def test_ported_settings_match_jax(override):
    tov, jov, c128 = _split(override)
    blocks = _blocks(override, c128)
    engine = "pallas" if _fused(override) else "xla"
    want, jst = run_jax(blocks, ddc_engine=engine, **jov)
    got, st = run_torch(blocks, **tov)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.all(np.isfinite(got))
    assert snr_db(got, want) >= _gate(override)
    _check_state(st, jst, override)


def test_lut_auto_is_the_unfused_chain():
    """fused_ddc="auto" with the LUT NCO runs the unfused parity route:
    bit-equal to fused_ddc="off"; "on" with the LUT raises ValueError."""
    blocks = _blocks({}, False, n=2)
    a, _ = run_torch(blocks, **_lut())
    b, _ = run_torch(blocks, **_unfused(nco_mode="lut", fused_ddc="off"))
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="nco_mode='exact'"):
        make_rx_chain(RxChainConfig(**{**CONFIG4, "nco_mode": "lut",
                                       "fused_ddc": "on"}), "cpu")


def test_parallel_agc_chain_matches_exact_chain():
    """The parity chain's two AGCs on the same blocks: parallel against the
    exact scan within 1e-5 of max|out| (float32 Newton solve against the
    float32 scan), gain rtol 1e-5, mode and timer equal."""
    blocks = _blocks({}, False, n=3)
    ov = _lut(demod="none")
    a, sa = run_torch(blocks, agc_mode="exact", **ov)
    b, sb = run_torch(blocks, agc_mode="parallel", **ov)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-5 * np.abs(a).max())
    np.testing.assert_allclose(float(sb["agc"]["gain"]),
                               float(sa["agc"]["gain"]), rtol=1e-5)
    assert int(sa["agc"]["mode"]) == int(sb["agc"]["mode"])


@pytest.mark.parametrize("override", [
    dict(), _lut(agc_mode="exact"),
    dict(impairment_bw=0.1, agc_mode="parallel", demod="am")], ids=_ids)
def test_debug_checks_name_the_stage_as_jax(override):
    """A NaN in the input: FloatingPointError naming the same first stage
    as the JAX chain; finite blocks pass with the same output."""
    cfg = {**CONFIG4, **override, "debug_checks": True, "input_format": "cf32"}
    b = make_blocks(1, 4096)[0]
    x = (b[0] + 1j * b[1]).astype(np.complex64)
    x[100] = np.nan
    init, apply = make_rx_chain(RxChainConfig(**cfg), "cpu")
    jinit, japply = jax_make_rx_chain(JaxRxChainConfig(
        **{**cfg, "dtype": jnp.complex64, "ddc_engine": "xla"}))
    with pytest.raises(FloatingPointError) as e:
        apply(init(), torch.from_numpy(x))
    with pytest.raises(FloatingPointError) as je:
        japply(jinit(), jnp.asarray(x))
    assert str(e.value) == str(je.value)
    assert "'input'" in str(e.value)


def test_rx_chain_stream_matches_jax():
    """make_rx_chain_stream: four blocks in one call against the JAX
    package's stream (its fori_loop over the blocks), the parity chain."""
    blocks = _blocks({}, False)
    ov = _lut(agc_mode="exact", input_format="planar")
    x = np.concatenate(blocks, axis=1)
    init, apply_stream = make_rx_chain_stream(
        RxChainConfig(**{**CONFIG4, **ov}), L, "cpu")
    got, st = apply_stream(init(), torch.from_numpy(x))
    jinit, japply = jax_make_rx_chain_stream(JaxRxChainConfig(
        **{**CONFIG4, **ov, "dtype": jnp.complex64, "ddc_engine": "xla"}), L)
    want, jst = japply(jinit(), jnp.asarray(x))
    want = np.asarray(want)
    assert got.shape == want.shape
    assert snr_db(got.numpy(), want) >= 100.0
    _check_state(st, jax.tree_util.tree_map(np.asarray, jst), ov)
    with pytest.raises(ValueError, match="multiple of block_size"):
        apply_stream(init(), torch.from_numpy(x[:, :L + 4]))


def test_checkpoint_with_impair_and_agc_carry_both_ways(tmp_path):
    """A state with the ``impair`` subtree and an AGC carry that the exact
    scan moved: JAX -> .npz -> port, the port resumes and matches JAX's
    continuation; port -> .npz -> JAX, leaf for leaf."""
    ov = _lut(agc_mode="exact", impairment_bw=0.1)
    blocks = _blocks({}, False)
    _, jst2 = run_jax(blocks[:2], ddc_engine="xla", **ov)
    want, jst4 = run_jax(blocks, ddc_engine="xla", **ov)
    path = str(tmp_path / "jax.npz")
    JaxChainState(**jst2).save(path)
    init, _ = make_rx_chain(RxChainConfig(**{**CONFIG4, **ov}), "cpu")
    st2 = ChainState.load(path, like=init())
    assert set(st2["impair"]) == {"dc", "k", "primed"}
    assert st2["agc"]["gain"].dtype == torch.float32
    got, st4 = run_torch(blocks[2:], state=st2, **ov)
    assert snr_db(got, want[want.size // 2:]) >= 100.0
    _check_state(st4, jst4, ov)
    ppath = st4.save(str(tmp_path / "port"))
    from solid_dsp_tpu.models.rx_chain import rx_chain_init
    like = rx_chain_init(JaxRxChainConfig(**{**CONFIG4, **ov,
                                             "dtype": jnp.complex64}))
    back = jax.tree_util.tree_map(np.asarray,
                                  JaxChainState.load(ppath, like=like))
    mine = state_to_numpy(st4)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(mine)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    again = state_from_numpy(back, "cpu")
    assert int(again["impair"]["primed"]) == 1


def test_rx_chain_module_takes_complex128_blocks():
    """RxChain with a complex128 unfused chain casts cf32 blocks to the
    chain's type and planar blocks to float64."""
    blocks = _blocks({}, True, n=2)
    ov = _unfused(fused_ddc="off", dtype=torch.complex128)
    chain = RxChain(RxChainConfig(**{**CONFIG4, **ov}), device="cpu")
    out = torch.cat([chain.execute_block(b) for b in blocks])
    want, _ = run_torch(blocks, **ov)
    assert out.dtype == torch.float64
    np.testing.assert_array_equal(out.numpy(), want)
