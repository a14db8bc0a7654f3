"""The sharded rx chain on the fused route's remaining settings, at world
size 1: the port on one gloo rank (tests/torch_dist.py) vs the JAX
package's sharded chain on a (1, 1) mesh of the fake CPU devices.

The same factories build the per-shard bodies in the chain's mode and real
type as on one card.  Two blocks with the state carried.  Gates, those of
the single-card chain (tests/test_torch_rx_chain_default.py): at
``fir_precision="default"`` against JAX's interpret-mode kernels
(``ddc_engine="pallas"``) >= 90 dB where every output is inside K1 or K2
(QPSK >= 60 dB) and >= 40 dB on shards of other lengths (JAX's CPU takes
the XLA edges around K3 in float32, the port rounds them to bf16);
complex128 >= 200 dB; 300 taps (JAX's XLA body) >= 100 dB.  State: phase
word and FIR tail exact, lock, mode and timer equal, gain, energy and
fm_prev rtol 1e-5 / 1e-4, 1e-2 at "default".
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist
from solid_dsp_tpu import parallel
from solid_dsp_tpu.models.rx_chain import RxChainConfig as JaxRxChainConfig
from torch_parity import snr_db

C = 2
MESH = (1, 1)
L_ALIGNED, L_PIECES = 131072, 131072 + 52   # every output in K1 or K2

# name: (config, blocks' length, planar, gate in dB)
CASES = {
    "planar_fm": (dict(demod="fm", fir_precision="default",
                       fused_ddc="on", input_format="planar"),
                  L_ALIGNED, True, 90.0),
    "fm": (dict(demod="fm", fir_precision="default"), L_ALIGNED, False, 90.0),
    "fm_pieces": (dict(demod="fm", fir_precision="default"), L_PIECES, False,
                  40.0),
    "am": (dict(demod="am", fir_precision="default"), L_ALIGNED, False, 90.0),
    "qpsk": (dict(demod="qpsk", fir_precision="default"), L_ALIGNED, False,
             60.0),
    "fm_c128": (dict(demod="fm", fir_precision="default",
                     dtype="complex128"), L_ALIGNED, False, 200.0),
    "am_300_taps": (dict(demod="am", fir_precision="highest", fir_taps=300),
                    L_ALIGNED, False, 100.0),
}


def _cfg(name):
    cfg = dict(agc_mode="block", nco_mode="exact", fused_ddc="auto")
    cfg.update(CASES[name][0])
    return cfg


def _blocks(name):
    """Two blocks: a tone near the carrier plus noise (QPSK symbols held
    for 32 samples), (C, L) complex or the planar (2, L) stream."""
    _, L, planar, _ = CASES[name]
    rng = np.random.default_rng(len(name))
    k = np.arange(2 * L)
    rows = []
    for c in range(1 if planar else C):
        if CASES[name][0]["demod"] == "qpsk":
            gray = np.array([1 + 1j, -1 + 1j, 1 - 1j, -1 - 1j]) / np.sqrt(2)
            s = 0.5 * gray[rng.integers(0, 4, 2 * L // 32 + 1)][k // 32]
            rows.append(s * np.exp(1j * (0.2 + 5e-4) * k))
        else:
            rows.append(0.5 * np.exp(1j * (0.2 + 0.003 * (c + 1)) * k))
        rows[-1] = rows[-1] + 0.05 * (rng.standard_normal(2 * L)
                                      + 1j * rng.standard_normal(2 * L))
    x = np.stack(rows)
    c128 = CASES[name][0].get("dtype") == "complex128"
    if planar:
        return [np.stack([x[0, b * L:(b + 1) * L].real,
                          x[0, b * L:(b + 1) * L].imag]).astype(np.float32)
                for b in range(2)]
    return [x[:, b * L:(b + 1) * L].astype(np.complex128 if c128
                                          else np.complex64)
            for b in range(2)]


@functools.lru_cache(maxsize=None)
def _jax(name):
    cfg = _cfg(name)
    dt = jnp.complex128 if cfg.pop("dtype", None) == "complex128" \
        else jnp.complex64
    mesh = parallel.make_mesh(*MESH)
    init, apply = parallel.make_sharded_rx_chain(
        JaxRxChainConfig(dtype=dt, ddc_engine="pallas", **cfg), mesh)
    planar = CASES[name][2]
    st = init() if planar else init(C)
    outs, states = [], []
    for x in _blocks(name):
        out, st = apply(st, jnp.asarray(x))
        outs.append(np.asarray(out))
        states.append({k: ({kk: np.asarray(vv) for kk, vv in v.items()}
                           if isinstance(v, dict) else np.asarray(v))
                       for k, v in st.items()})
    return outs, states


@pytest.fixture(scope="module")
def rank(tmp_path_factory):
    """The one rank's results of every case."""
    cases = []
    for name in CASES:
        cfg = _cfg(name)
        if cfg.get("dtype") == "complex128":
            cfg["dtype"] = torch.complex128
        cases.append((name, MESH, "rx_chain", dict(
            cfg=cfg, blocks=_blocks(name),
            num_channels=None if CASES[name][2] else C)))
    return torch_dist.run_ranks(tmp_path_factory.mktemp("default"), 1,
                                cases)[0]


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_chain_default_settings_match_jax(rank, name):
    outs, states = _jax(name)
    cfg, _, _, gate = CASES[name]
    bf16 = cfg.get("fir_precision") == "default" and \
        cfg.get("dtype") != "complex128"
    for b, (want, jst) in enumerate(zip(outs, states)):
        got = rank[name]["out"][b]
        assert got.shape == want.shape and got.dtype == want.dtype
        assert np.all(np.isfinite(got))
        assert snr_db(got, want) >= gate
        st = rank[name]["state"][b]
        np.testing.assert_array_equal(st["nco_theta"], jst["nco_theta"])
        np.testing.assert_array_equal(st["fir_tail"], jst["fir_tail"])
        for k in ("gain", "energy"):
            np.testing.assert_allclose(st["agc"][k], jst["agc"][k],
                                       rtol=1e-2 if bf16 else 1e-5)
        for k in ("lock", "mode", "timer"):
            np.testing.assert_array_equal(st["agc"][k], jst["agc"][k])
        np.testing.assert_allclose(st["fm_prev"], jst["fm_prev"],
                                   rtol=1e-2 if bf16 else 1e-4)
