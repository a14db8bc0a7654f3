"""Port vs JAX package on the CPU: ``utils/metrics.py`` and
``utils/profiling.py``.

Gates: ``rssi_db`` equal; ``BlockMetrics.to_json`` equal for equal
fields; ``MetricsCollector`` over the port's chain against JAX's over the
JAX chain, block for block (gains and energies within rtol 1e-5, float32
sums in another order; ``rssi_db`` within 1e-4 dB; lock, indices and
sample counts equal); ``roofline`` equal for an explicit ``chip="cpu"``;
``fir_workload`` and ``fft_workload`` equal; ``emit_metric``'s line
equal; ``benchmark`` and ``trace`` run on the CPU (the trace file is
written and names the work); the port's ``CHIP_PEAKS`` holds no TPU
entry, and ``roofline``'s default device is the card's row.
"""

import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.models.rx_chain import RxChain as JaxRxChain
from solid_dsp_tpu.utils import metrics as jmetrics
from solid_dsp_tpu.utils import profiling as jprof
from solid_dsp_tpu_torch import utils
from solid_dsp_tpu_torch.models.rx_chain import RxChain
from solid_dsp_tpu_torch.utils import metrics, profiling


def _tone(n, f, amp=0.1, seed=0):
    rng = np.random.default_rng(seed)
    k = np.arange(n)
    return (amp * np.exp(2j * np.pi * f * k)
            + 0.001 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)))


def test_utils_exports_match_jax():
    import solid_dsp_tpu.utils as jutils
    import solid_dsp_tpu_torch as pkg
    for name in ("Timer", "benchmark", "trace", "emit_metric",
                 "BlockMetrics", "MetricsCollector", "rssi_db"):
        assert hasattr(jutils, name) and hasattr(utils, name), name
    assert pkg.utils is utils
    assert set(metrics.__all__) == set(jmetrics.__all__)
    assert set(jprof.__all__) <= set(profiling.__all__)


@pytest.mark.parametrize("gain", [10.0, 1.0, 0.5, 1e-3, 3.7e4, 0.0, -1.0])
def test_rssi_db_matches_jax(gain):
    assert metrics.rssi_db(gain) == jmetrics.rssi_db(gain)


def test_block_metrics_json_matches_jax():
    for kw in ({}, {"rssi_db": -3.5, "agc_gain": 1.5, "agc_locked": True,
                    "energy": 0.25}, {"agc_locked": False}):
        got = metrics.BlockMetrics(3, 4096, 0.002, **kw)
        want = jmetrics.BlockMetrics(3, 4096, 0.002, **kw)
        assert got.to_json() == want.to_json()
        assert got.msps == want.msps
    assert metrics.BlockMetrics(0, 10, 0.0).msps == \
        jmetrics.BlockMetrics(0, 10, 0.0).msps


@pytest.mark.parametrize("overrides", [
    dict(nco_mode="exact", agc_mode="block", demod="fm"),
    dict(nco_mode="exact", agc_mode="block", demod="am"),
    dict(nco_mode="exact", agc_mode="exact", demod="fm"),
])
def test_collector_matches_jax(overrides):
    """tests/test_state_metrics.py's collector, block for block, on both
    chains."""
    chain = RxChain(device="cpu", dtype=torch.complex64, **overrides)
    jchain = JaxRxChain(dtype=jnp.complex64, **overrides)
    lines, jlines = [], []
    mc = metrics.MetricsCollector(sink=lambda m: lines.append(m.to_json()))
    jmc = jmetrics.MetricsCollector(sink=lambda m: jlines.append(m.to_json()))
    for b, amp in enumerate((0.05, 0.05, 0.2, 0.01)):
        x = _tone(4096, 0.033, amp=amp, seed=b).astype(np.complex64)
        out = mc.measure(chain, torch.from_numpy(x))
        jout = jmc.measure(jchain, jnp.asarray(x))
        assert tuple(out.shape) == np.asarray(jout).shape
    assert len(mc.history) == len(jmc.history) == 4
    for m, jm in zip(mc.history, jmc.history):
        assert (m.block_index, m.n_samples) == (jm.block_index, jm.n_samples)
        assert m.agc_locked == jm.agc_locked
        np.testing.assert_allclose(m.agc_gain, jm.agc_gain, rtol=1e-5)
        np.testing.assert_allclose(m.energy, jm.energy, rtol=1e-5)
        assert abs(m.rssi_db - jm.rssi_db) <= 1e-4
        assert m.seconds > 0
    rec, jrec = json.loads(lines[-1]), json.loads(jlines[-1])
    assert set(rec) == set(jrec)
    assert rec["block_index"] == 3 and rec["msps"] > 0
    last = mc.history[-1]
    assert last.agc_gain > 1.0
    assert last.rssi_db == metrics.rssi_db(float(chain.state["agc"]["gain"]))


def test_collector_on_numpy_planar_blocks_and_stateless_chains():
    chain = RxChain(device="cpu", input_format="planar")
    x = _tone(8192, 0.05).astype(np.complex64)
    mc = metrics.MetricsCollector()
    mc.measure(chain, np.stack([x.real, x.imag]))
    assert mc.history[0].n_samples == 8192

    class Plain:
        def execute_block(self, block):
            return block * 2

    mc2, jmc2 = metrics.MetricsCollector(), jmetrics.MetricsCollector()
    mc2.measure(Plain(), torch.ones(5))
    jmc2.measure(Plain(), np.ones(5))
    assert mc2.history[0].agc_gain is None
    assert json.loads(mc2.history[0].to_json()).keys() == \
        json.loads(jmc2.history[0].to_json()).keys()


@pytest.mark.parametrize("n,taps,cplx", [(1 << 20, 64, True),
                                         (4096, 7, False)])
def test_workloads_match_jax(n, taps, cplx):
    assert profiling.fir_workload(n, taps, cplx) == \
        jprof.fir_workload(n, taps, cplx)
    assert profiling.fft_workload(n // 64, 64, cplx) == \
        jprof.fft_workload(n // 64, 64, cplx)
    assert profiling.fft_workload(3, 1) == jprof.fft_workload(3, 1)


@pytest.mark.parametrize("seconds,flops,nbytes", [
    ((1 << 20) / 68e9, 8.0 * 64 * (1 << 20), 16.0 * (1 << 20)),
    (0.05, 1e12, 1e9), (1.0, 0.0, 0.5)])
def test_roofline_matches_jax_on_cpu_row(seconds, flops, nbytes):
    got = profiling.roofline("w", seconds, flops, nbytes, chip="cpu")
    want = jprof.roofline("w", seconds, flops, nbytes, chip="cpu")
    assert got.__dict__ == want.__dict__
    assert repr(got) == repr(want)


def test_chip_peaks_hold_the_card_not_the_tpu():
    assert not any("tpu" in k for k in profiling.CHIP_PEAKS)
    assert profiling.CHIP_PEAKS["cpu"] == jprof.CHIP_PEAKS["cpu"]
    h100 = profiling.CHIP_PEAKS["h100-sxm"]
    assert h100 == {"gflops_f32": 67_000.0, "gbps_hbm": 3_350.0}
    flops, nbytes = profiling.fir_workload(1 << 24, 64)
    r = profiling.roofline("fir", 1e-3, flops, nbytes)
    assert r.__dict__ == profiling.roofline("fir", 1e-3, flops, nbytes,
                                            chip="h100-sxm").__dict__
    assert r.__dict__ == profiling.roofline("fir", 1e-3, flops, nbytes,
                                            chip="no-such").__dict__
    assert r.bound == "compute"
    np.testing.assert_allclose(r.frac_memory, 2 * 8 * (1 << 24) / 1e-3
                               / 3.35e12)


def test_emit_metric_matches_jax(capsys):
    profiling.emit_metric("rate", 1.5, "Msamples/s", 0.9)
    got = capsys.readouterr().out
    jprof.emit_metric("rate", 1.5, "Msamples/s", 0.9)
    assert got == capsys.readouterr().out


def test_timer():
    t = profiling.Timer("x")
    assert t.mean == 0.0
    for _ in range(3):
        with t:
            pass
    assert t.count == 3 and t.total >= 0.0 and t.mean == t.total / 3


def test_benchmark_on_cpu():
    chain = RxChain(device="cpu", input_format="planar")
    x = torch.from_numpy(np.stack([_tone(1 << 14, 0.03).real,
                                   _tone(1 << 14, 0.03).imag])
                         .astype(np.float32))
    res = profiling.benchmark(chain.execute_block, x, warmup=1, iters=3,
                              samples=1 << 14)
    assert set(res) == {"seconds_per_call", "samples_per_second",
                        "msamples_per_second"}
    assert res["seconds_per_call"] > 0
    np.testing.assert_allclose(res["msamples_per_second"],
                               (1 << 14) / res["seconds_per_call"] / 1e6)
    nested = profiling.benchmark(lambda: {"a": (torch.ones(2), [3])},
                                 warmup=0, iters=1)
    assert set(nested) == {"seconds_per_call"}


def test_trace_on_cpu_writes_a_trace(tmp_path):
    logdir = str(tmp_path / "tr")
    x = torch.randn(4096)
    with profiling.trace(logdir):
        torch.fft.fft(x)
    files = glob.glob(os.path.join(logdir, "trace-*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("fft" in str(e.get("name", "")) for e in events)
