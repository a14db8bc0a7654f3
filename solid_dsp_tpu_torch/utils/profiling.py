"""Timers, throughput benchmarking and roofline counters.

Port of ``solid_dsp_tpu/utils/profiling.py``: wall-clock timing with a
device wait, samples/s and GFLOP/s reporting, and trace capture, here by
``torch.profiler`` (a Chrome trace written into the log directory; the
card's kernels when CUDA is available).

``CHIP_PEAKS`` diverges from the JAX package on purpose: the JAX table
holds TPU peaks, which say nothing of this port's device, so the port's
table holds the H100 SXM's and the host's row, and ``roofline`` judges
against the card by default.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = ["Timer", "benchmark", "trace", "Roofline", "roofline",
           "fir_workload", "fft_workload", "CHIP_PEAKS", "emit_metric"]


@dataclass
class Timer:
    """Accumulating wall-clock timer."""

    name: str = "timer"
    total: float = 0.0
    count: int = 0
    _t0: float = field(default=0.0, repr=False)

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.total += time.perf_counter() - self._t0
        self.count += 1

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)


def _block(out):
    """Wait for the CUDA devices that computed ``out`` (a tensor or a
    nested tuple, list or dict of them); host values need no wait."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _block(v)
    elif isinstance(out, (tuple, list)):
        for v in out:
            _block(v)
    return out


def benchmark(fn, *args, warmup: int = 2, iters: int = 10,
              samples: int | None = None):
    """Time a function on the host's clock, waiting for the device that
    computed its output; returns a dict with seconds a call and, given
    ``samples`` (stream samples a call), samples/s."""
    for _ in range(warmup):
        _block(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _block(out)
    dt = (time.perf_counter() - t0) / iters
    res = {"seconds_per_call": dt}
    if samples is not None:
        res["samples_per_second"] = samples / dt
        res["msamples_per_second"] = samples / dt / 1e6
    return res


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace (the host's ops, and the card's
    kernels when CUDA is available) around a block of work, written as a
    Chrome trace ``trace-<pid>-<ns>.json`` into ``logdir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


def emit_metric(metric: str, value: float, unit: str, vs_baseline: float):
    """Print the single-line JSON metric format of the bench driver."""
    print(
        json.dumps(
            {
                "metric": metric,
                "value": value,
                "unit": unit,
                "vs_baseline": vs_baseline,
            }
        )
    )


# --------------------------------------------------------------------------
# roofline analysis
# --------------------------------------------------------------------------

# Peaks per device (f32 unless noted).  "h100-sxm": NVIDIA H100 80GB HBM3
# (SXM5) at its 700 W power limit, from its data sheet: 67 TFLOP/s FP32 on
# the CUDA cores, 3.35 TB/s HBM3; a card set below 700 W runs slower under
# load.  "cpu": a rough host-class row.
CHIP_PEAKS = {
    "h100-sxm": {"gflops_f32": 67_000.0, "gbps_hbm": 3_350.0},
    "cpu": {"gflops_f32": 100.0, "gbps_hbm": 50.0},
}
DEFAULT_CHIP = "h100-sxm"


@dataclass
class Roofline:
    """Achieved-vs-peak classification for one measured workload."""

    name: str
    achieved_gflops: float
    achieved_gbps: float
    frac_compute: float
    frac_memory: float
    bound: str  # "compute" | "memory"
    arithmetic_intensity: float  # flops per byte

    def __repr__(self) -> str:
        return (
            f"Roofline[{self.name}] {self.bound}-bound: "
            f"{self.achieved_gflops:.1f} GFLOP/s "
            f"({100 * self.frac_compute:.0f}% of peak), "
            f"{self.achieved_gbps:.1f} GB/s "
            f"({100 * self.frac_memory:.0f}% of HBM), "
            f"AI={self.arithmetic_intensity:.2f} flop/B"
        )


def roofline(name: str, seconds: float, flops: float, bytes_moved: float,
             chip: str = DEFAULT_CHIP) -> Roofline:
    """Classify a measured run against the device's roofline (an unknown
    ``chip`` reads the H100's row).

    flops / bytes_moved are the workload totals; ``bound`` is whichever
    resource the run used the larger fraction of: at speed-of-light the
    bound fraction approaches 1.0.
    """
    peaks = CHIP_PEAKS.get(chip, CHIP_PEAKS[DEFAULT_CHIP])
    gflops = flops / seconds / 1e9
    gbps = bytes_moved / seconds / 1e9
    fc = gflops / peaks["gflops_f32"]
    fm = gbps / peaks["gbps_hbm"]
    return Roofline(
        name=name,
        achieved_gflops=gflops,
        achieved_gbps=gbps,
        frac_compute=fc,
        frac_memory=fm,
        bound="compute" if fc >= fm else "memory",
        arithmetic_intensity=flops / max(bytes_moved, 1.0),
    )


def fir_workload(n_samples: int, ntaps: int, complex_data: bool = True):
    """(flops, bytes) for a block FIR: 8 flops a complex MAC, in + out."""
    mac = 8.0 if complex_data else 2.0
    sample_bytes = 8.0 if complex_data else 4.0
    return (mac * n_samples * ntaps, 2.0 * sample_bytes * n_samples)


def fft_workload(batch: int, nfft: int, complex_data: bool = True):
    """(flops, bytes) for batched FFTs: the 5 N log2 N convention."""
    flops = 5.0 * batch * nfft * np.log2(max(nfft, 2))
    return (flops, 2.0 * 8.0 * batch * nfft)
