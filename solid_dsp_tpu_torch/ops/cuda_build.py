"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source in ``csrc/`` is CUDA C++ for ``sm_90a`` with a plain C
interface (``extern "C"`` launchers that take device pointers, sizes and a
stream, and return the launch's ``cudaError_t``); none includes a PyTorch
header.  :func:`build` compiles every source at once, one ``nvcc`` process
each, into a shared library under ``solid_dsp_tpu_torch/_build/`` named by
a hash of its source, the shared headers (``csrc/*.cuh``) and the flags,
so that a built library is reused and a changed source is rebuilt.  The
wrappers (``ops/cuda_ddc.py``, ``ops/cuda_chan.py``, ``ops/cuda_iir.py``,
``ops/cuda_fft.py``, ``ops/cuda_resample.py``, ``ops/cuda_halo.py``,
``ops/cuda_scan.py``, ``ops/cuda_track.py``, ``ops/cuda_bcjr.py``,
``ops/cuda_viterbi.py``, ``ops/cuda_cvsd.py``, ``ops/cuda_timing.py``) pass
``tensor.data_ptr()`` and the current stream and raise on a non-zero
return.

Needs ``nvcc`` (``$CUDA_HOME/bin`` or on the ``PATH``); nothing is built
when a module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["SOURCES", "BUILD_DIR", "ENGINES", "build", "build_logs",
           "launcher", "stream_of", "check_launch", "use_kernel"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("ddc_fm.cu", "ddc_body.cu", "channelizer.cu", "iir_bank.cu",
           "windowed_fft.cu", "farrow.cu", "halo_frontend.cu", "seq_scan.cu",
           "iir_scan.cu", "track_scan.cu", "bcjr_scan.cu",
           "viterbi_scan.cu", "cvsd_scan.cu", "gardner_scan.cu")
ENGINES = ("auto", "cuda", "torch")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in ((Path(CUDA_HOME) / "bin" / "nvcc") if CUDA_HOME else None,
                 shutil.which("nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found: the port's kernels build on a "
                       "machine with the CUDA toolkit")


def _target(source: str) -> Path:
    src = CSRC / source
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


@functools.cache
def build() -> dict:
    """Compile every source not built yet (all ``nvcc`` processes started
    together), then load each library: {source name: ctypes.CDLL}.  Raises
    with the compiler's output if a source does not build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for source in SOURCES:
        out = _target(source)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = out.with_suffix(".log").open("w")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                 str(CSRC / source)],
                                stdout=log, stderr=subprocess.STDOUT)
        jobs.append((source, proc, tmp, out, log))
    failed = []
    for source, proc, tmp, out, log in jobs:
        proc.wait()
        log.close()
        if proc.returncode != 0:
            failed.append(f"{source}:\n{out.with_suffix('.log').read_text()}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed on " + "\n".join(failed))
    return {source: ctypes.CDLL(str(_target(source))) for source in SOURCES}


def build_logs() -> dict:
    """{source name: the compiler's output of its last build (ptxas
    registers, shared memory and spills per kernel)}."""
    return {s: (_target(s).with_suffix(".log").read_text()
                if _target(s).with_suffix(".log").exists() else "")
            for s in SOURCES}


@functools.cache
def launcher(source: str, name: str, argtypes: tuple):
    """The C launcher ``name`` of ``source``'s library, typed: ``argtypes``
    holds ``ctypes.c_void_p`` for each pointer and the stream (a plain int
    would be cut to 32 bits)."""
    fn = getattr(build()[source], name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as an int for ctypes."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(err: int, name: str):
    """Raise if a launcher returned a CUDA error: a refused launch never
    runs, and a later synchronize would not report it."""
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")


def use_kernel(engine: str, t: torch.Tensor) -> bool:
    """Whether a wrapper launches its kernel: ``"auto"`` for a CUDA tensor,
    ``"cuda"`` always (a CPU tensor then raises), ``"torch"`` never (the
    plain version, on any device)."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    return engine == "cuda" or (engine == "auto" and t.is_cuda)
