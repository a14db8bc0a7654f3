"""Build the native runtime's shared library with g++ at first use.

The port compiles the JAX package's C++ runtime, ``native/solid_runtime.cc``,
unchanged: a plain C interface, loaded with ctypes.  The source is found in
the repository layout (``native/`` beside the package) or, in an installed
copy, as the package data ``native_src/solid_runtime.cc`` (a symlink in the
repository that a wheel ships as a file).  The library goes to
``solid_dsp_tpu_torch/_build/``, or to ``$XDG_CACHE_HOME/solid_dsp_tpu_torch``
(``~/.cache`` by default) where the package directory is read-only, named by
a hash of the source and the flags, so a changed source is rebuilt and a
built one reused.  Nothing is written beside the source: the JAX package
keeps its own library in ``native/``.  Nothing is built when a module is
imported.
"""

from __future__ import annotations

import functools
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

__all__ = ["SOURCE_CANDIDATES", "BUILD_DIR", "CXXFLAGS", "source",
           "ensure_built"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE_CANDIDATES = (_PKG.parent / "native" / "solid_runtime.cc",
                     _PKG / "native_src" / "solid_runtime.cc")
BUILD_DIR = _PKG / "_build"
CXXFLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_LOCK = threading.Lock()


def source() -> Path:
    """The runtime's C++ source: the first candidate that exists."""
    for cand in SOURCE_CANDIDATES:
        if cand.exists():
            return cand
    raise FileNotFoundError("solid_runtime.cc not found in "
                            + ", ".join(map(str, SOURCE_CANDIDATES)))


def _out_dir() -> Path:
    """``_build/`` in the package where it can be written, else the user
    cache directory."""
    probe = BUILD_DIR if BUILD_DIR.exists() else BUILD_DIR.parent
    if os.access(probe, os.W_OK):
        return BUILD_DIR
    cache = os.environ.get("XDG_CACHE_HOME",
                           os.path.join(os.path.expanduser("~"), ".cache"))
    return Path(cache) / "solid_dsp_tpu_torch"


def _arch_flags() -> list:
    """The portable x86-64-v2 baseline on x86 hosts, nothing elsewhere;
    ``SOLID_DSP_CXXFLAGS_ARCH`` replaces it, as in the JAX package's
    build."""
    env = os.environ.get("SOLID_DSP_CXXFLAGS_ARCH")
    if env is not None:
        return env.split()
    return (["-march=x86-64-v2"]
            if platform.machine() in ("x86_64", "AMD64") else [])


def _target(out_dir: Path, src: bytes, flags: list) -> Path:
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    return out_dir / f"libsolid_runtime-{digest}.so"


@functools.cache
def ensure_built() -> str:
    """Compile the runtime if no library of this source and these flags
    exists; return its path.  The arch baseline is dropped where g++
    refuses it (GCC < 11 does not know x86-64-v2).  Raises with g++'s
    output where neither build succeeds."""
    src = source()
    data = src.read_bytes()
    arch = _arch_flags()
    variants = [[*arch, *CXXFLAGS], list(CXXFLAGS)] if arch else [
        list(CXXFLAGS)]
    out_dir = _out_dir()
    with _LOCK:
        for flags in variants:
            out = _target(out_dir, data, flags)
            if out.exists():
                return str(out)
        out_dir.mkdir(parents=True, exist_ok=True)
        errors = []
        for flags in variants:
            out = _target(out_dir, data, flags)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            r = subprocess.run(["g++", *flags, str(src), "-o", str(tmp)],
                               capture_output=True, text=True)
            if r.returncode == 0:
                os.replace(tmp, out)
                return str(out)
            errors.append(f"g++ {' '.join(flags)}:\n{r.stderr}")
    raise RuntimeError("building the native runtime failed:\n"
                       + "\n".join(errors))
