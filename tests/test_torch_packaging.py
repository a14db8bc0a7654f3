"""The port's packaging ships what it builds from (fault P5, repaired).

``pyproject.toml``'s package data for ``solid_dsp_tpu_torch`` must match
every CUDA source ``ops/cuda_build.py`` compiles, every header those sources
``#include "..."``, and the runtime's ``native_src/solid_runtime.cc``; and
``solid_dsp_tpu_torch.runtime`` must be a package of the wheel.  Structural
checks, exact: no build is run.
"""

import fnmatch
import os
import re
import tomllib

from solid_dsp_tpu_torch.ops import cuda_build
from solid_dsp_tpu_torch.runtime import build as runtime_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "solid_dsp_tpu_torch")


def _pyproject():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)


def _shipped(relpath: str) -> bool:
    globs = _pyproject()["tool"]["setuptools"]["package-data"][
        "solid_dsp_tpu_torch"]
    return any(fnmatch.fnmatch(relpath, g) for g in globs)


def _includes(path: str) -> set:
    with open(path) as f:
        return set(re.findall(r'^\s*#include\s+"([^"]+)"', f.read(), re.M))


def test_package_data_ships_every_cuda_source_and_header():
    needed = set()
    for source in cuda_build.SOURCES:
        needed.add(f"csrc/{source}")
        needed |= {f"csrc/{h}" for h in
                   _includes(os.path.join(PKG, "csrc", source))}
    # headers that include headers
    for rel in sorted(needed):
        needed |= {f"csrc/{h}" for h in _includes(os.path.join(PKG, rel))}
    assert {"csrc/hopper.cuh", "csrc/ddc_tc.cuh", "csrc/ddc_direct.cuh",
            "csrc/bcjr_scan.cu", "csrc/viterbi_scan.cu", "csrc/cvsd_scan.cu",
            "csrc/gardner_scan.cu"} <= needed
    missing = sorted(r for r in needed if not _shipped(r))
    assert not missing, f"package data misses {missing}"
    for rel in needed:
        assert os.path.exists(os.path.join(PKG, rel)), rel


def test_package_data_ships_the_runtime_source():
    rel = "native_src/solid_runtime.cc"
    assert _shipped(rel)
    shipped = os.path.join(PKG, rel)
    assert os.path.realpath(shipped) == os.path.realpath(
        os.path.join(REPO, "native", "solid_runtime.cc"))
    assert runtime_build.SOURCE_CANDIDATES[1] == runtime_build.Path(shipped)


def test_runtime_is_a_package_and_the_cli_a_script():
    project = _pyproject()
    packages = project["tool"]["setuptools"]["packages"]
    for name in ("solid_dsp_tpu_torch.runtime",
                 "solid_dsp_tpu_torch.streaming",
                 "solid_dsp_tpu_torch.utils"):
        assert name in packages
    assert (project["project"]["scripts"]["solid-dsp-tpu-torch"]
            == "solid_dsp_tpu_torch.__main__:main")
    # every subpackage of the port on disk is listed
    on_disk = {f"solid_dsp_tpu_torch.{d}" for d in os.listdir(PKG)
               if os.path.exists(os.path.join(PKG, d, "__init__.py"))}
    assert on_disk <= set(packages)
