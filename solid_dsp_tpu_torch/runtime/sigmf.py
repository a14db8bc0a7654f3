"""SigMF recording interop (v1.0.0), the SDR ecosystem's standard format.

Port of ``solid_dsp_tpu/runtime/sigmf.py`` on the port's native
:func:`read_iq` / :func:`write_iq`.  SigMF wraps a raw interleaved IQ file
with a JSON metadata sidecar, so recordings move between this package, the
JAX package, GNU Radio, sigmf-python and IQEngine:

* ``<name>.sigmf-data``: the interleaved IQ payload (the native IO);
* ``<name>.sigmf-meta``: JSON with ``global`` (datatype, sample rate, ...),
  ``captures`` (stream segments: start index, center frequency, time) and
  ``annotations`` (labelled sample ranges).

Only the complex little-endian datatypes of ``SIGMF_DATATYPES`` are read and
written; SigMF's real and big-endian datatypes raise a ``ValueError``.
"""

from __future__ import annotations

import hashlib
import json
import os
from datetime import datetime, timezone

import numpy as np

from . import read_iq, write_iq

__all__ = ["write_sigmf", "read_sigmf", "sigmf_paths", "SIGMF_DATATYPES"]

SIGMF_VERSION = "1.0.0"

# framework IQ format <-> SigMF core:datatype (little-endian, interleaved)
SIGMF_DATATYPES = {
    "cf32": "cf32_le",
    "cf64": "cf64_le",
    "ci16": "ci16_le",
    "ci8": "ci8",
}
_FMT_BY_DATATYPE = {v: k for k, v in SIGMF_DATATYPES.items()}


def sigmf_paths(base: str) -> tuple:
    """(data_path, meta_path) for a recording basename.

    ``base`` may be bare or carry either SigMF extension already.
    """
    for ext in (".sigmf-data", ".sigmf-meta"):
        if base.endswith(ext):
            base = base[: -len(ext)]
            break
    return base + ".sigmf-data", base + ".sigmf-meta"


def write_sigmf(base: str, samples, sample_rate: float, fmt: str = "cf32",
                center_freq: float | None = None, description: str = "",
                datetime_iso: str | None = None, annotations=None,
                extra_global=None, with_hash: bool = True) -> tuple:
    """Write a SigMF recording pair; returns (data_path, meta_path).

    ``annotations`` is a list of dicts merged into the SigMF annotations
    array; entries may use either bare keys (``sample_start``, ``label``)
    or full ``core:``-prefixed names.
    """
    if fmt not in SIGMF_DATATYPES:
        raise ValueError(f"unsupported SigMF format {fmt!r}; "
                         f"one of {sorted(SIGMF_DATATYPES)}")
    data_path, meta_path = sigmf_paths(base)
    n = write_iq(data_path, samples, fmt=fmt)

    glob = {
        "core:datatype": SIGMF_DATATYPES[fmt],
        "core:sample_rate": float(sample_rate),
        "core:version": SIGMF_VERSION,
        "core:recorder": "solid_dsp_tpu_torch",
    }
    if description:
        glob["core:description"] = str(description)
    if with_hash:
        glob["core:sha512"] = _sha512_file(data_path)
    if extra_global:
        glob.update(extra_global)

    capture = {"core:sample_start": 0}
    if center_freq is not None:
        capture["core:frequency"] = float(center_freq)
    capture["core:datetime"] = datetime_iso or (
        datetime.now(timezone.utc).isoformat().replace("+00:00", "Z"))

    anns = []
    for a in (annotations or []):
        entry = {}
        for k, v in a.items():
            key = k if ":" in k else f"core:{k}"
            entry[key] = v
        entry.setdefault("core:sample_start", 0)
        anns.append(entry)

    meta = {"global": glob, "captures": [capture], "annotations": anns}
    tmp = meta_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
    os.replace(tmp, meta_path)
    if n != np.asarray(samples).size:
        raise OSError(f"wrote {n} of {np.asarray(samples).size} samples "
                      f"to {data_path}")
    return data_path, meta_path


def read_sigmf(base: str, check_hash: bool = False) -> tuple:
    """Read a SigMF recording -> (samples complex64, meta dict).

    ``check_hash=True`` verifies ``core:sha512`` when present and raises
    ``ValueError`` on mismatch (corrupt or substituted data file).
    """
    data_path, meta_path = sigmf_paths(base)
    with open(meta_path) as f:
        meta = json.load(f)
    datatype = meta.get("global", {}).get("core:datatype", "")
    fmt = _FMT_BY_DATATYPE.get(datatype)
    if fmt is None:
        raise ValueError(
            f"unsupported SigMF core:datatype {datatype!r}; this framework "
            f"reads {sorted(_FMT_BY_DATATYPE)} (complex little-endian)")
    if check_hash and "core:sha512" in meta["global"]:
        got = _sha512_file(data_path)
        want = meta["global"]["core:sha512"]
        if got != want:
            raise ValueError(f"SigMF sha512 mismatch for {data_path}: "
                             f"recording corrupt or modified")
    return read_iq(data_path, fmt=fmt), meta


def _sha512_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha512()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()
