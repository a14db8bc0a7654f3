"""SigMF recordings move both ways between the JAX package and the port.

A pair written by one package is read by the other: the samples equal
exactly (the same native conversion of the same bytes), the metadata equal
but for ``core:recorder`` (each package names itself), and the sha512 check
passes on both sides.  The port's own SigMF tests mirror
tests/test_sigmf.py (extension handling, annotations, corruption, refused
datatypes).
"""

import json

import numpy as np
import pytest

import solid_dsp_tpu.runtime as jrt
import solid_dsp_tpu_torch.runtime as prt


def _iq(n, seed=0):
    rng = np.random.default_rng(seed)
    return (0.45 * (rng.uniform(-1, 1, n) + 1j * rng.uniform(-1, 1, n))
            ).astype(np.complex64)


def _meta_without_recorder(meta):
    g = {k: v for k, v in meta["global"].items() if k != "core:recorder"}
    return {**meta, "global": g}


@pytest.mark.parametrize("fmt", ["cf32", "cf64", "ci16", "ci8"])
@pytest.mark.parametrize("writer,reader", [(jrt, prt), (prt, jrt)],
                         ids=["jax_to_port", "port_to_jax"])
def test_pair_crosses_packages(tmp_path, fmt, writer, reader):
    x = _iq(4096, seed=len(fmt))
    base = str(tmp_path / "rec")
    kw = dict(sample_rate=2.4e6, fmt=fmt, center_freq=100.1e6,
              description="cross-package capture",
              datetime_iso="2026-01-01T00:00:00Z",
              annotations=[{"sample_start": 10, "sample_count": 20,
                            "label": "burst"}])
    dp, mp = writer.write_sigmf(base, x, **kw)
    y, meta = reader.read_sigmf(base, check_hash=True)
    y_same, meta_same = writer.read_sigmf(base, check_hash=True)
    np.testing.assert_array_equal(y, y_same)
    assert y.dtype == np.complex64 and y.shape == x.shape
    assert meta == meta_same
    # the same recording written by the other package: the same bytes and
    # the same metadata but the recorder's name
    dp2, mp2 = reader.write_sigmf(str(tmp_path / "again"), x, **kw)
    assert open(dp, "rb").read() == open(dp2, "rb").read()
    assert (_meta_without_recorder(meta)
            == _meta_without_recorder(json.load(open(mp2))))
    assert meta["global"]["core:recorder"] == writer.write_sigmf.__module__ \
        .split(".")[0]


def test_paths_and_annotations(tmp_path):
    x = _iq(128)
    base = str(tmp_path / "rec3.sigmf-data")          # extension tolerated
    prt.write_sigmf(base, x, sample_rate=48e3,
                    annotations=[{"sample_start": 10, "sample_count": 20,
                                  "label": "burst"}, {"my:custom": 7}])
    assert prt.sigmf_paths(base) == jrt.sigmf_paths(base)
    _, meta = prt.read_sigmf(str(tmp_path / "rec3.sigmf-meta"))
    a0 = meta["annotations"][0]
    assert (a0["core:sample_start"], a0["core:sample_count"],
            a0["core:label"]) == (10, 20, "burst")
    assert meta["annotations"][1] == {"my:custom": 7,
                                      "core:sample_start": 0}


def test_hash_detects_corruption(tmp_path):
    base = str(tmp_path / "rec4")
    dp, _ = prt.write_sigmf(base, _iq(256), sample_rate=1e6)
    raw = bytearray(open(dp, "rb").read())
    raw[8] ^= 0xFF
    open(dp, "wb").write(bytes(raw))
    for mod in (prt, jrt):
        with pytest.raises(ValueError, match="sha512 mismatch"):
            mod.read_sigmf(base, check_hash=True)
    assert len(prt.read_sigmf(base)[0]) == 256


def test_refused_datatypes(tmp_path):
    base = str(tmp_path / "rec5")
    _, mp = prt.write_sigmf(base, _iq(64), sample_rate=1e6)
    meta = json.load(open(mp))
    meta["global"]["core:datatype"] = "rf32_be"
    json.dump(meta, open(mp, "w"))
    with pytest.raises(ValueError, match="core:datatype"):
        prt.read_sigmf(base)
    with pytest.raises(ValueError, match="unsupported SigMF format"):
        prt.write_sigmf(str(tmp_path / "x"), _iq(8), 1e6, fmt="ci4")
