"""ARFF stream IO of the port (``repro_torch.data.io``) against the JAX
package's (``repro.data.io``): each package reads the files the other
writes with exactly equal arrays, ``save_arff`` writes the same bytes from
the same stream, and the reference's two ARFF tests run on the port, with
the dynamic loader's quirks (the first two REAL columns are SEQUENCE_ID,
TIME_ID; FINITE attributes stay in the list while their values are
dropped).  Everything is exact: the files hold ``repr(float(x))``."""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data import io as jio  # noqa: E402
from repro.data import stream as jstream  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.data import io as tio  # noqa: E402
from repro_torch.data import stream as tstream  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402


def _mixed_arrays(n=64, seed=0):
    """Attributes (name, kind, card) with REAL and FINITE columns
    interleaved, and their arrays."""
    g = np.random.default_rng(seed)
    spec = [("A", "REAL", 0), ("B", "FINITE", 3), ("C", "REAL", 0),
            ("D", "REAL", 0), ("E", "FINITE", 5)]
    xc = (g.standard_normal((n, 3)) * 10.0 ** g.integers(-8, 8, (n, 3))
          ).astype(np.float32)
    xd = np.stack([g.integers(0, 3, n), g.integers(0, 5, n)], 1
                  ).astype(np.int32)
    return spec, xc, xd


def _stream(mod, spec, xc, xd):
    kinds = {"REAL": mod.REAL, "FINITE": mod.FINITE}
    attrs = [mod.Attribute(name, kinds[k], card) for name, k, card in spec]
    return mod.DataStream.from_arrays(attrs, xc, xd)


def _same(a, b):
    """Two loaded streams: attribute lists and arrays exactly equal."""
    assert [(x.name, x.kind, x.card) for x in a.attributes] == \
        [(x.name, x.kind, x.card) for x in b.attributes]
    ba, bb = a.collect(), b.collect()
    np.testing.assert_array_equal(np.asarray(ba.xc), np.asarray(bb.xc))
    np.testing.assert_array_equal(np.asarray(ba.xd), np.asarray(bb.xd))


def test_save_arff_writes_the_reference_bytes(tmp_path):
    spec, xc, xd = _mixed_arrays()
    jp, tp = tmp_path / "j.arff", tmp_path / "t.arff"
    jio.save_arff(str(jp), _stream(jstream, spec, xc, xd), relation="mixed")
    tio.save_arff(str(tp), _stream(tstream, spec, xc, xd), relation="mixed")
    assert tp.read_bytes() == jp.read_bytes()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_package_reads_the_others_files(tmp_path, writer):
    spec, xc, xd = _mixed_arrays(seed=1)
    path = str(tmp_path / "x.arff")
    if writer == "jax":
        jio.save_arff(path, _stream(jstream, spec, xc, xd))
    else:
        tio.save_arff(path, _stream(tstream, spec, xc, xd))
    got, ref = tio.load_arff(path), jio.load_arff(path)
    _same(got, ref)
    b = got.collect()
    np.testing.assert_array_equal(b.xc, xc)
    np.testing.assert_array_equal(b.xd, xd)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_arff_roundtrip(tmp_path, pkg):
    """``test_io_trainer_pgm.py::test_arff_roundtrip`` on the port, from
    each package's naive-Bayes stream (the port's draws its categories
    another way)."""
    syn = jsyn if pkg == "jax" else tsyn
    stream, _ = syn.nb_stream(50, 3, 2, 2, seed=0)
    path = str(tmp_path / "d.arff")
    tio.save_arff(path, stream)
    loaded = tio.load_arff(path)
    a, b = stream.collect(), loaded.collect()
    np.testing.assert_allclose(np.asarray(a.xc), b.xc, rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(a.xd), b.xd)
    assert [x.name for x in loaded.attributes] == \
        [x.name for x in stream.attributes]
    _same(loaded, jio.load_arff(path))


def test_regression_stream_through_arff(tmp_path):
    """The regression stream of both packages (the same draws) through the
    other package's writer: the same bytes."""
    js, jw = jsyn.regression_stream(40, 3, seed=2)
    ts, tw = tsyn.regression_stream(40, 3, seed=2)
    jp, tp = tmp_path / "j.arff", tmp_path / "t.arff"
    jio.save_arff(str(jp), js)
    tio.save_arff(str(tp), ts)
    assert tp.read_bytes() == jp.read_bytes()


def _write_dynamic(path, lead=""):
    """The reference test's hand-built dynamic file (paper Code Fragment 4
    layout); ``lead`` puts a FINITE column before SEQUENCE_ID."""
    with open(path, "w") as f:
        f.write("@relation dyn\n")
        if lead:
            f.write("@attribute K {0,1,2}\n")
        f.write("@attribute SEQUENCE_ID REAL\n@attribute TIME_ID REAL\n")
        f.write("@attribute G0 REAL\n@attribute F1 {0,1}\n@data\n")
        for s in range(2):
            for t in range(3):
                if (s, t) == (1, 1):
                    continue            # a hole: masked out
                row = f"{s},{t},{s * 10 + t},{(s + t) % 2}"
                f.write((f"{t % 3}," if lead else "") + row + "\n")


@pytest.mark.parametrize("lead", ["", "finite first"])
def test_dynamic_arff(tmp_path, lead):
    """``test_io_trainer_pgm.py::test_dynamic_arff`` with a hole, a FINITE
    column after the values and (second case) one before SEQUENCE_ID: the
    first two REAL columns are read as SEQUENCE_ID, TIME_ID, the FINITE
    attributes stay in the list and their values are dropped."""
    path = str(tmp_path / "dyn.arff")
    _write_dynamic(path, lead)
    ds, ref = tio.load_dynamic_arff(path), jio.load_dynamic_arff(path)
    batch = ds.collect()
    assert batch.xc.shape == (2, 3, 1)
    assert float(batch.xc[1, 2, 0]) == 12.0
    assert float(batch.mask.sum()) == 5.0 and batch.mask[1, 1] == 0.0
    assert batch.xd.shape == (2, 3, 0)
    names = [a.name for a in ds.attributes]
    assert names == (["K"] if lead else []) + ["G0", "F1"]
    assert names == [a.name for a in ref.attributes]
    rb = ref.collect()
    np.testing.assert_array_equal(batch.xc, np.asarray(rb.xc))
    np.testing.assert_array_equal(batch.mask, np.asarray(rb.mask))


def test_dynamic_arff_needs_sequence_columns(tmp_path):
    path = str(tmp_path / "flat.arff")
    with open(path, "w") as f:
        f.write("@relation flat\n@attribute TIME_ID REAL\n"
                "@attribute SEQUENCE_ID REAL\n@data\n0,0\n")
    for mod in (tio, jio):
        with pytest.raises(ValueError, match="SEQUENCE_ID"):
            mod.load_dynamic_arff(path)


def test_unsupported_attribute_type_raises(tmp_path):
    path = str(tmp_path / "bad.arff")
    with open(path, "w") as f:
        f.write("@relation bad\n@attribute S STRING\n@data\nx\n")
    for mod in (tio, jio):
        with pytest.raises(ValueError, match="unsupported"):
            mod.load_arff(path)
