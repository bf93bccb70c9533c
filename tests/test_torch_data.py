"""The port's generators and workload configs against the reference: the
generators that draw the same numpy stream must give the same arrays
(exactly); ``nb_stream`` draws its categories by inverse CDF, so only its
shapes, ranges and the class dependence are checked."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs import amidst_pgm as jcfg  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.configs import amidst_pgm as tcfg  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402


def _arrays(stream):
    b = stream.collect()
    return np.asarray(b.xc), np.asarray(b.xd)


@pytest.mark.parametrize("name,args", [
    ("gmm_stream", (500, 3, 4)),
    ("drift_stream", (200, 3)),
    ("fa_stream", (300, 6, 2)),
])
def test_generators_match_reference(name, args):
    jout = getattr(jsyn, name)(*args, seed=3)
    tout = getattr(tsyn, name)(*args, seed=3)
    for a, b in zip(_arrays(jout[0]), _arrays(tout[0])):
        np.testing.assert_array_equal(a, b)
    assert [str(a) for a in jout[0].attributes] == [
        str(a) for a in tout[0].attributes]
    for x, y in zip(jout[1:], tout[1:]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_nb_stream_shapes_and_class_dependence():
    stream, y = tsyn.nb_stream(4000, 3, 4, 2, card=4, seed=0)
    xc, xd = _arrays(stream)
    assert xc.shape == (4000, 4) and xd.shape == (4000, 3)
    assert xd[:, :2].min() >= 0 and xd[:, :2].max() <= 3
    np.testing.assert_array_equal(xd[:, 2], y)
    ref, _ = jsyn.nb_stream(10, 3, 4, 2, card=4, seed=0)
    assert [str(a) for a in stream.attributes] == [
        str(a) for a in ref.attributes]
    # the category frequencies depend on the class (Dirichlet(0.5) tables)
    freq = [np.bincount(xd[y == c, 0], minlength=4) / (y == c).sum()
            for c in range(3)]
    assert max(np.abs(freq[0] - freq[1]).max(),
               np.abs(freq[1] - freq[2]).max()) > 0.05


def test_workload_configs_match_reference():
    assert set(tcfg.PGM_WORKLOADS) == set(jcfg.PGM_WORKLOADS)
    for name, w in tcfg.PGM_WORKLOADS.items():
        r = jcfg.PGM_WORKLOADS[name]
        assert dataclasses.astuple(w.spec) == dataclasses.astuple(r.spec)
        assert w.nodes_per_instance() == r.nodes_per_instance()
        assert w.description == r.description
