"""``repro_torch.core.dvmp`` and the port's ``mesh=`` paths against the
reference on the CPU, over gloo.

Two worlds:
- one rank in this process (a ``FileStore`` under a tmp dir): d-VMP there
  must give ``vmp_fit``'s bits, and every ``mesh=`` entry point the
  mesh-free path's bits;
- two ranks launched once for the module (``_torch_dist.launch``, one
  deadline for the lot): each rank computes on its block of rows, and
  both must hold the same bits and stop on the same sweep.

The reference's results are computed here: ``repro.core.vmp.vmp_fit`` and
``repro.core.dvmp.dvmp_fit`` on a one-device mesh, from the reference's
initial posterior carried into the port.

Tolerances: a two-rank fit sums its stats in another order, so its
posterior lies within rtol 1e-4 / atol 1e-3 of the reference's fit and its
ELBO within 1.0 (``tests/test_distributed.py``'s bars); the streaming
columns within ``test_torch_streaming.py``'s (ELBO rtol 1e-4, posterior
1e-3, drift flags exact); served rows within 1e-5 of ``posterior_z``
(``tests/test_serve.py``'s bar); sampled tables within
5 sqrt(p (1 - p) / ESS) + 1e-3 of exact inference.
"""

import datetime
import itertools
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402

import _torch_dist  # noqa: E402
from _torch_parity import (T, assert_params_close, plates,  # noqa: E402
                           trees_equal)
from repro.core import dvmp as jdvmp  # noqa: E402
from repro.core import streaming as jst  # noqa: E402
from repro.core import vmp as jvmp  # noqa: E402
from repro.core.compat import make_mesh  # noqa: E402
from repro.data import stream as jstream  # noqa: E402
from repro.data.synthetic import drift_stream, gmm_stream  # noqa: E402
from repro_torch.core import dvmp, streaming, vmp  # noqa: E402
from repro_torch.core import importance_sampling as tis  # noqa: E402
from repro_torch.core import map_inference as tmap  # noqa: E402
from repro_torch.core.dag import PlateSpec  # noqa: E402
from repro_torch.data import stream as tstream  # noqa: E402
from repro_torch.data.synthetic import random_discrete_bn  # noqa: E402
from repro_torch.infer_exact import JunctionTreeEngine  # noqa: E402
from repro_torch.launch import dryrun_pgm  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.pgm_models import GaussianMixture  # noqa: E402
from repro_torch.serve.engine import (PGMQueryEngine,  # noqa: E402
                                      vmp_bucket_rows)

WORLD = 2
LAUNCH_TIMEOUT_S = 120   # both ranks, start to finish
STREAM_KW = dict(sweeps=6, tol=0.0, drift_threshold=3.0)


# -- inputs, made here from numpy seeds ---------------------------------------


def _gmm_data():
    """803 instances of a two-component GMM, padded by ``sharded_batches``
    to 804 rows (the last one masked)."""
    g = np.random.default_rng(0)
    z = g.random(803) < 0.4
    mus = np.array([[3.0, -2.0], [-3.0, 2.0]], np.float32)
    x = (mus[z.astype(int)]
         + 0.7 * g.standard_normal((803, 2))).astype(np.float32)
    attrs = [tstream.Attribute(f"X{i}", tstream.REAL) for i in range(2)]
    (b,) = tstream.DataStream.from_arrays(attrs, x).sharded_batches(803,
                                                                     WORLD)
    return b.xc, b.xd, b.mask


def _nb_data():
    """Two classes: three Gaussian leaves and two discrete ones (cards 3
    and 4) whose tables depend on the class."""
    g = np.random.default_rng(1)
    n = 600
    z = (g.random(n) < 0.5).astype(int)
    xc = (np.array([[2.0, 0.0, -1.0], [-2.0, 1.0, 1.0]])[z]
          + g.standard_normal((n, 3))).astype(np.float32)
    p0 = np.array([[0.7, 0.2, 0.1], [0.1, 0.2, 0.7]])
    p1 = np.array([[0.4, 0.3, 0.2, 0.1], [0.1, 0.2, 0.3, 0.4]])
    xd = np.stack([[g.choice(3, p=p0[k]) for k in z],
                   [g.choice(4, p=p1[k]) for k in z]], 1).astype(np.int32)
    return xc, xd, np.ones(n, np.float32)


def _fa_data():
    g = np.random.default_rng(3)
    return (g.standard_normal((128, 3), dtype=np.float32),
            np.zeros((128, 0), np.int32), np.ones(128, np.float32))


PLATES = {
    # name: (spec, data, (max_sweeps, tol))
    "gmm": (dict(n_features=2, latent_card=2), _gmm_data, (50, 1e-6)),
    "nb": (dict(n_features=5, latent_card=2,
                discrete_features=((3, 3), (4, 4))), _nb_data, (30, 1e-6)),
    "fa": (dict(n_features=3, latent_card=2, latent_dim=2), _fa_data,
           (10, 0.0)),
}


@pytest.fixture(scope="module")
def inputs():
    """Everything both worlds and the reference read: per plate the
    reference's compiled plate, prior and initial posterior, the port's
    copies, the data; the stream, serving, sampling and MAP cases."""
    out = {"plates": {}, "jax": {}}
    for name, (spec, make, fit) in PLATES.items():
        jcp, jprior, jinit, _, tprior, tinit = plates(0, **spec)
        xc, xd, mask = make()
        out["plates"][name] = dict(spec=spec, prior=tprior, init=tinit,
                                   xc=xc, xd=xd, mask=mask, fit=fit)
        out["jax"][name] = (jcp, jprior, jinit)
    jcp, jprior, jinit, _, tprior, tinit = plates(0, n_features=3,
                                                  latent_card=2)
    stream, _ = drift_stream(750, 3, seed=8)        # shift at batch 3 of 6
    out["stream"] = dict(spec=dict(n_features=3, latent_card=2),
                         prior=tprior, init=tinit, kw=STREAM_KW,
                         xcs=[np.asarray(b.xc) for b in stream.batches(250)])
    out["jax"]["stream"] = (jcp, jprior, jinit)
    s, _, _ = gmm_stream(256, 3, 4, seed=1)
    xs = np.asarray(s.collect().xc)
    out["serve"] = dict(xc=xs, queries=xs[:10])
    out["importance"] = dict(n=20_000, seed=5, evidence={"X2": 1.0})
    out["map"] = dict(net_seed=0, evidence={"D11": 1, "D5": 0},
                      n_starts=64, n_passes=6, seed=3)
    out["dryrun_n"] = 2048
    return out


def _worker_inputs(inp):
    """What the ranks read: no JAX objects."""
    return {k: v for k, v in inp.items() if k != "jax"}


@pytest.fixture(scope="module", autouse=True)
def launched(inputs, tmp_path_factory):
    """The two ranks, started before the module's first test so that they
    run while the one-rank tests and the reference compile."""
    tmp = str(tmp_path_factory.mktemp("dvmp_ranks"))
    procs = _torch_dist.start(WORLD, tmp, _worker_inputs(inputs))
    deadline = time.monotonic() + LAUNCH_TIMEOUT_S
    yield lambda: _torch_dist.collect(procs, tmp, deadline)
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def ranks(launched):
    """Each of the two ranks' ``{case: result}``."""
    return launched()


def _case(ranks, name):
    res = [r[name] for r in ranks]
    for r, x in enumerate(res):
        if isinstance(x, str):
            pytest.fail(f"rank {r}, case {name}:\n{x}")
    return res


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A one-rank gloo world in this process and its ("data",) mesh."""
    store = tmp_path_factory.mktemp("dvmp_world1") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    finally:
        dist.destroy_process_group()


def _port_plate(inp, name):
    """(cp, prior, init) of plate ``name`` or of the stream case."""
    case = inp["stream"] if name == "stream" else inp["plates"][name]
    cp = vmp.compile_plate(PlateSpec(**case["spec"]), device="cpu")
    return cp, case["prior"], case["init"]


def _reference_fits(inputs, name):
    """The reference's ``vmp_fit`` and ``dvmp_fit`` on a one-device mesh."""
    jcp, jprior, jinit = inputs["jax"][name]
    case = inputs["plates"][name]
    xc, xd, mask = (jnp.asarray(case[k]) for k in ("xc", "xd", "mask"))
    sweeps, tol = case["fit"]
    single = jvmp.vmp_fit(jcp, jprior, jinit, xc, xd, sweeps, tol, mask)
    mesh = make_mesh((1,), ("data",))
    dist1 = jdvmp.dvmp_fit(jcp, jprior, jinit, xc, xd, mesh, ("data",),
                           sweeps, tol, mask=mask)
    return single, dist1


def _leaf_bytes(inputs, name):
    """Bytes of the flat stats buffer of plate ``name``."""
    cp, _, init = _port_plate(inputs, name)
    case = inputs["plates"][name]
    st, _ = vmp.local_step(cp, init, *T(case["xc"][:4], case["xd"][:4],
                                        case["mask"][:4]))
    return 4 * sum(leaf.numel() for leaf in streaming.tree_leaves(st))


# -- one rank in this process -------------------------------------------------


@pytest.mark.parametrize("name", list(PLATES))
def test_one_rank_dvmp_fit_is_vmp_fit_bits(inputs, world1, name):
    cp, prior, init = _port_plate(inputs, name)
    case = inputs["plates"][name]
    xc, xd, mask = T(case["xc"], case["xd"], case["mask"])
    sweeps, tol = case["fit"]
    ref = vmp.vmp_fit(cp, prior, init, xc, xd, sweeps, tol, mask)
    dvmp.reset_collectives()
    got = dvmp.dvmp_fit(cp, prior, init, xc, xd, world1, ("data",), sweeps,
                        tol, mask=mask)
    assert trees_equal(ref.post, got.post)
    assert torch.equal(ref.elbo, got.elbo) and ref.sweep == got.sweep
    assert dvmp.COLLECTIVES["all_reduce"] == got.sweep


def test_one_rank_one_sweeps_are_vmp_sweeps(inputs, world1):
    """k dvmp_one_sweep calls == vmp_fit(max_sweeps=k, tol=0), bit for
    bit."""
    cp, prior, init = _port_plate(inputs, "fa")
    xc, xd, mask = T(*(inputs["plates"]["fa"][k] for k in ("xc", "xd",
                                                           "mask")))
    post = init
    for _ in range(3):
        post, e = dvmp.dvmp_one_sweep(cp, prior, post, xc, xd, mask, world1)
    ref = vmp.vmp_fit(cp, prior, init, xc, xd, 3, 0.0, mask)
    assert ref.sweep == 3
    assert trees_equal(ref.post, post) and torch.equal(ref.elbo, e)


def test_one_rank_update_model_is_mesh_free_bits(inputs, world1):
    """Model.update_model(mesh=): a batch gives the mesh-free fit's bits; a
    multi-chunk stream is collected into one batch (no streaming route);
    a supervised model's closed form makes no collective."""
    xc = inputs["serve"]["xc"]
    attrs = [tstream.Attribute(f"X{i}", tstream.REAL)
             for i in range(xc.shape[1])]
    batch = tstream.Batch(xc, np.zeros((len(xc), 0), np.int32),
                          np.ones(len(xc), np.float32))
    fits = []
    for mesh in (None, world1):
        m = GaussianMixture(attrs, n_states=3, device="cpu")
        e = m.update_model(batch, sweeps=15, tol=1e-6, mesh=mesh)
        fits.append((m, e))
    assert trees_equal(fits[0][0].posterior, fits[1][0].posterior)
    assert fits[0][1] == fits[1][1]

    chunks = [(xc[i:i + 64], np.zeros((64, 0), np.int32))
              for i in range(0, len(xc), 64)]
    stream = tstream.DataStream(attrs, lambda: iter(chunks))
    m = GaussianMixture(attrs, n_states=3, device="cpu")
    e = m.update_model(stream, sweeps=15, tol=1e-6, mesh=world1)
    assert m.last_stream_info is None
    assert trees_equal(m.posterior, fits[0][0].posterior)
    assert e == fits[0][1]

    class Labelled(GaussianMixture):
        def supervised_r(self, b):
            return torch.eye(3)[(b.xc[:, 0] > 0).long()
                                + (b.xc[:, 1] > 0).long()]

    sup = []
    for mesh in (None, world1):
        m = Labelled(attrs, n_states=3, device="cpu")
        dvmp.reset_collectives()
        sup.append((m.update_model(batch, mesh=mesh), m.posterior))
        assert dvmp.COLLECTIVES["all_reduce"] == 0
    assert sup[0][0] == sup[1][0] and trees_equal(sup[0][1], sup[1][1])


def test_one_rank_stream_update_matches_reference(inputs, world1,
                                                 reference_stream):
    """stream_update(mesh=) against the reference's one-device-mesh
    stream_update."""
    cp, prior, init = _port_plate(inputs, "stream")
    state = streaming.stream_init(prior, init)
    infos = []
    for xc in inputs["stream"]["xcs"]:
        state, info = streaming.stream_update(
            cp, prior, state, *T(xc, np.zeros((len(xc), 0), np.int32)),
            mesh=world1, **STREAM_KW)
        infos.append(info)
    _check_stream(inputs, reference_stream, state,
                  {k: torch.stack([i[k] for i in infos]) for k in infos[0]})


def test_one_rank_vmp_serving_and_sampling_are_mesh_free_bits(inputs,
                                                              world1):
    """At one shard the mesh engine's rows are posterior_z's bits, the
    sampler's particles are one draw seeded by the shard seed, and MAP is
    the climb from the shard seed's starts."""
    xc = inputs["serve"]["xc"]
    m = GaussianMixture([tstream.Attribute(f"X{i}", tstream.REAL)
                         for i in range(xc.shape[1])], n_states=3,
                        device="cpu")
    m.update_model(xc[:128], sweeps=5)
    eng = PGMQueryEngine(m, mode="vmp", mesh=world1)
    qs = [eng.submit("Z", {f"X{i}": float(xc[b, i]) for i in range(4)})
          for b in range(5)]
    eng.flush()
    expect = m.posterior_z(np.pad(xc[:5], ((0, 3), (0, 0)))).numpy()[:5]
    np.testing.assert_array_equal(np.stack([q.result for q in qs]), expect)

    bn = _torch_dist.chain_bn()
    inf = tis.ImportanceSampling(1000, seed=2, device="cpu")
    inf.set_model(bn)
    inf.set_evidence({"X0": 0.5})
    inf.run_inference(mesh=world1)
    (sd,) = dvmp.shard_seeds(torch.Generator().manual_seed(2), 1)
    part, logw = tis._sample_or_clamp(bn, torch.Generator().manual_seed(sd),
                                      1000, {"X0": 0.5})
    assert torch.equal(inf._logw, logw)
    assert all(torch.equal(inf._particles[k], part[k]) for k in part)

    dbn = random_discrete_bn(8, card=3, seed=5, device="cpu")
    ev = {"D6": 0, "D2": 2}
    got = tmap.map_inference(dbn, ev, n_starts=16, n_passes=4, seed=1,
                             mesh=world1, device="cpu")
    (sd,) = dvmp.shard_seeds(torch.Generator().manual_seed(1), 1)
    tev = dbn.evidence_tensors(ev, torch.device("cpu"))
    dvars = tmap._query_vars(dbn, tev)
    states, best = tmap._hill_climb(dbn, tev, tmap._starts(
        dvars, 16, sd, torch.device("cpu")), 4)
    i = int(best.argmax())
    assert got == ({v.name: int(states[i, j]) for j, v in enumerate(dvars)},
                   float(best[i]))


def test_mesh_must_be_a_device_mesh_with_the_data_axes(inputs, world1):
    """A mesh that is not a DeviceMesh raises TypeError at every entry
    point; data axes the mesh lacks raise ValueError; a mesh off
    mode="vmp" raises ValueError, as the reference does."""
    cp, prior, init = _port_plate(inputs, "gmm")
    case = inputs["plates"]["gmm"]
    xc, xd, mask = T(case["xc"], case["xd"], case["mask"])
    m = GaussianMixture([tstream.Attribute("X0", tstream.REAL)], n_states=2,
                        device="cpu")
    bn = _torch_dist.chain_bn()
    inf = tis.ImportanceSampling(10, device="cpu")
    inf.set_model(bn)
    calls = [
        lambda mesh, ax: dvmp.dvmp_fit(cp, prior, init, xc, xd, mesh, ax),
        lambda mesh, ax: dvmp.dvmp_one_sweep(cp, prior, init, xc, xd, mask,
                                             mesh, ax),
        lambda mesh, ax: dvmp.dvmp_posterior_z(cp, init, xc, xd, mesh, ax),
        lambda mesh, ax: streaming.stream_update(
            cp, prior, streaming.stream_init(prior, init), xc, xd,
            mesh=mesh, data_axes=ax),
        lambda mesh, ax: m.update_model(xc[:, :1].numpy(), mesh=mesh,
                                        data_axes=ax),
        lambda mesh, ax: inf.run_inference(mesh=mesh, data_axes=ax),
        lambda mesh, ax: tmap.map_inference(bn, {"X2": 0.0}, device="cpu",
                                            mesh=mesh, data_axes=ax),
        lambda mesh, ax: PGMQueryEngine(m, mode="vmp", mesh=mesh,
                                        data_axes=ax),
    ]
    for call in calls:
        with pytest.raises(TypeError, match="DeviceMesh"):
            call(object(), ("data",))
        with pytest.raises(ValueError, match="not dims of the mesh"):
            call(world1, ("pod",))
    for mode in ("exact", "importance"):
        with pytest.raises(ValueError, match="mode='vmp'"):
            PGMQueryEngine(bn, mode=mode, device="cpu", mesh=world1)


@pytest.mark.parametrize("batch_size,n_shards", [(803, 2), (10, 4), (8, 4),
                                                 (5, 1)])
def test_sharded_batches_match_reference(batch_size, n_shards):
    """Rounded up to a multiple of the shards; padded rows masked 0."""
    g = np.random.default_rng(batch_size)
    x = g.standard_normal((1000, 2)).astype(np.float32)
    attrs_t = [tstream.Attribute(f"X{i}", tstream.REAL) for i in range(2)]
    attrs_j = [jstream.Attribute(f"X{i}", jstream.REAL) for i in range(2)]
    got = list(tstream.DataStream.from_arrays(attrs_t, x).sharded_batches(
        batch_size, n_shards))
    ref = list(jstream.DataStream.from_arrays(attrs_j, x).sharded_batches(
        batch_size, n_shards))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.xc.shape[0] % n_shards == 0
        for k in ("xc", "xd", "mask"):
            np.testing.assert_array_equal(getattr(a, k),
                                          np.asarray(getattr(b, k)))


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 6, 12])
def test_vmp_bucket_rows_split_evenly_over_any_world(shards):
    """A vmp bucket holds every query and splits into equal blocks over
    the data shards; at a power-of-two world it is the reference's
    max(next power of two, data size)."""
    for n in range(1, 70):
        rows = vmp_bucket_rows(n, shards)
        pow2 = 1 << (n - 1).bit_length()
        assert rows >= max(n, pow2) and rows % shards == 0
        assert rows - pow2 < shards
        if shards & (shards - 1) == 0:
            assert rows == max(pow2, shards)
    assert vmp_bucket_rows(5, 3) == 9 and vmp_bucket_rows(5, 6) == 12


def test_launch_mesh_and_dryrun_at_one_rank(world1):
    """data_axes_of picks "pod"/"data"; the host mesh is ("data",
    "model"); the dry run's claim holds at one rank."""
    host = tmesh.make_host_mesh(1, 1)
    assert host.mesh_dim_names == ("data", "model")
    assert tmesh.data_axes_of(host) == ("data",)
    assert tmesh.data_axes_of(world1) == ("data",)
    assert dvmp.data_size(host, ("data", "model")) == 1
    rec = dryrun_pgm.run_one("fa_plate", 512, world1, sweeps=2)
    assert rec["claim_holds"] and rec["runs"][0]["sweeps"] == 2
    assert rec["suffstat_leaves"] == 9   # einsum's lazy latent block


@pytest.mark.parametrize("mesh,axes", [("single", ["data"]),
                                       ("multi", ["pod", "data"])])
def test_dryrun_main_runs_alone(tmp_path, mesh, axes):
    """``python -m repro_torch.launch.dryrun_pgm --device cpu`` as a world
    of one rank, in its own process (this one may hold a process group);
    ``--mesh multi`` is ``make_production_mesh(multi_pod=True)`` with the
    node's ranks from the launcher's ``LOCAL_WORLD_SIZE``."""
    import json
    import subprocess
    import sys

    env = dict(os.environ, PYTHONPATH=_torch_dist.SRC, LOCAL_WORLD_SIZE="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun_pgm", "--n", "512",
         "--device", "cpu", "--mesh", mesh, "--out", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    name = "pgm_gmm_large_" + "x".join("1" * len(axes)) + ".json"
    assert os.listdir(tmp_path) == [name]
    with open(tmp_path / name) as f:
        rec = json.load(f)
    assert rec["claim_holds"] and rec["backend"] == "gloo"
    assert rec["data_axes"] == axes == list(rec["mesh"])
    assert [r["all_reduces_per_sweep"] for r in rec["runs"]] == [len(axes)] * 2


# -- two ranks ----------------------------------------------------------------


@pytest.mark.parametrize("name", list(PLATES))
def test_two_rank_fit_matches_reference(inputs, ranks, name):
    """Both ranks the same bits and sweeps; within rtol 1e-4 / atol 1e-3 of
    the reference's vmp_fit and its one-device dvmp_fit, ELBO within 1."""
    a, b = (r[f"{name}/data"] for r in _case(ranks, "fits"))
    assert trees_equal(a["post"], b["post"])
    assert torch.equal(a["elbo"], b["elbo"])
    assert a["sweeps"] == b["sweeps"] == a["metric_sweeps"] >= 2
    for ref in _reference_fits(inputs, name):
        assert_params_close(ref.post, a["post"], rtol=1e-4, atol=1e-3,
                            label=name)
        assert abs(float(a["elbo"]) - float(ref.elbo)) < 1.0


@pytest.mark.parametrize("name", list(PLATES))
def test_two_rank_fit_one_all_reduce_a_sweep(inputs, ranks, name):
    """One all_reduce of the whole stats buffer a sweep; the metrics add
    one gather of the shard counts, in shard order (the padded row of
    ``sharded_batches`` counts 0)."""
    a = _case(ranks, "fits")[0][f"{name}/data"]
    c = a["collectives"]
    assert c["all_reduce"] == a["sweeps"]
    assert c["bytes"] == a["sweeps"] * _leaf_bytes(inputs, name)
    assert c["gather"] == 1
    n = len(inputs["plates"][name]["mask"])
    expect = [402.0, 401.0] if name == "gmm" else [n / 2, n / 2]
    assert a["shard_n"].tolist() == expect


def test_two_rank_fit_on_a_2d_mesh_equals_the_1d_mesh(ranks):
    """A (2, 1) ("data", "model") mesh over ("data",) gives the 1-D mesh's
    bits; over both dims, two all_reduces a sweep and the same bits."""
    fits = _case(ranks, "fits")[0]
    one = fits["gmm/data"]
    for label, calls in (("2d", 1), ("2d_both", 2)):
        two = fits[f"gmm/{label}"]
        assert trees_equal(one["post"], two["post"])
        assert two["sweeps"] == one["sweeps"]
        assert two["collectives"]["all_reduce"] == calls * two["sweeps"]
        assert two["shard_n"].tolist() == one["shard_n"].tolist()


def test_two_rank_one_sweeps_equal_the_fit(ranks):
    """dvmp_one_sweep x 4 == dvmp_fit(max_sweeps=4, tol=0) bit for bit,
    on both ranks."""
    a, b = _case(ranks, "one_sweep")
    assert a["fit_sweeps"] == 4
    assert trees_equal(a["post"], a["fit_post"])
    assert torch.equal(a["elbo"], a["fit_elbo"])
    assert trees_equal(a["post"], b["post"])


@pytest.fixture(scope="module")
def reference_stream(inputs):
    """The reference's stream_update on a one-device mesh, batch by
    batch: (final state, info columns)."""
    jcp, jprior, jinit = inputs["jax"]["stream"]
    mesh = make_mesh((1,), ("data",))
    state = jst.stream_init(jprior, jinit)
    infos = []
    for xc in inputs["stream"]["xcs"]:
        state, info = jst.stream_update(
            jcp, jprior, state, jnp.asarray(xc),
            jnp.zeros((xc.shape[0], 0), jnp.int32), mesh=mesh, **STREAM_KW)
        infos.append(info)
    return state, {k: np.stack([np.asarray(i[k]) for i in infos])
                   for k in infos[0]}


def _check_stream(inputs, reference, state, info):
    js, jinfo = reference
    assert info["drifted"].tolist() == jinfo["drifted"].tolist()
    assert any(info["drifted"].tolist())
    assert info["sweeps"].tolist() == jinfo["sweeps"].tolist() \
        == [STREAM_KW["sweeps"]] * len(inputs["stream"]["xcs"])
    for k in ("elbo", "score", "n_eff"):
        np.testing.assert_allclose(info[k].numpy(), jinfo[k], rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    assert_params_close(js.post, state.post, rtol=1e-3, atol=1e-3)
    assert int(state.n_drifts) == int(js.n_drifts)


def test_two_rank_stream_update_matches_reference(inputs, ranks,
                                                 reference_stream):
    a, b = _case(ranks, "stream")
    assert trees_equal(a["state"], b["state"])
    _check_stream(inputs, reference_stream, a["state"], a["info"])


def test_two_rank_model_and_vmp_serving(inputs, ranks):
    """update_model(mesh=) is dvmp_fit: one all_reduce a sweep; served rows
    within 1e-5 of posterior_z; the bucket padded to a power of two that
    the shards divide; the fit within 1e-3 of the mesh-free fit."""
    a, b = _case(ranks, "serve")
    assert trees_equal(a["post"], b["post"])
    np.testing.assert_array_equal(a["served"], b["served"])
    np.testing.assert_allclose(a["served"], a["posterior_z"], atol=1e-5)
    assert a["caps"] == [(16,)]
    assert a["fit_collectives"]["all_reduce"] >= 2
    assert a["fit_collectives"]["gather"] == 0
    xc = inputs["serve"]["xc"]
    m = GaussianMixture([tstream.Attribute(f"X{i}", tstream.REAL)
                         for i in range(xc.shape[1])], n_states=3,
                        device="cpu")
    m.update_model(tstream.Batch(xc, np.zeros((len(xc), 0), np.int32),
                                 np.ones(len(xc), np.float32)),
                   sweeps=20, tol=1e-6)
    np.testing.assert_allclose(a["post"].reg.m.numpy(),
                               m.posterior.reg.m.numpy(), rtol=1e-4,
                               atol=1e-3)


def _mc_bar(p, ess):
    return 5.0 * np.sqrt(p * (1.0 - p) / ess) + 1e-3


def test_two_rank_importance_sampling_contract(inputs, ranks):
    """The gathered particles are the single-process draws with the shard
    seeds, concatenated in shard order; every rank advanced its generator
    the same way; the tables lie within the MC bar of exact."""
    a, b = _case(ranks, "importance")
    s = inputs["importance"]
    bn = _torch_dist.chain_bn()
    gen = torch.Generator().manual_seed(s["seed"])
    seeds = dvmp.shard_seeds(gen, WORLD)
    blocks = [tis._sample_or_clamp(bn, torch.Generator().manual_seed(sd),
                                   s["n"] // WORLD, s["evidence"])
              for sd in seeds]
    assert torch.equal(a["logw"], torch.cat([blk[1] for blk in blocks]))
    for k in a["particles"]:
        expect = torch.cat([blk[0][k] for blk in blocks])
        assert torch.equal(a["particles"][k], expect), k
        assert torch.equal(a["particles"][k], b["particles"][k]), k
    assert torch.equal(a["next_draw"], b["next_draw"])
    assert torch.equal(a["next_draw"],
                       torch.randint(1 << 30, (4,), generator=gen))
    inf = tis.ImportanceSampling(s["n"], device="cpu")
    inf._particles, inf._logw = a["particles"], a["logw"]
    ess = float(inf.effective_sample_size())
    eng = JunctionTreeEngine(bn, device="cpu")
    eng.set_evidence({k: np.array([v]) for k, v in s["evidence"].items()})
    eng.run_inference()
    for name in ("Z", "W"):
        var = bn.dag.variables.by_name(name)
        exact = eng.posterior_discrete(var).reshape(-1).numpy()
        got = inf.posterior_discrete(var).numpy()
        assert (np.abs(got - exact) <= _mc_bar(exact, ess)).all(), name


def test_two_rank_map_contract_and_enumeration(inputs, ranks):
    """MAP over two shards: the first maximum of the shard climbs seeded
    from ``seed``, and the enumerated maximum of the 12-node network."""
    a, b = _case(ranks, "map")
    assert a == b
    s = inputs["map"]
    bn = random_discrete_bn(12, card=3, seed=s["net_seed"], device="cpu")
    ev = bn.evidence_tensors(s["evidence"], torch.device("cpu"))
    dvars = tmap._query_vars(bn, ev)
    seeds = dvmp.shard_seeds(torch.Generator().manual_seed(s["seed"]),
                             WORLD)
    climbs = [tmap._hill_climb(bn, ev, tmap._starts(
        dvars, s["n_starts"] // WORLD, sd, torch.device("cpu")),
        s["n_passes"]) for sd in seeds]
    states = torch.cat([c[0] for c in climbs])
    best = torch.cat([c[1] for c in climbs])
    i = int(best.argmax())
    assert a["asg"] == {v.name: int(states[i, j])
                        for j, v in enumerate(dvars)}
    assert a["lp"] == float(best[i])
    names = [v.name for v in bn.order if v.name not in s["evidence"]]
    grid = torch.tensor(list(itertools.product(range(3),
                                               repeat=len(names))))
    full = {n: grid[:, j] for j, n in enumerate(names)}
    full.update({k: torch.full((grid.shape[0],), v)
                 for k, v in s["evidence"].items()})
    np.testing.assert_allclose(a["lp"], float(bn.log_prob(full).max()),
                               rtol=1e-6)


def test_two_rank_dryrun_collectives_are_o1_in_n(ranks):
    """launch.dryrun_pgm: one all_reduce a sweep and the same bytes at N
    and 4N, on both ranks."""
    for rank in _case(ranks, "dryrun"):
        for name, rec in rank.items():
            assert rec["claim_holds"], rec
            assert rec["mesh"] == {"data": WORLD}
            small, big = rec["runs"]
            assert small["all_reduces_per_sweep"] == 1.0
            assert small["bytes_per_sweep"] == big["bytes_per_sweep"] > 0
            assert rec["suffstat_leaves"] == 8   # no latent block


def test_two_rank_shard_rows_needs_equal_blocks(ranks):
    """Rows that do not split evenly over the shards raise, as shard_map
    does; an even split gives each rank its own contiguous block."""
    for rank, res in enumerate(_case(ranks, "uneven")):
        assert "3 rows do not split into 2 equal shards" in res["error"]
        assert res["block"] == [2 * rank, 2 * rank + 1]
