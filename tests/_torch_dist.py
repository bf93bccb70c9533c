"""Rank workers of the port's d-VMP tests (``tests/test_torch_dvmp.py``).

A launched rank imports only ``torch``, ``numpy`` and ``repro_torch`` (never
JAX): :func:`start` launches ``world`` processes of

    python tests/_torch_dist.py <rank> <world> <tmp dir>

each of which joins a gloo process group through a ``FileStore`` under the
tmp dir (its own timeout on the rendezvous and every collective), runs every
case of :data:`CASES` on the inputs the test wrote (``inputs.pt``), and
saves ``{case: result, or the traceback}`` to ``rank<r>.pt``.
:func:`collect` waits for all ranks within one deadline and kills what is
left.

The networks of the sampling cases are built here from plain arrays
(:func:`chain_bn`), so the test rebuilds the same ones in its own process.
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")

RANK_TIMEOUT_S = 60      # rendezvous and each collective, inside a rank


def chain_bn():
    """Z (card 3) -> X0 -> X1 -> X2 with W (card 2) -> X1, on the CPU."""
    from repro_torch.convert import bayesian_network_from_numpy

    rng = np.random.default_rng(0)
    variables = [("Z", "multinomial", 3), ("W", "multinomial", 2),
                 ("X0", "gaussian", 0), ("X1", "gaussian", 0),
                 ("X2", "gaussian", 0)]
    parents = {"X0": ["Z"], "X1": ["W", "X0"], "X2": ["X1"]}
    cpds = {
        "Z": {"table": rng.dirichlet(np.ones(3))},
        "W": {"table": rng.dirichlet(np.ones(2))},
        "X0": {"alpha": rng.normal(0, 2, 3), "beta": np.zeros((3, 0)),
               "sigma2": 0.5 + rng.random(3)},
        "X1": {"alpha": rng.normal(0, 1, 2), "beta": rng.normal(0, 1, (2, 1)),
               "sigma2": 0.5 + rng.random(2)},
        "X2": {"alpha": rng.normal(), "beta": rng.normal(0, 1, 1),
               "sigma2": 0.5 + rng.random()},
    }
    return bayesian_network_from_numpy(variables, parents, cpds, "cpu")


# -- the cases a rank runs ----------------------------------------------------


def _plate(inp, name):
    from repro_torch.core import vmp
    from repro_torch.core.dag import PlateSpec

    case = inp["plates"][name]
    cp = vmp.compile_plate(PlateSpec(**case["spec"]), device="cpu")
    xc, xd, mask = (torch.from_numpy(case[k]) for k in ("xc", "xd", "mask"))
    return cp, case["prior"], case["init"], xc, xd, mask, case["fit"]


def case_fits(inp, meshes):
    """dvmp_fit on each plate, 1-D mesh, with metrics and collective
    counts; gmm also on the (w, 1) mesh over ("data",) and over both
    dims."""
    from repro_torch.core import dvmp

    out = {}
    for name in inp["plates"]:
        cp, prior, init, xc, xd, mask, (sweeps, tol) = _plate(inp, name)
        runs = [("data", meshes["1d"], ("data",))]
        if name == "gmm":
            runs += [("2d", meshes["2d"], ("data",)),
                     ("2d_both", meshes["2d"], ("data", "model"))]
        for label, mesh, axes in runs:
            dvmp.reset_collectives()
            st, met = dvmp.dvmp_fit(cp, prior, init, xc, xd, mesh, axes,
                                    sweeps, tol, mask=mask,
                                    with_metrics=True)
            out[f"{name}/{label}"] = dict(
                post=st.post, elbo=st.elbo, sweeps=st.sweep,
                shard_n=met.shard_n, metric_sweeps=met.sweeps,
                collectives=dict(dvmp.COLLECTIVES))
    return out


def case_one_sweep(inp, meshes):
    """k dvmp_one_sweep calls against dvmp_fit(max_sweeps=k, tol=0)."""
    from repro_torch.core import dvmp

    cp, prior, init, xc, xd, mask, _ = _plate(inp, "gmm")
    post = init
    for _ in range(4):
        post, e = dvmp.dvmp_one_sweep(cp, prior, post, xc, xd, mask,
                                      meshes["1d"], ("data",))
    st = dvmp.dvmp_fit(cp, prior, init, xc, xd, meshes["1d"], ("data",), 4,
                       0.0, mask=mask)
    return dict(post=post, elbo=e, fit_post=st.post, fit_elbo=st.elbo,
                fit_sweeps=st.sweep)


def case_stream(inp, meshes):
    """stream_update(mesh=) over the drift batches."""
    from repro_torch.core import streaming, vmp
    from repro_torch.core.dag import PlateSpec

    s = inp["stream"]
    cp = vmp.compile_plate(PlateSpec(**s["spec"]), device="cpu")
    state = streaming.stream_init(s["prior"], s["init"])
    infos = []
    for xc in s["xcs"]:
        xc = torch.from_numpy(xc)
        state, info = streaming.stream_update(
            cp, s["prior"], state, xc,
            torch.zeros((xc.shape[0], 0), dtype=torch.int32),
            mesh=meshes["1d"], **s["kw"])
        infos.append(info)
    return dict(state=state, info={k: torch.stack([i[k] for i in infos])
                                   for k in infos[0]})


def case_model_and_serving(inp, meshes):
    """GaussianMixture.update_model(mesh=) and PGMQueryEngine(mode="vmp",
    mesh=) against the mesh-free model's posterior_z."""
    from repro_torch.core import dvmp
    from repro_torch.data.stream import Attribute, Batch
    from repro_torch.pgm_models import GaussianMixture
    from repro_torch.serve.engine import PGMQueryEngine

    s = inp["serve"]
    xc = s["xc"]
    attrs = [Attribute(f"X{i}", "REAL") for i in range(xc.shape[1])]
    m = GaussianMixture(attrs, n_states=3, device="cpu")
    batch = Batch(xc, np.zeros((xc.shape[0], 0), np.int32),
                  np.ones(xc.shape[0], np.float32))
    dvmp.reset_collectives()
    e = m.update_model(batch, sweeps=20, tol=1e-6, mesh=meshes["1d"])
    fit_collectives = dict(dvmp.COLLECTIVES)
    eng = PGMQueryEngine(m, mode="vmp", mesh=meshes["1d"])
    q = s["queries"]
    qs = [eng.submit("Z", {f"X{i}": float(q[b, i])
                           for i in range(q.shape[1])})
          for b in range(q.shape[0])]
    eng.flush()
    return dict(post=m.posterior, elbo=e, fit_collectives=fit_collectives,
                served=np.stack([x.result for x in qs]),
                posterior_z=m.posterior_z(q).numpy(),
                caps=[k.batch_shape for k in eng.plans.keys()])


def case_importance(inp, meshes):
    from repro_torch.core.importance_sampling import ImportanceSampling

    s = inp["importance"]
    inf = ImportanceSampling(n_samples=s["n"], seed=s["seed"], device="cpu")
    inf.set_model(chain_bn())
    inf.set_evidence(s["evidence"])
    inf.run_inference(mesh=meshes["1d"])
    return dict(particles=inf._particles, logw=inf._logw,
                next_draw=torch.randint(1 << 30, (4,), generator=inf.gen))


def case_map(inp, meshes):
    from repro_torch.core import map_inference as M
    from repro_torch.data.synthetic import random_discrete_bn

    s = inp["map"]
    bn = random_discrete_bn(12, card=3, seed=s["net_seed"], device="cpu")
    asg, lp = M.map_inference(bn, s["evidence"], n_starts=s["n_starts"],
                              n_passes=s["n_passes"], seed=s["seed"],
                              mesh=meshes["1d"], device="cpu")
    return dict(asg=asg, lp=lp)


def case_dryrun(inp, meshes):
    from repro_torch.launch import dryrun_pgm

    return {name: dryrun_pgm.run_one(name, inp["dryrun_n"], meshes["1d"],
                                     sweeps=2)
            for name in ("gmm_large", "nb_mixed")}


def case_uneven(inp, meshes):
    from repro_torch.core import dvmp

    try:
        dvmp.shard_rows(torch.zeros(3), meshes["1d"], ("data",))
        error = ""
    except ValueError as e:
        error = str(e)
    block = dvmp.shard_rows(torch.arange(4), meshes["1d"], ("data",))
    return dict(error=error, block=block.tolist())


CASES = {"fits": case_fits, "uneven": case_uneven, "one_sweep": case_one_sweep,
         "stream": case_stream, "serve": case_model_and_serving,
         "importance": case_importance, "map": case_map,
         "dryrun": case_dryrun}


def _rank_main(rank: int, world: int, tmp: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(tmp, 'store')}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        meshes = {"1d": init_device_mesh("cpu", (world,),
                                         mesh_dim_names=("data",)),
                  "2d": init_device_mesh("cpu", (world, 1),
                                         mesh_dim_names=("data", "model"))}
        inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
        out = {}
        for name, fn in CASES.items():
            try:
                out[name] = fn(inp, meshes)
            except Exception:   # report per case; the others still run
                out[name] = traceback.format_exc()
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def start(world: int, tmp: str, inputs: dict) -> list:
    """Start ``world`` gloo ranks running every case on ``inputs``;
    returns their processes (see :func:`collect`)."""
    torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = SRC
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world), tmp],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def collect(procs: list, tmp: str, deadline: float) -> list:
    """Each rank's ``{case: result or traceback}``.  Raises if a rank
    fails or the ranks are not done by ``deadline`` (``time.monotonic``);
    they are killed then."""
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(),
                                               0.1))
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n"
                               f"{logs[r][-3000:]}")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(len(procs))]


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
