"""d-VMP's structural claim on the paper's own workloads, over the ranks a
job is launched on (counterpart of ``repro.launch.dryrun_pgm``).

The JAX package lowers ``dvmp_fit`` at N = 1e8 on a 256-chip mesh and
counts the all-reduces in the compiled program.  The port has no compiled
program to read, so this command runs ``dvmp.dvmp_fit`` for a
``configs.amidst_pgm`` workload at N and at 4N instances and counts the
collectives it makes (``dvmp.COLLECTIVES``).  The claim it checks: the only
cross-rank communication of a sweep is one ``all_reduce`` of the
suff-stat buffer a data axis, and its bytes do not depend on N.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_pgm --n 65536
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.dryrun_pgm \
        --device cpu --mesh multi

With no launcher environment it runs as a world of one rank.  The ranks
run on their cards over NCCL, one card a rank, unless ``--device cpu``
asks for gloo ranks on the CPU.  ``--mesh multi`` lays the ranks out as
``("pod", "data")`` (``make_production_mesh(multi_pod=True)``).
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.amidst_pgm import PGM_WORKLOADS
from repro_torch.core import dvmp, vmp
from repro_torch.core.streaming import tree_leaves
from repro_torch.launch.mesh import data_axes_of, make_production_mesh

SWEEPS = 3                                   # sweeps of each fit
TIMEOUT = datetime.timedelta(seconds=300)    # a rendezvous or collective
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _data(cp, n: int, seed: int, device):
    """xc [n, F] standard normal, xd [n, Fd] uniform over each leaf's
    card, from ``seed`` (the same on every rank)."""
    lay = cp.layout
    g = np.random.default_rng(seed)
    xc = g.standard_normal((n, max(lay.F, 1)), dtype=np.float32)
    cards = [c for _, c in sorted(cp.spec.discrete_map.items())]
    xd = np.stack([g.integers(0, c, n) for c in cards], 1).astype(np.int32) \
        if cards else np.zeros((n, 0), np.int32)
    return (torch.from_numpy(xc).to(device),
            torch.from_numpy(xd).to(device))


def run_one(name: str, n: int, mesh, *, sweeps: int = SWEEPS,
            backend=None) -> dict:
    """``dvmp_fit`` of workload ``name`` at n and 4n instances on ``mesh``
    (an up process group, every rank calling); returns the record."""
    axes = data_axes_of(mesh)
    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh.device_type == "cuda" else torch.device("cpu"))
    cp = vmp.compile_plate(PGM_WORKLOADS[name].spec, device=device)
    prior = vmp.default_prior(cp)
    init = vmp.symmetry_broken(prior, torch.Generator().manual_seed(0))
    per_sweep = {}
    for size in (n, 4 * n):
        xc, xd = _data(cp, size, 0, device)
        dvmp.reset_collectives()
        st = dvmp.dvmp_fit(cp, prior, init, xc, xd, mesh, axes,
                           max_sweeps=sweeps, tol=0.0, backend=backend)
        per_sweep[size] = dict(
            sweeps=st.sweep,
            all_reduces_per_sweep=dvmp.COLLECTIVES["all_reduce"] / st.sweep,
            bytes_per_sweep=dvmp.COLLECTIVES["bytes"] / st.sweep,
            elbo=float(st.elbo))
    stats, _ = vmp.local_step(cp, init, *_data(cp, 2, 1, device),
                              torch.ones(2, device=device), backend=backend)
    a, b = per_sweep[n], per_sweep[4 * n]
    return {
        "workload": name, "n_instances": [n, 4 * n],
        "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
        "data_axes": list(axes),
        "backend": dist.get_backend(), "device": str(device),
        "runs": [per_sweep[n], per_sweep[4 * n]],
        "suffstat_leaves": len(tree_leaves(stats)),
        "claim": "all_reduce calls a sweep == data axes, bytes a sweep "
                 "independent of N",
        "claim_holds": (a["all_reduces_per_sweep"] == len(axes)
                        == b["all_reduces_per_sweep"]
                        and a["bytes_per_sweep"] == b["bytes_per_sweep"]),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="gmm_large",
                    choices=list(PGM_WORKLOADS))
    ap.add_argument("--n", type=int, default=1 << 16,
                    help="instances of the first run (the second has 4n)")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--device", default="cuda", choices=list(BACKENDS))
    ap.add_argument("--out", default="results/dryrun_pgm")
    args = ap.parse_args(argv)
    backend = BACKENDS[args.device]
    if args.device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    with tempfile.TemporaryDirectory() as tmp:
        if "RANK" in os.environ:          # launched by torchrun
            dist.init_process_group(backend, timeout=TIMEOUT)
        else:
            dist.init_process_group(
                backend, init_method=f"file://{tmp}/store",
                world_size=1, rank=0, timeout=TIMEOUT)
        try:
            mesh = make_production_mesh(multi_pod=args.mesh == "multi",
                                        device_type=args.device)
            rec = run_one(args.workload, args.n, mesh)
        finally:
            dist.destroy_process_group()
    if int(os.environ.get("RANK", 0)) == 0:
        os.makedirs(args.out, exist_ok=True)
        world = "x".join(str(v) for v in rec["mesh"].values())
        with open(os.path.join(args.out,
                               f"pgm_{args.workload}_{world}.json"), "w") as f:
            json.dump(rec, f, indent=1)
        print(json.dumps(rec, indent=1))
    return 0 if rec["claim_holds"] else 1


if __name__ == "__main__":
    sys.exit(main())
