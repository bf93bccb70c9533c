"""What the d-VMP collective costs the host on one NCCL rank, on the card.

On a one-rank NCCL world (``init_process_group`` over a ``FileStore``, a
``("data",)`` ``DeviceMesh``) this probe times, with CUDA synchronised
around each timed loop:

- ``dist.all_reduce`` of a buffer the size of gmm_large's stats (174
  floats), host us a call, without and with a ``synchronize`` after each
  call (beside an in-place add with a ``synchronize``, the floor of a
  synchronised call);
- ``dvmp._all_reduce_stats`` of gmm_large's ``PlateStats`` at N = 2^20
  (flatten, all_reduce, split), and the flatten (``torch.cat``) alone;
- one sweep at N = 2^20, in turns (plain, mesh, mesh, plain): the mesh-free
  ``local_step`` + ``global_update`` + ELBO read against
  ``dvmp.dvmp_one_sweep`` + ELBO read, ms a sweep over 40 sweeps;
- ``dvmp.gather_rows`` of a [2^20] float32 and a [2^20] int64 block, and
  ``ImportanceSampling.run_inference`` with 2^20 particles on chain12
  (``chip_smoke``'s network and evidence) with and without the mesh, in
  turns, ms a call; then one profiled call of each (device ops, device
  busy ms).

It runs the measurement twice, in two processes: as launched, and with
``TORCH_NCCL_TRACE_BUFFER_SIZE=0`` (NCCL's flight recorder off).

    python3 probes/dvmp_collective.py

Prints the card's name and power limit, then one dict a process.
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _timed_us(fn, n=500, sync=False):
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
        if sync:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def _sampling(mesh, dev) -> dict:
    import torch

    import chip_smoke as cs
    from repro_torch.core import dvmp
    from repro_torch.core.importance_sampling import ImportanceSampling

    out = {}
    for dtype in (torch.float32, torch.int64):
        block = torch.ones(cs.IS_PARTICLES, device=dev, dtype=dtype)
        out[f"gather_{str(dtype)[6:]}_ms"] = _timed_us(
            lambda: dvmp.gather_rows(block, mesh, ("data",)), n=50) / 1e3
    bn = cs._chain_net(dev)
    inf = ImportanceSampling(cs.IS_PARTICLES, seed=0, device=dev)
    inf.set_model(bn)
    inf.set_evidence(cs._sampled_evidence(bn, dev, ("X11",), 10))
    runs = {"plain": lambda: inf.run_inference(),
            "mesh": lambda: inf.run_inference(mesh=mesh)}
    ms = {"plain": [], "mesh": []}
    for name in ("plain", "mesh", "mesh", "plain"):
        ms[name].append(_timed_us(runs[name], n=20) / 1e3)
    out["importance_ms"] = ms
    for name, fn in runs.items():
        wall, busy, n, _ = cs._profiled(lambda: (fn(),
                                                 torch.cuda.synchronize()),
                                        ())
        out[f"importance_{name}_profile"] = dict(
            wall_ms=wall / 1e3, busy_ms=busy / 1e3, device_ops=n)
    return out


def measure() -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import chip_smoke as cs
    from repro_torch.configs.amidst_pgm import PGM_WORKLOADS
    from repro_torch.core import dvmp, streaming, vmp

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    out = {"TORCH_NCCL_TRACE_BUFFER_SIZE":
           os.environ.get("TORCH_NCCL_TRACE_BUFFER_SIZE")}
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", init_method=f"file://{d}/store",
                                world_size=1, rank=0,
                                timeout=datetime.timedelta(seconds=120))
        try:
            mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
            group = mesh.get_group("data")
            _, xc, xd = cs._gmm(cs.N, 1)
            xc = torch.from_numpy(xc).to(dev)
            xd = torch.from_numpy(np.ascontiguousarray(xd)).to(dev)
            mask = torch.ones(cs.N, device=dev)
            cp = vmp.compile_plate(PGM_WORKLOADS["gmm_large"].spec,
                                   device=dev)
            prior = vmp.default_prior(cp)
            init = vmp.symmetry_broken(prior,
                                       torch.Generator().manual_seed(0))
            st, _ = vmp.local_step(cp, init, xc, xd, mask)
            leaves = streaming.tree_leaves(st)
            flat = torch.zeros(sum(t.numel() for t in leaves), device=dev)
            out["buffer_floats"] = flat.numel()
            out["all_reduce_us"] = _timed_us(
                lambda: dist.all_reduce(flat, group=group))
            out["all_reduce_sync_us"] = _timed_us(
                lambda: dist.all_reduce(flat, group=group), sync=True)
            out["add_sync_us"] = _timed_us(lambda: flat.add_(0.0),
                                           sync=True)
            out["all_reduce_stats_us"] = _timed_us(
                lambda: dvmp._all_reduce_stats(st, mesh, ("data",)))
            out["cat_us"] = _timed_us(
                lambda: torch.cat([t.reshape(-1) for t in leaves]))

            def plain():
                s, _ = vmp.local_step(cp, init, xc, xd, mask)
                p = vmp.global_update(prior, s)
                float(vmp.elbo(cp, prior, p, s))

            def meshed():
                _, e = dvmp.dvmp_one_sweep(cp, prior, init, xc, xd, mask,
                                           mesh)
                float(e)

            sweeps = {"plain": [], "mesh": []}
            for name in ("plain", "mesh", "mesh", "plain"):
                fn = plain if name == "plain" else meshed
                sweeps[name].append(_timed_us(fn, n=40) / 1e3)
            out["sweep_ms"] = sweeps
            out.update(_sampling(mesh, dev))
        finally:
            dist.destroy_process_group()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("dvmp_collective: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    if len(sys.argv) > 1 and sys.argv[1] == "--measure":
        print(measure(), flush=True)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    from repro_torch.kernels import build

    build.build_all()
    rc = 0
    for extra in ({}, {"TORCH_NCCL_TRACE_BUFFER_SIZE": "0"}):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--measure"], env=dict(os.environ, **extra),
                           capture_output=True, text=True, timeout=600)
        print(r.stdout.strip(), flush=True)
        if r.returncode:
            print(r.stderr[-3000:], file=sys.stderr)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
