"""d-VMP across the cards of one host: shard invariance and fit time.

Spawns one process a card, joined in one NCCL world over a ``FileStore``
with a ``("data",)`` ``DeviceMesh``.  For each of the main path's workloads
(gmm_large, nb_mixed, fa_plate at their full widths), every rank makes the
same global batch of ``ranks x n`` instances from a seed and runs
``dvmp.dvmp_fit(sweeps, tol=0.0)`` on its block of n rows, five times
(seconds from a barrier to the end, synchronised).  Rank 0 also fits, with
the mesh-free ``vmp.vmp_fit`` on its own card, the whole global batch (what
one card does with the same data) and its own block alone (the per-card
work without the collective), five times each, while the others wait.
Eight sweeps of d-VMP are profiled on every rank after a barrier; rank
0's are reported (device busy time with and without NCCL's kernels,
device ops, NCCL's kernels' least and median time).

Checks: every rank holds the same bits; the d-VMP means lie within
1e-3 (1 + max|m|) of the one-card fit of the whole batch.

    python3 probes/dvmp_multicard.py            # one rank a card
    python3 probes/dvmp_multicard.py --cpu --ranks 4 --n 4096   # gloo, CPU

Prints the cards' names and power limits, one line a workload, and exits
non-zero if a check fails.
"""

from __future__ import annotations

import argparse
import datetime
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
REPS = 5
PROFILED_SWEEPS = 8
FIT_TOL_REL = 1e-3


def _profile_sweeps(sweep, init, dist, k=PROFILED_SWEEPS):
    """torch.profiler over ``k`` sweeps (each ending in a host read of the
    ELBO) after a barrier: wall and device busy ms a sweep, device ops a
    sweep, and NCCL's kernels one by one.  An NCCL kernel's time includes
    its wait for the slowest rank, so the least and the median are
    given; busy time is also given without NCCL's kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def run():
        post = init
        for _ in range(k):
            post, e = sweep(post)
            float(e)
        torch.cuda.synchronize()

    run()
    dist.barrier()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = 1e6 * (time.perf_counter() - t0)
    busy, n, nccl = 0.0, 0, []
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dur = ev.time_range.elapsed_us()
            busy += dur
            n += 1
            if "nccl" in ev.name.lower():
                nccl.append(dur)
    nccl.sort()
    return dict(sweep_ms=wall / k / 1e3, busy_ms=busy / k / 1e3,
                busy_without_nccl_ms=(busy - sum(nccl)) / k / 1e3,
                idle=max(0.0, 1.0 - busy / wall), ops=n / k,
                nccl_kernels=len(nccl),
                nccl_us_min=nccl[0] if nccl else None,
                nccl_us_median=nccl[len(nccl) // 2] if nccl else None)


def _rank(rank, world, store, out, n, on_cpu, sweeps):
    sys.path[:0] = [SRC, ROOT]
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import chip_smoke as cs
    from repro_torch.configs.amidst_pgm import PGM_WORKLOADS
    from repro_torch.core import dvmp, vmp
    from repro_torch.core.streaming import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    if on_cpu:
        dev, backend = torch.device("cpu"), "gloo"
        sync = lambda: None
        torch.set_num_threads(1)        # the ranks share the host's cores
    else:
        dev, backend = torch.device("cuda", rank), "nccl"
        torch.cuda.set_device(dev)
        sync = torch.cuda.synchronize
    dist.init_process_group(backend, init_method=f"file://{store}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=600))
    try:
        mesh = init_device_mesh(dev.type, (world,), mesh_dim_names=("data",))

        def timed(fn, barrier=True):
            secs, res = [], None
            for _ in range(REPS):
                sync()
                if barrier:
                    dist.barrier()
                t0 = time.perf_counter()
                res = fn()
                sync()
                secs.append(time.perf_counter() - t0)
            return res, secs

        results = {}
        for name, make in (("gmm_large", cs._gmm), ("nb_mixed", cs._nb),
                           ("fa_plate", cs._fa)):
            _, xc, xd = make(world * n, 1)
            xc = torch.from_numpy(xc).to(dev)
            xd = torch.from_numpy(np.ascontiguousarray(xd)).to(dev)
            ones = torch.ones(world * n, device=dev)
            cp = vmp.compile_plate(PGM_WORKLOADS[name].spec, device=dev)
            prior = vmp.default_prior(cp)
            init = vmp.symmetry_broken(prior,
                                       torch.Generator().manual_seed(0))
            dvmp.dvmp_fit(cp, prior, init, xc, xd, mesh, max_sweeps=1)
            st, secs = timed(lambda: dvmp.dvmp_fit(
                cp, prior, init, xc, xd, mesh, max_sweeps=sweeps, tol=0.0))
            rec = dict(secs=secs, sweeps=st.sweep, elbo=float(st.elbo),
                       post=tree_map(lambda t: t.cpu(), st.post))
            if not on_cpu:
                rec["profile"] = _profile_sweeps(
                    lambda post: dvmp.dvmp_one_sweep(
                        cp, prior, post, xc, xd, ones, mesh),
                    init, dist)
            if rank == 0:
                vmp.vmp_fit(cp, prior, init, xc, xd, 1, 0.0)
                one, one_secs = timed(lambda: vmp.vmp_fit(
                    cp, prior, init, xc, xd, sweeps, 0.0), barrier=False)
                blk, blk_secs = timed(lambda: vmp.vmp_fit(
                    cp, prior, init, xc[:n], xd[:n], sweeps, 0.0),
                    barrier=False)
                rec["one_card"] = dict(secs=one_secs, sweeps=one.sweep,
                                       m=one.post.reg.m.cpu(),
                                       elbo=float(one.elbo))
                rec["one_block"] = dict(secs=blk_secs, sweeps=blk.sweep)
            dist.barrier()
            results[name] = rec
            del xc, xd
        torch.save(results, out)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="processes (default: one a card)")
    ap.add_argument("--n", type=int, default=1 << 20,
                    help="instances a rank")
    ap.add_argument("--sweeps", type=int, default=5)
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU (a rehearsal)")
    args = ap.parse_args(argv)
    sys.path[:0] = [SRC, ROOT]
    import torch

    from repro_torch.core.streaming import tree_leaves

    if not args.cpu:
        if not torch.cuda.is_available():
            print("dvmp_multicard: no CUDA device", file=sys.stderr)
            return 1
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip(),
              flush=True)
        from repro_torch.kernels import build

        build.build_all()
    world = args.ranks or (2 if args.cpu else torch.cuda.device_count())
    ctx = multiprocessing.get_context("spawn")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        outs = [os.path.join(d, f"rank{r}.pt") for r in range(world)]
        procs = [ctx.Process(target=_rank, args=(
            r, world, os.path.join(d, "store"), outs[r], args.n, args.cpu,
            args.sweeps)) for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + 1200
        try:
            for p in procs:
                p.join(max(deadline - time.monotonic(), 0.1))
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
        if any(p.exitcode != 0 for p in procs):
            print(f"dvmp_multicard: exit codes "
                  f"{[p.exitcode for p in procs]}", file=sys.stderr)
            return 1
        res = [torch.load(o, weights_only=False) for o in outs]
    ok = True
    total = world * args.n
    for name, r0 in res[0].items():
        same = all(all(torch.equal(a, b) for a, b in zip(
            tree_leaves(r0["post"]), tree_leaves(r[name]["post"])))
            and r[name]["sweeps"] == r0["sweeps"] for r in res[1:])
        one = r0["one_card"]
        err = float((r0["post"].reg.m - one["m"]).abs().max())
        tol = FIT_TOL_REL * (1.0 + float(one["m"].abs().max()))
        rate = lambda secs: [round(total / s) for s in secs]
        print(f"{name}: {world} ranks x n={args.n} = {total} instances, "
              f"{r0['sweeps']} sweeps (one card: {one['sweeps']}); d-VMP "
              f"s {[round(s, 6) for s in r0['secs']]} inst/s "
              f"{rate(r0['secs'])}; one card, the whole batch: s "
              f"{[round(s, 6) for s in one['secs']]} inst/s "
              f"{rate(one['secs'])}; one card, one block of n: s "
              f"{[round(s, 6) for s in r0['one_block']['secs']]}; ranks "
              f"{'the same bits' if same else 'DIFFER'}; |m - m_one_card| "
              f"{err:.3e} (tol {tol:.3e}); elbo {r0['elbo']:.8g} vs "
              f"{one['elbo']:.8g}; profiled sweep on rank 0 (profiler on) "
              f"{r0.get('profile', 'not measured')}", flush=True)
        ok = ok and same and err <= tol
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
