#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's streaming-VMP main path on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. device: requires a CUDA card; TF32 off; prints the card's name and power
   limit as nvidia-smi reports them.
2. build: compiles the port's CUDA sources (``src/repro_torch/kernels/csrc``)
   with nvcc and prints the seconds.
3. kernels: each suff-stats kernel at the main path's shapes (N = 2^20
   instances; gmm_large for clg_suffstats, fa_plate for
   clg_suffstats_latent, nb_mixed for clg_disc_counts) against its plain
   PyTorch version, twice for bitwise repeatability, and timed with CUDA
   events against the plain version, one PyTorch library call where there is
   one, and the least time the card could take (bytes over 3.35 TB/s or
   float32 operations over 67 TFLOP/s, whichever is larger).
4. main path: for gmm_large, nb_mixed and fa_plate at full width, a drifting
   stream of T = 8 chunks of 2^20 instances whose generator switches at
   chunk 4 goes through ``Model.update_model(stream, sweeps=5, tol=0.0)``
   with the default (CUDA) backend, then ``posterior_z`` on 2^20 queries;
   the same fit is re-run with ``backend="einsum"`` as the yardstick.

Prints the kernel line ``{"kernels": [...]}`` (launch counts from the main
path's runs) and, last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

N = 1 << 20            # instances per chunk and per kernel call
T_CHUNKS = 8           # chunks per stream
SWITCH = 4             # the generator changes at this chunk
SWEEPS = 5
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
KERNEL_RTOL, KERNEL_ATOL_REL = 1e-4, 1e-5   # atol = 1e-5 * max|plain|
FIT_TOL_REL = 1e-3             # |m_cuda - m_einsum| <= 1e-3 * (1 + max|m|)
Z_ATOL = 1e-2                  # posterior_z after the cuda and einsum
                               # fits (float32 sum order over ~40 sweeps)
SOURCE = "src/repro_torch/kernels/csrc/clg_stats.cu"
REPLACES = {"clg_suffstats": "src/repro/kernels/clg_stats.py:108",
            "clg_suffstats_latent": "src/repro/kernels/clg_stats.py:215",
            "clg_disc_counts": "src/repro/kernels/clg_stats.py:289"}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, nops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def compare(got, exp):
    """Max abs error; raises if outside the stated tolerance."""
    import torch

    err = 0.0
    for g, e in zip(got, exp):
        scale = float(e.abs().max())
        torch.testing.assert_close(g, e, rtol=KERNEL_RTOL,
                                   atol=KERNEL_ATOL_REL * scale)
        err = max(err, float((g - e).abs().max()))
    return err


def kernel_phase(dev):
    """Each kernel vs its plain version at the main path's shapes."""
    import torch

    from repro_torch.configs.amidst_pgm import PGM_WORKLOADS
    from repro_torch.core.vmp import layout_of
    from repro_torch.kernels import clg_stats, ref

    g = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(*s, generator=g, device=dev)
    rows = {}

    def record(name, kern, plain, library, nbytes, nops):
        got, again = kern(), kern()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{name}: two launches differ in bits")
        err = compare(got, plain())
        b_ms, b_by = bound(nbytes, nops)
        rows[name] = dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=0, max_abs_err=err, ms=time_ms(kern),
            plain_ms=time_ms(plain), bound_ms=b_ms, bound_by=b_by,
            library_ms=None if library is None else time_ms(library))
        log(f"kernel {name}: max_abs_err {err:.3e} (rtol {KERNEL_RTOL}, "
            f"atol {KERNEL_ATOL_REL}*max|plain|), bitwise repeatable; "
            f"ms {rows[name]['ms']:.4f} plain_ms {rows[name]['plain_ms']:.4f}"
            f" bound_ms {b_ms:.4f} ({b_by})")

    # clg_suffstats at gmm_large: d [N, F, 1], y [N, F], r [N, K]
    lay = layout_of(PGM_WORKLOADS["gmm_large"].spec)
    F, K, D = lay.F, lay.K, lay.D
    d, y = randn(N, F, D), randn(N, F)
    r = torch.softmax(randn(N, K), -1)
    u = torch.cat([d, y[..., None]], -1)     # [d, y]: one einsum, all three
    record("clg_suffstats", lambda: clg_stats.clg_suffstats(d, y, r),
           lambda: ref.clg_suffstats_ref(d, y, r),
           lambda: torch.einsum("nfa,nfb,nk->fkab", u, u, r),
           4 * (N * (F * D + F + K) + F * K * (D * D + D + 1)),
           N * F * K * 3 * (D * D + D + 1))

    # clg_suffstats_latent at fa_plate: obs [N, F, 1], h_mean [N, K, L]
    lay = layout_of(PGM_WORKLOADS["fa_plate"].spec)
    F, K, L, Do = lay.F, lay.K, lay.L, 1 + lay.P
    D = Do + L
    obs, y = randn(N, F, Do), randn(N, F)
    hm, r = randn(N, K, L), torch.softmax(randn(N, K), -1)
    a = 0.3 * randn(K, L, L)
    shh = a @ a.transpose(-1, -2) + torch.eye(L, device=dev)
    record("clg_suffstats_latent",
           lambda: clg_stats.clg_suffstats_latent(obs, hm, y, r, shh),
           lambda: ref.clg_suffstats_latent_ref(obs, hm, y, r, shh), None,
           4 * (N * (F * Do + K * L + F + K) + K * L * L
                + F * K * (D * D + D + 1)),
           N * F * K * 3 * (D * D + D + 1))

    # clg_disc_counts at nb_mixed: xd [N, Fd] int32, r [N, K], C
    lay = layout_of(PGM_WORKLOADS["nb_mixed"].spec)
    Fd, K, C = lay.Fd, lay.K, lay.C
    xd = torch.randint(0, C, (N, Fd), generator=g, device=dev,
                       dtype=torch.int32)
    r = torch.softmax(randn(N, K), -1)
    record("clg_disc_counts", lambda: [clg_stats.clg_disc_counts(xd, r, C)],
           lambda: [ref.clg_disc_counts_ref(xd, r, C)], None,
           4 * (N * (Fd + K) + Fd * K * C), N * Fd * K)
    return rows


# -- drifting streams of the three workloads ---------------------------------


def _gmm(n, seed):
    from repro_torch.data import synthetic as syn

    s, _, _ = syn.gmm_stream(n, 4, 10, seed=seed)
    b = s.collect()
    return s.attributes, b.xc, b.xd


def _nb(n, seed):
    from repro_torch.data import synthetic as syn

    s, _ = syn.nb_stream(n, 3, 10, 2, card=4, seed=seed)
    b = s.collect()
    return s.attributes[:-1], b.xc, b.xd[:, :-1]   # the class is hidden


def _fa(n, seed):
    from repro_torch.data import synthetic as syn

    s, _ = syn.fa_stream(n, 16, 4, seed=seed)
    b = s.collect()
    return s.attributes, b.xc, b.xd


def drifting_stream(make, n, t_chunks, switch):
    """t_chunks chunks of n instances; chunks >= switch come from another
    seed of the generator (new means: a concept drift)."""
    from repro_torch.data.stream import DataStream

    phases = [make(switch * n, 1), make((t_chunks - switch) * n, 2)]

    def src():
        for _, xc, xd in phases:
            for i in range(0, xc.shape[0], n):
                yield xc[i:i + n], xd[i:i + n]

    return DataStream(phases[0][0], src, n_instances=t_chunks * n)


def main_path_phase(card):
    """The three workloads through the public API; returns the launch
    counts of their cuda-backend runs."""
    import torch

    from repro_torch.configs.amidst_pgm import PGM_WORKLOADS
    from repro_torch.core.streaming import tree_finite, tree_leaves
    from repro_torch.kernels import clg_stats
    from repro_torch.pgm_models import (FactorAnalysis, GaussianMixture,
                                        NaiveBayes)

    cases = [
        # (workload, data, model, kernels it must launch, drift expected)
        ("gmm_large", _gmm,
         lambda a, backend: GaussianMixture(a, n_states=4, backend=backend),
         ("clg_suffstats",), True),
        ("nb_mixed", _nb,
         lambda a, backend: NaiveBayes(a, n_states=3, backend=backend),
         ("clg_suffstats", "clg_disc_counts"), True),
        ("fa_plate", _fa,
         lambda a, backend: FactorAnalysis(a, n_hidden=4, backend=backend),
         ("clg_suffstats_latent",), False),
    ]

    def fit(name, build, attrs, stream, queries, backend):
        model = build(attrs, backend=backend)
        if model.spec != PGM_WORKLOADS[name].spec:
            raise AssertionError(f"{name}: spec {model.spec} differs from "
                                 f"the config's")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        clg_stats.reset_launches()           # counts of this run only
        t0 = time.perf_counter()
        e = model.update_model(stream, sweeps=SWEEPS, tol=0.0)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        z = model.posterior_z(queries)
        torch.cuda.synchronize()
        info = model.last_stream_info
        return dict(model=model, elbo=e, seconds=secs, z=z,
                    inst_per_s=T_CHUNKS * N / secs,
                    launches=dict(clg_stats.LAUNCHES),
                    peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                    drifted=[bool(x) for x in info["drifted"].tolist()],
                    sweeps=info["sweeps"].tolist())

    total = dict.fromkeys(clg_stats.LAUNCHES, 0)
    for name, make, build, kernels, drifts in cases:
        # warm-up of both backends on a small stream (library handles,
        # allocator, first launches), outside every timed and counted run
        small = drifting_stream(make, 4096, 2, 1)
        for backend in ("cuda", "einsum"):
            build(small.attributes, backend).update_model(small, sweeps=1,
                                                          tol=0.0)
        stream = drifting_stream(make, N, T_CHUNKS, SWITCH)
        attrs = stream.attributes
        _, qx, qd = make(N, 2)              # queries from the new regime
        queries = _batch(qx, qd)
        # in turns: einsum, cuda, cuda, einsum
        runs = {"cuda": [], "einsum": []}
        for backend in ("einsum", "cuda", "cuda", "einsum"):
            runs[backend].append(fit(name, build, attrs, stream, queries,
                                     backend))
        cu, ei = runs["cuda"][0], runs["einsum"][0]
        if not all(torch.equal(a, b) for a, b in zip(
                tree_leaves(cu["model"].posterior),
                tree_leaves(runs["cuda"][1]["model"].posterior))):
            raise AssertionError(f"{name}: two cuda fits differ in bits")
        for k in clg_stats.LAUNCHES:
            total[k] += cu["launches"][k]
            if (k in kernels) != (cu["launches"][k] > 0):
                raise AssertionError(f"{name}: {k} launched "
                                     f"{cu['launches'][k]} times")
        if any(ei["launches"].values()):
            raise AssertionError(f"{name}: the einsum run launched kernels")
        post = cu["model"].posterior
        if not bool(tree_finite(post)):
            raise AssertionError(f"{name}: posterior is not finite")
        z = cu["z"]
        if tuple(z.shape) != (N, post.mix.alpha.shape[0]) or not bool(
                torch.isfinite(z).all()):
            raise AssertionError(f"{name}: posterior_z bad: {tuple(z.shape)}")
        z_err = float((z - ei["z"]).abs().max())
        m_c, m_e = post.reg.m, ei["model"].posterior.reg.m
        m_err = float((m_c - m_e).abs().max())
        m_tol = FIT_TOL_REL * (1.0 + float(m_e.abs().max()))
        first = next((i for i, f in enumerate(cu["drifted"]) if f), None)
        rate = {b: [r["inst_per_s"] for r in runs[b]] for b in runs}
        log(f"{name}: T={T_CHUNKS} x N={N}, switch at {SWITCH}; drift flags "
            f"cuda {cu['drifted']} einsum {ei['drifted']}; sweeps "
            f"{cu['sweeps']}; elbo {cu['elbo']:.6g} (einsum {ei['elbo']:.6g})"
            f"; |m_cuda-m_einsum| {m_err:.3e} (tol {m_tol:.3e}); "
            f"|z_cuda-z_einsum| {z_err:.3e} (tol {Z_ATOL}); two cuda fits "
            f"bitwise equal")
        log(f"{name}: inst/s (einsum, cuda, cuda, einsum) {rate['einsum'][0]}"
            f" {rate['cuda'][0]} {rate['cuda'][1]} {rate['einsum'][1]}; "
            f"peak GB cuda {cu['peak_mem_gb']:.4f} einsum "
            f"{ei['peak_mem_gb']:.4f}; launches {cu['launches']}; "
            f"card {card}")
        if m_err > m_tol:
            raise AssertionError(f"{name}: cuda and einsum posteriors differ")
        if z_err > Z_ATOL:
            raise AssertionError(f"{name}: cuda and einsum posterior_z differ")
        if drifts and first not in (SWITCH, SWITCH + 1):
            raise AssertionError(f"{name}: first drift at {first}, expected "
                                 f"{SWITCH} or {SWITCH + 1}")
        prof = {b: profile_sweeps(runs[b][0]["model"], queries)
                for b in ("cuda", "einsum")}
        log(f"{name}: profiled sweep at N={N} (profiler on) {prof}")
    return total


def profile_sweeps(model, batch, sweeps=3):
    """torch.profiler over ``sweeps`` local steps + global updates of
    ``model`` on ``batch`` (after the fits, so warm): device busy time (sum
    of kernel durations), its share of the wall time, device kernels per
    sweep, and the share of device time in this repo's kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import vmp

    b = model._as_batch(batch)

    def run():
        for _ in range(sweeps):
            st, _ = vmp.local_step(model.cp, model.posterior, b.xc, b.xd,
                                   b.mask, backend=model.backend)
            post = vmp.global_update(model.prior, st)
            float(vmp.elbo(model.cp, model.prior, post, st))
        torch.cuda.synchronize()

    run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_us = 1e6 * (time.perf_counter() - t0)
    ours = ("clg_moments_tile", "disc_counts_tile", "tile_reduce",
            "latent_correct")
    busy = mine = 0.0
    n = 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dur = ev.time_range.elapsed_us()
            busy += dur
            n += 1
            if any(k in ev.name for k in ours):
                mine += dur
    return dict(sweep_ms=wall_us / sweeps / 1e3,
                device_busy_ms=busy / sweeps / 1e3,
                idle_share=max(0.0, 1.0 - busy / wall_us),
                device_ops_per_sweep=n / sweeps,
                kernel_share_of_device=mine / busy if busy else 0.0)


def _batch(xc, xd):
    from repro_torch.data.stream import Batch

    return Batch(xc, xd, np.ones(xc.shape[0], np.float32))


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    log(card)
    dev = torch.device("cuda:0")

    from repro_torch.kernels import build

    secs, _ = build.build_all()
    log(f"build: {secs:.2f} s")
    rows = kernel_phase(dev)
    total = main_path_phase(card)
    for name, row in rows.items():
        row["launches"] = total[name]
        if not row["launches"]:
            raise AssertionError(f"{name} was never launched on the main path")
    kernels = {"kernels": list(rows.values())}
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
