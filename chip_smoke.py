#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. device: requires a CUDA card; TF32 off; prints the card's name and power
   limit as nvidia-smi reports them.
2. build: compiles the port's CUDA sources (``src/repro_torch/kernels/csrc``,
   one nvcc per source, all started together) and prints the seconds.
3. kernels: each suff-stats kernel at the streaming path's shapes (N = 2^20
   instances; gmm_large for clg_suffstats, fa_plate for
   clg_suffstats_latent, nb_mixed for clg_disc_counts) against its plain
   PyTorch version, twice for bitwise repeatability, and timed with CUDA
   events against the plain version, one PyTorch library call where there is
   one, and the least time the card could take (bytes over 3.35 TB/s or
   float32 operations over 67 TFLOP/s, whichever is larger).
4. streaming main path: for gmm_large, nb_mixed and fa_plate at full width,
   a drifting stream of T = 8 chunks of 2^20 instances whose generator
   switches at chunk 4 goes through ``Model.update_model(stream, sweeps=5,
   tol=0.0)`` with the default (CUDA) backend, then ``posterior_z`` on 2^20
   queries; the same fit is re-run with ``backend="einsum"`` as the
   yardstick.
5. exact serving: ``PGMQueryEngine(mode="exact", pad_pow2=True)`` answers
   B = 1024 queries per evidence schema per flush on three networks -- the
   discrete pipeline on ``random_discrete_bn(32, card=4, max_parents=3)``
   (3 schemas, 4 flushes), the strong pipeline on BENCH_latent's depth-12
   CLG chain and on an FA-style network at fa_plate's widths (Z card 4,
   four latent H, 16 observed leaves) -- with the CUDA backend and the plain
   backend in turns (plain, cuda, cuda, plain), asserting the launches per
   propagation (168 log_product + 48 log_marginalize on the discrete
   network, at least one cg_weak_marg on each strong one) and that the two
   backends agree; then ``factors.reduce_evidence`` on the largest clique
   belief and ``Model.posterior_exact`` on the fitted nb_mixed model,
   against ``posterior_z``.
6. factor kernels: each of the four at the largest shape the serving phase
   launched, against its plain version (same bits for log_product and
   evidence_select), with all -inf rows and dead mixture rows, timed as in
   phase 3.

Prints the kernel line ``{"kernels": [...]}`` (launch counts from the main
paths' runs) and, last, ``{"ok": true, "device": {...}}``.
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
FACTOR_SOURCE = "src/repro_torch/kernels/csrc/factor_ops.cu"
REPLACES = {"clg_suffstats": "src/repro/kernels/clg_stats.py:108",
            "clg_suffstats_latent": "src/repro/kernels/clg_stats.py:215",
            "clg_disc_counts": "src/repro/kernels/clg_stats.py:289",
            "log_product": "src/repro/kernels/factor_ops.py:60",
            "log_marginalize": "src/repro/kernels/factor_ops.py:114",
            "evidence_select": "src/repro/kernels/factor_ops.py:154",
            "cg_weak_marg": "src/repro/kernels/factor_ops.py:222"}
SERVE_B = 1024         # queries per evidence schema per flush
SERVE_FLUSHES = 4
POST_ATOL = 1e-5       # exact posteriors, cuda vs plain backend
LOGZ_TOL_REL = 1e-4    # |logZ_cuda - logZ_plain| <= 1e-4 (1 + |logZ|)
MOMENT_TOL_REL = 1e-4  # posterior means/variances: 1e-4 (1 + |plain|)
EXACT_VS_VMP_ATOL = 1e-3   # posterior_exact vs posterior_z (point estimate
                           # vs VMP's expected log-likelihoods)
LSE_TOL = 1e-5         # log_marginalize, cg_weak_marg's mass: 1e-5 (1+|x|)
WEAK_ATOL, WEAK_RTOL = 1e-5, 1e-4   # cg_weak_marg's mean and covariance


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
    fitted = {}
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
        fitted[name] = (cu["model"], queries, z)
    return total, fitted


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


# -- exact serving (infer_exact + serve) --------------------------------------


def _chain_net(dev, depth=12):
    """BENCH_latent's strong-JT network: Z (card 3) -> X00 -> ... -> X11, the
    same draws from RandomState(0) as ``benchmarks/run.py``."""
    import torch

    from repro_torch.core.dag import (BayesianNetwork, CLGCPD, DAG,
                                      MultinomialCPD, Variables)

    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32,
                               device=dev)
    vs = Variables()
    Z = vs.new_multinomial("Z", 3)
    xs = [vs.new_gaussian(f"X{i:02d}") for i in range(depth)]
    dag = DAG(vs)
    dag.add_parent(xs[0], Z)
    for a_, b_ in zip(xs, xs[1:]):
        dag.add_parent(b_, a_)
    rng = np.random.RandomState(0)
    cpds = {"Z": MultinomialCPD(t(rng.dirichlet(np.ones(3)))),
            xs[0].name: CLGCPD(t(rng.randn(3)), t(np.zeros((3, 0))),
                               t(np.ones(3)))}
    for a_, b_ in zip(xs, xs[1:]):
        cpds[b_.name] = CLGCPD(t(rng.randn()), t(rng.randn(1) * 0.8),
                               t(0.3 + rng.rand()))
    return BayesianNetwork(dag, cpds)


def _fa_net(dev, K=4, L=4, F=16, seed=0):
    """``tests/test_strong_jt.py::fa_net`` widened to fa_plate's widths:
    Z (card K) mixes L latent H; F observed leaves each regress on all H."""
    import torch

    from repro_torch.core.dag import (BayesianNetwork, CLGCPD, DAG,
                                      MultinomialCPD, Variables)

    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32,
                               device=dev)
    rng = np.random.RandomState(seed)
    vs = Variables()
    Z = vs.new_multinomial("Z", K)
    hs = [vs.new_gaussian(f"H{i + 1}") for i in range(L)]
    xs = [vs.new_gaussian(f"X{i}") for i in range(F)]
    dag = DAG(vs)
    cpds = {"Z": MultinomialCPD(t(rng.dirichlet(np.ones(K))))}
    for h in hs:
        dag.add_parent(h, Z)
        cpds[h.name] = CLGCPD(t(2.0 * rng.randn(K)), t(np.zeros((K, 0))),
                              t(0.5 + rng.rand(K)))
    for x in xs:
        for h in hs:
            dag.add_parent(x, h)
        cpds[x.name] = CLGCPD(t(rng.randn()), t(rng.randn(L)),
                              t(0.3 + rng.rand()))
    return BayesianNetwork(dag, cpds)


def _serving_cases(dev):
    """(name, network, schemas, targets, continuous nodes to query, kernels
    the cuda backend must launch)."""
    from repro_torch.data.synthetic import random_discrete_bn

    disc = random_discrete_bn(32, card=4, max_parents=3, seed=0, device=dev)
    fa = _fa_net(dev)
    return [
        ("discrete32", disc,
         [("D31",), ("D5", "D20"), ("D10", "D25", "D30")], ("D0", "D16"),
         (), ("log_product", "log_marginalize")),
        ("chain12", _chain_net(dev), [("X11",), ("X05", "X11")], ("Z",),
         ("X00", "X08"), ("cg_weak_marg",)),
        ("fa16", fa, [tuple(f"X{i}" for i in range(16)),
                      tuple(f"X{i}" for i in range(8))], ("Z",),
         ("H1", "H4", "X15"), ("cg_weak_marg",)),
    ]


def _draw_queries(dev, bn, schemas, targets, seed):
    """SERVE_FLUSHES flushes of SERVE_B queries per schema: evidence values
    drawn by sampling the network (so none is impossible)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    flushes = []
    for _ in range(SERVE_FLUSHES):
        qs = []
        for schema in schemas:
            s = {k: v.cpu().numpy() for k, v in
                 bn.sample(gen, SERVE_B).items() if k in schema}
            for b in range(SERVE_B):
                qs.append((targets[b % len(targets)],
                           {k: float(s[k][b]) for k in schema}))
        flushes.append(qs)
    return flushes


class _ShapeRecorder:
    """Wraps the factor-kernel wrappers while the serving phase runs and
    keeps the largest input shapes each was called with."""

    def __init__(self):
        from repro_torch.kernels import factor_ops

        self.mod, self.largest, self._orig = factor_ops, {}, {}
        for name in factor_ops.LAUNCHES:
            self._orig[name] = getattr(factor_ops, name)
            setattr(factor_ops, name, self._wrap(name, self._orig[name]))

    def _wrap(self, name, fn):
        def rec(*args):
            shapes = tuple(tuple(a.shape) for a in args)
            if shapes[0] and (name not in self.largest or np.prod(
                    shapes[0]) > np.prod(self.largest[name][0])):
                self.largest[name] = shapes
            return fn(*args)
        return rec

    def close(self):
        for name, fn in self._orig.items():
            setattr(self.mod, name, fn)


def exact_serving_phase(dev, card, fitted):
    """The three networks through ``PGMQueryEngine``; then
    ``factors.reduce_evidence`` and ``Model.posterior_exact``.  Returns the
    launch counts of the cuda-backend runs and the largest kernel shapes."""
    import torch

    from repro_torch.infer_exact import JunctionTreeEngine
    from repro_torch.infer_exact import factors as F
    from repro_torch.kernels import factor_ops

    total = dict.fromkeys(factor_ops.LAUNCHES, 0)
    cases = _serving_cases(dev)
    rec = _ShapeRecorder()
    try:
        for name, bn, schemas, targets, cont, kernels in cases:
            flushes = _draw_queries(dev, bn, schemas, targets, seed=1)
            n_props = SERVE_FLUSHES * len(schemas)
            runs = {"cuda": [], "einsum": []}
            for backend in ("einsum", "cuda", "cuda", "einsum"):
                runs[backend].append(
                    _serve(bn, backend, dev, flushes, schemas, cont))
            cu, ei = runs["cuda"][0], runs["einsum"][0]
            launches = cu["launches"]
            for k in total:
                total[k] += launches[k]
                if (k in kernels) != (launches[k] > 0):
                    raise AssertionError(f"{name}: {k} launched "
                                         f"{launches[k]} times")
            if name == "discrete32" and (
                    launches["log_product"] != 168 * n_props
                    or launches["log_marginalize"] != 48 * n_props):
                raise AssertionError(f"{name}: {launches} in {n_props} "
                                     f"propagations, expected 168 and 48 "
                                     f"per propagation")
            if launches["cg_weak_marg"] and launches["cg_weak_marg"] < n_props:
                raise AssertionError(f"{name}: cg_weak_marg launched "
                                     f"{launches['cg_weak_marg']} times in "
                                     f"{n_props} propagations")
            if any(r["launches"][k] for r in runs["einsum"] for k in total):
                raise AssertionError(f"{name}: the plain run launched "
                                     f"kernels")
            errs = _compare_serving(name, cu, ei)
            qps = {b: [r["qps"] for r in runs[b]] for b in runs}
            log(f"{name}: {len(schemas)} schemas x B={SERVE_B} x "
                f"{SERVE_FLUSHES} flushes = {n_props} propagations; launches "
                f"{launches}; cuda vs plain max |d posterior| "
                f"{errs['post']:.3e} (tol {POST_ATOL}), |d logZ| "
                f"{errs['logz']:.3e} (tol {LOGZ_TOL_REL}(1+|logZ|)), "
                f"|d mean/var| {errs['moments']:.3e} (tol "
                f"{MOMENT_TOL_REL}(1+|plain|))")
            log(f"{name}: queries/s (plain, cuda, cuda, plain) "
                f"{qps['einsum'][0]} {qps['cuda'][0]} {qps['cuda'][1]} "
                f"{qps['einsum'][1]}; peak GB cuda {cu['peak_gb']:.4f} plain "
                f"{ei['peak_gb']:.4f}; card {card}")
            prof = {b: profile_flush(bn, b, dev, flushes[0], len(schemas))
                    for b in ("cuda", "einsum")}
            log(f"{name}: profiled flush of {len(schemas)} x {SERVE_B} "
                f"queries (profiler on) {prof}")

        # shrink-style evidence reduction on the largest clique belief of the
        # discrete network (the algebra layer's entry to evidence_select)
        bn = cases[0][1]
        ev = _draw_queries(dev, bn, [("D31",)], ("D0",), seed=2)[0]
        eng = JunctionTreeEngine(bn, device=dev)
        eng.set_evidence({"D31": np.array([e["D31"] for _, e in ev])})
        eng.run_inference()
        ci = max(range(len(eng._scopes)), key=lambda i: eng._beliefs[i].numel())
        scope = eng._scopes[ci]
        belief = F.Factor(scope, tuple(4 for _ in scope), eng._beliefs[ci])
        idx = torch.randint(0, 4, (SERVE_B,), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(3))
        factor_ops.reset_launches()
        got = F.reduce_evidence(belief, scope[-1], idx, backend="cuda")
        torch.cuda.synchronize()
        total["evidence_select"] += factor_ops.LAUNCHES["evidence_select"]
        exp = F.reduce_evidence(belief, scope[-1], idx, backend="einsum")
        if not torch.equal(got.logp, exp.logp) or \
                factor_ops.LAUNCHES["evidence_select"] != 1:
            raise AssertionError("reduce_evidence: cuda and plain differ")
        log(f"reduce_evidence: clique {scope} [{SERVE_B}, "
            f"{tuple(belief.logp.shape[1:])}] clamped on {scope[-1]}: same "
            f"bits as the plain path")

        # exact posteriors of the fitted nb_mixed model vs posterior_z
        model, queries, z = fitted["nb_mixed"]
        nq = 1 << 16
        sub = _batch(queries.xc[:nq], queries.xd[:nq])
        factor_ops.reset_launches()
        t0 = time.perf_counter()
        pe = model.posterior_exact(sub)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        for k in total:
            total[k] += factor_ops.LAUNCHES[k]
        if not factor_ops.LAUNCHES["log_product"]:
            raise AssertionError("posterior_exact launched no kernel")
        pp = model.posterior_exact(sub, backend="einsum")
        d_z = float((pe - z[:nq]).abs().max())
        d_p = float((pe - pp).abs().max())
        log(f"posterior_exact(nb_mixed, {nq} queries): {secs:.3f} s; "
            f"|exact - posterior_z| {d_z:.3e} (tol {EXACT_VS_VMP_ATOL}); "
            f"|cuda - plain| {d_p:.3e} (tol {POST_ATOL})")
        if tuple(pe.shape) != tuple(z[:nq].shape) or not bool(
                torch.isfinite(pe).all()):
            raise AssertionError(f"posterior_exact bad: {tuple(pe.shape)}")
        if d_z > EXACT_VS_VMP_ATOL or d_p > POST_ATOL:
            raise AssertionError("posterior_exact disagrees")
    finally:
        rec.close()
    return total, rec.largest


def _serve(bn, backend, dev, flushes, schemas, cont):
    """Serve every flush through a fresh engine; returns results, launch
    counts, queries/s and the posterior moments of ``cont`` for the first
    schema's last batch."""
    import torch

    from repro_torch.infer_exact import JunctionTreeEngine
    from repro_torch.kernels import factor_ops
    from repro_torch.serve.engine import PGMQueryEngine

    eng = PGMQueryEngine(bn, mode="exact", backend=backend, device=dev,
                         pad_pow2=True)
    for t, ev in flushes[0][:: SERVE_B]:       # warm-up: one per schema
        eng.submit(t, ev)
    eng.flush()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    factor_ops.reset_launches()                # counts of this run only
    t0 = time.perf_counter()
    results = []
    for qs in flushes:
        sub = [eng.submit(t, ev) for t, ev in qs]
        eng.flush()
        results.extend(sub)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    moments = []
    if cont:
        jt = JunctionTreeEngine(bn, backend=backend, device=dev)
        last = [ev for _, ev in flushes[-1][:SERVE_B]]
        jt.set_evidence({k: np.array([e[k] for e in last])
                         for k in schemas[0]})
        jt.run_inference()
        for c in cont:
            if c not in schemas[0]:
                moments.extend(jt.posterior_mean_var(
                    bn.dag.variables.by_name(c)))
        torch.cuda.synchronize()
    return dict(results=results, qps=len(results) / secs,
                launches=dict(factor_ops.LAUNCHES), moments=moments,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def profile_flush(bn, backend, dev, qs, n_props):
    """torch.profiler over one warm flush: device busy time (sum of kernel
    durations), its share of the wall time, device kernels per propagation
    and the share of device time in this repo's factor kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import PGMQueryEngine

    eng = PGMQueryEngine(bn, mode="exact", backend=backend, device=dev,
                         pad_pow2=True)

    def run():
        for t, ev in qs:
            eng.submit(t, ev)
        eng.flush()
        torch.cuda.synchronize()

    run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_us = 1e6 * (time.perf_counter() - t0)
    ours = ("log_product", "log_marginalize", "evidence_select",
            "cg_weak_marg")
    busy = mine = 0.0
    n = 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dur = ev.time_range.elapsed_us()
            busy += dur
            n += 1
            if any(k in ev.name for k in ours):
                mine += dur
    return dict(flush_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
                idle_share=max(0.0, 1.0 - busy / wall_us),
                device_ops_per_propagation=n / n_props,
                kernel_share_of_device=mine / busy if busy else 0.0)


def _compare_serving(name, cu, ei):
    post = logz = moments = 0.0
    for a, b in zip(cu["results"], ei["results"]):
        if a.result.shape != b.result.shape or not np.isfinite(
                a.result).all() or not np.isfinite(a.log_evidence):
            raise AssertionError(f"{name}: bad result for query {a.qid}")
        post = max(post, float(np.abs(a.result - b.result).max()))
        d = abs(a.log_evidence - b.log_evidence) / (1 + abs(b.log_evidence))
        logz = max(logz, d)
    for a, b in zip(cu["moments"], ei["moments"]):
        moments = max(moments, float(((a - b).abs() / (1 + b.abs())).max()))
    if post > POST_ATOL or logz > LOGZ_TOL_REL or moments > MOMENT_TOL_REL:
        raise AssertionError(f"{name}: cuda and plain backends differ: "
                             f"{post} {logz} {moments}")
    return dict(post=post, logz=logz, moments=moments)


def factor_kernel_phase(dev, largest):
    """The four factor kernels at the largest shapes the serving phase
    launched, against their plain versions, with -inf entries, all -inf
    rows and dead mixture rows."""
    import torch

    from repro_torch.kernels import factor_ops, ref

    g = torch.Generator(device=dev).manual_seed(4)
    rows = {}

    def table(shape):
        x = torch.randn(*shape, generator=g, device=dev)
        x[torch.rand(*shape, generator=g, device=dev) < 0.25] = float("-inf")
        x.view(-1, shape[-1])[0] = float("-inf")     # an all -inf row
        return x

    def record(name, kern, plain, library, check, nbytes, nops):
        got, again = kern(), kern()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{name}: two launches differ in bits")
        err = check(got, plain())
        b_ms, b_by = bound(nbytes, nops)
        rows[name] = dict(
            name=name, route="cuda", source=FACTOR_SOURCE,
            replaces=REPLACES[name], launches=0, max_abs_err=err,
            ms=time_ms(kern), plain_ms=time_ms(plain), bound_ms=b_ms,
            bound_by=b_by,
            library_ms=None if library is None else time_ms(library))
        log(f"kernel {name} at {largest[name]}: max_abs_err {err:.3e}, "
            f"bitwise repeatable; ms {rows[name]['ms']:.4f} plain_ms "
            f"{rows[name]['plain_ms']:.4f} library_ms "
            f"{rows[name]['library_ms']} bound_ms {b_ms:.5f} ({b_by})")

    def same_bits(got, exp):
        for a, b in zip(got, exp):
            if not torch.equal(a, b):
                raise AssertionError("kernel and plain differ in bits")
        return 0.0

    def lse_close(a, b):
        if not torch.equal(torch.isneginf(a), torch.isneginf(b)):
            raise AssertionError("-inf pattern differs")
        fin = torch.isfinite(b)
        d = (a[fin] - b[fin]).abs()
        if bool((d > LSE_TOL * (1 + b[fin].abs())).any()):
            raise AssertionError(f"log-mass differs by {float(d.max())}")
        return float(d.max()) if d.numel() else 0.0

    (B, M, N), _ = largest["log_product"]
    a, b = table((B, M, N)), torch.randn(B, N, generator=g, device=dev)
    record("log_product", lambda: [factor_ops.log_product(a, b)],
           lambda: [ref.log_product_ref(a, b)],
           lambda: [a + b[:, None, :]], same_bits,
           4 * (2 * B * M * N + B * N), B * M * N)
    del a, b

    (B, M, N), = largest["log_marginalize"]
    x = table((B, M, N))
    record("log_marginalize", lambda: [factor_ops.log_marginalize(x)],
           lambda: [ref.log_marginalize_ref(x)],
           lambda: [torch.logsumexp(x, -1)],
           lambda got, exp: lse_close(got[0], exp[0]),
           4 * (B * M * N + B * M), 4 * B * M * N)
    del x

    (B, M, N), (_,) = largest["evidence_select"]
    x = table((B, M, N))
    idx = torch.randint(0, N, (B,), generator=g, device=dev)
    sel = idx[:, None, None].expand(B, M, 1)
    record("evidence_select", lambda: [factor_ops.evidence_select(x, idx)],
           lambda: [ref.evidence_select_ref(x, idx)],
           lambda: [torch.gather(x, 2, sel)[..., 0]], same_bits,
           4 * (2 * B * M + B), 0)
    del x

    (B, M, N), (_, _, _, n), _ = largest["cg_weak_marg"]
    lw = table((B, M, N))
    mu = torch.randn(B, M, N, n, generator=g, device=dev)
    q = torch.randn(B, M, N, n, n, generator=g, device=dev)
    sg = q @ q.transpose(-1, -2) + 0.5 * torch.eye(n, device=dev)

    def weak_close(got, exp):
        err = lse_close(got[0], exp[0])
        for x_, y_ in zip(got[1:], exp[1:]):
            torch.testing.assert_close(x_, y_, atol=WEAK_ATOL, rtol=WEAK_RTOL)
            err = max(err, float((x_ - y_).abs().max()))
        if float(got[1][0, 0].abs().max()) or not torch.equal(
                got[2][0, 0], torch.eye(n, device=dev)):
            raise AssertionError("cg_weak_marg: dead row is not (-inf, 0, I)")
        return err

    e = n * n
    record("cg_weak_marg", lambda: factor_ops.cg_weak_marg(lw, mu, sg),
           lambda: ref.cg_weak_marg_ref(lw, mu, sg), None, weak_close,
           4 * (B * M * N * (1 + n + e) + B * M * (1 + n + e)),
           B * M * N * (2 + 3 * n + 4 * e))
    return rows



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
    total, fitted = main_path_phase(card)
    serve_total, largest = exact_serving_phase(dev, card, fitted)
    total.update(serve_total)
    rows.update(factor_kernel_phase(dev, largest))
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
