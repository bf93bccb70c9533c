"""Serving driver: ``python -m repro_torch.launch.serve`` (counterpart of
``repro.launch.serve``).

* ``--arch <id>`` -- the LM path: a reduced model (random weights from
  ``--seed``, or a JAX checkpoint with ``--ckpt``) drains a batch of
  synthetic requests through the lock-step ``DecodeEngine``.  Runs on the
  CUDA card unless ``--device cpu`` is given.  Every family but ``audio``
  (whisper), which ``DecodeEngine`` refuses: its requests carry no
  encoder frames.

* default (no ``--arch``) -- the async PGM serving tier
  (:class:`repro_torch.serve.queue.AsyncPGMServer`) under Poisson offered
  load: a synthetic discrete network (``--mode exact``, ``--vars`` nodes) or
  a GaussianMixture fitted on a synthetic stream and served as q(Z | x)
  (``--mode vmp``), exponential inter-arrival times at ``--load``
  queries/s for ``--duration`` seconds, per-request deadlines from
  ``--deadline-ms``, ``--replicas`` workers and an optional hot model swap
  half-way (``--swap``).  Progress and the latency summary go through
  ``repro_torch.obs.log`` (stderr, and ``log`` events when obs is on).

    python -m repro_torch.launch.serve --arch zamba2-1.2b --device cpu
    python -m repro_torch.launch.serve --arch mixtral-8x7b --device cpu
    python -m repro_torch.launch.serve --mode exact --duration 3 --swap
"""

from __future__ import annotations

import argparse
import time


def _serve_lm(args) -> int:
    import numpy as np
    import torch

    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.nn import transformer as T
    from repro_torch.serve.engine import DecodeEngine, Request

    cfg = get_config(args.arch).reduced()
    dev = resolve_device(args.device)
    if args.ckpt:
        params = convert.load_lm_checkpoint(args.ckpt, cfg, dev)
    else:
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        params = T.init_model(gen, cfg)

    engine = DecodeEngine(params, cfg, args.batch, args.capacity,
                          seed=args.seed)
    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, rng.integers(4, 12)).tolist()
        engine.submit(Request(rid=rid, prompt=prompt, max_new=args.max_new))

    t0 = time.perf_counter()
    steps = 0
    while True:
        active = engine.step()
        steps += 1
        if active == 0 and not engine.queue:
            break
        if steps > 100_000:
            raise RuntimeError("serve loop did not drain")
    dt = time.perf_counter() - t0
    toks = args.requests * args.max_new
    print(f"[serve] {args.requests} requests, {toks} tokens in {dt:.1f}s "
          f"({toks / dt:,.0f} tok/s, batch={args.batch}, {steps} steps, "
          f"device {dev})", flush=True)
    return 0


def _serve_pgm(args) -> int:
    import numpy as np

    from repro_torch import obs
    from repro_torch.data import synthetic as syn
    from repro_torch.device import resolve_device
    from repro_torch.serve.queue import AsyncPGMServer

    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    if args.mode == "vmp":
        from repro_torch.pgm_models import GaussianMixture

        s, _, _ = syn.gmm_stream(512, 3, 4, seed=args.seed)
        model = GaussianMixture(s.attributes, n_states=3, device=dev)
        model.update_model(s)
        xs = np.asarray(s.collect().xc)

        def make_query():
            row = xs[rng.integers(len(xs))]
            return "Z", {f"X{i}": float(row[i]) for i in range(xs.shape[1])}
    else:
        bn = syn.random_discrete_bn(args.vars, card=2, max_parents=2,
                                    seed=args.seed, device=dev)
        names = [v.name for v in bn.order]
        model = bn
        # a few evidence schemas, so buckets coalesce and flush apart
        schemas = [names[:1], names[1:3], names[:2]]

        def make_query():
            sc = schemas[rng.integers(len(schemas))]
            return names[-1], {n: float(rng.integers(2)) for n in sc}

    server = AsyncPGMServer(model, mode=args.mode, max_batch=args.max_batch,
                            max_delay_ms=args.max_delay_ms,
                            default_deadline_ms=args.deadline_ms,
                            replicas=args.replicas, device=dev)
    obs.log(f"[serve] async PGM tier up: mode={args.mode} "
            f"load={args.load}/s deadline={args.deadline_ms}ms "
            f"replicas={args.replicas} device={dev}", component="serve")

    tickets = []
    swapped = False
    t0 = time.monotonic()
    end = t0 + args.duration
    try:
        while time.monotonic() < end:
            target, evidence = make_query()
            tickets.append(server.submit(target, evidence,
                                         deadline_ms=args.deadline_ms))
            if (args.swap and not swapped
                    and time.monotonic() - t0 > args.duration / 2):
                if args.mode == "exact":
                    bn2 = syn.random_discrete_bn(args.vars, card=2,
                                                 max_parents=2,
                                                 seed=args.seed + 1,
                                                 device=dev)
                    info = server.swap_model(bn2)
                else:
                    model.update_model(xs[:256])
                    info = server.swap_model(model)
                obs.log(f"[serve] hot swap v{info['old_version']}->"
                        f"v{info['new_version']} "
                        f"warmed={info['warmed_plans']} "
                        f"drained={info['drained']}", component="serve")
                swapped = True
            # Poisson arrivals at the offered load
            time.sleep(rng.exponential(1.0 / args.load))
    finally:
        server.stop()

    for t in tickets:
        t.result(timeout=60)        # all served: stop() drained the queue
    lat_ms = np.array([(t.done_s - t.submitted_s) * 1e3 for t in tickets])
    st = server.stats()
    dt = time.monotonic() - t0
    n = len(tickets)
    p50, p99 = (float(np.percentile(lat_ms, q)) for q in (50, 99))
    obs.log(f"[serve] {n} queries in {dt:.1f}s "
            f"({n / dt:,.0f} q/s achieved vs {args.load}/s offered), "
            f"p50 {p50:.2f}ms p99 {p99:.2f}ms, "
            f"deadline misses {st['deadline_misses']}/{n}, "
            f"flushes {st['flushes']}, "
            f"plan hit-rate {st['plans']['hit_rate']:.2f}",
            component="serve", queries=n, seconds=dt, qps=n / dt,
            offered=args.load, p50_ms=p50, p99_ms=p99,
            deadline_misses=st["deadline_misses"],
            flushes=st["flushes"], plan_stats=st["plans"])
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None,
                    help="LM arch id (omit for the async PGM tier)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--capacity", type=int, default=256)
    ap.add_argument("--ckpt", default=None,
                    help="a checkpoint written by repro.train.checkpoint")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    # async PGM tier knobs
    ap.add_argument("--mode", default="exact", choices=["exact", "vmp"])
    ap.add_argument("--vars", type=int, default=6,
                    help="exact mode: synthetic network size")
    ap.add_argument("--load", type=float, default=200.0,
                    help="offered load, queries/s (Poisson)")
    ap.add_argument("--duration", type=float, default=3.0,
                    help="offered-load window, seconds")
    ap.add_argument("--deadline-ms", type=float, default=50.0,
                    help="per-request deadline")
    ap.add_argument("--max-delay-ms", type=float, default=5.0,
                    help="micro-batch coalescing window")
    ap.add_argument("--max-batch", type=int, default=32,
                    help="micro-batch size trigger")
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--swap", action="store_true",
                    help="hot-swap the model mid-run")
    args = ap.parse_args(argv)
    if args.arch is not None:
        return _serve_lm(args)
    return _serve_pgm(args)


if __name__ == "__main__":
    raise SystemExit(main())
