"""Serving driver: ``python -m repro_torch.launch.serve`` (counterpart of
``repro.launch.serve``).

* ``--arch <id>`` -- the LM path: a reduced model (random weights from
  ``--seed``, or a JAX checkpoint with ``--ckpt``) drains a batch of
  synthetic requests through the lock-step ``DecodeEngine``.  Runs on the
  CUDA card unless ``--device cpu`` is given.

* default (no ``--arch``) -- the async PGM serving tier of the JAX package;
  not ported yet (ROADMAP Queue 1), so it raises ``NotImplementedError``.

    python -m repro_torch.launch.serve --arch zamba2-1.2b --device cpu
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None,
                    help="LM arch id (omit for the PGM tier, not ported)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--capacity", type=int, default=256)
    ap.add_argument("--ckpt", default=None,
                    help="a checkpoint written by repro.train.checkpoint")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    args = ap.parse_args(argv)
    if args.arch is None:
        raise NotImplementedError(
            "the async PGM serving tier (repro.serve.queue.AsyncPGMServer) "
            "is not ported yet: ROADMAP Queue 1")
    return _serve_lm(args)


if __name__ == "__main__":
    raise SystemExit(main())
