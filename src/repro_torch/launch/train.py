"""Training driver: ``python -m repro_torch.launch.train --arch <id>
[options]`` (counterpart of ``repro.launch.train``).

Runs the reduced config by default and the full one with ``--full``;
random weights from ``--seed``, a Markov corpus from the same seed, AdamW
(``--optimizer adamw``) or streaming-VB (``--optimizer vb``) steps, the
loss-drift monitor, and the parameters to ``--ckpt`` at the end (the
reference's npz format).  Runs on the CUDA card unless ``--device cpu`` is
given.

``--data-shards D --model-shards M`` with D M > 1 trains on a ``("data",
"model")`` mesh (FSDP over data x tensor parallel over model,
``sharding.param_specs(mode="train")``): one process a rank, launched by
``torchrun --nproc-per-node D*M`` (ranks, world size and rendezvous from
its environment; NCCL, one card a rank by ``LOCAL_RANK``, or gloo with
``--device cpu``).  It raises unless the world has D M ranks.  Every rank
draws its blocks of the same weights from ``--seed`` and feeds the same
batches; rank 0 logs and writes ``--ckpt`` (the gathered whole model).

    python -m repro_torch.launch.train --arch granite-3-2b --device cpu \\
        --steps 4 --batch 2 --seq 32
    python -m repro_torch.launch.train --arch zamba2-1.2b --full \\
        --batch 2 --seq 4096 --steps 3      # on the card, full width
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch granite-3-2b --full --data-shards 2 --model-shards 2
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--optimizer", choices=["adamw", "vb"], default="adamw")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="full config")
    ap.add_argument("--data-shards", type=int, default=1)
    ap.add_argument("--model-shards", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--corpus-size", type=int, default=200_000)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default, raises without a card) or cpu")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from repro_torch import obs
    from repro_torch.bayes.drift import LossDriftMonitor
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream, markov_sequence_fast
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.nn import transformer as T
    from repro_torch.sharding import init_sharded
    from repro_torch.train import checkpoint as ck
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as ts

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    sh, own_group = T.NO_SHARD, False
    if args.data_shards * args.model_shards > 1:
        cpu = args.device is not None and torch.device(args.device).type \
            == "cpu"
        if not dist.is_initialized():
            if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
                raise ValueError(
                    f"--data-shards {args.data_shards} --model-shards "
                    f"{args.model_shards}: launch one process a rank, e.g. "
                    f"torchrun --nproc-per-node "
                    f"{args.data_shards * args.model_shards}")
            dist.init_process_group("gloo" if cpu else "nccl")
            own_group = True
        if not cpu:
            args.device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
            torch.cuda.set_device(torch.device(args.device))
        sh = T.Shardings(mesh=make_lm_mesh(args.data_shards,
                                           args.model_shards,
                                           "cpu" if cpu else "cuda"))
    dev = resolve_device(args.device)
    lead = sh.mesh is None or dist.get_rank() == 0

    def log(msg, **kw):
        if lead:
            obs.log(msg, component="train", **kw)

    log(f"[train] arch={cfg.name} params~{cfg.n_params()/1e6:.1f}M "
        f"optimizer={args.optimizer} device={dev}"
        + (f" mesh={args.data_shards}x{args.model_shards}" if sh.mesh
           is not None else ""),
        arch=cfg.name, n_params=cfg.n_params(), optimizer=args.optimizer)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = T.init_model(gen, cfg, trainable=True) if sh.mesh is None \
        else init_sharded(gen, cfg, sh, "train", trainable=True)
    corpus = markov_sequence_fast(args.corpus_size, cfg.vocab, seed=args.seed)
    enc_stub = ((cfg.encoder.enc_len, cfg.d_model) if cfg.is_encdec else None)
    stream = TokenStream(corpus, args.batch, args.seq, enc_stub=enc_stub,
                         device=dev)
    lr_fn = opt.cosine_schedule(args.lr, args.steps // 10, args.steps)
    monitor = LossDriftMonitor.create()

    if args.optimizer == "adamw":
        state = ts.init_train_state(params)

        def step(state, batch):
            return ts.train_step(state, batch, cfg, sh, lr_fn=lr_fn)
    else:
        state = ts.init_vb_state(params)

        def step(state, batch):
            return ts.vb_train_step(state, batch, cfg, sh,
                                    n_total=float(args.corpus_size))

    t0 = time.time()
    losses = []
    for i, batch in enumerate(stream.batches(args.steps)):
        state, metrics = step(state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        monitor, drifted = monitor.observe(loss)
        if i % args.log_every == 0 or i == args.steps - 1:
            tps = args.batch * args.seq * (i + 1) / (time.time() - t0)
            log(f"[train] step={i:5d} loss={loss:.4f} tok/s={tps:,.0f}"
                + (" DRIFT" if bool(drifted) else ""),
                step=i, loss=loss, tok_s=tps, drifted=bool(drifted))
    log(f"[train] done: first={losses[0]:.3f} last={losses[-1]:.3f} "
        f"log(V)={np.log(cfg.vocab):.3f}",
        first_loss=losses[0], last_loss=losses[-1])
    if args.ckpt:
        ck.save_lm(args.ckpt, state.params, sh.mesh)
        log(f"[train] checkpoint -> {args.ckpt}", ckpt=args.ckpt)
    if own_group:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
