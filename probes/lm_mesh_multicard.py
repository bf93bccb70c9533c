"""The LM mesh paths across the four cards of one host.

Spawns one process a card, joined in one NCCL world over a ``FileStore``.

1. mixtral-8x7b at full width and depth (random weights from seed 0,
   fp32, 46.7B parameters: no one card holds them) over a ``("data",
   "model")`` 1 x 4 mesh: each rank draws its blocks a layer at a time
   (``sharding.init_sharded``, serve specs: two whole experts and 8 of 32
   q heads a card, the vocabulary split four ways).  A prefill of
   ``--batch`` x ``--seq`` through ``forward(sh=)``, then ``--steps``
   teacher-forced decode steps through ``decode_step(sh=)`` (each ring's
   sequence split over the cards).  Reported: prefill tokens/s and
   generated tokens/s (host clock around synchronised work, after a
   warm-up), peak memory a card.  Checks: every rank holds the same
   logits bits; chip_smoke phase 16's decode check on the mesh, at its
   depth (4 layers): 256 teacher-forced decode steps against a forward
   that drops no pair (capacity factor E / K), argmax > 0.85.  At full
   depth, ``FULL_CHECK`` teacher-forced decode steps (8 x 64 = 512
   positions) against the same no-drop forward, held to
   the model's own floor: the no-drop forward on its two attention routes
   ("cuda", the kernel; "einsum", the plain version) against each other on
   the same positions -- 32 bf16 layers of random weights carry any
   rounding difference to the logits.  Decode must agree with the forward
   at least as often as the floor less ``_margin`` (three standard errors
   of the difference of two shares over those positions), or as phase
   16's bar where that is lower (``--cpu``: one attention route, so the
   floor is 1).
2. granite-3-2b at full width and depth on a 2 x 2 mesh (FSDP over data x
   tensor parallel over model, train specs): AdamW steps of a global batch
   of ``--train-batch`` x ``--train-seq`` tokens (``train_step(sh=)``).
   Reported: step ms (CUDA events after a barrier, after a warm-up step),
   training tokens/s, peak memory a card.  Check: every gradient within
   0.1 relative L2 of one card's mesh-free gradients of the same global
   batch (rank 0 computes them on its card first), the loss within 1e-3.

    python3 probes/lm_mesh_multicard.py           # four NCCL ranks
    python3 probes/lm_mesh_multicard.py --cpu     # gloo ranks on the CPU,
                                                  # reduced configs

Before them, the world's ``all_reduce`` rate: 256 MB of fp32 five times
after a warm-up (CUDA events on rank 0; bus GB/s = 2 (n - 1) / n bytes
over the time), and ``nvidia-smi topo -m`` on rank 0: the two runs' times
depend on the links between the cards.

Prints each card's name and power limit, one line a run, writes the
numbers to ``chiprun_out/lm_mesh_multicard.json`` and exits non-zero if a
check fails or the host shows fewer than four cards.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import hashlib
import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
WORLD = 4
DECODE_ARGMAX_MIN = 0.85       # chip_smoke phase 16's bar
FULL_CHECK = (8, 64)           # full depth: batch x teacher-forced steps
GRAD_REL = 0.1                 # chip_smoke phase 18's route bar
LOSS_RTOL = 1e-3


def _cfg(arch, cpu):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return cfg.reduced() if cpu else cfg


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak_gb(dev):
    import torch

    return torch.cuda.max_memory_allocated(dev) / 1e9 \
        if dev.type == "cuda" else 0.0


def _mixtral(args, dev, sh, dist):
    import torch

    from repro_torch.nn import transformer as T
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding import init_sharded

    cfg = _cfg("mixtral-8x7b", args.cpu)
    t0 = time.perf_counter()
    loc = init_sharded(torch.Generator(device=dev).manual_seed(0), cfg, sh,
                       "serve")
    _sync(dev)
    init_s = time.perf_counter() - t0
    local_gb = sum(p.numel() * p.element_size()
                   for p in loc.parameters()) / 1e9
    toks = torch.randint(0, cfg.vocab, (args.batch, args.seq), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    out = dict(init_s=init_s, local_weights_gb=local_gb,
               experts_a_card=tuple(loc["blocks"][0]["moe"]["w_gate"].shape))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        def prefill():
            return T.forward(loc, toks, cfg, sh, remat=False).logits

        prefill()                              # warm
        secs = []
        for _ in range(2):
            dist.barrier()
            _sync(dev)
            t0 = time.perf_counter()
            lg = prefill()
            _sync(dev)
            secs.append(time.perf_counter() - t0)
        full = T.gather_logits(loc, lg, cfg, sh, args.batch).cpu()
        out["logits_sha256"] = hashlib.sha256(
            full.numpy().tobytes()).hexdigest()
        del lg, full
        out["prefill_s"] = secs
        out["prefill_tokens_s"] = [args.batch * args.seq / s for s in secs]
        cap = max(args.steps, 8)
        st = T.init_decode_state(loc, cfg, args.batch, cap, sh=sh)
        T.decode_step(loc, st, toks[:, :1], cfg, sh=sh)   # warm
        st = T.init_decode_state(loc, cfg, args.batch, cap, sh=sh)
        C.reset_collectives()
        dist.barrier()
        _sync(dev)
        t0 = time.perf_counter()
        for t in range(args.steps):
            lg, st = T.decode_step(loc, st, toks[:, t:t + 1], cfg, sh=sh)
        _sync(dev)
        dsecs = time.perf_counter() - t0
        out["decode_s"] = dsecs
        out["generated_tokens_s"] = args.batch * args.steps / dsecs
        out["decode_collectives_a_step"] = {
            k: v["calls"] / args.steps for k, v in C.collectives().items()}
        del st, lg
        out["peak_gb"] = _peak_gb(dev)
        # full depth: decode against the no-drop forward, beside the
        # forward's two routes against each other, on the same positions
        tf = torch.randint(0, cfg.vocab, FULL_CHECK, device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(2))
        dec = _teacher_forced(loc, tf, cfg, sh)
        fwd = {b: _no_drop_forward(loc, tf, cfg, sh, b)
               for b in ("cuda", "einsum")}
        n = tf.numel()
        agree = _agree(dec, fwd["cuda"])
        floor = _agree(fwd["cuda"], fwd["einsum"])
        bar = min(DECODE_ARGMAX_MIN, floor - _margin(floor, n))
        out["full_check"] = dict(
            positions=n, decode_vs_prefill_argmax=agree,
            cuda_vs_einsum_forward_argmax=floor, margin=_margin(floor, n),
            bar=bar, ok=agree >= bar)
        del loc, dec, fwd
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        # phase 16's check, on the mesh at its depth
        cfg4 = dataclasses.replace(cfg, n_layers=min(4, cfg.n_layers))
        loc = init_sharded(torch.Generator(device=dev).manual_seed(0), cfg4,
                           sh, "serve")
        t1 = toks[:1, :args.check_steps]
        out["check_decode_vs_prefill_argmax"] = _agree(
            _teacher_forced(loc, t1, cfg4, sh),
            _no_drop_forward(loc, t1, cfg4, sh, "cuda"))
        del loc
    return out


def _link_rate(dev, dist, world):
    """(ms, bus GB/s) of an all_reduce of 256 MB of fp32 over the world."""
    import torch

    if dev.type != "cuda":
        return None
    x = torch.ones(64 << 20, device=dev)
    for _ in range(2):
        dist.all_reduce(x)
    torch.cuda.synchronize(dev)
    dist.barrier()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        dist.all_reduce(x)
    end.record()
    torch.cuda.synchronize(dev)
    ms = start.elapsed_time(end) / 5
    return ms, 2 * (world - 1) / world * x.numel() * 4 / (ms / 1e3) / 1e9


def _agree(a, b):
    return float((a.argmax(-1) == b.argmax(-1)).float().mean())


def _margin(floor, n):
    """Three standard errors of the difference of two agreement shares
    near ``floor`` over ``n`` positions, and at least two positions."""
    return max(3 * (2 * floor * (1 - floor) / n) ** 0.5, 2 / n)


def _teacher_forced(loc, toks, cfg, sh):
    """Whole logits [B, S, V] of S decode steps fed ``toks``."""
    import torch

    from repro_torch.nn import transformer as T

    B, S = toks.shape
    st = T.init_decode_state(loc, cfg, B, max(S, 8), sh=sh)
    out = []
    for t in range(S):
        lg, st = T.decode_step(loc, st, toks[:, t:t + 1], cfg, sh=sh)
        out.append(lg[:, 0])
    return torch.stack(out, 1)


def _no_drop_forward(loc, toks, cfg, sh, backend):
    """The whole logits of a forward whose capacity drops no pair
    (capacity factor E / K: an expert holds every token)."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.nn import transformer as T

    E, K = cfg.moe.n_experts, cfg.moe.top_k
    no_drop = dataclasses.replace(cfg, moe=MoEConfig(E, K, E / K))
    if toks.device.type == "cpu":
        backend = "einsum"
    return T.gather_logits(loc, T.forward(loc, toks, no_drop, sh,
                                          backend=backend,
                                          remat=False).logits,
                           cfg, sh, toks.shape[0])


def _granite(args, dev, sh, dist, rank):
    import torch

    from repro_torch.data.tokens import TokenStream, markov_sequence_fast
    from repro_torch.nn import transformer as T
    from repro_torch.sharding import gather_tensor, init_sharded
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as TS

    cfg = _cfg("granite-3-2b", args.cpu)
    batches = list(TokenStream(markov_sequence_fast(
        200_000, cfg.vocab, seed=0), args.train_batch, args.train_seq,
        device=dev).batches(1 + args.train_steps))
    out = {}
    ref = None
    if rank == 0:                  # one card, mesh-free, the global batch
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        lm = T.init_model(torch.Generator(device=dev).manual_seed(0), cfg,
                          trainable=True)
        (_, (loss, _)), grads = TS.grads_of(lm, batches[0], cfg)
        ref = ({k: g.cpu() for k, g in grads.items()}, float(loss))
        out["one_card_peak_gb"] = _peak_gb(dev)
        del lm, grads
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    dist.barrier()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    loc = init_sharded(torch.Generator(device=dev).manual_seed(0), cfg, sh,
                       "train", trainable=True)
    named = dict(loc.named_parameters())
    (_, (loss, _)), grads = TS.grads_of(loc, batches[0], cfg, sh=sh)
    worst = (0.0, "")
    for k, g in grads.items():
        full = gather_tensor(g, named[k].shard_spec, sh.mesh)
        if ref is not None:
            e = ref[0][k].double()
            rel = float((full.cpu().double() - e).norm() / e.norm())
            worst = max(worst, (rel, k))
        del full
    del grads
    if ref is not None:
        out.update(worst_grad_rel=worst[0], worst_grad=worst[1],
                   loss=float(loss), one_card_loss=ref[1])
    state = TS.init_train_state(loc)
    lr_fn = opt.cosine_schedule(5e-4, 1, 100)
    ms, losses = [], []
    for i, b in enumerate(batches[1:]):
        dist.barrier()
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        state, m = TS.train_step(state, b, cfg, sh, lr_fn=lr_fn)
        if dev.type == "cuda":
            end.record()
            torch.cuda.synchronize(dev)
            step_ms = start.elapsed_time(end)
        else:
            step_ms = 1e3 * (time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        if i:                              # the first step warms up
            ms.append(step_ms)
    tokens = args.train_batch * args.train_seq
    out.update(step_ms=ms, tokens_s=[tokens / (x / 1e3) for x in ms],
               losses=losses, peak_gb=_peak_gb(dev),
               local_params=sum(p.numel() for p in loc.parameters()))
    return out


def _rank(rank, world, store, outp, args):
    sys.path[:0] = [SRC, ROOT]
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.nn import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    if args.cpu:
        dev, kind = torch.device("cpu"), "cpu"
        torch.set_num_threads(1)
    else:
        dev, kind = torch.device("cuda", rank), "cuda"
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo" if args.cpu else "nccl",
                            init_method=f"file://{store}", world_size=world,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=900))
    try:
        names = ("data", "model")
        m14 = init_device_mesh(kind, (1, world), mesh_dim_names=names)
        m22 = init_device_mesh(kind, (2, world // 2), mesh_dim_names=names)
        res = {"link": _link_rate(dev, dist, world)}
        if rank == 0 and not args.cpu:
            res["topo"] = subprocess.run(["nvidia-smi", "topo", "-m"],
                                         capture_output=True,
                                         text=True).stdout
        res["mixtral"] = _mixtral(args, dev, T.Shardings(mesh=m14), dist)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        res["granite"] = _granite(args, dev, T.Shardings(mesh=m22), dist,
                                  rank)
        torch.save(res, outp)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU, reduced configs")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--check-steps", type=int, default=256,
                    help="phase 16's teacher-forced decode check, 4 layers")
    ap.add_argument("--train-batch", type=int, default=4)
    ap.add_argument("--train-seq", type=int, default=4096)
    ap.add_argument("--train-steps", type=int, default=4)
    args = ap.parse_args(argv)
    if args.cpu:
        args.seq, args.train_seq = min(args.seq, 64), min(args.train_seq, 64)
    sys.path[:0] = [SRC, ROOT]
    import torch

    card = "CPU (gloo)"
    if not args.cpu:
        if not torch.cuda.is_available():
            print("lm_mesh_multicard: no CUDA device", file=sys.stderr)
            return 1
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, check=True).stdout.strip()
        print(card, flush=True)
        if torch.cuda.device_count() < WORLD:
            print(f"lm_mesh_multicard: {torch.cuda.device_count()} cards, "
                  f"the probe needs {WORLD}", file=sys.stderr)
            return 1
        from repro_torch.kernels import build

        build.build_all()
    ctx = multiprocessing.get_context("spawn")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        outs = [os.path.join(d, f"rank{r}.pt") for r in range(WORLD)]
        procs = [ctx.Process(target=_rank, args=(
            r, WORLD, os.path.join(d, "store"), outs[r], args))
            for r in range(WORLD)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + 2400
        try:
            for p in procs:
                p.join(max(deadline - time.monotonic(), 0.1))
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
        if any(p.exitcode != 0 for p in procs):
            print(f"lm_mesh_multicard: exit codes "
                  f"{[p.exitcode for p in procs]}", file=sys.stderr)
            return 1
        res = [torch.load(o, weights_only=False) for o in outs]
    mix = [r["mixtral"] for r in res]
    gra = [r["granite"] for r in res]
    same = len({m["logits_sha256"] for m in mix}) == 1
    m0, g0 = mix[0], gra[0]
    fc = m0["full_check"]
    if res[0]["link"] is not None:
        print(f"all_reduce of 256 MB fp32 over {WORLD} cards: "
              f"{res[0]['link'][0]:.3f} ms, bus {res[0]['link'][1]:.1f} GB/s"
              f"\n{res[0].get('topo', '')}", flush=True)
    print(f"mixtral-8x7b{' (reduced)' if args.cpu else ''} over model = "
          f"{WORLD}: {m0['local_weights_gb']:.2f} GB of weights a card "
          f"(experts {m0['experts_a_card']}), drawn in {m0['init_s']:.1f} s;"
          f" prefill {args.batch} x {args.seq}: s {m0['prefill_s']}, tokens/s "
          f"{[round(x, 1) for x in m0['prefill_tokens_s']]}; {args.steps} "
          f"decode steps: {m0['decode_s']:.3f} s, generated tokens/s "
          f"{m0['generated_tokens_s']:.1f}, collectives a step "
          f"{m0['decode_collectives_a_step']}; peak GB a card "
          f"{[round(m['peak_gb'], 2) for m in mix]}; ranks "
          f"{'the same logits bits' if same else 'DIFFER'}; full depth, "
          f"{fc['positions']} teacher-forced positions: decode argmax vs the "
          f"no-drop forward {fc['decode_vs_prefill_argmax']:.4f} (>= "
          f"{fc['bar']:.4f}: the forward's own routes, cuda vs einsum, "
          f"{fc['cuda_vs_einsum_forward_argmax']:.4f} less "
          f"{fc['margin']:.4f}, or {DECODE_ARGMAX_MIN}); phase 16's check at "
          f"4 layers, "
          f"{args.check_steps} teacher-forced steps: "
          f"{m0['check_decode_vs_prefill_argmax']:.4f} (> "
          f"{DECODE_ARGMAX_MIN})", flush=True)
    lrel = abs(g0["loss"] - g0["one_card_loss"]) / abs(g0["one_card_loss"])
    print(f"granite-3-2b{' (reduced)' if args.cpu else ''} on a 2 x 2 mesh, "
          f"global batch {args.train_batch} x {args.train_seq}: AdamW step ms "
          f"{[round(x, 2) for x in g0['step_ms']]}, training tokens/s "
          f"{[round(x, 1) for x in g0['tokens_s']]}, losses "
          f"{[round(x, 5) for x in g0['losses']]}; peak GB a card "
          f"{[round(g['peak_gb'], 2) for g in gra]} (one card, mesh-free "
          f"gradients of the same batch: {g0['one_card_peak_gb']:.2f}); "
          f"worst gradient relative L2 {g0['worst_grad_rel']:.3e} "
          f"({g0['worst_grad']}; <= {GRAD_REL}); loss {g0['loss']:.6f} vs "
          f"one card {g0['one_card_loss']:.6f}", flush=True)
    rec = dict(card=card, args=vars(args), mixtral=mix, granite=gra,
               link=res[0]["link"], topo=res[0].get("topo"),
               seconds=time.perf_counter() - t0)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "lm_mesh_multicard.json"),
              "w") as f:
        json.dump(rec, f, indent=1, default=str)
    ok = (same and fc["ok"]
          and m0["check_decode_vs_prefill_argmax"] > DECODE_ARGMAX_MIN
          and g0["worst_grad_rel"] <= GRAD_REL and lrel <= LOSS_RTOL)
    print(f"lm_mesh_multicard: {'ok' if ok else 'FAILED'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
