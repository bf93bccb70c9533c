"""Rank workers of the port's LM mesh tests (``tests/test_torch_mesh.py``).

A launched rank imports only ``torch``, ``numpy`` and ``repro_torch`` (never
JAX): :func:`start` launches ``world`` processes of

    python tests/_torch_mesh_ranks.py <rank> <world> <tmp dir>

each of which joins a gloo process group through a ``FileStore`` under the
tmp dir (its own timeout on the rendezvous and on every collective), builds
the ``("data", "model")`` meshes 2 x 2, 1 x 4 and 4 x 1 and the
``("pod", "data", "model")`` mesh 2 x 1 x 2, runs every case of
:data:`CASES` on the inputs the test wrote (``inputs.pkl``: the weights as
the reference's parameter trees of numpy arrays), and saves ``{case:
result, or the traceback}`` to ``rank<r>.pt``.  ``_torch_dist.collect``
waits for the ranks within one deadline and kills what is left.
"""

from __future__ import annotations

import datetime
import os
import pickle
import subprocess
import sys
import traceback

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")

RANK_TIMEOUT_S = 90      # rendezvous and each collective, inside a rank
FSDP = dict(data_axes=("data", "model"), moe_ep=False)


def _lm(tree, arch, ep=1, trainable=False):
    from repro_torch import convert
    from repro_torch.configs import get_config

    cfg = get_config(arch).reduced()
    return cfg, convert.lm_params_from_numpy(tree, cfg, "cpu", ep_shards=ep,
                                             trainable=trainable)


def _sharded(lm, sh, mode):
    from repro_torch import sharding as S

    return S.shard_params(lm, S.mesh_specs(lm, sh, mode), sh.mesh)


def case_moe(inp, meshes):
    from repro_torch.configs.base import MoEConfig
    from repro_torch.nn import moe as M
    from repro_torch.sharding import collectives as C

    out = {}
    for name, case in inp["moe"].items():
        params = {k: torch.from_numpy(v) for k, v in case["params"].items()}
        C.reset_collectives()
        y, aux = M.apply_moe(params, torch.from_numpy(case["x"]),
                             MoEConfig(**case["cfg"]),
                             mesh=meshes[case["mesh"]])
        out[name] = dict(y=y, collectives=C.collectives(),
                         **aux._asdict())
    return out


def case_decode(inp, meshes):
    from repro_torch.nn import transformer as T
    from repro_torch.sharding import collectives as C

    d = inp["decode"]
    cfg, lm = _lm(d["params"], d["arch"])
    sh = T.Shardings(mesh=meshes["2x2"])
    loc = _sharded(lm, sh, "decode")
    st = T.init_decode_state(loc, cfg, d["batch"], d["capacity"], sh=sh)
    logits = []
    C.reset_collectives()
    with torch.no_grad():
        for t in torch.from_numpy(d["tokens"]).T:
            lg, st = T.decode_step(loc, st, t[:, None], cfg, sh=sh)
            logits.append(lg)
    return dict(logits=torch.stack(logits), collectives=C.collectives(),
                cache=tuple(st.kv[0].k.shape))


def case_forward(inp, meshes):
    from repro_torch.nn import transformer as T
    from repro_torch.sharding import collectives as C

    out = {}
    for arch, case in inp["forward"].items():
        cfg, lm = _lm(case["params"], arch, case["ep"])
        sh = T.Shardings(mesh=meshes["2x2"])
        loc = _sharded(lm, sh, "serve")
        toks = torch.from_numpy(case["tokens"])
        C.reset_collectives()
        with torch.no_grad():
            lg = T.forward(loc, toks, cfg, sh, remat=False).logits
            full = T.gather_logits(loc, lg, cfg, sh, toks.shape[0])
        out[arch] = dict(logits=full, local=tuple(lg.shape),
                         collectives=C.collectives())
    return out


def case_train(inp, meshes):
    from repro_torch.nn import transformer as T
    from repro_torch.sharding import gather_params
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as ts

    t = inp["train"]
    batch = ts.TrainBatch(tokens=torch.from_numpy(t["tokens"]),
                          labels=torch.from_numpy(t["labels"]))
    out = {}
    for mode in ("train", "train_fsdp"):
        sh = T.Shardings(mesh=meshes["2x2"], **(FSDP if mode == "train_fsdp"
                                                else {}))
        for optim in ("adamw", "vb"):
            cfg, lm = _lm(t["params"], t["arch"], trainable=True)
            loc = _sharded(lm, sh, mode)
            if optim == "adamw":
                s, m = ts.train_step(ts.init_train_state(loc), batch, cfg, sh,
                                     lr_fn=opt.cosine_schedule(t["lr"], 1,
                                                               100))
            else:
                s, m = ts.vb_train_step(ts.init_vb_state(loc), batch, cfg, sh,
                                        n_total=t["n_total"], lr=t["vb_lr"])
            full = gather_params(s.params, sh.mesh)
            out[f"{optim}/{mode}"] = dict(
                loss=m["loss"], kl=m.get("kl"),
                params=T.params_tree(full),
                local={k: p.detach().clone()
                       for k, p in s.params.named_parameters()},
                specs={k: p.shard_spec
                       for k, p in s.params.named_parameters()})
    return out


def case_norm(inp, meshes):
    """The clip's global norm of one batch's gradients on the 2 x 2 mesh
    in train and train_fsdp (this rank's blocks, ``sharded_sum``) and the
    norm of the same gradients gathered whole, in fp64."""
    from repro_torch.nn import transformer as T
    from repro_torch.sharding import gather_tensor
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as ts

    t = inp["train"]
    batch = ts.TrainBatch(tokens=torch.from_numpy(t["tokens"]),
                          labels=torch.from_numpy(t["labels"]))
    out = {}
    for mode in ("train", "train_fsdp"):
        sh = T.Shardings(mesh=meshes["2x2"], **(FSDP if mode == "train_fsdp"
                                                else {}))
        cfg, lm = _lm(t["params"], t["arch"], trainable=True)
        loc = _sharded(lm, sh, mode)
        _, grads = ts.grads_of(loc, batch, cfg, sh=sh)
        named = dict(loc.named_parameters())
        whole = sum(float(torch.sum(gather_tensor(
            g, named[k].shard_spec, sh.mesh).double() ** 2))
            for k, g in grads.items())
        out[mode] = dict(norm=opt.global_norm(grads, named, sh.mesh),
                         whole=whole ** 0.5)
    return out


def case_refusals(inp, meshes):
    """Expert parallel experts on a model axis that splits the data."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.nn import moe as M
    from repro_torch.nn import transformer as T

    sh = T.Shardings(mesh=meshes["2x2"], data_axes=("data", "model"))
    params = {"router": torch.zeros(8, 2), "w_gate": torch.zeros(1, 1, 8, 4),
              "w_up": torch.zeros(1, 1, 8, 4),
              "w_down": torch.zeros(1, 1, 4, 8)}
    try:
        M.moe_layer(params, torch.zeros(1, 4, 8), MoEConfig(2, 1, 1.0), sh)
    except ValueError as e:
        return dict(moe_ep_fsdp=str(e))
    return dict(moe_ep_fsdp=None)


def case_groups(inp, meshes):
    """Mamba2 with B/C groups (G = 2, 4) split over model = 2 and 4: the
    gradients of one batch and 10 decode steps, against the mesh-free
    ones (every rank computes both)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.nn import transformer as T
    from repro_torch.sharding import gather_tensor
    from repro_torch.train import step as ts

    out = {}
    toks = torch.from_numpy(inp["train"]["tokens"])
    batch = ts.TrainBatch(tokens=toks, labels=torch.roll(toks, -1, 1))
    for mesh, G in (("2x2", 2), ("1x4", 2), ("2x2", 4)):
        cfg = get_config("mamba2-1.3b").reduced()
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, n_groups=G))
        sh = T.Shardings(mesh=meshes[mesh])
        full = T.init_model(torch.Generator().manual_seed(0), cfg,
                            trainable=True)
        loc = _sharded(full, sh, "train")
        _, g0 = ts.grads_of(full, batch, cfg)
        _, g1 = ts.grads_of(loc, batch, cfg, sh=sh)
        named = dict(loc.named_parameters())
        grads = {k: (gather_tensor(g, named[k].shard_spec, sh.mesh), g0[k])
                 for k, g in g1.items()}
        st0 = T.init_decode_state(full, cfg, 4, 8)
        st1 = T.init_decode_state(loc, cfg, 4, 8, sh=sh)
        steps = []
        with torch.no_grad():
            for t in toks[:, :10].T:
                a, st0 = T.decode_step(full, st0, t[:, None], cfg)
                b, st1 = T.decode_step(loc, st1, t[:, None], cfg, sh=sh)
                steps.append((b, a))
        out[f"{mesh}/G{G}"] = dict(grads=grads, decode=steps)
    return out


def case_launch(inp, meshes):
    from repro_torch.launch import train

    rc = train.main(["--arch", "granite-3-2b", "--device", "cpu", "--steps",
                     "2", "--batch", "4", "--seq", "16", "--data-shards",
                     "2", "--model-shards", "2", "--corpus-size", "4096",
                     "--ckpt", inp["ckpt"], "--log-every", "1"])
    return dict(rc=rc)


def seq_shard_config():
    """Reduced gemma with 3 q heads and 1 kv head: the heads do not divide
    over model = 2, so attention takes the seq-shard route."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("gemma-2b").reduced(), n_heads=3,
                               n_kv_heads=1)


def case_seq_shard(inp, meshes):
    """gemma (3 q heads) on the 2 x 2 mesh with attn_seq_shard: the
    forward's logits, one batch's gradients gathered whole, and one AdamW
    step."""
    from repro_torch import convert
    from repro_torch.nn import transformer as T
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding import gather_params, gather_tensor
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as ts

    t = inp["seq_shard"]
    cfg = seq_shard_config()
    sh = T.Shardings(mesh=meshes["2x2"], attn_seq_shard=True)
    toks = torch.from_numpy(t["tokens"])
    batch = ts.TrainBatch(tokens=toks, labels=torch.from_numpy(t["labels"]))

    def local(trainable):
        lm = convert.lm_params_from_numpy(t["params"], cfg, "cpu",
                                          trainable=trainable)
        return _sharded(lm, sh, "train" if trainable else "serve")

    loc = local(False)
    wq = tuple(loc["blocks"][0]["attn"]["wq"].shape)
    C.reset_collectives()
    with torch.no_grad():
        lg = T.forward(loc, toks, cfg, sh, remat=False).logits
        logits = T.gather_logits(loc, lg, cfg, sh, toks.shape[0])
    coll = C.collectives()
    loc = local(True)
    named = dict(loc.named_parameters())
    _, grads = ts.grads_of(loc, batch, cfg, sh=sh)
    grads = {k: gather_tensor(g, named[k].shard_spec, sh.mesh)
             for k, g in grads.items()}
    s, m = ts.train_step(ts.init_train_state(loc), batch, cfg, sh,
                         lr_fn=opt.cosine_schedule(t["lr"], 1, 100))
    return dict(logits=logits, collectives=coll, grads=grads, loss=m["loss"],
                params=T.params_tree(gather_params(s.params, sh.mesh)),
                wq=wq)


def dryrun_case(case):
    """(config, InputShape) of a dry-run comparison case."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape

    cfg = seq_shard_config() if case["arch"] == "gemma-seq" \
        else get_config(case["arch"]).reduced()
    return cfg, InputShape(*case["shape"])


def case_dryrun(inp, meshes):
    """Each dry-run case's step on real tensors (the parameters drawn,
    the optimizer and decode states as ``dryrun.input_specs`` makes them),
    measured as the dry run measures a fake one."""
    from repro_torch.launch import dryrun

    out = {}
    g = torch.Generator().manual_seed(0)
    for name, case in inp["dryrun"].items():
        cfg, shape = dryrun_case(case)
        dryrun.TRAIN_SHARDING = case["sharding"]
        try:
            mesh = meshes[case["mesh"]]
            kind, args, fn = dryrun.input_specs(cfg, shape, mesh,
                                                device=torch.device("cpu"))
            lm = args[0].params if kind == "train" else args[0]
            with torch.no_grad():
                for p in lm.parameters():
                    p.normal_(0.0, 0.02, generator=g)
            out[name] = dryrun.measure(fn, args, mesh.size())
        finally:
            dryrun.TRAIN_SHARDING = "tp_fsdp"
    return out


def case_pods(inp, meshes):
    """granite on the ("pod", "data", "model") = 2 x 1 x 2 mesh, the data
    split over ("pod", "data"): the loss and the gradients gathered whole,
    against the mesh-free ones on the same weights."""
    from repro_torch.configs import get_config
    from repro_torch.nn import transformer as T
    from repro_torch.sharding import gather_tensor, init_sharded
    from repro_torch.train import step as ts

    t = inp["train"]
    cfg = get_config(t["arch"]).reduced()
    sh = T.Shardings(mesh=meshes["pods"], data_axes=("pod", "data"))
    batch = ts.TrainBatch(tokens=torch.from_numpy(t["tokens"]),
                          labels=torch.from_numpy(t["labels"]))
    full = T.init_model(torch.Generator().manual_seed(5), cfg, trainable=True)
    loc = init_sharded(torch.Generator().manual_seed(5), cfg, sh, "train",
                       trainable=True)
    (_, (l0, _)), g0 = ts.grads_of(full, batch, cfg)
    (_, (l1, _)), g1 = ts.grads_of(loc, batch, cfg, sh=sh)
    named = dict(loc.named_parameters())
    return dict(loss=(l1, l0), grads={
        k: (gather_tensor(g, named[k].shard_spec, sh.mesh), g0[k])
        for k, g in g1.items()})


CASES = {"moe": case_moe, "decode": case_decode, "forward": case_forward,
         "train": case_train, "norm": case_norm, "refusals": case_refusals,
         "groups": case_groups, "launch": case_launch,
         "seq_shard": case_seq_shard, "dryrun": case_dryrun,
         "pods": case_pods}


def _rank_main(rank: int, world: int, tmp: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(tmp, 'store')}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        names = ("data", "model")
        meshes = {"2x2": init_device_mesh("cpu", (2, 2),
                                          mesh_dim_names=names),
                  "1x4": init_device_mesh("cpu", (1, 4),
                                          mesh_dim_names=names),
                  "4x1": init_device_mesh("cpu", (4, 1),
                                          mesh_dim_names=names),
                  "pods": init_device_mesh("cpu", (2, 1, 2),
                                           mesh_dim_names=("pod",) + names)}
        with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
            inp = pickle.load(f)
        out = {"coords": {a: meshes["2x2"].get_local_rank(a)
                          for a in ("data", "model")}}
        for name, fn in CASES.items():
            try:
                out[name] = fn(inp, meshes)
            except Exception:   # report per case; a collective that fails
                out[name] = traceback.format_exc()   # raises on every rank
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def start(world: int, tmp: str) -> list:
    """Start ``world`` gloo ranks running every case on ``inputs.pkl``."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = SRC
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world), tmp],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
