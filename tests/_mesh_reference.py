"""The reference's mesh routes on the inputs ``tests/test_torch_mesh.py``
wrote, run on four host devices:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_mesh_reference.py <tmp dir>

Reads ``inputs.pkl`` (weights as the reference's parameter trees of numpy
arrays, tokens, MoE cases) and writes ``reference.pkl``: ``{case: arrays}``.
Imports JAX and ``repro`` only.
"""

from __future__ import annotations

import os
import pickle
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
from repro.configs.base import MoEConfig
from repro.core.compat import make_mesh
from repro.nn import moe as M
from repro.nn import transformer as T
from repro.train import optimizer as opt
from repro.train import step as ts


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def moe_cases(inp, meshes):
    out = {}
    for name, case in inp["moe"].items():
        cfg = MoEConfig(**case["cfg"])
        mesh = meshes[case["mesh"]]
        y, aux = jax.jit(partial(M.apply_moe, cfg=cfg, mesh=mesh))(
            case["params"], jnp.asarray(case["x"]))
        out[name] = dict(y=np.asarray(y), **{k: np.asarray(v) for k, v in
                                              aux._asdict().items()})
    return out


def decode_case(inp, meshes):
    d = inp["decode"]
    cfg = get_config(d["arch"]).reduced()
    sh = T.Shardings(mesh=meshes["2x2"], shard_heads=False)
    st = T.init_decode_state(d["params"], cfg, d["batch"], d["capacity"], sh)
    step = jax.jit(lambda s, t: T.decode_step(d["params"], s, t, cfg, sh))
    logits = []
    for t in d["tokens"].T:
        lg, st = step(st, jnp.asarray(t[:, None]))
        logits.append(np.asarray(lg))
    return np.stack(logits)


def forward_cases(inp, meshes):
    out = {}
    for arch, case in inp["forward"].items():
        cfg = get_config(arch).reduced()
        sh = T.Shardings(mesh=meshes["2x2"])
        fwd = jax.jit(lambda p, t: T.forward(p, t, cfg, sh, remat=False))
        out[arch] = np.asarray(fwd(case["params"],
                                   jnp.asarray(case["tokens"])).logits)
    return out


def train_cases(inp, meshes):
    t = inp["train"]
    cfg = get_config(t["arch"]).reduced()
    batch = ts.TrainBatch(tokens=jnp.asarray(t["tokens"]),
                          labels=jnp.asarray(t["labels"]))
    out = {}
    for mode in ("train", "train_fsdp"):
        mesh = meshes["2x2"]
        sh = T.Shardings(mesh=mesh) if mode == "train" else T.Shardings(
            mesh=mesh, data_axes=("data", "model"), shard_heads=False,
            moe_ep=False)
        lr_fn = opt.cosine_schedule(t["lr"], 1, 100)
        s, m = jax.jit(partial(ts.train_step, cfg=cfg, sh=sh, lr_fn=lr_fn))(
            ts.init_train_state(t["params"]), batch)
        out[f"adamw/{mode}"] = dict(loss=np.asarray(m["loss"]),
                                    params=_np(s.params))
        s, m = jax.jit(partial(ts.vb_train_step, cfg=cfg, sh=sh,
                               n_total=t["n_total"], lr=t["vb_lr"]))(
            ts.init_vb_state(t["params"]), batch)
        out[f"vb/{mode}"] = dict(loss=np.asarray(m["loss"]),
                                 params=_np(s.vb.mean),
                                 kl=np.asarray(m["kl"]))
    return out


def seq_shard_case(inp, meshes):
    """gemma with 3 q heads over model = 2 and attn_seq_shard: the
    forward's logits, one batch's gradients and one AdamW step."""
    import dataclasses

    t = inp["seq_shard"]
    cfg = dataclasses.replace(get_config("gemma-2b").reduced(), n_heads=3,
                              n_kv_heads=1)
    sh = T.Shardings(mesh=meshes["2x2"], attn_seq_shard=True)
    batch = ts.TrainBatch(tokens=jnp.asarray(t["tokens"]),
                          labels=jnp.asarray(t["labels"]))
    logits = jax.jit(lambda p, x: T.forward(p, x, cfg, sh, remat=False))(
        t["params"], batch.tokens).logits
    grads = jax.jit(jax.grad(partial(ts.loss_fn, cfg=cfg, sh=sh),
                             has_aux=True))(t["params"], batch)[0]
    s, m = jax.jit(partial(ts.train_step, cfg=cfg, sh=sh,
                           lr_fn=opt.cosine_schedule(t["lr"], 1, 100)))(
        ts.init_train_state(t["params"]), batch)
    return dict(logits=np.asarray(logits), grads=_np(grads),
                loss=np.asarray(m["loss"]), params=_np(s.params))


def main(tmp: str) -> None:
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    for case in [inp["decode"], inp["train"], inp["seq_shard"],
                 *inp["forward"].values(), *inp["moe"].values()]:
        case["params"] = jax.tree_util.tree_map(jnp.asarray, case["params"])
    meshes = {"2x2": make_mesh((2, 2), ("data", "model")),
              "1x4": make_mesh((1, 4), ("data", "model"))}
    out = {"moe": moe_cases(inp, meshes), "decode": decode_case(inp, meshes),
           "forward": forward_cases(inp, meshes),
           "train": train_cases(inp, meshes),
           "seq_shard": seq_shard_case(inp, meshes)}
    with open(os.path.join(tmp, "reference.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
