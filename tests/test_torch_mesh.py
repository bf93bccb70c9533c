"""The port's LM mesh paths against the reference's, on the CPU.

Four gloo ranks (``tests/_torch_mesh_ranks.py``, the ``_torch_dist``
pattern: a ``FileStore``, per-rank timeouts, one deadline) run the port's
mesh routes; the reference's mesh routes run at the same time in one
subprocess on four host devices (``tests/_mesh_reference.py``, as
``tests/test_distributed.py`` runs them).  Both start from the same
weights (reduced configs drawn with the port's ``init_model`` and carried
across as the reference's parameter trees) and the same numpy inputs.

Tolerances, each case's own:
- expert parallel ``apply_moe``: both round y to bf16 before the sum over
  model, so y within 2e-2 (abs and rel, the reference's own EP test);
  ``expert_load`` (linear in the tokens) within 1e-6, ``load_balance`` and
  ``router_z`` rtol 1e-5 -- the same pairs are dropped;
- ctx-parallel decode: each step's logits within 2e-2 relative L2 of the
  reference's (the port's mesh-free decode lies ~1e-2 from it: bf16
  products and caches), argmax the same at >= 90% of the steps' rows;
- sharded forward logits: >= 95% of positions within 3e-2 relative L2
  (bf16 partial sums over model in both; a mixture-of-experts route that
  flips on a near-tie moves a few positions further), argmax the same at
  >= 95% of positions;
- train steps: the loss rtol 1e-4; AdamW's first step moves each weight by
  ~lr sign(g), so the updated weights within 2.1 lr of the reference's
  everywhere and within lr / 100 at >= 99% of entries; VB's step is
  smooth in g, so its update within 2e-2 relative L2, its KL rtol 1e-3;
- a one-rank ("data", "model") mesh: the mesh-free bits (the MoE combine
  rounds y to bf16 before its sum over model, as the reference's mesh route
  does, and the residual stream it is added to is bf16: the same bits);
- attention split over the sequence (``attn_seq_shard``, reduced gemma with
  3 q heads and 1 kv head on the 2 x 2 mesh) against the reference's
  ``Shardings(attn_seq_shard=True)``: the forward's logits at the sharded
  forward's bars, each gradient within 5e-2 relative L2 (the bar of the
  B/C groups' gradients: bf16 products), the AdamW step at the train
  steps' bars;
- the dry run (``launch.dryrun``) on fake tensors against the same steps
  on real tensors on every rank: the collectives (calls and bytes by kind),
  the argument bytes and the aten flops equal;
- ("pod", "data", "model") = 2 x 1 x 2: the loss within rtol 1e-4 of the
  mesh-free one (the train steps' bar: bf16 partial sums over model) and
  each gradient within 5e-2 relative L2.
"""

import datetime
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

import _torch_dist  # noqa: E402
import _torch_mesh_ranks  # noqa: E402
from repro.train import checkpoint as jck  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.nn import moe as M  # noqa: E402
from repro_torch.nn import transformer as T  # noqa: E402
from repro_torch.sharding import mesh_specs, shard_params  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import step as ts  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORLD = 4
DEADLINE_S = 240         # the ranks and the reference, start to finish
LR, VB_LR, N_TOTAL = 1e-3, 0.1, 1e4
FORWARD = {"granite-3-2b": 1, "mixtral-8x7b": 2, "mamba2-1.3b": 1,
           "zamba2-1.2b": 1}                       # arch: EP shards
MOE = {   # name: (mesh, E, top_k, capacity factor)
    "s2_E4": ("2x2", 4, 2, 1.0), "s2_E1": ("2x2", 1, 1, 1.0),
    "s4_E8": ("1x4", 8, 2, 1.0), "s4_E2": ("1x4", 2, 1, 1.0)}


def _tree(arch, seed, ep=1):
    cfg = get_config(arch).reduced()
    lm = T.init_model(torch.Generator().manual_seed(seed), cfg, ep_shards=ep)
    return T.params_tree(lm)


def _moe_case(seed, mesh, E, k, cf):
    g = np.random.default_rng(seed)
    d, ff = 32, 64
    s = 2 if mesh == "2x2" else 4
    w = {"w_gate": g.normal(0, d ** -0.5, (E, d, ff)),
         "w_up": g.normal(0, d ** -0.5, (E, d, ff)),
         "w_down": g.normal(0, ff ** -0.5, (E, ff, d))}
    params = {"router": g.normal(0, d ** -0.5, (d, E)).astype(np.float32)}
    for name, v in w.items():
        split = M.ep_split_down if name == "w_down" else M.ep_split
        params[name] = split(torch.from_numpy(v.astype(np.float32)),
                             s).numpy()
    return dict(mesh=mesh, cfg=dict(n_experts=E, top_k=k,
                                    capacity_factor=cf),
                params=params,
                x=g.standard_normal((4, 16, d)).astype(np.float32))


# dry-run cases: arch, InputShape fields, mesh, REPRO_TRAIN_SHARDING
DRYRUN = {
    "granite/train": ("granite-3-2b", ("train_4k", 32, 4, "train"), "2x2",
                      "tp_fsdp"),
    "granite/train_fsdp": ("granite-3-2b", ("train_4k", 32, 4, "train"),
                           "2x2", "fsdp"),
    "granite/pods": ("granite-3-2b", ("train_4k", 32, 4, "train"), "pods",
                     "tp_fsdp"),
    "mixtral/prefill": ("mixtral-8x7b", ("prefill_32k", 64, 4, "prefill"),
                        "1x4", "tp_fsdp"),
    "zamba2/prefill": ("zamba2-1.2b", ("prefill_32k", 64, 4, "prefill"),
                       "2x2", "tp_fsdp"),
    "zamba2/decode": ("zamba2-1.2b", ("decode_32k", 16, 4, "decode"), "4x1",
                      "tp_fsdp"),
    "gemma-seq/train": ("gemma-seq", ("train_4k", 32, 4, "train"), "2x2",
                        "tp_fsdp"),
    "gemma-seq/prefill": ("gemma-seq", ("prefill_32k", 64, 4, "prefill"),
                          "1x4", "tp_fsdp"),
}
MESH_DIMS = {"2x2": (2, 2), "1x4": (1, 4), "4x1": (4, 1), "pods": (2, 1, 2)}


def _inputs(tmp):
    g = np.random.default_rng(7)
    toks = g.integers(0, 512, (4, 32))
    seq = T.init_model(torch.Generator().manual_seed(4),
                       _torch_mesh_ranks.seq_shard_config())
    return {
        "moe": {name: _moe_case(i, *case)
                for i, (name, case) in enumerate(MOE.items())},
        "decode": dict(arch="glm4-9b", params=_tree("glm4-9b", 1), batch=8,
                       capacity=8, tokens=g.integers(0, 512, (8, 12))),
        "forward": {arch: dict(params=_tree(arch, 2, ep), ep=ep,
                               tokens=g.integers(0, 512, (4, 64)))
                    for arch, ep in FORWARD.items()},
        "train": dict(arch="granite-3-2b", params=_tree("granite-3-2b", 3),
                      tokens=toks, labels=np.roll(toks, -1, 1), lr=LR,
                      vb_lr=VB_LR, n_total=N_TOTAL),
        "ckpt": os.path.join(tmp, "launch.npz"),
        "seq_shard": dict(params=T.params_tree(seq), tokens=toks,
                          labels=np.roll(toks, -1, 1), lr=LR),
        "dryrun": {name: dict(arch=a, shape=shape, mesh=mesh, sharding=sh)
                   for name, (a, shape, mesh, sh) in DRYRUN.items()},
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the reference's results, each rank's results)."""
    tmp = str(tmp_path_factory.mktemp("lm_mesh"))
    inp = _inputs(tmp)
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    deadline = time.monotonic() + DEADLINE_S
    ref = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_mesh_reference.py"), tmp],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ranks = _torch_mesh_ranks.start(WORLD, tmp)
    try:
        out = _torch_dist.collect(ranks, tmp, deadline)
        log, _ = ref.communicate(timeout=max(deadline - time.monotonic(),
                                             0.1))
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, log[-3000:]
    with open(os.path.join(tmp, "reference.pkl"), "rb") as f:
        reference = pickle.load(f)
    return inp, reference, out


def _ok(out, case):
    for r, o in enumerate(out):
        assert not isinstance(o[case], str), f"rank {r}:\n{o[case]}"
    return [o[case] for o in out]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _same_on_every_rank(results, key=None):
    first = results[0] if key is None else results[0][key]
    for r in results[1:]:
        assert torch.equal(first, r if key is None else r[key])
    return first


@pytest.mark.parametrize("name", list(MOE))
def test_moe_ep_matches_reference(runs, name):
    inp, ref, out = runs
    got = [r[name] for r in _ok(out, "moe")]
    y = _same_on_every_rank(got, "y").numpy()
    exp = ref["moe"][name]
    np.testing.assert_allclose(y, exp["y"], atol=2e-2, rtol=2e-2)
    for k in ("load_balance", "router_z"):
        np.testing.assert_allclose(_same_on_every_rank(got, k).numpy(),
                                   exp[k], rtol=1e-5)
    np.testing.assert_allclose(_same_on_every_rank(got, "expert_load")
                               .numpy(), exp["expert_load"], atol=1e-6)
    # each data shard routes its own tokens against its own capacity: the
    # cases with E >= s drop pairs there
    case = inp["moe"][name]
    cfg = MoEConfig(**case["cfg"])
    x = torch.from_numpy(case["x"])
    blocks = x.chunk(2) if case["mesh"] == "2x2" else (x,)
    dropped = 0
    for xb in blocks:
        _, idx, _ = M._route(torch.from_numpy(case["params"]["router"]),
                             xb.reshape(-1, xb.shape[-1]), cfg)
        cap = M.capacity(idx.shape[0], cfg)
        dropped += int((M.ranks(idx.reshape(-1), cfg.n_experts) >= cap)
                       .sum())
    assert dropped > 0 or cfg.n_experts < 4
    # the tokens whose every pair was dropped are zero rows in both
    assert (np.abs(exp["y"]).max(-1) == 0).sum() == \
        (np.abs(y).max(-1) == 0).sum()
    # the combine is one bf16 sum over model; on the data-split mesh the
    # three aux terms are averaged over data and y's rows gathered
    split = inp["moe"][name]["mesh"] == "2x2"
    c = got[0]["collectives"]
    assert c["all_reduce"]["calls"] == 1 + 3 * split
    assert c["gather"]["calls"] == split


def test_ctx_parallel_decode_matches_reference(runs):
    inp, ref, out = runs
    got = _ok(out, "decode")
    lg = _same_on_every_rank(got, "logits").numpy()
    exp = ref["decode"]
    d = inp["decode"]
    assert d["tokens"].shape[1] > d["capacity"]       # past a ring wrap
    assert got[0]["cache"][1] == d["capacity"] // 2   # the ring is split
    for step in range(lg.shape[0]):
        assert _rel(lg[step], exp[step]) < 2e-2, step
    assert (lg.argmax(-1) == exp.argmax(-1)).mean() >= 0.9
    # a step: per layer the q heads' gather, the combine's MAX and SUM and
    # the sums after wo and w_down; the embedding's sum; the logits'
    # gathers over vocabulary and batch
    cfg = get_config(d["arch"]).reduced()
    steps = d["tokens"].shape[1]
    c = got[0]["collectives"]
    assert c["max"]["calls"] == steps * cfg.n_layers
    assert c["all_reduce"]["calls"] == steps * (3 * cfg.n_layers + 1)
    assert c["gather"]["calls"] == steps * (cfg.n_layers + 2)


@pytest.mark.parametrize("arch", list(FORWARD))
def test_sharded_forward_matches_reference(runs, arch):
    inp, ref, out = runs
    got = [r[arch] for r in _ok(out, "forward")]
    lg = _same_on_every_rank(got, "logits").numpy()
    exp = ref["forward"][arch]
    per = np.linalg.norm(lg - exp, axis=-1) / np.linalg.norm(exp, axis=-1)
    assert (per < 3e-2).mean() >= 0.95
    assert (lg.argmax(-1) == exp.argmax(-1)).mean() >= 0.95
    cfg = get_config(arch).reduced()
    assert got[0]["local"] == (2, 64, cfg.vocab // 2)   # this rank's block
    assert got[0]["collectives"]["all_reduce"]["calls"] > 0


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("run", ["adamw/train", "adamw/train_fsdp",
                                 "vb/train", "vb/train_fsdp"])
def test_sharded_train_steps_match_reference(runs, run):
    inp, ref, out = runs
    got = [r[run] for r in _ok(out, "train")]
    exp = ref["train"][run]
    loss = _same_on_every_rank(got, "loss")
    np.testing.assert_allclose(float(loss), exp["loss"], rtol=1e-4)
    before = _flat(inp["train"]["params"])
    mine = [_flat(g["params"]) for g in got]
    for m in mine[1:]:
        assert all(np.array_equal(m[k], mine[0][k]) for k in m)
    theirs = _flat(exp["params"])
    assert sorted(mine[0]) == sorted(theirs)
    for k in theirs:
        a, b, p0 = mine[0][k], theirs[k], before[k]
        if run.startswith("adamw"):
            diff = np.abs(a - b)
            assert diff.max() <= 2.1 * LR, k
            assert (diff <= LR / 100).mean() >= 0.99, k
        else:
            assert _rel(a - p0, b - p0) < 2e-2, k
    if run.startswith("vb"):
        np.testing.assert_allclose(float(_same_on_every_rank(got, "kl")),
                                   exp["kl"], rtol=1e-3)


def test_ranks_hold_identical_bits_where_the_specs_replicate(runs):
    """After a train step, every pair of ranks that the spec of a
    parameter says hold the same block holds the same bits."""
    _, _, out = runs
    coords = [o["coords"] for o in out]
    for run in ("adamw/train", "vb/train_fsdp"):
        res = [r[run] for r in _ok(out, "train")]
        for k, spec in res[0]["specs"].items():
            split = {a for e in spec if e is not None
                     for a in ((e,) if isinstance(e, str) else e)}
            for r in range(1, len(out)):
                if all(coords[r][a] == coords[0][a] for a in split):
                    assert torch.equal(res[r]["local"][k],
                                       res[0]["local"][k]), (run, k, r)


@pytest.mark.parametrize("mode", ["train", "train_fsdp"])
def test_mesh_global_norm_counts_each_entry_once(runs, mode):
    """The clip's norm from each rank's blocks (summed over the axes that
    split each parameter, a replicated one counted once) is the norm of
    the gathered gradients, rtol 1e-6, and the same bits on every rank."""
    _, _, out = runs
    res = [r[mode] for r in _ok(out, "norm")]
    norm = float(_same_on_every_rank(res, "norm"))
    np.testing.assert_allclose(norm, res[0]["whole"], rtol=1e-6)


def test_expert_parallel_refused_on_a_data_split_model_axis(runs):
    _, _, out = runs
    for r in _ok(out, "refusals"):
        assert "moe_ep" in (r["moe_ep_fsdp"] or ""), r


@pytest.mark.parametrize("run", ["2x2/G2", "1x4/G2", "2x2/G4"])
def test_mamba2_groups_split_over_model(runs, run):
    """B/C groups (the reference's configs all have G = 1): a rank keeps
    the groups its heads read -- two of four at model = 2, one shared by
    two ranks at model = 4 --; gradients within 5e-2 relative L2 and
    decode logits within 2e-2 of the mesh-free ones (bf16 partial sums
    over model)."""
    _, _, out = runs
    res = _ok(out, "groups")[0][run]
    for k, (got, exp) in res["grads"].items():
        assert _rel(got, exp) < 5e-2, k
    for got, exp in res["decode"]:
        assert _rel(got, exp) < 2e-2


def test_launch_train_on_a_mesh_writes_a_whole_checkpoint(runs):
    inp, _, out = runs
    assert all(r["rc"] == 0 for r in _ok(out, "launch"))
    cfg = get_config("granite-3-2b").reduced()
    lm = convert.load_lm_checkpoint(inp["ckpt"], cfg, "cpu")
    fresh = T.init_model(torch.Generator().manual_seed(0), cfg)
    named = dict(lm.named_parameters())
    assert sorted((k, p.shape) for k, p in fresh.named_parameters()) == \
        sorted((k, p.shape) for k, p in named.items())
    assert all(bool(torch.isfinite(p).all()) for p in named.values())
    # two steps moved the weights drawn from --seed 0
    assert not torch.equal(named["blocks.0.attn.wq"],
                           fresh["blocks"][0]["attn"]["wq"])
    # the reference reads it into its own tree
    like = _flat(T.params_tree(fresh))
    back = _flat(jck.load(inp["ckpt"], T.params_tree(fresh)))
    assert sorted(back) == sorted(like)


def test_seq_shard_forward_matches_reference(runs):
    """The q heads (3) do not divide over model = 2: wq stays whole on
    every rank and attention splits over the sequence; the logits at the
    sharded forward's bars.  Collectives a forward: the vocab-parallel
    embedding's sum, per layer the attention blocks' gather over model and
    the MLP's sum, and the logits' gathers over vocabulary and batch."""
    inp, ref, out = runs
    got = _ok(out, "seq_shard")
    lg = _same_on_every_rank(got, "logits").numpy()
    exp = ref["seq_shard"]["logits"]
    per = np.linalg.norm(lg - exp, axis=-1) / np.linalg.norm(exp, axis=-1)
    assert (per < 3e-2).mean() >= 0.95
    assert (lg.argmax(-1) == exp.argmax(-1)).mean() >= 0.95
    cfg = _torch_mesh_ranks.seq_shard_config()
    assert got[0]["wq"] == (cfg.d_model, 3, cfg.head_dim_)
    c = got[0]["collectives"]
    assert c["gather"]["calls"] == cfg.n_layers + 2
    assert c["all_reduce"]["calls"] == cfg.n_layers + 1


def test_seq_shard_gradients_and_step_match_reference(runs):
    inp, ref, out = runs
    got = _ok(out, "seq_shard")
    exp = ref["seq_shard"]
    theirs = _flat(exp["grads"])
    for r in got:
        mine = {}
        for k, g in r["grads"].items():
            parts = k.split(".")
            if parts[0] == "blocks":      # the reference stacks the layers
                mine.setdefault(".".join(parts[:1] + parts[2:]), {})[
                    int(parts[1])] = g.numpy()
            else:
                mine[k] = g.numpy()
        for k, v in mine.items():
            a = np.stack([v[i] for i in sorted(v)]) if isinstance(v, dict) \
                else v
            assert _rel(a, theirs[k.replace(".", "/")]) < 5e-2, k
    loss = _same_on_every_rank(got, "loss")
    np.testing.assert_allclose(float(loss), exp["loss"], rtol=1e-4)
    mine, theirs = _flat(got[0]["params"]), _flat(exp["params"])
    assert sorted(mine) == sorted(theirs)
    for k in theirs:
        diff = np.abs(mine[k] - theirs[k])
        assert diff.max() <= 2.1 * LR, k
        assert (diff <= LR / 100).mean() >= 0.99, k


@pytest.mark.parametrize("name", list(DRYRUN))
def test_fake_run_matches_the_real_run(runs, monkeypatch, name):
    """The dry run's two ranks (the first and the last; a fake world of the
    mesh's size, fake tensors, ``dryrun.run_rank``) against the same
    ranks' step on the real gloo ranks: the collectives, the argument bytes
    and the aten flops equal."""
    from repro_torch.launch import dryrun

    _, _, out = runs
    case = dict(zip(("arch", "shape", "mesh", "sharding"), DRYRUN[name]))
    monkeypatch.setattr(dryrun, "TRAIN_SHARDING", case["sharding"])
    cfg, shape = _torch_mesh_ranks.dryrun_case(case)
    real = [r[name] for r in _ok(out, "dryrun")]
    for rank in (0, len(real) - 1):
        got = real[rank]
        fake = dryrun.run_rank(cfg, shape, MESH_DIMS[case["mesh"]], rank,
                               torch.device("cpu"))
        assert fake["kind"] == shape.kind
        assert fake["collectives"] == got["collectives"], rank
        assert fake["memory"]["argument_bytes"] == \
            got["memory"]["argument_bytes"], rank
        assert fake["flops"] == got["flops"], rank
    assert real[0]["collectives"]["count"] > 0


def test_lm_paths_take_pod_and_data_as_data_axes(runs):
    for r in _ok(out := runs[2], "pods"):
        got, exp = r["loss"]
        np.testing.assert_allclose(float(got), float(exp), rtol=1e-4)
        for k, (a, b) in r["grads"].items():
            assert _rel(a, b) < 5e-2, k
    assert len(out) == WORLD


@pytest.fixture
def one_rank_mesh(tmp_path):
    """A one-rank gloo world in this process and its 1 x 1 mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield init_device_mesh("cpu", (1, 1),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_world_one_mesh_gives_mesh_free_bits(one_rank_mesh):
    sh = T.Shardings(mesh=one_rank_mesh)
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(0, 512, (2, 32), generator=g)
    for arch in ("granite-3-2b", "zamba2-1.2b", "mixtral-8x7b"):
        cfg = get_config(arch).reduced()
        lm = T.init_model(torch.Generator().manual_seed(1), cfg,
                          trainable=True)
        loc = shard_params(lm, mesh_specs(lm, sh, "train"), one_rank_mesh)
        with torch.no_grad():
            a = T.forward(lm, toks, cfg).logits
            b = T.forward(loc, toks, cfg, sh).logits
        assert torch.equal(a, b), arch
        batch = ts.TrainBatch(tokens=toks, labels=torch.roll(toks, -1, 1))
        lr = opt.cosine_schedule(LR, 1, 100)
        s0, m0 = ts.train_step(ts.init_train_state(lm), batch, cfg,
                               lr_fn=lr)
        s1, m1 = ts.train_step(ts.init_train_state(loc), batch, cfg, sh,
                               lr_fn=lr)
        assert torch.equal(m0["loss"], m1["loss"])
        p1 = dict(s1.params.named_parameters())
        assert all(torch.equal(p, p1[k])
                   for k, p in s0.params.named_parameters()), arch
        if cfg.arch_type == "hybrid":
            st0 = T.init_decode_state(lm, cfg, 2, 16)
            st1 = T.init_decode_state(loc, cfg, 2, 16, sh=sh)
            with torch.no_grad():
                for t in toks[:, :20].T:
                    l0, st0 = T.decode_step(lm, st0, t[:, None], cfg)
                    l1, st1 = T.decode_step(loc, st1, t[:, None], cfg, sh=sh)
                    assert torch.equal(l0, l1)
