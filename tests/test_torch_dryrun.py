"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``), on the CPU.

The reference's pure functions are compared without its 512 host devices:
the skip table and the shapes' kinds for all 40 (arch, shape) pairs, the
Shardings each mode chooses at 16 x 16 and 2 x 16 x 16 (on stand-in meshes
that carry the axis names and sizes), the decode capacity, n_params and
n_active, and each rank's parameter shapes against ``repro.sharding.
param_specs`` + ``fix_spec`` at {pod: 2, data: 16, model: 16} (the
reference's trees from ``jax.eval_shape``, the port's on the ``meta``
device).  Then ``run_one`` at production size and reduced depth on a fake
256-rank world, and the kernel wrappers' branch for fake tensors.  The
dry run against real gloo ranks is in ``tests/test_torch_mesh.py``.

Everything here is exact (shapes, counts, strings); the fake branch's
flops are the formulas of ``flash_attn.attention_flops`` and
``ssd_scan.ssd_flops`` / ``ssd_bwd_flops``, equal to the integer.

``import repro.launch.dryrun`` writes ``XLA_FLAGS`` (512 host devices) into
``os.environ``; the fixture that imports it restores the variable, so no
later subprocess of this worker inherits it.
"""

import json
import math
import os
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

import test_torch_sharding as TSH  # noqa: E402
from repro.configs import ARCH_IDS as JARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import INPUT_SHAPES as JSHAPES  # noqa: E402
from repro.sharding import specs as jspecs  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES  # noqa: E402
from repro_torch.kernels import flash_attn, ssd_scan  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.nn import transformer as T  # noqa: E402
from repro_torch.sharding import empty_sharded, mesh_specs  # noqa: E402

PAIRS = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES]
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
MODES = {"train": "train", "prefill": "serve", "decode": "decode"}


@pytest.fixture(scope="module")
def ref():
    """``repro.launch.dryrun``, imported with ``XLA_FLAGS`` restored."""
    before = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as jdry
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return jdry


def _meshes(name):
    """(the reference's stand-in mesh, the port's) of one production
    mesh: its axis names and sizes, which is all ``shardings_for``
    reads."""
    names, dims = MESHES[name]
    return (SimpleNamespace(axis_names=names, shape=dict(zip(names, dims))),
            SimpleNamespace(mesh_dim_names=names, shape=dims))


def test_skip_table_and_kinds_match_the_reference(ref):
    assert ARCH_IDS == list(JARCH_IDS)
    assert list(INPUT_SHAPES) == list(JSHAPES)
    skipped = 0
    for arch, shape in PAIRS:
        got = dryrun.skip_reason(get_config(arch), INPUT_SHAPES[shape])
        exp = ref.skip_reason(jget_config(arch), JSHAPES[shape])
        assert got == exp, (arch, shape)
        skipped += got is not None
        a, b = INPUT_SHAPES[shape], JSHAPES[shape]
        assert (a.kind, a.seq_len, a.global_batch) == \
            (b.kind, b.seq_len, b.global_batch)
    assert skipped == 6        # long_500k of the six quadratic archs


def test_n_params_and_n_active_match_the_reference():
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), jget_config(arch)
        assert (cfg.n_params(), cfg.n_active_params()) == \
            (jcfg.n_params(), jcfg.n_active_params()), arch


def _wq_head_split(cfg, sh, mode):
    """Whether ``mode``'s specs split the q heads over ``model``."""
    specs = mesh_specs(TSH._port_shapes(cfg.name, 1), sh, mode)
    return any(k.endswith("attn.wq") and spec[1] == "model"
               for k, spec in specs.items())


@pytest.mark.parametrize("sharding", ["tp_fsdp", "fsdp"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_shardings_for_match_the_reference(ref, monkeypatch, mesh,
                                           sharding):
    """data_axes, model_axis, attn_seq_shard and moe_ep equal the
    reference's for every arch and mode; its shard_heads is the port's
    head-split wq or attn_seq_shard (``dryrun.shardings_for``)."""
    monkeypatch.setattr(ref, "TRAIN_SHARDING", sharding)
    monkeypatch.setattr(dryrun, "TRAIN_SHARDING", sharding)
    jmesh, tmesh = _meshes(mesh)
    seq = 0
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for mode, spec_mode in MODES.items():
            a = dryrun.shardings_for(cfg, tmesh, mode)
            b = ref.shardings_for(jget_config(arch), jmesh, mode)
            assert (tuple(a.data_axes), a.model_axis, a.attn_seq_shard,
                    a.moe_ep) == (tuple(b.data_axes), b.model_axis,
                                  b.attn_seq_shard, b.moe_ep), (arch, mode)
            if mode == "train" and sharding == "fsdp":
                spec_mode = "train_fsdp"
            if cfg.n_heads:        # (mamba2 has no attention to split)
                heads = _wq_head_split(cfg, a, spec_mode)
                assert b.shard_heads == (heads or a.attn_seq_shard), \
                    (arch, mode)
            seq += a.attn_seq_shard
    # gemma's 8 heads over 16 model ranks: prefill, and train unless pure
    # FSDP (no tensor parallelism)
    assert seq == (1 if sharding == "fsdp" else 2)


def test_decode_capacity_follows_the_reference_rule():
    """The reference's rule (``repro/launch/dryrun.py``, input_specs): the
    sequence, the window's ring for long_500k, rounded down to a multiple
    of the model axis, at least one slot a rank."""
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for name in ("decode_32k", "long_500k"):
            for ms in (16, 3):
                shape = INPUT_SHAPES[name]
                cap = shape.seq_len
                if cfg.sliding_window and name == "long_500k":
                    cap = cfg.sliding_window
                assert dryrun.decode_capacity(cfg, shape, ms) == \
                    max(ms, cap // ms * ms)
    cfg = get_config("mixtral-8x7b")
    assert dryrun.decode_capacity(cfg, INPUT_SHAPES["long_500k"], 16) == 4096
    assert dryrun.decode_capacity(cfg, INPUT_SHAPES["decode_32k"], 3) == 32766


def _ref_local(shape, spec, sizes):
    return tuple(n // math.prod(sizes[a] for a in TSH.specs.axes_of(e))
                 for n, e in zip(shape, tuple(spec) + (None,) * len(shape)))


@pytest.mark.parametrize("mode", ["train", "train_fsdp", "serve"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rank_parameter_shapes_match_the_reference(arch, mode):
    """Each rank's block of every parameter (``empty_sharded`` on the
    meta device) against the reference's spec at {pod: 2, data: 16,
    model: 16}: its full shape over each split dim's axes."""
    sizes = {"pod": 2, "data": 16, "model": 16}
    names, dims = MESHES["2x16x16"]
    mesh = SimpleNamespace(mesh_dim_names=names, shape=dims)
    cfg, jcfg = get_config(arch), jget_config(arch)
    data_axes = ("pod", "data", "model") if mode == "train_fsdp" \
        else ("pod", "data")
    sh = T.Shardings(mesh=mesh, data_axes=data_axes,
                     moe_ep=mode != "train_fsdp")
    ep = TSH._ep(cfg, sizes, mode)
    tree = TSH._ref_shapes(arch, ep)
    spec_tree = jspecs.param_specs(tree, jcfg, mode,
                                   data_axes=("pod", "data"),
                                   axis_sizes=sizes)
    shapes = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
        shape = tuple(leaf.shape)
        if keys[0] in ("blocks", "enc_blocks"):
            keys.insert(1, "*")
            shape = shape[1:]
        shapes[".".join(keys)] = shape
    want = {}
    for key, spec in TSH._ref_flat(spec_tree).items():
        want[key] = _ref_local(shapes[key], spec, sizes)
    lm = empty_sharded(cfg, sh, mode, device="meta")
    got = {}
    for k, p in lm.named_parameters():
        parts = k.split(".")
        if parts[0] in ("blocks", "enc_blocks"):
            parts[1] = "*"
        key = ".".join(parts)
        assert got.setdefault(key, tuple(p.shape)) == tuple(p.shape), k
        assert p.shard_spec is not None
    assert got == want


def _same_but_kernels(a, b, seq_shard):
    for key in ("memory", "collectives"):
        assert a[key] == b[key], key
    assert a["flops"]["aten"] == b["flops"]["aten"]
    if not seq_shard:          # the seq-shard route's blocks differ in
        assert a["flops"] == b["flops"]      # live pairs on the kernels


@pytest.mark.parametrize("arch,shape", [
    ("granite-3-2b", "train_4k"), ("gemma-2b", "prefill_32k"),
    ("mixtral-8x7b", "decode_32k")])
def test_run_one_at_production_size(arch, shape):
    """Two layers of each at full width on a fake 16 x 16 world: a record
    with the reference's keys and no error, rank 0's and the last rank's
    the same counts (the seq-shard route aside, whose kernel flops follow
    each block's live pairs)."""
    rec = dryrun.run_one(arch, shape, False, layers=2)
    assert {"arch", "shape", "mesh", "n_params", "n_active", "kind"} <= \
        set(rec) and "error" not in rec and "skipped" not in rec
    assert (rec["mesh"], rec["kind"], rec["layers"]) == \
        ("16x16", INPUT_SHAPES[shape].kind, 2)
    assert rec["last_rank"]["rank"] == 255 and rec["rank"] == 0
    _same_but_kernels(rec, rec["last_rank"], arch == "gemma-2b")
    mem, coll = rec["memory"], rec["collectives"]
    assert 0 < mem["argument_bytes"] < mem["peak_bytes"]
    assert coll["count"] == sum(coll[k]["calls"] for k in
                                ("all_reduce", "max", "gather"))
    assert coll["world_bytes"] == coll["bytes"] * 256
    assert rec["flops"]["total"] > 0
    if arch == "gemma-2b":
        # seq-shard: one gather of each attention block's output a layer
        assert coll["gather"]["calls"] >= 2


def test_main_writes_skips_and_fails_with_an_error_record(tmp_path,
                                                          monkeypatch):
    out = str(tmp_path / "dry")
    assert dryrun.main(["--arch", "gemma-2b", "--shape", "long_500k",
                        "--mesh", "both", "--out", out]) == 0
    names = sorted(os.listdir(out))
    assert names == ["gemma-2b__long_500k__16x16.json",
                     "gemma-2b__long_500k__2x16x16.json"]
    rec = json.load(open(os.path.join(out, names[1])))
    assert rec["mesh"] == "2x16x16" and "full-attention" in rec["skipped"]

    def boom(*a, **k):
        raise RuntimeError("boom")

    monkeypatch.setattr(dryrun, "run_one", boom)
    assert dryrun.main(["--arch", "granite-3-2b", "--shape", "train_4k",
                        "--out", out]) == 1
    rec = json.load(open(os.path.join(out,
                                      "granite-3-2b__train_4k__16x16.json")))
    assert rec["error"] == "RuntimeError: boom"


# -- the kernel wrappers' branch for fake tensors -----------------------------


def test_fake_tensors_take_no_launch_and_count_the_kernels_work():
    """On fake CUDA tensors: outputs of the real route's shapes and dtypes,
    no launch or route counted, the kernels' flops added to FAKE_FLOPS;
    real CPU tensors add nothing."""
    flash_attn.reset_launches()
    ssd_scan.reset_launches()
    dev = torch.device("cuda", 0)
    B, Sq, Sk, Hq, Hkv, D, off = 2, 256, 512, 4, 2, 64, 256
    b, S, H, P, G, N, chunk = 2, 256, 8, 64, 1, 128, 128
    with FakeTensorMode():
        q = torch.empty((B, Sq, Hq, D), dtype=torch.bfloat16, device=dev)
        k = torch.empty((B, Sk, Hkv, D), dtype=torch.bfloat16, device=dev)
        out = flash_attn.flash_attention(q, k, k, q_offset=off, window=100)
        o2, lse = flash_attn._forward(q, k, k, True, 100, None, True, off)
        grads = flash_attn.flash_attention_backward(q, k, k, o2, lse, o2,
                                                    window=100, q_offset=off)
        x = torch.empty((b, S, H, P), device=dev)
        dt = torch.empty((b, S, H), device=dev)
        A = torch.empty((H,), device=dev)
        Bm = torch.empty((b, S, G, N), device=dev)
        y, hfin = ssd_scan.ssd_scan(x, dt, A, Bm, Bm, chunk)
        sgrads = ssd_scan.ssd_scan_backward(x, dt, A, Bm, Bm, x, None, chunk)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert out.device == dev and lse.shape == (B, Hq, Sq)
    assert [tuple(t.shape) for t in grads] == \
        [q.shape, k.shape, k.shape]
    assert (y.shape, hfin.shape) == ((b, S, H, P), (b, H, P, N))
    assert [tuple(t.shape) for t in sgrads] == \
        [(b, S, H, P), (b, S, H), (H,), (b, S, G, N), (b, S, G, N)]
    fwd = flash_attn.attention_flops(B, Sq, Sk, Hq, D, True, 100, off)
    assert flash_attn.FAKE_FLOPS == {
        "flash_attention": 2 * fwd,
        "flash_attention_backward": flash_attn.attention_flops(
            B, Sq, Sk, Hq, D, True, 100, off, backward=True)}
    assert fwd == 4 * D * B * Hq * sum(min(p, Sk - 1) - max(p - 99, 0) + 1
                                       for p in range(off, off + Sq))
    assert ssd_scan.FAKE_FLOPS == {
        "ssd_scan": ssd_scan.ssd_flops(b, S, H, P, G, N, chunk),
        "ssd_scan_backward": ssd_scan.ssd_bwd_flops(b, S, H, P, G, N,
                                                    chunk)}
    assert not any(flash_attn.LAUNCHES.values())
    assert not any(flash_attn.ROUTES.values())
    assert not any(ssd_scan.LAUNCHES.values())
    before = dict(flash_attn.FAKE_FLOPS)
    q = torch.randn((1, 8, 2, 16))
    flash_attn.flash_attention(q, q, q)
    assert flash_attn.FAKE_FLOPS == before
