"""``repro_torch.sharding`` against ``repro.sharding``: the partition specs
of every config's parameters, optimizer states and decode states, in each
mode and at each mesh size, and the split / gather round trip.

The reference's trees are ``jax.eval_shape`` of ``repro.nn.transformer``'s
initialisers at full size (no memory); its stacked ``blocks`` leaves carry a
leading ``None`` for the layer axis, which the port's one-module-a-layer
tree does not have.  The port's trees are built on the ``meta`` device
(``sharding.param_shapes``).  Specs must be equal entry for entry.
"""

import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.nn import transformer as JT  # noqa: E402
from repro.sharding import specs as jspecs  # noqa: E402
from repro.train import step as jts  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.nn import transformer as T  # noqa: E402
from repro_torch.sharding import params as sp  # noqa: E402
from repro_torch.sharding import specs  # noqa: E402
from repro_torch.train import step as ts  # noqa: E402

ARCHS = ("chameleon-34b", "gemma-2b", "glm4-9b", "granite-3-2b",
         "h2o-danube-1.8b", "mamba2-1.3b", "mixtral-8x7b",
         "phi3.5-moe-42b-a6.6b", "whisper-medium", "zamba2-1.2b")
MODES = ("train", "train_fsdp", "serve", "decode")
MESHES = ({"data": 2, "model": 2}, {"data": 1, "model": 4},
          {"data": 16, "model": 16})
DECODE_B, DECODE_C = 32, 64


def _ep(cfg, sizes, mode):
    """The reference's dry run: EP over the model axis except pure FSDP."""
    return 1 if (cfg.moe is None or mode == "train_fsdp") else sizes["model"]


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch, ep):
    cfg = jget_config(arch)
    return jax.eval_shape(lambda: JT.init_model(jax.random.PRNGKey(0), cfg,
                                                ep_shards=ep))


@functools.lru_cache(maxsize=None)
def _port_shapes(arch, ep):
    return specs.param_shapes(get_config(arch), ep_shards=ep, trainable=True)


def _ref_flat(tree, stacked=("blocks", "enc_blocks")):
    """{port name pattern: spec} of a reference spec tree: a stacked leaf's
    name holds ``*`` for the layer and its spec drops the leading None."""
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    )[0]:
        keys = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
        spec = tuple(spec)
        if keys[0] in stacked:
            keys.insert(1, "*")
            assert spec[0] is None
            spec = spec[1:]
        out[".".join(keys)] = spec
    return out


def _port_flat(port: dict, n_layers: dict) -> dict:
    """{name with the layer replaced by ``*``: spec}, checking every layer
    of a stack has the same spec."""
    out = {}
    for k, spec in port.items():
        parts = k.split(".")
        if parts[0] in n_layers:
            parts[1] = "*"
        key = ".".join(parts)
        assert out.setdefault(key, spec) == spec, k
    return out


def _layers(cfg):
    n = {"blocks": cfg.n_layers}
    if cfg.encoder is not None:
        n["enc_blocks"] = cfg.encoder.n_layers
    return n


def _assert_param_specs(arch, mode, sizes):
    cfg, jcfg = get_config(arch), jget_config(arch)
    ep = _ep(cfg, sizes, mode)
    ref = _ref_flat(jspecs.param_specs(_ref_shapes(arch, ep), jcfg, mode,
                                       axis_sizes=sizes))
    lm = _port_shapes(arch, ep)
    got = specs.param_specs(lm, cfg, mode, axis_sizes=sizes)
    assert list(got) == [k for k, _ in lm.named_parameters()]
    assert _port_flat(got, _layers(cfg)) == ref
    return got


@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: "x".join(
    str(v) for v in s.values()))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, mode, sizes):
    got = _assert_param_specs(arch, mode, sizes)
    # every split dim divides (fix_spec), so each rank's block is whole
    lm = _port_shapes(arch, _ep(get_config(arch), sizes, mode))
    for k, p in lm.named_parameters():
        for dim, entry in zip(p.shape, got[k]):
            assert dim % math.prod(sizes.get(a, 1)
                                   for a in specs.axes_of(entry)) == 0, k


@pytest.mark.parametrize("optimizer", ("adamw", "vb"))
@pytest.mark.parametrize("mode", ("train", "train_fsdp"))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_specs_match_reference(arch, mode, optimizer):
    sizes = {"data": 2, "model": 2}
    cfg, jcfg = get_config(arch), jget_config(arch)
    ep = _ep(cfg, sizes, mode)
    init = jts.init_train_state if optimizer == "adamw" \
        else jts.init_vb_state
    jstate = jax.eval_shape(init, _ref_shapes(arch, ep))
    ref = jspecs.train_state_specs(jstate, jcfg, axis_sizes=sizes, mode=mode)
    lm = _port_shapes(arch, ep)
    state = (ts.init_train_state if optimizer == "adamw"
             else ts.init_vb_state)(lm)
    got = specs.train_state_specs(state, cfg, axis_sizes=sizes, mode=mode)
    pspec = _port_flat(got.params, _layers(cfg))
    if optimizer == "adamw":
        trees = {"m": (got.opt.m, ref.opt.m), "v": (got.opt.v, ref.opt.v)}
        assert got.opt.step == tuple(ref.opt.step) == ()
    else:
        trees = {f: (getattr(got.vb, f), getattr(ref.vb, f))
                 for f in ("mean", "fisher", "prior_mean", "prior_prec")}
        assert got.vb.step == tuple(ref.vb.step) == ()
    assert got.step == tuple(ref.step) == ()
    for name, (mine, theirs) in trees.items():
        assert _port_flat(mine, _layers(cfg)) == _ref_flat(theirs) \
            == pspec, name


@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: "x".join(
    str(v) for v in s.values()))
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_specs_match_reference(arch, sizes):
    cfg, jcfg = get_config(arch), jget_config(arch)
    ep = _ep(cfg, sizes, "decode")
    enc = None
    if cfg.arch_type == "audio":
        enc = jax.ShapeDtypeStruct((DECODE_B, cfg.encoder.enc_len,
                                    cfg.d_model), jnp.float32)
    jstate = jax.eval_shape(
        lambda p, e: JT.init_decode_state(p, jcfg, DECODE_B, DECODE_C,
                                          enc_input=e),
        _ref_shapes(arch, ep), enc)
    ref = jspecs.decode_state_specs(jstate, jcfg, axis_sizes=sizes)
    penc = None if enc is None else torch.empty(enc.shape, device="meta")
    state = T.init_decode_state(_port_shapes(arch, ep), cfg, DECODE_B,
                                DECODE_C, enc_input=penc, backend="einsum")
    got = specs.decode_state_specs(state, cfg, axis_sizes=sizes)
    for field in ("kv", "ssm", "shared_kv"):
        mine, theirs = getattr(got, field), getattr(ref, field)
        assert (mine is None) == (theirs is None), field
        if mine is None:
            continue
        n = jax.tree_util.tree_leaves(getattr(jstate, field))[0].shape[0]
        assert len(mine) == n, field
        for layer in mine:
            for f in layer._fields:
                assert tuple(getattr(layer, f)) == tuple(
                    getattr(theirs, f))[1:], (field, f)
    if cfg.arch_type == "audio":
        for layer in got.enc_kv:
            assert [tuple(t) for t in layer] == [tuple(t)[1:]
                                                 for t in ref.enc_kv]
    else:
        assert got.enc_kv is None and ref.enc_kv is None


def test_fix_spec_replicates_granites_vocab():
    """49155 rows split over no even model axis, as in the reference."""
    sizes = {"data": 2, "model": 2}
    got = specs.param_specs({"embed.table": (49155, 2048)}, None, "train",
                            axis_sizes=sizes)
    assert got["embed.table"] == (None, "data") == tuple(
        jspecs.fix_spec(jax.sharding.PartitionSpec("model", "data"),
                        (49155, 2048), sizes))


class _Mesh:
    """The geometry a ``DeviceMesh`` gives ``shard_tensor`` / ``place``
    at one coordinate of a ("data", "model") mesh."""

    mesh_dim_names = ("data", "model")

    def __init__(self, sizes, coords):
        self.shape = tuple(sizes[a] for a in self.mesh_dim_names)
        self.coords = coords

    def get_local_rank(self, axis):
        return self.coords[axis]


_ENTRY = st.sampled_from([None, "data", "model", ("data", "model"),
                          ("model", "data")])


@settings(max_examples=60, deadline=None)
@given(shape=st.lists(st.integers(1, 12), min_size=1, max_size=3),
       entries=st.lists(_ENTRY, min_size=3, max_size=3),
       data=st.integers(1, 4), model=st.integers(1, 4))
def test_shard_then_gather_round_trips(shape, entries, data, model):
    """Every coordinate's block placed back (what ``gather_tensor`` sums
    over the ranks) rebuilds the tensor, each element counted once per
    rank that replicates it; dims the axes do not divide are replicated by
    ``fix_spec``.  Axes a spec names twice are left out (no spec does)."""
    sizes = {"data": data, "model": model}
    spec = []
    used = set()
    for e in entries[:len(shape)]:
        axes = specs.axes_of(e)
        spec.append(None if used & set(axes) else e)
        used |= set(axes)
    spec = specs.fix_spec(tuple(spec), tuple(shape), sizes)
    full = torch.arange(math.prod(shape), dtype=torch.float32).reshape(shape)
    total = torch.zeros_like(full)
    for i in range(data):
        for j in range(model):
            mesh = _Mesh(sizes, {"data": i, "model": j})
            block = sp.shard_tensor(full, spec, mesh)
            assert block.is_contiguous()
            total += sp.place(block, spec, mesh)
    split = {a for e in spec for a in specs.axes_of(e)}
    copies = math.prod(n for a, n in sizes.items() if a not in split)
    assert torch.equal(total, full * copies)


def test_shard_tensor_refuses_an_uneven_split():
    with pytest.raises(ValueError, match="does not split"):
        sp.shard_tensor(torch.zeros(5, 4), ("model", None),
                        _Mesh({"data": 1, "model": 2},
                              {"data": 0, "model": 0}))


def test_meta_shapes_are_init_models():
    """``param_shapes`` (no memory) has the names and shapes of a real
    ``init_model``, at every EP layout the specs are computed for."""
    for arch in ("granite-3-2b", "mixtral-8x7b", "zamba2-1.2b",
                 "whisper-medium"):
        cfg = get_config(arch).reduced()
        for ep in ((1, 2, 4) if cfg.moe else (1,)):
            real = T.init_model(torch.Generator().manual_seed(0), cfg,
                                ep_shards=ep)
            meta = specs.param_shapes(cfg, ep_shards=ep)
            assert [(k, p.shape) for k, p in real.named_parameters()] == \
                [(k, p.shape) for k, p in meta.named_parameters()]
            assert all(p.device.type == "meta" for p in meta.parameters())
            jp = JT.init_model(jax.random.PRNGKey(0), jget_config(arch)
                               .reduced(), ep_shards=ep)
            if cfg.moe:
                np.testing.assert_array_equal(
                    np.asarray(jp["blocks"]["moe"]["w_gate"]).shape[1:],
                    tuple(real["blocks"][0]["moe"]["w_gate"].shape))
