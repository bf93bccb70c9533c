"""The port's language-model slice against the JAX package on the CPU.

Reduced configurations (2 layers, d_model <= 256); the weights are the JAX
package's ``init_model`` carried across by ``convert.lm_params_from_numpy``
and every input is made by numpy from a seed.  The port's plain route
(``"einsum"``) runs here; the kernels run only on a card
(``tests/test_torch_gpu.py``).

Tolerances.  fp32 layer math (RMSNorm statistics, RoPE) within 1e-5.
Everything that goes through a bf16 matmul or a bf16 residual stream is
compared to a few bf16 roundings: the two frameworks round at the same
places but their CPU matmuls sum in other orders, so an element can land
one bf16 step apart (2^-8 relative) and the difference grows through the
layers.  Logits (|logit| up to ~5): within 0.1, and the same argmax at 90%
of positions or more.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_parity  # noqa: E402,F401  (one torch thread per worker)
from repro.configs import get_config as jax_config  # noqa: E402
from repro.nn import attention as JA  # noqa: E402
from repro.nn import layers as JL  # noqa: E402
from repro.nn import ssm as JS  # noqa: E402
from repro.nn import transformer as JT  # noqa: E402
from repro.serve.engine import DecodeEngine as JaxDecodeEngine  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.train import checkpoint as jax_checkpoint  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.nn import attention as A  # noqa: E402
from repro_torch.nn import layers as L  # noqa: E402
from repro_torch.nn import ssm as S  # noqa: E402
from repro_torch.nn import transformer as T  # noqa: E402
from repro_torch.serve.engine import DecodeEngine, Request  # noqa: E402

LOGIT_ATOL = 0.1
ARGMAX_MIN = 0.9


def _models(arch, seed=0):
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jp = JT.init_model(jax.random.PRNGKey(seed), jcfg)
    tp = convert.lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    return jcfg, cfg, jp, tp


@pytest.fixture(scope="module")
def zamba():
    return _models("zamba2-1.2b")


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _logits_close(jl, tl):
    jl, tl = _np(jl), _np(tl)
    assert np.abs(jl - tl).max() <= LOGIT_ATOL, np.abs(jl - tl).max()
    agree = (jl.argmax(-1) == tl.argmax(-1)).mean()
    assert agree >= ARGMAX_MIN, agree


# -- layers ---------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    g = np.random.default_rng(0)
    x = g.standard_normal((2, 5, 48), dtype=np.float32) * 3
    scale = g.standard_normal(48, dtype=np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    exp = JL.rmsnorm({"scale": jnp.asarray(scale)}, jx)
    got = L.rmsnorm({"scale": torch.from_numpy(scale)}, tx)
    assert got.dtype == tx.dtype
    tol = 1e-5 if dtype == "float32" else 1e-2     # one bf16 rounding
    np.testing.assert_allclose(_np(got), _np(exp), rtol=tol, atol=tol)


def test_apply_rope_rotates_halves():
    g = np.random.default_rng(1)
    x = g.standard_normal((2, 7, 3, 16), dtype=np.float32)
    pos = g.integers(0, 5000, (2, 7))
    exp = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=1e-4,
                               rtol=1e-5)
    # the first half pairs with the second (not interleaved pairs)
    one = np.zeros((1, 1, 1, 16), np.float32)
    one[..., 0] = 1.0
    r = L.apply_rope(torch.from_numpy(one), torch.tensor([[1]]), 10000.0)
    assert r[..., 8].item() == pytest.approx(np.sin(1.0), abs=1e-6)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp(kind):
    g = np.random.default_rng(2)
    jp = JL.init_mlp(jax.random.PRNGKey(3), 64, 160, kind)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = g.standard_normal((2, 9, 64), dtype=np.float32)
    exp = JL.mlp(jp, jnp.asarray(x).astype(jnp.bfloat16), kind)
    got = L.mlp(tp, torch.from_numpy(x).to(torch.bfloat16), kind)
    assert got.dtype == torch.bfloat16
    scale = np.abs(_np(exp)).max()
    np.testing.assert_allclose(_np(got), _np(exp), rtol=0.02,
                               atol=0.02 * scale)


# -- attention decode -----------------------------------------------------------


@pytest.mark.parametrize("window", [None, 5])
def test_attention_decode_ring_cache_wraps(window):
    """Capacity 8, 13 tokens written: the ring wraps; each step's output
    equals the JAX package's."""
    g = np.random.default_rng(4)
    B, C, Hq, Hkv, D = 2, 8, 4, 2, 16
    jc = JA.init_kv_cache(B, C, Hkv, D)
    tc = A.init_kv_cache(B, C, Hkv, D)
    for _ in range(13):
        q, k, v = (g.standard_normal((B, 1, H, D), dtype=np.float32)
                   for H in (Hq, Hkv, Hkv))
        jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
        tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16)
                      for a in (q, k, v))
        jc = JA.cache_update(jc, jk, jv)
        tc = A.cache_update(tc, tk, tv)
        exp = JA.attention_decode(jq, jc, window=window)
        got = A.attention_decode(tq, tc, window=window)
        np.testing.assert_allclose(_np(got), _np(exp), atol=2e-2, rtol=2e-2)
    assert tc.length == 13
    np.testing.assert_array_equal(_np(tc.k), _np(jc.k))


# -- Mamba2 ---------------------------------------------------------------------


def test_apply_mamba2_and_decode_step():
    """The block on a 64-step prefix (chunk 32), then 4 decode steps from
    a fresh state, each against the JAX package."""
    jcfg = jax_config("mamba2-1.3b").reduced()
    cfg = get_config("mamba2-1.3b").reduced()
    d = cfg.d_model
    jp = JS.init_mamba2(jax.random.PRNGKey(5), d, jcfg.ssm)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(6).standard_normal((2, 64, d),
                                                 dtype=np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    exp = JS.apply_mamba2(jp, jx, d, jcfg.ssm)
    got = S.apply_mamba2(tp, tx, d, cfg.ssm)
    scale = np.abs(_np(exp)).max()
    np.testing.assert_allclose(_np(got), _np(exp), rtol=0.05,
                               atol=0.02 * scale)
    js = JS.init_ssm_state(2, d, jcfg.ssm)
    ts = S.init_ssm_state(2, d, cfg.ssm)
    for t in range(4):
        jy, js = JS.ssd_decode_step(jp, jx[:, t:t + 1], js, d, jcfg.ssm)
        ty, ts = S.ssd_decode_step(tp, tx[:, t:t + 1], ts, d, cfg.ssm)
        np.testing.assert_allclose(_np(ty), _np(jy), rtol=0.05,
                                   atol=0.02 * scale)
        np.testing.assert_allclose(ts.h.numpy(), np.asarray(js.h),
                                   rtol=1e-3, atol=1e-3)
    # decode over the prefix gives the block's prefill output
    np.testing.assert_allclose(_np(ty), _np(got[:, 3:4]), rtol=0.05,
                               atol=0.02 * scale)


# -- whole models ---------------------------------------------------------------


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "mamba2-1.3b",
                                  "h2o-danube-1.8b", "gemma-2b",
                                  "granite-3-2b", "glm4-9b",
                                  "chameleon-34b"])
def test_forward_matches_reference(arch):
    """zamba2 (hybrid: Mamba2 + the shared attention block, S = 96 > its
    reduced window of 64), mamba2 (pure SSM), danube (dense, sliding
    window), gemma (MQA, GeGLU, tied embeddings), granite (GQA, tied
    embeddings), glm4 (GQA) and chameleon (vlm: the dense blocks)."""
    jcfg, cfg, jp, tp = _models(arch)
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 96))
    exp = JT.forward(jp, jnp.asarray(toks), jcfg, remat=False)
    with torch.no_grad():
        got = T.forward(tp, torch.from_numpy(toks), cfg)
    assert got.logits.shape == (2, 96, cfg.vocab)
    assert got.logits.dtype == torch.float32
    _logits_close(exp.logits, got.logits)
    assert float(got.moe_aux) == 0.0


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "gemma-2b"])
def test_decode_steps_match_reference(arch, zamba):
    """Eight teacher-forced ``decode_step`` calls (B = 2) against the JAX
    package's jitted step: the zamba2 hybrid, and gemma's MQA (one kv head
    for every q head) against its ring caches."""
    jcfg, cfg, jp, tp = zamba if arch == "zamba2-1.2b" else _models(arch)
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (2, 8))
    jstep = jax.jit(lambda st, tok: JT.decode_step(jp, st, tok, jcfg))
    js = JT.init_decode_state(jp, jcfg, 2, capacity=16)
    ts = T.init_decode_state(tp, cfg, 2, capacity=16)
    jl, tl = [], []
    with torch.no_grad():
        for t in range(8):
            lj, js = jstep(js, jnp.asarray(toks[:, t:t + 1], jnp.int32))
            lt, ts = T.decode_step(tp, ts, torch.from_numpy(toks[:, t:t + 1]),
                                   cfg)
            jl.append(np.asarray(lj))
            tl.append(lt.numpy())
    _logits_close(np.concatenate(jl, 1), np.concatenate(tl, 1))
    if arch == "gemma-2b":
        assert cfg.n_kv_heads == 1 and len(ts.kv) == cfg.n_layers
        assert ts.kv[0].length == 8 and ts.kv[0].k.shape[2] == 1
    else:
        assert len(ts.ssm) == cfg.n_layers and len(ts.shared_kv) == 1
        assert ts.shared_kv[0].length == 8


def test_decode_agrees_with_forward(zamba):
    """The port's own decode, teacher-forced over a 64-token prompt, gives
    the forward's argmax at > 85% of positions (the JAX package's bar;
    this case gives 100%)."""
    _, cfg, _, tp = zamba
    toks = torch.from_numpy(
        np.random.default_rng(9).integers(0, cfg.vocab, (1, 64)))
    with torch.no_grad():
        fwd = T.forward(tp, toks, cfg).logits.argmax(-1)[0]
        st = T.init_decode_state(tp, cfg, 1, capacity=64)
        preds = []
        for t in range(64):
            lg, st = T.decode_step(tp, st, toks[:, t:t + 1], cfg)
            preds.append(int(lg[0, 0].argmax()))
    assert (torch.tensor(preds) == fwd).float().mean() > 0.85


def test_decode_engine_matches_reference_engine(zamba):
    """Greedy tokens of the port's engine against the JAX package's, same
    weights and prompts (4 requests, 2 slots, 8 new tokens each): equal at
    90% of the generated positions or more (a bf16 near-tie can send one
    request down another path; this case gives 100%)."""
    jcfg, cfg, jp, tp = zamba
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, cfg.vocab, rng.integers(4, 12)).tolist()
               for _ in range(4)]
    jeng = JaxDecodeEngine(jp, jcfg, batch=2, capacity=64)
    teng = DecodeEngine(tp, cfg, batch=2, capacity=64)
    for i, p in enumerate(prompts):
        jeng.submit(JaxRequest(rid=i, prompt=list(p), max_new=8))
        teng.submit(Request(rid=i, prompt=list(p), max_new=8))
    jreqs, treqs = list(jeng.queue), list(teng.queue)
    jeng.run()
    teng.run()
    assert all(r.done and len(r.out) == 8 for r in treqs)
    same = np.mean([a == b for jr, tr in zip(jreqs, treqs)
                    for a, b in zip(jr.out, tr.out)])
    assert same >= 0.9, same


def test_decode_engine_samples_from_its_generator(zamba):
    _, cfg, _, tp = zamba
    outs = []
    for _ in range(2):
        eng = DecodeEngine(tp, cfg, batch=2, capacity=32, greedy=False,
                           seed=3)
        reqs = [Request(rid=i, prompt=[1, 2, 3], max_new=6) for i in range(3)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]
    assert all(0 <= t < cfg.vocab for o in outs[0] for t in o)


def test_checkpoint_from_the_reference_serves_in_the_port(tmp_path, zamba):
    """A checkpoint written by ``repro.train.checkpoint.save`` loads through
    ``load_lm_checkpoint`` with the same weights, key for key."""
    jcfg, cfg, jp, tp = zamba
    path = str(tmp_path / "zamba.npz")
    jax_checkpoint.save(path, jp)
    loaded = convert.load_lm_checkpoint(path, cfg, "cpu")
    a, b = loaded.state_dict(), tp.state_dict()
    assert a.keys() == b.keys()
    assert "blocks.1.mamba.w_z" in a and "shared_attn.attn.wq" in a
    assert all(torch.equal(a[k], b[k]) for k in a)
    np.testing.assert_array_equal(
        a["blocks.1.mamba.A_log"].numpy(),
        np.asarray(jp["blocks"]["mamba"]["A_log"][1]))


def test_init_model_shapes_and_seed():
    cfg = get_config("zamba2-1.2b").reduced()
    a = T.init_model(torch.Generator().manual_seed(0), cfg)
    b = T.init_model(torch.Generator().manual_seed(0), cfg)
    jp = JT.init_model(jax.random.PRNGKey(0), jax_config("zamba2-1.2b")
                       .reduced())
    ref = convert.lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu").state_dict()
    sa = a.state_dict()
    assert sa.keys() == ref.keys()
    assert all(sa[k].shape == ref[k].shape for k in sa)
    assert all(torch.equal(sa[k], b.state_dict()[k]) for k in sa)
    assert not any(p.requires_grad for p in a.parameters())


def test_modules_call_the_functions(zamba):
    """An ``LM`` and its blocks are ``nn.Module``s: calling them runs
    ``forward``, ``mamba_block`` and ``dense_block``."""
    _, cfg, _, tp = zamba
    toks = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab, (1, 32)))
    x = torch.randn((1, 32, cfg.d_model),
                    generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    with torch.no_grad():
        assert torch.equal(tp(toks).logits, T.forward(tp, toks, cfg).logits)
        assert torch.equal(tp["blocks"][0](x),
                           T.mamba_block(tp["blocks"][0], x, cfg))
        assert torch.equal(tp["shared_attn"](x),
                           T.dense_block(tp["shared_attn"], x, cfg))


def test_forward_refuses_a_mesh(zamba):
    """The refusals of attention split over the sequence
    (``attn_seq_shard``) on a model axis of more than one rank: attention
    weights split by head over ``model`` (the route needs them whole on
    every rank), and a sequence that does not divide over ``model``."""
    from types import SimpleNamespace

    _, cfg, _, tp = zamba
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 2))
    sh = T.Shardings(mesh=mesh, attn_seq_shard=True)
    whole = dict(tp["shared_attn"]["attn"].items())
    x = torch.zeros((1, 4, cfg.d_model), dtype=torch.bfloat16)
    split = {k: v.detach().clone() for k, v in whole.items()}
    split["wq"].shard_spec = (None, "model", None)
    with pytest.raises(ValueError, match=r"\['wq'\] are split by head"):
        T.attention_block(split, x, cfg, sh=sh)
    with pytest.raises(ValueError, match="5 positions does not split"):
        T.attention_block(whole, x[:, :1].expand(1, 5, -1), cfg, sh=sh)


def test_serve_driver_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve

    assert serve.main(["--arch", "zamba2-1.2b", "--device", "cpu",
                       "--requests", "3", "--max-new", "4"]) == 0
    assert "3 requests, 12 tokens" in capsys.readouterr().out
    # without --arch the driver serves the async PGM tier, on the card
    # unless --device cpu asks for the CPU (no silent fallback)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main([])
    assert serve.main(["--mode", "exact", "--device", "cpu", "--duration",
                       "0.3", "--load", "100"]) == 0
    assert "async PGM tier up" in capsys.readouterr().err
