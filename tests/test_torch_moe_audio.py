"""The port's mixture-of-experts (mixtral, phi3.5-moe) and encoder-decoder
(whisper) families against the JAX package on the CPU.

Reduced configurations (2 layers, d_model <= 256, 4 experts, whisper's
encoder 2 layers over 64 frames); the weights are the JAX package's
``init_model`` carried across by ``convert.lm_params_from_numpy``, and every
input is made by numpy from a seed.  The port's plain route (``"einsum"``)
runs here; ``flash_attention``'s kernel runs only on a card
(``tests/test_torch_gpu.py``).

Tolerances.  fp32 layer math (LayerNorm statistics, learned positions)
within 1e-5.  The router runs in fp32 on the same input in both packages:
the same experts exactly and gates at rtol 1e-5.  A mixture-of-experts
output on the same input: the same kept (token, k) pairs exactly, and y
within one bf16 step (ulp) at max |y| (each expert output is a bf16 product
whose fp32 sums run in another order, so an element can land one step
apart).  Whole models, as in ``test_torch_lm.py``: logits within 0.1 (|logit|
up to ~5), the same argmax at >= 90% of positions, ``moe_aux`` at rtol 1e-3.

Route flips.  Between the layers the residual stream is bf16, and the two
frameworks round it at the same places but sum in other orders, so a
router's input can differ by a bf16 step or two.  Where that moves a
token's choice (a near-tie), the whole-model test shows it is one: on the
reference's own router input the port picks the reference's experts, and
the contested logits lie within the drift of the input (and within
``NEAR_TIE``).  A flipped token's logits, and those a flip reaches (later
positions of its sequence through attention in the next layers, and the
pairs whose kept/dropped status the shifted ranks change), are left out of
the logit bar; every position still counts in the argmax bar.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_parity  # noqa: E402,F401  (one torch thread per worker)
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs.base import MoEConfig as JaxMoEConfig  # noqa: E402
from repro.nn import layers as JL  # noqa: E402
from repro.nn import moe as JM  # noqa: E402
from repro.nn import transformer as JT  # noqa: E402
from repro.train import checkpoint as jax_checkpoint  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.nn import layers as L  # noqa: E402
from repro_torch.nn import moe as M  # noqa: E402
from repro_torch.nn import transformer as T  # noqa: E402
from repro_torch.serve.engine import DecodeEngine, Request  # noqa: E402

LOGIT_ATOL = 0.1
ARGMAX_MIN = 0.9
AUX_RTOL = 1e-3
NEAR_TIE = 0.02       # contested router logits of a flipped route; router
                      # logits are O(1) and the 2nd-3rd choice gap is ~0.3
                      # on average
MOE_ARCHS = ("mixtral-8x7b", "phi3.5-moe-42b-a6.6b")
WHISPER = "whisper-medium"
S_TOK = 96


def _models(arch, seed=0):
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jp = JT.init_model(jax.random.PRNGKey(seed), jcfg)
    tp = convert.lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    return jcfg, cfg, jp, tp


@pytest.fixture(scope="module")
def mixtral():
    return _models("mixtral-8x7b")


@pytest.fixture(scope="module")
def whisper():
    return _models(WHISPER)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _enc_input(cfg, batch, seed):
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.encoder.enc_len, cfg.d_model), dtype=np.float32)


def _keep(idx, E, cap):
    """[T, K] expert ids -> [T, K] kept mask (rank < cap), in numpy."""
    flat = np.asarray(idx).reshape(-1)
    oh = np.eye(E, dtype=np.int64)[flat]
    pos = (np.cumsum(oh, 0) - 1)[np.arange(flat.size), flat]
    return (pos < cap).reshape(np.asarray(idx).shape)


def _bf16_step(x):
    """One bf16 step (ulp) at |x|."""
    return 2.0 ** (np.floor(np.log2(x)) - 7)


# -- layers ---------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm(dtype):
    g = np.random.default_rng(0)
    x = g.standard_normal((2, 5, 48), dtype=np.float32) * 3 + 1
    scale, bias = (g.standard_normal(48, dtype=np.float32) for _ in "sb")
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jp = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    tp = {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}
    exp, got = JL.layernorm(jp, jx), L.layernorm(tp, tx)
    assert got.dtype == tx.dtype
    tol = 1e-5 if dtype == "float32" else 1e-2     # one bf16 rounding
    np.testing.assert_allclose(_np(got), _np(exp), rtol=tol, atol=tol)
    init = L.init_layernorm(48)
    ref = JL.init_layernorm(48)
    assert all(np.array_equal(init[k].numpy(), np.asarray(ref[k]))
               for k in ("scale", "bias"))


@pytest.mark.parametrize("offset", [0, 5])
def test_add_pos(offset):
    g = np.random.default_rng(1)
    table = g.standard_normal((40, 16), dtype=np.float32)
    x = g.standard_normal((2, 7, 16), dtype=np.float32)
    exp = JL.add_pos({"pos": jnp.asarray(table)},
                     jnp.asarray(x).astype(jnp.bfloat16), offset)
    got = L.add_pos({"pos": torch.from_numpy(table)},
                    torch.from_numpy(x).to(torch.bfloat16), offset)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(exp))
    p = L.init_pos_embedding(torch.Generator().manual_seed(0), 40, 16)
    assert p["pos"].shape == (40, 16) and float(p["pos"].std()) < 0.02


# -- mixture of experts ----------------------------------------------------------


def _moe_inputs(E, K, cf, seed=1, d=128, ff=256, B=2, S=96):
    jcfg, cfg = JaxMoEConfig(E, K, cf), MoEConfig(E, K, cf)
    jp = JM.init_moe(jax.random.PRNGKey(seed), d, ff, jcfg)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(seed + 1).standard_normal((B, S, d),
                                                        dtype=np.float32)
    return jcfg, cfg, jp, tp, x


@pytest.mark.parametrize("E,K", [(4, 2), (8, 2), (16, 1)])
def test_route_matches_reference(E, K):
    """fp32 router on the same input: the same experts exactly (a stable
    top-k, the lower index first on ties), gates at rtol 1e-5, the aux
    losses at rtol 1e-5."""
    jcfg, cfg, jp, tp, x = _moe_inputs(E, K, 1.25)
    x2 = x.reshape(-1, x.shape[-1])
    jg, ji, ja = JM._route(jp["router"], jnp.asarray(x2), jcfg)
    tg, ti, ta = M._route(tp["router"], torch.from_numpy(x2), cfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-7)
    for a, b in zip(ta, ja):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)


def test_top_k_takes_the_lower_index_on_ties():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4]])
    _, idx = M._top_k(probs, 2)
    _, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == [[0, 1], [1, 3]] == np.asarray(jidx).tolist()


def test_capacity_and_ranks():
    cfg = MoEConfig(8, 2, 1.25)
    assert M.capacity(16384, cfg) == 5120       # chip_smoke's mixtral
    assert M.capacity(4, cfg) == 8              # a decode step: at least 8
    assert M.capacity(100, MoEConfig(4, 2, 1.0)) == 56     # ceil8(50)
    flat = torch.tensor([0, 1, 1, 0, 1, 2])
    assert M.ranks(flat, 3).tolist() == [0, 0, 1, 1, 2, 0]


@pytest.mark.parametrize("E,K,cf", [(4, 2, 1.25), (4, 2, 0.5), (8, 2, 0.75),
                                    (16, 2, 1.0)])
def test_apply_moe_matches_reference(E, K, cf):
    """bf16 input, the same to both: the same kept pairs (>= 5% dropped at
    cf < 1.25), y within one bf16 step at max |y|, aux at rtol 1e-4."""
    jcfg, cfg, jp, tp, x = _moe_inputs(E, K, cf)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    jy, ja = JM.apply_moe(jp, jx, jcfg)
    ty, ta = M.apply_moe(tp, tx, cfg)
    assert ty.dtype == torch.bfloat16 and ty.shape == tx.shape
    T_ = x.shape[0] * x.shape[1]
    cap = M.capacity(T_, cfg)
    _, ji, _ = JM._route(jp["router"], jx.reshape(T_, -1), jcfg)
    _, ti, _ = M._route(tp["router"], tx.reshape(T_, -1), cfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    pos = M.ranks(ti.reshape(-1), E).reshape(T_, K)
    keep = _keep(ji, E, cap)
    np.testing.assert_array_equal((pos < cap).numpy(), keep)
    if cf < 1.25:
        assert 1 - keep.mean() >= 0.05, keep.mean()
    top = np.abs(_np(jy)).max()
    assert np.abs(_np(ty) - _np(jy)).max() <= _bf16_step(top)
    for a, b in zip(ta, ja):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4)


def test_apply_moe_dropped_pairs_add_nothing():
    """At capacity 8 a token whose every pair is dropped gets y = 0, and
    two calls give the same bits (no atomics)."""
    _, cfg, _, tp, x = _moe_inputs(4, 2, 0.05)
    tx = torch.from_numpy(x[:, :40]).to(torch.bfloat16)       # T = 80
    assert M.capacity(80, cfg) == 8
    y, _ = M.apply_moe(tp, tx, cfg)
    _, idx, _ = M._route(tp["router"], tx.reshape(80, -1), cfg)
    dropped = ~(M.ranks(idx.reshape(-1), 4) < 8).reshape(80, 2).any(1)
    assert dropped.sum() > 0
    assert float(y.reshape(80, -1)[dropped].abs().max()) == 0.0
    assert torch.equal(y, M.apply_moe(tp, tx, cfg)[0])


def test_apply_moe_refuses_a_mesh():
    """A mesh must be a ``DeviceMesh`` (the expert-parallel route itself is
    held against the reference's in ``test_torch_mesh.py``)."""
    _, cfg, _, tp, x = _moe_inputs(4, 2, 1.25)
    with pytest.raises(TypeError, match="DeviceMesh"):
        M.apply_moe(tp, torch.from_numpy(x), cfg, mesh=object())


def test_ep_split_layouts_match_reference():
    w = np.arange(4 * 6 * 8, dtype=np.float32).reshape(4, 6, 8)
    wd = w.reshape(4, 8, 6)
    for s in (1, 2, 4, 8):
        np.testing.assert_array_equal(
            M.ep_split(torch.from_numpy(w), s).numpy(),
            np.asarray(JM.ep_split(jnp.asarray(w), s)))
        np.testing.assert_array_equal(
            M.ep_split_down(torch.from_numpy(wd), s).numpy(),
            np.asarray(JM.ep_split_down(jnp.asarray(wd), s)))


# -- whole models ---------------------------------------------------------------


def _recorder(mod, calls):
    route = mod._route

    def rec(router_w, x, cfg):
        out = route(router_w, x, cfg)
        calls.append((router_w, x, out[1]))
        return out
    return rec


def _jax_moe_forward(jp, jcfg, toks):
    """The reference's moe forward, layer by layer (eagerly, so its routes
    can be recorded): logits and the summed aux."""
    x = JL.embed(jp["embed"], jnp.asarray(toks))
    lb, z = [], []
    for i in range(jcfg.n_layers):
        pl = jax.tree_util.tree_map(lambda a: a[i], jp["blocks"])
        x, aux = JT.moe_block(pl, x, jcfg, JT.NO_SHARD)
        lb.append(aux.load_balance)
        z.append(aux.router_z)
    x = JL.rmsnorm(jp["final_norm"], x, jcfg.norm_eps)
    head = jp["embed"] if jcfg.tie_embeddings else jp["lm_head"]
    return JL.unembed(head, x), sum(lb) + 0.001 * sum(z)


def _route_flips(jcalls, tcalls, cfg, B, S):
    """Per layer, the tokens whose routes differ between the packages, each
    shown to be a near-tie; returns the [B, S] mask of positions a flip or
    a changed kept set reaches."""
    E, K, n_layers = cfg.moe.n_experts, cfg.moe.top_k, cfg.n_layers
    cap = M.capacity(B * S, cfg.moe)
    reached = np.zeros((B, S), bool)
    for layer, ((_, jx, ji), (router, tx, ti)) in enumerate(
            zip(jcalls, tcalls)):
        ji, ti = np.asarray(ji), ti.numpy()
        flips = np.where((ji != ti).any(1))[0]
        jx_t = torch.from_numpy(np.asarray(jx, np.float32))
        for t in flips:
            # the routers agree on the same input: the flip is the input's
            _, on_ref_input, _ = M._route(router, jx_t[t:t + 1], cfg.moe)
            assert on_ref_input[0].tolist() == ji[t].tolist(), (layer, t)
            k = int(np.argmax(ji[t] != ti[t]))
            lt = tx[t].float() @ router
            lj = jx_t[t] @ router
            a, b = int(ji[t, k]), int(ti[t, k])
            gap = float((lt[a] - lt[b]).abs())
            drift = float((lt - lj).abs().max())
            assert gap <= 2 * drift and gap <= NEAR_TIE, (layer, t, gap,
                                                           drift)
        changed = flips.tolist() + np.where(
            (_keep(ji, E, cap) != _keep(ti, E, cap)).any(1))[0].tolist()
        for t in changed:
            b, s = divmod(int(t), S)
            if layer == n_layers - 1:
                reached[b, s] = True
            else:
                reached[b, s:] = True
    return reached


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_matches_reference(arch, monkeypatch):
    """mixtral (sliding window, S = 96 > its reduced window of 64) and
    phi3.5-moe against the reference's blocks run layer by layer (so that
    its routes can be recorded): logits, the argmax and ``moe_aux``, with
    any route flip shown to be a near-tie (module docstring); then against
    the reference's ``forward`` on the argmax and ``moe_aux``."""
    jcfg, cfg, jp, tp = _models(arch)
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, S_TOK))
    jcalls, tcalls = [], []
    monkeypatch.setattr(JM, "_route", _recorder(JM, jcalls))
    monkeypatch.setattr(M, "_route", _recorder(M, tcalls))
    exp, exp_aux = _jax_moe_forward(jp, jcfg, toks)
    with torch.no_grad():
        got = T.forward(tp, torch.from_numpy(toks), cfg)
    monkeypatch.undo()
    assert got.logits.shape == (2, S_TOK, cfg.vocab)
    assert len(jcalls) == len(tcalls) == cfg.n_layers
    reached = _route_flips(jcalls, tcalls, cfg, 2, S_TOK)
    assert reached.mean() <= 0.25, reached.mean()   # the bar keeps >= 3/4
    jl, tl = _np(exp), _np(got.logits)
    d = np.abs(jl - tl)[~reached]
    assert d.max() <= LOGIT_ATOL, d.max()
    agree = (jl.argmax(-1) == tl.argmax(-1)).mean()
    assert agree >= ARGMAX_MIN, agree
    np.testing.assert_allclose(float(got.moe_aux), float(exp_aux),
                               rtol=AUX_RTOL)
    # the reference's own forward (a lax.scan over the layers, compiled:
    # XLA fuses and rounds at other places than the eager layers, so its
    # routes are not the recorded ones) on the argmax and aux bars
    scanned = JT.forward(jp, jnp.asarray(toks), jcfg, remat=False)
    agree = (_np(scanned.logits).argmax(-1) == tl.argmax(-1)).mean()
    assert agree >= ARGMAX_MIN, agree
    np.testing.assert_allclose(float(got.moe_aux), float(scanned.moe_aux),
                               rtol=AUX_RTOL)


def test_whisper_forward_matches_reference(whisper):
    """Encoder (bidirectional, 64 frames) and decoder (causal, S = 96, cross
    attention Sq = 96 against Sk = 64)."""
    jcfg, cfg, jp, tp = whisper
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, S_TOK))
    enc = _enc_input(cfg, 2, 8)
    exp = JT.forward(jp, jnp.asarray(toks), jcfg, remat=False,
                     enc_input=jnp.asarray(enc))
    with torch.no_grad():
        got = T.forward(tp, torch.from_numpy(toks), cfg,
                        enc_input=torch.from_numpy(enc))
    assert got.logits.shape == (2, S_TOK, cfg.vocab)
    jl, tl = _np(exp.logits), _np(got.logits)
    assert np.abs(jl - tl).max() <= LOGIT_ATOL, np.abs(jl - tl).max()
    assert (jl.argmax(-1) == tl.argmax(-1)).mean() >= ARGMAX_MIN
    assert float(got.moe_aux) == 0.0
    with pytest.raises(ValueError, match="enc_input"):
        T.forward(tp, torch.from_numpy(toks), cfg)


def test_whisper_cross_kv_matches_reference(whisper):
    """``init_decode_state(enc_input=...)`` runs the encoder once and caches
    each decoder layer's cross K/V: within two bf16 steps of their largest
    magnitude (bf16 products of a bf16 encoder output)."""
    jcfg, cfg, jp, tp = whisper
    enc = _enc_input(cfg, 2, 9)
    js = JT.init_decode_state(jp, jcfg, 2, 16, enc_input=jnp.asarray(enc))
    with torch.no_grad():
        ts = T.init_decode_state(tp, cfg, 2, 16,
                                 enc_input=torch.from_numpy(enc))
    assert len(ts.enc_kv) == cfg.n_layers and len(ts.kv) == cfg.n_layers
    for layer, (k, v) in enumerate(ts.enc_kv):
        assert k.shape == (2, cfg.encoder.enc_len, cfg.n_kv_heads,
                           cfg.head_dim_) and k.dtype == torch.bfloat16
        for got, exp in ((k, js.enc_kv[0][layer]), (v, js.enc_kv[1][layer])):
            exp = _np(exp)
            top = np.abs(exp).max()
            assert np.abs(_np(got) - exp).max() <= 2 * _bf16_step(top)
    with pytest.raises(ValueError, match="enc_input"):
        T.init_decode_state(tp, cfg, 2, 16)


def _decode_steps(jcfg, cfg, jp, tp, toks, enc=None, steps=8):
    B = toks.shape[0]
    jstep = jax.jit(lambda st, tok: JT.decode_step(jp, st, tok, jcfg))
    kw = {} if enc is None else {"enc_input": enc}
    js = JT.init_decode_state(jp, jcfg, B, 16,
                              **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        ts = T.init_decode_state(tp, cfg, B, 16, **{
            k: torch.from_numpy(v) for k, v in kw.items()})
        jl, tl = [], []
        for t in range(steps):
            lj, js = jstep(js, jnp.asarray(toks[:, t:t + 1], jnp.int32))
            lt, ts = T.decode_step(tp, ts, torch.from_numpy(toks[:, t:t + 1]),
                                   cfg)
            jl.append(_np(lj))
            tl.append(_np(lt))
    return np.concatenate(jl, 1), np.concatenate(tl, 1), ts


@pytest.mark.parametrize("arch", ["mixtral-8x7b", WHISPER])
def test_decode_steps_match_reference(arch, mixtral, whisper):
    """Eight teacher-forced ``decode_step`` calls (B = 2) against the JAX
    package's jitted step: mixtral's experts at T = B = 2 (capacity 8, no
    drops), whisper's cross attention at Sq = 1 and decoder position row 0
    at every step (the reference's decode)."""
    jcfg, cfg, jp, tp = mixtral if arch != WHISPER else whisper
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (2, 8))
    enc = _enc_input(cfg, 2, 10) if arch == WHISPER else None
    jl, tl, ts = _decode_steps(jcfg, cfg, jp, tp, toks, enc)
    assert np.abs(jl - tl).max() <= LOGIT_ATOL, np.abs(jl - tl).max()
    assert (jl.argmax(-1) == tl.argmax(-1)).mean() >= ARGMAX_MIN
    assert ts.kv[0].length == 8


def test_whisper_decode_adds_position_row_zero(whisper):
    """The reference's quirk, kept: decode adds ``dec_pos`` row 0 at every
    step, so a step's logits do not depend on the rows past 0 (the forward
    adds rows 0..S-1)."""
    _, cfg, _, tp = whisper
    enc = torch.from_numpy(_enc_input(cfg, 1, 11))
    tok = torch.tensor([[5], [5]])
    with torch.no_grad():
        st = T.init_decode_state(tp, cfg, 2, 8,
                                 enc_input=torch.cat([enc, enc]))
        a, _ = T.decode_step(tp, st, tok, cfg)
        saved = tp["dec_pos"]["pos"][1:].clone()
        tp["dec_pos"]["pos"][1:] = 0.0
        try:
            st = T.init_decode_state(tp, cfg, 2, 8,
                                     enc_input=torch.cat([enc, enc]))
            b, _ = T.decode_step(tp, st, tok, cfg)
        finally:
            tp["dec_pos"]["pos"][1:] = saved
    assert torch.equal(a, b)


def test_decode_agrees_with_forward(mixtral):
    """The port's own mixtral decode, teacher-forced over a 64-token prompt,
    gives the forward's argmax at > 85% of positions (the JAX package's
    bar for the dense and SSM families) when the forward drops no pair, as
    decode at T = B = 1 never does: capacity factor E / K, so cap >= T.  At
    the config's 1.25 the forward drops pairs and agrees with decode no
    better than the reference's own decode agrees with its forward (0.72 on
    these tokens), because the two compute other functions there."""
    _, cfg, _, tp = mixtral
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    no_drop = dataclasses.replace(cfg, moe=MoEConfig(E, K, E / K))
    assert M.capacity(64, no_drop.moe) >= 64
    toks = torch.from_numpy(
        np.random.default_rng(9).integers(0, cfg.vocab, (1, 64)))
    with torch.no_grad():
        fwd = T.forward(tp, toks, no_drop).logits.argmax(-1)[0]
        st = T.init_decode_state(tp, cfg, 1, capacity=64)
        preds = []
        for t in range(64):
            lg, st = T.decode_step(tp, st, toks[:, t:t + 1], cfg)
            preds.append(int(lg[0, 0].argmax()))
    match = float((torch.tensor(preds) == fwd).float().mean())
    assert match > 0.85, match


def test_check_arch_accepts_every_config():
    from repro_torch.configs import ARCH_IDS

    for name in ARCH_IDS:
        T.check_arch(get_config(name))
    assert {get_config(n).arch_type for n in ARCH_IDS} == set(T.ARCH_TYPES)


def test_init_model_shapes_and_seed():
    """The port's ``init_model`` gives the reference's keys and shapes for
    both families (the EP layout at one shard, the encoder's blocks), the
    same weights from the same seed, frozen."""
    for arch in ("mixtral-8x7b", WHISPER):
        cfg = get_config(arch).reduced()
        a = T.init_model(torch.Generator().manual_seed(0), cfg)
        b = T.init_model(torch.Generator().manual_seed(0), cfg)
        jp = JT.init_model(jax.random.PRNGKey(0), jax_config(arch).reduced())
        ref = convert.lm_params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu").state_dict()
        sa = a.state_dict()
        assert sa.keys() == ref.keys()
        assert all(sa[k].shape == ref[k].shape for k in sa)
        assert all(torch.equal(sa[k], b.state_dict()[k]) for k in sa)
        assert not any(p.requires_grad for p in a.parameters())
    assert sa["blocks.0.xattn.wq"].shape == (cfg.d_model, cfg.n_heads,
                                             cfg.head_dim_)
    assert "enc_blocks.1.mlp.b_up" in sa and "dec_pos.pos" in sa


def test_modules_call_the_functions(mixtral, whisper):
    """``MoEBlock``, ``EncoderBlock`` and ``DecoderBlock`` are
    ``nn.Module``s: calling them runs ``moe_block``, ``encoder_block`` and
    ``decoder_block``; calling the LM runs ``forward``."""
    g = torch.Generator().manual_seed(0)
    _, cfg, _, tp = mixtral
    x = torch.randn((1, 32, cfg.d_model), generator=g).to(torch.bfloat16)
    with torch.no_grad():
        y, aux = tp["blocks"][0](x)
        ey, eaux = T.moe_block(tp["blocks"][0], x, cfg)
        assert torch.equal(y, ey) and torch.equal(aux.router_z,
                                                  eaux.router_z)
        _, cfg, _, tp = whisper
        x = torch.randn((1, 32, cfg.d_model), generator=g).to(torch.bfloat16)
        e = torch.randn((1, cfg.encoder.enc_len, cfg.d_model),
                        generator=g).to(torch.bfloat16)
        assert torch.equal(tp["enc_blocks"][0](e),
                           T.encoder_block(tp["enc_blocks"][0], e, cfg))
        assert torch.equal(tp["blocks"][1](x, e),
                           T.decoder_block(tp["blocks"][1], x, e, cfg))
        toks = torch.zeros((1, 4), dtype=torch.long)
        assert torch.equal(tp(toks, enc_input=e).logits,
                           T.forward(tp, toks, cfg, enc_input=e).logits)


# -- serving ---------------------------------------------------------------------


def test_reference_checkpoint_serves_in_the_port(tmp_path, mixtral):
    """A reduced mixtral saved by ``repro.train.checkpoint.save`` loads
    through ``load_lm_checkpoint`` key for key (the EP layout as it is) and
    ``DecodeEngine`` serves it greedily, as the loaded weights' own engine
    does."""
    jcfg, cfg, jp, tp = mixtral
    path = str(tmp_path / "mixtral.npz")
    jax_checkpoint.save(path, jp)
    loaded = convert.load_lm_checkpoint(path, cfg, "cpu")
    a, b = loaded.state_dict(), tp.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert a["blocks.1.moe.w_gate"].shape == (1, cfg.moe.n_experts,
                                              cfg.d_model, cfg.d_ff)
    np.testing.assert_array_equal(
        a["blocks.1.moe.w_down"].numpy(),
        np.asarray(jp["blocks"]["moe"]["w_down"][1]))
    outs = []
    for params in (loaded, tp):
        eng = DecodeEngine(params, cfg, batch=2, capacity=32)
        reqs = [Request(rid=i, prompt=[1 + i, 2, 3], max_new=5)
                for i in range(3)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        assert all(r.done and len(r.out) == 5 for r in reqs)
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]


def test_decode_engine_refuses_audio(whisper):
    """The reference's ``DecodeEngine`` fails on whisper (its decode state
    asserts on the missing ``enc_input``); the port's raises ValueError."""
    jcfg, cfg, jp, tp = whisper
    from repro.serve.engine import DecodeEngine as JaxDecodeEngine
    with pytest.raises(AssertionError):
        JaxDecodeEngine(jp, jcfg, batch=2, capacity=16)
    with pytest.raises(ValueError, match="audio"):
        DecodeEngine(tp, cfg, batch=2, capacity=16)


def test_serve_driver_runs_mixtral_on_the_cpu(capsys):
    from repro_torch.launch import serve

    assert serve.main(["--arch", "mixtral-8x7b", "--device", "cpu",
                       "--requests", "3", "--max-new", "4"]) == 0
    assert "3 requests, 12 tokens" in capsys.readouterr().out
