"""The port's LM training path against the reference on the same inputs:
the optimizers, the VB posterior, the drift monitor, the token pipeline,
``lm_loss``, ``loss_fn``'s gradients, train steps and remat.

Inputs are numpy arrays from a seed handed to both packages; the models
carry the reference's initial weights (``convert.lm_params_from_numpy``).
Tolerances:
* the optimizers, the VB tree functions, the monitor and ``lm_loss``: the
  same fp32 arithmetic in another order, rtol 1e-6 (atol 1e-7 for values
  near 0; 1e-5 relative for sums over a whole tree);
* the token pipeline: identical arrays (the same numpy draws);
* ``loss_fn``: matmuls in bf16 in both packages, rounded at other places,
  so the loss within 2e-3 and each parameter's gradient within a relative
  L2 error of GRAD_REL (measured worst: 0.016 granite, 0.019 whisper);
  mixtral's top-2 routing flips at near-ties between the packages, which
  moves every gradient a little and the router's most (measured 0.05 and
  0.15): MOE_GRAD_REL and ROUTER_GRAD_REL;
* ``forward(remat=True)`` against ``remat=False``: the same bits.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_parity  # noqa: E402,F401  (one torch thread per worker)
from repro.bayes import drift as jdrift  # noqa: E402
from repro.bayes import vb_optimizer as jvb  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.data import tokens as jtok  # noqa: E402
from repro.nn import transformer as JT  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.bayes import drift as tdrift  # noqa: E402
from repro_torch.bayes import vb_optimizer as tvb  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import tokens as ttok  # noqa: E402
from repro_torch.nn import transformer as T  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402

GRAD_REL = 0.03
MOE_GRAD_REL, ROUTER_GRAD_REL = 0.08, 0.25
RTOL, ATOL = 1e-6, 1e-7


def _trees(seed=0, shapes=((3, 5), (7,), (2, 3, 4))):
    """A params dict and a grads dict (sorted keys: the reference's leaf
    order), as numpy."""
    g = np.random.default_rng(seed)
    keys = [f"w{i}" for i in range(len(shapes))]
    p = {k: g.standard_normal(s).astype(np.float32)
         for k, s in zip(keys, shapes)}
    gr = {k: (g.standard_normal(s) * 0.7).astype(np.float32)
          for k, s in zip(keys, shapes)}
    return p, gr


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _close(jtree, ttree, rtol=RTOL, atol=ATOL):
    for k in jtree:
        np.testing.assert_allclose(ttree[k].numpy(), np.asarray(jtree[k]),
                                   rtol=rtol, atol=atol, err_msg=k)


# -- optimizers ---------------------------------------------------------------


@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_update_matches_reference(clip):
    """Three steps with clipping active (clip 1) and not (clip 100)."""
    p, gr = _trees(1)
    jp, js = {k: jnp.asarray(v) for k, v in p.items()}, None
    js = jopt.adamw_init(jp)
    tp = _t(p)
    ts_ = topt.adamw_init(tp)
    jl, tl = jopt.cosine_schedule(1e-2, 2, 10), topt.cosine_schedule(1e-2, 2,
                                                                     10)
    for i in range(3):
        g = {k: v * (i + 1) for k, v in gr.items()}
        jp, js = jopt.adamw_update(jp, {k: jnp.asarray(v) for k, v in
                                        g.items()}, js, lr_fn=jl,
                                   clip_norm=clip)
        tp, ts_ = topt.adamw_update(tp, _t(g), ts_, lr_fn=tl, clip_norm=clip)
    assert ts_.step == int(js.step) == 3
    _close(jp, tp)
    _close(js.m, ts_.m)
    _close(js.v, ts_.v)


def test_cosine_schedule_matches_reference():
    """rtol 1e-6, and atol 1e-6 x base_lr where 1 + cos cancels near the
    end (the reference evaluates it in fp32, the port in float64)."""
    jl, tl = jopt.cosine_schedule(3e-4, 10, 100), \
        topt.cosine_schedule(3e-4, 10, 100)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(tl(step), float(jl(jnp.asarray(step))),
                                   rtol=RTOL, atol=1e-6 * 3e-4)


def test_sgd_update_matches_reference():
    p, gr = _trees(2)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    js, tp = jopt.sgd_init(jp), _t(p)
    ts_ = topt.sgd_init(tp)
    for i in range(3):
        g = {k: v - i for k, v in gr.items()}
        jp, js = jopt.sgd_update(jp, {k: jnp.asarray(v) for k, v in
                                      g.items()}, js, lr=0.05)
        tp, ts_ = topt.sgd_update(tp, _t(g), ts_, lr=0.05)
    _close(jp, tp)
    _close(js.mom, ts_.mom)
    assert ts_.step == 3


# -- the VB posterior ---------------------------------------------------------


def _vb_pair(steps=3, seed=3):
    p, gr = _trees(seed)
    jst = jvb.vb_init({k: jnp.asarray(v) for k, v in p.items()},
                      prior_prec=2.0)
    tst = tvb.vb_init(_t(p), prior_prec=2.0)
    for i in range(steps):
        g = {k: v * (1 + 0.5 * i) for k, v in gr.items()}
        jst = jvb.vb_update(jst, {k: jnp.asarray(v) for k, v in g.items()},
                            n_total=500.0, lr=0.1)
        tst = tvb.vb_update(tst, _t(g), n_total=500.0, lr=0.1)
    return jst, tst


def test_vb_update_matches_reference():
    jst, tst = _vb_pair()
    assert tst.step == int(jst.step) == 3
    _close(jst.mean, tst.mean)
    _close(jst.fisher, tst.fisher)


def test_posterior_prec_and_chain_prior_match_reference():
    jst, tst = _vb_pair()
    _close(jvb.posterior_prec(jst, 500.0), tvb.posterior_prec(tst, 500.0),
           atol=1e-4)
    jc = jvb.chain_prior(jst, 500.0, temper=0.3)
    tc = tvb.chain_prior(tst, 500.0, temper=0.3)
    _close(jc.prior_prec, tc.prior_prec, atol=1e-4)
    _close(jc.prior_mean, tc.prior_mean)
    assert all(tc.prior_mean[k].data_ptr() != tc.mean[k].data_ptr()
               for k in tc.mean)


def test_posterior_kl_matches_reference():
    jst, tst = _vb_pair()
    for st_j, st_t in ((jst, tst), (jvb.chain_prior(jst, 500.0, temper=0.3),
                                    tvb.chain_prior(tst, 500.0,
                                                    temper=0.3))):
        np.testing.assert_allclose(float(tvb.posterior_kl(st_t, 500.0)),
                                   float(jvb.posterior_kl(st_j, 500.0)),
                                   rtol=1e-5)


def test_sample_params_draws_from_the_posterior():
    """Over 2^18 weights, (w - m) sqrt(p) has mean 0 and variance 1 within
    5 standard errors; the same generator seed gives the same draw."""
    g = np.random.default_rng(4)
    p = {"w": g.standard_normal((512, 512)).astype(np.float32)}
    gr = {"w": g.standard_normal((512, 512)).astype(np.float32)}
    st = tvb.vb_update(tvb.vb_init(_t(p)), _t(gr), n_total=100.0)
    w = tvb.sample_params(st, torch.Generator().manual_seed(0), 100.0)["w"]
    prec = tvb.posterior_prec(st, 100.0)["w"]
    z = ((w - st.mean["w"]) * prec.sqrt()).double()
    n = z.numel()
    assert abs(float(z.mean())) < 5 / n ** 0.5
    assert abs(float(z.var()) - 1.0) < 5 * (2 / n) ** 0.5
    again = tvb.sample_params(st, torch.Generator().manual_seed(0), 100.0)
    assert torch.equal(w, again["w"])


def test_loss_drift_monitor_matches_reference():
    losses = np.concatenate([np.full(10, 3.0), np.full(6, 4.5),
                             np.linspace(2.0, 5.0, 8)]).astype(np.float32)
    jm = jdrift.LossDriftMonitor.create(threshold=1.0)
    tm = tdrift.LossDriftMonitor.create(threshold=1.0)
    flags = []
    for loss in losses:
        jm, jd = jm.observe(jnp.asarray(loss))
        tm, td = tm.observe(float(loss))
        assert bool(jd) == bool(td)
        flags.append(bool(td))
        np.testing.assert_allclose(float(tm.state.cum), float(jm.state.cum),
                                   rtol=1e-6, atol=1e-6)
    assert any(flags) and not any(flags[:10])


# -- tokens -------------------------------------------------------------------


def test_markov_sequences_and_drift_corpus_are_the_references():
    np.testing.assert_array_equal(ttok.markov_sequence(3000, 97, seed=5),
                                  jtok.markov_sequence(3000, 97, seed=5))
    np.testing.assert_array_equal(
        ttok.markov_sequence_fast(20_000, 512, seed=6),
        jtok.markov_sequence_fast(20_000, 512, seed=6))
    np.testing.assert_array_equal(ttok.drift_corpus(5000, 512, seed=1),
                                  jtok.drift_corpus(5000, 512, seed=1))


def test_token_stream_yields_the_references_batches():
    corpus = jtok.markov_sequence_fast(5000, 128, seed=2)
    js = jtok.TokenStream(corpus, 3, 16, enc_stub=(8, 4), seed=9)
    ts_ = ttok.TokenStream(corpus, 3, 16, enc_stub=(8, 4), seed=9,
                           device="cpu")
    for jb, tb in zip(js.batches(4), ts_.batches(4)):
        assert isinstance(tb, TS.TrainBatch)
        for a, b in zip(jb, tb):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_token_stream_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttok.TokenStream(np.arange(100), 2, 8)


# -- loss and gradients -------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss_matches_reference(masked):
    g = np.random.default_rng(7)
    logits = (g.standard_normal((2, 9, 33)) * 3).astype(np.float32)
    labels = g.integers(0, 33, (2, 9)).astype(np.int32)
    mask = (g.random((2, 9)) > 0.3).astype(np.float32) if masked else None
    exp = JS.lm_loss(jnp.asarray(logits), jnp.asarray(labels),
                     None if mask is None else jnp.asarray(mask))
    got = TS.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                     None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(exp), rtol=RTOL)


def _pair(arch, trainable=True, **kw):
    jcfg = dataclasses.replace(jax_config(arch).reduced(), **kw)
    cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    jp = JT.init_model(jax.random.PRNGKey(0), jcfg)
    tp = convert.lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                      cfg, "cpu", trainable=trainable)
    return jcfg, cfg, jp, tp


def _batch(cfg, seed=3, B=2, S=80):
    g = np.random.default_rng(seed)
    toks = g.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labs = g.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    enc = g.standard_normal((B, cfg.encoder.enc_len, cfg.d_model)).astype(
        np.float32) if cfg.is_encdec else None
    jb = JS.TrainBatch(jnp.asarray(toks), jnp.asarray(labs),
                       None if enc is None else jnp.asarray(enc))
    tb = TS.TrainBatch(*(None if a is None else torch.from_numpy(a)
                         for a in (toks, labs, enc)))
    return jb, tb


ARCHS = {"granite-3-2b": dict(n_kv_heads=2),    # GQA: reduced() has Hkv = Hq
         "mixtral-8x7b": {}, "whisper-medium": {},
         "gemma-2b": dict(head_dim=256),        # MQA 4/1 at its real D
         "chameleon-34b": {}}                   # vlm: its dense blocks


@pytest.mark.parametrize("arch", list(ARCHS))
def test_loss_fn_gradients_match_jax_value_and_grad(arch):
    """``loss_fn`` (S = 80, above mixtral's reduced window of 64; whisper
    with enc_input) and every parameter's gradient against
    ``jax.value_and_grad`` of the reference's ``loss_fn``."""
    jcfg, cfg, jp, tp = _pair(arch, **ARCHS[arch])
    jb, tb = _batch(cfg)
    (jt, (jl, ja)), jg = jax.value_and_grad(JS.loss_fn, has_aux=True)(
        jp, jb, jcfg, JT.NO_SHARD)
    (tt, (tl, ta)), tg = TS.grads_of(tp, tb, cfg)
    np.testing.assert_allclose(float(tl), float(jl), atol=2e-3)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(float(tt), float(jt), atol=2e-3)
    ref = dict(convert.lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jg), cfg, "cpu").named_parameters())
    assert set(ref) == set(tg)
    for k, e in ref.items():
        rel = float((tg[k] - e).norm() / e.norm().clamp_min(1e-30))
        bar = GRAD_REL if cfg.arch_type != "moe" else (
            ROUTER_GRAD_REL if k.endswith("router") else MOE_GRAD_REL)
        assert rel <= bar, (k, rel)


def test_loss_fn_refuses_frozen_parameters():
    _, cfg, _, tp = _pair("granite-3-2b", trainable=False)
    with pytest.raises(ValueError, match="trainable=True"):
        TS.grads_of(tp, _batch(cfg)[1], cfg)


@pytest.mark.parametrize("arch", ["granite-3-2b", "mixtral-8x7b",
                                  "whisper-medium", "zamba2-1.2b"])
def test_remat_gives_the_same_bits(arch):
    """``forward(remat=True)`` checkpoints each block (whisper's encoder
    and decoder blocks, zamba2's Mamba and shared blocks): the loss and
    every gradient are the bits of ``remat=False``."""
    _, cfg, _, tp = _pair(arch)
    tb = _batch(cfg, S=64)[1]
    named = dict(tp.named_parameters())
    out = {}
    for remat in (True, False):
        total, _ = TS.loss_fn(tp, tb, cfg, remat=remat)
        out[remat] = (total, torch.autograd.grad(total, list(named.values())))
    assert torch.equal(out[True][0], out[False][0])
    assert all(torch.equal(a, b) for a, b in zip(out[True][1], out[False][1]))


def test_init_model_trainable_flag():
    cfg = get_config("granite-3-2b").reduced()
    frozen = T.init_model(torch.Generator().manual_seed(0), cfg)
    live = T.init_model(torch.Generator().manual_seed(0), cfg,
                        trainable=True)
    assert not any(p.requires_grad for p in frozen.parameters())
    assert all(p.requires_grad for p in live.parameters())
    assert all(torch.equal(a, b) for a, b in zip(frozen.parameters(),
                                                  live.parameters()))


def test_params_tree_is_the_references_layout():
    jcfg, cfg, jp, tp = _pair("whisper-medium")
    tree = T.params_tree(tp)
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(jflat) == len(jax.tree_util.tree_leaves(tree))
    for path, leaf in jflat:
        node = tree
        for part in path:
            node = node[part.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))


# -- train steps --------------------------------------------------------------


def _steps(mode, n=3):
    jcfg, cfg, jp, tp = _pair("granite-3-2b", n_kv_heads=2)
    g = np.random.default_rng(11)
    if mode == "adamw":
        js, ts_ = JS.init_train_state(jp), TS.init_train_state(tp)
        jl, tl = jopt.cosine_schedule(1e-2, 1, 10), \
            topt.cosine_schedule(1e-2, 1, 10)
        jstep = jax.jit(lambda s, b: JS.train_step(s, b, jcfg, lr_fn=jl))

        def tstep(s, b):
            return TS.train_step(s, b, cfg, lr_fn=tl)
    else:
        js, ts_ = JS.init_vb_state(jp), TS.init_vb_state(tp)
        jstep = jax.jit(lambda s, b: JS.vb_train_step(
            s, b, jcfg, n_total=2e4, lr=0.05))

        def tstep(s, b):
            return TS.vb_train_step(s, b, cfg, n_total=2e4, lr=0.05)
    metrics = []
    for _ in range(n):
        t = g.integers(0, cfg.vocab, (2, 64)).astype(np.int32)
        lab = g.integers(0, cfg.vocab, (2, 64)).astype(np.int32)
        js, jm = jstep(js, JS.TrainBatch(jnp.asarray(t), jnp.asarray(lab)))
        ts_, tm = tstep(ts_, TS.TrainBatch(torch.from_numpy(t),
                                           torch.from_numpy(lab)))
        metrics.append((jm, tm))
    jparams = js.params if mode == "adamw" else js.vb.mean
    ref = dict(convert.lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), cfg,
        "cpu").named_parameters())
    start = dict(convert.lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), cfg,
        "cpu").named_parameters())
    upd = {k: float(((p.detach() - start[k]) - (ref[k] - start[k])).norm()
                    / (ref[k] - start[k]).norm().clamp_min(1e-30))
           for k, p in ts_.params.named_parameters()}
    return metrics, upd, ts_


def test_train_steps_match_reference():
    """Three AdamW steps (lr 1e-2): the losses within 1e-2 and each weight's
    update within a relative L2 error of 0.2 -- Adam's first steps move a
    weight by about lr whatever its gradient's size, so a tiny gradient
    whose bf16 sign differs between the packages moves it by 2 lr the
    other way (measured worst 0.15)."""
    metrics, upd, st = _steps("adamw")
    for jm, tm in metrics:
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=1e-2)
    assert st.step == 3 and st.opt.step == 3
    assert max(upd.values()) <= 0.2, max(upd.items(), key=lambda kv: kv[1])


def test_vb_train_steps_match_reference():
    """Three VON steps (lr 0.05, N = 2e4): the losses within 1e-2, the KL
    within 1e-4 relative, each weight's update within a relative L2 error
    of 0.05 (measured worst 0.023)."""
    metrics, upd, st = _steps("vb")
    for jm, tm in metrics:
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=1e-2)
        np.testing.assert_allclose(float(tm["kl"]), float(jm["kl"]),
                                   rtol=1e-4)
    assert st.vb.step == 3
    assert max(upd.values()) <= 0.05, max(upd.items(), key=lambda kv: kv[1])
    assert all(st.vb.mean[k] is p for k, p in st.params.named_parameters())
