"""``flash_attention``'s gradient on the CPU route against ``jax.grad`` of
the reference's ``attention_blockwise``; the plain backward
(``flash_attention_backward_plain``, the backward kernels' oracle) against
autograd; and the backward kernels' plans (``dq_kv_tile_range``,
``q_tile_range``, ``dkdv_heads``) emulated in numpy.

Tolerances (relative L2 error of each gradient): fp32 1e-5 (the same fp32
products summed in another order); bf16 2^-6 (both packages round the
inputs' products, p and the outputs to bf16, at other places; measured
worst ~2^-8).  The plain backward against autograd of
``attention_reference`` in float64: 1e-5 (the plain backward works in
fp32).  The plans: every live (q, k) pair exactly once.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_parity  # noqa: E402,F401  (one torch thread per worker)
from repro.nn import attention as JA  # noqa: E402
from repro_torch.kernels import flash_attn  # noqa: E402
from repro_torch.nn import attention as A  # noqa: E402

REL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}

# (B, Sq, Sk, Hq, Hkv, D, causal, window)
ROUTES = {
    "causal_mha": (2, 96, 96, 2, 2, 16, True, None),
    "causal_gqa4": (1, 96, 96, 8, 2, 16, True, None),
    "window": (1, 130, 130, 4, 1, 16, True, 40),
    "noncausal": (2, 70, 70, 4, 4, 32, False, None),
    "cross_ragged": (1, 40, 150, 4, 1, 16, False, None),
    "window_only": (1, 100, 100, 2, 2, 16, False, 30),
}


def _inputs(B, Sq, Sk, Hq, Hkv, D, seed=0):
    g = np.random.default_rng(seed)
    return [g.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D),
                      (B, Sq, Hq, D))]


def _rel(got, exp):
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    return float(np.linalg.norm(got - exp) / max(np.linalg.norm(exp), 1e-30))


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_gradients_match_jax_grad(route, dtype):
    """kv_block 32 in both packages, so that Sk spans several blocks and
    the ragged one."""
    B, Sq, Sk, Hq, Hkv, D, causal, window = ROUTES[route]
    q, k, v, g = _inputs(B, Sq, Sk, Hq, Hkv, D)
    jdt = getattr(jnp, dtype)

    def jloss(q_, k_, v_):
        o = JA.attention_blockwise(q_, k_, v_, causal=causal, window=window,
                                   kv_block=32)
        return jnp.sum(o.astype(jnp.float32) * g)

    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    exp = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_()
                  for a in (q, k, v))
    flash_attn.reset_launches()
    o = flash_attn.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert flash_attn.LAUNCHES == {"flash_attention": 0,
                                   "flash_attention_backward": 0}
    # the CPU route is attention_blockwise with its default block; kv_block
    # only regroups the same sums, which the fp32 bar covers
    (o.float() * torch.from_numpy(g)).sum().backward()
    for got, e in zip((tq.grad, tk.grad, tv.grad), exp):
        assert got.dtype == tdt
        assert _rel(got.float().numpy(), np.asarray(e, np.float32)) \
            <= REL[dtype]


@pytest.mark.parametrize("route", list(ROUTES))
def test_plain_backward_matches_autograd(route):
    """The plain backward, from the forward's output and the plain lse,
    against autograd of ``attention_reference`` in float64; kv blocks of
    32 and of the whole Sk give the same function."""
    B, Sq, Sk, Hq, Hkv, D, causal, window = ROUTES[route]
    q, k, v, g = (torch.from_numpy(a).double()
                  for a in _inputs(B, Sq, Sk, Hq, Hkv, D, seed=1))
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    o = A.attention_reference(qr, kr, vr, causal=causal, window=window)
    exp = torch.autograd.grad(o, (qr, kr, vr), g)
    lse = flash_attn.attention_lse_plain(q, k, causal=causal, window=window)
    for kv_block in (32, 1024):
        got = flash_attn.flash_attention_backward_plain(
            q, k, v, o.detach(), lse, g, causal=causal, window=window,
            kv_block=kv_block)
        for a, e in zip(got, exp):
            assert a.dtype == torch.float32 and a.shape == e.shape
            assert _rel(a.numpy(), e.numpy()) <= 1e-5


def test_lse_matches_logsumexp_of_the_masked_scores():
    B, Sq, Sk, Hq, Hkv, D, causal, window = ROUTES["window"]
    q, k, _, _ = (torch.from_numpy(a) for a in _inputs(B, Sq, Sk, Hq, Hkv, D))
    lse = flash_attn.attention_lse_plain(q, k, causal=causal, window=window,
                                         kv_block=48)
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(),
                     k.double()[:, :, torch.arange(Hq) % Hkv]) / D ** 0.5
    bias = A._mask_bias(Sq, Sk, 0, causal, window).double()
    exp = torch.logsumexp(s + torch.where(bias < 0, -torch.inf, 0.0), -1)
    torch.testing.assert_close(lse.double(), exp, rtol=1e-6, atol=1e-5)


def test_backward_wrapper_takes_cuda_tensors_only():
    q, k, v, g = (torch.from_numpy(a)
                  for a in _inputs(1, 16, 16, 2, 2, 16))
    lse = flash_attn.attention_lse_plain(q, k)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attn.flash_attention_backward(q, k, v, q, lse, g)


# -- the backward kernels' plans ----------------------------------------------


def _live(Sq, Sk, causal, window):
    qp = np.arange(Sq)[:, None]
    kp = np.arange(Sk)[None, :]
    ok = np.ones((Sq, Sk), bool)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= kp > qp - window
    return ok


PLAN_CASES = [(4096, 4096, True, None), (8192, 8192, True, 4096),
              (1500, 1500, False, None), (448, 1500, False, None),
              (1, 1500, False, None), (100, 37, True, 5),
              (300, 130, False, 70), (130, 64, True, None),
              (65, 200, True, 1), (64, 64, False, 64)]


@pytest.mark.parametrize("Sq,Sk,causal,window", PLAN_CASES)
def test_dq_plan_covers_every_live_pair_once(Sq, Sk, causal, window):
    """Each q tile's kv tiles, in order, cover every live pair of its rows
    exactly once (tiles are disjoint, so once is at most once)."""
    bq, bk = flash_attn.BWD_BQ, flash_attn.BWD_BK
    cover = np.zeros((Sq, Sk), np.uint8)
    for qt in range(-(-Sq // bq)):
        tiles = list(flash_attn.dq_kv_tile_range(qt, Sq, Sk, causal, window))
        assert tiles == sorted(set(tiles))
        for kt in tiles:
            cover[qt * bq:(qt + 1) * bq, kt * bk:(kt + 1) * bk] += 1
    live = _live(Sq, Sk, causal, window)
    assert (cover[live] == 1).all()
    assert cover.max() <= 1


@pytest.mark.parametrize("Sq,Sk,causal,window", PLAN_CASES)
@pytest.mark.parametrize("Hq,Hkv", [(8, 2), (4, 4), (4, 1)])
def test_dkdv_plan_covers_every_live_pair_once(Sq, Sk, causal, window, Hq,
                                               Hkv):
    """Each (kv head, kv tile) block sums the G q heads h = g Hkv + hk in
    order g = 0 .. G - 1 and, for each, its q tiles in order: every live
    (q head, q, k) triple exactly once, each q head through the kv head
    h % Hkv."""
    bq, bk = flash_attn.BWD_BQ, flash_attn.BWD_BK
    visits = {h: [] for h in range(Hq)}          # (kt, qt) by q head
    for hk in range(Hkv):
        heads = flash_attn.dkdv_heads(hk, Hq, Hkv)
        assert heads == sorted(heads) and all(h % Hkv == hk for h in heads)
        for kt in range(-(-Sk // bk)):
            tiles = list(flash_attn.q_tile_range(kt, Sq, Sk, causal, window))
            assert tiles == sorted(set(tiles))
            for h in heads:
                visits[h] += [(kt, qt) for qt in tiles]
    live = _live(Sq, Sk, causal, window)
    for h, tiles in visits.items():
        cover = np.zeros((Sq, Sk), np.uint8)
        for kt, qt in tiles:
            cover[qt * bq:(qt + 1) * bq, kt * bk:(kt + 1) * bk] += 1
        assert (cover[live] == 1).all() and cover.max() <= 1, h


def test_bwd_smem_fits_a_block():
    """Both kernels' shared memory fits Hopper's 227 KB a block at every D
    they take (the library checks these numbers when it loads)."""
    for D in range(16, flash_attn.BWD_MAX_D + 1, 16):
        for kernel in ("dq", "dkdv"):
            assert flash_attn.bwd_smem_bytes(kernel, D) <= 232_448
