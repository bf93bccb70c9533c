"""The port's attention and SSD plain versions against the JAX package.

``repro_torch.kernels.flash_attn.flash_attention`` and
``repro_torch.kernels.ssd_scan.ssd_scan`` take their plain route on CPU
tensors (``nn.attention.attention_blockwise``, ``nn.ssm.ssd_chunked``); both
are held against the Pallas kernels in interpret mode and against the JAX
package's oracles, on the sweeps of ``tests/test_kernels.py``, with inputs
made by numpy from a seed.

Tolerances: fp32 attention within 2e-5 (the same fp32 products summed in
another order); bf16 attention within 0.05 (bf16 outputs, and the plain
version rounds the softmax weights to bf16 before PV where the Pallas
kernel keeps them fp32); the SSD scan within rtol 2e-4 plus 2e-4 max|ref|
(the JAX test's bound; float32 sums in another order over the chunk).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import _torch_parity  # noqa: E402,F401  (one torch thread per worker)
from repro.kernels.flash_attn import flash_attention as pallas_flash  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd  # noqa: E402
from repro.nn.attention import attention_reference as jax_attention  # noqa: E402
from repro.nn.ssm import ssd_chunked as jax_ssd  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attn, ref, ssd_scan  # noqa: E402
from repro_torch.nn import attention as tattn  # noqa: E402
from repro_torch.nn import ssm as tssm  # noqa: E402
from repro_torch.nn import transformer as T  # noqa: E402

ATTN_SHAPES = [
    (1, 128, 4, 4, 64),     # MHA
    (2, 256, 4, 2, 64),     # GQA: pins q head h -> kv head h % Hkv
    (1, 128, 4, 1, 128),    # MQA
    (1, 192, 2, 2, 256),    # gemma-style head_dim, ragged seq/block
]


def _qkv(B, S, Hq, Hkv, D, seed=0):
    g = np.random.default_rng(seed)
    return (g.standard_normal((B, S, Hq, D), dtype=np.float32),
            g.standard_normal((B, S, Hkv, D), dtype=np.float32),
            g.standard_normal((B, S, Hkv, D), dtype=np.float32))


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _j(*arrays, dtype=jnp.float32):
    return [jnp.asarray(a).astype(dtype) for a in arrays]


@pytest.mark.parametrize("B,S,Hq,Hkv,D", ATTN_SHAPES)
@pytest.mark.parametrize("window", [None, 64])
def test_flash_attention_plain_matches_pallas_and_reference(B, S, Hq, Hkv, D,
                                                            window):
    q, k, v = _qkv(B, S, Hq, Hkv, D)
    pallas = np.asarray(pallas_flash(*_j(q, k, v), causal=True, window=window,
                                     bq=64, bk=64, interpret=True))
    oracle = np.asarray(jax_attention(*_j(q, k, v), causal=True,
                                      window=window))
    flash_attn.reset_launches()
    got = flash_attn.flash_attention(*_t(q, k, v), window=window).numpy()
    blockwise = tattn.attention_blockwise(*_t(q, k, v), window=window,
                                          kv_block=128).numpy()
    port_ref = ref.flash_attention_ref(*_t(q, k, v), window=window).numpy()
    assert flash_attn.LAUNCHES["flash_attention"] == 0
    for out in (got, blockwise, port_ref):
        np.testing.assert_allclose(out, pallas, atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(out, oracle, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("name,tol", [("float32", 2e-5), ("bfloat16", 0.05)])
def test_flash_attention_dtypes(name, tol):
    q, k, v = _qkv(1, 128, 2, 1, 64, seed=1)
    tdt, jdt = getattr(torch, name), getattr(jnp, name)
    pallas = pallas_flash(*_j(q, k, v, dtype=jdt), bq=64, bk=64,
                          interpret=True)
    got = flash_attn.flash_attention(*_t(q, k, v, dtype=tdt))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(pallas, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("Sq,Sk", [(128, 128), (64, 160)])
def test_flash_attention_noncausal(Sq, Sk):
    g = np.random.default_rng(2)
    q = g.standard_normal((1, Sq, 2, 64), dtype=np.float32)
    k, v = (g.standard_normal((1, Sk, 2, 64), dtype=np.float32)
            for _ in range(2))
    oracle = np.asarray(jax_attention(*_j(q, k, v), causal=False))
    if Sq == Sk:
        pallas = np.asarray(pallas_flash(*_j(q, k, v), causal=False, bq=64,
                                         bk=64, interpret=True))
        np.testing.assert_allclose(oracle, pallas, atol=2e-5)
    got = flash_attn.flash_attention(*_t(q, k, v), causal=False).numpy()
    np.testing.assert_allclose(got, oracle, atol=2e-5, rtol=2e-5)


def test_blockwise_block_size_and_q_offset():
    """Any kv block size gives the oracle; ``q_offset`` shifts the queries'
    positions as in the JAX package."""
    q, k, v = _qkv(1, 96, 4, 2, 32, seed=3)
    oracle = np.asarray(jax_attention(*_j(q[:, 32:], k, v), window=40,
                                      q_offset=32))
    for blk in (16, 40, 96):
        got = tattn.attention_blockwise(*_t(q[:, 32:], k, v), window=40,
                                        q_offset=32, kv_block=blk).numpy()
        np.testing.assert_allclose(got, oracle, atol=2e-5, rtol=2e-5)


SSD_SHAPES = [
    (2, 128, 4, 32, 1, 64, 32),
    (1, 256, 2, 64, 2, 32, 64),      # G = 2: pins head h -> group h // rep
    (1, 128, 8, 64, 1, 128, 128),    # mamba2-1.3b tile shape
]


def _ssd_inputs(b, S, H, P, G, N, seed=0):
    g = np.random.default_rng(seed)
    x = g.standard_normal((b, S, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(g.standard_normal((b, S, H)))).astype(np.float32)
    A = np.exp(0.3 * g.standard_normal(H)).astype(np.float32)
    B = g.standard_normal((b, S, G, N), dtype=np.float32)
    C = g.standard_normal((b, S, G, N), dtype=np.float32)
    return x, dt, A, B, C


def _ssd_close(got, exp):
    scale = max(1.0, float(np.abs(exp).max()))
    np.testing.assert_allclose(got, exp, rtol=2e-4, atol=2e-4 * scale)


@pytest.mark.parametrize("b,S,H,P,G,N,chunk", SSD_SHAPES)
def test_ssd_scan_plain_matches_pallas_and_reference(b, S, H, P, G, N,
                                                     chunk):
    arrays = _ssd_inputs(b, S, H, P, G, N)
    py, ph = pallas_ssd(*_j(*arrays), chunk, interpret=True)
    jy, jh = jax_ssd(*_j(*arrays), chunk)
    ssd_scan.reset_launches()
    ty, th = ssd_scan.ssd_scan(*_t(*arrays), chunk)
    ry, rh = ref.ssd_scan_ref(*_t(*arrays), chunk)
    assert ssd_scan.LAUNCHES["ssd_scan"] == 0
    for y, h in ((ty, th), (ry, rh)):
        for exp_y, exp_h in ((py, ph), (jy, jh)):
            _ssd_close(y.numpy(), np.asarray(exp_y))
            _ssd_close(h.numpy(), np.asarray(exp_h))


def test_ssd_scan_chunk_invariance():
    """Different chunk sizes give the same scan (the SSD identity), as the
    JAX package's test holds (3e-4)."""
    arrays = _t(*_ssd_inputs(1, 128, 2, 16, 1, 32, seed=1))
    y32, h32 = ssd_scan.ssd_scan(*arrays, 32)
    y128, h128 = ssd_scan.ssd_scan(*arrays, 128)
    np.testing.assert_allclose(y32.numpy(), y128.numpy(), atol=3e-4,
                               rtol=3e-4)
    np.testing.assert_allclose(h32.numpy(), h128.numpy(), atol=3e-4,
                               rtol=3e-4)


def test_ssd_chunked_carries_an_initial_state():
    """Two halves scanned in turn, the second from the first's final
    state, give the whole scan."""
    x, dt, A, B, C = _t(*_ssd_inputs(1, 128, 4, 16, 2, 16, seed=2))
    y, h = tssm.ssd_chunked(x, dt, A, B, C, 32)
    y1, h1 = tssm.ssd_chunked(x[:, :64], dt[:, :64], A, B[:, :64],
                              C[:, :64], 32)
    y2, h2 = tssm.ssd_chunked(x[:, 64:], dt[:, 64:], A, B[:, 64:],
                              C[:, 64:], 32, h0=h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, rtol=1e-5,
                               atol=1e-4)
    torch.testing.assert_close(h2, h, rtol=1e-5, atol=1e-4)


def test_wrappers_check_their_inputs_on_the_cpu():
    q, k, v = _t(*_qkv(1, 32, 2, 2, 16))
    with pytest.raises(TypeError):
        flash_attn.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="disagree"):
        flash_attn.flash_attention(q, k[..., :8], v)
    with pytest.raises(ValueError, match="window"):
        flash_attn.flash_attention(q, k, v, window=0)
    x, dt, A, B, C = _t(*_ssd_inputs(1, 64, 2, 16, 1, 8))
    with pytest.raises(TypeError):
        ssd_scan.ssd_scan(x.double(), dt, A, B, C, 32)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_scan.ssd_scan(x, dt, A, B, C, 48)
    with pytest.raises(ValueError, match="disagree"):
        ssd_scan.ssd_scan(x, dt[:, :, :1], A, B, C, 32)


def test_cuda_backend_on_cpu_tensors_raises():
    """The kernel route is never taken for a CPU tensor: naming it
    raises instead of falling back."""
    cfg = get_config("zamba2-1.2b").reduced()
    params = T.init_model(torch.Generator().manual_seed(0), cfg)
    x = torch.zeros((1, 32, cfg.d_model), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="cuda"):
        tssm.apply_mamba2(params["blocks"][0]["mamba"], x, cfg.d_model,
                          cfg.ssm, backend="cuda")
    with pytest.raises(ValueError, match="cuda"):
        T.attention_block(params["shared_attn"]["attn"], x, cfg,
                          backend="cuda")
    with pytest.raises(ValueError, match="cuda"):
        T.forward(params, torch.zeros((1, 32), dtype=torch.long), cfg,
                  backend="cuda")
