"""The port's suff-stats kernel wrappers on the CPU (their plain PyTorch
versions) against the JAX Pallas kernels in interpret mode and against
``repro.kernels.ref``, on the shapes of ``tests/test_kernels.py``.

Tolerance: rtol 1e-4 and atol 1e-3, as tests/test_kernels.py holds the
Pallas kernels to their oracle: float32 sums over up to 1000 instances in
different orders (torch vs XLA einsum differ by up to ~1e-4 relative).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity  # noqa: E402,F401  (one intra-op thread)
import jax.numpy as jnp  # noqa: E402

from repro.kernels import clg_stats as jk  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import clg_stats, ref  # noqa: E402

RTOL, ATOL = 1e-4, 1e-3


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _moments_inputs(N, F, D, K, seed):
    g = np.random.default_rng(seed)
    return (g.standard_normal((N, F, D), dtype=np.float32),
            g.standard_normal((N, F), dtype=np.float32),
            _softmax(g.standard_normal((N, K))))


def _close(port, *refs):
    for exp in refs:
        for p, e in zip(port, exp):
            np.testing.assert_allclose(p.numpy(), np.asarray(e), rtol=RTOL,
                                       atol=ATOL)


@pytest.mark.parametrize("N,F,D,K,block", [
    (1000, 3, 4, 2, 256),
    (513, 1, 2, 5, 128),     # ragged N vs block
    (256, 2, 8, 16, 64),     # K = 16 components
])
def test_clg_suffstats_matches_pallas_and_ref(N, F, D, K, block):
    d, y, r = _moments_inputs(N, F, D, K, 0)
    got = clg_stats.clg_suffstats(*map(torch.from_numpy, (d, y, r)))
    pallas = jk.clg_suffstats(jnp.asarray(d), jnp.asarray(y), jnp.asarray(r),
                              block=block, interpret=True)
    _close(got, pallas, jref.clg_suffstats_ref(d, y, r))


@pytest.mark.parametrize("N,F,Do,K,L,block", [
    (600, 3, 2, 2, 1, 256),
    (513, 2, 1, 3, 2, 128),    # ragged N vs block; FA-style Do = 1
    (256, 1, 3, 4, 8, 64),     # wide latent block (L = 8)
])
def test_clg_suffstats_latent_matches_pallas_and_ref(N, F, Do, K, L, block):
    obs, y, r = _moments_inputs(N, F, Do, K, 1)
    g = np.random.default_rng(2)
    hm = g.standard_normal((N, K, L), dtype=np.float32)
    a = 0.3 * g.standard_normal((K, L, L), dtype=np.float32)
    shh = (a @ a.transpose(0, 2, 1) + np.eye(L)).astype(np.float32)
    got = clg_stats.clg_suffstats_latent(
        *map(torch.from_numpy, (obs, hm, y, r, shh)))
    pallas = jk.clg_suffstats_latent(*map(jnp.asarray, (obs, hm, y, r, shh)),
                                     block=block, interpret=True)
    _close(got, pallas, jref.clg_suffstats_latent_ref(obs, hm, y, r, shh))
    sxx = got[0].numpy()
    np.testing.assert_allclose(sxx, sxx.swapaxes(-1, -2), atol=1e-4)


@pytest.mark.parametrize("N,Fd,C,K,block", [
    (1000, 2, 3, 2, 256),
    (513, 1, 5, 4, 128),     # ragged N vs block
    (128, 3, 2, 7, 64),
    (300, 2, 64, 3, 128),    # C = 64 categories
])
def test_clg_disc_counts_matches_pallas_and_ref(N, Fd, C, K, block):
    """Category -1 (padded instances) counts nothing, as in jax.nn.one_hot."""
    g = np.random.default_rng(3)
    xd = g.integers(-1, C, (N, Fd)).astype(np.int32)
    r = _softmax(g.standard_normal((N, K)))
    got = clg_stats.clg_disc_counts(torch.from_numpy(xd), torch.from_numpy(r),
                                    C)
    pallas = jk.clg_disc_counts(jnp.asarray(xd), jnp.asarray(r), C,
                                block=block, interpret=True)
    _close([got], [pallas], [jref.clg_disc_counts_ref(xd, r, C)])


def test_masked_instances_contribute_nothing():
    """r = 0 rows (masked instances) add nothing, including to the
    rsum * S_k correction of the latent block."""
    obs, y, r = _moments_inputs(200, 2, 2, 3, 4)
    g = np.random.default_rng(5)
    hm = g.standard_normal((200, 3, 2), dtype=np.float32)
    shh = np.broadcast_to(0.7 * np.eye(2, dtype=np.float32), (3, 2, 2)).copy()
    r[150:] = 0.0
    t = lambda *a: [torch.from_numpy(np.ascontiguousarray(x)) for x in a]
    full = clg_stats.clg_suffstats_latent(*t(obs, hm, y, r, shh))
    trunc = clg_stats.clg_suffstats_latent(
        *t(obs[:150], hm[:150], y[:150], r[:150], shh))
    for a, b in zip(full, trunc):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-4)


def test_wrapper_padding_is_inert():
    """The CUDA wrappers pad N to a tile multiple with zero r and category
    -1; on the plain versions that padding changes nothing."""
    d, y, r = _moments_inputs(300, 2, 3, 2, 6)
    td, ty, tr = map(torch.from_numpy, (d, y, r))
    T = clg_stats.tile_for(2 * 3 + 2 + 2, "test")
    pad = -(-300 // T) * T - 300
    assert pad > 0
    padded = clg_stats.clg_suffstats(*(clg_stats._pad_rows(x, pad)
                                       for x in (td, ty, tr)))
    for a, b in zip(padded, clg_stats.clg_suffstats(td, ty, tr)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-5)
    xd = torch.from_numpy(np.random.default_rng(7).integers(
        0, 4, (300, 2)).astype(np.int32))
    got = clg_stats.clg_disc_counts(clg_stats._pad_rows(xd, pad, value=-1),
                                    clg_stats._pad_rows(tr, pad), 4)
    np.testing.assert_allclose(got.numpy(),
                               clg_stats.clg_disc_counts(xd, tr, 4).numpy(),
                               rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("row,tile", [(24, 256), (48, 128), (200, 32),
                                      (376, 32)])
def test_tile_fits_shared_memory(row, tile):
    assert clg_stats.tile_for(row, "test") == tile
    assert 4 * (tile * row + clg_stats.THREADS) <= clg_stats.SMEM_BYTES


def test_wrappers_check_inputs_and_count_no_cpu_launch():
    d, y, r = map(torch.from_numpy, _moments_inputs(64, 2, 3, 2, 8))
    with pytest.raises(ValueError, match="limit of 376"):
        clg_stats.tile_for(377, "clg_suffstats")
    with pytest.raises(TypeError):
        clg_stats.clg_suffstats(d.double(), y, r)
    with pytest.raises(ValueError, match="disagree"):
        clg_stats.clg_suffstats(d, y[:10], r)
    with pytest.raises(TypeError):
        clg_stats.clg_disc_counts(torch.zeros((4, 2)), r[:4], 3)
    before = dict(clg_stats.LAUNCHES)
    clg_stats.clg_suffstats(d, y, r)
    assert clg_stats.LAUNCHES == before    # the plain path launches nothing


def test_one_hot_matches_jax_for_padding_category():
    xd = torch.tensor([[-1, 0], [2, 5]], dtype=torch.int32)
    got = ref.one_hot_cmp(xd, 3).numpy()
    import jax

    exp = np.asarray(jax.nn.one_hot(jnp.asarray(xd.numpy()), 3))
    np.testing.assert_array_equal(got, exp)
