"""The CUDA kernels (suff-stats and factor algebra) against their plain
PyTorch versions, on the card, the temporal models' kernel route
(``clg_seq_suffstats``, an HMM fit on ``"cuda"`` against ``"einsum"``,
temporal serving), and approximate inference on the card (importance
sampling and its serving mode against exact inference, MAP and LDA's E-step
against the CPU, SVI steps on ``"cuda"`` against ``"einsum"``), d-VMP
on one NCCL rank against ``vmp_fit`` bit for bit, and the production tier
(the async server's two replicas against the direct engine bit for bit,
obs kernel counts against the wrappers' launches, a checkpoint of card
tensors).  Marked ``gpu``: each
test asks the ``cuda`` fixture for the device,
which skips when there is no card, so the CPU run collects the same tests
and skips them.  Run on a machine with a card:

    python -m pytest -m gpu tests/test_torch_gpu.py

Tolerance: the kernel and the plain einsum sum the same float32 products in
different orders, so results agree to rtol 1e-4 plus an absolute term that
scales with the largest output (sums over N instances).  Two launches on
the same input must agree bit for bit (fixed-order reductions, no atomics).
``family_counts`` with 0/1 weights gives the plain version's bits (every
count an exact integer), with float weights rtol 1e-5.
Factor kernels: ``log_product`` and ``evidence_select`` give the plain
version's bits; ``log_marginalize`` agrees within 1e-5 + 1e-5|plain| (the
lanes' sums of expf(x - max) added by a shuffle tree, and a long row's
warps merged, against one max-then-sum)
and ``cg_weak_marg`` within 1e-5 + 1e-4|plain| (the centred covariance
against second - mean mean^T), with ``-inf`` exactly where the plain
version has it.
LM kernels: ``flash_attention`` (causal, windowed, and non-causal at
whisper's encoder, cross-attention and decode shapes) against the plain
``attention_blockwise`` within 2e-5 on fp32 inputs (the same fp32
products, summed in another order) and 0.05 on bf16 inputs (the kernel
carries the softmax weights as a bf16 hi + lo pair, the plain version
rounds them to bf16; the output is bf16); bf16 also against the plain
version in fp32 on the same inputs at chip_smoke.py's bar, |d| <= 2^-7
|exp| + 2^-8 mean |exp| (the output's bf16 rounding is at most 2^-8
|exp|);
``ssd_scan`` against ``ssd_chunked`` within rtol 2e-4 plus 2e-4 max|plain|
(another order of fp32 sums, a warp scan for the cumulative decay, and
split-TF32 products of about 20 bits each).
Training: ``flash_attention``'s backward kernels (``csrc/flash_attn_bwd.cu``)
against the plain backward in fp32 on the same inputs, the forward
kernel's output and lse, by relative L2 error of dq, dk and dv: 1e-5 on
fp32 inputs, 2^-7 on bf16 (chip_smoke.py's bar; the outputs' bf16
rounding is ~2^-9), two launches the same bits, the autograd path the
same bits as the wrapper, on a side stream too; ``ssd_scan``'s backward
kernels (``csrc/ssd_scan_bwd.cu``) against the plain backward in fp32 by
relative L2 error of dx, ddt, dA, dB and dC within 2e-4 (chip_smoke.py's
bar: split-TF32 products, dA a sum of b S terms of both signs), two
launches the same bits, autograd the wrapper's bits; reduced granite and
zamba2 steps on the card against the CPU (each gradient within 0.05
relative L2) and a VB step.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (clg_stats, factor_ops,  # noqa: E402
                                 family_counts, flash_attn, ref, ssd_scan)
from repro_torch.nn import attention as tattn  # noqa: E402
from repro_torch.nn import ssm as tssm  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _close(got, exp):
    for g, e in zip(got, exp):
        scale = float(e.abs().max()) + 1.0
        torch.testing.assert_close(g, e, rtol=1e-4, atol=1e-5 * scale)


def _same_bits(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _inputs(N, F, D, K, seed, dev):
    g = np.random.default_rng(seed)
    d = torch.from_numpy(g.standard_normal((N, F, D), dtype=np.float32))
    y = torch.from_numpy(g.standard_normal((N, F), dtype=np.float32))
    r = torch.softmax(torch.from_numpy(
        g.standard_normal((N, K), dtype=np.float32)), -1)
    return d.to(dev), y.to(dev), r.to(dev)


@pytest.mark.parametrize("N,F,D,K", [
    (1000, 3, 4, 2), (513, 1, 2, 5), (256, 2, 8, 16), (1 << 20, 10, 1, 4),
    (4099, 5, 3, 1),
])
def test_clg_suffstats_kernel(cuda, N, F, D, K):
    d, y, r = _inputs(N, F, D, K, 0, cuda)
    before = clg_stats.LAUNCHES["clg_suffstats"]
    got = clg_stats.clg_suffstats(d, y, r)
    again = clg_stats.clg_suffstats(d, y, r)
    torch.cuda.synchronize()
    assert clg_stats.LAUNCHES["clg_suffstats"] == before + 2
    _close(got, ref.clg_suffstats_ref(d, y, r))
    assert _same_bits(got, again)


@pytest.mark.parametrize("N,F,Do,K,L", [
    (600, 3, 2, 2, 1), (513, 2, 1, 3, 2), (256, 1, 3, 4, 8),
    (1 << 20, 16, 1, 1, 4), (777, 16, 1, 2, 16),
    (4099, 300, 1, 2, 4), (2000, 992, 1, 1, 4),    # wide rows
    (3001, 4, 2, 5, 3),                            # K = 5
    (1500, 3, 1, 5, 16),                           # L = 16 with K = 5
    (900, 2, 40, 2, 3),                            # two observed blocks
])
def test_clg_suffstats_latent_kernel(cuda, N, F, Do, K, L):
    """Any F in one launch (one stage-1 kernel a call): the wrapper makes
    one C launch a call, which runs stage 1 once and stage 2 once."""
    obs, y, r = _inputs(N, F, Do, K, 1, cuda)
    g = np.random.default_rng(2)
    hm = torch.from_numpy(g.standard_normal((N, K, L), dtype=np.float32))
    a = torch.from_numpy(g.standard_normal((K, L, L), dtype=np.float32)) * .3
    shh = a @ a.transpose(-1, -2) + torch.eye(L)
    hm, shh = hm.to(cuda), shh.to(cuda)
    before = clg_stats.LAUNCHES["clg_suffstats_latent"]
    got = clg_stats.clg_suffstats_latent(obs, hm, y, r, shh)
    again = clg_stats.clg_suffstats_latent(obs, hm, y, r, shh)
    torch.cuda.synchronize()
    assert clg_stats.LAUNCHES["clg_suffstats_latent"] == before + 2
    _close(got, ref.clg_suffstats_latent_ref(obs, hm, y, r, shh))
    assert _same_bits(got, again)


@pytest.mark.parametrize("N,Fd,C,K", [
    (1000, 2, 3, 2), (513, 1, 5, 4), (128, 3, 2, 7), (1 << 20, 2, 4, 3),
    (3000, 2, 64, 3),
    (1, 2, 4, 3),                       # one instance
    (1000003, 2, 4, 3),                 # N a multiple of no block size
    (5000, 380, 64, 2),                 # Fd + K > 376 (the tile kernel's
                                        # limit) and C = 64
    (20000, 400, 8, 4),                 # chip_smoke's wide row
])
def test_clg_disc_counts_kernel(cuda, N, Fd, C, K):
    """Read in place at any Fd + K, one launch a call (both stages),
    categories -1 and >= C counting nothing, the same bits twice."""
    g = np.random.default_rng(3)
    xd = g.integers(-1, C + 1, (N, Fd)).astype(np.int32)
    xd = torch.from_numpy(xd).to(cuda)
    r = torch.softmax(torch.from_numpy(
        g.standard_normal((N, K), dtype=np.float32)), -1).to(cuda)
    before = clg_stats.LAUNCHES["clg_disc_counts"]
    got = clg_stats.clg_disc_counts(xd, r, C)
    again = clg_stats.clg_disc_counts(xd, r, C)
    torch.cuda.synchronize()
    assert clg_stats.LAUNCHES["clg_disc_counts"] == before + 2
    _close([got], [ref.clg_disc_counts_ref(xd, r, C)])
    assert torch.equal(got, again)


def test_masked_rows_count_nothing(cuda):
    d, y, r = _inputs(300, 2, 3, 3, 4, cuda)
    r = r * (torch.arange(300, device=cuda) < 200)[:, None]
    full = clg_stats.clg_suffstats(d, y, r)
    trunc = clg_stats.clg_suffstats(d[:200].contiguous(),
                                    y[:200].contiguous(),
                                    r[:200].contiguous())
    _close(full, trunc)


def test_wrappers_raise_on_bad_cuda_input(cuda):
    d, y, r = _inputs(64, 2, 3, 2, 5, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        clg_stats.clg_suffstats(d.transpose(0, 1).contiguous().transpose(0, 1),
                                y, r)
    with pytest.raises(TypeError):
        clg_stats.clg_suffstats(d.double(), y, r)
    with pytest.raises(ValueError, match="one column"):
        # any number of leaves and any design width go in one launch; a
        # design of no columns is refused
        empty = torch.zeros((64, 2, 0), device=cuda)
        clg_stats.clg_suffstats(empty, torch.zeros((64, 2), device=cuda), r)


@pytest.mark.parametrize("N,F,D,K", [(5000, 300, 2, 2), (4099, 992, 2, 1),
                                     (700, 130, 3, 5)])
def test_clg_suffstats_wide_row_splits_by_leaf(cuda, N, F, D, K):
    """A row of F*D + F + K > 376 words (the most a 32-instance tile of the
    first kernel held in 48 KB of shared memory), which that kernel split
    by leaves: one launch a call, read in place, the moments equal to the
    plain version's, the same bits on a second call."""
    d, y, r = _inputs(N, F, D, K, 6, cuda)
    assert F * D + F + K > 376
    before = clg_stats.LAUNCHES["clg_suffstats"]
    got = clg_stats.clg_suffstats(d, y, r)
    again = clg_stats.clg_suffstats(d, y, r)
    torch.cuda.synchronize()
    assert clg_stats.LAUNCHES["clg_suffstats"] == before + 2
    _close(got, ref.clg_suffstats_ref(d, y, r))
    assert _same_bits(got, again)


@pytest.mark.parametrize("N,F,D,K", [
    (3000, 3, 12, 2),         # D > 8: a thread owns one row of sxx
    (2000, 5, 32, 1),         # one block of 32 columns a row
    (2000, 5, 40, 2),         # two column blocks a row
    (300, 2, 400, 2),         # 13 column blocks a row (once refused)
    (100000, 20, 3, 16),      # many components: units across blocks
    (50000, 7, 4, 3),         # D % 4 == 0: 16-byte loads; K % KG != 0
    (1 << 16, 1, 1, 1), (5, 2, 5, 2),
])
def test_clg_suffstats_kernel_design_widths(cuda, N, F, D, K):
    d, y, r = _inputs(N, F, D, K, 7, cuda)
    got = clg_stats.clg_suffstats(d, y, r)
    again = clg_stats.clg_suffstats(d, y, r)
    torch.cuda.synchronize()
    _close(got, ref.clg_suffstats_ref(d, y, r))
    assert _same_bits(got, again)


def test_clg_suffstats_kernel_reads_unaligned_rows(cuda):
    """d and r one float past a 16-byte boundary (off the 8- and 16-byte
    alignment the vector loads want): the 4-byte loads, same moments."""
    d, y, r = _inputs(4096, 6, 4, 4, 8, cuda)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device=cuda)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out

    d2, r2 = shifted(d), shifted(r)
    assert d2.data_ptr() % 8 and r2.data_ptr() % 8
    _close(clg_stats.clg_suffstats(d2, y, r2), ref.clg_suffstats_ref(d, y, r))


@pytest.mark.parametrize("N,F,D,K,chunk", [
    (1 << 16, 992, 2, 1, 1 << 14),      # the CLG search's chunks
    (50000, 30, 3, 4, 1 << 14),         # a ragged last chunk
    (3000, 5, 2, 1, 1 << 14),           # one chunk, shorter than chunk
    (40000, 3, 10, 2, 4096),            # D > 8
    (20000, 3, 40, 2, 4096),            # D > 32: two column blocks a row
])
def test_clg_suffstats_chunks_kernel(cuda, N, F, D, K, chunk):
    """One launch; each chunk the same bits as ``clg_suffstats`` of that
    chunk alone, and within tolerance of the plain version."""
    d, y, r = _inputs(N, F, D, K, 9, cuda)
    before = clg_stats.LAUNCHES["clg_suffstats_chunks"]
    got = clg_stats.clg_suffstats_chunks(d, y, r, chunk)
    torch.cuda.synchronize()
    assert clg_stats.LAUNCHES["clg_suffstats_chunks"] == before + 1
    n_chunks = -(-N // chunk)
    assert got[0].shape == (n_chunks, F, K, D, D)
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        one = clg_stats.clg_suffstats(d[sl], y[sl], r[sl])
        assert all(torch.equal(a[i], b) for a, b in zip(got, one))
        _close([a[i] for a in got], ref.clg_suffstats_ref(d[sl], y[sl],
                                                           r[sl]))
    assert _same_bits(got, clg_stats.clg_suffstats_chunks(d, y, r, chunk))


@pytest.mark.parametrize("spec,f,cards,latent_mask,chunk", [
    (dict(n_features=12, latent_card=3,
          discrete_features=((10, 4), (11, 4))), 10, (4, 4), None, None),
    (dict(n_features=2, latent_card=2, discrete_features=((0, 3), (1, 64))),
     0, (3, 64), None, 1000),                       # pure discrete, C = 64
    (dict(n_features=16, latent_card=2, latent_dim=16), 16, (), "eye", None),
    (dict(n_features=6, latent_card=3, latent_dim=2), 6, (), None, 777),
    (dict(n_features=3, latent_card=2, feature_parents=((), (0,), (0, 1))),
     3, (), None, None),
])
def test_local_step_cuda_backend_matches_einsum(cuda, spec, f, cards,
                                                latent_mask, chunk):
    """The VMP local step through the kernels against the einsum backend on
    the card: mixed, pure-discrete, per-leaf latent mask (dense fallback,
    L = F = 16), chunked and regression plates, with a masked tail."""
    from repro_torch.core import expfam as ef
    from repro_torch.core import vmp
    from repro_torch.core.dag import PlateSpec

    lm = None if latent_mask is None else np.eye(f, dtype=np.float32)
    cp = vmp.compile_plate(PlateSpec(**spec), lm, cuda)
    post = vmp.symmetry_broken(vmp.default_prior(cp),
                               torch.Generator().manual_seed(0))
    g = np.random.default_rng(9)
    n = 3000
    xc = torch.from_numpy(g.standard_normal((n, f), dtype=np.float32))
    xd = torch.from_numpy(np.stack([g.integers(0, c, n) for c in cards], 1)
                          .astype(np.int32) if cards
                          else np.zeros((n, 0), np.int32))
    mask = torch.ones(n)
    mask[-300:] = 0.0
    rf = torch.softmax(torch.from_numpy(g.standard_normal(
        (n, cp.layout.K), dtype=np.float32)), -1)
    args = [t.to(cuda) for t in (xc, xd, mask)]
    for r_fixed in (None, rf.to(cuda)):
        se, re_ = vmp.local_step(cp, post, *args, r_fixed, backend="einsum",
                                 chunk=chunk)
        sc, rc = vmp.local_step(cp, post, *args, r_fixed, backend="cuda",
                                chunk=chunk)
        a, b = ef.reg_dense(se.reg), ef.reg_dense(sc.reg)
        _close([b.sxx, b.sxy, b.syy, sc.disc, sc.counts],
               [a.sxx, a.sxy, a.syy, se.disc, se.counts])
        torch.testing.assert_close(rc, re_, rtol=0, atol=1e-6)


# -- factor algebra of the junction tree --------------------------------------


def _table(g, shape, p_neg_inf=0.25):
    """Random log table with structural zeros (evidence indicators)."""
    x = g.standard_normal(shape, dtype=np.float32)
    x[g.random(shape) < p_neg_inf] = -np.inf
    return x


def _same_inf_close(got, exp, atol, rtol):
    assert torch.equal(torch.isneginf(got), torch.isneginf(exp))
    fin = torch.isfinite(exp)
    torch.testing.assert_close(got[fin], exp[fin], atol=atol, rtol=rtol)


FACTOR_SHAPES = [(1, 8, 8), (4, 300, 13), (2, 64, 700), (3, 1, 1),
                 (1024, 4096, 4), (1024, 1, 16384), (7, 33, 31)]


@pytest.mark.parametrize("B,M,N", FACTOR_SHAPES)
def test_log_product_kernel(cuda, B, M, N):
    g = np.random.default_rng(10)
    a = torch.from_numpy(_table(g, (B, M, N))).to(cuda)
    b = torch.from_numpy(g.standard_normal((B, N), dtype=np.float32)).to(cuda)
    before = factor_ops.LAUNCHES["log_product"]
    got = factor_ops.log_product(a, b)
    torch.cuda.synchronize()
    assert factor_ops.LAUNCHES["log_product"] == before + 1
    assert torch.equal(got, ref.log_product_ref(a, b))


LSE_SHAPES = FACTOR_SHAPES + [(64, 100, 3), (8, 300, 17), (16, 60, 129),
                              (64, 8, 4096), (1024, 1024, 16)]


def _lse_table(g, shape):
    """_table with an all -inf row, a row -inf but for one entry, and a row
    -inf in its first half."""
    x = _table(g, shape)
    rows = x.reshape(-1, shape[-1])
    rows[0] = -np.inf
    rows[-1, 1:] = -np.inf
    rows[len(rows) // 2, : shape[-1] // 2] = -np.inf
    return x


def _check_lse(got, again, x):
    exp = ref.log_marginalize_ref(x)
    assert bool(torch.isneginf(got.view(-1)[0]))
    _same_inf_close(got, exp, atol=1e-5, rtol=1e-5)
    assert torch.equal(got, again)


@pytest.mark.parametrize("B,M,N", LSE_SHAPES)
def test_log_marginalize_kernel(cuda, B, M, N):
    g = np.random.default_rng(11)
    x = torch.from_numpy(_lse_table(g, (B, M, N))).to(cuda)
    got = factor_ops.log_marginalize(x)
    again = factor_ops.log_marginalize(x)
    torch.cuda.synchronize()
    _check_lse(got, again, x)


@pytest.mark.parametrize("B,M,N", [(4, 300, 16), (2, 64, 700),
                                   (16, 60, 129), (1024, 1, 4096)])
def test_log_marginalize_kernel_unaligned_base(cuda, B, M, N):
    """A contiguous view one float past an aligned base: the plan takes
    scalar loads (V = 1); the kernel still agrees with plain."""
    g = np.random.default_rng(13)
    x = torch.from_numpy(_lse_table(g, (B, M, N))).to(cuda)
    flat = torch.empty(B * M * N + 1, device=cuda)
    flat[1:] = x.view(-1)
    xv = flat[1:].view(B, M, N)
    assert xv.data_ptr() % 16
    assert factor_ops.lse_plan_of(xv).V == 1
    got = factor_ops.log_marginalize(xv)
    again = factor_ops.log_marginalize(xv)
    torch.cuda.synchronize()
    _check_lse(got, again, xv)


@pytest.mark.parametrize("B,M,N", [(1, 8, 8), (4, 300, 13), (2, 64, 700),
                                   (1024, 4096, 4)])
def test_evidence_select_kernel(cuda, B, M, N):
    g = np.random.default_rng(12)
    x = torch.from_numpy(_table(g, (B, M, N))).to(cuda)
    idx = torch.from_numpy(g.integers(0, N, B)).to(cuda)
    got = factor_ops.evidence_select(x, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.evidence_select_ref(x, idx))
    idx[0] = N                                         # out of range -> -inf
    assert bool(torch.isneginf(factor_ops.evidence_select(x, idx)[0]).all())


@pytest.mark.parametrize("B,M", [(3, 7), (5, 1), (2, 1030), (64, 257)])
@pytest.mark.parametrize("N", [1, 3, 4, 33])
@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_evidence_select_kernel_dtypes_and_ragged_rows(cuda, B, M, N, dtype):
    """int32 and int64 idx read in place, M not a multiple of 4 (groups of
    four outputs straddle rows of b), the 16-byte loads of N = 1 and 4 and
    the scalar loads of N = 3 and 33, -1 and N out of range: the plain
    version's bits; x at a 4-byte offset takes the scalar loads."""
    g = np.random.default_rng(14)
    x = torch.from_numpy(_table(g, (B, M, N))).to(cuda)
    idx = torch.from_numpy(g.integers(-1, N + 1, B)).to(cuda, dtype)
    before = factor_ops.LAUNCHES["evidence_select"]
    got = factor_ops.evidence_select(x, idx)
    torch.cuda.synchronize()
    assert factor_ops.LAUNCHES["evidence_select"] == before + 1
    assert torch.equal(got, ref.evidence_select_ref(x, idx))
    wide = torch.from_numpy(g.integers(0, N, (B, 2))).to(cuda, dtype)
    assert torch.equal(factor_ops.evidence_select(x, wide[:, 1]),
                       ref.evidence_select_ref(x, wide[:, 1]))
    buf = torch.empty(B * M * N + 1, device=cuda)
    shifted = buf[1:].view(B, M, N)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16
    assert torch.equal(factor_ops.evidence_select(shifted, idx),
                       ref.evidence_select_ref(x, idx))


@pytest.mark.parametrize("B,M,N,n", [(1, 4, 3, 1), (3, 130, 6, 2),
                                     (2, 8, 12, 3), (1024, 1, 3, 1),
                                     (1024, 1, 4, 4), (5, 7, 9, 8),
                                     (16384, 1, 4, 4), (4, 6, 3, 9),
                                     (3, 5, 7, 12), (2, 3, 5, 16),
                                     (1, 2, 3, 40), (7, 3, 40, 2),
                                     (6, 5, 1, 4)])   # a row of N = 1
def test_cg_weak_marg_kernel(cuda, B, M, N, n):
    """Any n (n = 9, 12, 16: entry blocks; n = 40 > 32: the mean read back
    from the output), N past a lane group's 32, one-component rows."""
    g = np.random.default_rng(13)
    lw = _table(g, (B, M, N))
    lw[0, 0] = -np.inf                                 # a dead row
    mu = g.standard_normal((B, M, N, n), dtype=np.float32)
    a = g.standard_normal((B, M, N, n, n), dtype=np.float32)
    sigma = a @ np.swapaxes(a, -1, -2) + 0.5 * np.eye(n, dtype=np.float32)
    lw, mu, sigma = (torch.from_numpy(t).to(cuda) for t in (lw, mu, sigma))
    got = factor_ops.cg_weak_marg(lw, mu, sigma)
    again = factor_ops.cg_weak_marg(lw, mu, sigma)
    torch.cuda.synchronize()
    exp = ref.cg_weak_marg_ref(lw, mu, sigma)
    _same_inf_close(got[0], exp[0], atol=1e-5, rtol=1e-5)
    for x, y in zip(got[1:], exp[1:]):
        torch.testing.assert_close(x, y, atol=1e-5, rtol=1e-4)
    assert float(got[1][0, 0].abs().max()) == 0.0
    assert torch.equal(got[2][0, 0], torch.eye(n, device=cuda))
    assert _same_bits(got, again)


def test_factor_wrappers_raise_on_bad_cuda_input(cuda):
    x = torch.zeros((2, 3, 4), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        factor_ops.log_marginalize(x.transpose(1, 2))
    with pytest.raises(TypeError):
        factor_ops.log_product(x.double(), torch.zeros((2, 4), device=cuda))


@pytest.mark.parametrize("net", ["discrete", "chain", "fa"])
def test_exact_engine_cuda_backend_matches_plain(cuda, net):
    """The junction-tree engine through the kernels against its plain
    backend on the card: posteriors within 1e-5, log-evidence within
    1e-4, means/variances within 1e-4 (1 + |plain|)."""
    from repro_torch.data.synthetic import random_discrete_bn
    from repro_torch.infer_exact import JunctionTreeEngine

    g = np.random.default_rng(14)
    if net == "discrete":
        bn = random_discrete_bn(12, card=3, max_parents=3, seed=1,
                                device=cuda)
        ev = {"D11": g.integers(0, 3, 64), "D4": g.integers(0, 3, 64)}
        cont = []
    else:
        from repro_torch.core.dag import (BayesianNetwork, CLGCPD, DAG,
                                          MultinomialCPD, Variables)

        vs = Variables()
        Z = vs.new_multinomial("Z", 3)
        hs = [vs.new_gaussian(f"H{i}") for i in range(2 if net == "fa" else 1)]
        xs = [vs.new_gaussian(f"X{i}") for i in range(4)]
        dag = DAG(vs)
        t = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda)
        cpds = {"Z": MultinomialCPD(t(g.dirichlet(np.ones(3))))}
        for h in hs:
            dag.add_parent(h, Z)
            cpds[h.name] = CLGCPD(t(g.standard_normal(3)), t(np.zeros((3, 0))),
                                  t(0.5 + g.random(3)))
        chain = [hs[0]] + xs if net == "chain" else xs
        for i, x in enumerate(xs):
            pas = [chain[i]] if net == "chain" else hs
            for p in pas:
                dag.add_parent(x, p)
            cpds[x.name] = CLGCPD(t(g.standard_normal()),
                                  t(g.standard_normal(len(pas))),
                                  t(0.3 + g.random()))
        bn = BayesianNetwork(dag, cpds)
        obs = xs[-1:] if net == "chain" else xs
        ev = {x.name: g.standard_normal(64).astype(np.float32) for x in obs}
        cont = [v for v in bn.order if not v.is_discrete and v.name not in ev]
    out = {}
    for backend in ("einsum", "cuda"):
        factor_ops.reset_launches()
        eng = JunctionTreeEngine(bn, backend=backend, device=cuda)
        eng.set_evidence(ev)
        eng.run_inference()
        out[backend] = (
            [eng.posterior_discrete(v) for v in bn.order if v.is_discrete],
            eng.log_evidence(), [eng.posterior_mean_var(v) for v in cont])
        launched = sum(factor_ops.LAUNCHES.values())
        assert (launched > 0) == (backend == "cuda")
    (pc, lc, mc), (pe, le, me) = out["cuda"], out["einsum"]
    for a, b in zip(pc, pe):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    torch.testing.assert_close(lc, le, atol=1e-4, rtol=0)
    for (m1, v1), (m2, v2) in zip(mc, me):
        torch.testing.assert_close(m1, m2, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(v1, v2, atol=1e-4, rtol=1e-4)


# -- family counts of structure learning --------------------------------------


def _families(g, Fd, cards, M, max_pa):
    """M random families (child, up to max_pa parents) and their strides."""
    strides = np.zeros((M, Fd), np.int32)
    C = 1
    for m in range(M):
        ch = int(g.integers(0, Fd))
        rest = [f for f in range(Fd) if f != ch]
        pa = g.choice(rest, size=int(g.integers(0, max_pa + 1)),
                      replace=False)
        s = 1
        for f in [ch] + list(pa):
            strides[m, f] = s
            s *= cards[f]
        C = max(C, s)
    return strides, C


@pytest.mark.parametrize("N,Fd,card,M,max_pa", [
    (1000, 4, 3, 7, 2), (513, 6, 2, 1, 1), (4099, 32, 4, 300, 2),
    (3000, 8, 4, 40, 3), (1 << 20, 32, 4, 992, 1), (20000, 5, 7, 33, 3),
    (777, 200, 3, 65, 2),
])
def test_family_counts_kernel(cuda, N, Fd, card, M, max_pa):
    """0/1 weights with a masked tail: the plain version's bits, the same
    bits again; uniform weights in (0, 1): rtol 1e-5.  (20000, 5, 7, 33, 3)
    has C = 2401 bins, split into ranges; (777, 200, ...) a wide tile."""
    g = np.random.default_rng(N + M)
    cards = [card] * Fd
    xd = torch.from_numpy(g.integers(0, card, (N, Fd)).astype(np.int32))
    strides, C = _families(g, Fd, cards, M, max_pa)
    mask = np.ones(N, np.float32)
    mask[-(N // 7):] = 0.0
    xd, st = xd.to(cuda), torch.from_numpy(strides).to(cuda)
    w01 = torch.from_numpy(mask).to(cuda)
    before = family_counts.LAUNCHES["family_counts"]
    got = family_counts.family_counts(xd, st, w01, C)
    again = family_counts.family_counts(xd, st, w01, C)
    torch.cuda.synchronize()
    assert family_counts.LAUNCHES["family_counts"] == before + 2
    assert torch.equal(got, ref.family_counts_ref(xd, st, w01, C))
    assert torch.equal(got, again)
    wf = torch.from_numpy(g.random(N).astype(np.float32)).to(cuda)
    torch.testing.assert_close(family_counts.family_counts(xd, st, wf, C),
                               ref.family_counts_ref(xd, st, wf, C),
                               rtol=1e-5, atol=1e-5)


def test_family_counts_out_of_range_codes_count_nothing(cuda):
    """Categories -1 and >= card make codes < 0 or >= C: no bin gets them,
    as in the plain version (and jax.nn.one_hot)."""
    g = np.random.default_rng(21)
    N, Fd = 5000, 3
    xd = g.integers(-1, 5, (N, Fd)).astype(np.int32)     # cards are 3
    strides = np.array([[1, 3, 0], [0, 1, 3], [1, 0, 0]], np.int32)
    xd, st = torch.from_numpy(xd).to(cuda), torch.from_numpy(strides).to(cuda)
    w = torch.ones(N, device=cuda)
    got = family_counts.family_counts(xd, st, w, 9)
    assert torch.equal(got, ref.family_counts_ref(xd, st, w, 9))
    assert float(got.sum()) < 3 * N


@pytest.mark.parametrize("N,Fd,card,M,max_pa,C", [
    (5000, 4, 300, 9, 1, 90000),    # values above 255: int32 tiles
    (20000, 8, 4, 50, 3, 256),      # C > Cb: two C ranges
    (1 << 16, 32, 4, 631, 3, 256),  # the adaptive stream's shape
    (3000, 3, 4, 3, 2, 64),         # mixed tiles (below)
])
def test_family_counts_kernel_mixed_tiles(cuda, N, Fd, card, M, max_pa, C):
    """Byte and int32 tiles in one launch: a value above 255 or below 0 in
    some tiles, including codes that come back into [0, C) through other
    terms; the plain version's bits with 0/1 weights, the same bits twice,
    float weights within 1e-5."""
    g = np.random.default_rng(N + C)
    xd = g.integers(0, card, (N, Fd)).astype(np.int32)
    strides, C_fam = _families(g, Fd, [card] * Fd, M, max_pa)
    xd[::211, 0] = -1
    xd[7::389, 1] = 300
    xd[11::97] = np.where(np.arange(Fd) % 2, -1, card + 1)
    xd, st = torch.from_numpy(xd).to(cuda), torch.from_numpy(strides).to(cuda)
    w01 = torch.from_numpy((g.random(N) < 0.9).astype(np.float32)).to(cuda)
    got = family_counts.family_counts(xd, st, w01, C)
    again = family_counts.family_counts(xd, st, w01, C)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.family_counts_ref(xd, st, w01, C))
    assert torch.equal(got, again)
    wf = torch.from_numpy(g.random(N).astype(np.float32)).to(cuda)
    torch.testing.assert_close(family_counts.family_counts(xd, st, wf, C),
                               ref.family_counts_ref(xd, st, wf, C),
                               rtol=1e-5, atol=1e-5)


def test_family_counts_blocks_per_sm_match_the_plan(cuda):
    """The card's occupancy of the counting kernel is the plan's blocks an
    SM (shared memory, not registers, sets it)."""
    for N, M, C in ((1 << 20, 15904, 64), (1 << 20, 992, 16),
                    (1 << 16, 631, 256)):
        p = family_counts.plan(N, 32, M, C, clg_stats.sm_count(cuda))
        for k in (2, 3, 4):
            assert family_counts.blocks_per_sm(k, p) == p.blocks_per_sm


def test_family_counts_wrapper_raises_on_bad_cuda_input(cuda):
    xd = torch.zeros((64, 3), dtype=torch.int32, device=cuda)
    st = torch.ones((2, 3), dtype=torch.int32, device=cuda)
    w = torch.ones(64, device=cuda)
    with pytest.raises(TypeError):
        family_counts.family_counts(xd.long(), st, w, 4)
    with pytest.raises(ValueError, match="contiguous"):
        family_counts.family_counts(xd, st.t().contiguous().t(), w, 4)
    with pytest.raises(ValueError, match="limit"):
        wide = torch.zeros((8, 600), dtype=torch.int32, device=cuda)
        family_counts.family_counts(
            wide, torch.ones((1, 600), dtype=torch.int32, device=cuda),
            torch.ones(8, device=cuda), 4)


# -- LM kernels: flash_attention and ssd_scan ----------------------------------


def _qkv(B, Sq, Sk, Hq, Hkv, D, dtype, dev, seed=0):
    g = np.random.default_rng(seed)
    return [torch.from_numpy(g.standard_normal((B, S, H, D),
                                               dtype=np.float32)
                             ).to(device=dev, dtype=dtype)
            for S, H in ((Sq, Hq), (Sk, Hkv), (Sk, Hkv))]


ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 0.05}


def _bf16_ratio(got, q, k, v, window, causal=True):
    """max |d| / (2^-7 |exp| + 2^-8 mean |exp|) of bf16 ``got`` against the
    plain version in fp32 on the same inputs (chip_smoke.py's bar: <= 1)."""
    exp = tattn.attention_blockwise(q.float(), k.float(), v.float(),
                                    causal=causal, window=window)
    d = (got.float() - exp).abs()
    allow = 2.0 ** -7 * exp.abs() + 2.0 ** -8 * exp.abs().mean()
    return float((d / allow).max())


@pytest.mark.parametrize("B,S,Hq,Hkv,D", [
    (1, 128, 4, 4, 64),      # MHA
    (2, 256, 4, 2, 64),      # GQA: q head h reads kv head h % Hkv
    (1, 128, 4, 1, 128),     # MQA
    (1, 192, 2, 2, 256),     # head_dim 256, ragged S
    (1, 200, 8, 2, 80),      # head_dim 80, ragged S
    (2, 1024, 4, 4, 64),     # many tiles: skipping below the window
])
@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel(cuda, B, S, Hq, Hkv, D, window, dtype):
    q, k, v = _qkv(B, S, S, Hq, Hkv, D, dtype, cuda)
    before = flash_attn.LAUNCHES["flash_attention"]
    got = flash_attn.flash_attention(q, k, v, window=window)
    again = flash_attn.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert flash_attn.LAUNCHES["flash_attention"] == before + 2
    assert got.dtype == dtype and torch.equal(got, again)
    exp = tattn.attention_blockwise(q, k, v, window=window)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), exp.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        assert _bf16_ratio(got, q, k, v, window) <= 1.0


def test_flash_attention_kernel_long_window(cuda):
    """The prefill's sequence length and window at 4 heads: 64 q tiles of
    128 rows, each visiting at most 33 kv tiles of 128 keys."""
    q, k, v = _qkv(1, 8192, 8192, 4, 4, 64, torch.bfloat16, cuda, seed=6)
    got = flash_attn.flash_attention(q, k, v, window=4096)
    again = flash_attn.flash_attention(q, k, v, window=4096)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _bf16_ratio(got, q, k, v, 4096) <= 1.0


def test_flash_attention_routes_by_dtype(cuda):
    """bf16 inputs launch the wgmma kernel, fp32 the split-TF32 one (no
    copy of contiguous inputs)."""
    q, k, v = _qkv(1, 128, 128, 2, 2, 64, torch.float32, cuda)
    flash_attn.reset_launches()
    flash_attn.flash_attention(q, k, v)
    bwd = {"bwd_bf16_wgmma": 0, "bwd_f32_tf32x3": 0, "bwd_dout_copy": 0,
           "bwd_f32_copy": 0}
    assert flash_attn.ROUTES == {"bf16_wgmma": 0, "f32_tf32x3": 1,
                                 "f32_copy": 0, **bwd}
    flash_attn.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert flash_attn.ROUTES == {"bf16_wgmma": 1, "f32_tf32x3": 1,
                                 "f32_copy": 0, **bwd}
    assert flash_attn.LAUNCHES["flash_attention"] == 2


@pytest.mark.parametrize("Sq,Sk", [(128, 128), (96, 300)])
def test_flash_attention_kernel_noncausal(cuda, Sq, Sk):
    q, k, v = _qkv(2, Sq, Sk, 4, 2, 64, torch.float32, cuda, seed=3)
    got = flash_attn.flash_attention(q, k, v, causal=False)
    exp = tattn.attention_reference(q, k, v, causal=False)
    torch.testing.assert_close(got, exp, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("B,Sq,Sk,H", [
    (2, 1500, 1500, 4),      # whisper's encoder: Sk not a multiple of 128
    (2, 448, 1500, 4),       # its decoder's cross attention in prefill
    (3, 1, 1500, 4),         # and in decode: one query a step
    (2, 130, 37, 2),         # Sq > Sk, one partial kv tile
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_cross_and_noncausal(cuda, B, Sq, Sk, H,
                                                     dtype):
    """Non-causal attention at whisper's shapes (D = 64): the ragged last kv
    tile masked, q tiles past Sq dropped, two launches the same bits."""
    q, k, v = _qkv(B, Sq, Sk, H, H, 64, dtype, cuda, seed=11)
    got = flash_attn.flash_attention(q, k, v, causal=False)
    again = flash_attn.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert got.shape == (B, Sq, H, 64) and torch.equal(got, again)
    exp = tattn.attention_blockwise(q, k, v, causal=False)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), exp.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        assert _bf16_ratio(got, q, k, v, None, causal=False) <= 1.0


def test_flash_attention_kernel_reads_strides(cuda):
    """q/k/v as views into wider [B, S, H, D + 16] buffers (D contiguous):
    the same bits as on contiguous copies."""
    q, k, v = _qkv(1, 160, 160, 4, 2, 80, torch.bfloat16, cuda, seed=5)
    wide = [torch.zeros(t.shape[:3] + (96,), dtype=t.dtype, device=cuda)
            for t in (q, k, v)]
    for w, t in zip(wide, (q, k, v)):
        w[..., :80] = t
    views = [w[..., :80] for w in wide]
    assert not views[0].is_contiguous()
    assert torch.equal(flash_attn.flash_attention(*views, window=64),
                       flash_attn.flash_attention(q, k, v, window=64))


def test_flash_attention_wrapper_raises_on_bad_cuda_input(cuda):
    q, k, v = _qkv(1, 64, 64, 2, 2, 64, torch.float32, cuda)
    with pytest.raises(TypeError):
        flash_attn.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        flash_attn.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="contiguous in D"):
        flash_attn.flash_attention(q.transpose(2, 3).contiguous()
                                   .transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="multiple of 16"):
        flash_attn.flash_attention(q[..., :40], k[..., :40], v[..., :40])
    with pytest.raises(ValueError, match="disagree"):
        flash_attn.flash_attention(q, k[:, :, :1], v)


def test_flash_attention_bf16_raises_on_misaligned_input(cuda):
    """The bf16 kernel moves 16-byte chunks: an H stride that is not a
    multiple of 8 elements, or a base 2 bytes off, raises (no fallback)."""
    q, k, v = _qkv(1, 64, 64, 2, 2, 64, torch.bfloat16, cuda)
    wide = torch.zeros((1, 64, 2, 68), dtype=torch.bfloat16, device=cuda)
    wide[..., :64] = q
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attn.flash_attention(wide[..., :64], k, v)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attn.flash_attention(q, k, wide[..., 1:65])
    wide32 = torch.zeros((1, 64, 2, 68), device=cuda)      # fp32: any stride
    wide32[..., :64] = q.float()
    k32, v32 = k.float(), v.float()
    assert torch.equal(flash_attn.flash_attention(wide32[..., :64], k32, v32),
                       flash_attn.flash_attention(q.float(), k32, v32))


def _fp32_forward_checked(q, k, v, causal=True, window=None, q_offset=0):
    """The fp32 forward kernel with lse, twice (the same bits), through the
    entry point (the same out), against the plain version and
    ``attention_lse_plain`` within ATTN_TOL[float32]; returns (out, lse)."""
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = flash_attn._forward(q, k, v, causal, window, None, True, q_offset)
    again = flash_attn._forward(q, k, v, causal, window, None, True,
                                q_offset)
    entry = flash_attn.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(entry, got[0])
    tol = ATTN_TOL[torch.float32]
    torch.testing.assert_close(got[0], tattn.attention_blockwise(q, k, v,
                                                                 **kw),
                               rtol=tol, atol=tol)
    torch.testing.assert_close(got[1], flash_attn.attention_lse_plain(q, k,
                                                                      **kw),
                               rtol=tol, atol=tol)
    return got


@pytest.mark.parametrize("split", [True, False], ids=["split", "unsplit"])
@pytest.mark.parametrize("Sk", [1, 64, 1500])
@pytest.mark.parametrize("Sq", [1, 2, 17, 130])
def test_flash_attention_fp32_split_tf32(cuda, monkeypatch, Sq, Sk, split):
    """The fp32 forward at short and longer queries against short and long
    keys (GQA 4/2, D = 64, non-causal), split where the plan splits on a
    card of 132 SMs, unsplit on one of 1 SM (the splits' merge: the
    unsplit plan's result within the bar)."""
    sms = 132 if split else 1
    monkeypatch.setattr(flash_attn, "sm_count", lambda dev: sms)
    q, k, v = _qkv(2, Sq, Sk, 4, 2, 64, torch.float32, cuda, seed=Sq + Sk)
    splits = flash_attn.f32_splits(2, Sq, Sk, 4, 2, False, None, 0, sms)
    assert (splits > 1) == (split and Sk == 1500)
    routed = flash_attn.ROUTES["f32_tf32x3"]
    _fp32_forward_checked(q, k, v, causal=False)
    assert flash_attn.ROUTES["f32_tf32x3"] == routed + 3


# (B, Sq, Sk, Hq, Hkv, causal, window, q_offset): causal GQA; a window;
# a window at an offset; rows with no live key (64.. of 100), unsplit
# (one kv tile) and split (two tiles, rows 65.. of 128 in neither); the
# short plan (Sq <= 16) at an offset
FP32_MASKS = {
    "causal": (1, 130, 130, 4, 2, True, None, 0),
    "window": (1, 200, 200, 4, 1, True, 64, 0),
    "offset": (1, 100, 300, 4, 2, True, 60, 150),
    "no_live_key": (1, 100, 64, 2, 2, False, 1, 0),
    "no_live_key_split": (1, 128, 128, 2, 2, False, 10, 72),
    "short_offset": (2, 16, 200, 4, 1, True, None, 184),
}


@pytest.mark.parametrize("mask", list(FP32_MASKS))
@pytest.mark.parametrize("D", [16, 64, 144, 256])
def test_flash_attention_fp32_masks_and_widths(cuda, D, mask):
    B, Sq, Sk, Hq, Hkv, causal, window, off = FP32_MASKS[mask]
    q, k, v = _qkv(B, Sq, Sk, Hq, Hkv, D, torch.float32, cuda, seed=D)
    _, lse = _fp32_forward_checked(q, k, v, causal, window, off)
    if mask.startswith("no_live_key"):
        dead = ~flash_attn._live(Sq, 0, Sk, causal, window, cuda, off).any(1)
        assert dead.any() and (lse[:, :, dead] == -1e30).all()


def test_flash_attention_fp32_copies_inputs_off_tma_rules(cuda):
    """q, k and v as views whose H strides are not multiples of 4 or whose
    bases are 4 bytes off 16: one copy a call (``ROUTES["f32_copy"]``)
    and the bits of contiguous inputs; TMA-legal views of wider buffers
    take no copy and give the same bits."""
    q, k, v = _qkv(2, 130, 300, 4, 2, 64, torch.float32, cuda, seed=17)
    exp = flash_attn.flash_attention(q, k, v, window=100)
    for pad, lo in ((2, 0), (4, 1), (4, 0), (8, 4)):
        wide = [torch.zeros(t.shape[:3] + (64 + pad,), device=cuda)
                for t in (q, k, v)]
        for w, t in zip(wide, (q, k, v)):
            w[..., lo:lo + 64] = t
        views = [w[..., lo:lo + 64] for w in wide]
        legal = all(map(flash_attn._tma_ok_f32, views))
        assert legal == (pad % 4 == 0 and lo % 4 == 0)
        copies = flash_attn.ROUTES["f32_copy"]
        got = flash_attn.flash_attention(*views, window=100)
        torch.cuda.synchronize()
        assert flash_attn.ROUTES["f32_copy"] == copies + (not legal)
        assert torch.equal(got, exp)


def _ssd_inputs(b, S, H, P, G, N, dev, seed=0):
    g = np.random.default_rng(seed)
    x = g.standard_normal((b, S, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(g.standard_normal((b, S, H)))).astype(np.float32)
    A = np.exp(0.3 * g.standard_normal(H)).astype(np.float32)
    B = g.standard_normal((b, S, G, N), dtype=np.float32)
    C = g.standard_normal((b, S, G, N), dtype=np.float32)
    return [torch.from_numpy(a).to(dev) for a in (x, dt, A, B, C)]


def _ssd_close(got, exp):
    for a, e in zip(got, exp):
        torch.testing.assert_close(a, e, rtol=2e-4,
                                   atol=2e-4 * float(e.abs().max()))


@pytest.mark.parametrize("b,S,H,P,G,N,chunk", [
    (2, 128, 4, 32, 1, 64, 32),
    (1, 256, 2, 64, 2, 32, 64),      # G = 2: head h reads group h // 1
    (1, 128, 8, 64, 1, 128, 128),    # mamba2-1.3b tile shape
    (2, 1024, 64, 64, 1, 64, 128),   # zamba2-1.2b's heads, P, N and chunk
    (1, 90, 4, 16, 2, 24, 30),       # a chunk that is not a multiple of 4
    (3, 64, 6, 48, 3, 16, 64),
])
def test_ssd_scan_kernel(cuda, b, S, H, P, G, N, chunk):
    args = _ssd_inputs(b, S, H, P, G, N, cuda)
    before = ssd_scan.LAUNCHES["ssd_scan"]
    got = ssd_scan.ssd_scan(*args, chunk)
    again = ssd_scan.ssd_scan(*args, chunk)
    torch.cuda.synchronize()
    assert ssd_scan.LAUNCHES["ssd_scan"] == before + 2
    assert _same_bits(got, again)
    _ssd_close(got, tssm.ssd_chunked(*args, chunk))


def _ssd_smoke_inputs(b, S, H, P, G, N, dev, dt_shift, seed=0):
    """chip_smoke's SSD inputs: dt = softplus(randn + dt_shift), A =
    exp(linspace(0, 2.77, H)) (A up to 16, as zamba2's A_log init)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, S, H, P), generator=g, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn((b, S, H), generator=g, device=dev) + dt_shift)
    A = torch.exp(torch.linspace(0.0, 2.77, H, device=dev))
    B = torch.randn((b, S, G, N), generator=g, device=dev)
    C = torch.randn((b, S, G, N), generator=g, device=dev)
    return [x, dt, A, B, C]


@pytest.mark.parametrize("b,S,H,P,G,N,chunk,dt_shift", [
    (2, 8192, 64, 64, 1, 64, 128, -4.0),   # the prefill's call, as chip_smoke
    (1, 1024, 8, 64, 1, 64, 128, 2.0),     # large dt: a chunk's decay < e^-88
    (2, 128, 4, 64, 1, 64, 128, -4.0),     # one chunk
    (1, 4096, 8, 32, 2, 32, 64, -4.0),     # 64 chunks, G = 2
], ids=["prefill", "large-dt", "one-chunk", "many-chunks-G2"])
def test_ssd_scan_kernel_chunk_parallel(cuda, b, S, H, P, G, N, chunk,
                                        dt_shift):
    """The chunk-parallel kernels on chip_smoke's inputs: y and h_final
    against ``ssd_chunked``, finite, and the same bits twice."""
    args = _ssd_smoke_inputs(b, S, H, P, G, N, cuda, dt_shift)
    got = ssd_scan.ssd_scan(*args, chunk)
    again = ssd_scan.ssd_scan(*args, chunk)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(t).all()) for t in got)
    assert _same_bits(got, again)
    _ssd_close(got, tssm.ssd_chunked(*args, chunk))


def test_ssd_scan_kernel_reads_strided_b_c(cuda):
    """B and C as the two halves of one [b, S, 2GN] tensor, as
    ``apply_mamba2`` passes them: the same bits as contiguous copies."""
    x, dt, A, B, C = _ssd_inputs(2, 256, 8, 32, 2, 32, cuda, seed=4)
    BC = torch.cat([B.reshape(2, 256, -1), C.reshape(2, 256, -1)], -1)
    Bv, Cv = (t.reshape(2, 256, 2, 32) for t in BC.chunk(2, dim=-1))
    assert not Bv.is_contiguous()
    assert _same_bits(ssd_scan.ssd_scan(x, dt, A, Bv, Cv, 64),
                      ssd_scan.ssd_scan(x, dt, A, B, C, 64))


def test_ssd_scan_kernel_reads_unaligned_rows(cuda):
    """x one float past a 16-byte boundary and N = 7 (rows of B, C and the
    states not a multiple of 16 bytes): the kernels copy 4 bytes a lane
    there, and agree with the plain version and with themselves."""
    x, dt, A, B, C = _ssd_inputs(2, 256, 4, 32, 1, 7, cuda, seed=5)
    wide = torch.zeros((2, 256, 4, 33), device=cuda)
    wide[..., 1:] = x
    xv = wide[..., 1:]
    assert xv.data_ptr() % 16
    got = ssd_scan.ssd_scan(xv, dt, A, B, C, 64)
    assert _same_bits(got, ssd_scan.ssd_scan(xv, dt, A, B, C, 64))
    _ssd_close(got, tssm.ssd_chunked(x, dt, A, B, C, 64))


def test_ssd_scan_wrapper_raises_on_bad_cuda_input(cuda):
    x, dt, A, B, C = _ssd_inputs(1, 256, 4, 32, 1, 64, cuda)
    with pytest.raises(TypeError):
        ssd_scan.ssd_scan(x.bfloat16(), dt, A, B, C, 64)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3),
                          dt, A, B, C, 64)
    with pytest.raises(ValueError, match="chunk <= 128"):
        ssd_scan.ssd_scan(x, dt, A, B, C, 256)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_scan.ssd_scan(x, dt, A, B, C, 96)
    with pytest.raises(ValueError, match="multiple of 16"):
        ssd_scan.ssd_scan(x[..., :24], dt, A, B, C, 64)


def test_reduced_zamba2_forward_on_both_backends(cuda):
    """The reduced hybrid through ``forward``: 2 ``ssd_scan`` and 1
    ``flash_attention`` launches on ``"cuda"``, none on ``"einsum"``, and
    the two agree on the argmax at >= 98% of positions."""
    from repro_torch.configs import get_config
    from repro_torch.nn import transformer as T

    cfg = get_config("zamba2-1.2b").reduced()
    params = T.init_model(torch.Generator(device=cuda).manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab, (2, 256), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    flash_attn.reset_launches()
    ssd_scan.reset_launches()
    with torch.no_grad():
        cu = T.forward(params, toks, cfg).logits
        assert (flash_attn.LAUNCHES["flash_attention"],
                ssd_scan.LAUNCHES["ssd_scan"]) == (1, cfg.n_layers)
        ei = T.forward(params, toks, cfg, backend="einsum").logits
    assert (flash_attn.LAUNCHES["flash_attention"],
            ssd_scan.LAUNCHES["ssd_scan"]) == (1, cfg.n_layers)
    assert bool(torch.isfinite(cu).all())
    assert float((cu.argmax(-1) == ei.argmax(-1)).float().mean()) >= 0.98


def _lm_on_card_and_cpu(cuda, arch, S, enc_len=None):
    """A reduced model's forward on the card (``"cuda"``) and the same
    weights' forward on the CPU, with the card's flash_attention launches."""
    from repro_torch.configs import get_config
    from repro_torch.nn import transformer as T

    cfg = get_config(arch).reduced()
    cpu = T.init_model(torch.Generator().manual_seed(0), cfg)
    card = T.init_model(torch.Generator().manual_seed(0), cfg).to(cuda)
    g = np.random.default_rng(12)
    toks = torch.from_numpy(g.integers(0, cfg.vocab, (2, S)))
    enc = None if enc_len is None else torch.from_numpy(g.standard_normal(
        (2, enc_len, cfg.d_model), dtype=np.float32))
    flash_attn.reset_launches()
    with torch.no_grad():
        got = T.forward(card, toks.to(cuda), cfg, enc_input=None if enc is None
                        else enc.to(cuda))
        launches = flash_attn.LAUNCHES["flash_attention"]
        exp = T.forward(cpu, toks, cfg, enc_input=enc)
    return cfg, got, exp, launches


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "whisper-medium"])
def test_reduced_moe_and_audio_forward_card_vs_cpu(cuda, arch):
    """The reduced mixtral (S = 256 > its window of 64) and whisper
    (encoder over 64 frames, decoder S = 96) on the card against the same
    weights on the CPU: one ``flash_attention`` launch an attention
    (mixtral 2; whisper 2 encoder + 2 decoder + 2 cross), the argmax the
    same at >= 90% of positions (bf16 near-ties can move a route), and
    ``moe_aux`` within 1e-2 relative."""
    audio = arch == "whisper-medium"
    cfg, got, exp, launches = _lm_on_card_and_cpu(
        cuda, arch, 96 if audio else 256, 64 if audio else None)
    assert launches == (3 if audio else 1) * cfg.n_layers
    assert bool(torch.isfinite(got.logits).all())
    agree = float((got.logits.cpu().argmax(-1) == exp.logits.argmax(-1))
                  .float().mean())
    assert agree >= 0.9, agree
    torch.testing.assert_close(got.moe_aux.cpu(), exp.moe_aux, rtol=1e-2,
                               atol=0.0)


# -- the temporal models' sequence suff-stats -------------------------------


@pytest.mark.parametrize("B,T,F,D,K", [(64, 17, 3, 1, 4), (300, 64, 10, 2, 4),
                                       (1 << 10, 64, 10, 1, 4)])
def test_clg_seq_suffstats_kernel(cuda, B, T, F, D, K):
    """[B, T] read as one instance axis in one launch, a ragged mask folded
    into r (zero rows count nothing), against the plain version on the
    flattened views; the same bits twice; a strided view raises."""
    d, y, r = _inputs(B * T, F, D, K, 4, cuda)
    d, y, r = d.view(B, T, F, D), y.view(B, T, F), r.view(B, T, K)
    lengths = torch.arange(B, device=cuda) % T + 1
    r = r * (torch.arange(T, device=cuda)[None] < lengths[:, None])[..., None]
    before = clg_stats.LAUNCHES["clg_seq_suffstats"]
    got = clg_stats.clg_seq_suffstats(d, y, r)
    again = clg_stats.clg_seq_suffstats(d, y, r)
    torch.cuda.synchronize()
    assert clg_stats.LAUNCHES["clg_seq_suffstats"] == before + 2
    _close(got, ref.clg_suffstats_ref(d.view(B * T, F, D), y.view(B * T, F),
                                      r.view(B * T, K)))
    assert _same_bits(got, again)
    with pytest.raises(ValueError, match="contiguous"):
        clg_stats.clg_seq_suffstats(d, y.transpose(0, 1).contiguous()
                                    .transpose(0, 1), r)


def test_hmm_fit_cuda_matches_einsum(cuda):
    """An HMM and an AR-HMM fitted on the card with the kernel route (one
    clg_seq_suffstats launch a sweep) and with einsum: ELBO within
    1e-4 (1 + |e|), emission means within 1e-3 (1 + max|m|)."""
    from repro_torch.data import synthetic as syn
    from repro_torch.pgm_models import AutoRegressiveHMM, HiddenMarkovModel

    stream = syn.hmm_sequences(s=64, t=20, states=3, f=4, seed=1)[0]
    for cls in (HiddenMarkovModel, AutoRegressiveHMM):
        fits = {}
        for backend in ("cuda", "einsum"):
            m = cls(stream.attributes, n_states=3, seed=0, device=cuda,
                    backend=backend)
            before = clg_stats.LAUNCHES["clg_seq_suffstats"]
            e = m.update_model(stream, sweeps=6, tol=0.0)
            torch.cuda.synchronize()
            fits[backend] = (e, m.posterior.emis.m,
                             clg_stats.LAUNCHES["clg_seq_suffstats"] - before)
        (ec, mc, nc), (ee, me, ne) = fits["cuda"], fits["einsum"]
        assert (nc, ne) == (6, 0)
        assert abs(ec - ee) <= 1e-4 * (1 + abs(ee))
        assert float((mc - me).abs().max()) <= 1e-3 * (
            1 + float(me.abs().max()))


def test_temporal_serving_on_card(cuda):
    """PGMQueryEngine(mode="temporal") on a card-resident model: the
    results of filter and predict buckets equal the model's own API, the
    second flush hits the cached plans."""
    from repro_torch.data import synthetic as syn
    from repro_torch.pgm_models import HiddenMarkovModel
    from repro_torch.serve.engine import PGMQueryEngine

    stream = syn.hmm_sequences(s=40, t=16, states=3, f=2, seed=2)[0]
    m = HiddenMarkovModel(stream.attributes, n_states=3, device=cuda)
    m.update_model(stream, sweeps=4)
    eng = PGMQueryEngine(m, mode="temporal")
    xc = stream.xc
    for _ in range(2):
        qf = [eng.submit("filter", {}, payload=xc[i]) for i in range(20)]
        qp = [eng.submit("predict", {"horizon": 4}, payload=xc[i])
              for i in range(20, 40)]
        eng.flush()
    assert eng.plans.stats()["hits"] == 2
    filt = m.filtered_posterior(xc[:20]).cpu().numpy()
    pred = m.predictive(xc[20:40], 4).cpu().numpy()
    np.testing.assert_allclose(np.stack([q.result for q in qf]), filt,
                               atol=1e-5)
    np.testing.assert_allclose(np.stack([q.result for q in qp]), pred,
                               atol=1e-5)


# -- approximate inference (importance sampling, MAP, SVI, LDA) --------------


def _discrete_net(dev):
    from repro_torch.data.synthetic import random_discrete_bn

    return random_discrete_bn(10, card=3, seed=4, device=dev)


def test_importance_sampling_on_card_matches_exact(cuda):
    """Likelihood weighting on the card: each posterior table within
    5 sqrt(p (1 - p) / ESS) + 1e-3 of the exact engine's; the same seed
    gives the same bits; importance serving equals direct runs seeded
    ``seed + qid`` bit for bit."""
    from repro_torch.core.importance_sampling import ImportanceSampling
    from repro_torch.serve.engine import PGMQueryEngine

    bn = _discrete_net(cuda)
    queries = [("D0", {"D9": 1, "D3": 2}), ("D5", {"D9": 0}), ("D2", {})]
    exact = PGMQueryEngine(bn, mode="exact", device=cuda)
    ex = [exact.submit(t, ev) for t, ev in queries]
    exact.flush()
    eng = PGMQueryEngine(bn, mode="importance", n_samples=1 << 16, seed=3,
                         device=cuda)
    got = [eng.submit(t, ev) for t, ev in queries]
    eng.flush()
    for q, r in zip(got, ex):
        runs = []
        for _ in range(2):
            inf = ImportanceSampling(1 << 16, seed=3 + q.qid, device=cuda)
            inf.set_model(bn)
            inf.set_evidence(q.evidence)
            inf.run_inference()
            runs.append(inf.posterior_discrete(
                bn.dag.variables.by_name(q.target)).cpu().numpy())
        np.testing.assert_array_equal(runs[0], runs[1])
        np.testing.assert_array_equal(q.result, runs[0])
        ess = float(inf.effective_sample_size())
        bar = 5.0 * np.sqrt(r.result * (1 - r.result) / ess) + 1e-3
        assert (np.abs(q.result - r.result) <= bar).all()


def test_map_on_card_matches_cpu(cuda):
    """The hill climb from the same initial states on the card and on the
    CPU: the same assignment, log-probs within 1e-4 (1 + |lp|)."""
    from repro_torch.core import map_inference as M

    ev = {"D9": 1, "D3": 2}
    out = {}
    init = torch.randint(3, (256, 8), generator=torch.Generator()
                         .manual_seed(0))
    for dev in ("cpu", cuda):
        bn = _discrete_net(dev)
        states, best = M._hill_climb(
            bn, bn.evidence_tensors(ev, torch.device(dev)), init.to(dev), 6)
        out[str(dev)] = (states.cpu(), best.cpu())
    (sc, bc), (sg, bg) = out["cpu"], out[str(cuda)]
    i = int(bc.argmax())
    assert torch.equal(sg[int(bg.argmax())], sc[i])
    assert abs(float(bg.max()) - float(bc[i])) <= 1e-4 * (1 + abs(float(bc[i])))


def test_svi_step_cuda_matches_einsum(cuda):
    """Six SVI steps with the CUDA suff-stats kernels and with einsum, from
    the same posterior: natural parameters within rtol 1e-4 plus 1e-4 of
    each field's largest entry; the kernels launch."""
    from repro_torch.core import svi, vmp
    from repro_torch.core.dag import PlateSpec

    spec = PlateSpec(n_features=6, latent_card=3,
                     discrete_features=((4, 4), (5, 3)))
    cp = vmp.compile_plate(spec, None, cuda)
    prior = vmp.default_prior(cp)
    init = vmp.symmetry_broken(prior, torch.Generator().manual_seed(0))
    g = np.random.default_rng(5)
    states = {b: svi.svi_init(init) for b in ("cuda", "einsum")}
    before = clg_stats.LAUNCHES["clg_disc_counts"]
    for _ in range(6):
        xc = g.standard_normal((4096, 4), dtype=np.float32)
        xd = np.stack([g.integers(0, 4, 4096), g.integers(0, 3, 4096)], 1)
        for b in states:
            states[b] = svi.svi_step(cp, prior, states[b], xc, xd, 1e5,
                                     backend=b)
    torch.cuda.synchronize()
    assert clg_stats.LAUNCHES["clg_disc_counts"] - before == 6
    for a, e in zip(states["cuda"].nat, states["einsum"].nat):
        torch.testing.assert_close(a, e, rtol=1e-4,
                                   atol=1e-4 * float(e.abs().max()))


def test_lda_estep_on_card_matches_cpu(cuda):
    """LDA's dense E-step on the card against the CPU's on the same lam and
    counts: gammas and topic-word stats within rtol 1e-4."""
    from repro_torch.data import synthetic as syn
    from repro_torch.pgm_models import LDA

    counts, _ = syn.lda_corpus(64, 200, 5, doc_len=100, seed=1)
    lda = LDA(5, 200, seed=0, device="cpu")
    ref = LDA._doc_estep(lda.lam, torch.from_numpy(counts), lda.alpha)
    got = LDA._doc_estep(lda.lam.to(cuda), torch.from_numpy(counts).to(cuda),
                         lda.alpha)
    for g_, r_ in zip(got, ref):
        torch.testing.assert_close(g_.cpu(), r_, rtol=1e-4,
                                   atol=1e-6 * float(r_.abs().max()))


# -- d-VMP on one NCCL rank -----------------------------------------------------


@pytest.fixture
def nccl_mesh(cuda, tmp_path):
    """A one-rank NCCL world on the card and its ("data",) mesh."""
    import datetime

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(cuda)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=120))
    try:
        yield init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("spec,f,cards", [
    (dict(n_features=10, latent_card=4), 10, ()),
    (dict(n_features=12, latent_card=3,
          discrete_features=((10, 4), (11, 4))), 10, (4, 4)),
    (dict(n_features=16, latent_card=0, latent_dim=4), 16, ()),
])
def test_dvmp_fit_one_nccl_rank_is_vmp_fit_bits(cuda, nccl_mesh, spec, f,
                                                cards):
    """gmm_large-, nb_mixed- and fa_plate-shaped plates: dvmp_fit at one
    NCCL rank gives vmp_fit's bits on the card (the all_reduce of one rank
    is the identity), with one all_reduce a sweep and the suff-stats
    kernels launched as often as without the mesh."""
    from repro_torch.core import dvmp, vmp
    from repro_torch.core.dag import PlateSpec
    from repro_torch.core.streaming import tree_leaves

    cp = vmp.compile_plate(PlateSpec(**spec), None, cuda)
    prior = vmp.default_prior(cp)
    init = vmp.symmetry_broken(prior, torch.Generator().manual_seed(0))
    g = np.random.default_rng(4)
    n = 1 << 16
    xc = torch.from_numpy(g.standard_normal((n, f), dtype=np.float32))
    xd = torch.from_numpy(np.stack([g.integers(0, c, n) for c in cards], 1)
                          .astype(np.int32) if cards
                          else np.zeros((n, 0), np.int32))
    xc, xd = xc.to(cuda), xd.to(cuda)
    clg_stats.reset_launches()
    ref = vmp.vmp_fit(cp, prior, init, xc, xd, 5, 0.0)
    plain = dict(clg_stats.LAUNCHES)
    clg_stats.reset_launches()
    dvmp.reset_collectives()
    got = dvmp.dvmp_fit(cp, prior, init, xc, xd, nccl_mesh, ("data",), 5,
                        0.0)
    torch.cuda.synchronize()
    assert got.sweep == ref.sweep
    assert dvmp.COLLECTIVES["all_reduce"] == got.sweep
    assert dict(clg_stats.LAUNCHES) == plain and any(plain.values())
    assert _same_bits(tree_leaves(got.post), tree_leaves(ref.post))
    assert torch.equal(got.elbo, ref.elbo)


@pytest.mark.parametrize("mesh,axes", [("single", 1), ("multi", 2)])
def test_dryrun_main_on_one_nccl_rank(cuda, tmp_path, mesh, axes):
    """``python -m repro_torch.launch.dryrun_pgm`` with its defaults runs
    NCCL ranks on the cards: at one rank, ``make_production_mesh`` lays
    out ("data",) or ("pod", "data"), with one all_reduce a sweep and a
    data axis and the same bytes at N and 4N."""
    import json
    import os
    import subprocess
    import sys

    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env["PYTHONPATH"] = src
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun_pgm", "--n",
         str(1 << 14), "--mesh", mesh, "--out", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        rec = json.load(f)
    assert rec["backend"] == "nccl" and rec["device"].startswith("cuda")
    assert len(rec["data_axes"]) == axes and rec["claim_holds"]
    assert [r["all_reduces_per_sweep"] for r in rec["runs"]] == [axes] * 2


# -- the production tier on the card -----------------------------------------------


def test_async_server_two_replicas_on_card_is_the_direct_engine(cuda):
    """Two worker threads on one card: each answer is the bits of a direct
    ``PGMQueryEngine(pad_pow2=True)`` flush of the bucket that served it,
    on the card, and the factor kernels launched."""
    from repro_torch.data.synthetic import random_discrete_bn
    from repro_torch.serve.engine import PGMQueryEngine
    from repro_torch.serve.queue import AsyncPGMServer

    bn = random_discrete_bn(12, card=3, max_parents=2, seed=0, device=cuda)
    names = [v.name for v in bn.order]
    g = np.random.default_rng(0)
    buckets = [[(names[-1], {names[2]: float(g.integers(3)),
                             names[7]: float(g.integers(3))})
                for _ in range(8)] for _ in range(6)]
    factor_ops.reset_launches()
    with AsyncPGMServer(bn, mode="exact", max_batch=8, max_delay_ms=10_000,
                        default_deadline_ms=60_000, replicas=2,
                        device=cuda) as srv:
        # buckets form on the clock: record each one the server flushes
        flushed, flush = [], srv._flush_bucket
        srv._flush_bucket = lambda eng, bk, trig: (
            flushed.append(list(bk.items)), flush(eng, bk, trig))[1]
        tickets = [srv.submit(t, e) for b in buckets for t, e in b]
        for t in tickets:
            t.result(timeout=120)
        assert srv.stats()["pending"] == 0
    assert factor_ops.LAUNCHES["log_product"] > 0
    assert factor_ops.LAUNCHES["log_marginalize"] > 0
    assert sum(len(items) for items in flushed) == len(tickets)
    for items in flushed:
        eng = PGMQueryEngine(bn, mode="exact", pad_pow2=True, device=cuda)
        qs = [eng.submit(t, e) for _, t, e, _ in items]
        eng.flush()
        for (ticket, *_), q in zip(items, qs):
            assert np.array_equal(ticket.result(timeout=0), q.result)


def test_obs_kernel_counts_equal_launches_on_card(cuda, tmp_path):
    """A gmm stream fit and an exact flush on the card at BASIC: every
    ``<kernel>:cuda`` dispatch count equals its wrapper's LAUNCHES delta,
    and the posterior is the bits of the run at OFF."""
    from repro_torch import obs
    from repro_torch.core import streaming, vmp
    from repro_torch.core.dag import PlateSpec
    from repro_torch.data.synthetic import random_discrete_bn
    from repro_torch.serve.engine import PGMQueryEngine

    cp = vmp.compile_plate(PlateSpec(n_features=4, latent_card=3),
                           device=cuda)
    prior = vmp.default_prior(cp)
    init = vmp.symmetry_broken(prior, torch.Generator().manual_seed(0))
    g = np.random.default_rng(1)
    xcs = g.standard_normal((4, 4096, 4), dtype=np.float32)
    xds = np.zeros((4, 4096, 0), np.int32)
    bn = random_discrete_bn(10, card=3, max_parents=2, seed=1, device=cuda)
    names = [v.name for v in bn.order]

    def run():
        st, _ = streaming.stream_fit(cp, prior,
                                     streaming.stream_init(prior, init), xcs,
                                     xds, sweeps=3, tol=0.0)
        eng = PGMQueryEngine(bn, mode="exact", device=cuda)
        for i in range(16):
            eng.submit(names[-1], {names[3]: float(i % 3)})
        return st, [q.result for q in eng.flush()]

    prev = obs.configure(level="off")
    try:
        off = run()
        before = {**clg_stats.LAUNCHES, **factor_ops.LAUNCHES}
        obs.configure(level="basic", path=str(tmp_path / "ev.jsonl"),
                      reset_counters=True)
        on = run()
        kc = obs.kernel_counts()
    finally:
        obs.configure(level=prev["level"], path=prev["path"],
                      reset_counters=True)
    after = {**clg_stats.LAUNCHES, **factor_ops.LAUNCHES}
    cuda_counts = {k[:-5]: v for k, v in kc.items() if k.endswith(":cuda")}
    assert cuda_counts == {k: after[k] - before[k] for k in after
                           if after[k] != before[k]}
    assert cuda_counts["clg_suffstats"] > 0 and cuda_counts["log_product"] > 0
    from repro_torch.core.streaming import tree_leaves

    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(off[0]),
                                                 tree_leaves(on[0])))
    assert all(np.array_equal(a, b) for a, b in zip(off[1], on[1]))


def test_checkpoint_round_trip_of_card_tensors(cuda, tmp_path):
    """A stream state on the card saved and loaded: the same bits, on the
    card; resuming from it gives the uninterrupted fit's bits."""
    from repro_torch.core import streaming, vmp
    from repro_torch.core.dag import PlateSpec
    from repro_torch.resilience import CheckpointManager, resume_stream_fit

    cp = vmp.compile_plate(PlateSpec(n_features=3, latent_card=2),
                           device=cuda)
    prior = vmp.default_prior(cp)
    init = vmp.symmetry_broken(prior, torch.Generator().manual_seed(0))
    xcs = np.random.default_rng(2).standard_normal((6, 2048, 3),
                                                   dtype=np.float32)
    xds = np.zeros((6, 2048, 0), np.int32)
    kw = dict(sweeps=3, tol=0.0)
    head, _ = streaming.stream_fit(cp, prior,
                                   streaming.stream_init(prior, init),
                                   xcs[:2], xds[:2], **kw)
    mgr = CheckpointManager(str(tmp_path), every=2)
    mgr.save(2, head)
    like = streaming.stream_init(prior, init)
    back, meta = mgr.restore(like)
    from repro_torch.core.streaming import tree_leaves

    assert meta["t"] == 2
    assert all(b.device.type == "cuda" and torch.equal(a, b)
               for a, b in zip(tree_leaves(head), tree_leaves(back)))
    resumed, _ = resume_stream_fit(cp, prior, like, xcs, xds, manager=mgr,
                                   **kw)
    full, _ = streaming.stream_fit(cp, prior,
                                   streaming.stream_init(prior, init), xcs,
                                   xds, **kw)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(resumed),
                                                 tree_leaves(full)))


# -- flash_attention's backward kernels (csrc/flash_attn_bwd.cu) ---------------


def _bwd_ratio(got, exp, dtype):
    """Relative L2 error of a gradient over its bar (<= 1 passes):
    BWD_BF16_REL on bf16 inputs (the outputs' bf16 rounding is ~2^-9
    relative), BWD_F32_REL on fp32 ones (the same fp32 products summed in
    another order)."""
    rel = float((got.float() - exp).norm() / exp.norm().clamp_min(1e-30))
    return rel / (BWD_BF16_REL if dtype == torch.bfloat16 else BWD_F32_REL)


BWD_BF16_REL, BWD_F32_REL = 2.0 ** -7, 1e-5


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,window", [
    (2, 256, 256, 4, 2, 64, True, None),     # causal GQA
    (1, 300, 300, 8, 2, 64, True, 100),      # window, ragged S
    (2, 200, 200, 4, 4, 128, False, None),   # non-causal, D 128
    (1, 96, 300, 4, 1, 64, False, None),     # Sq != Sk, ragged Sk, MQA
    (1, 1, 150, 2, 2, 64, False, None),      # one query (decode's shape)
    (1, 160, 160, 2, 1, 32, False, 50),      # window without the causal mask
    (1, 130, 64, 4, 2, 64, True, None),      # causal, Sq > Sk
    (1, 384, 384, 8, 1, 256, True, None),    # gemma's MQA, D 256, causal
    (1, 100, 330, 4, 2, 256, False, None),   # D 256 non-causal, ragged Sk
    (1, 200, 200, 4, 2, 80, True, 70),       # D 80 padded to 128, window
    (1, 200, 200, 8, 2, 144, True, 70),      # D 144: fp32's 32-key tiles
    (2, 150, 180, 4, 1, 192, False, None),   # D 192 non-causal MQA, ragged
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_kernels(cuda, B, Sq, Sk, Hq, Hkv, D, causal,
                                          window, dtype):
    """The forward kernel's lse against the plain one; the three backward
    kernels (one counted launch a call, counted by route) against the
    plain backward in fp32 on the same inputs, the kernel's output and lse
    (:func:`_bwd_ratio`), twice the same bits; and through autograd the
    same gradients.  Both routes take every D here, fp32 at D > 128 on its
    plan of 32-key tiles."""
    bf16 = dtype == torch.bfloat16
    q, k, v = _qkv(B, Sq, Sk, Hq, Hkv, D, dtype, cuda, seed=3)
    g = _qkv(B, Sq, Sq, Hq, Hq, D, dtype, cuda, seed=4)[0]
    kw = dict(causal=causal, window=window)
    out, lse = flash_attn._forward(q, k, v, causal, window, None, True)
    exp_lse = flash_attn.attention_lse_plain(q, k, causal=causal,
                                             window=window)
    torch.testing.assert_close(lse, exp_lse, rtol=1e-5, atol=1e-4)
    before = flash_attn.LAUNCHES["flash_attention_backward"]
    route = "bwd_bf16_wgmma" if bf16 else "bwd_f32_tf32x3"
    routed = flash_attn.ROUTES[route]
    got = flash_attn.flash_attention_backward(q, k, v, out, lse, g, **kw)
    again = flash_attn.flash_attention_backward(q, k, v, out, lse, g, **kw)
    torch.cuda.synchronize()
    assert flash_attn.LAUNCHES["flash_attention_backward"] == before + 2
    assert flash_attn.ROUTES[route] == routed + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    exp = flash_attn.flash_attention_backward_plain(q, k, v, out, lse, g, **kw)
    for a, e, name in zip(got, exp, ("dq", "dk", "dv")):
        assert a.dtype == dtype and a.shape == e.shape
        assert _bwd_ratio(a, e, dtype) <= 1, (name, _bwd_ratio(a, e, dtype))
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    o = flash_attn.flash_attention(qr, kr, vr, **kw)
    assert torch.equal(o, out)
    grads = torch.autograd.grad(o, (qr, kr, vr), g)
    assert all(torch.equal(a, b) for a, b in zip(grads, got))
    assert flash_attn.LAUNCHES["flash_attention_backward"] == before + 3


# (B, Sq, Sk, Hq, Hkv, D, causal, q_offset): the fp32 rows' kinds
F32_BWD_CASES = {
    "causal_mqa_d64": (2, 512, 512, 8, 1, 64, True, 0),
    "causal_mqa_d128": (2, 512, 512, 8, 1, 128, True, 0),
    "causal_mqa_d256": (2, 512, 512, 8, 1, 256, True, 0),
    "gqa_d144": (2, 384, 384, 8, 2, 144, False, 0),
    "offset_gqa_d96": (1, 256, 640, 8, 2, 96, True, 320),
}


@pytest.mark.parametrize("sms", [1, None], ids=["unsplit", "split"])
@pytest.mark.parametrize("case", list(F32_BWD_CASES))
def test_flash_attention_backward_fp32_split_tf32(cuda, monkeypatch, case,
                                                  sms):
    """The fp32 route on the tensor cores in split TF32 (ROUTES
    ``bwd_f32_tf32x3``): twice the same bits, within BWD_F32_REL of the
    plain backward in fp32, through autograd the same bits; with the card's
    SM count (its dK/dV blocks' steps split, partials summed by the finish
    kernel) and with the plan told of 1 SM (no split)."""
    B, Sq, Sk, Hq, Hkv, D, causal, off = F32_BWD_CASES[case]
    if sms is not None:
        monkeypatch.setattr(flash_attn, "sm_count", lambda dev: sms)
    n_sms = flash_attn.sm_count(cuda)
    splits = flash_attn.dkdv_splits(B, Sq, Sk, Hq, Hkv, causal, None, off,
                                    n_sms)
    assert (splits == 1) == (sms == 1)
    q, k, v = _qkv(B, Sq, Sk, Hq, Hkv, D, torch.float32, cuda, seed=31)
    g = _qkv(B, Sq, Sq, Hq, Hq, D, torch.float32, cuda, seed=32)[0]
    kw = dict(causal=causal, q_offset=off)
    out, lse = flash_attn._forward(q, k, v, causal, None, None, True, off)
    routed = flash_attn.ROUTES["bwd_f32_tf32x3"]
    got = flash_attn.flash_attention_backward(q, k, v, out, lse, g, **kw)
    again = flash_attn.flash_attention_backward(q, k, v, out, lse, g, **kw)
    torch.cuda.synchronize()
    assert flash_attn.ROUTES["bwd_f32_tf32x3"] == routed + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    exp = flash_attn.flash_attention_backward_plain(q, k, v, out, lse, g,
                                                    **kw)
    for a, e, name in zip(got, exp, ("dq", "dk", "dv")):
        assert a.dtype == torch.float32 and a.shape == e.shape
        r = _bwd_ratio(a, e, torch.float32)
        assert r <= 1, (name, r)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    o = flash_attn.flash_attention(qr, kr, vr, **kw)
    assert torch.equal(o, out)
    grads = torch.autograd.grad(o, (qr, kr, vr), g)
    assert all(torch.equal(a, b) for a, b in zip(grads, got))
    assert flash_attn.ROUTES["bwd_f32_tf32x3"] == routed + 3


def test_flash_attention_backward_fp32_copies_inputs_off_tma_rules(cuda):
    """fp32 q, k, v whose strides break TMA's rules (views into rows of D +
    3 floats) are copied once a call (ROUTES ``bwd_f32_copy``) and give the
    bits of the contiguous inputs."""
    q, k, v = _qkv(1, 150, 150, 4, 2, 64, torch.float32, cuda, seed=33)
    g = _qkv(1, 150, 150, 4, 4, 64, torch.float32, cuda, seed=34)[0]
    views = []
    for t in (q, k, v):
        w = torch.zeros(t.shape[:3] + (67,), device=cuda)
        w[..., :64] = t
        views.append(w[..., :64])
    assert not any(map(flash_attn._tma_ok_f32, views))
    out, lse = flash_attn._forward(q, k, v, True, None, None, True)
    exp = flash_attn.flash_attention_backward(q, k, v, out, lse, g)
    copies = flash_attn.ROUTES["bwd_f32_copy"]
    got = flash_attn.flash_attention_backward(*views, out, lse, g)
    assert flash_attn.ROUTES["bwd_f32_copy"] == copies + 1
    assert all(torch.equal(a, b) for a, b in zip(got, exp))


@pytest.mark.parametrize("view", ["transposed", "unaligned"])
def test_flash_attention_backward_copies_a_strided_dout(cuda, view):
    """A dout that breaks TMA's rules (a view with D not contiguous; a
    base 2 bytes past 16-byte alignment) is copied
    once, counted in ROUTES["bwd_dout_copy"], and gives the bits of the
    contiguous dout; through autograd too."""
    q, k, v = _qkv(1, 100, 100, 4, 2, 64, torch.bfloat16, cuda, seed=11)
    g = _qkv(1, 100, 100, 4, 4, 64, torch.bfloat16, cuda, seed=12)[0]
    if view == "transposed":
        bad = g.transpose(2, 3).contiguous().transpose(2, 3)
    else:
        bad = torch.empty(g.numel() + 1, dtype=g.dtype,
                          device=cuda)[1:].view(g.shape).copy_(g)
    assert not flash_attn._tma_ok(bad) and torch.equal(bad, g)
    out, lse = flash_attn._forward(q, k, v, True, None, None, True)
    exp = flash_attn.flash_attention_backward(q, k, v, out, lse, g)
    copies = flash_attn.ROUTES["bwd_dout_copy"]
    got = flash_attn.flash_attention_backward(q, k, v, out, lse, bad)
    assert flash_attn.ROUTES["bwd_dout_copy"] == copies + 1
    assert all(torch.equal(a, b) for a, b in zip(got, exp))
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    grads = torch.autograd.grad(flash_attn.flash_attention(qr, kr, vr),
                                (qr, kr, vr), bad)
    assert all(torch.equal(a, b) for a, b in zip(grads, exp))


def test_flash_attention_backward_known_wrong_variants_fail(cuda):
    """The bar of the backward separates dK / dV folded onto the wrong kv
    head (h // G instead of h % Hkv) and a backward without delta."""
    q, k, v = _qkv(2, 256, 256, 8, 2, 64, torch.bfloat16, cuda, seed=5)
    g = _qkv(2, 256, 256, 8, 8, 64, torch.bfloat16, cuda, seed=6)[0]
    out, lse = flash_attn._forward(q, k, v, True, None, None, True)
    got = flash_attn.flash_attention_backward(q, k, v, out, lse, g)
    exp = flash_attn.flash_attention_backward_plain(q, k, v, out, lse, g)
    assert all(_bwd_ratio(a, e, torch.bfloat16) <= 1
               for a, e in zip(got, exp))
    # the wrong fold: q head h read kv head h // G
    perm = torch.arange(8, device=cuda).reshape(2, 4).T.reshape(-1)
    bad = flash_attn.flash_attention_backward_plain(
        q[:, :, perm], k, v, out[:, :, perm], lse[:, perm], g[:, :, perm])
    assert _bwd_ratio(bad[1], exp[1], torch.bfloat16) > 1
    no_delta = flash_attn.flash_attention_backward_plain(
        q, k, v, torch.zeros_like(out), lse, g)
    assert _bwd_ratio(no_delta[0], exp[0], torch.bfloat16) > 1


def test_flash_attention_backward_raises_on_bad_cuda_input(cuda):
    """What the kernels still refuse: D not a multiple of 16 and D > 256,
    on either route; and out, lse or dout that disagree with q."""
    for D in (72, 272):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _qkv(1, 64, 64, 2, 2, D, dtype, cuda)
            lse = torch.zeros((1, 2, 64), device=cuda)
            with pytest.raises(NotImplementedError,
                               match=f"multiple of 16 up to 256, got {D}"):
                flash_attn.flash_attention_backward(q, k, v, q, lse, q)
            qr = q.clone().requires_grad_()
            with pytest.raises(NotImplementedError,
                               match=f"multiple of 16 up to 256, got {D}"):
                flash_attn.flash_attention(qr, k, v)
    q, k, v = _qkv(1, 64, 64, 2, 2, 64, torch.float32, cuda)
    out, lse = flash_attn._forward(q, k, v, True, None, None, True)
    with pytest.raises(ValueError):
        flash_attn.flash_attention_backward(q, k, v, out, lse[:, :1], out)
    with pytest.raises(ValueError):
        flash_attn.flash_attention_backward(q, k, v, out, lse,
                                            out.bfloat16())


def test_flash_attention_backward_on_a_side_stream(cuda):
    """The autograd engine runs the backward on its device thread: the
    launches follow the stream the forward ran on."""
    q, k, v = _qkv(2, 512, 512, 4, 2, 64, torch.bfloat16, cuda, seed=7)
    g = _qkv(2, 512, 512, 4, 4, 64, torch.bfloat16, cuda, seed=8)[0]
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    exp = torch.autograd.grad(flash_attn.flash_attention(qr, kr, vr),
                              (qr, kr, vr), g)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
        o = flash_attn.flash_attention(qs, ks, vs)
        torch.cuda._sleep(10 ** 6)        # the side stream is still busy
        (o.float() * g.float()).sum().backward()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b.grad) for a, b in zip(exp, (qs, ks, vs)))


# -- the causal q offset (context-parallel attention) -------------------------


def _bf16_offset_ratio(got, q, k, v, window, off):
    exp = tattn.attention_blockwise(q.float(), k.float(), v.float(),
                                    window=window, q_offset=off)
    d = (got.float() - exp).abs()
    allow = 2.0 ** -7 * exp.abs() + 2.0 ** -8 * exp.abs().mean()
    return float((d / allow).max())


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,off,window", [
    (2, 256, 512, 4, 2, 64, 256, None),      # GQA, the second half
    (1, 200, 600, 8, 1, 64, 250, 100),       # MQA, windowed, ragged
    (1, 128, 384, 4, 4, 256, 128, None),     # D 256
    (1, 333, 1000, 2, 1, 128, 667, 300),     # MQA, D 128, the last block
    (1, 64, 64, 2, 2, 64, 0, None),          # offset 0
    (1, 200, 520, 8, 2, 144, 300, 90),       # D 144, GQA, windowed
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernels_with_a_q_offset(cuda, B, Sq, Sk, Hq, Hkv, D,
                                                 off, window, dtype):
    """Query i at position off + i: the forward against the plain version at
    the same offset (ATTN_TOL; bf16 also at chip_smoke.py's bar), its lse
    against the plain one, the backward kernels against the plain backward
    in fp32 (_bwd_ratio), each twice the same bits; the same call with
    offset 0 fails the bar (unless off is 0)."""
    bf16 = dtype == torch.bfloat16
    q, k, v = _qkv(B, Sq, Sk, Hq, Hkv, D, dtype, cuda, seed=21)
    g = _qkv(B, Sq, Sq, Hq, Hq, D, dtype, cuda, seed=22)[0]
    kw = dict(window=window, q_offset=off)
    got = flash_attn.flash_attention(q, k, v, **kw)
    again = flash_attn.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    exp = tattn.attention_blockwise(q, k, v, **kw)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), exp.float(), rtol=tol, atol=tol)
    if bf16:
        assert _bf16_offset_ratio(got, q, k, v, window, off) <= 1.0
    if off:
        wrong = flash_attn.flash_attention(q, k, v, window=window)
        assert _bf16_offset_ratio(wrong, q, k, v, window, off) > 1.0
    out, lse = flash_attn._forward(q, k, v, True, window, None, True, off)
    torch.testing.assert_close(lse, flash_attn.attention_lse_plain(
        q, k, window=window, q_offset=off), rtol=1e-5, atol=1e-4)
    grads = flash_attn.flash_attention_backward(q, k, v, out, lse, g, **kw)
    again = flash_attn.flash_attention_backward(q, k, v, out, lse, g, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    plain = flash_attn.flash_attention_backward_plain(q, k, v, out, lse, g,
                                                      **kw)
    for a, e, name in zip(grads, plain, ("dq", "dk", "dv")):
        assert _bwd_ratio(a, e, dtype) <= 1, (name, _bwd_ratio(a, e, dtype))
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    o = flash_attn.flash_attention(qr, kr, vr, **kw)
    auto = torch.autograd.grad(o, (qr, kr, vr), g)
    assert torch.equal(o, out)
    assert all(torch.equal(a, b) for a, b in zip(auto, grads))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 200])
def test_a_q_block_at_its_offset_gives_the_full_calls_bits(cuda, dtype,
                                                           window):
    """Rows off .. off + n - 1 of a full causal call and the call on those
    rows alone at q_offset = off (off a multiple of every q tile): the same
    output, lse and dq bits -- the offset moves the positions and nothing
    else, so offset 0 keeps the kernels' arithmetic."""
    B, S, Hq, Hkv, D, off, n = 2, 1024, 4, 2, 64, 512, 256
    q, k, v = _qkv(B, S, S, Hq, Hkv, D, dtype, cuda, seed=23)
    g = _qkv(B, S, S, Hq, Hq, D, dtype, cuda, seed=24)[0]
    out, lse = flash_attn._forward(q, k, v, True, window, None, True)
    qb, gb = (t[:, off:off + n].contiguous() for t in (q, g))
    ob, lb = flash_attn._forward(qb, k, v, True, window, None, True, off)
    assert torch.equal(ob, out[:, off:off + n])
    assert torch.equal(lb, lse[:, :, off:off + n])
    dq = flash_attn.flash_attention_backward(q, k, v, out, lse, g,
                                             window=window)[0]
    dqb = flash_attn.flash_attention_backward(qb, k, v, ob, lb, gb,
                                              window=window, q_offset=off)[0]
    assert torch.equal(dqb, dq[:, off:off + n])


def test_flash_attention_refuses_an_offset_past_the_keys(cuda):
    q, k, v = _qkv(1, 128, 256, 2, 2, 64, torch.bfloat16, cuda)
    for off in (-1, 129):
        with pytest.raises(ValueError, match="q_offset"):
            flash_attn.flash_attention(q, k, v, q_offset=off)
    # without the causal mask the offset moves the window alone
    assert flash_attn.flash_attention(q, k, v, causal=False,
                                      q_offset=1000).shape == q.shape


def test_real_cuda_tensors_never_take_the_fake_branch(cuda):
    """A launch on real CUDA tensors counts in LAUNCHES and adds nothing to
    FAKE_FLOPS, in both kernels' wrappers, forward and backward."""
    flash_attn.reset_launches()
    ssd_scan.reset_launches()
    q, k, v = (t.requires_grad_() for t in _qkv(1, 128, 128, 2, 2, 64,
                                                torch.bfloat16, cuda))
    flash_attn.flash_attention(q, k, v).float().sum().backward()
    x, dt, A, B, C = _ssd_inputs(1, 128, 2, 64, 1, 64, cuda)
    x.requires_grad_()
    ssd_scan.ssd_scan(x, dt, A, B, C, 64)[0].sum().backward()
    torch.cuda.synchronize()
    assert flash_attn.LAUNCHES == {"flash_attention": 1,
                                   "flash_attention_backward": 1}
    assert ssd_scan.LAUNCHES == {"ssd_scan": 1, "ssd_scan_backward": 1}
    assert not any(flash_attn.FAKE_FLOPS.values())
    assert not any(ssd_scan.FAKE_FLOPS.values())


SSD_BWD_REL = 2e-4      # chip_smoke.py's bar for the SSD backward


def _ssd_bwd_args(b, S, H, P, G, N, shift, dev, seed):
    """x, dt = softplus(randn + shift), A = exp(linspace(0, 2.77, H)), B and
    C strided views of one [b, S, 2 G N] tensor (as Mamba2 splits them),
    dy, dhfin."""
    import torch.nn.functional as Fnn

    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    x, dy = rn(b, S, H, P), rn(b, S, H, P)
    dt = Fnn.softplus(rn(b, S, H) + shift)
    A = torch.exp(torch.linspace(0.0, 2.77, H, device=dev))
    B, C = (t.reshape(b, S, G, N) for t in rn(b, S, 2 * G * N).chunk(2, -1))
    return x, dt, A, B, C, dy, rn(b, H, P, N)


@pytest.mark.parametrize("b,S,H,P,G,N,chunk,shift", [
    (1, 256, 4, 64, 1, 64, 128, -4.0),     # zamba2's P, N and chunk
    (2, 512, 8, 32, 2, 128, 128, 2.0),     # N = 128, G = 2, a large dt
    (1, 90, 6, 16, 3, 24, 30, 0.0),        # a ragged chunk, G = 3
    (2, 192, 4, 48, 4, 7, 64, -1.0),       # N = 7, one head a group
    (1, 1024, 64, 64, 1, 128, 128, -4.0),  # mamba2-1.3b's heads, N, chunk
    (2, 1800, 7, 32, 1, 128, 90, 0.0),     # a ragged chunk at N = 128, 7
    # heads in 3 dB/dC slices (2, 2, 3), clusters of two ranks
    (2, 1280, 10, 16, 2, 64, 64, -1.0),    # 5 heads a group in 3 slices
    # (1, 2, 2), one rank
])
def test_ssd_scan_backward_kernels(cuda, b, S, H, P, G, N, chunk, shift):
    """``ssd_scan_backward`` against the plain backward in fp32 on the same
    inputs: each of dx, ddt, dA, dB and dC within a relative L2 error of
    SSD_BWD_REL; two launches the same bits, one count each in
    ``ssd_scan_backward`` and none in ``ssd_scan`` (the recomputation is
    the backward's); autograd through ``ssd_scan`` gives the wrapper's bits
    with one launch of each."""
    x, dt, A, B, C, dy, dh = _ssd_bwd_args(b, S, H, P, G, N, shift, cuda,
                                           seed=S + N)
    ssd_scan.reset_launches()
    got = ssd_scan.ssd_scan_backward(x, dt, A, B, C, dy, dh, chunk)
    again = ssd_scan.ssd_scan_backward(x, dt, A, B, C, dy, dh, chunk)
    torch.cuda.synchronize()
    assert ssd_scan.LAUNCHES == {"ssd_scan": 0, "ssd_scan_backward": 2}
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    exp = ssd_scan.ssd_scan_backward_plain(x, dt, A, B, C, dy, dh, chunk)
    for name, u, e in zip(("dx", "ddt", "dA", "dB", "dC"), got, exp):
        rel = float((u - e).norm() / e.norm())
        assert rel <= SSD_BWD_REL, (name, rel)
    leaves = [t.detach().clone().requires_grad_() for t in (x, dt, A, B, C)]
    ssd_scan.reset_launches()
    y, h = ssd_scan.ssd_scan(*leaves, chunk)
    grads = torch.autograd.grad((y, h), leaves, (dy, dh))
    torch.cuda.synchronize()
    assert ssd_scan.LAUNCHES == {"ssd_scan": 1, "ssd_scan_backward": 1}
    assert all(torch.equal(u, v) for u, v in zip(grads, got))


def test_ssd_scan_backward_dy_copy_and_no_dhfin(cuda):
    """A dy with its last dim strided is copied once
    (``ROUTES["bwd_dy_copy"]``) and gives the contiguous dy's bits; dhfin
    None gives the bits of a zero dhfin, and so does autograd when the loss
    drops the final state."""
    x, dt, A, B, C, dy, dh = _ssd_bwd_args(2, 256, 8, 32, 2, 16, -1.0, cuda,
                                           seed=3)
    zero = torch.zeros_like(dh)
    exp = ssd_scan.ssd_scan_backward(x, dt, A, B, C, dy, zero, 64)
    bad = dy.transpose(2, 3).contiguous().transpose(2, 3)
    assert bad.stride(3) != 1 and torch.equal(bad, dy)
    copies = ssd_scan.ROUTES["bwd_dy_copy"]
    got = ssd_scan.ssd_scan_backward(x, dt, A, B, C, bad, None, 64)
    assert ssd_scan.ROUTES["bwd_dy_copy"] == copies + 1
    assert all(torch.equal(u, v) for u, v in zip(got, exp))
    leaves = [t.detach().clone().requires_grad_() for t in (x, dt, A, B, C)]
    y, _ = ssd_scan.ssd_scan(*leaves, 64)
    grads = torch.autograd.grad(y, leaves, dy)
    assert all(torch.equal(u, v) for u, v in zip(grads, exp))


def test_reduced_zamba2_train_step_card_vs_cpu(cuda):
    """Reduced zamba2-1.2b (Mamba2 blocks and the shared attention block)
    trained on the card (``"cuda"``: ``ssd_scan`` twice a Mamba2 block
    under remat and its backward kernels once, the attention kernels
    likewise) against the same weights on the CPU: each parameter's
    gradient within a relative L2 error of 0.05, and two AdamW steps'
    losses within 1e-2."""
    from repro_torch.configs import get_config
    from repro_torch.nn import transformer as T
    from repro_torch.train import step as TS

    cfg = get_config("zamba2-1.2b").reduced()
    cpu = T.init_model(torch.Generator().manual_seed(0), cfg, trainable=True)
    card = T.init_model(torch.Generator().manual_seed(0), cfg,
                        trainable=True).to(cuda)
    g = np.random.default_rng(14)
    toks = torch.from_numpy(g.integers(0, cfg.vocab, (2, 256)))
    labs = torch.from_numpy(g.integers(0, cfg.vocab, (2, 256)))
    cb = TS.TrainBatch(toks.to(cuda), labs.to(cuda))
    flash_attn.reset_launches()
    ssd_scan.reset_launches()
    (_, (loss_c, _)), grads_c = TS.grads_of(card, cb, cfg)
    torch.cuda.synchronize()
    assert ssd_scan.LAUNCHES == {"ssd_scan": 2 * cfg.n_layers,
                                 "ssd_scan_backward": cfg.n_layers}
    n_attn = flash_attn.LAUNCHES["flash_attention_backward"]
    assert n_attn > 0 and flash_attn.LAUNCHES["flash_attention"] == 2 * n_attn
    (_, (loss_p, _)), grads_p = TS.grads_of(cpu, TS.TrainBatch(toks, labs),
                                            cfg)
    assert abs(float(loss_c) - float(loss_p)) < 1e-2
    for k, e in grads_p.items():
        rel = float((grads_c[k].cpu() - e).norm() / e.norm())
        assert rel <= 0.05, (k, rel)
    sc, sp = TS.init_train_state(card), TS.init_train_state(cpu)
    for _ in range(2):
        sc, mc = TS.train_step(sc, cb, cfg)
        sp, mp = TS.train_step(sp, TS.TrainBatch(toks, labs), cfg)
        assert abs(float(mc["loss"]) - float(mp["loss"])) < 1e-2


def test_reduced_granite_train_step_card_vs_cpu(cuda):
    """Reduced granite-3-2b with GQA (Hkv = 2) trained on the card
    (``"cuda"``: the forward kernel twice a layer under remat, the backward
    kernels once) against the same weights on the CPU: each parameter's
    gradient within a relative L2 error of 0.05 (bf16 products rounded at
    other places; the kernel carries p as a hi + lo pair), and two AdamW
    steps' losses within 1e-2."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.nn import transformer as T
    from repro_torch.train import step as TS

    cfg = dataclasses.replace(get_config("granite-3-2b").reduced(),
                              n_kv_heads=2)
    cpu = T.init_model(torch.Generator().manual_seed(0), cfg, trainable=True)
    card = T.init_model(torch.Generator().manual_seed(0), cfg,
                        trainable=True).to(cuda)
    g = np.random.default_rng(13)
    toks = torch.from_numpy(g.integers(0, cfg.vocab, (2, 256)))
    labs = torch.from_numpy(g.integers(0, cfg.vocab, (2, 256)))
    cb = TS.TrainBatch(toks.to(cuda), labs.to(cuda))
    flash_attn.reset_launches()
    (_, (loss_c, _)), grads_c = TS.grads_of(card, cb, cfg)
    torch.cuda.synchronize()
    assert flash_attn.LAUNCHES == {"flash_attention": 2 * cfg.n_layers,
                                   "flash_attention_backward": cfg.n_layers}
    (_, (loss_p, _)), grads_p = TS.grads_of(cpu, TS.TrainBatch(toks, labs),
                                            cfg)
    assert abs(float(loss_c) - float(loss_p)) < 1e-2
    for k, e in grads_p.items():
        rel = float((grads_c[k].cpu() - e).norm() / e.norm())
        assert rel <= 0.05, (k, rel)
    sc, sp = TS.init_train_state(card), TS.init_train_state(cpu)
    for _ in range(2):
        sc, mc = TS.train_step(sc, cb, cfg)
        sp, mp = TS.train_step(sp, TS.TrainBatch(toks, labs), cfg)
        assert abs(float(mc["loss"]) - float(mp["loss"])) < 1e-2


def test_vb_train_step_on_the_card(cuda):
    """A VON step on the card: finite loss and KL, the mean updated in
    place (the model's own tensors)."""
    from repro_torch.configs import get_config
    from repro_torch.nn import transformer as T
    from repro_torch.train import step as TS

    cfg = get_config("granite-3-2b").reduced()
    params = T.init_model(torch.Generator(device=cuda).manual_seed(0), cfg,
                          trainable=True)
    st = TS.init_vb_state(params)
    g = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 128), device=cuda, generator=g)
    before = params["embed"]["table"].detach().clone()
    st, m = TS.vb_train_step(st, TS.TrainBatch(toks, toks.roll(-1, 1)), cfg,
                             n_total=1e4)
    assert bool(torch.isfinite(m["loss"])) and bool(torch.isfinite(m["kl"]))
    assert not torch.equal(before, params["embed"]["table"])
    assert st.vb.mean["embed.table"] is params["embed"]["table"]


# -- the LM mesh paths on one NCCL rank ---------------------------------------


@pytest.fixture
def nccl_lm_mesh(cuda, tmp_path):
    """A one-rank NCCL world on the card and its ("data", "model") 1 x 1
    mesh."""
    import datetime

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(cuda)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=120))
    try:
        yield init_device_mesh("cuda", (1, 1),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "mixtral-8x7b",
                                  "granite-3-2b"])
def test_lm_mesh_one_nccl_rank_is_mesh_free_bits(cuda, nccl_lm_mesh, arch):
    """Reduced configs on the card: forward(sh=) and decode_step(sh=) on a
    1 x 1 NCCL mesh give the mesh-free bits with the kernels launched as
    often (the expert combine's bf16 sum over one rank included), and a
    train_step(sh=) updates every weight to the mesh-free bits."""
    from repro_torch.configs import get_config
    from repro_torch.nn import transformer as T
    from repro_torch.sharding import mesh_specs, shard_params
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as ts

    cfg = get_config(arch).reduced()
    sh = T.Shardings(mesh=nccl_lm_mesh)
    lm = T.init_model(torch.Generator(device=cuda).manual_seed(0), cfg,
                      trainable=True)
    loc = shard_params(lm, mesh_specs(lm, sh, "train"), sh.mesh)
    g = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 256), device=cuda, generator=g)
    counts = []
    with torch.no_grad():
        outs = []
        for p, s in ((lm, T.NO_SHARD), (loc, sh)):
            flash_attn.reset_launches()
            ssd_scan.reset_launches()
            outs.append(T.forward(p, toks, cfg, s).logits)
            torch.cuda.synchronize()
            counts.append((dict(flash_attn.LAUNCHES),
                           dict(ssd_scan.LAUNCHES)))
        assert torch.equal(*outs)
        assert counts[0] == counts[1]
        st = [T.init_decode_state(p, cfg, 2, 32, sh=s)
              for p, s in ((lm, T.NO_SHARD), (loc, sh))]
        for t in range(40):
            lg = []
            for i, (p, s) in enumerate(((lm, T.NO_SHARD), (loc, sh))):
                out, st[i] = T.decode_step(p, st[i], toks[:, t:t + 1], cfg,
                                           sh=s)
                lg.append(out)
            assert torch.equal(*lg), t
    batch = ts.TrainBatch(tokens=toks, labels=torch.roll(toks, -1, 1))
    lr = opt.cosine_schedule(1e-3, 1, 100)
    s0, m0 = ts.train_step(ts.init_train_state(lm), batch, cfg, lr_fn=lr)
    s1, m1 = ts.train_step(ts.init_train_state(loc), batch, cfg, sh,
                           lr_fn=lr)
    assert torch.equal(m0["loss"], m1["loss"])
    p1 = dict(s1.params.named_parameters())
    assert all(torch.equal(p, p1[k]) for k, p in s0.params.named_parameters())
