"""The backward of the SSD scan, on the CPU: ``ssd_scan_backward_plain``
(``kernels/ssd_scan.py``) against ``jax.grad`` of the reference's
``ssd_chunked`` and torch autograd of the port's; the CUDA kernels'
dataflow (``csrc/ssd_scan_bwd.cu``) emulated in torch with their
split-TF32 products; ``SsdScanFn``'s wiring; the kernels' plan and
shared memory; and whole-model gradients of the ssm and hybrid families.

The gradients are those of the functional sum(dy ⊙ y) + sum(dhfin ⊙
h_final).  Tolerances:
* the plain backward in float64 against float64 autograd in JAX and in
  torch: relative L2 error 1e-9 for each of dx, ddt, dA, dB and dC (the
  same function, rounded at ~1e-16);
* the emulated kernels in fp32 against the plain backward in float64:
  chip_smoke.py's bar (``_ssd_bwd_ratio``: relative L2 over SSD_BWD_REL =
  2e-4 for each gradient) held at <= 0.5; at chip_smoke's inputs (dt =
  softplus(randn - 4)) the five are ~1e-6, with a large dt (softplus(randn
  + 2), a chunk's decay past e^-88) dA's is ~2.5e-5; one TF32 pass gives
  ~1.5e-3 and breaks the bar, and each known-wrong variant breaks it at
  least tenfold;
* reduced mamba2-1.3b and zamba2-1.2b: the loss within 2e-3 and each
  parameter's gradient within a relative L2 error of GRAD_REL (bf16
  matmuls in both packages, rounded at other places).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_parity  # noqa: E402,F401  (one torch thread per worker)
from repro.configs import get_config as jax_config  # noqa: E402
from repro.nn import transformer as JT  # noqa: E402
from repro.nn.ssm import ssd_chunked as jax_ssd  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402
from repro_torch.nn import ssm as tssm  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402
from test_torch_ssd_plan import _chip_smoke, _mm  # noqa: E402

GRAD_REL = 0.03
SMEM_BLOCK_MAX = 232448          # bytes a block may use on an H100
SMEM_SM = 233472                 # bytes of shared memory an SM can hand out
SMEM_RESERVED = 1024             # bytes the runtime keeps per block
GRADS = ("dx", "ddt", "dA", "dB", "dC")


def _x64():
    """float64 in JAX for a block (``jax.enable_x64`` or, before it, the
    experimental context of the same name)."""
    if hasattr(jax, "enable_x64"):
        return jax.enable_x64(True)
    from jax.experimental import enable_x64
    return enable_x64()


def _inputs(b, S, H, P, G, N, dt_shift, seed=0):
    """x, B, C, dy, dhfin standard normal, dt = softplus(randn + dt_shift),
    A = exp(linspace(0, 2.77, H)) (chip_smoke's), fp32 numpy."""
    g = np.random.default_rng(seed)
    x = g.standard_normal((b, S, H, P))
    dt = np.logaddexp(0.0, g.standard_normal((b, S, H)) + dt_shift)
    A = np.exp(np.linspace(0.0, 2.77, H))
    B = g.standard_normal((b, S, G, N))
    C = g.standard_normal((b, S, G, N))
    dy = g.standard_normal((b, S, H, P))
    dh = g.standard_normal((b, H, P, N))
    return [np.asarray(a, np.float32) for a in (x, dt, A, B, C, dy, dh)]


def _rel(got, exp):
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    return float(np.linalg.norm(got - exp) / np.linalg.norm(exp))


CASES = {"G1_S=l": (2, 32, 4, 5, 1, 3, 32, 0.0),
         "G2_S=4l": (2, 128, 4, 5, 2, 3, 32, 0.0),
         "N7_G3": (1, 64, 6, 4, 3, 7, 16, 0.0),
         "small_dt": (1, 256, 4, 8, 1, 8, 64, -4.0),
         # a chunk of 8: its decays pass e^-88, and exp(cum_i - cum_j)
         # above the diagonal, which the references compute and mask, stays
         # below fp64's overflow, so that their autodiff stays finite
         "large_dt": (1, 64, 4, 8, 2, 8, 8, 2.0)}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_jax_grad_and_autograd(case):
    """All five gradients, float64, against ``jax.grad`` of
    ``repro.nn.ssm.ssd_chunked`` and torch autograd of the port's."""
    *shape, chunk, shift = CASES[case]
    arrays = _inputs(*shape, shift)
    x, dt, A, B, C, dy, dh = [a.astype(np.float64) for a in arrays]

    def functional(x, dt, A, B, C):
        y, h = jax_ssd(x, dt, A, B, C, chunk)
        return (y * dy).sum() + (h * dh).sum()

    with _x64():
        jg = jax.jit(jax.grad(functional, argnums=(0, 1, 2, 3, 4)))(
            *[jnp.asarray(a) for a in (x, dt, A, B, C)])
        jg = [np.asarray(g) for g in jg]
    assert all(g.dtype == np.float64 and np.isfinite(g).all() for g in jg)
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, dt, A, B, C)]
    y, h = tssm.ssd_chunked(*ts, chunk)
    ((y * torch.from_numpy(dy)).sum() + (h * torch.from_numpy(dh)).sum()
     ).backward()
    got = ssd_scan.ssd_scan_backward_plain(
        *[torch.from_numpy(a) for a in (x, dt, A, B, C, dy, dh)], chunk)
    for name, g, j, t in zip(GRADS, got, jg, ts):
        assert g.dtype == torch.float64
        assert _rel(g, j) <= 1e-9, (name, _rel(g, j))
        assert _rel(g, t.grad) <= 1e-9, (name, _rel(g, t.grad))


def test_plain_backward_without_dhfin_and_in_fp32():
    """dhfin None is a zero gradient of the final state; the plain version
    in fp32 stays within the bar of its float64 self."""
    arrays = _inputs(1, 128, 4, 8, 2, 6, -1.0, seed=4)
    t32 = [torch.from_numpy(a) for a in arrays]
    t64 = [t.double() for t in t32]
    none = ssd_scan.ssd_scan_backward_plain(*t64[:6], None, 32)
    zero = ssd_scan.ssd_scan_backward_plain(
        *t64[:6], torch.zeros_like(t64[6]), 32)
    assert all(torch.equal(a, b) for a, b in zip(none, zero))
    exp = ssd_scan.ssd_scan_backward_plain(*t64, 32)
    got = ssd_scan.ssd_scan_backward_plain(*t32, 32)
    assert all(g.dtype == torch.float32 for g in got)
    assert _chip_smoke()._ssd_bwd_ratio(got, exp) <= 0.05


# -- the kernels' dataflow ----------------------------------------------------


def emulate_bwd(x, dt, A, B, C, dy, dhfin, chunk, mode="split", wrong=None,
                sms=132):
    """The recomputation (forward kernels 1-3) and the six kernels of
    ``csrc/ssd_scan_bwd.cu`` on fp32 inputs, each product through
    ``_mm(mode)``: cum written once (the dstates kernel's scratch) and read
    by dx and dB/dC; dB/dC by slices of each group's heads
    (``ssd_scan.bwd_slices`` on ``sms`` SMs), L ⊙ D formed once a head and
    summed over the slice into S in head order, W's sums off the diagonal
    from the same tile, the carried-state terms summed in head order, then
    S @ B and S^T @ C once a slice and the slices' partials summed in slice
    order.  ``wrong`` names a known-wrong variant: "intra" (dcum without
    W's row and column sums), "group" (dB and dC of a group's first head
    alone), "decay" (the reverse state pass without exp(tot)), "dhfin"
    (the final state's gradient ignored), "slice" (the last slice's partial
    of dB and dC dropped)."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    nc, rep, l = S // chunk, H // G, chunk
    heads = lambda t: t.reshape(b, nc, l, *t.shape[2:]).transpose(2, 3)
    cum = torch.cumsum(heads(dt * -A), -1)                  # [b,nc,H,l]
    tot = cum[..., -1]
    dth = heads(dt)
    xh, dyh = heads(x), heads(dy)                          # [b,nc,H,l,P]
    Bg, Cg = heads(B), heads(C)                            # [b,nc,G,l,N]
    Bh, Ch = Bg.repeat_interleave(rep, 2), Cg.repeat_interleave(rep, 2)
    w = torch.exp(tot[..., None] - cum)                    # exp(tot - cum)
    ecum = torch.exp(cum)
    # recomputation: the chunk states, their pass, C B^T
    states = _mm((xh * dth[..., None]).transpose(-1, -2), w[..., None] * Bh,
                 mode)
    h = torch.zeros((b, H, P, N))
    hp = []
    for c in range(nc):
        hp.append(h)
        h = h * torch.exp(tot[:, c])[..., None, None] + states[:, c]
    hp = torch.stack(hp, 1)                                # [b,nc,H,P,N]
    after = torch.cat([hp[:, 1:], h[:, None]], 1)
    K = _mm(Cg, Bg.transpose(-1, -2), mode).repeat_interleave(rep, 2)
    # 1. dstates, 2. the reverse state pass with its sums of g ⊙ after
    pull = _mm(dyh.transpose(-1, -2), ecum[..., None] * Ch, mode)
    run = torch.zeros_like(h) if dhfin is None or wrong == "dhfin" else dhfin
    g, last = [None] * nc, [None] * nc
    for c in reversed(range(nc)):
        g[c] = run
        last[c] = (run * after[:, c]).sum((-1, -2))
        decay = 1.0 if wrong == "decay" else \
            torch.exp(tot[:, c])[..., None, None]
        run = run * decay + pull[:, c]
    g, last = torch.stack(g, 1), torch.stack(last, 1)      # last [b,nc,H]
    keep = torch.tril(torch.ones((l, l), dtype=torch.bool))
    L = torch.where(keep, torch.exp(cum[..., :, None] - cum[..., None, :]),
                    0.0)
    # 3. dx: intra + inter, s = x . dxd, the carried-state terms q
    inter = _mm(w[..., None] * Bh, g.transpose(-1, -2), mode)
    dxd = _mm((K * L).transpose(-1, -2), dyh, mode) + inter
    yint = _mm(ecum[..., None] * Ch, hp.transpose(-1, -2), mode)
    s = (xh * dxd).sum(-1)
    q = (dyh * yint).sum(-1) - dth * (xh * inter).sum(-1)
    # 4. dB, dC: L ⊙ D once a head, W's sums off the diagonal from it
    LD = L * (_mm(dyh, xh.transpose(-1, -2), mode) * dth[..., None, :])
    off = torch.tril(torch.ones((l, l), dtype=torch.bool), -1)
    W = torch.where(off, K * LD, 0.0)
    wrow, wcol = W.sum(-1), W.sum(-2)
    carC = _mm(ecum[..., None] * dyh, hp, mode)            # [b,nc,H,l,N]
    carB = _mm((w * dth)[..., None] * xh, g, mode)
    nsl = ssd_scan.bwd_slices(b, S, H, G, N, chunk, sms)
    parts = []
    for sl in range(nsl):
        Ss = torch.zeros((b, nc, G, l, l))
        cB, cC = torch.zeros((b, nc, G, l, N)), torch.zeros((b, nc, G, l, N))
        for grp in range(G):
            lo = grp * rep + sl * rep // nsl
            hi = grp * rep + (sl + 1) * rep // nsl
            if wrong == "group":
                lo, hi = (grp * rep, grp * rep + 1) if sl == 0 else (0, 0)
            for hh in range(lo, hi):
                Ss[:, :, grp] += LD[:, :, hh]
                cB[:, :, grp] += carB[:, :, hh]
                cC[:, :, grp] += carC[:, :, hh]
        parts.append((cB + _mm(Ss.transpose(-1, -2), Cg, mode),
                      cC + _mm(Ss, Bg, mode)))
    if wrong == "slice":
        parts = parts[:-1]
    dBg, dCg = parts[0]
    for pB, pC in parts[1:]:
        dBg, dCg = dBg + pB, dCg + pC
    group = lambda t: t.transpose(2, 3).reshape(b, S, G, N)

    # 5. finish: dcum, da, ddt, dA
    dcum = q if wrong == "intra" else (wrow - wcol) + q
    dcum = torch.cat([dcum[..., :-1], dcum[..., -1:] + last[..., None]], -1)
    da = dcum.flip(-1).cumsum(-1).flip(-1)
    ddt = s - A[:, None] * da
    dA = -(dth * da).sum((0, 1, 3))
    back = lambda t: t.transpose(2, 3).reshape(b, S, H, *t.shape[4:])
    return back(dth[..., None] * dxd), back(ddt), dA, group(dBg), \
        group(dCg)


def _score(arrays, chunk, mode="split", wrong=None):
    t32 = [torch.from_numpy(a) for a in arrays]
    exp = ssd_scan.ssd_scan_backward_plain(*[t.double() for t in t32], chunk)
    got = emulate_bwd(*t32, chunk, mode, wrong)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    return _chip_smoke()._ssd_bwd_ratio(got, exp)


@pytest.mark.parametrize("shape,shift", [
    ((1, 512, 4, 64, 1, 64, 128), -4.0),     # chip_smoke's distribution
    ((1, 512, 4, 64, 1, 64, 128), 2.0),      # large dt
    ((2, 128, 4, 16, 2, 7, 32), 0.0),        # G = 2, N = 7
])
def test_emulated_kernels_hold_the_bar(shape, shift):
    *dims, chunk = shape
    assert _score(_inputs(*dims, shift), chunk) <= 0.5


def test_emulated_fp32_products_hold_the_bar():
    """The dataflow itself, with fp32 products: the same function as the
    plain backward."""
    assert _score(_inputs(1, 256, 4, 32, 1, 32, -1.0, seed=2), 64,
                  "fp32") <= 0.1


def test_one_tf32_pass_breaks_the_bar():
    """One TF32 pass (10 mantissa bits of each operand) fails the bar that
    the split holds, on chip_smoke's inputs."""
    assert _score(_inputs(1, 512, 4, 64, 1, 64, -4.0), 128,
                  "tf32") > 1.0


@pytest.mark.parametrize("wrong", ["intra", "group", "decay", "dhfin",
                                   "slice"])
def test_known_wrong_variants_fail_the_bar_tenfold(wrong):
    """Each variant on inputs where it matters: several heads to a group
    (four slices of one head), several chunks with decays well below 1, a
    nonzero dhfin."""
    arrays = _inputs(1, 512, 4, 32, 1, 32, -4.0, seed=5)
    assert _score(arrays, 128, wrong=wrong) >= 10.0


# -- SsdScanFn's wiring, the plan ---------------------------------------------


def test_ssd_scan_fn_routes_through_the_backward(monkeypatch):
    """``SsdScanFn`` with its launches replaced by the plain versions, on
    CPU tensors: autograd's gradients of ssd_chunked, with and without the
    final state in the loss (dhfin None then), and one backward call a
    backward pass."""
    calls = []

    def backward(*args):
        calls.append(args[6])
        return ssd_scan.ssd_scan_backward_plain(*args)

    monkeypatch.setattr(ssd_scan, "_forward", lambda counts, *a: (
        *tssm.ssd_chunked(*a), None, None, None))
    monkeypatch.setattr(ssd_scan, "ssd_scan_backward", backward)
    arrays = [a.astype(np.float64) for a in _inputs(2, 64, 4, 8, 2, 5, 0.0,
                                                    seed=6)]
    dy, dh = (torch.from_numpy(a) for a in arrays[5:])
    for use_h in (True, False):
        ts = [torch.from_numpy(a).requires_grad_() for a in arrays[:5]]
        ref = [torch.from_numpy(a).requires_grad_() for a in arrays[:5]]
        y, h = ssd_scan.SsdScanFn.apply(*ts, 16)
        yr, hr = tssm.ssd_chunked(*ref, 16)
        loss = (y * dy).sum() + ((h * dh).sum() if use_h else 0.0)
        lref = (yr * dy).sum() + ((hr * dh).sum() if use_h else 0.0)
        loss.backward()
        lref.backward()
        for t, r in zip(ts, ref):
            assert _rel(t.grad, r.grad) <= 1e-12
        assert (calls[-1] is None) == (not use_h)
    assert len(calls) == 2


def test_ssd_scan_backward_refuses_cpu_tensors():
    arrays = [torch.from_numpy(a) for a in _inputs(1, 32, 2, 16, 1, 4,
                                                   0.0)]
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan.ssd_scan_backward(*arrays, 32)


@pytest.mark.parametrize("chunk", [1, 30, 64, 90, 128])
@pytest.mark.parametrize("N", [1, 7, 64, 127, 128])
def test_every_backward_block_fits_the_card(chunk, N):
    for kernel in ssd_scan.BWD_KERNELS:
        assert 0 < ssd_scan.bwd_smem_bytes(kernel, chunk, N) \
            <= SMEM_BLOCK_MAX, kernel


def test_backward_shared_memory_at_the_training_shapes():
    """chunk 128, N = 64 (zamba2) and 128 (mamba2): three dstates blocks
    an SM; two dx blocks an SM at N = 64, one at N = 128 (K's columns and
    B's and C's 64 rows of 128 columns, with half a head's dy rows and one
    of g and h_prev, pass half the SM; the source's header says why it is
    not split); one dB/dC block an SM (a cluster of two at N = 128); each
    within the SM's memory with the runtime's reserve; the dB/dC block's
    final copies of C (over x) and B (over dy) fit the space they reuse."""
    for N in (64, 128):
        per = {k: ssd_scan.bwd_smem_bytes(k, 128, N) + SMEM_RESERVED
               for k in ssd_scan.BWD_KERNELS}
        assert 3 * per["dstates"] <= SMEM_SM
        assert per["dx"] <= SMEM_SM
        assert (2 * per["dx"] <= SMEM_SM) == (N == 64)
        assert per["dbc"] <= SMEM_SM < 2 * per["dbc"]
        assert ssd_scan.dbc_ranks(N) == (1 if N == 64 else 2)
        ldh = -(-ssd_scan.dbc_rank_cols(N) // 32) * 32 + 4
        assert 2 * ldh % 32 == 8      # rows 2q, 2q + 1 in distinct banks
        assert 128 * ldh <= 128 * (ssd_scan.BWD_MAX_P + 8)     # C over x,
        # B over dy
    assert ssd_scan.bwd_smem_bytes("dbc", 128, 128) == 211968
    assert ssd_scan.bwd_smem_bytes("dbc", 128, 64) == 230400
    assert ssd_scan.bwd_smem_bytes("dx", 128, 128) == 162304
    assert ssd_scan.bwd_smem_bytes("dx", 128, 64) == 113152


@pytest.mark.parametrize("b,S,H,G,N,chunk,want", [
    (2, 4096, 64, 1, 64, 128, 2),    # zamba2-1.2b's call: 128 blocks
    (2, 4096, 64, 1, 128, 128, 2),   # mamba2-1.3b's: 128 clusters of two
    (2, 192, 24, 2, 24, 64, 6),      # 12 heads a group: 6 slices of two
    (2, 2048, 12, 1, 128, 64, 2),    # 12 heads a group, 64 clusters a slice
    (1, 256, 8, 8, 16, 64, 1),       # G = H: one head a group, one slice
    (2, 1800, 7, 1, 128, 90, 3),     # 7 heads in slices of 2, 2 and 3
])
def test_dbc_slice_plan(b, S, H, G, N, chunk, want):
    """The slice count fills the card: the fewest waves of blocks (one an
    SM, dbc_ranks(N) a cluster) times the longest slice's heads plus one,
    from 2 (1 at G = H) to H / G; on 114 SMs as on 132 it stays within those
    bounds, and the slices deal each group's heads in order, every head
    once, their sizes within one of each other."""
    nsl = ssd_scan.bwd_slices(b, S, H, G, N, chunk, 132)
    assert nsl == want
    rep = H // G
    units = ssd_scan.dbc_ranks(N) * G * (S // chunk) * b
    cost = lambda s: -(-(units * s) // 132) * (-(-rep // s) + 1)
    assert all(cost(nsl) <= cost(s) for s in range(min(2, rep), rep + 1))
    assert all(cost(nsl) < cost(s) for s in range(min(2, rep), nsl))
    for sms in (132, 114):
        n = ssd_scan.bwd_slices(b, S, H, G, N, chunk, sms)
        assert min(2, rep) <= n <= rep
        sizes = [(k + 1) * rep // n - k * rep // n for k in range(n)]
        assert sum(sizes) == rep and max(sizes) - min(sizes) <= 1
        assert min(sizes) >= 1 and (rep == 1 or max(sizes) < rep)


@pytest.mark.parametrize("b,S,H,P,G,N,chunk", [
    (2, 4096, 64, 64, 1, 64, 128),   # zamba2-1.2b's training call
    (2, 4096, 64, 64, 1, 128, 128),  # mamba2-1.3b's
    (1, 90, 6, 16, 3, 7, 30),        # a ragged chunk, G = 3, N = 7
    (2, 192, 24, 48, 2, 24, 64),     # 12 heads a group: dx walks 4
    (2, 1800, 7, 32, 1, 128, 90),    # 7 heads in 3 slices, N = 128
    (2, 4096, 32, 64, 1, 64, 128),   # zamba2's call on a rank of model = 2
    (2, 4096, 16, 64, 1, 128, 128),  # mamba2's on a rank of model = 4
])
def test_backward_grids_cover_every_row_once(b, S, H, P, G, N, chunk):
    """The dx blocks (heads_per_block heads, 64 rows j, chunk, batch) reach
    every (batch, head, position) once; the dB / dC clusters (rank, slice,
    group; chunk; batch) reach every (batch, group, position, column n)
    once through a rank's columns and every (batch, head, chunk) once
    through the slices; D's 16 x 8 tiles j <= i are dealt to the ranks'
    warps once, at most three a warp of two ranks, five of one; the state
    pass's threads every four
    entries of a (batch, head) once, in at most bwd_state_warps warps."""
    nsl = ssd_scan.bwd_slices(b, S, H, G, N, chunk, 132)
    grids = ssd_scan.bwd_grids(b, S, H, P, G, N, chunk, nsl)
    ranks = ssd_scan.dbc_ranks(N)
    nc, LP = S // chunk, -(-chunk // 16) * 16
    nrb, hpb = -(-LP // 64), ssd_scan.heads_per_block(H, G)
    rep = H // G
    assert rep % hpb == 0
    seen = np.zeros((b, H, S), np.int64)
    gx, gy, gz = grids["dx"]
    for x in range(gx):
        for y in range(gy):
            c, j0 = y // nrb, (y % nrb) * 64
            for h in range(x * hpb, (x + 1) * hpb):
                assert h // rep == x * hpb // rep   # one group
                rows = np.arange(j0, min(j0 + 64, chunk))
                seen[:gz, h, c * chunk + rows] += 1
    assert (seen == 1).all()
    gx, gy, gz = grids["dbc"]
    assert gx % ranks == 0 and (gy, gz) == (nc, b)
    NH = ssd_scan.dbc_rank_cols(N)
    cols = np.zeros((b, G, S, N), np.int64)
    slices = np.zeros((b, H, nc), np.int64)
    for x in range(gx):
        rank, sl, grp = x % ranks, (x // ranks) % nsl, (x // ranks) // nsl
        n = np.arange(rank * NH, min(N, (rank + 1) * NH))
        h0, h1 = grp * rep + sl * rep // nsl, grp * rep + (sl + 1) * rep // nsl
        for c in range(gy):
            rows = c * chunk + np.arange(chunk)
            cols[:, grp, rows[:, None], n[None, :]] += 1
            if rank == 0:
                slices[:, h0:h1, c] += 1
    assert (cols == nsl).all() and (slices == 1).all()
    nb = LP // 16
    T = nb * (nb + 1)
    dealt = np.zeros((LP, LP), np.int64)
    for rank in range(ranks):
        lo, Tr = ((0, T) if ranks == 1 else (0, T // 2) if rank == 0
                  else (T // 2, T - T // 2))
        for w in range(16):
            units = range(lo + w * Tr // 16, lo + (w + 1) * Tr // 16)
            assert len(units) <= (5 if ranks == 1 else 3)
            for u in units:
                r = int((np.sqrt(4 * u + 1) - 1) // 2)
                while (r + 1) * (r + 2) <= u:
                    r += 1
                c8 = u - r * (r + 1)
                assert 0 <= c8 <= 2 * r + 1
                dealt[16 * r:16 * r + 16, 8 * c8:8 * c8 + 8] += 1
    i, j = np.indices((LP, LP))
    assert (dealt[j <= i] == 1).all() and (dealt[j >= i + 16] == 0).all()
    gx, gy, _ = grids["state_pass"]
    chains = np.arange(gx * 256)
    live = chains[chains < P * N // 4]
    assert len(live) == P * N // 4 and gy == b * H
    assert len(np.unique(live // 32)) <= ssd_scan.bwd_state_warps(P, N)
    assert grids["finish"][0] * 256 >= b * H * nc * 32
    assert grids["sums"][0] * 256 >= max(b * S * G * N, H)
    assert grids["dstates"] == (H, nc, b)


# -- whole-model gradients -----------------------------------------------------


def _pair(arch):
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jp = JT.init_model(jax.random.PRNGKey(0), jcfg)
    tp = convert.lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                      cfg, "cpu", trainable=True)
    return jcfg, cfg, jp, tp


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b"])
def test_ssm_loss_fn_gradients_match_jax_value_and_grad(arch):
    """``loss_fn`` of the reduced ssm and hybrid configs (S = 64, two of
    the reduced chunks of 32) and every parameter's gradient against
    ``jax.value_and_grad`` of the reference's ``loss_fn``."""
    jcfg, cfg, jp, tp = _pair(arch)
    assert 64 % cfg.ssm.chunk == 0 and 64 // cfg.ssm.chunk == 2
    g = np.random.default_rng(7)
    toks = g.integers(0, cfg.vocab, (2, 64)).astype(np.int32)
    labs = g.integers(0, cfg.vocab, (2, 64)).astype(np.int32)
    jb = JS.TrainBatch(jnp.asarray(toks), jnp.asarray(labs), None)
    tb = TS.TrainBatch(torch.from_numpy(toks), torch.from_numpy(labs))
    (jt, (jl, _)), jg = jax.jit(jax.value_and_grad(JS.loss_fn, has_aux=True),
                                static_argnums=(2, 3))(
        jp, jb, jcfg, JT.NO_SHARD)
    (tt, (tl, _)), tg = TS.grads_of(tp, tb, cfg)
    np.testing.assert_allclose(float(tl), float(jl), atol=2e-3)
    np.testing.assert_allclose(float(tt), float(jt), atol=2e-3)
    ref = dict(convert.lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jg), cfg, "cpu").named_parameters())
    assert set(ref) == set(tg)
    mamba = [k for k in ref if ".mamba." in k]
    assert any(k.endswith("A_log") for k in mamba)
    for k, e in ref.items():
        rel = float((tg[k] - e).norm() / e.norm().clamp_min(1e-30))
        assert rel <= GRAD_REL, (k, rel)
