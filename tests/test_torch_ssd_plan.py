"""The SSD kernels' split and their split-TF32 products, checked on the CPU.

``csrc/ssd_scan.cu`` runs the Mamba2 SSD scan as the chunk-parallel split
of ``repro_torch.nn.ssm.ssd_chunked``: chunk states (x dt)^T @ (exp(cum_l -
cum) ⊙ B), C B^T once per group, an elementwise pass of the state across
chunks, and the outputs [C B^T ⊙ exp(cum_i - cum_j)[j <= i] | exp(cum) ⊙ C]
@ [x dt ; h_prev^T].  Its products run on the tensor cores in TF32 (the
top 19 bits of an fp32 operand: sign, exponent, 10 mantissa bits) as a
split: a = a_hi + a_lo with a_hi = a cut to TF32 and a_lo = a - a_hi
(exact in fp32, read by the tensor cores as its top 19 bits), summing
a_lo b_hi + a_hi b_lo + a_hi b_hi in fp32.

Here that arithmetic is emulated in plain torch: TF32 is fp32 with the
low 13 bits cleared, the products of TF32 operands are exact in fp32 and
sum in fp32 (in another order than the tensor cores: the emulation sums
the three split products per matrix, the kernel per k step; and the
kernel takes the decay of most pairs as a product of a row and a column
factor where the emulation takes one exp).  It is
scored with chip_smoke.py's SSD bar against ``ssd_chunked`` in fp64:
|d| <= 2e-4 (|exp| + max |exp|) on y and the final state.  At b = 1,
S = 1024, H = 4, P = N = 64, chunk 128, with chip_smoke's inputs (dt =
softplus(randn - 4), A = exp(linspace(0, 2.77, H))), the split gives a
ratio of 0.0026 (fp32 products: 0.0022) and must stay <= 0.5; one TF32
pass gives 4.79 and breaks the bar.  With a large dt (softplus(randn + 2),
where a chunk's decay passes e^-88): split 0.0120 (fp32 0.0128), one TF32
pass 4.35.
The split keeps about 20 bits of each product and costs three MMAs for
one.

The shared-memory plan of ``kernels/ssd_scan.py`` (checked against the
library when it loads on a card) is held to the card's limits here.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import _torch_parity  # noqa: E402,F401  (one torch thread per worker)
from repro.nn.ssm import ssd_chunked as jax_ssd  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402
from repro_torch.nn import ssm as tssm  # noqa: E402

SMEM_BLOCK_MAX = 232448          # bytes a block may use on an H100
SMEM_SM = 233472                 # bytes of shared memory an SM can hand out
SMEM_RESERVED = 1024             # bytes the runtime keeps per block


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tf32(t):
    """The TF32 that the tensor cores read of fp32 ``t``: its low 13 bits
    cleared."""
    return (t.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm(a, b, mode):
    """a @ b (batched) as the kernel forms it: "fp32", "tf32" (one pass)
    or "split" (a_lo b_hi + a_hi b_lo + a_hi b_hi)."""
    if mode == "fp32":
        return a @ b
    ah, bh = _tf32(a), _tf32(b)
    if mode == "tf32":
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def emulate(x, dt, A, B, C, chunk, mode):
    """The four kernels of ``csrc/ssd_scan.cu`` on fp32 inputs."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    nc, rep = S // chunk, H // G
    xd = (x * dt[..., None]).reshape(b, nc, chunk, H, P)
    cum = torch.cumsum((dt * -A).reshape(b, nc, chunk, H), 2)
    tot = cum[:, :, -1]                                       # [b, nc, H]
    Bc = B.reshape(b, nc, chunk, G, N)
    Cc = C.reshape(b, nc, chunk, G, N)
    # 1. chunk states: (x dt)^T @ (exp(cum_l - cum) ⊙ B) per (b, c, h)
    wdec = torch.exp(tot[:, :, None] - cum)                   # [b,nc,l,H]
    Bd = wdec[..., None] * Bc.repeat_interleave(rep, 3)       # [b,nc,l,H,N]
    xdh = xd.permute(0, 1, 3, 2, 4)                           # [b,nc,H,l,P]
    states = _mm(xdh.transpose(-1, -2), Bd.permute(0, 1, 3, 2, 4), mode)
    # 2. C B^T per (b, c, group)
    Cg, Bg = Cc.permute(0, 1, 3, 2, 4), Bc.permute(0, 1, 3, 2, 4)
    cb = _mm(Cg, Bg.transpose(-1, -2), mode)                  # [b,nc,G,l,l]
    # 3. the state before each chunk; the last one is h_final
    h = torch.zeros((b, H, P, N))
    prev = []
    for c in range(nc):
        prev.append(h)
        h = h * torch.exp(tot[:, c])[..., None, None] + states[:, c]
    hprev = torch.stack(prev, 1)                              # [b,nc,H,P,N]
    # 4. y = [cb ⊙ decay ⊙ dt_j | exp(cum) ⊙ C] @ [x ; h_prev^T]: the
    # kernel folds dt and the decay into the A operand
    ch = cum.permute(0, 1, 3, 2)                              # [b,nc,H,l]
    dth = dt.reshape(b, nc, chunk, H).permute(0, 1, 3, 2)     # [b,nc,H,l]
    keep = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    M = torch.where(keep, cb.repeat_interleave(rep, 2)
                    * torch.exp(ch[..., :, None] - ch[..., None, :])
                    * dth[..., None, :], 0.0)
    EC = torch.exp(ch)[..., None] * Cg.repeat_interleave(rep, 2)
    xh = x.reshape(b, nc, chunk, H, P).permute(0, 1, 3, 2, 4)
    y = _mm(M, xh, mode) + _mm(EC, hprev.transpose(-1, -2), mode)
    return y.permute(0, 1, 3, 2, 4).reshape(b, S, H, P), h


def _smoke_inputs(b, S, H, P, N, dt_shift, seed=0):
    """chip_smoke's SSD inputs: x, B, C standard normal, dt =
    softplus(randn + dt_shift), A = exp(linspace(0, 2.77, H)), G = 1."""
    g = np.random.default_rng(seed)
    x = g.standard_normal((b, S, H, P), dtype=np.float32)
    dt = np.logaddexp(0.0, g.standard_normal((b, S, H)) + dt_shift)
    A = np.exp(np.linspace(0.0, 2.77, H))
    B = g.standard_normal((b, S, 1, N), dtype=np.float32)
    C = g.standard_normal((b, S, 1, N), dtype=np.float32)
    return [np.asarray(a, np.float32) for a in (x, dt, A, B, C)]


def _ratio(arrays, chunk, mode):
    t32 = [torch.from_numpy(a) for a in arrays]
    exp = tssm.ssd_chunked(*[t.double() for t in t32], chunk)
    got = emulate(*t32, chunk, mode)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    return _chip_smoke()._ssd_ratio(got, exp)


@pytest.mark.parametrize("dt_shift", [-4.0, 2.0])
def test_split_tf32_holds_the_ssd_bar(dt_shift):
    """chip_smoke's distribution (dt_shift -4) and a large dt (+2), where a
    chunk's decay passes e^-88: the split at <= 0.5 of the bar."""
    arrays = _smoke_inputs(1, 1024, 4, 64, 64, dt_shift)
    assert _ratio(arrays, 128, "split") <= 0.5


@pytest.mark.parametrize("dt_shift", [-4.0, 2.0])
def test_one_tf32_pass_breaks_the_ssd_bar(dt_shift):
    """One TF32 pass (10 mantissa bits of each operand) fails the bar that
    the split holds, on the same inputs."""
    arrays = _smoke_inputs(1, 1024, 4, 64, 64, dt_shift)
    assert _ratio(arrays, 128, "tf32") > 1.0


def test_emulated_fp32_matches_the_plain_version():
    """The split itself, in fp32: the same function as ``ssd_chunked``."""
    arrays = _smoke_inputs(1, 1024, 4, 64, 64, -4.0, seed=3)
    assert _ratio(arrays, 128, "fp32") <= 0.05


@pytest.mark.parametrize("b,S,H,P,G,N,chunk", [
    (1, 512, 4, 64, 1, 64, 128),     # zamba2's P, N and chunk
    (1, 256, 4, 32, 2, 32, 64),      # G = 2: head h reads group h // 2
    (2, 90, 6, 16, 3, 24, 30),       # a ragged chunk, G = 3
])
def test_emulated_split_matches_the_jax_oracle(b, S, H, P, G, N, chunk):
    """The emulated kernel against ``repro.nn.ssm.ssd_chunked`` within
    rtol 2e-4 plus 2e-4 max(1, max |ref|), the bar of
    tests/test_torch_lm_kernels.py."""
    g = np.random.default_rng(b * S + G)
    x = g.standard_normal((b, S, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(g.standard_normal((b, S, H)))).astype(np.float32)
    A = np.exp(0.3 * g.standard_normal(H)).astype(np.float32)
    B = g.standard_normal((b, S, G, N), dtype=np.float32)
    C = g.standard_normal((b, S, G, N), dtype=np.float32)
    arrays = (x, dt, A, B, C)
    jy, jh = jax_ssd(*[jnp.asarray(a) for a in arrays], chunk)
    ty, th = emulate(*[torch.from_numpy(a) for a in arrays], chunk, "split")
    for got, exp in ((ty, jy), (th, jh)):
        exp = np.asarray(exp)
        scale = max(1.0, float(np.abs(exp).max()))
        np.testing.assert_allclose(got.numpy(), exp, rtol=2e-4,
                                   atol=2e-4 * scale)


def test_shared_memory_per_sm_at_the_prefill_shape():
    """At zamba2's chunk 128 and N = 64 three chunk-state blocks fit one
    SM, and one output block holds C B^T, C and a stage of dt, x and
    h_prev for each of its two teams (so one team's loads overlap the
    other's products)."""
    per = {k: ssd_scan.smem_bytes(k, 128, 64) + SMEM_RESERVED
           for k in ssd_scan.KERNELS}
    assert 3 * per["states"] <= SMEM_SM
    assert per["out"] <= SMEM_SM < 2 * per["out"]


@pytest.mark.parametrize("chunk", [1, 30, 90, 128])
@pytest.mark.parametrize("N", [1, 24, 127, 128])
def test_every_block_fits_the_card_up_to_the_limits(chunk, N):
    for kernel in ssd_scan.KERNELS:
        assert 0 < ssd_scan.smem_bytes(kernel, chunk, N) <= SMEM_BLOCK_MAX


def test_scratch_at_the_prefill_shape():
    """The states buffer is 134 MB (half of x's 268 MB: a chunk of 128
    steps folds into a 64 x 64 state) and C B^T 8.4 MB at [2, 8192, 64, 64],
    G = 1, N = 64, chunk 128 (64 chunks)."""
    states, cb, dec = ssd_scan.scratch_shapes(2, 8192, 64, 64, 1, 64, 128)
    assert (states, cb, dec) == ((2, 64, 64, 64, 64), (2, 64, 1, 128, 128),
                                 (2, 64, 64))
    assert 4 * np.prod(states) == 134217728
    assert 4 * np.prod(cb) == 8388608
