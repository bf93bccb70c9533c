"""Plain PyTorch reference of the benchmark's language models.

Three families, as a configuration file states them (``arch``):

* ``dense``  (granite-3-2b): embedding, ``n`` blocks of RMSNorm -> GQA
  attention with RoPE -> RMSNorm -> gated MLP, final RMSNorm, head;
* ``ssm``: embedding, ``n`` blocks of RMSNorm -> Mamba2 (SSD,
  arXiv:2405.21060), final RMSNorm, head;
* ``hybrid``: ``ssm``'s stack with one weight-shared attention + MLP
  block (the dense block) after every ``hybrid_attn_every`` Mamba2
  blocks, the port's zamba2-style layout.

The precision is the configuration's: float32 weights; every product
takes bfloat16 operands and accumulates in float32 (rounded to bfloat16);
the residual stream is bfloat16; norms, RoPE, softmax, the Mamba2
convolution, gate and scan, and the loss run in float32 (TF32 off).  With
``prec="fp8"`` every product's operands are first rounded to float8 e4m3
with a per-tensor scale: the control, one precision step below.

Attention is computed in blocks of query rows over the keys they may see,
and the scan in chunks, so that full-size sequences fit; the math is the
plain one.  Weights are a dict of named float32 tensors
(``bench.weights``); names follow the layout there.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Tensor = torch.Tensor
Weights = Dict[str, Tensor]
BF = torch.bfloat16
Q_BLOCK = 512
FP8_MAX = 448.0


@dataclasses.dataclass(frozen=True)
class Dims:
    arch: str
    d: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    ff: int
    vocab: int
    act: str
    tied: bool
    rope_theta: float
    eps: float
    window: Optional[int]
    ssm: Optional[dict]
    attn_every: int

    @staticmethod
    def of(cfg: dict) -> "Dims":
        return Dims(arch=cfg["arch"], d=cfg["hidden_size"],
                    layers=cfg["num_hidden_layers"],
                    heads=cfg["num_attention_heads"],
                    kv_heads=cfg["num_key_value_heads"],
                    head_dim=cfg["head_dim"], ff=cfg["intermediate_size"],
                    vocab=cfg["vocab_size"], act=cfg["hidden_act"],
                    tied=cfg["tie_word_embeddings"],
                    rope_theta=cfg["rope_theta"], eps=cfg["rms_norm_eps"],
                    window=cfg.get("sliding_window"), ssm=cfg.get("ssm"),
                    attn_every=cfg.get("hybrid_attn_every", 0))


@contextlib.contextmanager
def fp32_exact():
    """TF32 off for the reference's float32 products, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _fp8(t: Tensor) -> Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale (amax to 448),
    back in bfloat16; the gradient passes straight through."""
    t32 = t.float()
    scale = FP8_MAX / t32.detach().abs().amax().clamp(min=1e-30)
    q = ((t32 * scale).to(torch.float8_e4m3fn).float() / scale).to(BF)
    return t.to(BF) + (q - t.to(BF)).detach()


def mm(a: Tensor, b: Tensor, prec: str) -> Tensor:
    """a @ b with bfloat16 operands (float8-rounded under ``"fp8"``),
    float32 accumulation, a bfloat16 result."""
    if prec == "fp8":
        return _fp8(a) @ _fp8(b)
    return a.to(BF) @ b.to(BF)


def rmsnorm(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    xf = x.float()
    out = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (out * scale.float()).to(x.dtype)


def rope(x: Tensor, theta: float) -> Tensor:
    """x [B, S, H, D]: the two halves of D rotated by position."""
    D, S = x.shape[-1], x.shape[1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, device=x.device,
                                       dtype=torch.float32) / D)
    ang = torch.arange(S, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     -1).to(x.dtype)


def attention(q: Tensor, k: Tensor, v: Tensor, window: Optional[int]
              ) -> Tensor:
    """Causal softmax attention in float32, q head h reading kv head
    h mod Hkv, within ``window`` positions; q [B, S, H, D], k/v [B, S, Hkv,
    D] -> [B, S, H, D] in q's dtype."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    qg = q.float().reshape(B, S, H // Hkv, Hkv, D)
    scale = 1.0 / math.sqrt(D)
    pos = torch.arange(S, device=q.device)
    outs = []
    for s0 in range(0, S, Q_BLOCK):
        s1 = min(S, s0 + Q_BLOCK)
        k0 = max(0, s0 - window + 1) if window else 0
        kb, vb = k[:, k0:s1].float(), v[:, k0:s1].float()
        logits = torch.einsum("bqgjd,bkjd->bgjqk", qg[:, s0:s1], kb) * scale
        qp, kp = pos[s0:s1, None], pos[None, k0:s1]
        ok = kp <= qp
        if window:
            ok = ok & (kp > qp - window)
        logits = logits.masked_fill(~ok, float("-inf"))
        p = torch.softmax(logits, dim=-1)
        outs.append(torch.einsum("bgjqk,bkjd->bqgjd", p, vb))
    return torch.cat(outs, 1).reshape(B, S, H, D).to(q.dtype)


def _act(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu_tanh":
        return lambda t: F.gelu(t, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


def dense_block(w: Weights, p: str, x: Tensor, c: Dims, prec: str,
                window: Optional[int], act: str) -> Tensor:
    B, S, d = x.shape
    H, Hk, hd = c.heads, c.kv_heads, c.head_dim
    h = rmsnorm(x, w[p + "ln1.scale"], c.eps)
    q = mm(h, w[p + "attn.wq"].reshape(d, H * hd), prec).view(B, S, H, hd)
    k = mm(h, w[p + "attn.wk"].reshape(d, Hk * hd), prec).view(B, S, Hk, hd)
    v = mm(h, w[p + "attn.wv"].reshape(d, Hk * hd), prec).view(B, S, Hk, hd)
    q, k = rope(q, c.rope_theta), rope(k, c.rope_theta)
    o = attention(q, k, v, window)
    x = x + mm(o.reshape(B, S, H * hd), w[p + "attn.wo"].reshape(H * hd, d),
               prec).to(x.dtype)
    h = rmsnorm(x, w[p + "ln2.scale"], c.eps)
    g = _act(act)(mm(h, w[p + "mlp.w_gate"], prec))
    u = mm(h, w[p + "mlp.w_up"], prec)
    return x + mm(g * u, w[p + "mlp.w_down"], prec).to(x.dtype)


def causal_conv(x: Tensor, wt: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal convolution over time, then SiLU; x [B, S, C]
    float32, wt [W, C]."""
    W, S = wt.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = b.float()[None, None, :]
    for i in range(W):
        out = out + xp[:, i:i + S] * wt[i].float()[None, None, :]
    return F.silu(out)


def ssd(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor,
        chunk: int) -> Tensor:
    """y of h_t = exp(-dt_t A) h_{t-1} + dt_t B_t x_t^T, y_t = C_t . h_t
    (h_0 = 0), in chunks of ``chunk`` steps.  x [b, S, H, P], dt [b, S, H],
    A [H], B/C [b, S, G, N]; head h reads group h // (H / G)."""
    b, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc, l = S // chunk, chunk
    Bh = Bm.repeat_interleave(H // G, dim=2).reshape(b, nc, l, H, N)
    Ch = Cm.repeat_interleave(H // G, dim=2).reshape(b, nc, l, H, N)
    xd = (x * dt[..., None]).reshape(b, nc, l, H, P)
    acum = torch.cumsum((dt * -A).reshape(b, nc, l, H), dim=2)
    seg = acum[:, :, :, None, :] - acum[:, :, None, :, :]        # i, j
    tril = torch.tril(torch.ones(l, l, dtype=torch.bool, device=x.device))
    decay = torch.exp(seg.masked_fill(~tril[None, None, :, :, None],
                                      float("-inf")))
    cb = torch.einsum("bnihe,bnjhe->bnijh", Ch, Bh)
    y = torch.einsum("bnijh,bnjhp->bnihp", cb * decay, xd)
    to_end = torch.exp(acum[:, :, -1:, :] - acum)
    states = torch.einsum("bnlh,bnlhe,bnlhp->bnhpe", to_end, Bh, xd)
    h = torch.zeros(b, H, P, N, device=x.device, dtype=torch.float32)
    prev = []
    for n in range(nc):
        prev.append(h)
        h = h * torch.exp(acum[:, n, -1])[:, :, None, None] + states[:, n]
    y = y + torch.einsum("bnlh,bnlhe,bnhpe->bnlhp", torch.exp(acum), Ch,
                         torch.stack(prev, 1))
    return y.reshape(b, S, H, P)


def mamba_block(w: Weights, p: str, x: Tensor, c: Dims, prec: str) -> Tensor:
    s = c.ssm
    B_, S, d = x.shape
    d_in = s["expand"] * d
    P, N, G = s["head_dim"], s["state_dim"], s["n_groups"]
    H = d_in // P
    h = rmsnorm(x, w[p + "ln.scale"], c.eps)
    m = p + "mamba."
    z = mm(h, w[m + "w_z"], prec)
    xs = mm(h, w[m + "w_x"], prec)
    bc = torch.cat([mm(h, w[m + "w_B"], prec), mm(h, w[m + "w_C"], prec)], -1)
    dt = mm(h, w[m + "w_dt"], prec)
    xs = causal_conv(xs.float(), w[m + "conv_x"], w[m + "conv_b_x"])
    bc = causal_conv(bc.float(), w[m + "conv_bc"], w[m + "conv_b_bc"])
    Bm, Cm = bc.chunk(2, dim=-1)
    dt = F.softplus(dt.float() + w[m + "dt_bias"].float())
    A = torch.exp(w[m + "A_log"].float())
    xh = xs.reshape(B_, S, H, P)
    y = ssd(xh, dt, A, Bm.reshape(B_, S, G, N), Cm.reshape(B_, S, G, N),
            min(s["chunk"], S))
    y = y + w[m + "D"].float()[None, None, :, None] * xh
    y = y.reshape(B_, S, d_in) * F.silu(z.float())
    y = rmsnorm(y, w[m + "norm_scale"], c.eps)
    return x + mm(y, w[m + "w_out"], prec).to(x.dtype)


def _run(fn, remat: bool, x: Tensor) -> Tensor:
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, x, use_reentrant=False)
    return fn(x)


def hidden(w: Weights, tokens: Tensor, c: Dims, prec: str = "bf16",
           remat: bool = False) -> Tensor:
    """The final RMSNorm's output [B, S, d] (bfloat16)."""
    x = w["embed.table"].to(BF)[tokens]
    if c.arch == "dense":
        for i in range(c.layers):
            x = _run(lambda t, i=i: dense_block(
                w, f"blocks.{i}.", t, c, prec, c.window, c.act), remat, x)
    elif c.arch in ("ssm", "hybrid"):
        every = c.attn_every if c.arch == "hybrid" else 0
        for i in range(c.layers):
            x = _run(lambda t, i=i: mamba_block(w, f"blocks.{i}.", t, c,
                                                prec), remat, x)
            if every and (i + 1) % every == 0:
                x = _run(lambda t: dense_block(w, "shared_attn.", t, c, prec,
                                               c.window, c.act), remat, x)
    else:
        raise ValueError(f"unknown family {c.arch!r}")
    return rmsnorm(x, w["final_norm.scale"], c.eps)


def head(w: Weights, c: Dims) -> Tensor:
    return w["embed.table"] if c.tied else w["lm_head.table"]


def logits(w: Weights, tokens: Tensor, c: Dims, prec: str = "bf16",
           remat: bool = False) -> Tensor:
    """[B, S, V] float32 logits."""
    return mm(hidden(w, tokens, c, prec, remat), head(w, c).t(), prec).float()


def lm_loss(lg: Tensor, labels: Tensor, z_loss: float) -> Tensor:
    """Mean next-token cross entropy plus ``z_loss`` log Z^2."""
    logz = torch.logsumexp(lg, -1)
    gold = torch.gather(lg, -1, labels[..., None])[..., 0]
    return ((logz - gold) + z_loss * logz ** 2).mean()


def loss_and_grads(w: Weights, tokens: Tensor, labels: Tensor, c: Dims,
                   z_loss: float, prec: str = "bf16"):
    """(loss, {name: float32 gradient}) of one batch, blocks recomputed in
    the backward."""
    leaves = {k: t.detach().requires_grad_(True) for k, t in w.items()}
    loss = lm_loss(logits(leaves, tokens, c, prec, remat=True), labels,
                   z_loss)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(t) if g is None else g.float()
                           for (k, t), g in zip(leaves.items(), grads)}
