"""Mamba2 SSD (state-space duality) block, arXiv:2405.21060 (counterpart of
``repro.nn.ssm``).

The SSD recurrence  h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t,
                    y_t = C_t^T h_t + D x_t
is computed in chunked form: an intra-chunk quadratic term
(C B^T ⊙ decay mask) @ x and an inter-chunk recurrence over per-chunk
states.  ``ssd_chunked`` is the plain PyTorch version of the CUDA kernel
``repro_torch.kernels.ssd_scan.ssd_scan``; ``apply_mamba2`` runs one or the
other by ``backend``.

The projections stay separate (``w_z``, ``w_x``, ``w_B``, ``w_C``,
``w_dt``), as in the JAX package, so weights carry across key for key.

Decode: O(1) single-step state update (``ssd_decode_step``).

Mesh paths (``sh``, a ``transformer.Shardings``): with ``w_z`` / ``w_x`` /
``w_dt`` and the per-head parameters split over ``model``, a rank runs its
H / s heads (the scan and its backward on the local heads); B and C are
computed on every rank from the replicated ``w_B`` / ``w_C`` and enter
through ``copy_to_model`` (a rank keeps the groups its heads read); the
gated RMSNorm's mean square over the whole d_in is an ``all_reduce`` of
each rank's sum of squares; ``w_out``'s partial products are summed over
``model``.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as Fnn

from repro_torch import device as devmod
from repro_torch.configs.base import SSMConfig
from repro_torch.nn.layers import Params, he_init, rmsnorm
from repro_torch.sharding import collectives as C

Tensor = torch.Tensor


def init_mamba2(gen: torch.Generator, d_model: int, cfg: SSMConfig,
                dtype=torch.float32) -> Dict[str, Tensor]:
    d_in = cfg.expand * d_model
    H = d_in // cfg.head_dim
    G, N = cfg.n_groups, cfg.state_dim
    dev = gen.device
    return {
        "w_z": he_init(gen, (d_model, d_in), d_model, dtype),
        "w_x": he_init(gen, (d_model, d_in), d_model, dtype),
        "w_B": he_init(gen, (d_model, G * N), d_model, dtype),
        "w_C": he_init(gen, (d_model, G * N), d_model, dtype),
        "w_dt": he_init(gen, (d_model, H), d_model, dtype),
        "conv_x": he_init(gen, (cfg.conv_width, d_in), cfg.conv_width, dtype),
        "conv_b_x": torch.zeros(d_in, device=dev, dtype=dtype),
        "conv_bc": he_init(gen, (cfg.conv_width, 2 * G * N), cfg.conv_width,
                           dtype),
        "conv_b_bc": torch.zeros(2 * G * N, device=dev, dtype=dtype),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=dev)
                           ).to(dtype),                           # [H]
        "D": torch.ones(H, device=dev, dtype=dtype),
        "dt_bias": torch.full((H,), math.log(math.expm1(0.01)), device=dev,
                              dtype=dtype),
        "norm_scale": torch.ones(d_in, device=dev, dtype=dtype),
        "w_out": he_init(gen, (d_in, d_model), d_in, dtype),
    }


def _causal_conv(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal conv1d, then SiLU. x: [B, S, C]; w: [W, C]."""
    W, S = w.shape[0], x.shape[1]
    xp = Fnn.pad(x, (0, 0, W - 1, 0))
    out = sum(xp[:, i: i + S, :] * w[i][None, None, :] for i in range(W))
    return Fnn.silu(out + b[None, None, :])


class SSMState(NamedTuple):
    """Decode-time recurrent state."""

    h: Tensor                # [B, H, P, N]
    conv_x: Tensor           # [B, W-1, d_in] trailing x inputs
    conv_bc: Tensor          # [B, W-1, 2*G*N] trailing B/C inputs


def init_ssm_state(batch: int, d_model: int, cfg: SSMConfig,
                   dtype=torch.float32, device=None, split: int = 1
                   ) -> SSMState:
    """``split``: the model ranks the heads (and d_in) are split over."""
    d_in = cfg.expand * d_model // split
    H = d_in // cfg.head_dim
    return SSMState(
        h=torch.zeros((batch, H, cfg.head_dim, cfg.state_dim), dtype=dtype,
                      device=device),
        conv_x=torch.zeros((batch, cfg.conv_width - 1, d_in), dtype=dtype,
                           device=device),
        conv_bc=torch.zeros((batch, cfg.conv_width - 1,
                             2 * cfg.n_groups * cfg.state_dim), dtype=dtype,
                            device=device))


def ssd_chunked(x: Tensor, dt: Tensor, A: Tensor, B: Tensor, C: Tensor,
                chunk: int, h0: Optional[Tensor] = None
                ) -> Tuple[Tensor, Tensor]:
    """SSD scan. x: [b, S, H, P]; dt: [b, S, H] (>0); A: [H] (>0, used as
    -A); B, C: [b, S, G, N]; head h reads group h // (H/G).  Returns
    (y [b, S, H, P], final state [b, H, P, N])."""
    b, S, H, Pd = x.shape
    G, N = B.shape[2], B.shape[3]
    if S % chunk:
        raise ValueError(f"ssd_chunked: S={S} is not a multiple of chunk="
                         f"{chunk}")
    nc = S // chunk
    rep = H // G

    dA = dt * (-A)[None, None, :]                  # [b, S, H] (negative)
    xd = x * dt[..., None]
    xc = xd.reshape(b, nc, chunk, H, Pd)
    Bc = B.reshape(b, nc, chunk, G, N)
    Cc = C.reshape(b, nc, chunk, G, N)
    cum = torch.cumsum(dA.reshape(b, nc, chunk, H), dim=2)   # [b, nc, l, H]
    total = cum[:, :, -1]                          # [b, nc, H]

    # intra-chunk: decay(i <- j) = exp(cum_i - cum_j) for j <= i
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # [b,nc,i,j,H]
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    Lmat = torch.where(mask[None, None, :, :, None], torch.exp(diff), 0.0)
    scores = torch.einsum("bnigd,bnjgd->bnijg", Cc, Bc)      # [b,nc,i,j,G]
    scores = torch.repeat_interleave(scores, rep, dim=-1)    # [b,nc,i,j,H]
    y_intra = torch.einsum("bnijh,bnjhp->bnihp", scores * Lmat, xc)

    # chunk state summaries: sum_j exp(total - cum_j) B_j x_j^T
    decay_to_end = torch.exp(total[:, :, None, :] - cum)     # [b,nc,l,H]
    Bh = torch.repeat_interleave(Bc, rep, dim=3)             # [b,nc,l,H,N]
    states = torch.einsum("bnlh,bnlhe,bnlhp->bnhpe", decay_to_end, Bh, xc)

    # inter-chunk recurrence over the nc chunks
    chunk_decay = torch.exp(total)                           # [b, nc, H]
    h = h0 if h0 is not None else torch.zeros((b, H, Pd, N), dtype=x.dtype,
                                              device=x.device)
    h_prevs = []
    for n in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, n, :, None, None] + states[:, n]
    h_prevs = torch.stack(h_prevs, 1)                        # [b,nc,H,P,N]

    # contribution of the carried state: C_i decay-from-start @ h_prev
    Ch = torch.repeat_interleave(Cc, rep, dim=3)             # [b,nc,l,H,N]
    y_inter = torch.einsum("bnlh,bnlhe,bnhpe->bnlhp", torch.exp(cum), Ch,
                           h_prevs)
    y = (y_intra + y_inter).reshape(b, S, H, Pd)
    return y, h


def _gated_norm(params: Params, y: Tensor, eps: float, d_in: int, tp: bool,
                sh) -> Tensor:
    """RMSNorm over the whole d_in of y [..., d_in / s]: on split heads the
    sum of squares is all-reduced over ``model`` (and its gradient summed
    back, the sum entering the split region again)."""
    if not tp:
        return rmsnorm({"scale": params["norm_scale"]}, y, eps)
    yf = y.float()
    ss = C.copy_to_model(C.reduce_from_model(
        (yf * yf).sum(-1, keepdim=True), sh), sh)
    out = yf * torch.rsqrt(ss / d_in + eps)
    return (out * params["norm_scale"].float()).to(y.dtype)


def _projections(params: Params, xb: Tensor, tp: bool, sh):
    """z, x, B C (concatenated) and dt of xb: the head-split projections of
    ``copy_to_model(xb)`` on split heads; B C from the replicated weights."""
    bf = torch.bfloat16
    xh = C.copy_to_model(xb, sh) if tp else xb
    BC = torch.cat([xb @ params["w_B"].to(bf), xb @ params["w_C"].to(bf)], -1)
    return (xh @ params["w_z"].to(bf), xh @ params["w_x"].to(bf), BC,
            xh @ params["w_dt"].to(bf))


def _out(params: Params, y: Tensor, tp: bool, sh) -> Tensor:
    bf = torch.bfloat16
    out = y.to(bf) @ params["w_out"].to(bf)
    return C.reduce_from_model(out, sh) if tp else out


def apply_mamba2(params: Params, x: Tensor, d_model: int, cfg: SSMConfig,
                 eps: float = 1e-5, backend: Optional[str] = None,
                 sh=None) -> Tensor:
    """Full Mamba2 block (prefill). x: [B, S, d_model].  ``backend``
    ``None`` follows the device (``"cuda"``: the ``ssd_scan`` kernel,
    whose gradient is its backward kernels'; ``"einsum"``: ``ssd_chunked``,
    differentiated by autograd)."""
    backend = devmod.check_backend(
        backend or devmod.default_backend(x.device), x.device)
    b, S, _ = x.shape
    d_in = cfg.expand * d_model
    tp = C.tp_split(params["w_x"], 1, sh)
    H = params["w_x"].shape[1] // cfg.head_dim          # this rank's heads
    N = cfg.state_dim
    z, xs, BC, dt = _projections(params, x.to(torch.bfloat16), tp, sh)
    xs = _causal_conv(xs.float(), params["conv_x"].float(),
                      params["conv_b_x"].float())
    BC = _causal_conv(BC.float(), params["conv_bc"].float(),
                      params["conv_b_bc"].float())
    B, Cm, G = _local_groups(BC, H, d_in // cfg.head_dim, cfg, tp, sh)
    dt = Fnn.softplus(dt.float() + params["dt_bias"].float())
    A = torch.exp(params["A_log"].float())                   # [H] > 0
    args = (xs.reshape(b, S, H, cfg.head_dim), dt, A,
            B.reshape(b, S, G, N), Cm.reshape(b, S, G, N), min(cfg.chunk, S))
    if backend == "cuda":
        from repro_torch.kernels import ssd_scan   # imports this module

        y, _ = ssd_scan.ssd_scan(*args)
    else:
        y, _ = ssd_chunked(*args)
    y = y + params["D"].float()[None, None, :, None] \
        * xs.reshape(b, S, H, cfg.head_dim)
    y = y.reshape(b, S, H * cfg.head_dim)
    # gated RMSNorm (mamba2 style), then output projection
    y = y * Fnn.silu(z.float())
    y = _gated_norm(params, y, eps, d_in, tp, sh)
    return _out(params, y, tp, sh).to(x.dtype)


def _local_groups(BC: Tensor, H: int, H_all: int, cfg: SSMConfig, tp: bool,
                  sh):
    """(B, C, groups) this rank's H heads read from BC [..., 2 G N]: all G
    without a split; on split heads (BC entering through
    ``copy_to_model``) the groups of global heads j H .. (j + 1) H - 1,
    head h reading group h // (H_all / G) -- whole groups when H is a
    multiple of H_all / G, else the one group the heads share."""
    G, N = cfg.n_groups, cfg.state_dim
    B, Cm = BC.chunk(2, dim=-1)
    if not tp:
        return B, Cm, G
    BC = C.copy_to_model(BC, sh)
    B, Cm = BC.chunk(2, dim=-1)
    rep = H_all // G
    if H % rep and rep % H:
        raise ValueError(f"{H} Mamba2 heads a rank read parts of B/C "
                         f"groups of {rep} heads")
    g0, ng = C.tp_rank(sh) * H // rep, max(H // rep, 1)
    return (B[..., g0 * N:(g0 + ng) * N], Cm[..., g0 * N:(g0 + ng) * N],
            ng)


def ssd_decode_step(params: Params, x: Tensor, state: SSMState,
                    d_model: int, cfg: SSMConfig, eps: float = 1e-5,
                    sh=None) -> Tuple[Tensor, SSMState]:
    """One-token decode. x: [B, 1, d_model] -> (y, new state); on split
    heads (``sh``) the state holds this rank's heads."""
    b = x.shape[0]
    d_in = cfg.expand * d_model
    tp = C.tp_split(params["w_x"], 1, sh)
    H = params["w_x"].shape[1] // cfg.head_dim
    N = cfg.state_dim
    z, xs, BC, dt = _projections(params, x[:, 0].to(torch.bfloat16), tp, sh)

    def conv1(hist_buf, new, w, bias):     # causal conv over the trailing inputs
        hist = torch.cat([hist_buf, new[:, None, :].to(hist_buf.dtype)], 1)
        out = Fnn.silu((hist.float() * w.float()[None]).sum(1) + bias.float())
        return out, hist[:, 1:]

    xs, new_cx = conv1(state.conv_x, xs, params["conv_x"], params["conv_b_x"])
    BC, new_cbc = conv1(state.conv_bc, BC, params["conv_bc"],
                        params["conv_b_bc"])
    B, Cm, G = _local_groups(BC, H, d_in // cfg.head_dim, cfg, tp, sh)
    dt = Fnn.softplus(dt.float() + params["dt_bias"].float())   # [B, H]
    A = torch.exp(params["A_log"].float())
    xh = xs.reshape(b, H, cfg.head_dim)
    Bh = torch.repeat_interleave(B.reshape(b, G, N), H // G, dim=1)  # [B,H,N]
    Ch = torch.repeat_interleave(Cm.reshape(b, G, N), H // G, dim=1)
    decay = torch.exp(dt * (-A)[None])                            # [B, H]
    h = state.h * decay[..., None, None] + torch.einsum(
        "bh,bhp,bhn->bhpn", dt, xh, Bh)
    y = torch.einsum("bhpn,bhn->bhp", h, Ch) \
        + params["D"].float()[None, :, None] * xh
    y = y.reshape(b, H * cfg.head_dim)
    y = y * Fnn.silu(z.float())
    y = _gated_norm(params, y, eps, d_in, tp, sh)
    out = _out(params, y, tp, sh)
    return out[:, None, :].to(x.dtype), SSMState(h=h, conv_x=new_cx,
                                                 conv_bc=new_cbc)
