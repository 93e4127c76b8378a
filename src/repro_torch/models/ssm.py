"""Attention-free sequence mixers: Mamba2 (SSD) and RWKV6 ("Finch").

Port of ``repro.models.ssm``.  Both reduce to the gated-linear-attention
recurrence of ``repro_torch.kernels.ssm_scan`` (the chunked kernel for
prefill and forward, the O(1) recurrent step for decode):

    S_t = diag(exp(w_t)) S_{t-1} + k_t (x) v_t ;   o_t = q_t^T S_t

* **Mamba2**: per-head scalar decay  w_t = -softplus(dt_t) * exp(A_h),
  k = B-projection, v = dt * x, q = C-projection, plus the depthwise
  short conv on the input and a gated output (SiLU(z) * y) with RMS norm.
* **RWKV6**: per-key-dim data-dependent decay w_t from a low-rank MLP,
  token-shift mixing on the inputs, receptance r as q, and a gated output.

Decode carries (conv tail or previous token, GLA state).  The projection
weights go through ``gather_fsdp``, as in the reference (an identity
outside a sharded scope).  q, k, v and w go to the scan as head-transposed views; the kernel
takes their strides, and Mamba2's per-head decay with a stride-0 K axis.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import gather_fsdp, reduce_model_partial
from repro_torch.kernels.ssm_scan import gla_scan
from repro_torch.kernels.ssm_scan.ref import gla_decode_step
from repro_torch.models.layers import ParamFactory, rms_norm

CONV_K = 4  # mamba short-conv width


# ---------------------------------------------------------------------------
# Mamba2 block.
# ---------------------------------------------------------------------------


def init_mamba2(generator, d_model: int, state: int, num_heads: int,
                head_dim: int | None = None, expand: int = 2,
                dtype=torch.bfloat16):
    """d_inner = expand*d_model split into num_heads of head_dim."""
    d_inner = expand * d_model
    head_dim = head_dim or d_inner // num_heads
    assert num_heads * head_dim == d_inner
    p = ParamFactory(generator, dtype)
    p.dense("in_xz", (d_model, 2 * d_inner), ("embed", "heads"))
    p.dense("in_bc", (d_model, 2 * state * num_heads), ("embed", "heads"))
    p.dense("in_dt", (d_model, num_heads), ("embed", "heads"))
    p.zeros("conv", (CONV_K, d_inner), (None, "heads"))
    p.zeros("A_log", (num_heads,), ("heads",), dtype=torch.float32)
    p.zeros("D", (num_heads,), ("heads",), dtype=torch.float32)
    # dt ~ softplus(x@W + bias) ~ 0.01: slow default decay (mamba2 init
    # range dt in [1e-3, 1e-1]); keeps chunk-cumulative log-decay bounded.
    p.const("dt_bias", (num_heads,), ("heads",), -4.6, dtype=torch.float32)
    p.zeros("norm_w", (d_inner,), ("heads",))
    p.dense("out", (d_inner, d_model), ("heads", "embed"))
    return p.params, p.axes


def _short_conv(x, w, tail=None):
    """Depthwise causal conv along S.  x: (B,S,C); w: (K,C).

    ``tail`` (B, K-1, C) carries the last K-1 inputs for decode; returns
    (out, new_tail).
    """
    B, S, C = x.shape
    if tail is None:
        tail = torch.zeros((B, CONV_K - 1, C), dtype=x.dtype, device=x.device)
    xp = torch.cat([tail.to(x.dtype), x], dim=1)      # (B, S+K-1, C)
    out = torch.zeros_like(x)
    for i in range(CONV_K):
        out = out + xp[:, i:i + S] * w[i][None, None]
    return out, xp[:, -(CONV_K - 1):]


def mamba2_fwd(params, x, *, state: int, num_heads: int, chunk: int = 128,
               carry=None, decode: bool = False):
    """x: (B, S, D).  carry = (conv_tail, gla_state) for decode continuity."""
    B, S, D = x.shape
    H = num_heads
    d_inner = params["in_xz"].shape[1] // 2
    hd = d_inner // H
    xs, z = (x @ gather_fsdp(params["in_xz"], tp_dim=1)).split(d_inner, dim=-1)
    conv_tail = carry[0] if carry is not None else None
    xs, new_tail = _short_conv(xs, params["conv"], conv_tail)
    xs = F.silu(xs)
    bmat, cmat = (x @ gather_fsdp(params["in_bc"], tp_dim=1)).split(H * state, dim=-1)  # (B,S,H*state)
    # x is a pending sum over "model" in a sharded train step (the
    # residual stream after a row-sharded projection), and so is x @ in_dt:
    # reduced before the add of the "model"-sharded dt_bias
    dt = F.softplus(reduce_model_partial(x @ params["in_dt"]).float()
                    + params["dt_bias"])                # (B,S,H)
    A = -torch.exp(params["A_log"])                    # (H,) negative
    w = (dt * A[None, None]).float()                   # (B,S,H) log-decay <= 0

    # GLA form: per head, K=state, V=head_dim.
    q = cmat.reshape(B, S, H, state).transpose(1, 2)
    k = bmat.reshape(B, S, H, state).transpose(1, 2)
    v = (xs.reshape(B, S, H, hd) * dt[..., None].to(xs.dtype)).transpose(1, 2)
    wk = w.transpose(1, 2)[..., None].expand(k.shape)

    gla_state = carry[1] if carry is not None else None
    if decode and S == 1:
        if gla_state is None:
            gla_state = torch.zeros((B, H, state, hd), dtype=torch.float32,
                                    device=x.device)
        o, new_state = gla_decode_step(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                                       wk[:, :, 0], gla_state)
        o = o[:, :, None]                              # (B,H,1,hd)
    else:
        o, new_state = gla_scan(q, k, v, wk, chunk=chunk)
    y = o.transpose(1, 2).reshape(B, S, d_inner)
    y = y + xs * torch.repeat_interleave(params["D"], hd)[None, None].to(xs.dtype)
    y = rms_norm(y, params["norm_w"]) * F.silu(z)
    return y @ gather_fsdp(params["out"], tp_dim=0), (new_tail, new_state)


# ---------------------------------------------------------------------------
# RWKV6 block (time mixing; channel mixing is a gated MLP in the stack).
# ---------------------------------------------------------------------------


def init_rwkv6(generator, d_model: int, num_heads: int, decay_rank: int = 64,
               dtype=torch.bfloat16):
    p = ParamFactory(generator, dtype)
    for n in ("r", "k", "v", "g"):
        p.dense(f"w_{n}", (d_model, d_model), ("embed", "heads"))
    # token-shift mix coefficients (one per stream)
    p.zeros("mix", (5, d_model), (None, "embed"))
    # data-dependent decay: low-rank MLP  d_model -> rank -> d_model
    p.dense("wd_a", (d_model, decay_rank), ("embed", None))
    p.dense("wd_b", (decay_rank, d_model), (None, "heads"))
    # w = -exp(decay_base + dd): base -5 => per-token log-decay ~ -0.007,
    # matching RWKV6's slow-decay init and bounding chunk exponents.
    p.const("decay_base", (d_model,), ("heads",), -5.0, dtype=torch.float32)
    p.zeros("ln_w", (d_model,), ("heads",))
    p.dense("out", (d_model, d_model), ("heads", "embed"))
    return p.params, p.axes


def token_shift(x, prev=None):
    """x shifted one position along S, ``prev`` (B, 1, D) filling position 0."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


def rwkv6_fwd(params, x, *, num_heads: int, chunk: int = 128,
              carry=None, decode: bool = False):
    """x: (B, S, D).  carry = (prev_token, gla_state)."""
    B, S, D = x.shape
    H = num_heads
    hd = D // H
    shifted = token_shift(x, carry[0] if carry is not None else None)

    def mixed(i):
        return x + (shifted - x) * params["mix"][i][None, None]

    r = mixed(0) @ gather_fsdp(params["w_r"], tp_dim=1)
    kk = mixed(1) @ gather_fsdp(params["w_k"], tp_dim=1)
    vv = mixed(2) @ gather_fsdp(params["w_v"], tp_dim=1)
    g = mixed(3) @ gather_fsdp(params["w_g"], tp_dim=1)
    # data-dependent per-channel log decay (Finch):
    dd = torch.tanh(mixed(4) @ params["wd_a"]) @ params["wd_b"]
    w = -torch.exp(params["decay_base"] + dd.float())  # (B,S,D) < 0

    q, k, v, wk = (t.reshape(B, S, H, hd).transpose(1, 2)
                   for t in (r, kk, vv, w))

    gla_state = carry[1] if carry is not None else None
    if decode and S == 1:
        if gla_state is None:
            gla_state = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                                    device=x.device)
        o, new_state = gla_decode_step(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                                       wk[:, :, 0], gla_state)
        o = o[:, :, None]
    else:
        o, new_state = gla_scan(q, k, v, wk, chunk=chunk)
    y = o.transpose(1, 2).reshape(B, S, D)
    y = rms_norm(y, params["ln_w"]) * F.silu(g)
    return y @ gather_fsdp(params["out"], tp_dim=0), (x[:, -1:], new_state)
