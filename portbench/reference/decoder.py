"""The plain reference: a dense decoder-only transformer in float32.

Plain PyTorch, written from the published descriptions of the two models
(StarCoder2: arXiv:2402.19173, LayerNorm with biases, tanh-GELU MLP;
Qwen2.5: RMSNorm, SwiGLU, biases on Q/K/V), with RoPE on the two halves of
each head and grouped-query attention.  It imports nothing of the program
under test.  What the configuration file states in its ``model`` block is
what runs here; the keys that say how the measured package departs from the
published model (the final norm, the norm scale stored as ``1 + w``) are
read from the same block, so both sides compute one model.

Weights come as the benchmark makes them (``portbench.weights``): a tree
whose per-layer leaves are stacked on a leading layer axis, every matrix
laid out (in, out) and applied as ``x @ W``.  They are bfloat16; each
layer's are widened to float32 when that layer runs, so the reference
never holds a float32 copy of the whole model.  Every product runs in
float32 with TF32 off.

``quant`` puts a lower precision in place of float32 for the control: a
function applied to every weight matrix before it is used.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

ATTN_CHUNK = 512          # query rows per block of the attention scores


@contextlib.contextmanager
def fp32_exact():
    """TF32 off for matrix products and convolutions, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def fp8_weights(w: torch.Tensor) -> torch.Tensor:
    """``w`` (in, out) rounded to float8 e4m3 with one scale per output
    column, returned in float32: the control's weights."""
    w = w.float()
    scale = w.abs().amax(0, keepdim=True).clamp_min(1e-12) / 448.0
    q = (w / scale).clamp(-448.0, 448.0).to(torch.float8_e4m3fn)
    return q.float() * scale


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per row (token), in
    float32: the control's activations at each product's input."""
    scale = x.abs().amax(-1, keepdim=True).clamp_min(1e-12) / 448.0
    return (x / scale).clamp(-448.0, 448.0).to(torch.float8_e4m3fn).float() * scale


def _norm(x, kind: str, w, b, eps: float, one_plus: bool):
    if kind == "rms":
        g = 1.0 + w if one_plus else w
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * g
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def _rope(x, positions, theta: float):
    """x: (R, T, H, D); rotates the first half of D against the second."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[:, None] * inv[None, :]           # (T, half)
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def _attention(q, k, v):
    """Causal GQA.  q: (R, T, H, D); k, v: (R, T, KV, D) -> (R, T, H*D)."""
    R, T, H, D = q.shape
    G = H // k.shape[2]
    k = k.repeat_interleave(G, dim=2).transpose(1, 2)         # (R, H, T, D)
    v = v.repeat_interleave(G, dim=2).transpose(1, 2)
    q = q.transpose(1, 2) * D ** -0.5
    out = torch.empty_like(q)
    for s in range(0, T, ATTN_CHUNK):
        e = min(T, s + ATTN_CHUNK)
        scores = q[:, :, s:e] @ k[:, :, :e].transpose(-1, -2)  # (R, H, c, e)
        qpos = torch.arange(s, e, device=q.device)[:, None]
        kpos = torch.arange(e, device=q.device)[None, :]
        scores = scores.masked_fill(kpos > qpos, -math.inf)
        out[:, :, s:e] = torch.softmax(scores, -1) @ v[:, :, :e]
    return out.transpose(1, 2).reshape(R, T, H * D)


def _layer_weights(blocks: dict, i: int, quant) -> dict:
    """Layer ``i`` of the stacked tree in float32; matrices through
    ``quant`` where given."""
    def take(t):
        if isinstance(t, dict):
            return {k: take(v) for k, v in t.items()}
        w = t[i].float()
        return quant(w) if quant is not None and w.dim() == 2 else w
    return take(blocks)


def logits_at(weights: dict, model: dict, tokens: torch.Tensor,
              wanted: torch.Tensor, quant=None, act=None) -> torch.Tensor:
    """float32 logits (R, len(wanted), vocab) at sequence positions
    ``wanted`` of ``tokens`` (R, T), computed over the whole causal prefix.

    ``model`` is the configuration file's ``model`` block.
    """
    L, H, KV = model["num_layers"], model["num_heads"], model["num_kv_heads"]
    D = model.get("head_dim") or model["d_model"] // H
    block_norm, one_plus = model["norm"], model["rms_scale"] == "one_plus_w"
    eps = {"rms": model["rms_eps"], "ln": model["ln_eps"]}
    R, T = tokens.shape
    pos = torch.arange(T, device=tokens.device)
    x = weights["embedding"]["embed"][tokens.long()].float()   # (R, T, d)
    a_in = act or (lambda t: t)
    with fp32_exact():
        for i in range(L):
            w = _layer_weights(weights["blocks"], i, quant)
            a = w["attn"]

            def norm(x, n):
                if block_norm == "rms":
                    return _norm(x, "rms", w[f"norm{n}"], None, eps["rms"], one_plus)
                return _norm(x, "ln", w[f"norm{n}_w"], w[f"norm{n}_b"], eps["ln"],
                             one_plus)

            h = a_in(norm(x, 1))
            q, k, v = h @ a["wq"], h @ a["wk"], h @ a["wv"]
            if model["qkv_bias"]:
                q, k, v = q + a["bq"], k + a["bk"], v + a["bv"]
            q = _rope(q.view(R, T, H, D), pos, model["rope_theta"])
            k = _rope(k.view(R, T, KV, D), pos, model["rope_theta"])
            x = x + a_in(_attention(q, k, v.view(R, T, KV, D))) @ a["wo"]
            h = a_in(norm(x, 2))
            m = w["mlp"]
            if model["mlp"] == "swiglu":
                h = F.silu(h @ m["wi_gate"]) * (h @ m["wi_up"])
            elif model["mlp"] == "gelu":
                h = F.gelu(h @ m["wi_up"], approximate="tanh")
            else:
                raise ValueError(f"mlp {model['mlp']!r}")
            x = x + a_in(h) @ m["wo"]
            del w, a, m, h, q, k, v
        x = x[:, wanted.to(x.device)]
        final = model["final_norm"]
        if final == "rms":
            x = _norm(x, "rms", weights["final_norm"].float(), None, eps["rms"],
                      one_plus)
        else:
            raise ValueError(f"final norm {final!r}")
        unembed = weights["embedding"]["unembed"].float()
        if quant is not None:
            unembed = quant(unembed)
        return a_in(x) @ unembed
