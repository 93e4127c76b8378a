"""Shared model layers: params-with-logical-axes, norms, RoPE/M-RoPE,
GQA attention (train / prefill / decode, full + sliding window), MLPs.

Port of ``repro.models.layers``.  Parameters are plain dicts of tensors in
the JAX layouts (weights ``(in, out)``, applied as ``x @ W``), so a JAX tree
converted by ``repro_torch.interop`` drops in unchanged.  Each init also
records the parallel axes tree of logical axis names, kept for the
multi-GPU slice.  The JAX package's sharding hooks (``gather_fsdp``,
``constrain_*``) are identities on one device and are left out.

Logical axis vocabulary:
  "vocab"   embedding rows
  "embed"   the d_model dim
  "heads"   q heads * head_dim
  "kv"      kv heads * head_dim
  "ff"      MLP hidden
  "experts" MoE expert dim
  "layers"  stacked layer dim
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.kernels.flash_attention import flash_attention

# ---------------------------------------------------------------------------
# Parameter factory with logical axes.
# ---------------------------------------------------------------------------


class ParamFactory:
    """Creates params and records logical axes in one pass.

    Draws from ``generator`` on its device.  The JAX package splits keys;
    here every factory and sub-factory draws from the one generator in
    order, so the numbers differ from JAX's (never compared bitwise).
    """

    def __init__(self, generator: torch.Generator, dtype=torch.bfloat16):
        self.generator = generator
        self.device = generator.device
        self.dtype = dtype
        self.params: dict[str, Any] = {}
        self.axes: dict[str, Any] = {}

    def dense(self, name: str, shape: tuple[int, ...], axes: tuple,
              scale: float | None = None, dtype=None) -> None:
        assert len(shape) == len(axes)
        if scale is None:
            scale = shape[0] ** -0.5  # fan-in
        self.params[name] = torch.randn(
            shape, generator=self.generator, device=self.device,
            dtype=dtype or self.dtype) * scale
        self.axes[name] = axes

    def zeros(self, name: str, shape: tuple[int, ...], axes: tuple,
              dtype=None) -> None:
        self.params[name] = torch.zeros(shape, dtype=dtype or self.dtype,
                                        device=self.device)
        self.axes[name] = axes

    def ones(self, name: str, shape: tuple[int, ...], axes: tuple,
             dtype=None) -> None:
        self.params[name] = torch.ones(shape, dtype=dtype or self.dtype,
                                       device=self.device)
        self.axes[name] = axes

    def const(self, name: str, shape: tuple[int, ...], axes: tuple,
              value: float, dtype=None) -> None:
        self.params[name] = torch.full(shape, value, dtype=dtype or self.dtype,
                                       device=self.device)
        self.axes[name] = axes

    def sub(self, name: str) -> "ParamFactory":
        child = ParamFactory(self.generator, self.dtype)
        self.params[name] = child.params
        self.axes[name] = child.axes
        return child


def _stack(trees: list) -> Any:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def stack_layer_params(init_fn, generator: torch.Generator, num: int):
    """Run an init ``num`` times -> params stacked on a leading axis.

    Returns (stacked params, axes tree with "layers" prepended).
    """
    inits = [init_fn(generator) for _ in range(num)]
    params = _stack([p for p, _ in inits])

    def prepend(a):
        if isinstance(a, dict):
            return {k: prepend(v) for k, v in a.items()}
        return ("layers",) + tuple(a)

    return params, prepend(inits[0][1])


def maybe_remat(fn, policy: str):
    """Wrap a layer body in activation checkpointing per the remat policy.

    torch has no counterpart of the "dots" policy (save matmul outputs);
    it recomputes the whole body like "full".
    """
    if policy == "none":
        return fn
    return lambda *args: torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False)


# ---------------------------------------------------------------------------
# Norms.
# ---------------------------------------------------------------------------


def rms_norm(x, w, eps: float = 1e-6):
    """Scales by ``(1 + w)``: ``w`` starts at zero (not ``torch.nn.RMSNorm``)."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + w.float())
    return out.to(x.dtype)


def layer_norm(x, w, b, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * w.float() + b.float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings (RoPE and Qwen2-VL M-RoPE).
# ---------------------------------------------------------------------------


def _rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def _rotate_halves(x, cos, sin):
    """Rotates the two halves of the head dim, not interleaved pairs."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float = 1e4):
    """x: (B, S, H, D) with D even; positions: (B, S) absolute indices."""
    B, S, H, D = x.shape
    freqs = _rope_freqs(D, theta, x.device)                 # (D/2,)
    ang = positions.float()[..., None] * freqs              # (B,S,D/2)
    return _rotate_halves(x, ang.cos()[:, :, None, :], ang.sin()[:, :, None, :])


def apply_mrope(x, positions_3d, theta: float = 1e6,
                sections: tuple[int, int, int] = (16, 24, 24)):
    """Qwen2-VL multimodal RoPE: the head dim is split into (temporal,
    height, width) sections, each rotated by its own position stream.

    x: (B, S, H, D); positions_3d: (B, S, 3).  ``sections`` are in
    half-dim units and must sum to D//2.
    """
    B, S, H, D = x.shape
    half = D // 2
    assert sum(sections) == half, "mrope sections must sum to head_dim/2"
    freqs = _rope_freqs(D, theta, x.device)                 # (half,)
    sec_id = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.tensor(sections, device=x.device))            # (half,) in {0,1,2}
    pos = torch.gather(positions_3d.float(), 2,
                       sec_id[None, None, :].expand(B, S, half))  # (B,S,half)
    ang = pos * freqs[None, None, :]
    return _rotate_halves(x, ang.cos()[:, :, None, :], ang.sin()[:, :, None, :])


# ---------------------------------------------------------------------------
# Attention (GQA) with KV-cache support.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 1e4
    mrope: bool = False
    causal: bool = True
    window: int | None = None    # sliding window (None = full)
    block_q: int = 512
    block_k: int = 512


def init_attention(generator, cfg: AttnConfig, dtype=torch.bfloat16):
    p = ParamFactory(generator, dtype)
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p.dense("wq", (D, H * hd), ("embed", "heads"))
    p.dense("wk", (D, KV * hd), ("embed", "kv"))
    p.dense("wv", (D, KV * hd), ("embed", "kv"))
    p.dense("wo", (H * hd, D), ("heads", "embed"))
    if cfg.qkv_bias:
        p.zeros("bq", (H * hd,), ("heads",))
        p.zeros("bk", (KV * hd,), ("kv",))
        p.zeros("bv", (KV * hd,), ("kv",))
    return p.params, p.axes


def _qkv(params, x, cfg: AttnConfig, positions):
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if cfg.mrope:
        pos3 = positions[..., None] if positions.dim() == 2 else positions
        if pos3.shape[-1] != 3:  # text-only stream: t=h=w=position
            pos3 = pos3.expand(*pos3.shape[:-1], 3)
        q = apply_mrope(q, pos3, cfg.rope_theta, _mrope_sections(hd))
        k = apply_mrope(k, pos3, cfg.rope_theta, _mrope_sections(hd))
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mrope_sections(head_dim: int) -> tuple[int, int, int]:
    half = head_dim // 2
    t = half - 2 * (3 * half // 8)
    return (t, 3 * half // 8, 3 * half // 8)


def attention_fwd(params, x, cfg: AttnConfig, positions=None):
    """Full-sequence attention (training / prefill).  x: (B, S, D).

    Goes through the flash-attention dispatcher: the CUDA kernel for a
    tensor on the card, the plain chunked version on the CPU.
    """
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    q, k, v = _qkv(params, x, cfg, positions)
    out = flash_attention(q, k, v, causal=cfg.causal, window=cfg.window,
                          q_offset=0, block_q=cfg.block_q, block_k=cfg.block_k)
    out = out.reshape(B, S, cfg.num_heads * cfg.head_dim)
    return out @ params["wo"], (k, v)


def attention_decode(params, x, cfg: AttnConfig, k_cache, v_cache,
                     kv_len: int, positions):
    """One-token decode against a filled cache.

    x: (B, 1, D); k_cache/v_cache: (B, S_cache, KV, hd) where entries
    [0, kv_len) are valid roped keys.  For sliding-window layers the cache
    is a ring of size ``window`` (attention is permutation-invariant, so
    ring order does not matter).  The new K/V row is written into the
    caches in place; returns (out, k_cache, v_cache).
    """
    B = x.shape[0]
    q, k_new, v_new = _qkv(params, x, cfg, positions)
    S_cache = k_cache.shape[1]
    slot = kv_len % S_cache if cfg.window is not None else kv_len
    slot = slot % S_cache
    k_cache[:, slot] = k_new[:, 0].to(k_cache.dtype)
    v_cache[:, slot] = v_new[:, 0].to(v_cache.dtype)
    valid = min(kv_len + 1, S_cache)
    out = _decode_attend(q, k_cache, v_cache, valid, cfg)
    out = out.reshape(B, 1, cfg.num_heads * cfg.head_dim)
    return out @ params["wo"], k_cache, v_cache


def _decode_attend(q, k_cache, v_cache, valid_len, cfg: AttnConfig):
    """Masked non-causal attention of one query over the cache (fp32 softmax).

    Plain torch, as in the JAX package: no kernel backs the dense decode.
    """
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    qf = q.float() * (hd ** -0.5)                         # (B,1,H,hd)
    kf = k_cache.float()
    vf = v_cache.float()
    qg = qf.reshape(B, KV, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, kf)           # (B,KV,G,S)
    kpos = torch.arange(k_cache.shape[1], device=q.device)
    mask = kpos[None, None, None, :] < valid_len
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, vf)
    return o.reshape(B, 1, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# MLPs.
# ---------------------------------------------------------------------------


def init_mlp(generator, d_model: int, d_ff: int, kind: str = "swiglu",
             dtype=torch.bfloat16):
    p = ParamFactory(generator, dtype)
    if kind in ("swiglu", "geglu"):
        p.dense("wi_gate", (d_model, d_ff), ("embed", "ff"))
        p.dense("wi_up", (d_model, d_ff), ("embed", "ff"))
    else:  # "gelu" / "relu": plain 2-layer MLP
        p.dense("wi_up", (d_model, d_ff), ("embed", "ff"))
    p.dense("wo", (d_ff, d_model), ("ff", "embed"))
    return p.params, p.axes


def mlp_fwd(params, x, kind: str = "swiglu"):
    """GELU is the tanh form, as ``jax.nn.gelu(approximate=True)``."""
    if kind == "swiglu":
        h = F.silu(x @ params["wi_gate"]) * (x @ params["wi_up"])
    elif kind == "geglu":
        h = F.gelu(x @ params["wi_gate"], approximate="tanh") * (x @ params["wi_up"])
    elif kind == "gelu":
        h = F.gelu(x @ params["wi_up"], approximate="tanh")
    elif kind == "relu":
        h = F.relu(x @ params["wi_up"])
    else:
        raise ValueError(kind)
    return h @ params["wo"]


# ---------------------------------------------------------------------------
# Embedding / unembedding.
# ---------------------------------------------------------------------------


def init_embedding(generator, vocab: int, d_model: int, tie: bool = False,
                   dtype=torch.bfloat16):
    p = ParamFactory(generator, dtype)
    p.dense("embed", (vocab, d_model), ("vocab", "embed"), scale=0.02)
    if not tie:
        p.dense("unembed", (d_model, vocab), ("embed", "vocab"))
    return p.params, p.axes


def embed_fwd(params, tokens):
    return params["embed"][tokens]


def unembed_fwd(params, x):
    if "unembed" in params:
        return x @ params["unembed"]
    return x @ params["embed"].T  # tied
