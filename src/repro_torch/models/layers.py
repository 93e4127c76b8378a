"""Shared model layers: params-with-logical-axes, norms, RoPE/M-RoPE,
GQA attention (train / prefill / decode, full + sliding window), MLPs.

Port of ``repro.models.layers``.  Parameters are plain dicts of tensors in
the JAX layouts (weights ``(in, out)``, applied as ``x @ W``), so a JAX tree
converted by ``repro_torch.interop`` drops in unchanged.  Each init also
records the parallel axes tree of logical axis names; the sharding layer
(``repro_torch.distributed.sharding``) maps them to mesh axes.  The
weights go through its hooks (``gather_fsdp`` here, ``constrain_kv_layout``
in the plain decode attention, ``kernels/decode_attention/ref.py``) at the
reference's call sites; outside a sharded scope they are identities.

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
import functools
from typing import Any

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (embed_rows, gather_fsdp,
                                              index_copy_, merge_heads,
                                              split_heads)
from repro_torch.kernels.decode_attention import decode_attention
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


def init_generator(generator: torch.Generator | None, device):
    """(generator, device) for a model init: the device resolved (``cuda``
    raises without a card), a generator seeded with 0 made there if none is
    given, and one on another device refused."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, device {dev}")
    return generator, dev


def stack_layer_params(init_fn, generator: torch.Generator, num: int):
    """Run an init ``num`` times -> params stacked on a leading axis.

    Each ``(num, ...)`` leaf is allocated once, from the first layer's
    shapes and dtypes (nested trees too), and every layer is copied into
    its slot as it is drawn, so the peak holds the stacked weights and one
    layer, not a list of layers beside their stack.  The layers draw from
    ``generator`` in order, as a stack of ``num`` inits would.

    Returns (stacked params, axes tree with "layers" prepended).
    """
    first, axes = init_fn(generator)

    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return t.new_empty((num, *t.shape))

    def put(dst, src, i):
        if isinstance(dst, dict):
            for k in dst:
                put(dst[k], src[k], i)
        else:
            dst[i].copy_(src)

    params = alloc(first)
    put(params, first, 0)
    del first
    for i in range(1, num):
        put(params, init_fn(generator)[0], i)

    def prepend(a):
        if isinstance(a, dict):
            return {k: prepend(v) for k, v in a.items()}
        return ("layers",) + tuple(a)

    return params, prepend(axes)


def layer_views(blocks: dict, n: int) -> list[dict]:
    """Per-layer views of params stacked on a leading axis (what each step
    of a ``lax.scan`` over them sees)."""
    def take(t, i):
        if isinstance(t, dict):
            return {k: take(v, i) for k, v in t.items()}
        return t[i]
    return [take(blocks, i) for i in range(n)]


# What the "dots" policy saves: the projections ``x @ W``, which
# ``torch.matmul`` folds into ``mm`` for a 3-D ``x`` (``addmm`` with a
# bias).  These are JAX's dots with no batch dimensions; ``bmm`` (the MoE
# experts, the plain attention's einsums) has batch dimensions, and
# neither policy saves those.
_DOTS_SAVED = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    """The port of ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``
    for ``create_selective_checkpoint_contexts``: keep the outputs of the
    ops in ``_DOTS_SAVED``, recompute everything else (the flash and
    gla_scan autograd functions among them, as JAX recomputes a Pallas
    call)."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS_SAVED
            else CheckpointPolicy.PREFER_RECOMPUTE)


def maybe_remat(fn, policy: str):
    """Wrap a layer body in activation checkpointing per the remat policy:
    "full" recomputes the whole body in the backward, "dots" recomputes it
    but for the projections' outputs, which the forward keeps
    (``_dots_policy``), and "none" keeps every activation."""
    if policy == "none":
        return fn
    if policy == "dots":
        return lambda *args: torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, context_fn=functools.partial(
                create_selective_checkpoint_contexts, _dots_policy))
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
    # (half,) in {0,1,2}, from the section boundaries as Python ints: no
    # copy from the host and no read of it, so a CUDA graph can capture it.
    i = torch.arange(half, device=x.device)
    sec_id = (i >= sections[0]).long() + (i >= sections[0] + sections[1]).long()
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
    q = x @ gather_fsdp(params["wq"], tp_dim=1)
    k = x @ gather_fsdp(params["wk"], tp_dim=1)
    v = x @ gather_fsdp(params["wv"], tp_dim=1)
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = split_heads(q, B, S, H, hd)
    k = split_heads(k, B, S, KV, hd)
    v = split_heads(v, B, S, KV, hd)
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
    with obs.span("attend"):
        out = flash_attention(q, k, v, causal=cfg.causal, window=cfg.window,
                              q_offset=0, block_q=cfg.block_q,
                              block_k=cfg.block_k)
    out = merge_heads(out, B, S, cfg.num_heads * cfg.head_dim)
    return out @ gather_fsdp(params["wo"], tp_dim=0), (k, v)


def kv_len_tensor(kv_len, device) -> torch.Tensor:
    """``kv_len`` as a 0-d int32 tensor on ``device``: a tensor there
    already is returned as it is, an int is filled in on the device (no
    copy from the host)."""
    if isinstance(kv_len, torch.Tensor):
        return kv_len.to(device=device, dtype=torch.int32)
    return torch.full((), kv_len, dtype=torch.int32, device=device)


def attention_decode(params, x, cfg: AttnConfig, k_cache, v_cache,
                     kv_len, positions):
    """One-token decode against a filled cache.

    x: (B, 1, D); k_cache/v_cache: (B, S_cache, KV, hd) where entries
    [0, kv_len) are valid roped keys.  ``kv_len`` is an int or a 0-d int32
    tensor on the cache's device, as in the JAX package; nothing here reads
    it on the host, so a CUDA graph can capture the step.  For
    sliding-window layers the cache is a ring of size ``window`` (attention
    is permutation-invariant, so ring order does not matter).  The new K/V
    row is written into the caches in place; returns (out, k_cache,
    v_cache).  The attention goes through the dense decode dispatcher: the
    CUDA kernel for the calls its route takes, the plain version (the JAX
    package's body) for the rest.
    """
    B = x.shape[0]
    q, k_new, v_new = _qkv(params, x, cfg, positions)
    S_cache = k_cache.shape[1]
    kv_len = kv_len_tensor(kv_len, k_cache.device)
    slot = torch.remainder(kv_len, S_cache).long().view(1)
    index_copy_(k_cache, 1, slot, k_new.to(k_cache.dtype))
    index_copy_(v_cache, 1, slot, v_new.to(v_cache.dtype))
    valid = torch.clamp(kv_len + 1, max=S_cache)
    with obs.span("attend"):
        out = decode_attention(q, k_cache, v_cache, valid)
    out = merge_heads(out, B, 1, cfg.num_heads * cfg.head_dim)
    return out @ params["wo"], k_cache, v_cache


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
    def w(name, tp_dim=1):
        return gather_fsdp(params[name], tp_dim=tp_dim)

    if kind == "swiglu":
        h = F.silu(x @ w("wi_gate")) * (x @ w("wi_up"))
    elif kind == "geglu":
        h = F.gelu(x @ w("wi_gate"), approximate="tanh") * (x @ w("wi_up"))
    elif kind == "gelu":
        h = F.gelu(x @ w("wi_up"), approximate="tanh")
    elif kind == "relu":
        h = F.relu(x @ w("wi_up"))
    else:
        raise ValueError(kind)
    return h @ w("wo", 0)


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
    """Rows of the table; a DTensor table (a sharded model) through
    ``sharding.embed_rows``."""
    if isinstance(params["embed"], DTensor):
        return embed_rows(params["embed"], tokens)
    return params["embed"][tokens]


def unembed_fwd(params, x):
    if "unembed" in params:
        return x @ params["unembed"]
    return x @ params["embed"].T  # tied
