"""Decoder-only LM, dense family with full attention.

Port of ``repro.models.transformer``.  Layer params are stacked on a
leading "layers" axis as in JAX; each ``lax.scan`` over them becomes a
Python loop over the same stacked tensors.  Caches are written in place:
``lm_decode_step`` and ``lm_decode_step_paged`` update the cache dict they
are given and return it, where the JAX functions return a new one.

The ``local_global`` attention pattern (gemma3), the ``moe`` family and the
``vlm`` family raise ``NotImplementedError``: they are items 4 (second
half) and 7 of Queue 1 in ROADMAP.md.

Entry points:
  init_lm(cfg, generator, device)             -> (params, logical-axes tree)
  lm_forward(params, cfg, tokens)             -> (logits, aux)   (forward only)
  lm_init_cache(cfg, batch, cache_len, ...)   -> cache dict
  lm_prefill(params, cfg, tokens, ...)        -> (logits, cache)
  lm_decode_step(params, cfg, cache, kv_len, token) -> (logits, cache)
  lm_init_paged_cache(cfg, batch, max_len, ...)     -> paged cache dict
  lm_decode_step_paged(params, cfg, cache, kv_len, token) -> (logits, cache)
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models import layers as L


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the families and attention patterns not ported yet."""
    if cfg.attention == "local_global":
        raise NotImplementedError(
            f"{cfg.name}: local_global attention is not ported yet "
            "(ROADMAP.md, Queue 1 item 4)")
    if cfg.family == "moe":
        raise NotImplementedError(
            f"{cfg.name}: the moe family is not ported yet "
            "(ROADMAP.md, Queue 1 item 7)")
    if cfg.family == "vlm":
        raise NotImplementedError(
            f"{cfg.name}: the vlm family (M-RoPE, embeds prefix) is not "
            "ported yet (ROADMAP.md, Queue 1 item 4)")
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not a transformer family")


# ---------------------------------------------------------------------------
# Block init.
# ---------------------------------------------------------------------------


def _attn_cfg(cfg: ModelConfig, *, window=None, theta=None) -> L.AttnConfig:
    return L.AttnConfig(
        d_model=cfg.d_model, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.hd,
        qkv_bias=cfg.qkv_bias, rope_theta=theta or cfg.rope_theta,
        mrope=cfg.mrope, causal=True, window=window)


def init_block(cfg: ModelConfig, generator) -> tuple[dict, dict]:
    """One decoder block: norm -> attn -> norm -> mlp."""
    check_supported(cfg)
    p = L.ParamFactory(generator)
    ap, aa = L.init_attention(generator, _attn_cfg(cfg))
    p.params["attn"], p.axes["attn"] = ap, aa
    if cfg.norm == "rms":
        p.zeros("norm1", (cfg.d_model,), ("embed",))
        p.zeros("norm2", (cfg.d_model,), ("embed",))
    else:
        p.ones("norm1_w", (cfg.d_model,), ("embed",))
        p.zeros("norm1_b", (cfg.d_model,), ("embed",))
        p.ones("norm2_w", (cfg.d_model,), ("embed",))
        p.zeros("norm2_b", (cfg.d_model,), ("embed",))
    mp, ma = L.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.mlp)
    p.params["mlp"], p.axes["mlp"] = mp, ma
    return p.params, p.axes


def _norm1(params, cfg, x):
    if cfg.norm == "rms":
        return L.rms_norm(x, params["norm1"])
    return L.layer_norm(x, params["norm1_w"], params["norm1_b"])


def _norm2(params, cfg, x):
    if cfg.norm == "rms":
        return L.rms_norm(x, params["norm2"])
    return L.layer_norm(x, params["norm2_w"], params["norm2_b"])


def block_fwd(params, x, cfg: ModelConfig, positions, *,
              window=None, theta=None):
    """Full-sequence block.  Returns (x, (k, v), aux_loss)."""
    acfg = _attn_cfg(cfg, window=window, theta=theta)
    a, kv = L.attention_fwd(params["attn"], _norm1(params, cfg, x), acfg,
                            positions)
    x = x + a
    m = L.mlp_fwd(params["mlp"], _norm2(params, cfg, x), cfg.mlp)
    return x + m, kv, torch.zeros((), device=x.device)


def block_decode(params, x, cfg: ModelConfig, k_cache, v_cache, kv_len,
                 positions, *, window=None, theta=None):
    acfg = _attn_cfg(cfg, window=window, theta=theta)
    a, k_cache, v_cache = L.attention_decode(
        params["attn"], _norm1(params, cfg, x), acfg, k_cache, v_cache,
        kv_len, positions)
    x = x + a
    m = L.mlp_fwd(params["mlp"], _norm2(params, cfg, x), cfg.mlp)
    return x + m, k_cache, v_cache


def _layers(blocks: dict, n: int) -> list[dict]:
    """Per-layer views of the stacked block params."""
    def take(t, i):
        if isinstance(t, dict):
            return {k: take(v, i) for k, v in t.items()}
        return t[i]
    return [take(blocks, i) for i in range(n)]


# ---------------------------------------------------------------------------
# Model init.
# ---------------------------------------------------------------------------


def init_lm(cfg: ModelConfig, generator: torch.Generator | None = None,
            device: str | torch.device = "cuda") -> tuple[dict, dict]:
    """Native init with the JAX init's shapes, dtypes (bf16) and scales.

    ``generator`` must live on ``device``; by default a generator seeded
    with 0 is made there.  Not bitwise equal to JAX's ``init_lm``: parity
    tests import JAX params through ``repro_torch.interop`` instead.
    """
    check_supported(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, device {dev}")
    params: dict[str, Any] = {}
    axes: dict[str, Any] = {}
    ep, ea = L.init_embedding(generator, cfg.padded_vocab, cfg.d_model,
                              cfg.tie_embeddings)
    params["embedding"], axes["embedding"] = ep, ea
    bp, ba = L.stack_layer_params(lambda g: init_block(cfg, g), generator,
                                  cfg.num_layers)
    params["blocks"], axes["blocks"] = bp, ba
    params["final_norm"] = torch.zeros((cfg.d_model,), dtype=torch.bfloat16,
                                       device=dev)
    axes["final_norm"] = ("embed",)
    return params, axes


def _final(params, cfg, x):
    x = L.rms_norm(x, params["final_norm"])
    return L.unembed_fwd(params["embedding"], x)


def _positions(cfg: ModelConfig, B: int, S: int, device, offset=0):
    pos = (torch.arange(S, device=device)[None] + offset).expand(B, S)
    if cfg.mrope:
        return pos[..., None].expand(B, S, 3)
    return pos


# ---------------------------------------------------------------------------
# Forward (no training step yet: the attention kernel has no backward).
# ---------------------------------------------------------------------------


def lm_forward(params, cfg: ModelConfig, tokens, embeds=None):
    """tokens: (B, S) int.  Returns (logits, aux_loss)."""
    check_supported(cfg)
    if embeds is not None:
        raise NotImplementedError("embeds prefixes belong to the vlm family "
                                  "(ROADMAP.md, Queue 1 item 4)")
    B, S = tokens.shape
    x = L.embed_fwd(params["embedding"], tokens)
    pos = _positions(cfg, B, S, tokens.device)
    aux = torch.zeros((), device=x.device)
    for blk in _layers(params["blocks"], cfg.num_layers):
        x, _, a = block_fwd(blk, x, cfg, pos)
        aux = aux + a
    return _final(params, cfg, x), aux


# ---------------------------------------------------------------------------
# KV cache: init / prefill / decode.
# ---------------------------------------------------------------------------


def lm_init_cache(cfg: ModelConfig, batch: int, cache_len: int,
                  dtype=torch.bfloat16, device: str | torch.device = "cuda"):
    check_supported(cfg)
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, cache_len, cfg.num_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def lm_decode_step(params, cfg: ModelConfig, cache: dict, kv_len, token):
    """token: (B, 1) int; kv_len: existing valid cache entries (int).
    Writes the new K/V rows into ``cache`` in place.
    Returns (logits (B, vocab), cache)."""
    check_supported(cfg)
    kv_len = int(kv_len)
    B = token.shape[0]
    x = L.embed_fwd(params["embedding"], token)
    pos = _positions(cfg, B, 1, token.device, offset=kv_len)
    for i, blk in enumerate(_layers(params["blocks"], cfg.num_layers)):
        x, _, _ = block_decode(blk, x, cfg, cache["k"][i], cache["v"][i],
                               kv_len, pos)
    return _final(params, cfg, x)[:, 0], cache


def lm_prefill(params, cfg: ModelConfig, tokens, cache_len: int | None = None,
               embeds=None):
    """Run the full prompt, returning (last-token logits, filled cache).

    Each layer's K/V (returned by its block) is written straight into a
    cache of ``cache_len`` positions, zero past the prompt.
    """
    check_supported(cfg)
    if embeds is not None:
        raise NotImplementedError("embeds prefixes belong to the vlm family "
                                  "(ROADMAP.md, Queue 1 item 4)")
    B, S = tokens.shape
    cache_len = cache_len or S
    x = L.embed_fwd(params["embedding"], tokens)
    pos = _positions(cfg, B, S, tokens.device)
    shape = (cfg.num_layers, B, cache_len, cfg.num_kv_heads, cfg.hd)
    ks = torch.zeros(shape, dtype=x.dtype, device=x.device)
    vs = torch.zeros(shape, dtype=x.dtype, device=x.device)
    for i, blk in enumerate(_layers(params["blocks"], cfg.num_layers)):
        x, (k, v), _ = block_fwd(blk, x, cfg, pos)
        ks[i, :, :S] = k
        vs[i, :, :S] = v
    logits = _final(params, cfg, x[:, -1:])[:, 0]
    return logits, {"k": ks, "v": vs}


# ---------------------------------------------------------------------------
# Paged decode (DDS-style block-table serving).
# ---------------------------------------------------------------------------


def lm_init_paged_cache(cfg: ModelConfig, batch: int, max_len: int,
                        page: int = 128, dtype=torch.bfloat16,
                        device: str | torch.device = "cuda"):
    """Paged KV pool + block table per layer (the DDS file-mapping analogue:
    logical (sequence, position) -> physical pool page).

    Pool pages are allocated contiguously per sequence up front; a serving
    engine integrates `PagedKVEngine` to spill/fetch cold pages through the
    DDS store, remapping table entries as pages move.
    """
    check_supported(cfg)
    dev = resolve_device(device)
    KV, hd, Lr = cfg.num_kv_heads, cfg.hd, cfg.num_layers
    pages_per_seq = -(-max_len // page)
    npages = batch * pages_per_seq
    table = (torch.arange(npages, dtype=torch.int32, device=dev)
             .reshape(batch, pages_per_seq))
    return {
        "k_pool": torch.zeros((Lr, npages, page, KV, hd), dtype=dtype, device=dev),
        "v_pool": torch.zeros((Lr, npages, page, KV, hd), dtype=dtype, device=dev),
        "block_table": table,            # shared across layers here
        "page": page,
    }


def lm_decode_step_paged(params, cfg: ModelConfig, cache: dict, kv_len,
                         token):
    """One-token decode over the paged pool via the paged-attention op.

    kv_len: number of existing valid positions (uniform across the batch in
    this entry point).  The new K/V rows are written into the pools in
    place; returns (logits (B, vocab), cache)."""
    check_supported(cfg)
    kv_len = int(kv_len)
    B = token.shape[0]
    page = cache["page"]
    table = cache["block_table"]
    x = L.embed_fwd(params["embedding"], token)
    pos = _positions(cfg, B, 1, token.device, offset=kv_len)
    acfg = _attn_cfg(cfg)
    phys = table[:, kv_len // page].long()            # (B,) physical pages
    slot_off = kv_len % page
    seq_lens = torch.full((B,), kv_len + 1, dtype=torch.int32,
                          device=token.device)
    for i, blk in enumerate(_layers(params["blocks"], cfg.num_layers)):
        k_pool, v_pool = cache["k_pool"][i], cache["v_pool"][i]
        h = _norm1(blk, cfg, x)
        q, k_new, v_new = L._qkv(blk["attn"], h, acfg, pos)
        # Write the new token's K/V into its page (translate-then-write).
        k_pool[phys, slot_off] = k_new[:, 0].to(k_pool.dtype)
        v_pool[phys, slot_off] = v_new[:, 0].to(v_pool.dtype)
        o = paged_attention(q[:, 0].contiguous(), k_pool, v_pool, table,
                            seq_lens)
        o = o.reshape(B, 1, cfg.num_heads * cfg.hd)
        x = x + o @ blk["attn"]["wo"]
        x = x + L.mlp_fwd(blk["mlp"], _norm2(blk, cfg, x), cfg.mlp)
    return _final(params, cfg, x)[:, 0], cache
