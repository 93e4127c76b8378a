"""Decoder-only LM, the dense, MoE and vlm families, with full attention
or gemma3's local:global pattern.

Port of ``repro.models.transformer``.  Layer params are stacked on a
leading "layers" axis as in JAX; each ``lax.scan`` over them becomes a
Python loop over the same stacked tensors.  Caches are written in place:
``lm_decode_step`` and ``lm_decode_step_paged`` update the cache dict they
are given and return it, where the JAX functions return a new one.  A MoE
block (granite, dbrx) runs ``models.moe`` where a dense block runs its MLP,
and its load-balance loss is summed over the layers.

The ``local_global`` pattern (gemma3) keeps the reference's grouped tree:
``groups`` holds ``local`` (``group_size - 1`` sliding-window layers,
stacked ``(n_groups, group_size - 1, ...)``) and ``global`` (one full
attention layer, stacked ``(n_groups, ...)``), and ``tail`` the
``num_layers % group_size`` window layers left over.  Local and tail layers
keep rings of ``W = min(window, cache_len)`` slots (position p at slot
p % W), global layers the full length; it has no paged decode, as in the
reference.

The ``vlm`` family (Qwen2-VL) is the dense block with M-RoPE: positions are
(B, S, 3), one stream each for (temporal, height, width), equal for a text
token.  ``lm_forward`` and ``lm_prefill`` take an ``embeds`` prefix (B, V,
d_model), precomputed patch embeddings (the vision frontend is a stub, as
in the reference) that replace the first V token embeddings; the decode
steps take none.

Entry points:
  init_lm(cfg, generator, device)             -> (params, logical-axes tree)
  lm_forward(params, cfg, tokens, embeds, remat) -> (logits, aux)
  lm_init_cache(cfg, batch, cache_len, ...)   -> cache dict
  lm_prefill(params, cfg, tokens, ..., embeds) -> (logits, cache)
  lm_decode_step(params, cfg, cache, kv_len, token) -> (logits, cache)
  lm_init_paged_cache(cfg, batch, max_len, ...)     -> paged cache dict
  lm_decode_step_paged(params, cfg, cache, kv_len, token) -> (logits, cache)
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (along, constrain_batch,
                                              constrain_logits, like, on_mesh_of)
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models import layers as L
from repro_torch.models.moe import init_moe, moe_fwd


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a family that is not a transformer."""
    if cfg.family not in ("dense", "moe", "vlm"):
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
    """One decoder block: norm -> attn -> norm -> mlp/moe."""
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
    if cfg.family == "moe":
        mp, ma = init_moe(generator, cfg.d_model, cfg.d_ff, cfg.num_experts,
                          cfg.top_k, cfg.mlp)
        p.params["moe"], p.axes["moe"] = mp, ma
    else:
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


def _mix(params, cfg, h):
    """The block's MLP or MoE: (out, aux_loss), aux_loss None for an MLP
    (so that a dense decode step launches nothing for it)."""
    if cfg.family == "moe":
        m, aux = moe_fwd(params["moe"], h, num_experts=cfg.num_experts,
                         top_k=cfg.top_k, kind=cfg.mlp,
                         capacity_factor=cfg.capacity_factor)
        return m, aux["aux_loss"]
    return L.mlp_fwd(params["mlp"], h, cfg.mlp), None


def block_fwd(params, x, cfg: ModelConfig, positions, *,
              window=None, theta=None):
    """Full-sequence block.  Returns (x, (k, v), aux_loss)."""
    x = constrain_batch(x)  # keep activations batch-sharded (DP/FSDP)
    acfg = _attn_cfg(cfg, window=window, theta=theta)
    a, kv = L.attention_fwd(params["attn"], _norm1(params, cfg, x), acfg,
                            positions)
    x = x + a
    m, aux = _mix(params, cfg, _norm2(params, cfg, x))
    if aux is None:
        aux = torch.zeros((), device=x.device)
    return x + m, kv, aux


def block_decode(params, x, cfg: ModelConfig, k_cache, v_cache, kv_len,
                 positions, *, window=None, theta=None):
    acfg = _attn_cfg(cfg, window=window, theta=theta)
    a, k_cache, v_cache = L.attention_decode(
        params["attn"], _norm1(params, cfg, x), acfg, k_cache, v_cache,
        kv_len, positions)
    x = x + a
    m, _ = _mix(params, cfg, _norm2(params, cfg, x))
    return x + m, k_cache, v_cache


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
    generator, dev = L.init_generator(generator, device)
    params: dict[str, Any] = {}
    axes: dict[str, Any] = {}
    ep, ea = L.init_embedding(generator, cfg.padded_vocab, cfg.d_model,
                              cfg.tie_embeddings)
    params["embedding"], axes["embedding"] = ep, ea

    def init_one(g):
        return init_block(cfg, g)

    if cfg.attention == "local_global":
        gsz, n_groups, tail = _local_global_counts(cfg)

        def init_group(g):
            lp, la = L.stack_layer_params(init_one, g, gsz - 1)
            gp, ga = init_block(cfg, g)
            return {"local": lp, "global": gp}, {"local": la, "global": ga}

        gp, ga = L.stack_layer_params(init_group, generator, n_groups)
        params["groups"], axes["groups"] = gp, ga
        if tail:
            tp, ta = L.stack_layer_params(init_one, generator, tail)
            params["tail"], axes["tail"] = tp, ta
    else:
        bp, ba = L.stack_layer_params(init_one, generator, cfg.num_layers)
        params["blocks"], axes["blocks"] = bp, ba
    params["final_norm"] = torch.zeros((cfg.d_model,), dtype=torch.bfloat16,
                                       device=dev)
    axes["final_norm"] = ("embed",)
    return params, axes


def _local_global_counts(cfg: ModelConfig) -> tuple[int, int, int]:
    """(group size, groups, tail layers) of the local_global pattern."""
    n_groups = cfg.num_layers // cfg.group_size
    return cfg.group_size, n_groups, cfg.num_layers - n_groups * cfg.group_size


def _layers(params, cfg: ModelConfig):
    """Every layer in order as (params view, cache name, cache index,
    window, rope theta): what each step of the reference's scans sees.
    Full attention: ``blocks`` into ``k``/``v`` at index i.  local_global:
    each group's local layers (window, ``rope_theta``) into
    ``local_k``/``local_v`` at (g, l), then its global layer
    (``rope_theta_global``) into ``global_k``/``global_v`` at g, then the
    tail (window, the default theta) into ``tail_k``/``tail_v``."""
    if cfg.attention != "local_global":
        for i, blk in enumerate(L.layer_views(params["blocks"], cfg.num_layers)):
            yield blk, "", i, None, None
        return
    gsz, n_groups, tail = _local_global_counts(cfg)
    for g, grp in enumerate(L.layer_views(params["groups"], n_groups)):
        for l, blk in enumerate(L.layer_views(grp["local"], gsz - 1)):
            yield blk, "local_", (g, l), cfg.window, cfg.rope_theta
        yield grp["global"], "global_", g, None, cfg.rope_theta_global
    if tail:
        for t, blk in enumerate(L.layer_views(params["tail"], tail)):
            yield blk, "tail_", t, cfg.window, None


def _final(params, cfg, x):
    x = constrain_batch(x)
    x = L.rms_norm(x, params["final_norm"])
    return constrain_logits(L.unembed_fwd(params["embedding"], x))


def _embed(params, tokens, embeds=None):
    """Token embeddings, the first V replaced by ``embeds`` (B, V, d_model)
    where given (the vlm's patch prefix)."""
    x = L.embed_fwd(params["embedding"], tokens)
    if embeds is None:
        return x
    return torch.cat([embeds.to(x.dtype), x[:, embeds.shape[1]:]], dim=1)


def _positions(cfg: ModelConfig, B: int, S: int, device, offset=0):
    """(B, S) positions from ``offset``, an int or a 0-d tensor; (B, S, 3)
    with the same position on each axis for M-RoPE."""
    pos = (torch.arange(S, device=device)[None] + offset).expand(B, S)
    if cfg.mrope:
        return pos[..., None].expand(B, S, 3)
    return pos


# ---------------------------------------------------------------------------
# Training forward.
# ---------------------------------------------------------------------------


def lm_forward(params, cfg: ModelConfig, tokens, embeds=None,
               remat: bool = True):
    """tokens: (B, S) int; ``embeds``: an optional (B, V, d_model) prefix
    that replaces the first V token embeddings.  Returns (logits,
    aux_loss).

    With ``remat`` each layer body goes through ``layers.maybe_remat`` at
    ``cfg.remat``: the backward recomputes the layer from its input, so
    the forward keeps one (B, S, d_model) input a layer, as the
    reference's rematerialized scans do (the reference's unit is a scan
    step: a whole local_global group; here every layer, gemma3's local,
    global and tail layers alike, which gives the same gradients)."""
    check_supported(cfg)
    B, S = tokens.shape
    x = _embed(params, tokens, embeds)
    pos = _positions(cfg, B, S, tokens.device)
    aux = torch.zeros((), device=x.device)
    for blk, _, _, window, theta in _layers(params, cfg):
        def body(x, blk, window=window, theta=theta):
            x, _, a = block_fwd(blk, x, cfg, pos, window=window, theta=theta)
            return x, a

        if remat:
            body = L.maybe_remat(body, cfg.remat)
        x, a = body(x, blk)
        aux = aux + a
    return _final(params, cfg, x), aux


# ---------------------------------------------------------------------------
# KV cache: init / prefill / decode.
# ---------------------------------------------------------------------------


def lm_init_cache(cfg: ModelConfig, batch: int, cache_len: int,
                  dtype=torch.bfloat16, device: str | torch.device = "cuda"):
    """Zero K/V caches: ``k``/``v`` (L, B, cache_len, KV, hd) for full
    attention; for local_global ``local_*`` (n_groups, gsz - 1, B, W, KV,
    hd) and ``tail_*`` (tail, B, W, KV, hd) rings of W = min(window,
    cache_len) slots, and ``global_*`` (n_groups, B, cache_len, KV, hd)."""
    check_supported(cfg)
    dev = resolve_device(device)
    KV, hd = cfg.num_kv_heads, cfg.hd
    if cfg.attention == "local_global":
        gsz, n_groups, tail = _local_global_counts(cfg)
        W = min(cfg.window, cache_len)
        shapes = {"local_": (n_groups, gsz - 1, batch, W, KV, hd),
                  "global_": (n_groups, batch, cache_len, KV, hd)}
        if tail:
            shapes["tail_"] = (tail, batch, W, KV, hd)
    else:
        shapes = {"": (cfg.num_layers, batch, cache_len, KV, hd)}
    return {f"{kind}{name}": torch.zeros(shape, dtype=dtype, device=dev)
            for kind, shape in shapes.items() for name in ("k", "v")}


def lm_decode_step(params, cfg: ModelConfig, cache: dict, kv_len, token):
    """token: (B, 1) int; kv_len: existing valid cache entries, an int or a
    0-d int32 tensor, never read on the host (the step can be captured in a
    CUDA graph).  Writes the new K/V rows into ``cache`` in place.
    Returns (logits (B, vocab), cache)."""
    check_supported(cfg)
    kv_len = L.kv_len_tensor(kv_len, token.device)
    B = token.shape[0]
    x = L.embed_fwd(params["embedding"], token)
    pos = _positions(cfg, B, 1, token.device, offset=kv_len)
    for blk, kind, i, window, theta in _layers(params, cfg):
        with obs.span("layer"):
            x, _, _ = block_decode(blk, x, cfg, cache[f"{kind}k"][i],
                                   cache[f"{kind}v"][i], kv_len, pos,
                                   window=window, theta=theta)
    return _final(params, cfg, x)[:, 0], cache


def lm_prefill(params, cfg: ModelConfig, tokens, cache_len: int | None = None,
               embeds=None):
    """Run the full prompt, returning (last-token logits, filled cache).

    Each layer's K/V (returned by its block) is written straight into a
    cache of ``cache_len`` positions, zero past the prompt; a window
    layer's into its ring of W slots, position p at slot p % W (the
    reference's ``ring``: zero past the prompt when S <= W, else the last
    W positions rolled by S % W).  ``embeds`` (B, V, d_model), where given,
    replace the first V token embeddings, as in ``lm_forward``.
    """
    check_supported(cfg)
    B, S = tokens.shape
    cache_len = cache_len or S
    x = _embed(params, tokens, embeds)
    pos = _positions(cfg, B, S, tokens.device)
    cache = on_mesh_of(lm_init_cache(cfg, B, cache_len, dtype=x.dtype,
                                     device=x.device), x)
    for blk, kind, i, window, theta in _layers(params, cfg):
        with obs.span("layer"):
            x, kv, _ = block_fwd(blk, x, cfg, pos, window=window, theta=theta)
        for name, a in zip("kv", kv):       # outside the layer's span
            dst = cache[f"{kind}{name}"][i]
            W = dst.shape[1]
            if window is None or S <= W:
                dst[:, :S] = like(a, dst)
            else:
                dst.copy_(like(along(lambda t: t[:, -W:].roll(S % W, dims=1),
                                     a, 1), dst))
    logits = _final(params, cfg, x[:, -1:])[:, 0]
    return logits, cache


# ---------------------------------------------------------------------------
# Paged decode (DDS-style block-table serving).
# ---------------------------------------------------------------------------


def _refuse_local_global(cfg: ModelConfig) -> None:
    if cfg.attention == "local_global":
        raise NotImplementedError("paged decode targets uniform-cache archs")


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
    _refuse_local_global(cfg)
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
    this entry point), an int or a 0-d int32 tensor.  Everything that
    depends on it (the page, the slot, ``seq_lens``) is computed on the
    device, so the step can be captured in a CUDA graph; the block table's
    entries may change between replays, its shape may not.  The new K/V
    rows are written into the pools in place; returns (logits (B, vocab),
    cache)."""
    check_supported(cfg)
    _refuse_local_global(cfg)
    kv_len = L.kv_len_tensor(kv_len, token.device)
    B = token.shape[0]
    page = cache["page"]
    table = cache["block_table"]
    x = L.embed_fwd(params["embedding"], token)
    pos = _positions(cfg, B, 1, token.device, offset=kv_len)
    acfg = _attn_cfg(cfg)
    col = torch.div(kv_len, page, rounding_mode="floor").long().view(1)
    phys = table.index_select(1, col).view(B).long()  # (B,) physical pages
    slot_off = torch.remainder(kv_len, page).long().expand(B)
    seq_lens = (kv_len + 1).expand(B).contiguous()    # (B,) int32
    for i, blk in enumerate(L.layer_views(params["blocks"], cfg.num_layers)):
        with obs.span("layer"):
            k_pool, v_pool = cache["k_pool"][i], cache["v_pool"][i]
            h = _norm1(blk, cfg, x)
            q, k_new, v_new = L._qkv(blk["attn"], h, acfg, pos)
            # Write the new token's K/V into its page (translate-then-write).
            k_pool.index_put_((phys, slot_off), k_new[:, 0].to(k_pool.dtype))
            v_pool.index_put_((phys, slot_off), v_new[:, 0].to(v_pool.dtype))
            with obs.span("attend"):
                o = paged_attention(q[:, 0].contiguous(), k_pool, v_pool,
                                    table, seq_lens)
            o = o.reshape(B, 1, cfg.num_heads * cfg.hd)
            x = x + o @ blk["attn"]["wo"]
            x = x + _mix(blk, cfg, _norm2(blk, cfg, x))[0]
    return _final(params, cfg, x)[:, 0], cache
