"""Zamba2-style hybrid stack: Mamba2 backbone + ONE shared attention block.

Port of ``repro.models.hybrid``.  Structure (arXiv:2411.15242):
``num_layers`` Mamba2 blocks; after every ``attn_every`` blocks, a SINGLE
shared transformer block (attention + MLP, parameters reused at every
application) refreshes global context.  Params keep the JAX nesting: groups
of ``attn_every`` Mamba blocks stacked ``(n_groups, attn_every, ...)``, plus
a Mamba-only ``tail`` when ``num_layers % attn_every != 0``.

Decode state: per-Mamba-layer (conv tail, GLA state), O(1) in sequence,
plus one KV cache per shared-attention application (n_groups caches).
Prefill runs ``gla_scan`` once per Mamba layer and the flash kernel once
per group.  The attention caches are written in place by decode (as
``layers.attention_decode`` does); the Mamba carries are stacked anew.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import along, constrain_batch, constrain_logits
from repro_torch.models import layers as L
from repro_torch.models.ssm import CONV_K, init_mamba2, mamba2_fwd


def _attn_cfg(cfg: ModelConfig) -> L.AttnConfig:
    return L.AttnConfig(d_model=cfg.d_model, num_heads=cfg.num_heads,
                        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.hd,
                        rope_theta=cfg.rope_theta, causal=True)


def _split_layers(cfg: ModelConfig) -> tuple[int, int]:
    n_groups = cfg.num_layers // cfg.attn_every
    return n_groups, cfg.num_layers - n_groups * cfg.attn_every


def init_mamba_block(cfg: ModelConfig, generator):
    p = L.ParamFactory(generator)
    mp, ma = init_mamba2(generator, cfg.d_model, cfg.ssm_state,
                         cfg.ssm_heads, expand=cfg.ssm_expand)
    p.params["mamba"], p.axes["mamba"] = mp, ma
    p.zeros("norm", (cfg.d_model,), ("embed",))
    return p.params, p.axes


def init_shared_attn(cfg: ModelConfig, generator):
    p = L.ParamFactory(generator)
    ap, aa = L.init_attention(generator, _attn_cfg(cfg))
    p.params["attn"], p.axes["attn"] = ap, aa
    mp, ma = L.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.mlp)
    p.params["mlp"], p.axes["mlp"] = mp, ma
    p.zeros("norm1", (cfg.d_model,), ("embed",))
    p.zeros("norm2", (cfg.d_model,), ("embed",))
    return p.params, p.axes


def init_hybrid_lm(cfg: ModelConfig, generator: torch.Generator | None = None,
                   device: str | torch.device = "cuda"):
    """Native init with the JAX init's shapes, dtypes and nesting."""
    generator, dev = L.init_generator(generator, device)
    params, axes = {}, {}
    ep, ea = L.init_embedding(generator, cfg.padded_vocab, cfg.d_model,
                              cfg.tie_embeddings)
    params["embedding"], axes["embedding"] = ep, ea
    n_groups, tail = _split_layers(cfg)

    def init_group(g):
        return L.stack_layer_params(lambda gg: init_mamba_block(cfg, gg), g,
                                    cfg.attn_every)

    gp, ga = L.stack_layer_params(init_group, generator, n_groups)
    params["groups"], axes["groups"] = gp, ga
    sp, sa = init_shared_attn(cfg, generator)  # ONE shared block (reused)
    params["shared_attn"], axes["shared_attn"] = sp, sa
    if tail:
        tp, ta = L.stack_layer_params(lambda g: init_mamba_block(cfg, g),
                                      generator, tail)
        params["tail"], axes["tail"] = tp, ta
    params["final_norm"] = torch.zeros((cfg.d_model,), dtype=torch.bfloat16,
                                       device=dev)
    axes["final_norm"] = ("embed",)
    return params, axes


def hybrid_state(cfg: ModelConfig, batch: int, cache_len: int,
                 dtype=torch.bfloat16, device: str | torch.device = "cuda"):
    """(mamba carries per layer, shared-attn KV caches per application)."""
    dev = resolve_device(device)
    n_groups, tail = _split_layers(cfg)
    d_inner = cfg.ssm_expand * cfg.d_model
    hd_m = d_inner // cfg.ssm_heads

    def conv(*lead):
        return torch.zeros((*lead, batch, CONV_K - 1, d_inner), dtype=dtype,
                           device=dev)

    def gla(*lead):
        return torch.zeros((*lead, batch, cfg.ssm_heads, cfg.ssm_state, hd_m),
                           dtype=torch.float32, device=dev)

    kv = (n_groups, batch, cache_len, cfg.num_kv_heads, cfg.hd)
    state = {
        "groups_conv": conv(n_groups, cfg.attn_every),
        "groups_gla": gla(n_groups, cfg.attn_every),
        "attn_k": torch.zeros(kv, dtype=dtype, device=dev),
        "attn_v": torch.zeros(kv, dtype=dtype, device=dev),
    }
    if tail:
        state["tail_conv"], state["tail_gla"] = conv(tail), gla(tail)
    return state


def _mamba_block(cfg, blk, x, carry, decode):
    x = constrain_batch(x)
    out, new_carry = mamba2_fwd(blk["mamba"], L.rms_norm(x, blk["norm"]),
                                state=cfg.ssm_state, num_heads=cfg.ssm_heads,
                                carry=carry, decode=decode)
    return x + out, new_carry


def _mamba_stack(cfg, blocks, n, x, conv=None, gla=None, decode=False):
    """x through the ``n`` stacked Mamba blocks; returns (x, (conv tails,
    GLA states) stacked over them)."""
    carries = []
    for i, blk in enumerate(L.layer_views(blocks, n)):
        carry = (conv[i], gla[i]) if conv is not None else None
        x, c = _mamba_block(cfg, blk, x, carry, decode)
        carries.append(c)
    return x, (torch.stack([c[0] for c in carries]),
               torch.stack([c[1] for c in carries]))


def _shared_attn_fwd(cfg, sp, x, pos):
    x = constrain_batch(x)
    a, kv = L.attention_fwd(sp["attn"], L.rms_norm(x, sp["norm1"]),
                            _attn_cfg(cfg), pos)
    x = x + a
    m = L.mlp_fwd(sp["mlp"], L.rms_norm(x, sp["norm2"]), cfg.mlp)
    return x + m, kv


def _shared_attn_decode(cfg, sp, x, kc, vc, kv_len, pos):
    a, kc, vc = L.attention_decode(sp["attn"], L.rms_norm(x, sp["norm1"]),
                                   _attn_cfg(cfg), kc, vc, kv_len, pos)
    x = x + a
    m = L.mlp_fwd(sp["mlp"], L.rms_norm(x, sp["norm2"]), cfg.mlp)
    return x + m, kc, vc


def _groups(params, cfg):
    n_groups, _ = _split_layers(cfg)
    return L.layer_views(params["groups"], n_groups)


def hybrid_forward(params, cfg: ModelConfig, tokens, embeds=None,
                   remat: bool = True):
    """The training forward: (logits, aux).  With ``remat`` each group (its
    Mamba blocks and the shared attention block) goes through
    ``layers.maybe_remat`` at ``cfg.remat`` and the tail does not, as in
    the reference."""
    B, S = tokens.shape
    x = L.embed_fwd(params["embedding"], tokens)
    pos = torch.arange(S, device=tokens.device)[None].expand(B, S)

    def group_body(x, grp, sp):
        x, _ = _mamba_stack(cfg, grp, cfg.attn_every, x)
        return _shared_attn_fwd(cfg, sp, x, pos)[0]

    if remat:
        group_body = L.maybe_remat(group_body, cfg.remat)
    for grp in _groups(params, cfg):
        x = group_body(x, grp, params["shared_attn"])
    if "tail" in params:
        x, _ = _mamba_stack(cfg, params["tail"], _split_layers(cfg)[1], x)
    x = L.rms_norm(x, params["final_norm"])
    return (constrain_logits(L.unembed_fwd(params["embedding"], x)),
            torch.zeros((), device=x.device))


def hybrid_prefill(params, cfg: ModelConfig, tokens, cache_len=None,
                   embeds=None):
    B, S = tokens.shape
    cache_len = cache_len or S
    x = L.embed_fwd(params["embedding"], tokens)
    pos = torch.arange(S, device=tokens.device)[None].expand(B, S)
    sp = params["shared_attn"]
    convs, glas, ks, vs = [], [], [], []
    for grp in _groups(params, cfg):
        x, (conv, gla) = _mamba_stack(cfg, grp, cfg.attn_every, x)
        x, (k, v) = _shared_attn_fwd(cfg, sp, x, pos)
        pad = (0, 0, 0, 0, 0, max(cache_len - S, 0))
        convs.append(conv)
        glas.append(gla)
        ks.append(along(lambda t: F.pad(t, pad), k, 1))
        vs.append(along(lambda t: F.pad(t, pad), v, 1))
    state = {"groups_conv": torch.stack(convs), "groups_gla": torch.stack(glas),
             "attn_k": torch.stack(ks), "attn_v": torch.stack(vs)}
    if "tail" in params:
        x, (state["tail_conv"], state["tail_gla"]) = _mamba_stack(
            cfg, params["tail"], _split_layers(cfg)[1], x)
    x = L.rms_norm(x, params["final_norm"])
    logits = L.unembed_fwd(params["embedding"], x[:, -1:])[:, 0]
    return logits, state


def hybrid_decode_step(params, cfg: ModelConfig, state, kv_len, token,
                       embeds=None):
    """Writes the new K/V rows into ``state``'s attention caches in place;
    returns (logits (B, vocab), new state).  ``kv_len`` is an int or a 0-d
    int32 tensor, never read on the host."""
    kv_len = L.kv_len_tensor(kv_len, token.device)
    B = token.shape[0]
    x = L.embed_fwd(params["embedding"], token)
    pos = kv_len.view(1, 1).expand(B, 1)
    sp = params["shared_attn"]
    convs, glas = [], []
    for g, grp in enumerate(_groups(params, cfg)):
        x, (conv, gla) = _mamba_stack(cfg, grp, cfg.attn_every, x,
                                      state["groups_conv"][g],
                                      state["groups_gla"][g], decode=True)
        x, _, _ = _shared_attn_decode(cfg, sp, x, state["attn_k"][g],
                                      state["attn_v"][g], kv_len, pos)
        convs.append(conv)
        glas.append(gla)
    new = dict(state, groups_conv=torch.stack(convs),
               groups_gla=torch.stack(glas))
    if "tail" in params:
        x, (new["tail_conv"], new["tail_gla"]) = _mamba_stack(
            cfg, params["tail"], _split_layers(cfg)[1], x, state["tail_conv"],
            state["tail_gla"], decode=True)
    x = L.rms_norm(x, params["final_norm"])
    return L.unembed_fwd(params["embedding"], x)[:, 0], new
