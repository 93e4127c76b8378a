"""Encoder-decoder backbone (SeamlessM4T-medium).

Port of ``repro.models.encdec``, with its names and its param tree.  Each
``lax.scan`` over the stacked layers becomes a loop over
``layers.layer_views``.  The decode step writes its self-attention K/V
into the cache in place and returns the same dict, as
``transformer.lm_decode_step`` does; ``kv_len`` is never read on the host,
so a CUDA graph can capture the step.

Encoder: bidirectional attention blocks (RoPE at positions 0..S-1) over
audio-frame embeddings; the modality frontend is a stub, the frames
``(B, S_enc, d_model)`` are given.  Decoder: causal self-attention,
cross-attention to the encoder states (no RoPE, through the flash
dispatcher with ``causal=False``, so a CUDA tensor takes the flash
kernel at ``Sq != Sk``), MLP.  The final norm is ``rms_norm`` with
``(1 + w)`` and ``w`` initialised to zeros, as in the reference, although
the config says ``norm="ln"``.

Frames are rounded to bf16 whatever the params' dtype, as in the
reference.  With fp32 params the reference's ``encode`` raises (the first
residual add promotes its ``lax.scan`` carry from bf16 to fp32); the port
carries on in fp32 from there, casting each block's normed input to the
weights' dtype where JAX would promote it.  That fault of the reference is
not copied (ROADMAP.md, Queue 3).

With ``remat`` (the default of ``encode``, ``dec_forward`` and
``encdec_forward``, as in the reference) each layer body goes through
``layers.maybe_remat`` at ``cfg.remat``: the backward recomputes the layer
from its input, the decoder's cross K/V projections included.  Prefill
encodes without it, as the reference's does.

Entry points:
  init_encdec(cfg, generator, device)                   -> (params, axes)
  encode(params, cfg, frames, remat)                    -> encoder states
  dec_forward(params, cfg, tokens, enc_states, remat)   -> logits
  encdec_forward(params, cfg, tokens, frames, remat)    -> (logits, aux = 0)
  encdec_init_cache(cfg, batch, cache_len, enc_len, ...) -> cache dict
  encdec_prefill(params, cfg, tokens, frames, cache_len) -> (logits, cache)
  encdec_decode_step(params, cfg, cache, kv_len, token)  -> (logits, cache)
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (constrain_batch, constrain_logits,
                                              like, on_mesh_of, split_heads)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as L


def _self_cfg(cfg: ModelConfig, causal: bool) -> L.AttnConfig:
    return L.AttnConfig(d_model=cfg.d_model, num_heads=cfg.num_heads,
                        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.hd,
                        rope_theta=cfg.rope_theta, causal=causal)


def init_enc_block(cfg: ModelConfig, generator) -> tuple[dict, dict]:
    p = L.ParamFactory(generator)
    ap, aa = L.init_attention(generator, _self_cfg(cfg, False))
    p.params["attn"], p.axes["attn"] = ap, aa
    mp, ma = L.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.mlp)
    p.params["mlp"], p.axes["mlp"] = mp, ma
    for n in ("norm1", "norm2"):
        p.ones(f"{n}_w", (cfg.d_model,), ("embed",))
        p.zeros(f"{n}_b", (cfg.d_model,), ("embed",))
    return p.params, p.axes


def init_dec_block(cfg: ModelConfig, generator) -> tuple[dict, dict]:
    p = L.ParamFactory(generator)
    ap, aa = L.init_attention(generator, _self_cfg(cfg, True))
    p.params["self_attn"], p.axes["self_attn"] = ap, aa
    cp, ca = L.init_attention(generator, _self_cfg(cfg, False))
    p.params["cross_attn"], p.axes["cross_attn"] = cp, ca
    mp, ma = L.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.mlp)
    p.params["mlp"], p.axes["mlp"] = mp, ma
    for n in ("norm1", "norm2", "norm3"):
        p.ones(f"{n}_w", (cfg.d_model,), ("embed",))
        p.zeros(f"{n}_b", (cfg.d_model,), ("embed",))
    return p.params, p.axes


def init_encdec(cfg: ModelConfig, generator: torch.Generator | None = None,
                device: str | torch.device = "cuda") -> tuple[dict, dict]:
    """Native init with the JAX init's shapes, dtypes (bf16) and scales;
    ``generator`` as in ``transformer.init_lm``."""
    generator, dev = L.init_generator(generator, device)
    params, axes = {}, {}
    ep, ea = L.init_embedding(generator, cfg.padded_vocab, cfg.d_model,
                              cfg.tie_embeddings)
    params["embedding"], axes["embedding"] = ep, ea
    bp, ba = L.stack_layer_params(lambda g: init_enc_block(cfg, g), generator,
                                  cfg.encoder_layers)
    params["encoder"], axes["encoder"] = bp, ba
    dp, da = L.stack_layer_params(lambda g: init_dec_block(cfg, g), generator,
                                  cfg.decoder_layers)
    params["decoder"], axes["decoder"] = dp, da
    params["final_norm"] = torch.zeros((cfg.d_model,), dtype=torch.bfloat16,
                                       device=dev)
    axes["final_norm"] = ("embed",)
    return params, axes


def _ln(p, n, x):
    """Block norm ``n`` of ``x``, in the dtype of the block's weights: the
    norm keeps ``x``'s dtype (bf16 for the encoder's first block, whose
    input is the rounded frames), and JAX promotes it in the product with
    fp32 weights."""
    return L.layer_norm(x, p[f"{n}_w"], p[f"{n}_b"]).to(p[f"{n}_w"].dtype)


def _positions(B: int, S: int, device, offset=0):
    return (torch.arange(S, device=device)[None] + offset).expand(B, S)


def encode(params, cfg: ModelConfig, frames, remat: bool = True):
    """frames: (B, S_enc, d_model) stub embeddings -> encoder states."""
    B, S, _ = frames.shape
    pos = _positions(B, S, frames.device)
    x = frames.to(torch.bfloat16)
    acfg = _self_cfg(cfg, False)

    def body(x, blk):
        x = constrain_batch(x)
        a, _ = L.attention_fwd(blk["attn"], _ln(blk, "norm1", x), acfg, pos)
        x = x + a
        return x + L.mlp_fwd(blk["mlp"], _ln(blk, "norm2", x), cfg.mlp)

    if remat:
        body = L.maybe_remat(body, cfg.remat)
    for blk in L.layer_views(params["encoder"], cfg.encoder_layers):
        x = body(x, blk)
    return x


def _cross_kv(blk, cfg: ModelConfig, enc_states):
    """Cross-attention K/V of one layer from the encoder states."""
    B, S, _ = enc_states.shape
    KV, hd = cfg.num_kv_heads, cfg.hd
    k = split_heads(enc_states @ blk["cross_attn"]["wk"], B, S, KV, hd)
    v = split_heads(enc_states @ blk["cross_attn"]["wv"], B, S, KV, hd)
    return k, v


def _cross_attend(blk, cfg: ModelConfig, x, ck, cv):
    """Query x against fixed cross K/V (no RoPE).  ``ck``/``cv`` must be
    contiguous and 16-byte aligned for the kernel: a layer's slice of the
    cache is."""
    B, S, _ = x.shape
    H, hd = cfg.num_heads, cfg.hd
    q = split_heads(x @ blk["cross_attn"]["wq"], B, S, H, hd)
    o = flash_attention(q, ck, cv, causal=False, q_offset=0)
    return o.reshape(B, S, H * hd) @ blk["cross_attn"]["wo"]


def _dec_block(blk, cfg: ModelConfig, x, pos, ck, cv):
    """One decoder block over a full sequence; returns (x, (k, v))."""
    a, kv = L.attention_fwd(blk["self_attn"], _ln(blk, "norm1", x),
                            _self_cfg(cfg, True), pos)
    x = x + a
    x = x + _cross_attend(blk, cfg, _ln(blk, "norm2", x), ck, cv)
    return x + L.mlp_fwd(blk["mlp"], _ln(blk, "norm3", x), cfg.mlp), kv


def _final(params, x):
    return L.unembed_fwd(params["embedding"],
                         L.rms_norm(x, params["final_norm"]))


def dec_forward(params, cfg: ModelConfig, tokens, enc_states,
                remat: bool = True):
    """Teacher-forced decoder over the full target sequence -> logits."""
    B, S = tokens.shape
    pos = _positions(B, S, tokens.device)
    x = L.embed_fwd(params["embedding"], tokens)

    def body(x, blk):
        x = constrain_batch(x)
        ck, cv = _cross_kv(blk, cfg, enc_states)
        return _dec_block(blk, cfg, x, pos, ck, cv)[0]

    if remat:
        body = L.maybe_remat(body, cfg.remat)
    for blk in L.layer_views(params["decoder"], cfg.decoder_layers):
        x = body(x, blk)
    x = constrain_batch(L.rms_norm(x, params["final_norm"]))
    return constrain_logits(L.unembed_fwd(params["embedding"], x))


def encdec_forward(params, cfg: ModelConfig, tokens, frames,
                   remat: bool = True):
    """The training forward: returns (logits, aux = 0.0)."""
    logits = dec_forward(params, cfg, tokens, encode(params, cfg, frames, remat),
                         remat)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def encdec_init_cache(cfg: ModelConfig, batch: int, cache_len: int,
                      enc_len: int, dtype=torch.bfloat16,
                      device: str | torch.device = "cuda"):
    dev = resolve_device(device)
    Ld, KV, hd = cfg.decoder_layers, cfg.num_kv_heads, cfg.hd

    def zeros(n):
        return torch.zeros((Ld, batch, n, KV, hd), dtype=dtype, device=dev)

    return {"k": zeros(cache_len), "v": zeros(cache_len),
            "cross_k": zeros(enc_len), "cross_v": zeros(enc_len)}


def encdec_prefill(params, cfg: ModelConfig, tokens, frames,
                   cache_len: int | None = None):
    """Encode the source and prefill the decoder prompt.  Returns (logits
    of the last position, cache): self K/V over ``cache_len`` positions,
    zero past the prompt; cross K/V over the frames' length."""
    enc = encode(params, cfg, frames, remat=False)
    B, S = tokens.shape
    cache_len = cache_len or S
    pos = _positions(B, S, tokens.device)
    x = L.embed_fwd(params["embedding"], tokens)
    cache = on_mesh_of(encdec_init_cache(cfg, B, cache_len, enc.shape[1],
                                         dtype=x.dtype, device=x.device), x)
    for i, blk in enumerate(L.layer_views(params["decoder"],
                                          cfg.decoder_layers)):
        ck, cv = _cross_kv(blk, cfg, enc)
        x, (k, v) = _dec_block(blk, cfg, x, pos, ck, cv)
        cache["k"][i, :, :S] = like(k, cache["k"])
        cache["v"][i, :, :S] = like(v, cache["v"])
        cache["cross_k"][i] = like(ck, cache["cross_k"])
        cache["cross_v"][i] = like(cv, cache["cross_v"])
    return _final(params, x[:, -1:])[:, 0], cache


def encdec_decode_step(params, cfg: ModelConfig, cache: dict, kv_len, token):
    """token: (B, 1) int; kv_len: valid self-attention entries, an int or a
    0-d int32 tensor, never read on the host.  Writes the new K/V rows into
    ``cache`` in place.  Returns (logits (B, vocab), cache)."""
    kv_len = L.kv_len_tensor(kv_len, token.device)
    B = token.shape[0]
    x = L.embed_fwd(params["embedding"], token)
    pos = _positions(B, 1, token.device, offset=kv_len)
    acfg = _self_cfg(cfg, True)
    for i, blk in enumerate(L.layer_views(params["decoder"],
                                          cfg.decoder_layers)):
        a, _, _ = L.attention_decode(blk["self_attn"], _ln(blk, "norm1", x),
                                     acfg, cache["k"][i], cache["v"][i],
                                     kv_len, pos)
        x = x + a
        x = x + _cross_attend(blk, cfg, _ln(blk, "norm2", x),
                              cache["cross_k"][i], cache["cross_v"][i])
        x = x + L.mlp_fwd(blk["mlp"], _ln(blk, "norm3", x), cfg.mlp)
    return _final(params, x)[:, 0], cache
