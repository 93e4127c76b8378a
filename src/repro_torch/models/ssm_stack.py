"""RWKV6 language model stack (attention-free).

Port of ``repro.models.ssm_stack``.  Block = RWKV6 time mixing + channel
mixing (token-shifted squared-ReLU MLP).  Decode state is O(1) in sequence
length: the tuple (time-mix previous token, per-head K x V GLA state,
channel-mix previous token), each stacked over layers.  Each ``lax.scan``
over the stacked layers becomes a loop; the new state is stacked from the
layers' outputs and returned, as in JAX (nothing is written in place).

Entry points:
  init_rwkv_lm(cfg, generator, device)             -> (params, axes)
  rwkv_init_state(cfg, batch, ...)                 -> state tuple
  rwkv_forward(params, cfg, tokens, remat=True)    -> (logits, aux)
  rwkv_prefill(params, cfg, tokens)                -> (last logits, state)
  rwkv_decode_step(params, cfg, state, kv_len, token) -> (logits, state)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (constrain_batch, constrain_logits,
                                              gather_fsdp)
from repro_torch.models import layers as L
from repro_torch.models.ssm import init_rwkv6, rwkv6_fwd, token_shift


def init_channel_mix(generator, d_model: int, d_ff: int):
    p = L.ParamFactory(generator)
    p.dense("wk", (d_model, d_ff), ("embed", "ff"))
    p.dense("wv", (d_ff, d_model), ("ff", "embed"))
    p.dense("wr", (d_model, d_model), ("embed", "embed"))
    p.zeros("mix", (2, d_model), (None, "embed"))
    return p.params, p.axes


def channel_mix_fwd(params, x, prev=None):
    """Token-shifted squared-ReLU channel mix.  Returns (out, last_token)."""
    shifted = token_shift(x, prev)
    xk = x + (shifted - x) * params["mix"][0][None, None]
    xr = x + (shifted - x) * params["mix"][1][None, None]
    k = torch.square(F.relu(xk @ gather_fsdp(params["wk"], tp_dim=1)))
    out = (torch.sigmoid(xr @ gather_fsdp(params["wr"], tp_dim=1))
           * (k @ gather_fsdp(params["wv"], tp_dim=0)))
    return out, x[:, -1:]


def init_rwkv_block(cfg: ModelConfig, generator):
    p = L.ParamFactory(generator)
    tp, ta = init_rwkv6(generator, cfg.d_model, cfg.num_heads)
    p.params["time"], p.axes["time"] = tp, ta
    cp, ca = init_channel_mix(generator, cfg.d_model, cfg.d_ff)
    p.params["chan"], p.axes["chan"] = cp, ca
    p.zeros("norm1", (cfg.d_model,), ("embed",))
    p.zeros("norm2", (cfg.d_model,), ("embed",))
    return p.params, p.axes


def init_rwkv_lm(cfg: ModelConfig, generator: torch.Generator | None = None,
                 device: str | torch.device = "cuda"):
    """Native init with the JAX init's shapes, dtypes (bf16) and scales
    (not its numbers: parity tests import JAX params through interop)."""
    generator, dev = L.init_generator(generator, device)
    params, axes = {}, {}
    ep, ea = L.init_embedding(generator, cfg.padded_vocab, cfg.d_model,
                              cfg.tie_embeddings)
    params["embedding"], axes["embedding"] = ep, ea
    bp, ba = L.stack_layer_params(lambda g: init_rwkv_block(cfg, g),
                                  generator, cfg.num_layers)
    params["blocks"], axes["blocks"] = bp, ba
    params["final_norm"] = torch.zeros((cfg.d_model,), dtype=torch.bfloat16,
                                       device=dev)
    axes["final_norm"] = ("embed",)
    return params, axes


def _block(cfg, blk, x, carry, decode):
    x = constrain_batch(x)
    t_out, t_carry = rwkv6_fwd(blk["time"], L.rms_norm(x, blk["norm1"]),
                               num_heads=cfg.num_heads,
                               carry=(carry[0], carry[1]), decode=decode)
    x = x + t_out
    c_out, c_prev = channel_mix_fwd(blk["chan"], L.rms_norm(x, blk["norm2"]),
                                    prev=carry[2])
    return x + c_out, (t_carry[0], t_carry[1], c_prev)


def rwkv_init_state(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                    device: str | torch.device = "cuda"):
    dev = resolve_device(device)
    Lr, D, H, hd = cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.hd
    return (torch.zeros((Lr, batch, 1, D), dtype=dtype, device=dev),   # time-mix prev
            torch.zeros((Lr, batch, H, hd, hd), dtype=torch.float32,
                        device=dev),                                      # GLA state
            torch.zeros((Lr, batch, 1, D), dtype=dtype, device=dev))   # chan-mix prev


def _run(params, cfg, x, state, decode):
    """The layer loop: x through every block, each with its slice of
    ``state``; returns (x, new state stacked over layers)."""
    blocks = L.layer_views(params["blocks"], cfg.num_layers)
    new = []
    for i, blk in enumerate(blocks):
        x, carry = _block(cfg, blk, x, tuple(s[i] for s in state), decode)
        new.append(carry)
    return x, tuple(torch.stack(s) for s in zip(*new))


def rwkv_forward(params, cfg: ModelConfig, tokens, embeds=None,
                 remat: bool = True):
    """The training forward: (logits, aux).  With ``remat`` each block goes
    through ``layers.maybe_remat`` at ``cfg.remat``, as the reference's
    rematerialized scan body: the backward runs the block again from its
    input (a second ``gla_scan`` a layer)."""
    x = L.embed_fwd(params["embedding"], tokens)
    state = rwkv_init_state(cfg, tokens.shape[0], device=tokens.device)

    def body(x, blk, *carry):
        return _block(cfg, blk, x, carry, decode=False)[0]

    if remat:
        body = L.maybe_remat(body, cfg.remat)
    for i, blk in enumerate(L.layer_views(params["blocks"], cfg.num_layers)):
        x = body(x, blk, *(s[i] for s in state))
    x = constrain_batch(L.rms_norm(x, params["final_norm"]))
    return (constrain_logits(L.unembed_fwd(params["embedding"], x)),
            torch.zeros((), device=x.device))


def rwkv_prefill(params, cfg: ModelConfig, tokens, embeds=None):
    x = L.embed_fwd(params["embedding"], tokens)
    state = rwkv_init_state(cfg, tokens.shape[0], device=tokens.device)
    x, new_state = _run(params, cfg, x, state, decode=False)
    x = L.rms_norm(x, params["final_norm"])
    return L.unembed_fwd(params["embedding"], x[:, -1:])[:, 0], new_state


def rwkv_decode_step(params, cfg: ModelConfig, state, kv_len, token,
                     embeds=None):
    """One token through the recurrence; ``kv_len`` is unused (the state
    carries the position), as in JAX.  Returns (logits (B, vocab), new
    state); nothing is read on the host, so the step can be captured."""
    x = L.embed_fwd(params["embedding"], token)
    x, new_state = _run(params, cfg, x, state, decode=True)
    x = L.rms_norm(x, params["final_norm"])
    return L.unembed_fwd(params["embedding"], x)[:, 0], new_state
