"""Model registry: one uniform API over the ported architectures.

Port of ``repro.models.registry``.  ``build_model(cfg, device)`` returns a
:class:`ModelAPI` with the JAX package's members; ``input_specs`` returns
meta-device tensors in place of ``ShapeDtypeStruct``.  Ported: the dense
and MoE transformer (whose ``loss_fn`` adds 0.01 x the summed load-balance
loss, as the JAX package's), with full attention or gemma3's local:global
pattern (its nested ``groups``/``tail`` params and ring caches), vlm
(Qwen2-VL: M-RoPE, and train and prefill batches carry a bf16 ``embeds``
prefix of ``min(VLM_PATCH_TOKENS, seq_len // 4)`` patch embeddings, a stub
of the vision frontend as in the reference; decode takes none), ssm
(RWKV6), hybrid (Zamba2) and encdec (SeamlessM4T: batches carry
``frames``, and ``init_cache`` takes an ``enc_len`` that defaults to
``cache_len``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import replicate_dim, take_last
from repro_torch.models import encdec as ED
from repro_torch.models import hybrid as HY
from repro_torch.models import ssm_stack as SS
from repro_torch.models import transformer as TF

DEC_PREFILL_FRAC = 8   # encdec prefill specs: a decoder prompt of seq_len / 8
VLM_PATCH_TOKENS = 1024    # stub vision prefix length, as the reference's


def cross_entropy(logits, labels):
    """Mean token cross entropy.

    The log-sum-exp runs over the whole (padded) vocab, pad columns
    included, as in the JAX package: slicing to ``vocab_size`` first
    changes the loss.  Sharded logits (a DTensor) are gathered whole over
    the vocab first (``replicate_dim``; an identity on a plain tensor):
    the gradient of a log-sum-exp over a vocab-sharded dim, averaged over
    a batch-sharded one, is wrong in some torch releases (2.11).  The
    label gather is ``sharding.take_last``.
    """
    logits = replicate_dim(logits.float(), -1)
    m = logits.amax(-1, keepdim=True).detach()
    lse = torch.log(torch.exp(logits - m).sum(-1)) + m[..., 0]
    label_logit = take_last(logits, labels.long())
    return (lse - label_logit).mean()


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable          # (generator) -> (params, axes)
    forward: Callable       # (params, batch) -> (logits, aux)
    loss_fn: Callable       # (params, batch) -> (loss, metrics)
    init_cache: Callable    # (batch, cache_len[, enc_len]) -> cache dict
    prefill: Callable       # (params, batch) -> (logits, cache)
    decode_step: Callable   # (params, cache, kv_len, token) -> (logits, cache)
    input_specs: Callable   # (ShapeConfig) -> dict of meta tensors
    device: torch.device


def _loss_wrapper(forward, moe_aux_weight=0.01):
    def loss_fn(params, batch):
        logits, aux = forward(params, batch)
        loss = cross_entropy(logits, batch["labels"])
        total = loss + moe_aux_weight * aux
        return total, {"xent": loss, "aux": aux}
    return loss_fn


def _meta(shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _token_specs(shape: ShapeConfig, cfg: ModelConfig | None = None) -> dict:
    """Tokens (and labels to train); for the vlm family also the bf16
    ``embeds`` prefix of ``min(VLM_PATCH_TOKENS, S // 4)`` rows."""
    B, S = shape.global_batch, shape.seq_len
    specs = {"tokens": _meta((B, S)), "labels": _meta((B, S))}
    if cfg is not None and cfg.family == "vlm":
        specs["embeds"] = _meta((B, min(VLM_PATCH_TOKENS, S // 4), cfg.d_model),
                                torch.bfloat16)
    if shape.kind == "prefill":
        specs.pop("labels")
    return specs


def _decode_specs(batch: int, cache) -> dict:
    """One token, the ``kv_len`` scalar and the cache, as meta tensors."""
    return {"token": _meta((batch, 1)), "kv_len": _meta(()), "cache": cache}


def _encdec_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The reference's encdec shapes: bf16 frames (B, S, d) beside the
    tokens; a decoder prompt of S / 8 at prefill; a decode cache of S + 1
    positions over S frames."""
    B, S = shape.global_batch, shape.seq_len
    frames = _meta((B, S, cfg.d_model), torch.bfloat16)
    if shape.kind == "train":
        return {**_token_specs(shape), "frames": frames}
    if shape.kind == "prefill":
        return {"tokens": _meta((B, max(1, S // DEC_PREFILL_FRAC))),
                "frames": frames}
    return _decode_specs(B, ED.encdec_init_cache(cfg, B, S + 1, S,
                                                 device="meta"))


@dataclasses.dataclass(frozen=True)
class _Family:
    """What a family supplies; :func:`build_model` binds cfg and device."""
    forward: Callable       # (params, cfg, batch) -> (logits, aux)
    prefill: Callable       # (params, cfg, batch, cache_len) -> (logits, cache)
    decode_step: Callable   # (params, cfg, cache, kv_len, token) -> (logits, cache)
    state: Callable         # (cfg, batch, cache_len, device[, enc_len]) -> cache
    init: Callable          # (cfg, generator, device) -> (params, axes)


_DENSE = _Family(
    lambda p, cfg, b: TF.lm_forward(p, cfg, b["tokens"], embeds=b.get("embeds")),
    lambda p, cfg, b, n: TF.lm_prefill(p, cfg, b["tokens"], cache_len=n,
                                       embeds=b.get("embeds")),
    TF.lm_decode_step,
    lambda cfg, B, n, device: TF.lm_init_cache(cfg, B, n, device=device),
    TF.init_lm)

_FAMILIES = {
    "dense": _DENSE, "moe": _DENSE, "vlm": _DENSE,
    "ssm": _Family(   # RWKV6: O(1) state, so no cache_len
        lambda p, cfg, b: SS.rwkv_forward(p, cfg, b["tokens"]),
        lambda p, cfg, b, n: SS.rwkv_prefill(p, cfg, b["tokens"]),
        SS.rwkv_decode_step,
        lambda cfg, B, n, device: SS.rwkv_init_state(cfg, B, device=device),
        SS.init_rwkv_lm),
    "hybrid": _Family(
        lambda p, cfg, b: HY.hybrid_forward(p, cfg, b["tokens"]),
        lambda p, cfg, b, n: HY.hybrid_prefill(p, cfg, b["tokens"], cache_len=n),
        HY.hybrid_decode_step,
        lambda cfg, B, n, device: HY.hybrid_state(cfg, B, n, device=device),
        HY.init_hybrid_lm),
    "encdec": _Family(
        lambda p, cfg, b: ED.encdec_forward(p, cfg, b["tokens"], b["frames"]),
        lambda p, cfg, b, n: ED.encdec_prefill(p, cfg, b["tokens"],
                                               b["frames"], cache_len=n),
        ED.encdec_decode_step,
        lambda cfg, B, n, device, enc_len=None: ED.encdec_init_cache(
            cfg, B, n, enc_len or n, device=device),
        ED.init_encdec),
}


def build_model(cfg: ModelConfig,
                device: str | torch.device = "cuda") -> ModelAPI:
    fam = cfg.family
    if fam not in _FAMILIES:
        raise ValueError(f"unknown family {fam}")
    f = _FAMILIES[fam]
    if f is _DENSE:
        TF.check_supported(cfg)
    device = resolve_device(device)

    def forward(params, batch):
        return f.forward(params, cfg, batch)

    def init_cache(batch: int, cache_len: int, enc_len: int | None = None):
        extra = () if enc_len is None else (enc_len,)   # encdec only
        return f.state(cfg, batch, cache_len, device, *extra)

    def prefill(params, batch, cache_len=None):
        return f.prefill(params, cfg, batch, cache_len)

    def decode_step(params, cache, kv_len, token):
        return f.decode_step(params, cfg, cache, kv_len, token)

    def input_specs(shape: ShapeConfig):
        if fam == "encdec":
            return _encdec_specs(cfg, shape)
        if shape.kind in ("train", "prefill"):
            return _token_specs(shape, cfg)
        # decode: one token and the state of a seq_len + 1 cache
        B = shape.global_batch
        return _decode_specs(B, f.state(cfg, B, shape.seq_len + 1, "meta"))

    def init(generator):
        return f.init(cfg, generator, device)

    return ModelAPI(cfg, init, forward, _loss_wrapper(forward), init_cache,
                    prefill, decode_step, input_specs, device)
