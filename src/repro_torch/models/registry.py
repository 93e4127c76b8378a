"""Model registry: one uniform API over the ported architectures.

Port of ``repro.models.registry``.  ``build_model(cfg, device)`` returns a
:class:`ModelAPI` with the JAX package's members; ``input_specs`` returns
meta-device tensors in place of ``ShapeDtypeStruct``.  Only the dense
transformer family is ported; the others raise ``NotImplementedError``
naming their ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as TF

_NOT_PORTED = {
    "ssm": "Queue 1 item 8",
    "hybrid": "Queue 1 item 8",
    "encdec": "Queue 1 item 9",
}


def cross_entropy(logits, labels):
    """Mean token cross entropy.

    The log-sum-exp runs over the whole (padded) vocab, pad columns
    included, as in the JAX package: slicing to ``vocab_size`` first
    changes the loss.
    """
    logits = logits.float()
    m = logits.amax(-1, keepdim=True).detach()
    lse = torch.log(torch.exp(logits - m).sum(-1)) + m[..., 0]
    label_logit = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (lse - label_logit).mean()


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable          # (generator) -> (params, axes)
    forward: Callable       # (params, batch) -> (logits, aux)
    loss_fn: Callable       # (params, batch) -> (loss, metrics)
    init_cache: Callable    # (batch, cache_len) -> cache dict
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


def build_model(cfg: ModelConfig,
                device: str | torch.device = "cuda") -> ModelAPI:
    fam = cfg.family
    if fam in _NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: family {fam!r} is not ported yet "
            f"(ROADMAP.md, {_NOT_PORTED[fam]})")
    if fam not in ("dense", "moe", "vlm"):
        raise ValueError(f"unknown family {fam}")
    TF.check_supported(cfg)
    return _build_transformer(cfg, resolve_device(device))


def _build_transformer(cfg: ModelConfig, device: torch.device) -> ModelAPI:
    def forward(params, batch):
        return TF.lm_forward(params, cfg, batch["tokens"],
                             embeds=batch.get("embeds"))

    def init_cache(batch: int, cache_len: int):
        return TF.lm_init_cache(cfg, batch, cache_len, device=device)

    def prefill(params, batch, cache_len=None):
        return TF.lm_prefill(params, cfg, batch["tokens"],
                             cache_len=cache_len, embeds=batch.get("embeds"))

    def decode_step(params, cache, kv_len, token):
        return TF.lm_decode_step(params, cfg, cache, kv_len, token)

    def input_specs(shape: ShapeConfig):
        B, S = shape.global_batch, shape.seq_len
        if shape.kind in ("train", "prefill"):
            specs = {"tokens": _meta((B, S)), "labels": _meta((B, S))}
            if shape.kind == "prefill":
                specs.pop("labels")
            return specs
        # decode: one token + full cache of seq_len entries
        cshape = (cfg.num_layers, B, S + 1, cfg.num_kv_heads, cfg.hd)
        return {"token": _meta((B, 1)), "kv_len": _meta(()),
                "cache": {"k": _meta(cshape, torch.bfloat16),
                          "v": _meta(cshape, torch.bfloat16)}}

    def init(generator):
        return TF.init_lm(cfg, generator, device)

    return ModelAPI(cfg, init, forward, _loss_wrapper(forward), init_cache,
                    prefill, decode_step, input_specs, device)
