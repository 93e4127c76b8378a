"""Int8 error-feedback gradient compression for the cross-pod all-reduce.

Port of ``repro.optim.compression``: each gradient leaf plus its residual
is quantized to int8 with one fp32 scale per tensor (max |x| / 127, round
half to even); the residual of each round is carried to the next, so the
accumulated dequantized sum tracks the true one.  On one device the train
step compresses and decompresses in place of the exchange; the wire-level
exchange across pods is ``train.loop.make_compressed_pod_train_fn``'s.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import leaves, tree_map


class CompressionState(NamedTuple):
    error: Any  # per-leaf fp32 residual feedback


def init_compression(params: Any) -> CompressionState:
    return CompressionState(error=tree_map(
        lambda p: torch.zeros_like(p, dtype=torch.float32), params))


def _quantize(x: torch.Tensor, amax: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 payload, fp32 scale) of ``x``; ``amax`` is max |x| over the
    whole tensor where ``x`` is one shard of it (default: ``x``'s own)."""
    amax = x.abs().amax() if amax is None else amax
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


@torch.no_grad()
def compress_tree(grads: Any, state: CompressionState
                  ) -> tuple[Any, Any, CompressionState]:
    """Returns (int8 tree, scale tree, new state with residuals)."""
    def one(g, e):
        x = g.float() + e
        q, s = _quantize(x)
        return q, s, x - _dequantize(q, s)   # error feedback residual

    out = tree_map(one, grads, state.error)
    q, scales, errs = (tree_map(lambda _, o: o[i], grads, out) for i in range(3))
    return q, scales, CompressionState(errs)


@torch.no_grad()
def decompress_tree(qtree: Any, scales: Any) -> Any:
    return tree_map(_dequantize, qtree, scales)


def compressed_ratio(grads: Any) -> float:
    """Bytes saved: int8+scale vs fp32 payload."""
    total = sum(g.numel() * 4 for g in leaves(grads))
    comp = sum(g.numel() + 4 for g in leaves(grads))
    return comp / total
