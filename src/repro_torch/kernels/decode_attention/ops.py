"""Dispatcher for dense decode attention, one query token a sequence over
the (B, S_cache, KV, hd) cache.

``route`` decides from what the call shows: contiguous bf16 or fp32 CUDA
tensors (not DTensors) that autograd does not record, with a head dim the
kernel compiles, 1..9 query heads a kv head, 16-byte aligned q and caches
and ``valid`` a 0-d int32 on their device take the hand-written kernel
(kernel.py); every other call (the CPU, a sharded model's DTensors,
gemma3_4b's head dim 320, a strided cache, a call under autograd) takes
the plain version (ref.py).  Never because a build or a launch failed.
The route checks each call once: a ``split`` call goes straight to
``kernel.launch``, past the public wrapper's own checks.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels.decode_attention.kernel import launch, rule
from repro_torch.kernels.decode_attention.ref import decode_attention_ref


def route(q, k_cache, v_cache, valid_len=None) -> str:
    """``"split"`` (the kernel) or ``"plain"`` for q (B, 1, H, hd), the
    caches (B, S_cache, KV, hd) and, when given, ``valid_len``."""
    tensors = (q, k_cache, v_cache)
    if any(isinstance(t, DTensor) or not t.is_cuda or not t.is_contiguous()
           for t in tensors):
        return "plain"
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return "plain"
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        return "plain"
    if valid_len is not None and not (
            isinstance(valid_len, torch.Tensor) and not isinstance(valid_len, DTensor)
            and valid_len.dtype == torch.int32 and valid_len.dim() == 0
            and valid_len.device == q.device):
        return "plain"
    if (q.dim() != 4 or q.shape[1] != 1 or k_cache.dim() != 4
            or v_cache.shape != k_cache.shape or k_cache.shape[0] != q.shape[0]
            or k_cache.shape[3] != q.shape[3] or k_cache.shape[1] < 1
            or k_cache.device != q.device or v_cache.device != q.device):
        return "plain"
    H, hd, KV = q.shape[2], q.shape[3], k_cache.shape[2]
    G = H // KV if KV and H % KV == 0 else 0
    return rule(q.dtype, G, hd, math.gcd(*(t.data_ptr() for t in tensors)))


def decode_attention(q, k_cache, v_cache, valid_len):
    """Attention of q (B, 1, H, hd) over positions [0, valid_len) of the
    caches -> (B, 1, H, hd) in q's dtype.  ``valid_len`` is a 0-d int32 on
    the caches' device (an int too on the plain route)."""
    if route(q, k_cache, v_cache, valid_len) == "split":
        B, _, H, hd = q.shape
        return launch(q.view(B, H, hd), k_cache, v_cache, valid_len).view(B, 1, H, hd)
    return decode_attention_ref(q, k_cache, v_cache, valid_len)
