"""Plain PyTorch oracle for flash attention (naive full materialization).

Semantics: GQA scaled dot-product attention with optional causal masking and
optional sliding window (a query at position i attends to keys in
``[i - window + 1, i]`` when causal, plus the mask).  fp32 softmax.

Shapes:
  q: (B, Sq, Hq, D)   k, v: (B, Sk, Hkv, D)   with Hq % Hkv == 0
  returns (B, Sq, Hq, D) in q.dtype
"""

from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal: bool = True, window: int | None = None,
                  q_offset: int | None = None, scale: float | None = None):
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    assert Hq % Hkv == 0
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    if q_offset is None:
        q_offset = Sk - Sq  # decode: queries are the trailing positions
    qf = q.float() * scale
    # expand kv heads to query heads
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = torch.where(mask[None, None], logits,
                         torch.full_like(logits, -1e30))
    probs = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = probs / (probs.sum(-1, keepdim=True) + 1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vf)
    return out.to(q.dtype)
