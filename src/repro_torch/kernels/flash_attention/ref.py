"""Plain PyTorch oracles for flash attention and its backward (naive full
materialization).

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


def attention_bwd_ref(q, k, v, o, do, *, causal: bool = True,
                      window: int | None = None, q_offset: int | None = None,
                      scale: float | None = None):
    """(dq, dk, dv) of ``attention_ref``, the plain version of the backward
    kernel, in fp32 and cast to the inputs' dtypes.

    Recomputes P in fp32 from q and k (0 on masked keys), then dV = P^T dO,
    dP = dO V^T, dS = P o (dP - rowsum(dO o O)), dQ = dS K * scale and
    dK = dS^T Q * scale, dK and dV summed over each K/V head's G query
    heads.  ``o`` is the forward's output, ``do`` its gradient.  A row whose
    keys are all masked has P = 0 and gets zero gradients.
    """
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    if q_offset is None:
        q_offset = Sk - Sq
    qf, of, dof = q.float(), o.float(), do.float()
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)),
                    torch.zeros_like(s))
    l = p.sum(-1, keepdim=True)
    p = p / torch.where(l > 0, l, torch.ones_like(l))
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = (dof * of).sum(-1).transpose(1, 2)[..., None]     # (B, Hq, Sq, 1)
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale

    def per_kv_head(x):   # (B, Sk, Hq, D) -> (B, Sk, Hkv, D)
        return x.reshape(B, Sk, Hkv, G, D).sum(3)

    return (dq.to(q.dtype), per_kv_head(dk).to(k.dtype),
            per_kv_head(dv).to(v.dtype))
