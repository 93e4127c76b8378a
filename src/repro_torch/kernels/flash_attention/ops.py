"""Dispatching wrapper for flash attention.

``flash_attention`` picks the implementation:
  * ``cuda``        — the hand-written Hopper kernel (kernel.py), and its
    backward kernel when autograd records the call; the default for CUDA
    tensors, which never take a plain path;
  * ``xla_chunked`` — a plain blockwise online-softmax implementation (a
    loop over KV blocks) with O(S * block) activations; the default for CPU
    tensors.  The name follows the JAX package's portable impl;
  * ``naive``       — the ref oracle (tests only; materializes S^2).

All implementations share semantics with ``ref.attention_ref``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref

NEG_INF = -1e30


def _chunk_body(q, kc, vc, carry, q_start, k_start, *, causal, window, bq, bk,
                k_limit):
    """One KV chunk of online softmax.  q: (B,H,bq,D); kc/vc: (B,H,bk,D)."""
    acc, m, l = carry
    s = torch.einsum("bhqd,bhkd->bhqk", q, kc)
    qpos = q_start + torch.arange(bq, device=q.device)[:, None]
    kpos = k_start + torch.arange(bk, device=q.device)[None, :]
    mask = kpos < k_limit  # padded key positions never attend
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(-1, keepdim=True)
    acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, vc)
    return acc, m_new, l


def flash_attention_xla(q, k, v, *, causal=True, window=None, q_offset=None,
                        scale=None, block_q: int = 512, block_k: int = 512):
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    if q_offset is None:
        q_offset = Sk - Sq
    bq = min(block_q, Sq)
    bk = min(block_k, Sk)
    # Pad sequences up to block multiples (masked out).
    pq = (-Sq) % bq
    pk = (-Sk) % bk
    qf = F.pad(q, (0, 0, 0, 0, 0, pq))
    kf = F.pad(k, (0, 0, 0, 0, 0, pk))
    vf = F.pad(v, (0, 0, 0, 0, 0, pk))
    nq, nk = (Sq + pq) // bq, (Sk + pk) // bk
    # (B, H, S, D) layouts; kv heads repeated per group.
    qf = qf.transpose(1, 2).float() * scale                    # (B,Hq,Sq,D)
    kf = kf.transpose(1, 2).repeat_interleave(G, dim=1).float()
    vf = vf.transpose(1, 2).repeat_interleave(G, dim=1).float()

    blocks = []
    for qi in range(nq):
        qblk = qf[:, :, qi * bq:(qi + 1) * bq]
        carry = (torch.zeros((B, Hq, bq, D), device=q.device),
                 torch.full((B, Hq, bq, 1), NEG_INF, device=q.device),
                 torch.zeros((B, Hq, bq, 1), device=q.device))
        for ki in range(nk):
            sl = slice(ki * bk, (ki + 1) * bk)
            carry = _chunk_body(qblk, kf[:, :, sl], vf[:, :, sl], carry,
                                qi * bq + q_offset, ki * bk, causal=causal,
                                window=window, bq=bq, bk=bk, k_limit=Sk)
        acc, _, l = carry
        blocks.append(acc / (l + 1e-30))
    out = torch.cat(blocks, dim=2)[:, :, :Sq].transpose(1, 2)
    return out.to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    q_offset: int | None = None, scale: float | None = None,
                    impl: str | None = None, block_q: int = 512,
                    block_k: int = 512):
    """GQA flash attention.  See ref.attention_ref for semantics."""
    if impl is None:
        impl = "cuda" if q.is_cuda else "xla_chunked"
    if impl == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset, scale=scale)
    if impl == "xla_chunked":
        return flash_attention_xla(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, scale=scale,
                                   block_q=block_q, block_k=block_k)
    if impl == "naive":
        return attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, scale=scale)
    raise ValueError(f"unknown impl {impl}")
