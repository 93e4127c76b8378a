"""Plain PyTorch oracle for paged decode attention (naive gather).

Decode-time attention where the KV cache lives in a paged pool (the DDS
file-mapping analogue: a block table maps each sequence's logical KV pages
to physical pool pages).

Shapes:
  q:           (B, Hq, D)          one new query token per sequence
  k_pages:     (P, page, Hkv, D)   physical page pool
  v_pages:     (P, page, Hkv, D)
  block_table: (B, MaxPages) int32 physical page id per logical page
  seq_lens:    (B,) int32          valid KV length per sequence
  returns      (B, Hq, D)

With ``seq_len == 0`` this returns the uniform mean of the gathered V; the
CUDA kernel, like the Pallas one, returns zeros there.
"""

from __future__ import annotations

import torch


def paged_attention_ref(q, k_pages, v_pages, block_table, seq_lens,
                        scale: float | None = None):
    B, Hq, D = q.shape
    P, page, Hkv, _ = k_pages.shape
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    # Gather each sequence's pages into contiguous KV (the "two-copy
    # straw-man" — fine for an oracle).
    table = block_table.long()
    k = k_pages[table]                          # (B, MaxPages, page, Hkv, D)
    v = v_pages[table]
    Smax = k.shape[1] * page
    k = k.reshape(B, Smax, Hkv, D).float().repeat_interleave(G, dim=2)
    v = v.reshape(B, Smax, Hkv, D).float().repeat_interleave(G, dim=2)
    qf = q.float() * scale
    s = torch.einsum("bhd,bkhd->bhk", qf, k)    # (B, Hq, Smax)
    kpos = torch.arange(Smax, device=q.device)[None, None, :]
    mask = kpos < seq_lens.to(q.device)[:, None, None]
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / (p.sum(-1, keepdim=True) + 1e-30)
    out = torch.einsum("bhk,bkhd->bhd", p, v)
    return out.to(q.dtype)
