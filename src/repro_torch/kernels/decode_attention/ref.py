"""Plain PyTorch dense decode attention: the version the CPU tests, the
sharded serve and the calls no kernel takes run, and what the kernel is
held to on the card.

The JAX package's ``_decode_attend`` (src/repro/models/layers.py), as the
port ran it before a kernel backed the dense decode: the whole cache cast
to fp32, every position scored, positions at or past ``valid_len`` masked
to -1e30, an fp32 softmax and two fp32 einsums.  The sharding hooks pin a
DTensor cache's layout and split its heads as the reference does; plain
tensors pass them unchanged.

Shapes:
  q:        (B, 1, H, hd)        the new token's queries
  k_cache:  (B, S_cache, KV, hd)
  v_cache:  (B, S_cache, KV, hd)
  valid_len: int or 0-d int32    positions [0, valid_len) attend
  returns   (B, 1, H, hd) in q's dtype
"""

from __future__ import annotations

import torch

from repro_torch.distributed.sharding import constrain_kv_layout, splittable


def decode_attention_ref(q, k_cache, v_cache, valid_len):
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    qf = q.float() * (hd ** -0.5)                         # (B,1,H,hd)
    kf = constrain_kv_layout(k_cache.float())
    vf = constrain_kv_layout(v_cache.float())
    qg = splittable(qf, 2, KV).reshape(B, KV, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, kf)           # (B,KV,G,S)
    kpos = torch.arange(k_cache.shape[1], device=q.device)
    mask = kpos[None, None, None, :] < valid_len
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, vf)
    return o.reshape(B, 1, H, hd).to(q.dtype)
