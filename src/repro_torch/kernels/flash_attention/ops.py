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

DTensors (a sharded model's q, k, v) go through ``flash_attention_sharded``
whatever the implementation: it runs the same dispatch on each rank's
local shards under ``local_map``, so the card launches the kernel and the
CPU runs the plain version on shards alike.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed.sharding import kernel_placements, model_rank
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
    if isinstance(q, DTensor):
        return flash_attention_sharded(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset, scale=scale, impl=impl,
                                       block_q=block_q, block_k=block_k)
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


def kv_heads_for_rank(k, v, rank: int, local_heads: int, group: int):
    """The K/V heads that q heads ``[rank * local_heads, (rank + 1) *
    local_heads)`` read, from whole K/V (B, S, Hkv, D), for a flash call on
    those q heads alone: a contiguous slice where the q heads cover whole
    groups or sit in one group, else one K/V head per q head."""
    lo = rank * local_heads
    if local_heads % group == 0 or group % local_heads == 0:
        sl = slice(lo // group, (lo + local_heads - 1) // group + 1)
        return k[:, :, sl], v[:, :, sl]
    idx = torch.arange(lo, lo + local_heads, device=k.device) // group
    return k.index_select(2, idx), v.index_select(2, idx)


class _DenseGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous: ``local_map`` wraps
    a rank's local gradient in a DTensor as it is, and DTensor's later
    views of it read it as contiguous (the plain path's gradients of K and
    V at Sq != Sk come back transposed)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def flash_attention_sharded(q, k, v, **kw):
    """``flash_attention`` on DTensors: each rank runs it on its local
    shards (``local_map``), batch over the mesh's data-parallel axes and q
    heads over ``model``, the sequence whole.  Where K/V heads do not
    divide ``model`` they are gathered whole and each rank takes the K/V
    heads its q heads read (``kv_heads_for_rank``); their gradients are
    then partial sums over ``model``.  Returns a DTensor with q's local
    placements."""
    mesh = q.device_mesh
    B, _, Hq, _ = q.shape
    Hkv = k.shape[2]
    qpl = kernel_placements(mesh, B, Hq, 2)
    kvpl = kernel_placements(mesh, B, Hkv, 2)
    rank, m = model_rank(mesh)
    split_kv = Hq % m == 0 and Hkv % m != 0
    if Hq % m:   # q heads whole on every rank: K/V too
        kvpl = qpl
    kv_grad = tuple(Partial() if split_kv and isinstance(p, Replicate) and a == "model"
                    else p for a, p in zip(mesh.mesh_dim_names, kvpl))
    q = q.redistribute(mesh, qpl)
    k = k.redistribute(mesh, kvpl)
    v = v.redistribute(mesh, kvpl)

    def local(q, k, v):
        q, k, v = (_DenseGrad.apply(t) for t in (q, k, v))
        if split_kv:
            k, v = kv_heads_for_rank(k, v, rank, Hq // m, Hq // Hkv)
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), **kw)

    return local_map(local, out_placements=list(qpl), in_placements=(qpl, kvpl, kvpl),
                     in_grad_placements=(qpl, kv_grad, kv_grad),
                     device_mesh=mesh)(q, k, v)
