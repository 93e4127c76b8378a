"""Dispatching wrapper for the chunked GLA/SSM scan.

Port of ``repro.kernels.ssm_scan.ops``.  ``gla_scan`` picks the
implementation:
  * ``cuda``        — the hand-written Hopper kernel (kernel.py); the default
    for CUDA tensors, which never take a plain path;
  * ``xla_chunked`` — the same chunked math in plain torch, a loop over
    chunks in place of ``lax.scan``; the default for CPU tensors.  The name
    follows the JAX package's portable impl;
  * ``naive``       — the per-token recurrence oracle (tests).

DTensors (a sharded model's operands) go through ``gla_scan_sharded``
whatever the implementation: the same dispatch on each rank's local
shards under ``local_map``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed.sharding import kernel_placements
from repro_torch.kernels.ssm_scan.kernel import gla_scan_cuda
from repro_torch.kernels.ssm_scan.ref import CLAMP, GUARD, gla_scan_ref


def clamp_decay(w):
    """w clamped to [-CLAMP, 0] as ``jnp.clip`` does it (a maximum, then a
    minimum): the same values as ``clamp``, and at a bound (w == 0 or
    w == -CLAMP) half the gradient, as ``jax.grad`` gives, where ``clamp``
    gives all of it."""
    return torch.minimum(torch.maximum(w, w.new_tensor(-CLAMP)), w.new_tensor(0.0))


def guard(a):
    """The exponent guard ``min(-a, GUARD)`` as ``jnp.minimum``: half the
    gradient at -a == GUARD, as ``jax.grad`` gives."""
    return torch.minimum(-a, a.new_tensor(GUARD))


def gla_scan_xla(q, k, v, w, chunk: int = 128, init_state=None):
    B, H, S, K = q.shape
    V = v.shape[-1]
    C = min(chunk, S)
    pad = (-S) % C
    if pad:
        q, k, v, w = (F.pad(x, (0, 0, 0, pad)) for x in (q, k, v, w))
    n = (S + pad) // C
    qf = q.float().reshape(B, H, n, C, K)
    kf = k.float().reshape(B, H, n, C, K)
    vf = v.float().reshape(B, H, n, C, V)
    wf = clamp_decay(w.float()).reshape(B, H, n, C, K)
    state = init_state
    if state is None:
        state = torch.zeros((B, H, K, V), dtype=torch.float32, device=q.device)
    causal = torch.ones((C, C), dtype=torch.bool, device=q.device).tril()

    outs = []
    for c in range(n):
        qc, kc, vc, wc = qf[:, :, c], kf[:, :, c], vf[:, :, c], wf[:, :, c]
        a = torch.cumsum(wc, dim=2)
        ea = torch.exp(a)
        q_t = qc * ea
        # Exponent guard, as the reference: exp(-a) overflows fp32 past ~88,
        # so it saturates at e^60.  The reference assumes exp(a_i) alone makes
        # the saturated terms negligible; the factor that matters is
        # exp(a_i - a_j), so a chunk whose decay passes 60 loses its local
        # terms (ROADMAP.md, Queue 3).  Copied on purpose: the port is held
        # to the JAX package.
        k_t = kc * torch.exp(guard(a))
        s = torch.einsum("bhik,bhjk->bhij", q_t, k_t)
        s = s.masked_fill(~causal, 0.0)
        intra = torch.einsum("bhij,bhjv->bhiv", s, vc)
        cross = torch.einsum("bhik,bhkv->bhiv", q_t, state)
        ea_last = ea[:, :, C - 1]                  # (B,H,K)
        k_fin = k_t * ea_last[:, :, None, :]
        state = (state * ea_last[..., None]
                 + torch.einsum("bhik,bhiv->bhkv", k_fin, vc))
        outs.append(intra + cross)
    o = torch.cat(outs, dim=2)[:, :, :S]
    return o.to(q.dtype), state


def gla_scan(q, k, v, w, chunk: int = 128, impl: str | None = None):
    if isinstance(q, DTensor):
        return gla_scan_sharded(q, k, v, w, chunk=chunk, impl=impl)
    if impl is None:
        impl = "cuda" if q.is_cuda else "xla_chunked"
    if impl == "cuda":
        return gla_scan_cuda(q, k, v, w, chunk=chunk)
    if impl == "xla_chunked":
        return gla_scan_xla(q, k, v, w, chunk=chunk)
    if impl == "naive":
        return gla_scan_ref(q, k, v, w)
    raise ValueError(f"unknown impl {impl}")


def gla_scan_sharded(q, k, v, w, chunk: int = 128, impl: str | None = None):
    """``gla_scan`` on DTensors: each rank scans its local shards
    (``local_map``), batch over the mesh's data-parallel axes and heads
    over ``model``, the sequence whole (the recurrence needs all of it).
    Returns (o, final state) as DTensors with those placements."""
    mesh = q.device_mesh
    B, H = q.shape[:2]
    pl = kernel_placements(mesh, B, H, 1)
    q, k, v, w = (t.redistribute(mesh, pl) for t in (q, k, v, w))

    def local(q, k, v, w):
        return gla_scan(q, k, v, w, chunk=chunk, impl=impl)

    return local_map(local, out_placements=(pl, pl), in_placements=(pl,) * 4,
                     device_mesh=mesh)(q, k, v, w)
