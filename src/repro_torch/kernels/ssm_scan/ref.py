"""Plain PyTorch oracle for the gated linear-attention (SSM) scan.

Port of ``repro.kernels.ssm_scan.ref``.  One recurrence covers the
attention-free families:

  S_t = diag(exp(w_t)) . S_{t-1} + k_t (x) v_t        (state K x V per head)
  o_t = q_t^T S_t

  * RWKV6 ("Finch"): w_t is a data-dependent per-key-dim log decay.
  * Mamba2 (SSD):    w_t = -softplus(dt) * A broadcast per head (scalar
                     decay), k_t = B_t, v_t = dt * x_t, q_t = C_t.

Shapes: q, k, w: (B, H, S, K); v: (B, H, S, V); init state (B, H, K, V).
Returns (o: (B, H, S, V) in q's dtype, final state in fp32).
``gla_decode_step`` is the serving path on every device: plain torch, as
in the JAX package, with no kernel behind it.  ``gla_scan_bwd_ref`` is the
gradient of the chunked form (``ops.gla_scan_xla``), the plain version of
the backward kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

CLAMP = 30.0   # w is clamped to [-CLAMP, 0]
GUARD = 60.0   # exp(-a) saturates at e^GUARD


def gla_scan_ref(q, k, v, w, init_state=None):
    B, H, S, K = q.shape
    V = v.shape[-1]
    state = init_state
    if state is None:
        state = torch.zeros((B, H, K, V), dtype=torch.float32, device=q.device)
    qf, kf, vf, wf = (x.float() for x in (q, k, v, w))
    outs = []
    for t in range(S):
        decay = torch.exp(wf[:, :, t])[..., None]              # (B,H,K,1)
        state = state * decay + kf[:, :, t, :, None] * vf[:, :, t, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", qf[:, :, t], state))
    o = torch.stack(outs, dim=2) if outs else vf.new_zeros((B, H, 0, V))
    return o.to(q.dtype), state


def gla_decode_step(q, k, v, w, state):
    """Single-token recurrence (serving): q/k/w (B,H,K), v (B,H,V)."""
    decay = torch.exp(w.float())[..., None]
    state = state * decay + k.float()[..., None] * v.float()[..., None, :]
    o = torch.einsum("bhk,bhkv->bhv", q.float(), state)
    return o.to(q.dtype), state


def _tie_mask(x, lo, hi):
    """d clip(x, lo, hi) / dx as ``jax.grad`` gives it: 1 inside, 0
    outside, 1/2 at either bound."""
    return (((x > lo) & (x < hi)).float()
            + 0.5 * ((x == lo) | (x == hi)).float())


def gla_scan_bwd_ref(q, k, v, w, do, d_final=None, chunk: int = 128):
    """(dq, dk, dv, dw) of ``gla_scan_xla(q, k, v, w, chunk)`` from a zero
    state, given ``do`` (B, H, S, V), the gradient of the output, and
    ``d_final`` (B, H, K, V), that of the final state (None: zero).

    An explicit reverse recurrence in fp32, not autograd.  Per chunk of C
    positions, with a = cumsum(clamp(w)), q~ = q e^a, k~ = k e^min(-a, 60),
    e = e^{a_last}, the chunk-start state S_c and dS the gradient of the
    state after the chunk:
      dP  = mask(dO v^T);   P = mask(q~ k~^T)
      dq~ = dP k~ + dO S_c^T
      dk~ = dP^T q~ + e (v dS^T)
      dv  = P^T dO + (k~ e) dS
      da  = dq~ q~ - dk~ k~ [guard], plus on the last row
            e (sum_v S_c dS + sum_i k~ (v dS^T))
      dw  = reverse cumsum of da [clamp];   dS <- q~^T dO + e dS
    where [guard] and [clamp] are the min and clip derivatives, 1/2 at a
    tie as in JAX.  The ragged last chunk acts as zero padding.  Returns
    dq, dk, dv in their inputs' dtypes and dw in fp32."""
    B, H, S, K = q.shape
    V = v.shape[-1]
    C = min(chunk, S)
    pad = (-S) % C
    n = (S + pad) // C

    def chunks(x, d):
        return F.pad(x.float(), (0, 0, 0, pad)).reshape(B, H, n, C, d)

    qf, kf, wf, vf, dof = (chunks(x, d) for x, d in
                           ((q, K), (k, K), (w, K), (v, V), (do, V)))
    a = torch.cumsum(wf.clamp(-CLAMP, 0.0), dim=3)
    ea = torch.exp(a)
    eg = torch.exp(torch.clamp(-a, max=GUARD))
    qt, kt = qf * ea, kf * eg
    ea_last = ea[:, :, :, C - 1]                                   # (B,H,n,K)
    causal = torch.ones((C, C), dtype=torch.bool, device=q.device).tril()

    starts, state = [], q.new_zeros((B, H, K, V), dtype=torch.float32)
    for c in range(n):
        starts.append(state)
        kfin = kt[:, :, c] * ea_last[:, :, c, None]
        state = (state * ea_last[:, :, c, :, None]
                 + torch.einsum("bhik,bhiv->bhkv", kfin, vf[:, :, c]))

    dS = (q.new_zeros((B, H, K, V), dtype=torch.float32) if d_final is None
          else d_final.float())
    dq, dk, dv, dw = [], [], [], []
    for c in reversed(range(n)):
        qc, kc, vc, doc, e = qt[:, :, c], kt[:, :, c], vf[:, :, c], dof[:, :, c], ea_last[:, :, c]
        P = torch.einsum("bhik,bhjk->bhij", qc, kc).masked_fill(~causal, 0.0)
        dP = torch.einsum("bhiv,bhjv->bhij", doc, vc).masked_fill(~causal, 0.0)
        vdS = torch.einsum("bhjv,bhkv->bhjk", vc, dS)
        dqt = dP @ kc + torch.einsum("bhiv,bhkv->bhik", doc, starts[c])
        dkt = dP.transpose(-1, -2) @ qc + e[:, :, None] * vdS
        dv.append(P.transpose(-1, -2) @ doc
                  + torch.einsum("bhjk,bhkv->bhjv", kc * e[:, :, None], dS))
        da = dqt * qc - dkt * kc * _tie_mask(-a[:, :, c], -torch.inf, GUARD)
        da[:, :, C - 1] += e * ((starts[c] * dS).sum(-1) + (kc * vdS).sum(2))
        dw.append(da.flip(2).cumsum(2).flip(2)
                  * _tie_mask(wf[:, :, c], -CLAMP, 0.0))
        dq.append(dqt * ea[:, :, c])
        dk.append(dkt * eg[:, :, c])
        dS = torch.einsum("bhik,bhiv->bhkv", qc, doc) + e[..., None] * dS

    def whole(parts, like):
        out = torch.cat(parts[::-1], dim=2)[:, :, :S]
        return out if like is None else out.to(like.dtype)

    return whole(dq, q), whole(dk, k), whole(dv, v), whole(dw, None)
