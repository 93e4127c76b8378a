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
in the JAX package, with no kernel behind it.
"""

from __future__ import annotations

import torch


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
