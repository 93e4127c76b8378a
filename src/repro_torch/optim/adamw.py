"""AdamW with decoupled weight decay and global-norm clipping.

Port of ``repro.optim.adamw`` over plain nested dicts of tensors (no
``torch.optim.Optimizer``), so that parameters, gradients and moments cross
to and from the JAX package leaf for leaf.  The moments are fp32; the
update runs in fp32 under ``torch.no_grad()`` and is cast back to each
parameter's dtype.  It is out of place, as in the reference: new
parameter and moment tensors are returned and the old ones are left as
they were.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import leaves, tree_map


class AdamWState(NamedTuple):
    count: torch.Tensor     # 0-d int32, on the parameters' device
    mu: Any
    nu: Any


def adamw_init(params: Any) -> AdamWState:
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)

    device = leaves(params)[0].device
    return AdamWState(count=torch.zeros((), dtype=torch.int32, device=device),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves (in JAX's leaf order) of each leaf's
    fp32 sum of squares."""
    return torch.sqrt(sum(g.float().square().sum() for g in leaves(tree)))


def clip_by_global_norm(grads: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    """Scales every leaf by min(1, max_norm / (norm + 1e-9)).  The scaled
    leaves are fp32, as JAX promotes a bf16 leaf times an fp32 scale."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm


@torch.no_grad()
def adamw_update(grads: Any, state: AdamWState, params: Any,
                 lr: torch.Tensor | float,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 max_grad_norm: float | None = 1.0) -> tuple[Any, AdamWState, torch.Tensor]:
    """Returns (new_params, new_state, pre-clip grad norm)."""
    if max_grad_norm is not None:
        grads, norm = clip_by_global_norm(grads, max_grad_norm)
    else:
        norm = global_norm(grads)
    count = state.count + 1
    c = count.float()
    bc1 = 1.0 - b1 ** c
    bc2 = 1.0 - b2 ** c

    def upd(g, m, v, p):
        g32 = g.float()
        m = b1 * m + (1 - b1) * g32
        v = b2 * v + (1 - b2) * g32.square()
        step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        # Decoupled weight decay only on matrices/embeddings (ndim >= 2).
        wd = weight_decay if p.ndim >= 2 else 0.0
        p32 = p.float()
        newp = p32 - lr * (step + wd * p32)
        return newp.to(p.dtype), m, v

    out = tree_map(lambda p, g, m, v: upd(g, m, v, p), params, grads,
                   state.mu, state.nu)
    new_p, new_m, new_v = (tree_map(lambda _, o: o[i], params, out)
                           for i in range(3))
    return new_p, AdamWState(count, new_m, new_v), norm
