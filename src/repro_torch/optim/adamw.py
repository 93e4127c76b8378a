"""AdamW with decoupled weight decay and global-norm clipping.

Port of ``repro.optim.adamw`` over plain nested dicts of tensors (no
``torch.optim.Optimizer``), so that parameters, gradients and moments cross
to and from the JAX package leaf for leaf.  The moments are fp32; the
update runs in fp32 under ``torch.no_grad()`` and is cast back to each
parameter's dtype.  By default it is out of place, as in the reference:
new parameter and moment tensors are returned and the old ones are left as
they were.  With ``donate=True`` (the counterpart of donating the buffers
to a jitted step) it writes each leaf's new parameter and moments into the
tensors it was given, one leaf at a time, so the device holds one state
and one leaf's fp32 temporaries; both forms run ``_leaf_update``, so they
give the same bits.
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


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def clip_by_global_norm(grads: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    """Scales every leaf by min(1, max_norm / (norm + 1e-9)).  The scaled
    leaves are fp32, as JAX promotes a bf16 leaf times an fp32 scale."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), norm


def _leaf_update(g, m, v, p, scale, lr, bc1, bc2, b1, b2, eps, weight_decay):
    """One leaf's AdamW update: (new p in p's dtype, new m, new v).  The
    gradient is clipped here (``scale``, None without a clip), as
    ``clip_by_global_norm`` would have scaled it."""
    g32 = g.float() if scale is None else g.float() * scale
    m = b1 * m + (1 - b1) * g32
    v = b2 * v + (1 - b2) * g32.square()
    step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    # Decoupled weight decay only on matrices/embeddings (ndim >= 2).
    wd = weight_decay if p.ndim >= 2 else 0.0
    p32 = p.float()
    newp = p32 - lr * (step + wd * p32)
    return newp.to(p.dtype), m, v


@torch.no_grad()
def adamw_update(grads: Any, state: AdamWState, params: Any,
                 lr: torch.Tensor | float,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 max_grad_norm: float | None = 1.0,
                 donate: bool = False) -> tuple[Any, AdamWState, torch.Tensor]:
    """Returns (new_params, new_state, pre-clip grad norm).  With
    ``donate`` the new values are written into ``params``, ``state.mu`` and
    ``state.nu``, and those same trees are returned (with a new ``count``)."""
    norm = global_norm(grads)
    scale = None if max_grad_norm is None else _clip_scale(norm, max_grad_norm)
    count = state.count + 1
    c = count.float()
    bc1 = 1.0 - b1 ** c
    bc2 = 1.0 - b2 ** c

    def upd(p, g, m, v):
        out = _leaf_update(g, m, v, p, scale, lr, bc1, bc2, b1, b2, eps,
                           weight_decay)
        if not donate:
            return out
        for dst, src in zip((p, m, v), out):
            dst.copy_(src)
        return None

    out = tree_map(upd, params, grads, state.mu, state.nu)
    if donate:
        return params, AdamWState(count, state.mu, state.nu), norm
    new_p, new_m, new_v = (tree_map(lambda _, o: o[i], params, out)
                           for i in range(3))
    return new_p, AdamWState(count, new_m, new_v), norm
