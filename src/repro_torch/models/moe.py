"""Mixture-of-Experts layer (granite-moe, dbrx) with sort-based dispatch.

Port of ``repro.models.moe``: top-k routing with per-row capacity, the
token -> expert assignments stably sorted by expert id, scattered into
per-expert buffers of capacity ``C``, run through batched expert FFNs (one
``bmm`` over the expert dim) and gathered back with router-probability
weighting.  Tokens beyond an expert's capacity are dropped.  The JAX
package's per-row ``vmap`` becomes batched ops over the leading B; every
row is still dispatched on its own.

Nothing here reads a value on the host or makes a data-dependent shape,
and no step adds into one place twice, so a decode step through this layer
can be captured in a CUDA graph and gives the same bits on every run.

On DTensors (a sharded model) the sort, scatter and gather run on each
rank's local rows under ``local_map`` (``moe_fwd_sharded``): the reference
keeps experts replicated and their ``ff`` dim on ``model``, so the
dispatch never crosses the model axis.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed.sharding import (axis_names, constrain_batch,
                                              gather_fsdp, kernel_placements,
                                              mesh_shape)
from repro_torch.models.layers import ParamFactory


def init_moe(generator, d_model: int, d_ff: int, num_experts: int, top_k: int,
             kind: str = "swiglu", dtype=torch.bfloat16):
    """The reference's params, layouts and scales: router 0.02, experts
    ``shape[0] ** -0.5``, which for ``(E, D, F)`` is E^-0.5, not the
    fan-in (kept on purpose: ROADMAP.md, Queue 3)."""
    p = ParamFactory(generator, dtype)
    E = num_experts
    p.dense("router", (d_model, E), ("embed", None), scale=0.02)
    if kind in ("swiglu", "geglu"):
        p.dense("wi_gate", (E, d_model, d_ff), ("experts", "embed", "ff"))
        p.dense("wi_up", (E, d_model, d_ff), ("experts", "embed", "ff"))
    else:
        p.dense("wi_up", (E, d_model, d_ff), ("experts", "embed", "ff"))
    p.dense("wo", (E, d_ff, d_model), ("experts", "ff", "embed"))
    return p.params, p.axes


def route(params, x, top_k: int):
    """(probs (B, S, E), gate_vals (B, S, K), gate_idx (B, S, K)).

    The router runs in the params' dtype and only then goes to fp32, as
    the reference's (bf16 logits tie often).  A stable sort of ``-probs``
    picks the lower expert first among equal probs, as ``lax.top_k`` does;
    ``torch.topk`` does not.
    """
    logits = (x @ params["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gate_idx = torch.argsort(-probs, dim=-1, stable=True)[..., :top_k]
    gate_vals = probs.gather(-1, gate_idx)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    return probs, gate_vals, gate_idx


def capacity(seq_len: int, num_experts: int, top_k: int,
             capacity_factor: float) -> int:
    """Per-row expert capacity, the reference's expression verbatim (float
    floor division included)."""
    A = seq_len * top_k
    return int(max(1, -(-A * capacity_factor // num_experts)))


def _expert_ffn(params, xe, kind: str):
    """xe: (E, rows, D) -> (E, rows, D); the reference's
    ``einsum("becd,edf->becf")`` pair as one ``bmm`` over E."""
    if kind in ("swiglu", "geglu"):
        g = torch.bmm(xe, params["wi_gate"])
        g = F.silu(g) if kind == "swiglu" else F.gelu(g, approximate="tanh")
        h = g * torch.bmm(xe, params["wi_up"])
    else:
        h = F.gelu(torch.bmm(xe, params["wi_up"]), approximate="tanh")
    return torch.bmm(h, params["wo"])


def moe_fwd(params, x, *, num_experts: int, top_k: int,
            kind: str = "swiglu", capacity_factor: float = 1.25):
    """x: (B, S, D) -> (out, {"aux_loss", "dropped_frac"}).

    Each row's A = S * K assignments, in (token, k) order, are stably
    sorted by expert only to find each one's position within its expert;
    the positions go back to (token, k) order, so the scatter into the
    buffers and the gather out of them need no permutation of D-wide rows.
    Buffer row ``e * B * C + b * C + pos`` holds row b's assignment at
    position ``pos`` of expert e; dropped assignments go to a spare last
    row, which is never read (the reference adds them as zeros at
    (0, 0): a plain scatter with those repeated indices could overwrite
    the real (0, 0) entry, an accumulating one is not deterministic on a
    card).  Each token's K weighted outputs are summed over a (K,) axis,
    not added into place.  The reference computes every expert over its
    whole buffer, empty slots included, and so does this.  DTensors go
    through ``moe_fwd_sharded``.
    """
    if isinstance(x, DTensor):
        return moe_fwd_sharded(params, x, num_experts=num_experts, top_k=top_k,
                               kind=kind, capacity_factor=capacity_factor)
    E, K = num_experts, top_k
    probs, gate_vals, gate_idx = route(params, x, K)

    # Load-balance loss (Switch-style): E * sum_e f_e * p_e.
    me = probs.mean(dim=(0, 1))
    experts = torch.arange(E, device=x.device)
    fe = (gate_idx[..., :1] == experts).float().mean(dim=(0, 1))
    aux_loss = E * torch.sum(fe * me)
    out, keep = _dispatch(params, x, gate_vals, gate_idx, E, K, kind,
                          capacity_factor)
    return out, {"aux_loss": aux_loss,
                 "dropped_frac": 1.0 - keep.float().mean()}


def _dispatch(params, x, gate_vals, gate_idx, E: int, K: int, kind: str,
              capacity_factor: float):
    """Sort, scatter, expert FFNs and weighted gather of ``moe_fwd``:
    (out (B, S, D), keep (B, S * K))."""
    B, S, D = x.shape
    A = S * K
    C = capacity(S, E, K, capacity_factor)
    flat_exp = gate_idx.reshape(B, A)
    order = torch.argsort(flat_exp, dim=-1, stable=True)
    sexp = flat_exp.gather(1, order)
    run_start = torch.searchsorted(sexp, sexp, side="left")
    spos = torch.arange(A, device=x.device) - run_start
    pos = torch.empty_like(spos).scatter_(1, order, spos)  # (token, k) order
    keep = pos < C
    rows = torch.arange(B, device=x.device)[:, None]
    trash = E * B * C
    slot = torch.where(keep, flat_exp * (B * C) + rows * C + pos,
                       trash).reshape(B * A)

    src = x[:, :, None, :].expand(B, S, K, D).reshape(B * A, D)
    buf = x.new_zeros((trash + 1, D))
    buf.index_copy_(0, slot, src)
    out_buf = _expert_ffn(params, buf[:trash].view(E, B * C, D), kind)

    vals = out_buf.reshape(trash, D).index_select(
        0, torch.where(keep.reshape(B * A), slot, 0)).view(B, A, D)
    vals = (torch.where(keep[..., None], vals, 0)
            * gate_vals.reshape(B, A, 1).to(out_buf.dtype))
    return vals.view(B, S, K, D).sum(dim=-2), keep


def moe_fwd_sharded(params, x, *, num_experts: int, top_k: int,
                    kind: str = "swiglu", capacity_factor: float = 1.25):
    """``moe_fwd`` on DTensors.  Each rank routes and dispatches its local
    rows (batch over the data-parallel axes where it divides, each row's
    sequence whole) through its ``ff`` shard of every expert (experts
    replicated, ``ff`` on ``model`` where it divides).  The outputs are
    partial sums over ``model``, and so are the gradients of x and the
    router there; over the batch shards the weights' gradients are partial
    sums.  The load-balance loss and the dropped fraction come from
    per-rank sums of the router's probabilities, first choices and kept
    assignments (split evenly over the ``model`` ranks, which all route
    the same rows)."""
    mesh = x.device_mesh
    B, S, D = x.shape
    E, K = num_experts, top_k
    names = axis_names(mesh)
    m = mesh_shape(mesh).get("model", 1)
    tp = m > 1 and params["wo"].shape[1] % m == 0
    xpl = kernel_placements(mesh, B)
    split = {a: isinstance(p, Shard) for a, p in zip(names, xpl)}   # batch shards

    def pl(model_pl, data_pl):
        return tuple(model_pl if a == "model" else data_pl(a) for a in names)

    rep, part = Replicate(), Partial()
    wpl = {n: pl(Shard(2 if n != "wo" else 1) if tp else rep, lambda a: rep)
           for n in ("wi_gate", "wi_up", "wo") if n in params}
    wgrad = {n: pl(Shard(2 if n != "wo" else 1) if tp else rep,
                   lambda a: part if split[a] else rep) for n in wpl}
    wpl["router"] = pl(rep, lambda a: rep)
    wgrad["router"] = pl(part if tp else rep, lambda a: part if split[a] else rep)
    x_grad = pl(part if tp else rep, lambda a: xpl[names.index(a)])
    out_pl = x_grad
    sum_pl = pl(part if tp else rep, lambda a: part if split[a] else rep)
    share = m if tp else 1
    order = sorted(wpl)
    weights = [(gather_fsdp(params[n], tp_dim=2 if n != "wo" else 1)
                if n != "router" else params[n]).redistribute(mesh, wpl[n])
               for n in order]

    def local(x, *ws):
        p = dict(zip(order, ws))
        probs, gate_vals, gate_idx = route(p, x, K)
        first = (gate_idx[..., :1] == torch.arange(E, device=x.device)).float()
        out, keep = _dispatch(p, x, gate_vals, gate_idx, E, K, kind,
                              capacity_factor)
        return (out, probs.sum(dim=(0, 1)) / share, first.sum(dim=(0, 1)) / share,
                keep.float().sum() / share)

    out, psum, fsum, kept = local_map(
        local, out_placements=(out_pl, sum_pl, sum_pl, sum_pl),
        in_placements=(xpl,) + tuple(wpl[n] for n in order),
        in_grad_placements=(x_grad,) + tuple(wgrad[n] for n in order),
        device_mesh=mesh)(x.redistribute(mesh, xpl), *weights)
    me = psum / (B * S)
    fe = fsum / (B * S)
    aux_loss = E * torch.sum(fe * me)
    return constrain_batch(out), {"aux_loss": aux_loss,
                                  "dropped_frac": 1.0 - kept / (B * S * K)}
