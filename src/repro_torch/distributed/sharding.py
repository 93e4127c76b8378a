"""Sharding rules: logical parameter axes -> mesh axes, on DeviceMesh/DTensor.

Port of ``repro.distributed.sharding``.  The model zoo annotates every
parameter with logical axis names (``repro_torch.models.layers``
docstring).  This module turns those into spec trees for a mesh and a
workload kind, with the reference's arithmetic:

  * **TP**   — "vocab"/"heads"/"ff" shard over the ``model`` axis.
  * **FSDP** — "embed" (the d_model dim of weights) shards over ``data``;
    ``gather_fsdp`` all-gathers a weight right before its use.  Optimizer
    state inherits parameter specs, so it is ZeRO-sharded too.
  * **DP**   — batch dims of inputs/activations shard over ``("pod","data")``
    (or just ``data`` single-pod).
  * **SP**   — when the batch does not divide the DP axes, the *sequence*
    dims of inputs (and long KV caches) shard over ``data`` instead.

A spec is a ``P``: a tuple with one entry per tensor dim, each ``None``
(replicated), a mesh axis name, a tuple of names, or ``P.UNCONSTRAINED``
(keep whatever placement the dim has).  ``to_placements`` turns a spec
into DTensor placements, one per mesh dim, and ``place`` distributes a
tree by a spec tree (the counterpart of ``NamedSharding`` in a jit's
``in_shardings``).  Unlike GSPMD, DTensor does not pad an uneven dim: it
splits it in ``torch.chunk``'s pieces, which gives the same values.

The activation hooks (``constrain_batch``, ``constrain_logits``,
``gather_fsdp``, ``constrain_kv_layout``) redistribute a DTensor under the
reference's conditions.  Outside an ``activation_sharding_scope``, or given
a plain tensor, each returns its input untouched, so the single-device
path runs as before.  The rules read only ``axis_names`` and ``shape``
(a dict) of a mesh, or a ``DeviceMesh``'s dim names and sizes.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ModelConfig, ShapeConfig


class _Unconstrained:
    def __repr__(self):
        return "P.UNCONSTRAINED"


def _canonical(entry):
    """A tuple of axis names as a tuple, one name alone as the name, as
    JAX's ``PartitionSpec`` keeps them."""
    if isinstance(entry, (tuple, list)):
        return entry[0] if len(entry) == 1 else tuple(entry)
    return entry


class P(tuple):
    """A partition spec: one entry per tensor dim (see the module
    docstring).  Compares as the tuple of its entries."""

    UNCONSTRAINED = _Unconstrained()

    def __new__(cls, *entries):
        return super().__new__(cls, (_canonical(e) for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a DeviceMesh or of a mesh with a ``shape`` dict."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(axis_names(mesh), mesh.shape))


def _is_spec(x) -> bool:
    return isinstance(x, P)


def _map(fn, tree, *rest, is_leaf=_is_spec):
    """``fn`` over the leaves of nested dicts, lists and tuples, a leaf
    being what ``is_leaf`` accepts or anything that is not a container;
    ``rest`` share ``tree``'s structure down to its leaves."""
    if tree is None:
        return None
    if is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
                            for i, v in enumerate(tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of tensors; a path holds dict keys
    and sequence indices."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


# ---------------------------------------------------------------------------
# Activation-sharding context.
# ---------------------------------------------------------------------------

_ACT_CTX = threading.local()


@contextlib.contextmanager
def activation_sharding_scope(mesh, mode: str = "train",
                              skip_axes: frozenset = frozenset()):
    """mode="train": batch-pin activations and gather FSDP weights;
    mode="decode": only the cache layout pins apply.  ``skip_axes``: mesh
    axes that a hook must not name."""
    prev = (getattr(_ACT_CTX, "mesh", None),
            getattr(_ACT_CTX, "mode", "train"),
            getattr(_ACT_CTX, "skip_axes", frozenset()))
    _ACT_CTX.mesh = mesh
    _ACT_CTX.mode = mode
    _ACT_CTX.skip_axes = skip_axes
    try:
        yield
    finally:
        _ACT_CTX.mesh, _ACT_CTX.mode, _ACT_CTX.skip_axes = prev


def _scoped(x):
    """The scope's mesh if ``x`` is a DTensor on it, else None."""
    mesh = getattr(_ACT_CTX, "mesh", None)
    if mesh is None or not isinstance(x, DTensor):
        return None
    return mesh


def constrain(x: DTensor, spec: P) -> DTensor:
    """Redistribute ``x`` to ``spec``: a dim that names mesh axes is
    sharded over them (in the mesh's order), a ``None`` dim is replicated,
    an ``UNCONSTRAINED`` dim keeps its placement, and a pending reduction
    (``Partial``) on a mesh axis that the spec does not name is kept.  An
    axis of size 1 is always ``Replicate`` (the same layout, which every
    DTensor op takes)."""
    mesh = x.device_mesh
    names = axis_names(mesh)
    entries = list(spec) + [None] * (x.ndim - len(spec))
    named = {}
    for d, e in enumerate(entries):
        if e is P.UNCONSTRAINED or e is None:
            continue
        for a in (e if isinstance(e, (tuple, list)) else (e,)):
            named[a] = d
    sizes = mesh_shape(mesh)
    out = []
    for a, cur in zip(names, x.placements):
        if sizes[a] == 1:
            out.append(Replicate())
        elif a in named:
            out.append(Shard(named[a]))
        elif (isinstance(cur, Shard)
              and entries[cur.dim % x.ndim] is not P.UNCONSTRAINED):
            out.append(Replicate())
        else:
            out.append(cur)
    if tuple(out) == tuple(x.placements):
        return x
    return x.redistribute(mesh, out)


def constrain_batch(x):
    """Pin dim 0 of an activation to the data-parallel axes (no-op outside
    an activation_sharding_scope, in decode mode, on a plain tensor, or
    when the batch does not divide)."""
    mesh = _scoped(x)
    if (mesh is None or x.ndim < 2
            or getattr(_ACT_CTX, "mode", "train") == "decode"):
        return x
    dp = dp_axes(mesh)
    shape = mesh_shape(mesh)
    n = 1
    for a in dp:
        n *= shape[a]
    if n <= 1 or x.shape[0] % n != 0:
        return x
    # Non-batch dims stay UNCONSTRAINED: None would force replication.
    return constrain(x, P(dp, *([P.UNCONSTRAINED] * (x.ndim - 1))))


def constrain_logits(x):
    """Logits: batch over the DP axes AND vocab over the model axis."""
    mesh = _scoped(x)
    if mesh is None or x.ndim < 2:
        return x
    dp = dp_axes(mesh)
    shape = mesh_shape(mesh)
    n = 1
    for a in dp:
        n *= shape[a]
    model_ax = "model" if "model" in shape else None
    if model_ax and x.shape[-1] % shape["model"] != 0:
        model_ax = None
    bax = dp if (n > 1 and x.shape[0] % n == 0) else None
    if bax is None and model_ax is None:
        return x
    return constrain(x, P(bax, *([P.UNCONSTRAINED] * (x.ndim - 2)), model_ax))


def gather_fsdp(w, tp_dim: int | None = None):
    """Just-in-time FSDP: unshard a weight's 'data'-sharded dim right
    before use, keeping the TP dim on 'model'.  Train mode only: serving
    keeps weights 2D-stationary."""
    mesh = _scoped(w)
    if (mesh is None or getattr(_ACT_CTX, "mode", "train") != "train"
            or "data" not in axis_names(mesh)):
        return w
    shape = mesh_shape(mesh)
    model_ax = "model" if "model" in shape else None
    if model_ax and tp_dim is not None and w.shape[tp_dim] % shape["model"]:
        model_ax = None
    entries = [None] * w.ndim
    if tp_dim is not None and model_ax:
        entries[tp_dim] = model_ax
    return constrain(w, P(*entries))


def constrain_kv_layout(x):
    """Pin a (..., KV, hd) cache-layout tensor so the model axis sits on
    whichever of its two trailing dims divides."""
    mesh = _scoped(x)
    if mesh is None or x.ndim < 2 or "model" not in axis_names(mesh):
        return x
    m = mesh_shape(mesh)["model"]
    kv_ax = "model" if x.shape[-2] % m == 0 else None
    hd_ax = None if kv_ax else ("model" if x.shape[-1] % m == 0 else None)
    if kv_ax is None and hd_ax is None:
        return x
    return constrain(x, P(*([P.UNCONSTRAINED] * (x.ndim - 2)), kv_ax, hd_ax))


def reduce_model_partial(x):
    """``x`` with a pending reduction (``Partial``) on ``model`` carried
    out: its last dim sharded over ``model`` where it divides, else whole
    there; anything else as it is.  What a broadcast add of a bias sharded
    on ``model`` needs: torch 2.11's DTensor would make the bias
    ``Partial`` instead, which it cannot redistribute."""
    if not isinstance(x, DTensor):
        return x
    sizes = mesh_shape(x.device_mesh)
    out = [(Shard(x.ndim - 1) if x.shape[-1] % sizes[a] == 0 else Replicate())
           if a == "model" and isinstance(p, Partial) else p
           for a, p in zip(axis_names(x.device_mesh), x.placements)]
    if out == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, out)


def replicate_dim(x, dim: int):
    """``x`` with dim ``dim`` whole on every rank (a plain tensor as it
    is): what an op that indexes along that dim needs."""
    if not isinstance(x, DTensor):
        return x
    spec = [P.UNCONSTRAINED] * x.ndim
    spec[dim] = None
    return constrain(x, P(*spec))


def splittable(x, dim: int, outer: int):
    """``x`` ready for a reshape that splits dim ``dim`` into (``outer``,
    rest): a DTensor whose dim is sharded over more ranks than ``outer``
    divides into is first gathered whole there, since DTensor cannot split
    such a shard; anything else as it is."""
    if isinstance(x, DTensor):
        n = 1
        sizes = mesh_shape(x.device_mesh)
        for a, p in zip(axis_names(x.device_mesh), x.placements):
            if isinstance(p, Shard) and p.dim % x.ndim == dim % x.ndim:
                n *= sizes[a]
        if outer % n:
            x = replicate_dim(x, dim)
    return x


def split_heads(x, *shape):
    """``x.reshape(*shape)`` for a (..., heads * hd) -> (..., heads, hd)
    split, the last dim gathered first where ``heads`` does not divide its
    shards (K/V heads that do not divide ``model``; ``splittable``)."""
    return splittable(x, -1, shape[-2]).reshape(*shape)


def merge_heads(x, *shape):
    """``x.reshape(*shape)`` for a (..., heads, hd) -> (..., heads * hd)
    merge.  A DTensor sharded on ``hd`` (a K/V layout with the model axis
    there) is first gathered whole there: not every torch release can
    merge such a shard."""
    if isinstance(x, DTensor) and any(
            isinstance(p, Shard) and p.dim % x.ndim == x.ndim - 1
            for p in x.placements):
        x = replicate_dim(x, -1)
    return x.reshape(*shape)


def like(src, dst):
    """``src`` in ``dst``'s placements when both are DTensors (a plain
    tensor as it is): what an in-place write into ``dst`` needs, since such
    a write takes ``src``'s local values as they are, a pending reduction
    (``Partial``) included."""
    if isinstance(src, DTensor) and isinstance(dst, DTensor):
        return src.redistribute(dst.device_mesh, dst.placements)
    return src


def embed_rows(table: DTensor, tokens):
    """``table[tokens]`` for a (V, D) DTensor table, on local shards: each
    ``model`` rank looks the tokens up in its slice of the vocab (zeros
    for tokens outside it), so the rows are partial sums over ``model``,
    one rank's each; the batch keeps the tokens' shards where it divides
    the data axes (``local_map`` takes even shards).  A sequence shard
    (the batch specs' fallback when the batch does not divide) is gathered
    whole here: DTensor cannot split a matmul's flattened (batch x
    sequence) dim back where the batch does not divide.
    DTensor's own rules for an index into a vocab-sharded table fail in
    some torch releases."""
    mesh = table.device_mesh
    names = axis_names(mesh)
    sizes = mesh_shape(mesh)
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    V = table.shape[0]
    split = "model" in names and sizes["model"] > 1 and V % sizes["model"] == 0
    tpl = tuple(Shard(0) if a == "model" and split else Replicate() for a in names)
    batch = kernel_placements(mesh, tokens.shape[0])
    kpl = tuple(b if a != "model" and isinstance(p, Shard) and p.dim == 0
                else Replicate()
                for a, p, b in zip(names, tokens.placements, batch))
    opl = tuple(Partial() if a == "model" and split else p for a, p in zip(names, kpl))
    gpl = tuple(p if a == "model" else (Partial() if isinstance(k, Shard) else p)
                for a, p, k in zip(names, tpl, kpl))
    rank, n = model_rank(mesh) if split else (0, 1)

    def local(t, k):
        lo = rank * (V // n)
        inside = (k >= lo) & (k < lo + V // n)
        rows = t[torch.where(inside, k - lo, 0)]
        return torch.where(inside[..., None], rows, torch.zeros_like(rows))

    return local_map(local, out_placements=list(opl), in_placements=(tpl, kpl),
                     in_grad_placements=(gpl, kpl), device_mesh=mesh)(
        table.redistribute(mesh, tpl), tokens.redistribute(mesh, kpl))


def take_last(x, index):
    """``torch.gather(x, -1, index[..., None])[..., 0]``; for a DTensor
    ``x`` the last dim is made whole (pending sums done) and each rank
    gathers from its local shard, ``index`` placed as ``x``'s other dims."""
    if not isinstance(x, DTensor):
        return torch.gather(x, -1, index[..., None])[..., 0]
    mesh, n = x.device_mesh, x.ndim
    xpl = tuple(Replicate() if p.is_partial() or (isinstance(p, Shard)
                                                  and p.dim % n == n - 1) else p
                for p in x.placements)
    ipl = tuple(p if isinstance(p, Shard) else Replicate() for p in xpl)
    if not isinstance(index, DTensor):
        index = DTensor.from_local(index, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
    return local_map(lambda a, i: torch.gather(a, -1, i[..., None])[..., 0],
                     out_placements=list(ipl), in_placements=(xpl, ipl),
                     device_mesh=mesh)(x.redistribute(mesh, xpl),
                                       index.redistribute(mesh, ipl))


def along(fn, x, dim: int):
    """``fn(x)`` for an op that works along ``dim`` alone and is linear (a
    pad with zeros, a slice, a roll).  For a DTensor ``x`` that dim is made
    whole and each rank applies ``fn`` to its local shard, since DTensor
    has no rule for such ops in every torch release."""
    if not isinstance(x, DTensor):
        return fn(x)
    x = replicate_dim(x, dim)
    local = fn(x.to_local())
    shape = list(x.shape)
    shape[dim] = local.shape[dim]
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return DTensor.from_local(local.contiguous(), x.device_mesh, x.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))


def index_copy_(dst, dim: int, index, src):
    """``dst.index_copy_(dim, index, src)``; for a DTensor ``dst`` each
    rank writes its local shard (``src`` first put in ``dst``'s
    placements), since DTensor has no rule for the op in every torch
    release.  ``dim`` must not be sharded there."""
    if not isinstance(dst, DTensor):
        return dst.index_copy_(dim, index, src)
    if any(isinstance(p, Shard) and p.dim % dst.ndim == dim % dst.ndim
           for p in dst.placements):
        raise NotImplementedError("index_copy_ along a sharded dim")
    dst.to_local().index_copy_(dim, index, like(src, dst).to_local())
    return dst


def local(t):
    """A DTensor's local shard; anything else as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def from_local_like(t: torch.Tensor, mesh, placements, like) -> DTensor:
    """``t``, this rank's local shard, as a DTensor on ``mesh`` with
    ``placements`` and ``like``'s global shape and stride (no check, no
    communication)."""
    return DTensor.from_local(t, mesh, placements, run_check=False,
                              shape=like.shape, stride=like.stride())


def on_mesh_of(tree: Any, x) -> Any:
    """``tree``'s tensors as replicated DTensors on ``x``'s mesh when ``x``
    is a DTensor (each rank keeps its own copy: no communication), so that
    a buffer a step allocates (a prefill's cache) can take ``x``'s values;
    ``tree`` as it is otherwise."""
    if not isinstance(x, DTensor):
        return tree
    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim
    return _map(lambda t: DTensor.from_local(t, mesh, rep, run_check=False),
                tree, is_leaf=lambda t: isinstance(t, torch.Tensor))


# ---------------------------------------------------------------------------
# Logical-axis -> mesh-axis rule tables.
# ---------------------------------------------------------------------------


def param_rules(mesh, cfg: ModelConfig, fsdp: bool = True) -> dict:
    axes = axis_names(mesh)
    model_ax = "model" if "model" in axes else None
    data_ax = "data" if ("data" in axes and fsdp) else None
    return {
        "vocab": model_ax,
        "embed": data_ax,     # FSDP on the d_model dim of weights
        "heads": model_ax,
        "kv": model_ax,
        "ff": model_ax,
        # Experts are replicated across the model axis; their d_ff is
        # TP-sharded and d_model FSDP-sharded instead.
        "experts": None,
        "layers": None,
        None: None,
    }


def dp_axes(mesh) -> tuple:
    skip = getattr(_ACT_CTX, "skip_axes", frozenset())
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names and a not in skip)


def spec_from_axes(axes_leaf: tuple, rules: dict) -> P:
    """Map logical axes to mesh axes; a mesh axis may appear only once per
    spec, so later duplicates are dropped (first occurrence wins).
    Embedding tables ("vocab" present) keep only the vocab TP sharding."""
    used: set = set()
    out = []
    for a in axes_leaf:
        entry = rules.get(a)
        if a == "embed" and "vocab" in axes_leaf:
            entry = None
        names = (entry if isinstance(entry, (tuple, list))
                 else [entry] if entry else [])
        if any(n in used for n in names):
            entry = None
            names = []
        used.update(names)
        out.append(entry)
    return P(*out)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields")


def param_specs(axes_tree: Any, mesh, cfg: ModelConfig,
                fsdp: bool = True) -> Any:
    rules = param_rules(mesh, cfg, fsdp=fsdp)
    return _map(lambda a: spec_from_axes(a, rules), axes_tree, is_leaf=_is_axes)


def param_shardings(axes_tree: Any, mesh, cfg: ModelConfig,
                    fsdp: bool = True) -> Any:
    return to_shardings(param_specs(axes_tree, mesh, cfg, fsdp), mesh)


# ---------------------------------------------------------------------------
# Input / batch specs.
# ---------------------------------------------------------------------------


def batch_specs(mesh, shape: ShapeConfig, cfg: ModelConfig) -> dict:
    """A spec per input-spec key for a workload cell."""
    dp = dp_axes(mesh)
    sizes = mesh_shape(mesh)
    ndp = 1
    for a in dp:
        ndp *= sizes[a]
    batch_shardable = shape.global_batch % ndp == 0 and shape.global_batch >= ndp
    bax = dp if batch_shardable else None
    if shape.kind in ("train", "prefill"):
        out = {"tokens": P(bax, None), "labels": P(bax, None),
               "frames": P(bax, None, None), "embeds": P(bax, None, None)}
        if not batch_shardable:
            # SP fallback: shard the sequence dim instead.
            out = {"tokens": P(None, dp), "labels": P(None, dp),
                   "frames": P(None, dp, None), "embeds": P(None, dp, None)}
        return out
    # decode
    seq_ax = None if batch_shardable else "data"
    return {"token": P(bax, None), "kv_len": P(),
            "cache": _CacheSpecRule(bax, seq_ax)}


class _CacheSpecRule:
    """Marker: cache specs are derived per-leaf (see cache_specs)."""

    def __init__(self, batch_ax, seq_ax):
        self.batch_ax = batch_ax
        self.seq_ax = seq_ax


def cache_specs(cache_tree: Any, mesh, cfg: ModelConfig,
                shape: ShapeConfig) -> Any:
    """Per-leaf spec for KV caches / SSM states, by key pattern.

    Leaf layouts (registry):
      k/v                (L, B, S, KV, hd)
      global_k/v         (G, B, S, KV, hd)
      local_k/v          (G, g-1, B, W, KV, hd)
      tail_k/v           (T, B, W, KV, hd)
      cross_k/v          (L, B, S_enc, KV, hd)
      attn_k/v (hybrid)  (G, B, S, KV, hd)
      groups_conv        (G, E, B, K-1, d_inner)
      groups_gla         (G, E, B, H, state, hd)
      tail_conv/tail_gla (T, B, ...)
      rwkv state tuple   ((L,B,1,D), (L,B,H,hd,hd), (L,B,1,D))
    """
    dp = dp_axes(mesh)
    sizes = mesh_shape(mesh)
    ndp = 1
    for a in dp:
        ndp *= sizes[a]
    batch_shardable = shape.global_batch % ndp == 0 and shape.global_batch >= ndp
    bax = dp if batch_shardable else None
    seq_ax = None if batch_shardable else "data"
    model_ax = "model" if "model" in sizes else None

    msize = sizes.get("model", 1) if model_ax else 1

    def kv_hd_axes(kv_dim: int, hd_dim: int):
        """Place the model axis on whichever of (kv heads, head_dim) divides."""
        if kv_dim % msize == 0:
            return model_ax, None
        if hd_dim % msize == 0:
            return None, model_ax
        return None, None

    def leaf_spec(path, leaf) -> P:
        name = "/".join(str(p) for p in path)
        nd = leaf.ndim
        if "conv" in name:           # (..., B, K-1, d_inner)
            return P(*([None] * (nd - 3)), bax, None, model_ax)
        if "gla" in name:            # (..., B, H, state, hd)
            return P(*([None] * (nd - 4)), bax, model_ax, None, None)
        if nd == 6:                  # (G, g-1, B, W, KV, hd)
            kv_ax, hd_ax = kv_hd_axes(leaf.shape[4], leaf.shape[5])
            return P(None, None, bax, None, kv_ax, hd_ax)
        if nd == 5 and any(t in name for t in ("k", "v")) and "gla" not in name:
            # (L/G/T, B, S-or-W, KV, hd)
            kv_ax, hd_ax = kv_hd_axes(leaf.shape[3], leaf.shape[4])
            sax = seq_ax if leaf.shape[2] > 4096 else None
            return P(None, bax, sax, kv_ax, hd_ax)
        # rwkv tuple leaves: (L,B,1,D) or (L,B,H,hd,hd)
        if nd == 4:
            return P(None, bax, None, model_ax)
        if nd == 5:
            return P(None, bax, model_ax, None, None)
        return P(*([None] * max(0, nd - 2)), bax, None) if nd >= 2 else P(None)

    specs = _map_with_path(leaf_spec, cache_tree)
    return sanitize_tree(specs, cache_tree, mesh)


def to_placements(spec: P, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` where tensor dim ``d`` names it, else ``Replicate()``
    (an ``UNCONSTRAINED`` dim names no axis; an axis of size 1 is always
    ``Replicate``)."""
    dims = {}
    for d, e in enumerate(spec):
        if e is None or e is P.UNCONSTRAINED:
            continue
        for a in (e if isinstance(e, (tuple, list)) else (e,)):
            dims[a] = d
    sizes = mesh_shape(mesh)
    return [Shard(dims[a]) if a in dims and sizes[a] > 1 else Replicate()
            for a in axis_names(mesh)]


def to_shardings(spec_tree: Any, mesh) -> Any:
    return _map(lambda s: to_placements(s, mesh), spec_tree)


def place(tree: Any, spec_tree: Any, mesh) -> Any:
    """Each tensor leaf of ``tree`` as a DTensor on ``mesh`` with its
    spec's placements (``distribute_tensor``; a DTensor already there is
    redistributed).  Leaves that are not tensors pass through."""
    def one(spec, t):
        if not isinstance(t, torch.Tensor):
            return t
        pl = to_placements(spec, mesh)
        if isinstance(t, DTensor):
            return t if list(t.placements) == pl else t.redistribute(mesh, pl)
        return distribute_tensor(t, mesh, pl)
    return _map(one, spec_tree, tree)


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    shape = mesh_shape(mesh)
    if isinstance(entry, (tuple, list)):
        n = 1
        for a in entry:
            n *= shape[a]
        return n
    return shape[entry]


def sanitize_spec(spec: P, shape: tuple[int, ...], mesh) -> P:
    """Drop mesh axes from dims they don't divide."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        if entry is not None and dim % _axis_size(mesh, entry) != 0:
            entry = None
        out.append(entry)
    return P(*out)


def sanitize_tree(spec_tree: Any, shape_tree: Any, mesh) -> Any:
    """Apply sanitize_spec leaf-wise (shape_tree: tensors, meta included)."""
    return _map(lambda s, x: sanitize_spec(s, x.shape, mesh), spec_tree,
                shape_tree)


# ---------------------------------------------------------------------------
# Kernels on local shards.
# ---------------------------------------------------------------------------


def kernel_placements(mesh, batch: int, heads: int = 1,
                      head_dim: int | None = None) -> tuple:
    """Placements a kernel's (batch, ..., heads, ...) operand takes under
    ``local_map``: the batch (dim 0) over every mesh axis but ``model``
    when it divides their product (else whole on each rank), the heads
    (dim ``head_dim``) over ``model`` when they divide it (``head_dim``
    None: whole), every other dim (the sequence among them) whole."""
    sizes = mesh_shape(mesh)
    n = 1
    for a, s in sizes.items():
        if a != "model":
            n *= s
    out = []
    for a in axis_names(mesh):
        if sizes[a] == 1:
            out.append(Replicate())
        elif a == "model":
            out.append(Shard(head_dim) if head_dim is not None
                       and heads % sizes[a] == 0 else Replicate())
        else:
            out.append(Shard(0) if batch % n == 0 else Replicate())
    return tuple(out)


def model_rank(mesh) -> tuple[int, int]:
    """(this rank's index on the ``model`` axis, the axis' size); (0, 1)
    without one."""
    if "model" not in axis_names(mesh):
        return 0, 1
    return mesh.get_local_rank("model"), mesh_shape(mesh)["model"]
