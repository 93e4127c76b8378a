"""Train step (single-device and sharded) and Trainer with DDS checkpoints.

Port of ``repro.train.loop``:

  * gradients by ``torch.autograd.grad`` over the registry loss, with each
    layer recomputed in the backward (``remat`` in the model's forward); on
    the card attention's forward and backward are the flash kernels
    (``kernels.flash_attention.kernel.FlashAttentionFn``);
  * optional microbatch gradient accumulation, into fp32 zeros as in the
    reference, so accumulated gradients are fp32 (with one microbatch they
    keep the parameters' dtype);
  * AdamW with global-norm clipping, out of place or, for ``Trainer``, in
    place (``make_train_fn(..., donate=True)``);
  * optional int8 error-feedback compression of the gradients
    (``compress_pod_grads``), compressed and decompressed on one device.

The step is eager: no CUDA graph is captured.  ``make_train_step`` runs
the same out-of-place step on DTensors placed by the sharding rules over a
``DeviceMesh`` (the reference's jit with in/out shardings).
``make_compressed_pod_train_fn`` is the multi-pod step whose cross-pod
gradient exchange is an all-gather of int8 payloads over the ``pod`` axis,
with per-pod error-feedback residuals from ``init_pod_compression``.

``Trainer`` drives steps with data from the deterministic pipeline and
checkpoints ``{params, mu, nu}`` through the DDS storage path
(write-behind, manifest last).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import P
from repro_torch.models.registry import ModelAPI, build_model
from repro_torch.optim import AdamWState, adamw_init, adamw_update, warmup_cosine
from repro_torch.optim.compression import (CompressionState, _dequantize,
                                           _quantize, compress_tree,
                                           decompress_tree, init_compression)
from repro_torch.tree import tree_map


@dataclass
class TrainConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    max_grad_norm: float = 1.0
    microbatch: int = 1           # gradient-accumulation splits
    fsdp: bool = True             # "embed" on 'data' in make_train_step
    compress_pod_grads: bool = False
    b1: float = 0.9
    b2: float = 0.95


def abstract_init(api: ModelAPI):
    """(parameter shapes as ``meta`` tensors, axes tree), without
    allocating anything: the init runs on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        params, axes = build_model(api.cfg, "cpu").init(torch.Generator())
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
                    params), axes


def _split_micro(batch: dict, n: int) -> dict:
    """Every (B, ...) entry -> (n, B // n, ...)."""
    def sp(x):
        B = x.shape[0]
        if B % n:
            raise ValueError(f"batch {B} does not split into {n} microbatches")
        return x.reshape(n, B // n, *x.shape[1:])
    return {k: sp(v) for k, v in batch.items()}


def value_and_grad(api: ModelAPI, params: Any, batch: dict
                   ) -> tuple[torch.Tensor, Any]:
    """(loss, gradient tree) of ``api.loss_fn`` at ``params``; gradients
    in the parameters' dtypes, zeros for a leaf the loss does not reach."""
    flat: list[torch.Tensor] = []

    def leaf(t):
        flat.append(t.detach().requires_grad_())
        return flat[-1]

    with torch.enable_grad():
        loss, _ = api.loss_fn(tree_map(leaf, params), batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(t)
              for g, t in zip(grads, flat))
    return loss.detach(), tree_map(lambda _: next(it), params)


def compute_grads(api: ModelAPI, tcfg: TrainConfig, params: Any,
                  batch: dict) -> tuple[Any, torch.Tensor]:
    """(gradient tree, loss) of one step's batch.  With ``microbatch`` > 1
    the batch is split and the gradients summed into fp32 zeros, as the
    reference's scan carry (in place, the same sums as its out-of-place
    adds, to hold one accumulator and not two), then scaled in place by
    1 / microbatch: fp32 gradients.  With 1 they keep the parameters'
    dtypes."""
    if tcfg.microbatch == 1:
        loss, g = value_and_grad(api, params, batch)
        return g, loss
    micro = _split_micro(batch, tcfg.microbatch)
    g = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device), params)
    loss_sum = None
    for i in range(tcfg.microbatch):
        loss, gi = value_and_grad(api, params, {k: v[i] for k, v in micro.items()})
        tree_map(lambda a, b: a.add_(b), g, gi)
        loss_sum = loss if loss_sum is None else loss_sum + loss
        del gi
    inv = 1.0 / tcfg.microbatch
    return tree_map(lambda x: x.mul_(inv), g), loss_sum * inv


def _lr(tcfg: TrainConfig, step) -> torch.Tensor:
    return warmup_cosine(step, peak_lr=tcfg.peak_lr,
                         warmup_steps=tcfg.warmup_steps,
                         total_steps=tcfg.total_steps)


def make_train_fn(api: ModelAPI, tcfg: TrainConfig,
                  donate: bool = False) -> Callable:
    """(params, opt_state, comp_state, batch, step) -> (params, opt_state,
    comp_state, metrics), where ``step`` is an int.

    ``donate=False``: out of place, as the reference's step; the given
    params and moments are left as they were.  ``donate=True`` (after
    ``jax.jit``'s ``donate_argnums``): the step writes the new params and
    moments into the tensors it was given and returns those same trees,
    so the device holds one copy of the state; the bits are those of the
    out-of-place step.  A write-behind checkpoint cannot race it:
    ``CheckpointManager.save_async`` takes its host copy before it
    returns."""

    def train_step(params, opt_state, comp_state, batch, step):
        grads, loss = compute_grads(api, tcfg, params, batch)
        if tcfg.compress_pod_grads and comp_state is not None:
            # int8 error-feedback quantization of the gradient exchange.
            q, scales, comp_state = compress_tree(grads, comp_state)
            grads = decompress_tree(q, scales)
        lr = _lr(tcfg, step)
        new_params, new_opt, gnorm = adamw_update(
            grads, opt_state, params, lr,
            b1=tcfg.b1, b2=tcfg.b2, weight_decay=tcfg.weight_decay,
            max_grad_norm=tcfg.max_grad_norm, donate=donate)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return new_params, new_opt, comp_state, metrics

    return train_step


def make_train_step(api: ModelAPI, mesh, axes_tree, tcfg: TrainConfig,
                    batch_spec: dict | None = None):
    """The train step with explicit in/out shardings for ``mesh``: returns
    ``(step_fn, jit_for)``, ``step_fn`` the out-of-place
    ``make_train_fn`` step.

    ``jit_for(batch_like)`` gives ``run(params, opt_state, comp_state,
    batch, step)``, which places params and the AdamW moments by the
    parameter specs, sanitized for their shapes as the reference's dry run
    places them (``count`` replicated), the compression residuals
    likewise and the batch by ``batch_spec`` (default: batch dims over the
    data-parallel axes), runs ``step_fn`` on those DTensors under an
    ``activation_sharding_scope(mesh, "train")``, and returns params and
    state in the same placements and the metrics replicated.  Plain
    tensors a step makes (positions, masks, zero states) act as
    replicated.  Inputs already placed so are not copied.
    """
    pspecs = sh.param_specs(axes_tree, mesh, api.cfg, fsdp=tcfg.fsdp)
    dp = sh.dp_axes(mesh)
    bspec = batch_spec or {"tokens": P(dp, None), "labels": P(dp, None),
                           "frames": P(dp, None, None),
                           "embeds": P(dp, None, None)}
    step_fn = make_train_fn(api, tcfg)

    def filter_bspec(batch_like):
        return {k: bspec.get(k, P(dp, None)) for k in batch_like}

    def place_state(params, opt_state, comp_state):
        specs = sh.sanitize_tree(pspecs, params, mesh)
        params = sh.place(params, specs, mesh)
        opt = AdamWState(sh.place(opt_state.count, P(), mesh),
                         sh.place(opt_state.mu, specs, mesh),
                         sh.place(opt_state.nu, specs, mesh))
        if comp_state is not None:
            comp_state = CompressionState(sh.place(comp_state.error, specs, mesh))
        return params, opt, comp_state

    def jit_for(batch_like):
        bspecs = filter_bspec(batch_like)

        def run(params, opt_state, comp_state, batch, step):
            params, opt_state, comp_state = place_state(params, opt_state,
                                                        comp_state)
            batch = sh.place(batch, {k: bspecs[k] for k in batch}, mesh)
            with sh.activation_sharding_scope(mesh, "train"), implicit_replication():
                out = step_fn(params, opt_state, comp_state, batch, step)
            params, opt_state, comp_state = place_state(*out[:3])
            metrics = {k: sh.place(v, P(), mesh) if isinstance(v, DTensor) else v
                       for k, v in out[3].items()}
            return params, opt_state, comp_state, metrics

        return run

    return step_fn, jit_for


def _pod_submesh(mesh):
    """This rank's pod: the submesh of every axis but ``pod``."""
    return mesh[tuple(a for a in sh.axis_names(mesh) if a != "pod")]


def _to_pod(t: DTensor, sub) -> DTensor:
    """A DTensor on the full mesh, replicated over ``pod``, as the same
    local shard on this rank's pod submesh (no communication)."""
    names = sh.axis_names(t.device_mesh)
    pl = [p for a, p in zip(names, t.placements) if a != "pod"]
    return sh.from_local_like(t.to_local(), sub, pl, t)


def _from_pod(t: DTensor, mesh) -> DTensor:
    """The inverse of ``_to_pod``: ``t`` on the full mesh, replicated over
    ``pod``."""
    inner = iter(t.placements)
    pl = [Replicate() if a == "pod" else next(inner) for a in sh.axis_names(mesh)]
    return sh.from_local_like(t.to_local(), mesh, pl, t)


def _pod_gather(t: torch.Tensor, mesh) -> torch.Tensor:
    """(npods, *t.shape): every pod's ``t``, all-gathered over ``pod``."""
    return DTensor.from_local(t[None], mesh["pod"], [Shard(0)],
                              run_check=False).full_tensor()


def pod_exchange(g: DTensor, e: DTensor, mesh) -> tuple[DTensor, DTensor]:
    """One leaf's cross-pod exchange (the reference's ``exchange``):
    ``x = g + e`` in fp32, one scale ``max|x| / 127`` over the whole tensor
    of this pod (a max over its shards), the int8 payload and the scale
    all-gathered over ``pod`` only and dequantized, and the mean over pods.
    ``g`` and ``e`` live on this rank's pod submesh; ``g`` is first put in
    ``e``'s placements.  Returns (the mean gradient, the new residual
    ``x - deq(q)``), both in ``e``'s placements."""
    sub = e.device_mesh
    x = sh.like(g, e).to_local().float() + e.to_local()
    amax = x.abs().amax()
    for a, p in zip(sh.axis_names(sub), e.placements):
        if p.is_shard():
            amax = funcol.all_reduce(amax, "max", sub.get_group(a))
    q, s = _quantize(x, amax)
    new_e = x - _dequantize(q, s)
    qg = _pod_gather(q, mesh)              # int8 on the pod links
    sg = _pod_gather(s, mesh)
    deq = qg.float() * sg.reshape((qg.shape[0],) + (1,) * x.ndim)
    return (sh.from_local_like(deq.mean(0), sub, e.placements, e),
            sh.from_local_like(new_e, sub, e.placements, e))


def make_compressed_pod_train_fn(api: ModelAPI, tcfg: TrainConfig,
                                 mesh) -> Callable:
    """Train step with a wire-level int8 cross-pod gradient exchange:
    ``(params, opt_state, comp_state, batch, step) -> (params, opt_state,
    comp_state, metrics)`` on a mesh with a ``pod`` axis.

    The reference's semantics (``shard_map`` manual over ``pod``):

      * each pod computes the loss and gradients of its own rows of the
        batch (split over ``pod``) on its (data, model) submesh, without
        microbatching, under an ``activation_sharding_scope`` that skips
        ``pod``; flash and ``gla_scan`` run on local shards there;
      * per leaf, ``pod_exchange``: an int8 payload and an fp32 scale per
        tensor all-gathered over ``pod`` and averaged, with the residual
        kept per pod;
      * the loss is averaged over ``pod`` and AdamW runs on the mean
        gradient over the whole mesh.

    Params and moments are placed as given: a DTensor keeps its placements
    (replicated over ``pod``), a plain tensor is replicated over the mesh,
    as the reference's jit places an uncommitted array.  The residuals
    (``init_pod_compression``) carry a leading pod dim, ``Shard(0)`` on
    ``pod`` and the parameter's placements inside.  Returns params and
    moments replicated over ``pod``, the residuals as placed, and the
    metrics replicated.
    """
    names = sh.axis_names(mesh)
    npods = sh.mesh_shape(mesh)["pod"]
    sub = _pod_submesh(mesh)
    rep = [Replicate()] * mesh.ndim

    def on_mesh(t):
        if isinstance(t, DTensor):
            pl = [Replicate() if a == "pod" else p
                  for a, p in zip(names, t.placements)]
            return t if list(t.placements) == pl else t.redistribute(mesh, pl)
        return DTensor.from_local(t, mesh, rep, run_check=False)

    def err_on_mesh(e, p):
        """A residual (npods, *p.shape) placed Shard(0) on ``pod`` and by
        ``p``'s placements inside."""
        pod = Shard(0) if npods > 1 else Replicate()
        pl = [pod if a == "pod" else (Shard(q.dim + 1) if q.is_shard() else q)
              for a, q in zip(names, p.placements)]
        if isinstance(e, DTensor):
            return e if list(e.placements) == pl else e.redistribute(mesh, pl)
        return distribute_tensor(e, mesh, pl)

    def per_pod(params, err, batch):
        """(mean gradient, new residual, loss) on full-mesh DTensors."""
        p_sub = tree_map(lambda t: _to_pod(t, sub), params)
        b_sub = {k: DTensor.from_local(v.to_local(), sub, [Replicate()] * sub.ndim,
                                       run_check=False)
                 for k, v in batch.items()}
        with sh.activation_sharding_scope(sub, "train",
                                          skip_axes=frozenset({"pod"})):
            loss, grads = value_and_grad(api, p_sub, b_sub)

        def one(g, e, p):
            mean, new_e = pod_exchange(
                g, sh.from_local_like(e.to_local()[0], sub, p.placements, p), mesh)
            return (_from_pod(mean, mesh),
                    sh.from_local_like(new_e.to_local()[None], mesh, e.placements, e))

        out = tree_map(one, grads, err, p_sub)
        mean_g, new_err = (tree_map(lambda _, o: o[i], grads, out) for i in range(2))
        local = loss.full_tensor() if isinstance(loss, DTensor) else loss
        loss = funcol.all_reduce(local.float(), "sum", mesh.get_group("pod")) / npods
        return mean_g, new_err, DTensor.from_local(loss, mesh, rep, run_check=False)

    def train_step(params, opt_state, comp_state, batch, step):
        params = tree_map(on_mesh, params)
        opt_state = AdamWState(on_mesh(opt_state.count),
                               tree_map(on_mesh, opt_state.mu),
                               tree_map(on_mesh, opt_state.nu))
        err = tree_map(err_on_mesh, comp_state.error, params)
        for k, v in batch.items():
            if v.shape[0] % npods:
                raise ValueError(f"batch {k} of {v.shape[0]} rows does not "
                                 f"split over {npods} pods")
        batch = sh.place(batch, {k: P("pod", *([None] * (v.ndim - 1)))
                                 for k, v in batch.items()}, mesh)
        with implicit_replication():
            grads, new_err, loss = per_pod(params, err, batch)
            lr = _lr(tcfg, step)
            new_params, new_opt, gnorm = adamw_update(
                grads, opt_state, params, lr,
                b1=tcfg.b1, b2=tcfg.b2, weight_decay=tcfg.weight_decay,
                max_grad_norm=tcfg.max_grad_norm)
        metrics = {"loss": loss, "grad_norm": sh.place(gnorm, P(), mesh)
                   if isinstance(gnorm, DTensor) else gnorm, "lr": lr}
        return new_params, new_opt, CompressionState(new_err), metrics

    return train_step


def init_pod_compression(params: Any, npods: int) -> CompressionState:
    """Per-pod error-feedback residuals: fp32 zeros with a leading pod dim
    of ``npods``, as a ``CompressionState`` (the reference's single-device
    ``init_train_state`` wraps its state in a 1-tuple; ROADMAP.md, Queue
    3).  ``make_compressed_pod_train_fn`` places them on its mesh."""
    def zeros(p):
        return torch.zeros((npods,) + tuple(p.shape), dtype=torch.float32,
                           device=sh.local(p).device)
    return CompressionState(error=tree_map(zeros, params))


def init_train_state(api: ModelAPI, tcfg: TrainConfig,
                     generator: torch.Generator | None = None,
                     params: Any = None):
    """(params, AdamW state, compression state or None, axes).

    ``params`` given (a JAX tree through ``interop.to_torch``, or a copy)
    are used as they are (``Trainer``'s steps then update them in place),
    and axes is then None; else ``api.init``
    draws them from ``generator`` (seed 0 on the model's device by
    default).  With ``compress_pod_grads`` the compression state is a
    ``CompressionState``: the reference wraps it in a 1-tuple, which its
    own step cannot read (ROADMAP.md, Queue 3).
    """
    axes = None
    if params is None:
        params, axes = api.init(generator)
    opt = adamw_init(params)
    comp = init_compression(params) if tcfg.compress_pod_grads else None
    return params, opt, comp, axes


def _init_from_start(api: ModelAPI, generator: torch.Generator | None,
                     params: Any) -> Callable:
    """``api.init`` for a Trainer started from ``generator`` or ``params``:
    called with no generator it gives the params the Trainer started from
    again (a draw from ``generator`` as it stood, or a host copy of
    ``params``), where ``api.init(None)`` draws from seed 0.  That is what
    ``TrainSupervisor`` re-inits to when it restarts with no checkpoint
    (``init_train_state(trainer.api, trainer.tcfg)``): the reference's
    Trainer takes neither argument, so its re-init is its start."""
    if params is not None:
        kept = tree_map(lambda t: t.detach().to("cpu", copy=True), params)

        def again():
            return tree_map(lambda t: t.to(api.device, copy=True), kept), None
    elif generator is not None:
        state, device = generator.get_state(), generator.device

        def again():
            return api.init(torch.Generator(device=device).set_state(state))
    else:
        return api.init
    return lambda generator: again() if generator is None else api.init(generator)


class Trainer:
    """End-to-end driver: pipeline -> train step -> DDS checkpoints.  Its
    step updates ``params``, ``opt.mu`` and ``opt.nu`` in place
    (``make_train_fn(..., donate=True)``).  Its ``api.init(None)`` gives the
    params it started from (``_init_from_start``; given ``params``, it keeps
    a host copy of them for that)."""

    def __init__(self, api: ModelAPI, tcfg: TrainConfig, pipeline,
                 checkpoint_mgr=None, ckpt_every: int = 100,
                 generator: torch.Generator | None = None, params: Any = None):
        self.api = replace(api, init=_init_from_start(api, generator, params))
        self.tcfg = tcfg
        self.pipeline = pipeline
        self.ckpt = checkpoint_mgr
        self.ckpt_every = ckpt_every
        self.params, self.opt, self.comp, self.axes = init_train_state(
            api, tcfg, generator, params)
        self.step = 0
        self.history: list[dict] = []
        self._step_fn = make_train_fn(api, tcfg, donate=True)

    def state(self) -> dict:
        """What a checkpoint holds: ``{params, mu, nu}``."""
        return {"params": self.params, "mu": self.opt.mu, "nu": self.opt.nu}

    def restore_latest(self) -> bool:
        """Load the latest committed checkpoint into this trainer's
        tensors (copied in place, so the device holds one state, not two)
        and resume at its step.  Raises on a leaf whose shape or dtype
        differs from this trainer's."""
        if self.ckpt is None:
            return False
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        tree = self.state()
        back = self.ckpt.restore(latest, tree)

        def load(dst, src):
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(f"checkpoint leaf {tuple(src.shape)} {src.dtype} "
                                 f"does not fit {tuple(dst.shape)} {dst.dtype}")
            dst.copy_(src)

        with torch.no_grad():
            tree_map(load, tree, back)
        self.opt = self.opt._replace(count=torch.full(
            (), latest, dtype=torch.int32, device=self.opt.count.device))
        self.step = latest
        return True

    def run(self, steps: int) -> list[dict]:
        dev = self.api.device
        for _ in range(steps):
            batch = {k: torch.as_tensor(v).to(dev)
                     for k, v in self.pipeline.batch_at(self.step).items()}
            self.params, self.opt, self.comp, metrics = self._step_fn(
                self.params, self.opt, self.comp, batch, self.step)
            rec = {k: float(v) for k, v in metrics.items()}
            rec["step"] = self.step
            self.history.append(rec)
            self.step += 1
            if self.ckpt is not None and self.step % self.ckpt_every == 0:
                self.ckpt.save_async(self.step, self.state())
        if self.ckpt is not None:
            self.ckpt.wait_async()
        return self.history
