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
``DeviceMesh`` (the reference's jit with in/out shardings).  The
reference's ``make_compressed_pod_train_fn`` and ``init_pod_compression``
are not ported yet.

``Trainer`` drives steps with data from the deterministic pipeline and
checkpoints ``{params, mu, nu}`` through the DDS storage path
(write-behind, manifest last).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import P
from repro_torch.models.registry import ModelAPI, build_model
from repro_torch.optim import AdamWState, adamw_init, adamw_update, warmup_cosine
from repro_torch.optim.compression import (CompressionState, compress_tree,
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

    def lr_fn(step):
        return warmup_cosine(step, peak_lr=tcfg.peak_lr,
                             warmup_steps=tcfg.warmup_steps,
                             total_steps=tcfg.total_steps)

    def train_step(params, opt_state, comp_state, batch, step):
        grads, loss = compute_grads(api, tcfg, params, batch)
        if tcfg.compress_pod_grads and comp_state is not None:
            # int8 error-feedback quantization of the gradient exchange.
            q, scales, comp_state = compress_tree(grads, comp_state)
            grads = decompress_tree(q, scales)
        lr = lr_fn(step)
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
    parameter specs (``count`` replicated), the compression residuals
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
        params = sh.place(params, pspecs, mesh)
        opt = AdamWState(sh.place(opt_state.count, P(), mesh),
                         sh.place(opt_state.mu, pspecs, mesh),
                         sh.place(opt_state.nu, pspecs, mesh))
        if comp_state is not None:
            comp_state = CompressionState(sh.place(comp_state.error, pspecs, mesh))
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


class Trainer:
    """End-to-end driver: pipeline -> train step -> DDS checkpoints.  Its
    step updates ``params``, ``opt.mu`` and ``opt.nu`` in place
    (``make_train_fn(..., donate=True)``)."""

    def __init__(self, api: ModelAPI, tcfg: TrainConfig, pipeline,
                 checkpoint_mgr=None, ckpt_every: int = 100,
                 generator: torch.Generator | None = None, params: Any = None):
        self.api = api
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
