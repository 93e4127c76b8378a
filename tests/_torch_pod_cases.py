"""The port's compressed pod train step on 8 gloo ranks, (pod 2, data 2,
model 2), on the CPU.

``python tests/_torch_pod_cases.py PARAMS OUT`` spawns the 8 ranks over a
file store, loads the params that PARAMS holds (``torch.save`` of a tree:
the JAX package's init carried across), and writes from rank 0 to OUT
(``torch.save``):

  * ``step``: ``STEPS`` steps of ``make_compressed_pod_train_fn`` on the
    reference test's batch (``default_rng(0)``, 8 x 32 over a vocab of
    256; lr 1e-3, one warmup step, 10 total): losses and grad norms;
  * ``no_residual`` and ``data_gather``: the same with a planted fault,
    the residuals dropped (each leaf's new residual zeroed) or the int8
    payloads gathered over ``data`` instead of ``pod``;
  * ``int8``: the collectives of one step, as (op, dtype, group) seen by a
    dispatch mode, beside the ``pod`` group's name;
  * ``exchange``: ``pod_exchange`` alone on fixed fp32 gradients and
    residuals (``exchange_inputs``), each pod's tensors sharded over its
    (data, model) submesh: the mean gradient and each pod's new residual,
    gathered whole.

Every collective has a 60 s timeout, so a rank left waiting fails the run
instead of hanging it.  Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import tempfile
from datetime import timedelta

import numpy as np
import torch

SHAPE = (2, 2, 2)
AXES = ("pod", "data", "model")
STEPS = 6
LAYERS, VOCAB, B, S = 2, 256, 8, 32
EXCHANGE_SHAPE = (6, 10)


def config():
    from repro_torch.configs import get_config, reduced_config
    return dataclasses.replace(reduced_config(get_config("tinyllama_1p1b")),
                               num_layers=LAYERS, vocab_size=VOCAB)


def train_config():
    from repro_torch.train.loop import TrainConfig
    return TrainConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)


def batch() -> dict:
    """The reference test's fixed batch."""
    rng = np.random.default_rng(0)
    return {k: torch.from_numpy(rng.integers(0, VOCAB, (B, S)).astype(np.int32))
            for k in ("tokens", "labels")}


def exchange_inputs(npods: int = 2) -> tuple[np.ndarray, np.ndarray]:
    """Fixed fp32 gradients and residuals, one of each a pod, with a few
    large entries so that the scale is set by one element."""
    rng = np.random.default_rng(7)
    g = rng.standard_normal((npods,) + EXCHANGE_SHAPE).astype(np.float32)
    g[:, 0, 0] *= 50.0
    e = (rng.standard_normal((npods,) + EXCHANGE_SHAPE) * 0.01).astype(np.float32)
    return g, e


def steps(api, params, mesh) -> dict:
    """STEPS steps from fresh moments and residuals: losses, grad norms."""
    from repro_torch.optim import adamw_init
    from repro_torch.train.loop import init_pod_compression, make_compressed_pod_train_fn
    step = make_compressed_pod_train_fn(api, train_config(), mesh)
    p, opt = params, adamw_init(params)
    comp = init_pod_compression(params, SHAPE[0])
    losses, norms = [], []
    for i in range(STEPS):
        p, opt, comp, m = step(p, opt, comp, batch(), i)
        losses.append(float(m["loss"].full_tensor()))
        norms.append(float(m["grad_norm"].full_tensor()))
    return {"losses": losses, "grad_norms": norms}


def collectives(api, params, mesh) -> dict:
    """(op, dtype, group name) of every c10d collective one step issues."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.optim import adamw_init
    from repro_torch.train.loop import init_pod_compression, make_compressed_pod_train_fn

    seen = []

    class Seen(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func._overloadpacket._qualified_op_name
            if (name.startswith("_c10d_functional::")
                    and not any(w in name for w in ("wait", "wrap"))):
                strs = [a for a in (*args, *(kwargs or {}).values())
                        if isinstance(a, str)]
                seen.append((name.split("::")[1], str(args[0].dtype),
                             strs[-1] if strs else None))
            return func(*args, **(kwargs or {}))

    step = make_compressed_pod_train_fn(api, train_config(), mesh)
    comp = init_pod_compression(params, SHAPE[0])
    with Seen():
        step(params, adamw_init(params), comp, batch(), 0)
    return {"seen": seen, "pod_group": mesh.get_group("pod").group_name}


def exchange(mesh) -> dict:
    """``pod_exchange`` on this rank's pod's fixed inputs, sharded (data on
    dim 0, model on dim 1) over its submesh."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.train.loop import _pod_submesh, pod_exchange
    g, e = exchange_inputs(SHAPE[0])
    pod = mesh.get_local_rank("pod")
    sub = _pod_submesh(mesh)
    pl = [Shard(0), Shard(1)]
    mean, new_e = pod_exchange(distribute_tensor(torch.from_numpy(g[pod]), sub, pl),
                               distribute_tensor(torch.from_numpy(e[pod]), sub, pl),
                               mesh)
    return {"mean": mean.full_tensor().numpy(), "new_e": new_e.full_tensor().numpy(),
            "pod": pod}


def _rank(rank: int, world: int, store: str, params_path: str, out: str):
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=timedelta(seconds=60))
    try:
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.models.registry import build_model
        from repro_torch.train import loop
        mesh = init_device_mesh("cpu", SHAPE, mesh_dim_names=AXES)
        api = build_model(config(), "cpu")
        params = torch.load(params_path, weights_only=False)
        results = {"step": steps(api, params, mesh),
                   "int8": collectives(api, params, mesh)}
        good_exchange, good_gather = loop.pod_exchange, loop._pod_gather

        def no_residual(g, e, mesh):
            mean, new_e = good_exchange(g, e, mesh)
            return mean, new_e * 0.0

        def over_data(t, mesh):
            return good_gather(t, _data_mesh(mesh))

        for name, attr, fault in (("no_residual", "pod_exchange", no_residual),
                                  ("data_gather", "_pod_gather", over_data)):
            good = getattr(loop, attr)
            setattr(loop, attr, fault)
            try:
                results[name] = steps(api, params, mesh)
            finally:
                setattr(loop, attr, good)
        ex = exchange(mesh)
        exs = [None] * world
        dist.all_gather_object(exs, ex)
        results["exchange"] = {"mean": [x["mean"] for x in exs],
                               "new_e": {x["pod"]: x["new_e"] for x in exs}}
        if rank == 0:
            torch.save(results, out)
    finally:
        dist.destroy_process_group()


def _data_mesh(mesh):
    """A stand-in for the mesh whose ``pod`` submesh is the ``data`` axis:
    ``mesh["pod"]`` of it gives ``mesh["data"]``."""
    class Swapped:
        def __getitem__(self, name):
            return mesh["data" if name == "pod" else name]
    return Swapped()


def main(argv: list[str]) -> None:
    import torch.multiprocessing as mp
    params_path, out = argv
    world = int(np.prod(SHAPE))
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(world, os.path.join(tmp, "store"), params_path, out),
                 nprocs=world)


if __name__ == "__main__":
    main(sys.argv[1:])
