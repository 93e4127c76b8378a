"""Cases of the port's sharded entry points, run on gloo ranks on the CPU.

``python tests/_torch_sharded_cases.py DATA MODEL BATCH OUT [GROUP]``
spawns DATA x MODEL ranks on a ("data", "model") mesh over a file store,
runs ``CASES[(DATA, MODEL)]`` (or ``CASES[GROUP]``) through
``make_train_step`` and ``make_serve_fns`` and writes,
from rank 0, every result gathered whole to OUT (``torch.save``).
``unsharded`` computes the same results on one process without a mesh:
``tests/test_torch_sharded_ranks.py`` holds the two against each other.
Every collective has a 60 s timeout, so a rank left waiting fails the
run instead of hanging it.  Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import tempfile
from datetime import timedelta

import numpy as np
import torch

S = 16
STEPS = 2
DECODE = 2
# (name, arch, changes to the reduced config, what to run)
CASES = {
    (2, 2): [
        ("tinyllama_kv1", "tinyllama_1p1b", {}, ("train", "serve", "comms")),
        ("tinyllama_kv2", "tinyllama_1p1b", {"num_kv_heads": 2}, ("train",)),
        ("tinyllama_h6_kv3", "tinyllama_1p1b", {"num_heads": 6, "num_kv_heads": 3},
         ("train", "fault")),
        ("granite", "granite_moe_3b_a800m", {}, ("train",)),
        ("rwkv6", "rwkv6_7b", {}, ("train",)),
        ("seamless", "seamless_m4t_medium", {}, ("train",)),
        ("zamba2", "zamba2_1p2b", {"num_layers": 5}, ("train",)),
    ],
    (4, 1): [
        ("tinyllama_sp", "tinyllama_1p1b", {}, ("train", "serve")),
        ("rwkv6_sp", "rwkv6_7b", {}, ("train",)),
    ],
    # the "dots" remat policy (tests/test_torch_remat.py), on a 2 x 2 mesh
    "dots": [
        ("tinyllama_dots", "tinyllama_1p1b", {"remat": "dots"}, ("train",)),
        ("granite_dots", "granite_moe_3b_a800m", {"remat": "dots"}, ("train",)),
        ("rwkv6_dots", "rwkv6_7b", {"remat": "dots"}, ("train",)),
        ("zamba2_dots", "zamba2_1p2b", {"remat": "dots", "num_layers": 5}, ("train",)),
    ],
}


def setup(arch: str, changes: dict, batch: int):
    """(api, fp32 params, axes, train batch, prefill batch) of a case:
    seeded params and numpy-drawn tokens."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models.registry import build_model
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(reduced_config(get_config(arch)),
                              **{"num_layers": 2, **changes})
    api = build_model(cfg, "cpu")
    params, axes = api.init(torch.Generator().manual_seed(0))
    params = tree_map(lambda t: t.float(), params)
    rng = np.random.default_rng(1)
    tb = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, S)).astype(np.int64))
          for k in ("tokens", "labels")}
    if cfg.family == "encdec":   # S bf16 frames of d_model a sequence
        tb["frames"] = torch.from_numpy(
            rng.standard_normal((batch, S, cfg.d_model)).astype(np.float32)
        ).to(torch.bfloat16)
    return api, params, axes, tb, {"tokens": tb["tokens"]}


def _serve_shape(batch: int):
    from repro_torch.configs.base import ShapeConfig
    return ShapeConfig("serve", "prefill", S, batch)


def _to_np(tree):
    from repro_torch.tree import leaves
    from torch.distributed.tensor import DTensor
    return [(t.full_tensor() if isinstance(t, DTensor) else t).detach().numpy()
            for t in leaves(tree)]


def _scalar(t) -> float:
    from torch.distributed.tensor import DTensor
    return float(t.full_tensor() if isinstance(t, DTensor) else t)


def train(api, params, axes, batch, mesh=None):
    """STEPS out-of-place steps from fresh AdamW moments: per-step losses
    and grad norms, then params, mu and nu as numpy leaves.  The batch is
    placed by ``batch_specs`` of a train shape, which shards the sequence
    where the batch does not divide the data axes."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import batch_specs
    from repro_torch.train.loop import (TrainConfig, init_train_state,
                                        make_train_fn, make_train_step)
    tcfg = TrainConfig()
    params, opt, comp, _ = init_train_state(api, tcfg, params=params)
    if mesh is not None:
        shape = ShapeConfig("train", "train", S, batch["tokens"].shape[0])
        step = make_train_step(api, mesh, axes, tcfg,
                               batch_specs(mesh, shape, api.cfg))[1](batch)
    else:
        step = make_train_fn(api, tcfg)
    losses, norms = [], []
    for i in range(STEPS):
        params, opt, comp, metrics = step(params, opt, comp, batch, i)
        losses.append(_scalar(metrics["loss"]))
        norms.append(_scalar(metrics["grad_norm"]))
    return {"loss": losses, "grad_norm": norms, "params": _to_np(params),
            "mu": _to_np(opt.mu), "nu": _to_np(opt.nu)}


def serve(api, params, axes, pbatch, mesh=None):
    """Prefill logits, then DECODE decode steps' logits from an S + DECODE
    cache that an unsharded prefill filled."""
    tok = pbatch["tokens"][:, :1]
    cache = api.prefill(params, pbatch, S + DECODE)[1]
    if mesh is None:
        prefill = lambda p, b: api.prefill(p, b)
        decode = api.decode_step
    else:
        from repro_torch.serve.engine import make_serve_fns
        pre, dec = make_serve_fns(api, mesh, axes, _serve_shape(tok.shape[0]))
        prefill, decode = pre(pbatch), dec(cache)
    out = {"prefill": _to_np(prefill(params, pbatch)[0])}
    steps = []
    for i in range(DECODE):
        logits, cache = decode(params, cache, S + i, tok)
        steps.append(_to_np(logits)[0])
    out["decode"] = steps
    return out


def unsharded(name: str, batch: int) -> dict:
    for cases in CASES.values():
        for case, arch, changes, what in cases:
            if case == name:
                api, params, axes, tb, pb = setup(arch, changes, batch)
                out = {"train": train(api, params, axes, tb)}
                if "serve" in what:
                    out["serve"] = serve(api, params, axes, pb)
                return out
    raise KeyError(name)


def comm_counts(api, params, axes, batch, mesh) -> dict:
    """Collectives of one sharded train step, by kind (CommDebugMode)."""
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.train.loop import TrainConfig, init_train_state, make_train_step
    tcfg = TrainConfig()
    p, opt, comp, _ = init_train_state(api, tcfg, params=params)
    run = make_train_step(api, mesh, axes, tcfg)[1](batch)
    with CommDebugMode() as comm:
        run(p, opt, comp, batch, 0)
    return {str(k): v for k, v in comm.get_comm_counts().items()}


def _rank(rank: int, world: int, shape: tuple, group, batch: int, store: str,
          out: str):
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=timedelta(seconds=60))
    try:
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.kernels.flash_attention import ops as flash_ops
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        results = {}
        for name, arch, changes, what in CASES[group]:
            api, params, axes, tb, pb = setup(arch, changes, batch)
            res = {"train": train(api, params, axes, tb, mesh)}
            if "serve" in what:
                res["serve"] = serve(api, params, axes, pb, mesh)
            if "comms" in what:
                res["comms"] = comm_counts(api, params, axes, tb, mesh)
            if "fault" in what:
                # planted: every rank takes the K/V heads of model rank 0
                good = flash_ops.kv_heads_for_rank
                flash_ops.kv_heads_for_rank = (
                    lambda k, v, r, n, g: good(k, v, 0, n, g))
                try:
                    res["fault"] = train(api, params, axes, tb, mesh)
                finally:
                    flash_ops.kv_heads_for_rank = good
            results[name] = res
        if rank == 0:
            torch.save(results, out)
    finally:
        dist.destroy_process_group()


def main(argv: list[str]) -> None:
    import torch.multiprocessing as mp
    data, model, batch, out = int(argv[0]), int(argv[1]), int(argv[2]), argv[3]
    group = argv[4] if len(argv) > 4 else (data, model)
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(data * model, (data, model), group, batch,
                              os.path.join(tmp, "store"), out),
                 nprocs=data * model)


if __name__ == "__main__":
    main(sys.argv[1:])
