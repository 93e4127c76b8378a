"""Mesh construction on ``torch.distributed``'s ``DeviceMesh``.

Port of ``repro.launch.mesh``.  Functions, not module-level constants, so
importing this module starts no process group: callers decide when.

Axis meanings (the reference's):

  pod    cross-pod data parallelism (gradient all-reduce only)
  data   in-pod data parallelism + FSDP parameter sharding
  model  tensor/expert parallelism

Each call joins the default process group, starting one if there is none:
from the launcher's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``) when it sets ``WORLD_SIZE``, else a world of one on an
in-process store.  The backend is NCCL on ``cuda`` and gloo on the CPU.
The reference's hardware constants belong to its TPU and are not carried
over.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device


def ensure_process_group(device: str | torch.device = "cuda") -> None:
    """Start the default process group for ``device`` if none exists."""
    if dist.is_initialized():
        return
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def _mesh(shape: tuple, axes: tuple, device) -> DeviceMesh:
    dev = resolve_device(device)
    ensure_process_group(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device = "cuda") -> DeviceMesh:
    """(data 16, model 16), or (pod 2, data 16, model 16): 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_test_mesh(devices: int | None = None,
                   device: str | torch.device = "cuda") -> DeviceMesh:
    """A small (data, model) mesh over ``devices`` ranks (default: the
    world's size): (1, 1) for one, else (n // 2, 2)."""
    ensure_process_group(device)
    n = devices or dist.get_world_size()
    if n == 1:
        return _mesh((1, 1), ("data", "model"), device)
    d = max(1, n // 2)
    return _mesh((d, n // d), ("data", "model"), device)
