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

The hardware constants below are the counterparts of the reference's
roofline denominators, for an NVIDIA H100 80GB HBM3 at its 700 W limit (the
card whose name and power limit ``chip_smoke.py`` prints); none of the
reference's TPU values carries over.  The dry run
(``repro_torch.launch.dryrun``) divides by them.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device

# NVIDIA H100 80GB HBM3, 700 W (SXM5).  NVIDIA H100 Tensor Core GPU
# datasheet: dense bf16 tensor-core rate (without sparsity).
PEAK_FLOPS_BF16 = 989e12
# Same datasheet: HBM3 bandwidth of the SXM5 part, bytes/s.
HBM_BW = 3.35e12
# The card's memory as torch.cuda.get_device_properties(0).total_memory
# reads it on an NVIDIA H100 80GB HBM3 (chip_smoke.py phase 1 prints it).
HBM_PER_GPU = 85_017_493_504
# Same datasheet: NVLink 4, 900 GB/s a GPU in both directions, so 450e9
# bytes/s each way: the rate between two GPUs of one node.
NVLINK_BW = 450e9
# GPUs that one NVLink domain joins: an HGX H100 8-GPU node (NVIDIA DGX H100
# user guide).
GPUS_PER_NODE = 8
# Between nodes: one ConnectX-7 400 Gb/s NDR InfiniBand NIC a GPU (NVIDIA DGX
# H100 user guide), 50e9 bytes/s each way.
NIC_BW = 50e9


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
