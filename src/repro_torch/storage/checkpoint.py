"""Distributed checkpointing on the DDS storage path.

Port of ``repro.storage.checkpoint`` for trees of tensors (nested dicts,
tuples and lists; numpy arrays are taken too).  Division of labor follows
the paper's partial-offload policy (§3):

  * **Saves** are complex, durable, and batched — they take the HOST path
    (DDS front-end library -> DMA rings -> DPU file service).  Saves can be
    asynchronous (write-behind thread), so the train loop never blocks on
    storage: the paper's non-blocking WriteFile + notification groups.

  * **Restores** are simple cold reads — exactly what DDS offloads.  Byte
    ranges of checkpoint files are read back, optionally *resharded onto a
    different mesh* (elastic restart after losing nodes): each host reads
    only the contiguous ranges its new shards need.

Atomic commit: leaf files are written first, the JSON manifest is written
LAST and fsync'd; a checkpoint without a manifest is invisible.  This gives
crash consistency without rename support in the segment FS.

The format is the reference's, so a checkpoint saved by either package
restores in the other: leaves are named as ``jax.tree_util`` paths (dict
keys sorted, sequence entries by index, joined by ``/``), and a leaf file
holds the raw bytes of a C-order array.  numpy has no bfloat16 of its own,
so a bf16 tensor is written as its 2-byte payload (a ``uint16`` view) with
``dtype: "bfloat16"`` in the manifest, and read back through the same view;
the JAX package reads those bytes through ``ml_dtypes``, which the port
does not need.  Restored leaves are CPU tensors.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.core.dds_server import DDSStorageServer
from repro_torch.tree import leaf_paths, tree_map

BF16 = "bfloat16"


def _leaf_paths(tree: Any) -> list[tuple[str, Any]]:
    """[(name, leaf)] in ``jax.tree_util.tree_flatten_with_path``'s order
    and naming."""
    return [("/".join(str(p) for p in path) or "leaf", leaf)
            for path, leaf in leaf_paths(tree)]


def _host(leaf: Any) -> tuple[np.ndarray, str]:
    """A leaf as a host array of its bytes and the manifest's dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy(), BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _tensor(raw: bytes, dtype: str, shape: list[int]) -> torch.Tensor:
    """Bytes of a leaf file -> a CPU tensor of ``dtype`` and ``shape``."""
    if dtype == BF16:
        arr = np.frombuffer(raw, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(raw, dtype=dtype).reshape(shape).copy())


def _rebuild(template: Any, arrays: dict[str, torch.Tensor],
             prefix: tuple = ()) -> Any:
    """``template``'s structure with each leaf replaced by its array."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _rebuild(v, arrays, prefix + (k,)) for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_rebuild(getattr(template, f), arrays,
                                         prefix + (f".{f}",))
                                for f in template._fields))
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(v, arrays, prefix + (i,))
                              for i, v in enumerate(template))
    name = "/".join(str(p) for p in prefix) or "leaf"
    if name not in arrays:
        raise KeyError(f"checkpoint missing leaf {name}")
    return arrays[name]


@dataclass
class CheckpointInfo:
    step: int
    nbytes: int
    wall_s: float
    leaves: int


class CheckpointManager:
    """Save/restore trees of tensors to a DDS storage server."""

    MANIFEST_PREFIX = "manifest-"

    def __init__(self, server: DDSStorageServer, keep: int = 3):
        self.server = server
        self.keep = keep
        self._history: list[CheckpointInfo] = []
        self._async_thread: threading.Thread | None = None
        self._async_err: list[BaseException] = []
        self._lock = threading.Lock()

    # -- save -------------------------------------------------------------------------
    def save(self, step: int, tree: Any) -> CheckpointInfo:
        t0 = time.perf_counter()
        fe = self.server.frontend
        leaves = _leaf_paths(tree)
        manifest: dict[str, Any] = {"step": step, "leaves": {}}
        total = 0
        for name, leaf in leaves:
            arr, dtype = _host(leaf)
            raw = arr.tobytes()
            fid = fe.create_file(f"ckpt-{step}/{name}")
            fe.write_sync(fid, 0, raw)
            manifest["leaves"][name] = {
                "file_id": fid, "shape": list(arr.shape),
                "dtype": dtype, "nbytes": len(raw),
            }
            total += len(raw)
        # Commit point: manifest written last + metadata fsync.
        mid = fe.create_file(f"{self.MANIFEST_PREFIX}{step}")
        fe.write_sync(mid, 0, json.dumps(manifest).encode())
        fe.fsync()
        self.server.run_until_idle()
        info = CheckpointInfo(step, total, time.perf_counter() - t0, len(leaves))
        with self._lock:
            self._history.append(info)
        self._gc()
        return info

    def save_async(self, step: int, tree: Any) -> None:
        """Write-behind save of a host copy of ``tree`` (taken before this
        returns, so the caller may go on changing its tensors); call
        ``wait_async`` before depending on it."""
        self.wait_async()
        host_tree = tree_map(
            lambda x: x.detach().to("cpu", copy=True)
            if isinstance(x, torch.Tensor) else np.array(x), tree)

        def work():
            try:
                self.save(step, host_tree)
            except BaseException as e:  # surfaced by wait_async
                self._async_err.append(e)

        self._async_thread = threading.Thread(target=work, daemon=True,
                                              name=f"ckpt-save-{step}")
        self._async_thread.start()

    def wait_async(self) -> None:
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None
        if self._async_err:
            raise self._async_err.pop()

    # -- discovery ------------------------------------------------------------------------
    def _manifests(self) -> dict[int, int]:
        """step -> manifest file id, scanning the root directory."""
        out = {}
        for fid, meta in self.server.fs.files.items():
            if meta.name.startswith(self.MANIFEST_PREFIX):
                try:
                    out[int(meta.name[len(self.MANIFEST_PREFIX):])] = fid
                except ValueError:
                    pass
        return out

    def latest_step(self) -> int | None:
        steps = self._manifests()
        return max(steps) if steps else None

    def _read_manifest(self, step: int) -> dict:
        mid = self._manifests().get(step)
        if mid is None:
            raise FileNotFoundError(f"no committed checkpoint for step {step}")
        size = self.server.fs.file_size(mid)
        raw = self.server.frontend.read_sync(mid, 0, size)
        return json.loads(raw.decode())

    def _read_leaf(self, m: dict) -> torch.Tensor:
        raw = self.server.frontend.read_sync(m["file_id"], 0, m["nbytes"])
        return _tensor(raw, m["dtype"], m["shape"])

    # -- restore -----------------------------------------------------------------------------
    def restore(self, step: int, template: Any | None = None) -> Any:
        """Full restore: {name: tensor}, or with ``template`` a tree of its
        structure."""
        manifest = self._read_manifest(step)
        arrays = {name: self._read_leaf(m)
                  for name, m in manifest["leaves"].items()}
        if template is None:
            return arrays
        return _rebuild(template, arrays)

    def restore_shard(self, step: int, name: str,
                      start_row: int, end_row: int) -> torch.Tensor:
        """Elastic restore: read ONLY the byte range of rows [start, end).

        Row-sharding over axis 0 (FSDP) makes each shard a contiguous byte
        range — the cold, simple read the DPU offload path is built for.
        A new mesh shape just changes the (start,end) each host requests.
        """
        manifest = self._read_manifest(step)
        m = manifest["leaves"][name]
        shape = m["shape"]
        if not shape:
            raise ValueError("cannot row-shard a scalar leaf")
        itemsize = 2 if m["dtype"] == BF16 else np.dtype(m["dtype"]).itemsize
        row_bytes = int(np.prod(shape[1:], dtype=np.int64)) * itemsize
        raw = self.server.frontend.read_sync(m["file_id"], start_row * row_bytes,
                                             (end_row - start_row) * row_bytes)
        return _tensor(raw, m["dtype"], [end_row - start_row] + shape[1:])

    def restore_elastic(self, step: int, template: Any,
                        shard_index: int, num_shards: int) -> Any:
        """Restore this host's row-shards for a num_shards-way layout (a
        leaf that is a scalar or does not split evenly comes back whole)."""
        manifest = self._read_manifest(step)
        arrays = {}
        for name, leaf in _leaf_paths(template):
            shape = tuple(np.shape(leaf))
            if not shape or shape[0] % num_shards != 0:
                arrays[name] = self._read_leaf(manifest["leaves"][name])
                continue
            rows = shape[0] // num_shards
            arrays[name] = self.restore_shard(
                step, name, shard_index * rows, (shard_index + 1) * rows)
        return _rebuild(template, arrays)

    # -- retention -----------------------------------------------------------------------------
    def _gc(self) -> None:
        steps = sorted(self._manifests())
        fe = self.server.frontend
        while len(steps) > self.keep:
            victim = steps.pop(0)
            manifest = self._read_manifest(victim)
            mid = self._manifests()[victim]
            for m in manifest["leaves"].values():
                fe.delete_file(m["file_id"])
            fe.delete_file(mid)
        self.server.run_until_idle()
