"""Conversion of the JAX package's parameter and cache pytrees to torch.

The port keeps the JAX layouts so that trees cross over leaf for leaf:
weights stay ``(in, out)`` and apply as ``x @ W``; stacked blocks keep the
layer axis first; caches stay ``(L, B, S, KV, hd)`` and page pools
``(L, P, page, KV, hd)``.  Trees arrive as nested dicts of numpy arrays
(``jax.device_get`` of a JAX tree); non-array leaves such as a pool's
``page`` pass through unchanged.

numpy has no native bf16, so a bf16 leaf (ml_dtypes' ``bfloat16``) goes
through float32, which is exact both ways.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device


def _leaf_to_torch(a: np.ndarray, device: torch.device,
                   dtype: torch.dtype | None) -> torch.Tensor:
    bf16 = a.dtype.name == "bfloat16"
    t = torch.tensor(a.astype(np.float32) if bf16 else a)
    if dtype is None and bf16:
        dtype = torch.bfloat16
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def to_torch(tree: Any, device: str | torch.device = "cuda",
             dtype: torch.dtype | None = None) -> Any:
    """Nested dict of numpy arrays -> the same dict of tensors on ``device``.

    ``dtype`` recasts floating leaves (the parity tests use float32 on both
    sides); integer leaves such as a block table keep their type.
    """
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (np.ndarray, np.generic)):
            return _leaf_to_torch(np.asarray(x), dev, dtype)
        return x

    return conv(tree)


def to_numpy(tree: Any) -> Any:
    """Tensor tree -> numpy tree (bf16 leaves come back as float32)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return tree
