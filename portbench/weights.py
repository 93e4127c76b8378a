"""Seeded weights, made on the device in the shapes and dtypes the model's
init reports, one draw per leaf of the stacked tree.

A matrix (its last two dims) is drawn N(0, 1/fan_in), fan_in its rows; the
embedding table N(0, 0.02^2).  Vectors are drawn too, so that the
comparison covers them: biases N(0, 0.02^2); a LayerNorm weight 1 + N(0,
0.1^2); an RMSNorm weight, stored as ``w`` in ``1 + w``, N(0, 0.1^2).
The same tensors go to the program and to the reference.
"""

from __future__ import annotations

import torch

from portbench import traffic


def _scale_shift(path: tuple[str, ...], shape: tuple[int, ...], stacked: bool
                 ) -> tuple[float, float]:
    leaf = path[-1]
    if leaf == "embed":
        return 0.02, 0.0
    if len(shape) - int(stacked) >= 2:
        return shape[-2] ** -0.5, 0.0
    if leaf.endswith("_b") or leaf in ("bq", "bk", "bv"):
        return 0.02, 0.0
    if leaf.endswith("_w"):
        return 0.1, 1.0
    return 0.1, 0.0


def _draw(tree: dict, seed: int) -> dict:
    """Fill every leaf of ``tree`` in place from ``seed``, in tree order."""
    g = None

    def fill(t, path):
        nonlocal g
        if isinstance(t, dict):
            for k, v in t.items():
                fill(v, path + (k,))
            return
        if g is None:
            g = torch.Generator(device=t.device)
            g.manual_seed(traffic.sub_seed(seed, traffic.WEIGHTS))
        scale, shift = _scale_shift(path, tuple(t.shape), path[0] == "blocks")
        t.normal_(generator=g).mul_(scale)
        if shift:
            t.add_(shift)

    fill(tree, ())
    return tree


def _empty(tree, device):
    if isinstance(tree, dict):
        return {k: _empty(v, device) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device=device)


def make(shapes: dict, seed: int, device) -> dict:
    """A tree like ``shapes`` (meta tensors) filled from ``seed``."""
    return _draw(_empty(shapes, device), seed)


def refill(params: dict, seed: int) -> None:
    """Draw ``seed``'s weights into ``params`` in place (a captured graph
    keeps reading the same tensors)."""
    _draw(params, seed)


def leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree
