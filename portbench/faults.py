"""Faults planted under the timed path, to see ``correct`` come out false.

Each is a decode step ``fault(step, params, cache, kv_len, token)`` built
on the program's own step; ``with_step`` makes the model the harness builds
use it, so that the decode graph captures the fault.  The tests plant them
in tiny cells on the CPU; ``calibrate.py --fault`` on the card, at a cell's
own size.
"""

from __future__ import annotations

from unittest import mock

import torch


def with_step(fault):
    """A patch of the program's ``build_model`` whose model decodes with
    ``fault`` wrapped round its own step."""
    from repro_torch.models import registry

    build = registry.build_model

    def faulty(cfg, device):
        api = build(cfg, device)
        step = api.decode_step
        return registry.ModelAPI(**{**api.__dict__, "decode_step": (
            lambda p, c, n, t: fault(step, p, c, n, t))})

    return mock.patch.object(registry, "build_model", faulty)


def state_unchanged(step, p, c, n, t):
    """The step runs on a copy of the cache and returns the cache as it
    was: no decode step's K/V is ever written."""
    from repro_torch.tree import tree_clone

    logits, _ = step(p, tree_clone(c), n, t)
    return logits, c


def half_batch(step, p, c, n, t):
    """Rows past the first half left out; each takes a first-half row's
    logits."""
    logits, c = step(p, c, n, t)
    h = logits.shape[0] // 2
    return torch.cat([logits[:h], logits[:h]])[:logits.shape[0]], c


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch}
