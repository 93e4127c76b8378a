"""What decides ``correct``: the served logits and tokens against the plain
reference.

The window keeps the logits of some rows of each recent wave (drawn from
the seed for each wave, one in each stratum of the batch:
``serving.kept_rows``).  Once it has closed, finished waves are sampled
from the seed, the longest prompt first, until ``check_requests``
requests are in; each is run through the reference once, its prompt with
the tokens the program served after it.
Two numbers are compared:

* ``logits_rel_err``: at every served position, the distance of the
  program's logits from the reference's float32 logits, relative to the
  reference's (L2 over the vocabulary); the widest over the sample.  The
  first served position is the prefill's last, the rest are replayed decode
  steps, so this covers the flash forward, the cache both write, the decode
  attention and every layer.
* ``served_not_argmax``: served tokens that are not the greedy token of the
  program's own kept logits (exact: limit 0).

The control puts the reference in the program's place in float8 (e4m3
weights, one scale per output column) and reads the first number on the
same sample.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import traffic as T
from portbench.reference import decoder

ROWS = 2          # requests the reference runs at once


def sample(waves: list, traffic: dict, seed: int) -> list:
    """Finished waves whose logits are still kept: the longest prompt
    first, then others in an order drawn from the seed, until they hold
    ``check_requests`` kept rows."""
    held = [w for w in waves if w.done and w.kept is not None]
    if not held:
        return []
    first = max(held, key=lambda w: w.S)
    rest = [w for w in held if w is not first]
    rng = np.random.default_rng(T.sub_seed(seed, T.SAMPLE, 1))
    picked, n = [], 0
    for w in [first] + [rest[i] for i in rng.permutation(len(rest))]:
        if n >= traffic["check_requests"]:
            break
        picked.append(w)
        n += len(w.rows)
    return picked


def readings(picked: list, weights: dict, model: dict,
             control: bool = False) -> dict[str, float]:
    """{number: reading} over the picked waves' kept rows; with ``control``
    the float8 reference's logits stand in for the program's."""
    rel, wrong = 0.0, 0
    for w in picked:
        n = w.out.shape[1]
        for i in range(0, len(w.rows), ROWS):
            r = w.rows[i:i + ROWS]
            served = w.out.index_select(0, r).long()
            tokens = torch.cat([w.prompts.index_select(0, r).long(), served[:, :-1]], 1)
            wanted = torch.arange(w.S - 1, w.S - 1 + n, device=tokens.device)
            ref = decoder.logits_at(weights, model, tokens, wanted)
            if control:
                got = decoder.logits_at(weights, model, tokens, wanted,
                                        quant=decoder.fp8_weights)
            else:
                got = w.kept[i:i + ROWS].float()
                wrong += int((got.argmax(-1) != served).sum())
            err = (got - ref).norm(dim=-1) / ref.norm(dim=-1)
            rel = max(rel, float(err.max()))
            del ref, got
    return {"logits_rel_err": rel, "served_not_argmax": wrong}
