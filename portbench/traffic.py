"""The one traffic generator: closed-loop waves of requests, read from a
cell's ``workloads/<cell>.json``.

A wave is ``batch`` requests with one prompt length (a prefill takes no
ragged batch).  The lengths run from ``prompt_len.from`` to
``prompt_len.to`` in steps of ``prompt_len.step``; each cycle through them
pairs the shortest left with the longest left, so that any two waves of a
pair carry the same number of prompt tokens, and the seed shuffles the
order of the pairs and of the two waves in each.  So every seed offers the
same mix of sizes, in another order.  Prompt tokens are drawn from the
seed, wave by wave, on the device.
"""

from __future__ import annotations

import numpy as np
import torch


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one stream of ``seed``'s draws."""
    ss = np.random.SeedSequence([int(seed) % 2**64, *tags])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


WEIGHTS, PROMPTS, ORDER, SAMPLE = 1, 2, 3, 4     # the streams of a seed


def lengths(traffic: dict) -> list[int]:
    p = traffic["prompt_len"]
    return list(range(p["from"], p["to"] + 1, p["step"]))


def schedule(traffic: dict, seed: int, waves: int) -> list[int]:
    """The prompt length of each of the first ``waves`` waves."""
    rng = np.random.default_rng(sub_seed(seed, ORDER))
    ls = sorted(lengths(traffic))
    pairs = [(ls[i], ls[-1 - i]) for i in range(len(ls) // 2)]
    if len(ls) % 2:
        pairs.append((ls[len(ls) // 2],))
    out: list[int] = []
    while len(out) < waves:
        for j in rng.permutation(len(pairs)):
            pair = list(pairs[j])
            if rng.random() < 0.5:
                pair.reverse()
            out.extend(pair)
    return out[:waves]


def prompts(traffic: dict, seed: int, wave: int, S: int, vocab: int,
            device) -> torch.Tensor:
    """The (batch, S) int32 prompt tokens of wave ``wave``."""
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, PROMPTS, wave))
    return torch.randint(0, vocab, (traffic["batch"], S), generator=g,
                         device=device, dtype=torch.int32)
