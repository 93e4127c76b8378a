"""The prefill layers' own products over their device time at the bf16
peak, in %: 2 * B * S * L operations a matmul weight of each layer (Q, K,
V, O, the MLP) over every prompt token of the traced prefills, over the
self time of their ``repro_torch.layer`` spans (the attention inside is
its own span; the cache's fill, the embedding and the unembedding are
outside), from the profiler's host ranges (``spans.py``)."""

import sys

from portbench import spans
from portbench.reference import counts


def read(run):
    s = spans.read(run)
    pre = run.stretch.prefills if run.stretch else []
    if s is None or not pre:
        return None
    own = [p.get("layer", 0.0) for p in s.prefills]
    if len(own) != len(pre) or not all(own):
        print(f"prefill_dense_mfu: {sum(map(bool, own))} of {len(own)} traced "
              f"prefills hold repro_torch.layer spans, {len(pre)} run in the "
              f"stretch: not read", file=sys.stderr)
        return None
    flops = sum(2.0 * B * S * run.model["num_layers"]
                * counts.layer_matmul_params(run.model) for B, S in pre)
    return 100.0 * flops / (sum(own) * counts.PEAK_BF16_FLOPS)
