"""Median, over the traced replays of the captured decode step, of each
one's device time in the program's ``repro_torch.attend`` spans, in ms:
every layer's core attention (in the dense step the casts of the cache to
fp32, the two products, the mask and the softmax; not the K/V row's write),
placed through the capture's node map (``spans.py``; a replay whose
records the profiler did not keep whole is left out, and said)."""

import statistics

from portbench import spans


def read(run):
    steps = spans.decode_steps(run, "decode_attn_ms")
    if not steps:
        return None
    return statistics.median(r.get("attend", 0.0) for _, _, r in steps) * 1e3
