"""Model operations of the traced prefills over their device time at the
bf16 peak, in %: the layers' products over every prompt token, the causal
attention, and the unembedding of the last positions, over the union of
the device intervals launched inside each ``portbench.prefill`` range of
the profiler's trace."""

import sys

from portbench.reference import counts


def read(run):
    if run.trace is None:
        return None
    device = run.trace.spans.get("portbench.prefill", [])
    pre = run.stretch.prefills
    if not pre or len(device) != len(pre):
        print(f"prefill_mfu: {len(device)} prefills traced, {len(pre)} run in "
              f"the stretch: not read", file=sys.stderr)
        return None
    flops = sum(counts.prefill_flops(run.model, B, S) for B, S in pre)
    return 100.0 * flops / (sum(device) * counts.PEAK_BF16_FLOPS)
