"""The traced decode steps' share of the chip's peak on the roofline, in %:
the sum of each step's least time (the larger of its operations over the
bf16 peak and its bytes over the memory rate; weights read once, the live
K/V read once, the new K/V and logits written once) over the sum of their
device times in the profiler's trace (``decode_step_ms``'s intervals)."""

import sys

from portbench.reference import counts


def read(run):
    if run.trace is None:
        return None
    device = run.trace.spans.get("portbench.decode_step", [])
    steps = run.stretch.decodes
    if not steps or len(device) != len(steps):
        print(f"decode_mfu: {len(device)} decode steps traced, {len(steps)} "
              f"run in the stretch: not read", file=sys.stderr)
        return None
    least = sum(counts.least_seconds(*counts.decode_step(run.model, B, kv))
                for B, kv in steps)
    return 100.0 * least / sum(device)
