"""Median device time of one replay of the captured decode step in the
traced stretch, in ms: the union of the device intervals launched inside
each ``portbench.decode_step`` range (the graph's kernels and the counter's
update), read from the profiler's trace, so idle time is not in it."""

import statistics


def read(run):
    steps = run.trace.spans.get("portbench.decode_step") if run.trace else None
    return statistics.median(steps) * 1e3 if steps else None
