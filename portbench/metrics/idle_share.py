"""The device's idle share of the traced stretch, in %: 1 - (the union of
its kernel, copy and set intervals) / (the stretch's wall time)."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
