"""95th percentile, over every request of the window, of the time from when
its wave was due (the previous wave's last token, or the window's start)
to its first token, in ms."""

import numpy as np


def read(run):
    times, weights, due = [], [], 0.0
    for w in run.waves:
        times.append(w.t_tokens[0] - due)
        weights.append(w.B)
        due = w.t_tokens[-1]
    if not times:
        return None
    return float(np.percentile(np.repeat(times, weights), 95)) * 1e3
