"""95th percentile, over every output token after its request's first, of
the time since that request's previous token, in ms (device timeline)."""

import numpy as np


def read(run):
    gaps = run.token_gaps()
    if not gaps:
        return None
    return float(np.percentile(np.repeat([g for _, g in gaps], [b for b, _ in gaps]),
                               95)) * 1e3
