"""The flash-attention forward's share of its roofline in the traced
stretch, in %: the sum of its calls' least times (from their shapes, one
causal call a layer a prefill) over the device time of the kernels the
profiler names ``flash_attention(_wgmma)_kernel``.  Nothing is read where
the stretch holds no prefill, or where the calls it counts differ from the
launches the program's wrapper counted on the wgmma route."""

import re
import sys

from portbench.reference import counts

KERNEL = re.compile(r"flash_attention(_wgmma)?_kernel[<(]")


def read(run):
    if run.trace is None or not run.stretch.prefills:
        return None
    m = run.model
    L, H, KV = m["num_layers"], m["num_heads"], m["num_kv_heads"]
    hd = m.get("head_dim") or m["d_model"] // H
    spans = [e - s for name, s, e in run.trace.kernels if KERNEL.search(name)]
    want = L * len(run.stretch.prefills)
    routes = run.stretch.flash_routes
    if len(spans) != want or routes.get("wgmma") != want or sum(routes.values()) != want:
        print(f"flash_roofline: {len(spans)} kernels traced, launches by route "
              f"{routes}, {want} calls expected on wgmma: not read", file=sys.stderr)
        return None
    least = sum(L * counts.least_seconds(*counts.flash_call(B, S, S, H, KV, hd))
                for B, S in run.stretch.prefills)
    return 100.0 * least / sum(spans)
