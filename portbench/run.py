#!/usr/bin/env python3
"""Run one cell of the benchmark on the card and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell is looked up by name in
``BENCHMARK.json``; its configuration, traffic and metric readers are files
under ``portbench/``.  The run sets up (weights made on the card from the
seed, kernels built or loaded from ``build/``, one warm prefill and the
decode graph's capture), starts waves for ``--seconds`` and runs each to
its last token, checks the served tokens against the plain reference, and
prints one JSON object as the last line of standard output: the end-to-end metrics with ``--trace 0``, the
per-layer metrics, ``breakdown`` and the device's busy and traced seconds
with ``--trace 1``.  The compared numbers and their limits are the last
lines of standard error and the last key of that object.  Without a card,
or with fewer cards than the cell asks for, it exits 3 and prints no
result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import spec

    try:
        cell = spec.load_cell(args.workload)
    except spec.SpecError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    # Every compile cache at a fixed path inside the checkout.
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    from portbench import measure

    result = measure.run_cell(cell, args.seed, args.seconds, bool(args.trace), T0)
    foreign = measure.foreign_modules()
    if foreign:
        print(f"portbench: modules that must not load were loaded: {foreign}",
              file=sys.stderr)
        return 4
    for name, c in result["check"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
