#!/usr/bin/env python3
"""Readings that set a cell's limits: the numbers ``correct`` compares, for
the program over many seeds, for the float8 control and for a planted fault,
in one process.

    python3 portbench/calibrate.py --workload <cell> --seconds <s> \
        --seeds <n> ... [--control <n> ...] [--fault state_unchanged|half_batch]

On the card, at the cell's own size and load: the model is built and the
decode graph captured once; each seed draws its weights into the same
tensors, runs a window of ``--seconds`` and reads the numbers a run
compares (``check.readings``) on the sample a run draws, and whether they
pass the cell's limits (``measure.passed``).  For a seed in ``--control``
the float8 reference is put in the program's place on the same sample and
judged the same way.  With ``--fault`` the decode graph captures that fault
(``faults.py``) and every reading is the broken program's.  One JSON line a
seed on standard output.  The benchmark's own runs never run this.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--fault", choices=["state_unchanged", "half_batch"])
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench import check, faults, measure, serving, spec, weights

    cell = spec.load_cell(args.workload)
    limits = cell.traffic["limit"]

    def judged(got: dict) -> dict:
        out = {k: (got[k], limits[k]) for k in limits}
        return {"readings": got, "correct": measure.passed(out)}

    plant = (faults.with_step(faults.FAULTS[args.fault]) if args.fault
             else contextlib.nullcontext())
    with torch.inference_mode():
        with plant:
            server = serving.setup(cell, args.seeds[0])
        model = cell.config["model"]
        for seed in args.seeds:
            weights.refill(server.params, seed)
            waves, _ = serving.window(server, cell.traffic, seed, args.seconds)
            picked = check.sample(waves, cell.traffic, seed)
            t = time.perf_counter()
            row = {"workload": args.workload, "seed": seed, "fault": args.fault,
                   "requests": sum(len(w.rows) for w in picked),
                   "tokens": sum(len(w.rows) * w.out.shape[1] for w in picked),
                   "program": judged(check.readings(picked, server.params, model)),
                   "reference_s": time.perf_counter() - t}
            if seed in args.control:
                got = check.readings(picked, server.params, model, control=True)
                row["control"] = judged(got)
            row["device"] = torch.cuda.get_device_name(0)
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
