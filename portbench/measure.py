"""One run of one cell: set-up, the window, the check, the metrics.

``run_cell`` returns the result line's object.  The metric readers
(``metrics/<name>.py``) read a ``Run``: the waves with their times on the
device's timeline, the set-up time and, in a traced run, the stretch.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time

import torch

from portbench import check, serving
from portbench import trace as trace_mod

FOREIGN = ("jax", "jaxlib", "flax", "repro")   # top-level names never loaded


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    model: dict                  # the configuration file's ``model`` block
    seconds: float               # the window's length: start to last token
    setup_s: float
    waves: list                  # serving.Wave, times in seconds from the start
    stretch: object = None       # serving.Stretch of a traced run
    trace: object = None         # trace.Trace of that stretch

    def token_gaps(self) -> list[tuple[int, float]]:
        """(requests, seconds since their previous token) of every token
        after each request's first."""
        return [(w.B, t - w.t_tokens[j - 1]) for w in self.waves
                for j, t in enumerate(w.t_tokens) if j]

    def step_intervals(self) -> list[float]:
        """Seconds between consecutive token marks of every decode step but
        each wave's first, whose interval holds the cache copy: device time
        and any idle time between steps."""
        return [t - w.t_tokens[j - 1] for w in self.waves
                for j, t in enumerate(w.t_tokens) if j >= 2]


def foreign_modules() -> list[str]:
    """Loaded modules whose top-level name is one that must not load."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)


def _warm_profiler() -> None:
    """Start the profiler once, so that a traced window does not pay its
    first start."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def timeline(waves: list) -> str:
    """The window's waves in brief, for the log: each one's prompt length
    and the seconds of its start, first and last token, and the longest gap
    between two marks of the window."""
    marks = sorted((t, w.index) for w in waves for t in [w.t_start] + w.t_tokens)
    gap, at = max(((b[0] - a[0], a) for a, b in zip(marks, marks[1:])),
                  default=(0.0, (0.0, -1)))
    brief = " ".join(f"{w.S}@{w.t_start:.3f}/{w.t_tokens[0]:.3f}/{w.t_tokens[-1]:.3f}"
                     for w in waves if w.t_tokens)
    return (f"waves (S@start/first/last s) {brief}; longest gap {gap:.4f} s "
            f"after {at[0]:.3f} s in wave {at[1]}")


def steps_in_brief(run: Run) -> str:
    """The traced decode steps' device times beside the intervals between
    step marks over the whole window, in ms, for the log."""
    dev = [f"{t * 1e3:.3f}" for t in run.trace.spans.get("portbench.decode_step", [])]
    placed = sum(sum(v) for v in run.trace.spans.values())
    gaps = sorted(run.step_intervals())
    mid = gaps[len(gaps) // 2] * 1e3 if gaps else float("nan")
    return (f"decode step device ms (trace) {' '.join(dev)}; median interval "
            f"between step marks over the window {mid:.3f} ms ({len(gaps)} steps); "
            f"device time placed in ranges {placed:.6f} s of {run.trace.busy_s:.6f}")


def free(server) -> None:
    """Drop the program's cache and captured graph (the weights stay: the
    benchmark made them, and the reference reads them; so do the kept
    logits, which the check reads)."""
    server.step = server.cache = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def judge(waves: list, cell, seed: int, server) -> tuple[dict, int]:
    """({number: (reading, limit)}, requests failed).  A run that kept no
    finished wave reads infinity: nothing it served was checked."""
    picked = check.sample(waves, cell.traffic, seed)
    limits = cell.traffic["limit"]
    if not picked:
        return {k: (math.inf, v) for k, v in limits.items()}, 1
    got = check.readings(picked, server.params, cell.config["model"])
    out = {k: (got[k], limits[k]) for k in limits}
    return out, 0 if passed(out) else sum(len(w.rows) for w in picked)


def passed(readings: dict) -> bool:
    return all(v <= lim for v, lim in readings.values())


def run_cell(cell, seed: int, seconds: float, trace: bool, t0: float,
             device: str = "cuda") -> dict:
    with torch.inference_mode():
        server = serving.setup(cell, seed, device)
        cuda = server.api.device.type == "cuda"
        if trace and cuda:
            _warm_profiler()
        setup_s = time.perf_counter() - t0
        waves, stretch = serving.window(server, cell.traffic, seed, seconds, trace)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        free(server)
        readings, failed = judge(waves, cell, seed, server)
    run = Run(cell.config["model"], waves[-1].t_tokens[-1], setup_s, waves, stretch,
              trace_mod.read(stretch.profile) if stretch else None)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = m.read(run)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": passed(readings),
              "attempted": sum(w.B for w in waves),
              "failed": failed, "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"], dev["window_s"] = run.trace.busy_s, run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    print(f"portbench: {timeline(waves)}", file=sys.stderr)
    if run.trace is not None:
        print(f"portbench: {steps_in_brief(run)}", file=sys.stderr)
    result["check"] = {k: {"value": v, "limit": lim} for k, (v, lim) in readings.items()}
    return result
