"""The traced stretch of a ``--trace 1`` run, read from the profiler.

The stretch is the ``portbench.traced`` range on the host, which begins
and ends with the device synchronised.  Device intervals (kernels,
copies, sets) are clipped to it; busy time is the length of their union,
so kernels that overlap count once.  Each device interval also belongs to
the ``portbench.*`` range (a prefill, a decode step, ...) inside which the
host launched it: the profiler links every interval to the host operation
that launched it, and that operation lies inside one such range.  So each
range's device time is the union of its own intervals, without the idle
time around them.  Idle gaps are named by what the host was doing in the
middle of each: the innermost ``portbench.*`` range and the innermost
operation or runtime call around that instant.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import NamedTuple

import numpy as np

STRETCH = "portbench.traced"
TOP = 10
NAME = 160


@dataclasses.dataclass
class Trace:
    window_s: float
    kernels: list            # (name, start_s, end_s) from the stretch's start
    busy_s: float
    device_ops: list         # [name, seconds] by total device time
    idle_gaps: list          # [what the host did, seconds] by total idle time
    spans: dict              # {range name: [device seconds of each instance]}


class Event(NamedTuple):
    name: str
    dev: bool                # on the device, not the host
    start: int               # ns
    end: int
    corr: int                # the profiler's id of a host operation
    linked: int              # the id of the host operation that launched it


def _events(profile):
    """Every recorded event but the device-side copies of host ranges
    (``record_function``), which are not work on the device."""
    from torch.autograd import DeviceType

    for e in profile.profiler.kineto_results.events():
        dev = e.device_type() == DeviceType.CUDA
        if dev and (e.is_user_annotation() or e.name().startswith("portbench.")):
            continue
        start = e.start_ns()
        yield Event(e.name(), dev, start, start + e.duration_ns(),
                    e.correlation_id(), e.linked_correlation_id())


def short(name: str) -> str:
    """A kernel's name without a leading ``void``, cut to ``NAME``
    characters."""
    name = name.removeprefix("void ")
    return name[:NAME]


def union_seconds(intervals: list[tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def read(profile) -> Trace | None:
    """The stretch's numbers, or None where the profile holds no device
    interval inside it."""
    return from_events(list(_events(profile)))


def from_events(events: list[Event]) -> Trace | None:
    ranges = [(e.start, e.end) for e in events if e.name == STRETCH and not e.dev]
    if not ranges:
        return None
    t0, t1 = ranges[0]
    dev = [e._replace(start=max(e.start, t0), end=min(e.end, t1)) for e in events
           if e.dev and e.end > t0 and e.start < t1]
    if not dev:
        return None
    busy = union_seconds([(e.start, e.end) for e in dev]) / 1e9
    by_name: dict[str, float] = defaultdict(float)
    for e in dev:
        by_name[e.name] += (e.end - e.start) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return Trace((t1 - t0) / 1e9,
                 [(e.name, (e.start - t0) / 1e9, (e.end - t0) / 1e9) for e in dev],
                 busy, [[short(n), v] for n, v in ops],
                 _idle_gaps(events, dev, t0, t1), range_seconds(events, dev, t0, t1))


def range_seconds(events: list[Event], dev: list[Event], t0: int, t1: int) -> dict:
    """{name: [device seconds of each instance, in order]} of the
    ``portbench.*`` host ranges that start in [t0, t1): each the union of
    the device intervals launched inside it.  A device interval carries the
    id of the runtime call that launched it (a replayed graph's kernels
    that of ``cudaGraphLaunch``) and is linked to the host operation around
    that call; the time of either places it in a range."""
    ranges = sorted((e.start, e.end, e.name) for e in events
                    if not e.dev and e.name.startswith("portbench.")
                    and e.name != STRETCH and t0 <= e.start < t1)
    starts = [r[0] for r in ranges]
    runtime, ops = {}, {}
    for e in events:
        if not e.dev:
            if e.name.startswith("cu"):
                runtime[e.corr] = e.start
            elif e.linked == 0:
                ops[e.corr] = e.start
    own: list[list] = [[] for _ in ranges]
    for e in dev:
        at = runtime.get(e.corr) if e.corr > 0 else None
        if at is None:
            at = ops.get(e.linked)
        if at is None:
            continue
        i = bisect.bisect_right(starts, at) - 1
        while i >= 0 and ranges[i][1] < at:     # the innermost range around it
            i -= 1
        if i >= 0:
            own[i].append((e.start, e.end))
    out: dict[str, list[float]] = defaultdict(list)
    for (_, _, name), iv in zip(ranges, own):
        out[name].append(union_seconds(iv) / 1e9)
    return dict(out)


def _idle_gaps(events, dev, t0, t1) -> list:
    """Idle time of the device inside [t0, t1], summed by what the host was
    doing at each gap's middle."""
    spans = sorted((e.start, e.end) for e in dev)
    gaps, end = [], t0
    for s, e in spans:
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if t1 > end:
        gaps.append((end, t1))
    host = [(e.name, e.start, e.end) for e in events if not e.dev and e.name != STRETCH]
    if not gaps or not host:
        return []
    names = [n for n, _, _ in host]
    starts = np.array([s for _, s, _ in host], dtype=np.int64)
    ends = np.array([e for _, _, e in host], dtype=np.int64)
    ours = np.array([n.startswith("portbench.") for n in names])
    total: dict[str, float] = defaultdict(float)
    for s, e in gaps:
        mid = (s + e) // 2
        around = (starts <= mid) & (ends >= mid)
        label = []
        for mask in (around & ours, around & ~ours):
            idx = np.flatnonzero(mask)
            if idx.size:
                label.append(names[idx[np.argmax(starts[idx])]])
        total[" > ".join(label) or "nothing recorded"] += (e - s) / 1e9
    return [[n, v] for n, v in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]
