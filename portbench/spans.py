"""Device self time of the program's own spans (``repro_torch.obs``) in the
traced stretch of a ``--trace 1`` run.

One rule for both ways in: a device interval belongs to the innermost span
around its launch, and a span's self time is the union of the intervals
that belong to it, so its children's time is not in it.

- Eager work (a prefill): the profiler's ``repro_torch.*`` host ranges.  An
  interval is placed, as ``trace.range_seconds`` places it, at the start of
  the runtime call that launched it (or of the host operation it is linked
  to), inside the innermost ``repro_torch.*`` range around that instant.
  The spans are grouped by the ``portbench.prefill`` range around them.
- A replay of the captured decode step: each ``cudaGraphLaunch`` inside a
  ``portbench.decode_step`` range.  Its device activities (those carrying
  the launch's id), sorted by start, are the graph's nodes in the order the
  capture made them: activity k is node k of the newest capture's
  ``obs.NodeMap``.  A replay with fewer activities than the map has nodes
  (the profiler lost some of its records) is not read, and the readers say
  so on stderr.

``read(run)`` gives ``Spans`` (computed once a profile), or None where the
run has no trace.  Self times are in seconds, by span name without the
``repro_torch.`` prefix.
"""

from __future__ import annotations

import bisect
import dataclasses
import sys
from collections import defaultdict

from portbench.trace import STRETCH, Event, _events, union_seconds

PREFIX = "repro_torch."
PREFILL = "portbench.prefill"
DECODE = "portbench.decode_step"
LAUNCH = "cudaGraphLaunch"


@dataclasses.dataclass
class Spans:
    prefills: list          # [{span: seconds}] of each traced prefill
    replays: list           # [{span: seconds} or None] of each traced replay
    why: str = ""           # what was not read, and why


_cache: list = [None, None]     # [profile, Spans]


def read(run) -> Spans | None:
    if run.trace is None:
        return None
    profile = run.stretch.profile
    if _cache[0] is not profile:
        events = list(_events(profile))
        _cache[:] = [profile, Spans(eager(events, PREFILL), [])]
        try:
            _cache[1].replays, _cache[1].why = replays(events, node_map())
        except LookupError as e:
            _cache[1].why = str(e)
    return _cache[1]


def decode_steps(run, who: str) -> list | None:
    """[(index, (B, cached positions), {span: seconds})] of the traced
    replays read, ``index`` in ``run.stretch.decodes``; None where none is,
    or where the replays are not the stretch's decode steps.  What was not
    read, and why, goes to stderr."""
    s = read(run)
    if s is None:
        return None
    decodes = run.stretch.decodes
    if s.replays and len(s.replays) != len(decodes):
        print(f"{who}: {len(s.replays)} replays traced, {len(decodes)} decode "
              f"steps run in the stretch: not read", file=sys.stderr)
        return None
    if s.why:
        print(f"{who}: {s.why}", file=sys.stderr)
    steps = [(i, d, r) for i, (d, r) in enumerate(zip(decodes, s.replays))
             if r is not None]
    return steps or None


def node_map():
    """The newest capture's ``obs.NodeMap``; LookupError where the program
    keeps none."""
    try:
        from repro_torch import obs
    except ImportError:
        raise LookupError("the program records no spans (no repro_torch.obs): "
                          "not read") from None
    if not obs.maps:
        raise LookupError("the program captured no graph with spans: not read")
    return obs.maps[-1]


def _ranges(events: list[Event], name: str) -> list[tuple[int, int]]:
    """The host ranges ``name`` that start inside the traced stretch."""
    t0, t1 = next((e.start, e.end) for e in events
                  if e.name == STRETCH and not e.dev)
    return sorted((e.start, e.end) for e in events
                  if not e.dev and e.name == name and t0 <= e.start < t1)


def _inside(ranges: list[tuple[int, int]], at: int) -> int:
    """The index of the latest range of ``ranges`` (sorted, disjoint or
    nested) that starts at or before ``at`` and holds it, or -1."""
    i = bisect.bisect_right(ranges, (at, float("inf"))) - 1
    while i >= 0 and ranges[i][1] < at:
        i -= 1
    return i


def eager(events: list[Event], outer: str) -> list[dict]:
    """[{span: self seconds}] of the ``repro_torch.*`` spans inside each
    ``outer`` host range, in order."""
    spans = sorted((e.start, e.end, e.name.removeprefix(PREFIX)) for e in events
                   if not e.dev and e.name.startswith(PREFIX))
    bounds = [(s, e) for s, e, _ in spans]
    runtime, ops = {}, {}
    for e in events:
        if not e.dev:
            if e.name.startswith("cu"):
                runtime[e.corr] = e.start
            elif e.linked == 0:
                ops[e.corr] = e.start
    own: list[list] = [[] for _ in spans]
    for e in events:
        if not e.dev:
            continue
        at = runtime.get(e.corr) if e.corr > 0 else None
        if at is None:
            at = ops.get(e.linked)
        i = -1 if at is None else _inside(bounds, at)
        if i >= 0:
            own[i].append((e.start, e.end))
    outs = _ranges(events, outer)
    grouped: list[dict] = [defaultdict(list) for _ in outs]
    for (start, _, name), iv in zip(spans, own):
        j = _inside(outs, start)
        if j >= 0:
            grouped[j][name].extend(iv)
    return [{n: union_seconds(iv) / 1e9 for n, iv in g.items()} for g in grouped]


def _owners(node_map) -> list:
    """The innermost span of each node, or None: spans are kept in the
    order they opened, so an inner span comes after the span around it."""
    owner = [None] * node_map.nodes
    for name, first, end in node_map.spans:
        owner[first:end] = [name] * (end - first)
    return owner


def replays(events: list[Event], node_map, outer: str = DECODE
            ) -> tuple[list, str]:
    """([{span: self seconds} or None] of each graph replay launched inside
    an ``outer`` host range, in order; what was not read and why).  A
    replay whose activities cannot be matched to the map's nodes is None."""
    outs = _ranges(events, outer)
    launches = sorted((e.start, e.corr) for e in events
                      if not e.dev and e.name.startswith(LAUNCH)
                      and _inside(outs, e.start) >= 0)
    acts: dict[int, list] = defaultdict(list)
    for e in events:
        if e.dev and e.corr > 0:
            acts[e.corr].append((e.start, e.end))
    owner = _owners(node_map)
    out, short = [], {}
    for i, (_, corr) in enumerate(launches):
        iv = sorted(acts[corr])
        if len(iv) != node_map.nodes:
            out.append(None)
            short[i + 1] = len(iv)
            continue
        by: dict = defaultdict(list)
        for name, interval in zip(owner, iv):
            if name is not None:
                by[name].append(interval)
        out.append({n: union_seconds(v) / 1e9 for n, v in by.items()})
    why = ""
    if short:
        why = (f"replays {sorted(short)} of {len(out)} not read: device "
               f"activities {[short[i] for i in sorted(short)]}, the graph's "
               f"nodes {node_map.nodes}")
    return out, why
