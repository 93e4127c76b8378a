"""Deterministic network-fault injection for the DDS wires.

DDS assumes a lossless DPU network path; every transport the paper
targets can drop, duplicate, reorder, delay, or corrupt frames.  This
module makes those faults *first-class and reproducible*: a
:class:`FaultWire` wraps any :class:`~repro_torch.core.traffic.Wire` or
:class:`~repro_torch.core.traffic.FlowDemuxWire` and perturbs traffic
according to a seeded :class:`FaultSchedule`, in the shared tick domain
of the cluster clock — two same-seed runs inject the exact same faults
at the exact same points, so chaos runs gate like any other benchmark.

Fault taxonomy (one seeded draw per frame selects at most one fault):

  * **drop**    — the frame vanishes; any pool-backed payload is released
    (a NIC dropping a descriptor still completes it).
  * **duplicate** — the frame is delivered, then a payload-materialized
    copy is delivered right behind it (no shared pool ownership).
  * **reorder** — the frame is held and re-injected AFTER the next frame
    that passes (or after one tick if nothing follows), swapping adjacent
    frames the way a multi-path fabric does.
  * **delay**   — the frame is held for a seeded number of ticks and
    released when the clock reaches its due tick.
  * **corrupt** — one seeded bit of a payload copy is flipped; the frame's
    stamped checksum is left stale, so checksum-verifying receivers
    discard it as a loss (and non-verifying ones see the damage — the
    property tests cover both).

Timed partitions are orthogonal to the schedule:
``partition(a, b, until_tick)`` drops every frame whose flow connects
endpoints ``a`` and ``b`` (either direction) until the clock passes
``until_tick`` — the building block for partitioned-primary tests.

Liveness contract: a FaultWire counts its internally-held (delayed /
reorder-held) frames in ``__len__``/``__bool__``, so the scheduler's
busy-predicates keep the owning server runnable until every held frame
has been released — a delayed packet can never strand a quiet cluster.

With no schedule armed and no partitions, every operation delegates
straight to the wrapped wire — no RNG draw, no copy, byte-identical
traffic (property-tested).
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from repro_torch.core.traffic import FiveTuple, Packet

_KINDS = ("dropped", "duplicated", "reordered", "delayed", "corrupted",
          "partition_dropped")


@dataclass
class FaultSchedule:
    """Seeded per-direction fault rates, active in a tick window.

    Rates are per-frame probabilities; at most ONE fault fires per frame
    (a single uniform draw is compared against cumulative thresholds, so
    the draw sequence — and therefore the whole injection trace — is a
    pure function of ``seed`` and the traffic).
    """

    seed: int = 0
    drop: float = 0.0
    dup: float = 0.0
    reorder: float = 0.0
    delay: float = 0.0
    delay_ticks: tuple[int, int] = (1, 4)   # inclusive held-ticks range
    corrupt: float = 0.0
    start_tick: int = 0
    stop_tick: int | None = None            # None = never stops

    def armed(self) -> bool:
        return (self.drop or self.dup or self.reorder or self.delay
                or self.corrupt) > 0.0

    def active(self, now: int) -> bool:
        return (self.start_tick <= now
                and (self.stop_tick is None or now < self.stop_tick))


def _copy_packet(pkt: Packet) -> Packet:
    """Duplicate a packet WITHOUT sharing pool ownership: the copy's
    payload is materialized so releasing the original's slab can never
    pull bytes out from under the duplicate."""
    return Packet(pkt.flow, pkt.seq, bytes(pkt.payload), pkt.flags,
                  pkt.ack, None, pkt.epoch, pkt.csum)


class FaultWire:
    """Fault-injecting wrapper over a ``Wire`` or ``FlowDemuxWire``.

    Exposes the full surface of both wire types (``push``, ``push_many``,
    ``pop``, ``pop_many``, ``pop_flow``, ``drain_flow``, ``flows``,
    ``weight_of``, ``__len__``, ``__bool__``); faults are applied on the
    PUSH side, so consumers see a perturbed but otherwise ordinary wire.
    """

    def __init__(self, inner, clock, schedule: FaultSchedule | None = None,
                 flow_filter=None):
        self.inner = inner
        self.clock = clock
        self.schedule = schedule
        # Optional predicate(FiveTuple) -> bool: only flows it accepts are
        # eligible for injection; everything else passes through verbatim.
        # Lets a harness model a lossy CLIENT network over a reliable
        # backend fabric (e.g. exempt inter-shard replication flows, which
        # have no retransmit layer of their own).
        self.flow_filter = flow_filter
        self._rng = random.Random(schedule.seed if schedule else 0)
        # ``push_many`` has two shapes: Wire takes (pkts), FlowDemuxWire
        # takes (flow, pkts).  Duck-type once at wrap time.
        self._demux = hasattr(inner, "pop_flow")
        self._held: list[tuple[int, Packet]] = []     # (due_tick, pkt)
        self._reorder: list[tuple[int, Packet]] = []  # (held_at_tick, pkt)
        self._partitions: list[tuple[str, str, int]] = []
        self.totals = dict.fromkeys(_KINDS, 0)
        self.flow_counts: dict[FiveTuple, dict[str, int]] = {}

    # -- schedule / partition control ---------------------------------------------
    def partition(self, a: str, b: str, until_tick: int) -> None:
        """Drop every frame between endpoints ``a`` and ``b`` (matched
        against the flow's src/dst ids, either direction) until the
        shared clock passes ``until_tick``."""
        self._partitions.append((a, b, until_tick))

    def injection_stats(self) -> dict:
        """Totals plus per-flow injection counters (JSON-friendly keys)."""
        return {
            "totals": dict(self.totals),
            "held": len(self._held) + len(self._reorder),
            "flows": {
                f"{f.src_ip}:{f.src_port}->{f.dst_ip}:{f.dst_port}":
                    dict(c) for f, c in self.flow_counts.items()},
        }

    # -- internals ----------------------------------------------------------------
    def _count(self, flow: FiveTuple, kind: str) -> None:
        self.totals[kind] += 1
        fc = self.flow_counts.get(flow)
        if fc is None:
            fc = self.flow_counts[flow] = dict.fromkeys(_KINDS, 0)
        fc[kind] += 1

    def _partitioned(self, flow: FiveTuple, now: int) -> bool:
        if not self._partitions:
            return False
        live = [p for p in self._partitions if now < p[2]]
        if len(live) != len(self._partitions):
            self._partitions = live
        ends = (flow.src_ip, flow.dst_ip)
        for a, b, _until in live:
            if (a in ends) and (b in ends):
                return True
        return False

    def _deliver(self, pkt: Packet) -> None:
        self.inner.push(pkt)

    def _release_due(self) -> None:
        """Move every held frame whose due tick has arrived onto the
        inner wire (delayed frames by due tick; reorder-held frames once
        a tick has passed with nothing to slot them behind)."""
        now = self.clock.now
        if self._held:
            due = [h for h in self._held if h[0] <= now]
            if due:
                self._held = [h for h in self._held if h[0] > now]
                for _t, pkt in due:
                    self._deliver(pkt)
        if self._reorder:
            due = [h for h in self._reorder if h[0] < now]
            if due:
                self._reorder = [h for h in self._reorder if h[0] >= now]
                for _t, pkt in due:
                    self._deliver(pkt)

    def _inject(self, pkt: Packet) -> None:
        """Apply at most one fault to ``pkt`` and deliver what survives."""
        now = self.clock.now
        if self._partitioned(pkt.flow, now):
            self._count(pkt.flow, "partition_dropped")
            pkt.consumed()
            return
        sched = self.schedule
        if sched is None or not sched.active(now) or not sched.armed():
            self._deliver(pkt)
            self._flush_reorder()
            return
        if self.flow_filter is not None and not self.flow_filter(pkt.flow):
            self._deliver(pkt)
            self._flush_reorder()
            return
        r = self._rng.random()
        edge = sched.drop
        if r < edge:
            self._count(pkt.flow, "dropped")
            pkt.consumed()
            return
        edge += sched.dup
        if r < edge:
            self._count(pkt.flow, "duplicated")
            self._deliver(pkt)
            self._deliver(_copy_packet(pkt))
            self._flush_reorder()
            return
        edge += sched.reorder
        if r < edge:
            self._count(pkt.flow, "reordered")
            self._reorder.append((now, pkt))
            return
        edge += sched.delay
        if r < edge:
            lo, hi = sched.delay_ticks
            self._count(pkt.flow, "delayed")
            self._held.append((now + self._rng.randint(lo, hi), pkt))
            return
        edge += sched.corrupt
        if r < edge and pkt.nbytes:
            self._count(pkt.flow, "corrupted")
            buf = bytearray(pkt.payload)
            i = self._rng.randrange(len(buf))
            buf[i] ^= 1 << self._rng.randrange(8)
            pkt.consumed()   # the original's slab (if any) goes back
            self._deliver(Packet(pkt.flow, pkt.seq, bytes(buf), pkt.flags,
                                 pkt.ack, None, pkt.epoch, pkt.csum))
            self._flush_reorder()
            return
        self._deliver(pkt)
        self._flush_reorder()

    def _flush_reorder(self) -> None:
        """A frame just went through: reorder-held frames slot in behind
        it (the adjacent swap), in the order they were held."""
        if self._reorder:
            held, self._reorder = self._reorder, []
            for _t, pkt in held:
                self._deliver(pkt)

    def _passthrough(self) -> bool:
        """True when no fault machinery can possibly engage: delegate raw."""
        return (not self._partitions and not self._held and not self._reorder
                and (self.schedule is None
                     or not self.schedule.armed()
                     or not self.schedule.active(self.clock.now)))

    # -- push side ------------------------------------------------------------------
    def push(self, pkt: Packet) -> None:
        if self._passthrough():
            self.inner.push(pkt)
            return
        self._release_due()
        self._inject(pkt)

    def push_many(self, *args) -> None:
        if self._demux:
            flow, pkts = args
            if self._passthrough():
                self.inner.push_many(flow, pkts)
                return
            self._release_due()
            for pkt in pkts:
                self._inject(pkt)
        else:
            (pkts,) = args
            if self._passthrough():
                self.inner.push_many(pkts)
                return
            self._release_due()
            for pkt in pkts:
                self._inject(pkt)

    # -- pop side (held frames release on every consumer touch) ----------------------
    def pop(self):
        if not self._passthrough():
            self._release_due()
        return self.inner.pop()

    def pop_many(self, n: int):
        if not self._passthrough():
            self._release_due()
        return self.inner.pop_many(n)

    def pop_flow(self, flow):
        if not self._passthrough():
            self._release_due()
        return self.inner.pop_flow(flow)

    def drain_flow(self, flow):
        if not self._passthrough():
            self._release_due()
        return self.inner.drain_flow(flow)

    def flows(self):
        return self.inner.flows()

    # -- scheduler-facing surface ----------------------------------------------------
    @property
    def name(self) -> str:
        return self.inner.name

    @property
    def weight_of(self):
        return getattr(self.inner, "weight_of", None)

    @weight_of.setter
    def weight_of(self, fn):
        self.inner.weight_of = fn

    def __len__(self) -> int:
        return len(self.inner) + len(self._held) + len(self._reorder)

    def __bool__(self) -> bool:
        # Held frames keep the wire truthy: the busy-predicates must keep
        # the owning server runnable until every delayed frame lands.
        return bool(self.inner) or bool(self._held) or bool(self._reorder)


def wrap_director(director, clock,
                  ingress: FaultSchedule | None = None,
                  responses: FaultSchedule | None = None,
                  flow_filter=None) -> tuple[FaultWire, FaultWire]:
    """Install fault wrappers on a director's client-facing wires.

    ``ingress`` perturbs client->server frames (requests), ``responses``
    server->client frames (acks / read data).  ``flow_filter`` (optional
    predicate on the FiveTuple) restricts injection to the flows it
    accepts — e.g. exempt inter-shard replication flows, whose reliable
    fabric has no retransmit layer.  Returns the two wrappers (armed or
    not) so callers can add partitions and read injection counters.
    Wrap BEFORE creating clients only by convention — both sides resolve
    the wires through the director attribute on every access, so
    wrapping is transparent either way.
    """
    fin = FaultWire(director.ingress, clock, ingress, flow_filter)
    fout = FaultWire(director.to_client, clock, responses, flow_filter)
    director.ingress = fin
    director.to_client = fout
    return fin, fout


__all__ = ["FaultSchedule", "FaultWire", "wrap_director"]
