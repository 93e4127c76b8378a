"""Sharded multi-server DDS cluster: scale-out behind consistent hashing.

The paper's deployable unit is ONE storage server host + DPU (Fig 6);
production disaggregated stores run MANY of them behind a thin routing
layer (cf. BPF-oF and disaggregated-DBMS designs in PAPERS.md).  This
module provides that layer:

``HashRing``
    Consistent hashing with virtual nodes.  Placement is stable across
    processes (blake2b, not the salted builtin ``hash``) and adding a shard
    only remaps ~1/N of the key space — the property that makes scale-out
    cheap.

``DDSCluster``
    N independent :class:`DDSStorageServer` instances ("shards"), each with
    its own DPU, traffic director, offload engine and RAM-backed device.
    Files are placed by consistent-hashing their *cluster-global* file id;
    the cluster keeps the global->(shard, local-id) mapping, playing the
    (rarely-consulted, control-plane) metadata service of disaggregated
    designs.

``ReadySet``
    The cluster's work-signaled scheduler state: a doorbell-armed set of
    runnable shard indices.  Every work producer — a client pushing into a
    director's ingress, a ring insert, a block-device submission — marks its
    server runnable via the server's ``signal()`` doorbell; ``pump()``
    drains ONLY runnable servers, so the cost of a scheduling round tracks
    *active* work instead of cluster size (the pre-overhaul loop stepped
    every shard on every iteration — wall-clock per op grew with shard
    count even when most shards were idle).

    The no-lost-wakeup discipline: a shard is taken OUT of the set before
    it is stepped, so a doorbell raised concurrently with the step re-arms
    it; after the step it is re-armed while ``server.busy()`` holds
    (pending device completions, undrained rings/wires, in-flight host
    requests).  Stepping order is shard-index order, a subsequence of the
    old poll-everything order, so existing deterministic interleavings are
    preserved.

Client-side batching/pipelining lives in :mod:`repro_torch.core.client`; the
§9.2 KV application on top of the cluster lives in
:mod:`repro_torch.apps.kv_store`.
"""

from __future__ import annotations

import bisect
import hashlib
import threading
from dataclasses import dataclass, field, replace
from typing import Callable, Iterable

from repro_torch.core import wire
from repro_torch.core.client import ShardConnection
from repro_torch.core.dds_server import (DDSStorageServer, ServerConfig,
                                   encode_app_write)
from repro_torch.core.lifecycle import TickClock, TickHistogram
from repro_torch.core.offload import OffloadAPI
from repro_torch.distributed.fault_tolerance import ClusterSupervisor


def stable_hash(key: object, salt: bytes = b"") -> int:
    """64-bit process-stable hash of ints/bytes/strs (builtin hash is salted)."""
    if isinstance(key, int):
        raw = key.to_bytes(16, "little", signed=True)
    elif isinstance(key, bytes):
        raw = key
    else:
        raw = str(key).encode()
    return int.from_bytes(hashlib.blake2b(salt + raw, digest_size=8).digest(),
                          "little")


class HashRing:
    """Consistent-hash ring over integer shard ids with virtual nodes."""

    def __init__(self, num_shards: int, vnodes: int = 64):
        if num_shards <= 0:
            raise ValueError("num_shards must be positive")
        self.num_shards = num_shards
        self.vnodes = vnodes
        self._nodes: set[int] = set(range(num_shards))
        # Build every (point, owner) pair flat and sort ONCE: the old
        # per-vnode ``list.insert`` into the sorted lists was O(n^2) in
        # total vnode count, which bites exactly when scale-out grows the
        # ring (16 shards x 64 vnodes = 1024 quadratic inserts).
        pairs = sorted(
            (stable_hash(f"shard-{shard}-vnode-{v}"), shard)
            for shard in range(num_shards) for v in range(vnodes))
        self._points = [p for p, _ in pairs]   # bisect-ready for shard_for
        self._owners = [s for _, s in pairs]

    def _owner_at(self, h: int) -> int:
        i = bisect.bisect_right(self._points, h)
        if i == len(self._points):
            i = 0  # wrap around the ring
        return self._owners[i]

    def shard_for(self, key: object) -> int:
        return self._owner_at(stable_hash(key, salt=b"key:"))

    def nodes(self) -> list[int]:
        """Current member shard ids, sorted."""
        return sorted(self._nodes)

    def copy(self) -> "HashRing":
        """Cheap structural copy — membership edits on the copy leave the
        original untouched (the pending-ring idiom live resharding uses)."""
        ring = HashRing.__new__(HashRing)
        ring.num_shards = self.num_shards
        ring.vnodes = self.vnodes
        ring._nodes = set(self._nodes)
        ring._points = list(self._points)
        ring._owners = list(self._owners)
        return ring

    def add_node(self, shard: int) -> None:
        """Online membership: splice ``shard``'s vnodes into the ring.

        The merged arrays are identical to a fresh sort-once build over the
        union membership, so incremental growth and from-scratch
        construction agree point-for-point (pinned by test)."""
        if shard in self._nodes:
            return
        self._nodes.add(shard)
        pts = [(stable_hash(f"shard-{shard}-vnode-{v}"), shard)
               for v in range(self.vnodes)]
        pairs = sorted([*zip(self._points, self._owners), *pts])
        self._points = [p for p, _ in pairs]
        self._owners = [s for _, s in pairs]
        self.num_shards = len(self._nodes)

    def remove_node(self, shard: int) -> None:
        """Online membership: drop every vnode owned by ``shard``.  Its
        ranges fall to each vnode's clockwise successor; no other owner's
        ranges move."""
        if shard not in self._nodes or len(self._nodes) <= 1:
            return
        self._nodes.discard(shard)
        pairs = [(p, s) for p, s in zip(self._points, self._owners)
                 if s != shard]
        self._points = [p for p, _ in pairs]
        self._owners = [s for _, s in pairs]
        self.num_shards = len(self._nodes)

    def claimed_ranges(self, shard: int) -> list[tuple[int, int]]:
        """Half-open hash ranges ``[lo, hi)`` owned by ``shard``.  The wrap
        interval is reported as two pieces ``[last_point, 2^64)`` and
        ``[0, first_point)``."""
        out: list[tuple[int, int]] = []
        pts, owners = self._points, self._owners
        for i, owner in enumerate(owners):
            if owner != shard:
                continue
            if i == 0:
                out.append((pts[-1], 1 << 64))
                out.append((0, pts[0]))
            else:
                out.append((pts[i - 1], pts[i]))
        return [(lo, hi) for lo, hi in out if lo < hi]

    @staticmethod
    def remap_fraction(old: "HashRing", new: "HashRing") -> float:
        """Fraction of the 64-bit hash space whose owner differs between
        two rings — the invariant live-migration volume depends on (adding
        one node to n remaps ~1/(n+1); removing one remaps only its own
        share).  Exact interval arithmetic, not sampling: walk the merged
        point set; ownership is constant on each piece."""
        bounds = sorted(set(old._points) | set(new._points))
        if not bounds:
            return 0.0
        moved = 0
        span = 1 << 64
        for j, b in enumerate(bounds):
            hi = bounds[j + 1] if j + 1 < len(bounds) else bounds[0] + span
            if old._owner_at(b) != new._owner_at(b):
                moved += hi - b
        return moved / span

    def successors(self, shard: int, k: int) -> list[int]:
        """The first ``k`` DISTINCT other shards clockwise from ``shard``'s
        first vnode — its replica group.  Deterministic (the ring is), and
        stable under failover because failover repairs a ROUTE table on top
        of the ring instead of removing vnodes (removal would re-home the
        dead shard's keys onto arbitrary ring successors, not onto the
        replicas actually holding the data)."""
        if k <= 0 or self.num_shards <= 1:
            return []
        owners = self._owners
        n = len(owners)
        try:
            i = owners.index(shard)
        except ValueError:
            return []
        out: list[int] = []
        seen = {shard}
        for j in range(1, n):
            o = owners[(i + j) % n]
            if o not in seen:
                seen.add(o)
                out.append(o)
                if len(out) >= k:
                    break
        return out

    def distribution(self, keys: Iterable[object]) -> dict[int, int]:
        out: dict[int, int] = {s: 0 for s in sorted(self._nodes)}
        for k in keys:
            out[self.shard_for(k)] += 1
        return out


@dataclass
class ClusterStats:
    """Aggregated across shards (per-shard stats stay on each server)."""
    offloaded_completed: int = 0
    bounced_to_host: int = 0
    host_responses: int = 0
    dpu_time_s: float = 0.0
    host_cpu_busy_s: float = 0.0
    per_shard_busy_s: list[float] = field(default_factory=list)


@dataclass
class FileLocation:
    """Where a cluster-global file id actually lives.

    ``replicas`` maps replica shard -> that shard's LOCAL fid of the copy
    (replica files are ordinary files on the replica's own SegmentFS).  On
    failover the promoted copy becomes ``(shard, local_fid)`` and leaves
    ``replicas``; the surviving copies stay listed."""
    shard: int
    local_fid: int
    replicas: dict[int, int] = field(default_factory=dict)


class ReadySet:
    """Doorbell-armed set of runnable shard indices (no lost wakeups).

    ``mark`` is the doorbell: idempotent (an armed shard is not re-queued)
    and safe from any thread.  ``take`` atomically snapshots-and-clears the
    set; a mark that races with a take lands in the NEXT snapshot, which is
    exactly the semantics the scheduler's take/step/re-arm cycle needs.
    Snapshots come back in shard-index order so cooperative stepping stays
    deterministic (a subsequence of the old step-everyone order).
    """

    def __init__(self, n: int):
        self._armed = [False] * n
        self._queue: list[int] = []
        self._lock = threading.Lock()
        # ``quiet`` caches "every shard was VERIFIED non-busy and no
        # doorbell has rung since": the scheduler's empty-set fallback scan
        # (a busy() probe per shard) runs at most once per quiet period
        # instead of once per idle pump.  Any mark clears it.
        self.quiet = False

    def mark(self, i: int) -> None:
        if self._armed[i]:   # racy fast path: double-mark is idempotent
            return
        with self._lock:
            self.quiet = False
            if not self._armed[i]:
                self._armed[i] = True
                self._queue.append(i)

    def take(self) -> list[int]:
        if not self._queue:   # racy-but-safe emptiness peek
            return []
        with self._lock:
            out = self._queue
            if not out:
                return []
            self._queue = []
            armed = self._armed
            for i in out:
                armed[i] = False
        out.sort()
        return out

    def grow(self, n: int = 1) -> None:
        """Widen the armed bitmap for newly provisioned shards."""
        with self._lock:
            self._armed.extend([False] * n)

    def __len__(self) -> int:
        return len(self._queue)

    def __bool__(self) -> bool:
        return bool(self._queue)


class _Replicator:
    """Primary-backup write forwarding for ONE primary shard.

    Owns a :class:`~repro_torch.core.client.ShardConnection` to each replica
    target, so forwarded writes ride the SAME host wire, batching and
    ordering guarantees as client traffic (the paper's wire is the only
    transport).  ``forward`` encodes the final on-disk bytes — called at
    the one point where they are known, after the primary's host handler
    rewrote the payload (e.g. a KV PUT into a log record) — as a raw
    ``APP_WRITE`` against the target's replica file, and HOLDS the
    primary's client ack (the ``token`` request id) until every live
    target acked, or the supervisor dropped a dead target.  The client
    therefore never sees an ack for bytes a single crash could lose.

    Replicator flows are epoch-UNTAGGED: replication must keep working
    across the epoch bump its own failover causes.  Replica-side fan-out
    does not chain — a replica never maps its replica files into its own
    replicator, so depth is exactly one (primary-backup, not chain
    replication).
    """

    def __init__(self, primary: int,
                 targets: list[tuple[int, DDSStorageServer]],
                 clock: TickClock):
        self.primary = primary
        self.clock = clock
        # Distinct source ip per primary keeps replicator flows disjoint
        # from every client's (client ports allocate from 10.0.*).
        self.conns = {t: ShardConnection(srv, f"10.1.{primary}.1", 45000 + t)
                      for t, srv in targets}
        self._fid_map: dict[int, dict[int, int]] = {t: {} for t, _ in targets}
        self._next_rrid = 1
        self._hold: dict[int, int] = {}      # token -> outstanding replica acks
        self._rrid_meta: dict[int, tuple[int, int, int]] = {}  # rrid -> (token, target, t0)
        self._pending: dict[int, set[int]] = {t: set() for t, _ in targets}
        self._responses: dict[int, tuple[int, bytes]] = {}
        self._dirty = False
        self.lag = TickHistogram()           # forward tick -> replica-ack tick
        self.forwarded = 0
        self.forwarded_bytes = 0
        self.failures = 0                    # replica error/terminal statuses
        self.dropped = 0                     # acks released by drop_target

    def map_file(self, target: int, primary_fid: int, replica_fid: int) -> None:
        m = self._fid_map.get(target)
        if m is not None:
            m[primary_fid] = replica_fid

    def forward(self, token: int, file_id: int, offset: int, data) -> bool:
        """Forward one acked write; True if the client ack is now held."""
        held = 0
        t0 = self.clock.now
        for t, conn in self.conns.items():
            rfid = self._fid_map[t].get(file_id)
            if rfid is None:
                continue   # unreplicated file (e.g. checkpoints): no hold
            rrid = self._next_rrid
            self._next_rrid += 1
            conn.enqueue(encode_app_write(rrid, rfid, offset, data))
            self._rrid_meta[rrid] = (token, t, t0)
            self._pending[t].add(rrid)
            held += 1
        if not held:
            return False
        self._hold[token] = held
        self._dirty = True
        self.forwarded += held
        self.forwarded_bytes += held * len(data)
        return True

    def holds(self, token: int) -> bool:
        return token in self._hold

    def busy(self) -> bool:
        return self._dirty or bool(self._hold)

    def step(self) -> int:
        """Flush queued forwards, harvest replica acks, release holds."""
        work = 0
        if self._dirty:
            self._dirty = False
            for conn in self.conns.values():
                work += conn.flush()
        resp = self._responses
        for t, conn in self.conns.items():
            conn.collect(resp)
            conn.arrival_order.clear()   # unused here; don't grow unbounded
            pend = self._pending[t]
            if pend and not resp:
                # A replica overload-shed never produces a wire response:
                # reconcile terminal marks so holds cannot wedge forever.
                lt = conn.server.lifecycle
                for rrid in [r for r in pend
                             if lt.take_terminal(conn.flow, r) is not None]:
                    self.failures += 1
                    work += self._resolve(rrid)
        if resp:
            now = self.clock.now
            for rrid in list(resp):
                status, _body = resp.pop(rrid)
                meta = self._rrid_meta.get(rrid)
                if meta is not None:
                    self.lag.add(now - meta[2])
                    if status != wire.E_OK:
                        self.failures += 1
                work += self._resolve(rrid)
        return work

    def _resolve(self, rrid: int) -> int:
        meta = self._rrid_meta.pop(rrid, None)
        if meta is None:
            return 0
        token, target, _t0 = meta
        pend = self._pending.get(target)
        if pend is not None:
            pend.discard(rrid)
        left = self._hold.get(token, 0) - 1
        if left <= 0:
            self._hold.pop(token, None)
        else:
            self._hold[token] = left
        return 1

    def drop_target(self, target: int) -> None:
        """A replica died: stop forwarding to it and release every client
        ack held on replica acks it will never send."""
        if self.conns.pop(target, None) is None:
            return
        self._fid_map.pop(target, None)
        for rrid in list(self._pending.pop(target, ())):
            self.dropped += 1
            self._resolve(rrid)

    def add_target(self, target: int, srv: DDSStorageServer,
                   port: int) -> None:
        """(Re-)arm forwarding to ``target`` — a healed shard rejoining as
        a replica.  ``port`` must be fresh per rejoin generation (the
        target's PEP still holds the dropped connection's sequence state,
        so reusing the old five-tuple would have every forward discarded
        as a stale retransmit)."""
        if target in self.conns:
            return
        self.conns[target] = ShardConnection(
            srv, f"10.1.{self.primary}.1", port)
        self._fid_map.setdefault(target, {})
        self._pending.setdefault(target, set())

    def reset(self) -> None:
        """Demotion: abandon ALL in-flight forwarding state.

        Called when a partitioned ex-primary heals after a replica was
        promoted in its place.  Its held acks answer requests the clients
        already replayed against the repaired ring, and flushing writes
        frozen since before the partition could clobber newer bytes on
        the new primary's replicas — both are dropped on the floor; the
        epoch fence has already made every one of them unservable."""
        for conn in self.conns.values():
            conn._pending.clear()
        self._hold.clear()
        self._rrid_meta.clear()
        for pend in self._pending.values():
            pend.clear()
        self._dirty = False

    def summary(self) -> dict:
        out = {"targets": sorted(self.conns), "forwarded": self.forwarded,
               "bytes": self.forwarded_bytes}
        if self.lag.n:
            out["lag"] = self.lag.summary()
        if self.failures:
            out["failures"] = self.failures
        if self.dropped:
            out["dropped_acks"] = self.dropped
        return out


class DDSCluster:
    """N DDS storage servers behind consistent-hash file-id sharding."""

    def __init__(self, num_shards: int = 2,
                 config: ServerConfig | None = None,
                 api_factory: Callable[[int], OffloadAPI | None] | None = None,
                 vnodes: int = 64, elastic: bool = False):
        self.num_shards = num_shards
        base = config or ServerConfig()
        # Kept for elastic growth: add_shard() provisions new servers from
        # the same template the initial members used.
        self._base_config = base
        self._api_factory = api_factory
        self.elastic = elastic
        self.ring = HashRing(num_shards, vnodes)
        self.servers: list[DDSStorageServer] = []
        self._ready = ReadySet(num_shards)
        self.pump_steps = [0] * num_shards   # per-shard srv.pump() count
        # The cluster's deterministic lifecycle clock: ONE tick per cluster
        # pump step, shared by every shard (devices, file services, rings,
        # lifecycle trackers), so tick latencies are comparable across
        # shards and two identical runs produce identical histograms.
        self.clock = TickClock()
        for i in range(num_shards):
            # Each shard listens on its own port so application signatures
            # stay per-server, exactly as N separate Fig-6 boxes would.
            cfg = replace(base, server_port=base.server_port + i)
            api = api_factory(i) if api_factory is not None else None
            srv = DDSStorageServer(cfg, api)
            srv.adopt_clock(self.clock)
            # Every producer doorbell (client send, ring insert, device
            # submission) for this shard now arms it in the ready set.
            srv.set_doorbell(lambda i=i: self._ready.mark(i))
            self.servers.append(srv)
        self._files: dict[int, FileLocation] = {}
        self._next_fid = 1
        # -- replication / failover state ----------------------------------
        # ``epoch`` is the ring generation, bumped on every failover and
        # stamped onto epoch-aware clients' packets; ``_route`` repairs
        # routing ON TOP of the ring (dead shard -> promoted replica) so
        # vnode placement — and therefore which replica holds which keys —
        # never shifts.  ``replication`` is the effective factor K.
        self.epoch = 0
        self._route: dict[int, int] = {}
        self._dead: set[int] = set()
        self._crash_at: dict[int, int] = {}
        # Timed network partitions: shard -> heal tick.  A partitioned
        # shard looks exactly like a crashed one from the outside (no
        # pumping, no heartbeats, no routing) but its device and files
        # survive — on heal it rejoins as a REPLICA of whoever was
        # promoted in its place (the epoch fence already invalidated
        # every packet it could try to serve, so no split brain).
        self._partitioned: dict[int, int] = {}
        self.replication = (min(base.replication, num_shards - 1)
                            if num_shards > 1 else 0)
        self.failover_events: list[dict] = []
        self.rejoin_events: list[dict] = []
        # Application hook (e.g. the KV store): called as
        # ``on_promote(dead_shard, promoted_shard)`` after ring repair.
        self.on_promote = None
        # ``on_rejoin(healed_shard, primary_shard)``: application-level
        # re-silver after a healed partition rejoins as a replica.
        self.on_rejoin = None
        self.supervisor: ClusterSupervisor | None = None
        # -- elastic resharding state --------------------------------------
        # ``resharder`` is the one active migration driver (None when the
        # membership is stable); committed ring changes append to
        # ``reshard_events`` and finished/aborted migrations summarize into
        # ``reshard_history``.  ``retired`` shards stay allocated (their
        # index is load-bearing) but own no keys and take no traffic.
        self.resharder = None
        self.reshard_events: list[dict] = []
        self.reshard_history: list[dict] = []
        self.reshard_totals = {"keys_migrated": 0, "bytes_streamed": 0,
                               "dual_routed": 0}
        self.retired: set[int] = set()
        if self.replication > 0:
            for i, srv in enumerate(self.servers):
                targets = [(t, self.servers[t])
                           for t in self.ring.successors(i, self.replication)]
                srv.replicator = _Replicator(i, targets, self.clock)
            self.supervisor = ClusterSupervisor(
                self, base.heartbeat_timeout_ticks,
                base.heartbeat_miss_windows)
            for srv in self.servers:
                # Epoch fence: a packet tagged with a pre-failover epoch is
                # refused with a retryable terminal redirect.
                srv.director.epoch_of = lambda: self.epoch
                srv.director.on_stale_epoch = srv._on_stale_epoch
        elif elastic:
            # Unreplicated but elastic: the ownership flip still needs the
            # epoch fence so in-flight pre-flip packets bounce with a
            # retryable redirect instead of landing on the old owner.
            for srv in self.servers:
                srv.director.epoch_of = lambda: self.epoch
                srv.director.on_stale_epoch = srv._on_stale_epoch

    @property
    def failover_armed(self) -> bool:
        return self.supervisor is not None

    def runnable(self) -> list[int]:
        """Currently armed shard indices (introspection/tests only)."""
        return sorted(i for i, a in enumerate(self._ready._armed) if a)

    # -- elastic membership ---------------------------------------------------------
    @property
    def reshard_active(self) -> bool:
        return self.resharder is not None

    def add_shard(self) -> int:
        """Provision one NEW storage server (infra only — the ring is
        untouched until a migration flips ownership to it).

        The new shard gets the same config template as the initial
        members, joins the shared tick clock, ready set and supervisor,
        and — on replicated clusters — gets its own replicator wired by
        the PENDING ring (membership including itself), so its log is
        redundant before it owns a single key."""
        if not (self.failover_armed or self.elastic):
            raise RuntimeError(
                "add_shard requires an elastic or replicated cluster "
                "(the ownership flip needs the epoch fence)")
        i = len(self.servers)
        base = self._base_config
        cfg = replace(base, server_port=base.server_port + i)
        api = self._api_factory(i) if self._api_factory is not None else None
        srv = DDSStorageServer(cfg, api)
        srv.adopt_clock(self.clock)
        srv.set_doorbell(lambda i=i: self._ready.mark(i))
        srv.director.epoch_of = lambda: self.epoch
        srv.director.on_stale_epoch = srv._on_stale_epoch
        self.servers.append(srv)
        self.num_shards = len(self.servers)
        self._ready.grow()
        self.pump_steps.append(0)
        if self.replication > 0:
            pending = self.ring.copy()
            pending.add_node(i)
            targets = [(t, self.servers[t])
                       for t in pending.successors(i, self.replication)
                       if t not in self._dead]
            srv.replicator = _Replicator(i, targets, self.clock)
        if self.supervisor is not None:
            self.supervisor.add_shard(i)
        return i

    def start_reshard(self, resharder) -> None:
        """Install the one active migration driver; it is stepped from
        ``pump()`` and retires itself on completion/abort."""
        if self.resharder is not None:
            raise RuntimeError("a resharding migration is already active")
        if not (self.failover_armed or self.elastic):
            raise RuntimeError("resharding requires elastic=True or replication")
        self.resharder = resharder

    def commit_ring(self, ring: HashRing, event: dict) -> None:
        """The atomic ownership flip: swap the ring and bump the epoch in
        one step.  Every in-flight packet stamped with the old epoch is
        refused by the fence with a retryable redirect; epoch-aware clients
        re-resolve against the new ring and replay."""
        self.ring = ring
        self.epoch += 1
        event = dict(event, epoch=self.epoch, tick=self.clock.now)
        self.reshard_events.append(event)

    def _retire_resharder(self) -> None:
        rs = self.resharder
        if rs is None:
            return
        summary = rs.summary()
        self.reshard_history.append(summary)
        tot = self.reshard_totals
        tot["keys_migrated"] += summary.get("keys_migrated", 0)
        tot["bytes_streamed"] += summary.get("bytes_streamed", 0)
        tot["dual_routed"] += summary.get("dual_routed", 0)
        self.resharder = None

    # -- control plane: cluster-global files ---------------------------------------
    def create_file(self, name: str) -> int:
        """Create a file on the shard the ring assigns; return a GLOBAL id."""
        gfid = self._next_fid
        self._next_fid += 1
        shard = self.route_of(self.ring.shard_for(gfid))
        lfid = self.servers[shard].frontend.create_file(f"{name}@{gfid}")
        loc = FileLocation(shard, lfid)
        if self.replication:
            loc.replicas = self.replicate_file(shard, lfid, f"{name}@{gfid}")
        self._files[gfid] = loc
        return gfid

    def replicate_file(self, primary: int, lfid: int,
                       name: str, ring: HashRing | None = None) -> dict[int, int]:
        """Create replica copies of a shard-LOCAL file on the primary's ring
        successors and register them with its replicator.

        The public API for applications that create files directly on shard
        frontends (the KV store's record logs): every write the primary acks
        against ``lfid`` is thereafter forwarded before the ack releases.
        ``ring`` lets elastic growth place a NEW shard's replicas by the
        pending ring (the new shard is not in ``self.ring`` until the
        ownership flip).  Returns ``{replica shard: replica-local fid}``."""
        out: dict[int, int] = {}
        repl = self.servers[primary].replicator
        if not self.replication or repl is None:
            return out
        for t in (ring or self.ring).successors(primary, self.replication):
            if t in self._dead:
                continue
            rlfid = self.servers[t].frontend.create_file(f"{name}:r{primary}")
            repl.map_file(t, lfid, rlfid)
            out[t] = rlfid
        return out

    def locate(self, gfid: int) -> FileLocation:
        loc = self._files.get(gfid)
        if loc is None:
            raise KeyError(f"unknown cluster file id {gfid}")
        return loc

    def shard_for_file(self, gfid: int) -> int:
        return self.locate(gfid).shard

    def route_of(self, shard: int) -> int:
        """Post-failover routing: follow the repair chain to a live shard.
        Chains are compressed at failover time, so this is usually one
        dict miss; a key's route never lands on a dead shard."""
        r = self._route
        while shard in r:
            shard = r[shard]
        return shard

    def shard_for_key(self, key: object) -> int:
        """Key routing clients should use: ring placement + route repair."""
        return self.route_of(self.ring.shard_for(key))

    def write_sync(self, gfid: int, offset: int, data: bytes) -> None:
        """Host-side bulk load (e.g. benchmark setup), bypassing the network."""
        loc = self.locate(gfid)
        self.servers[loc.shard].frontend.write_sync(loc.local_fid, offset, data)
        self.servers[loc.shard].run_until_idle()
        # The bulk load bypassed the wire (and so the replicator): mirror it
        # onto the replica copies directly, preserving the invariant that
        # replicas hold every byte the primary considers durable.
        for t, rlfid in loc.replicas.items():
            if t in self._dead:
                continue
            self.servers[t].frontend.write_sync(rlfid, offset, data)
            self.servers[t].run_until_idle()

    # -- fault injection + failover -------------------------------------------------
    def crash(self, shard: int) -> None:
        """Deterministic fault injection: power-fail ``shard`` NOW.

        Its device loses every queued-but-unexecuted op (bytes already
        executed stay durable for a recovery mount), it stops being
        scheduled, and its heartbeat goes silent — the supervisor detects
        the death and promotes a replica ``heartbeat_timeout_ticks`` later.
        """
        if shard in self._dead:
            return
        self._dead.add(shard)
        self.servers[shard].device.crash()

    def crash_at(self, shard: int, tick: int) -> None:
        """Schedule ``crash(shard)`` for the first pump at/after ``tick``."""
        self._crash_at[shard] = tick

    def partition(self, shard: int, until_tick: int) -> None:
        """Deterministic fault injection: cut ``shard`` off the network NOW.

        Unlike :meth:`crash`, the device keeps its state.  While
        partitioned the shard is unreachable (not pumped, heartbeats
        silent, routing skips it) — if the partition outlasts the
        supervisor's grace windows a replica is promoted exactly as for a
        crash.  At ``until_tick`` the shard heals and, if it was failed
        over, rejoins the repaired ring AS A REPLICA of its promoted
        successor (see :meth:`_heal`)."""
        if shard in self._dead:
            return
        self._partitioned[shard] = until_tick
        self._dead.add(shard)

    def _heal(self, shard: int) -> None:
        """A partitioned shard's network came back.

        If nothing was promoted (the blip fit inside the supervisor's
        grace windows) the shard simply resumes as primary.  Otherwise
        the split-brain hazard is closed in three moves: (1) its
        replicator abandons every in-flight forward it froze
        pre-partition (``reset`` — the epoch fence already made the
        underlying requests unservable, clients replayed them against
        the new primary); (2) the new primary re-silvers the healed
        shard: every file it now owns is copied over and registered as a
        replica, restoring the redundancy the failover spent; (3) the
        supervisor starts monitoring it again.  The healed shard serves
        no client traffic — routes moved at promotion and stay moved."""
        self._partitioned.pop(shard, None)
        self._dead.discard(shard)
        sup = self.supervisor
        if sup is not None:
            sup.monitor.watch(f"shard{shard}")
            sup._misses.pop(f"shard{shard}", None)
        if shard not in self._route:
            return   # blip shorter than detection: clean resume as primary
        srv = self.servers[shard]
        if srv.replicator is not None:
            srv.replicator.reset()
        primary = self.route_of(shard)
        prepl = self.servers[primary].replicator
        resilvered = 0
        if prepl is not None:
            # Fresh port per rejoin generation: the healed shard's PEP
            # still remembers the old forwarding connection's sequence
            # state, so the epoch salt keeps the five-tuple unique.
            prepl.add_target(shard, srv,
                             port=45000 + shard + 1000 * (self.epoch + 1))
            psrv = self.servers[primary]
            for gfid, loc in self._files.items():
                if loc.shard != primary:
                    continue
                # A pre-partition replica copy may already exist on the
                # healed shard, but its forwarding was dropped at the
                # promotion — recopy the whole file (it missed every
                # partition-era write) and re-register the mapping.
                rlfid = loc.replicas.get(shard)
                if rlfid is None:
                    rlfid = srv.frontend.create_file(f"rejoin@{gfid}")
                size = psrv.fs.file_size(loc.local_fid)
                if size:
                    data = psrv.frontend.read_sync(loc.local_fid, 0, size)
                    srv.frontend.write_sync(rlfid, 0, data)
                    srv.run_until_idle()
                prepl.map_file(shard, loc.local_fid, rlfid)
                loc.replicas[shard] = rlfid
                resilvered += 1
        self.rejoin_events.append(
            {"tick": self.clock.now, "healed": shard, "primary": primary,
             "resilvered": resilvered})
        if self.on_rejoin is not None:
            self.on_rejoin(shard, primary)
        self._ready.mark(shard)

    def _failover(self, dead: int) -> int | None:
        """Promote a replica of ``dead``: drain the promoted shard, adopt
        its replica copies as primaries, repair key routing, release client
        acks held on the dead shard's replica acks, and bump the ring epoch
        (in-flight stale-epoch requests are refused with retryable
        redirects; clients replay against the repaired ring)."""
        # Candidates come from where the replicas actually LIVE (the dead
        # primary's replicator targets), not from recomputing the ring's
        # successors: an elastic flip reshapes the ring without moving
        # replica placement, so post-reshard the two can disagree — and a
        # successor holding no copy would be promoted into data loss.
        repl = self.servers[dead].replicator
        holders = set(repl.conns) if repl is not None else set()
        promoted = None
        for cand in self.ring.successors(dead, self.replication):
            if cand not in self._dead and (not holders or cand in holders):
                promoted = cand
                break
        if promoted is None:
            for cand in sorted(holders):
                if cand not in self._dead:
                    promoted = cand
                    break
        if promoted is not None:
            # Drain FIRST: every forwarded write the dead primary acked is
            # applied on the replica before any adopted file is served.
            self.servers[promoted].run_until_idle()
            prepl = self.servers[promoted].replicator
            for loc in self._files.values():
                if loc.shard != dead:
                    continue
                rlfid = loc.replicas.pop(promoted, None)
                if rlfid is None:
                    continue   # not replicated onto the promoted shard
                loc.shard = promoted
                loc.local_fid = rlfid
                # K >= 2: keep the surviving copies replicated from the
                # new primary (no re-replication of lost copies — the
                # repaired group is one smaller; documented limitation).
                if prepl is not None:
                    for t, rfid in loc.replicas.items():
                        if t not in self._dead:
                            prepl.map_file(t, rlfid, rfid)
            self._route[dead] = promoted
            for k, v in list(self._route.items()):
                if v != dead:
                    continue
                if k == promoted:
                    # Ping-pong promotion (A died onto B, B now dies back
                    # onto a healed A): a self-entry would make route_of
                    # spin forever — the promoted shard routes to itself.
                    del self._route[k]
                else:   # path compression: old chains point at the
                    self._route[k] = promoted   # live end directly
        for i, srv in enumerate(self.servers):
            if i not in self._dead and srv.replicator is not None:
                srv.replicator.drop_target(dead)
        self.epoch += 1
        self.failover_events.append(
            {"tick": self.clock.now, "dead": dead, "promoted": promoted,
             "epoch": self.epoch})
        if promoted is not None and self.on_promote is not None:
            self.on_promote(dead, promoted)
        return promoted

    # -- work-signaled cooperative event loop -----------------------------------------
    def pump(self) -> int:
        """Drain RUNNABLE servers only (doorbell semantics).

        Each runnable shard is taken out of the ready set BEFORE it is
        stepped (a doorbell racing the step re-arms it) and re-armed after
        the step while it produced work or ``busy()`` holds — pending
        device completions, undrained rings, in-flight host requests all
        keep a shard runnable, so wakeups are never lost.

        When the ready set is empty, a verification sweep re-arms any shard
        whose ``busy()`` holds, then latches the ready set's ``quiet`` flag;
        every doorbell (``ReadySet.mark``) clears it, so repeated idle
        pumps cost O(1) regardless of cluster size.  The contract this
        buys: ``pump() == 0`` means every shard was verified non-busy at
        some point since the last doorbell.  Work enqueued WITHOUT ringing
        a doorbell (poking a director wire directly) is caught by the
        sweep only until the first clean sweep latches quiet — after that
        it stays unscheduled until the next doorbell.  Every in-tree
        producer signals (client sends, ring publishes, device
        submissions); a new producer must too.
        """
        self.clock.tick()   # one tick per scheduling step (lifecycle clock)
        if self._crash_at:
            now = self.clock.now
            for shard, at in list(self._crash_at.items()):
                if now >= at:
                    del self._crash_at[shard]
                    self.crash(shard)
        if self._partitioned:
            now = self.clock.now
            for shard, until in list(self._partitioned.items()):
                if now >= until:
                    self._heal(shard)
        sup = self.supervisor
        if sup is not None:
            # Failure detection runs BEFORE the quiet-latch early returns:
            # a dead shard produces no doorbells, so its detection must not
            # depend on other work existing.  Unreplicated clusters skip
            # both calls (sup is None) — zero cost on that path.
            sup.beat_live()
            sup.poll()
        rs_work = 0
        rs = self.resharder
        if rs is not None:
            # The migration driver is pumped like a shard: it reports >=1
            # while a migration is in any live phase, keeping
            # ``run_until_idle`` driving the cluster until the flip (or
            # abort) lands even when no client traffic rings doorbells.
            rs_work = rs.step()
            if rs.phase in ("done", "aborted"):
                self._retire_resharder()
        runnable = self._ready.take()
        servers = self.servers
        dead = self._dead
        if not runnable:
            if self._ready.quiet:
                return rs_work   # verified idle, no doorbell since
            runnable = [i for i, srv in enumerate(servers)
                        if i not in dead and srv.busy()]
            if not runnable:
                self._ready.quiet = True
                return rs_work
        work = 0
        steps = self.pump_steps
        mark = self._ready.mark
        for i in runnable:
            if i in dead:
                continue   # crashed shards never step again
            srv = servers[i]
            steps[i] += 1
            w = srv.pump()
            if w or srv.busy():
                mark(i)
            work += w
        return work + rs_work

    def run_until_idle(self, max_iters: int = 200_000) -> None:
        """Converge on ready-set emptiness plus device drain.

        The common exit is ONE cheap check: ``pump() == 0`` with an empty
        ready set means every shard was verified non-busy (devices drained,
        rings consumed, nothing in flight) — no idle sweeps over all
        servers.  The pre-overhaul three-idle-sweep escape survives only
        for quiescent-but-permanently-busy states (e.g. a shed request's
        forever-outstanding application op), where ``busy()`` never clears
        even though no pump can make progress.
        """
        idle = 0
        for _ in range(max_iters):
            if self.pump():
                idle = 0
                continue
            if not self._ready:
                return   # verified idle: nothing runnable, nothing busy
            for srv in self.servers:
                if srv.device.busy():
                    srv.device.drain()
            idle += 1
            if idle >= 3:
                return
        raise TimeoutError("cluster did not go idle")

    # -- aggregate accounting ---------------------------------------------------------
    def stats(self) -> ClusterStats:
        st = ClusterStats()
        for srv in self.servers:
            st.offloaded_completed += srv.offload.stats.completed
            st.bounced_to_host += srv.offload.stats.bounced_to_host
            st.host_responses += srv.director.stats.resp_from_host
            st.dpu_time_s += srv.director.stats.modeled_time_s
            st.host_cpu_busy_s += srv.host_cpu_busy_s
            st.per_shard_busy_s.append(srv.director.stats.modeled_time_s
                                       + srv.host_cpu_busy_s)
        return st

    def makespan_s(self) -> float:
        """Modeled completion time: the busiest shard bounds the cluster."""
        return max(self.stats().per_shard_busy_s, default=0.0)

    def latency_stats(self) -> dict:
        """Cluster-wide measured tick-latency distributions.

        Merges every shard's per-class lifecycle histograms and device
        completion histograms (all stamped against the SHARED cluster
        clock, so merging is meaningful).  Exact histograms are available
        via ``latency_histograms`` for determinism checks."""
        classes = self._merged_classes()
        dev = TickHistogram()
        dev_prio = TickHistogram()
        sheds = 0
        redirects = 0
        for srv in self.servers:
            sheds += srv.lifecycle.sheds
            redirects += srv.lifecycle.redirects
            dev.merge(srv.device.stats.completion_ticks)
            dev_prio.merge(srv.device.stats.prio_completion_ticks)
        out = {"classes": {c: h.summary() for c, h in classes.items() if h.n}}
        if sheds:
            out["sheds"] = sheds
        if redirects:
            out["redirects"] = redirects
        if dev.n:
            out["device"] = dev.summary()
        if dev_prio.n:
            out["device_prio"] = dev_prio.summary()
        repl = self._replication_summary()
        if repl is not None:
            out["replication"] = repl
        jr_records = jr_bytes = 0
        for srv in self.servers:
            jr_records += srv.fs.journal_replayed_records
            jr_bytes += srv.fs.journal_replayed_bytes
        if jr_records:
            out["journal_replay"] = {"records": jr_records,
                                     "bytes": jr_bytes}
        if self.failover_events:
            out["failover"] = {"epoch": self.epoch,
                               "events": list(self.failover_events)}
        if self.rejoin_events:
            out["rejoins"] = list(self.rejoin_events)
        wire_stats = {"corrupt_dropped": 0, "seq_resyncs": 0,
                      "dpu_bypassed": 0}
        eo = {"dup_suppressed": 0, "replayed_acks": 0}
        for srv in self.servers:
            ds = srv.director.stats
            wire_stats["corrupt_dropped"] += ds.corrupt_dropped
            wire_stats["seq_resyncs"] += ds.seq_resyncs
            wire_stats["dpu_bypassed"] += ds.dpu_bypassed
            eo["dup_suppressed"] += srv.host_app.dup_suppressed
            eo["replayed_acks"] += srv.host_app.replayed_acks
        if any(wire_stats.values()):
            out["wire"] = wire_stats
        if any(eo.values()):
            out["exactly_once"] = eo
        tenants = {t: {c: h.summary() for c, h in per.items() if h.n}
                   for t, per in sorted(self._merged_tenants().items())}
        for t, n in sorted(self._merged_tenant_sheds().items()):
            tenants.setdefault(t, {})["sheds"] = n
        if tenants:
            out["tenants"] = tenants
        admission = [srv.admission.summary() for srv in self.servers
                     if srv.admission is not None]
        if admission:
            out["admission"] = {
                "offered": sum(a["offered"] for a in admission),
                "granted": sum(a["granted"] for a in admission),
                "shed": sum(a["shed"] for a in admission),
            }
        reshard = self._resharding_summary()
        if reshard is not None:
            out["resharding"] = reshard
        return out

    def _resharding_summary(self) -> dict | None:
        """Migration observability: committed ring events, lifetime totals,
        and — while one is live — the active migration's summary."""
        if not (self.reshard_events or self.reshard_history
                or self.resharder is not None):
            return None
        out: dict = {"events": list(self.reshard_events),
                     "totals": dict(self.reshard_totals)}
        if self.reshard_history:
            out["completed"] = list(self.reshard_history)
        if self.resharder is not None:
            out["active"] = self.resharder.summary()
        if self.retired:
            out["retired"] = sorted(self.retired)
        return out

    def _replication_summary(self) -> dict | None:
        """Cluster-wide replication accounting: merged lag histogram (all
        stamps ride the shared clock) + forward/drop counters."""
        lag = TickHistogram()
        forwarded = fbytes = dropped = 0
        any_repl = False
        for srv in self.servers:
            repl = srv.replicator
            if repl is None:
                continue
            any_repl = True
            lag.merge(repl.lag)
            forwarded += repl.forwarded
            fbytes += repl.forwarded_bytes
            dropped += repl.dropped
        if not any_repl:
            return None
        out: dict = {"forwarded": forwarded, "bytes": fbytes}
        if lag.n:
            out["lag"] = lag.summary()
        if dropped:
            out["dropped_acks"] = dropped
        return out

    def _merged_classes(self) -> dict:
        """Every shard's per-class lifecycle histograms, merged (stamps all
        ride the SHARED cluster clock, so merging is meaningful)."""
        classes: dict[str, TickHistogram] = {}
        for srv in self.servers:
            for cls, h in srv.lifecycle.hist.items():
                agg = classes.get(cls)
                if agg is None:
                    agg = classes[cls] = TickHistogram()
                agg.merge(h)
        return classes

    def _merged_tenants(self) -> dict:
        """Per-tenant per-class histograms across shards (tenant 0 — the
        untenanted default — lives only in the aggregate classes)."""
        tenants: dict[int, dict[str, TickHistogram]] = {}
        for srv in self.servers:
            for t, per in srv.lifecycle.tenant_hist.items():
                agg_per = tenants.get(t)
                if agg_per is None:
                    agg_per = tenants[t] = {}
                for cls, h in per.items():
                    agg = agg_per.get(cls)
                    if agg is None:
                        agg = agg_per[cls] = TickHistogram()
                    agg.merge(h)
        return tenants

    def _merged_tenant_sheds(self) -> dict[int, int]:
        sheds: dict[int, int] = {}
        for srv in self.servers:
            for t, n in srv.lifecycle.tenant_sheds.items():
                sheds[t] = sheds.get(t, 0) + n
        return sheds

    def tenant_latency(self, tenant: int, cls: str) -> TickHistogram:
        """Merged cross-shard histogram for one (tenant, class) — the
        tenancy benchmark's victim-p99 probe."""
        agg = TickHistogram()
        for srv in self.servers:
            per = srv.lifecycle.tenant_hist.get(tenant)
            if per is not None:
                h = per.get(cls)
                if h is not None:
                    agg.merge(h)
        return agg

    def latency_histograms(self) -> dict:
        """Exact merged per-class histograms (byte-identical across two
        same-seed runs — the determinism gate compares these)."""
        return {c: h.as_dict()
                for c, h in sorted(self._merged_classes().items()) if h.n}
