"""Elastic resharding: crash-safe live key migration between shards.

Growing or shrinking a :class:`~repro_torch.distributed.cluster.DDSCluster`
means moving the keys whose consistent-hash owner changes between the
old and the new :class:`HashRing`.  The migration must be LIVE (the
cluster keeps serving), CRASH-SAFE (no acked write is ever lost, no
matter which endpoint dies at which phase) and EXACTLY-ONCE (a resent
sync never double-applies).  The driver here reuses the existing data
plane for all of it:

* sync traffic rides :class:`~repro_torch.core.client.ShardConnection` flows
  to the destination — the same host wire, batching and PEP ordering as
  client traffic, exactly like PR 7's replica forwarding;
* writes that race the migration are DUAL-ROUTED: the source's
  ``migrator`` tap (installed on ``DDSStorageServer``) forwards every
  write it executes for a migrating key and HOLDS the client ack until
  the destination holds the bytes too (piggybacking on the server's
  ``_held_acks`` machinery);
* resends reuse the same request id, so the destination's exactly-once
  dedup cache absorbs duplicates;
* the ownership flip is one atomic ring swap + epoch bump — in-flight
  requests stamped with the old epoch bounce off the director's
  ``E_REDIRECT`` fence and the client replays them against the new
  owner.

Phases (journaled on BOTH endpoints so a crash leaves an unambiguous
resume/abort decision)::

    setup ── snapshot owned keys, install taps, arm shields
      │
    stream ─ push the snapshot window-by-window (tokenless syncs)
      │        new writes are forwarded immediately with known bytes
    dual ─── snapshot queue drained; every racing write now holds its
      │        client ack until the destination acks the sync
    flip ─── gate passed (no un-acked tokenless sync remains):
      │        journal intent, then swap ring + bump epoch + invalidate
      │        the source DPU cache for migrated keys
    cleanup ─ drain straggler syncs, grace period for fence-passed
      │        traffic, then drop the source's copies
    done

Any pre-flip fault (endpoint death or demotion) ABORTS: held acks are
released (the bytes are durable at the source, which keeps ownership)
and the destination's partial copy is dropped.  A source death DURING
flip proceeds — the flip gate guarantees the destination already holds
every acked migrating byte.  Short partitions merely stall the driver;
it resumes when the wire heals.

Ordering across the flip: every migration sync carries a PRE-flip
value, while every direct client write to the destination for a
migrated key is POST-flip (the fence re-routes clients only after the
flip).  The destination therefore arms a per-shard write SHIELD during
migration: a late (resent) sync for a key the destination has since
served a direct write for is acked but NOT applied — a stale pre-flip
value can never clobber a newer post-flip one.
"""

from __future__ import annotations

import struct
from collections import deque

from repro_torch.core import wire
from repro_torch.core.client import ShardConnection

# Migration phases in lifecycle order.  ``abort``/``aborted`` branch off
# any pre-flip phase.
PHASES = ("setup", "stream", "dual", "flip", "cleanup", "done",
          "abort", "aborted")
PHASE_CODES = {p: i + 1 for i, p in enumerate(PHASES)}
CODE_PHASES = {c: p for p, c in PHASE_CODES.items()}

# Journal record: (seq, pair_id, phase_code, aux, cursor, tick).
J_REC = struct.Struct("<IIIIQQ")

WINDOW = 32           # max in-flight snapshot syncs per pair
RESEND_TICKS = 64     # first resend deadline (doubles per attempt)
MAX_ATTEMPTS = 8      # pre-flip give-up threshold -> abort
CLEANUP_GRACE = 96    # ticks between flip and dropping source copies

_UNSET = object()     # "no acked loc yet" / "value not supplied"


class MigrationJournal:
    """Crash-consistent migration log, one append-only file per endpoint.

    Records are written through the fs allocator straight to device
    memory (``raw_write`` commits immediately in the model) — NOT via
    the front-end rings, whose synchronous helpers would eat completions
    of concurrent host traffic on a busy shard.  Each record lands on
    both the source's and the destination's journal, so whichever
    endpoint survives a crash can reconstruct the phase cursor.
    """

    def __init__(self, cluster, tag: str):
        self.cluster = cluster
        self.tag = tag
        self._fids: dict[int, int] = {}
        self._off: dict[int, int] = {}
        self._seq = 0

    def attach(self, shard: int) -> None:
        if shard in self._fids:
            return
        srv = self.cluster.servers[shard]
        self._fids[shard] = srv.fs.create_file(
            f"reshard-journal:{self.tag}:{shard}")
        self._off[shard] = 0

    def record(self, shards, pair_id: int, phase: str,
               cursor: int = 0, aux: int = 0) -> None:
        self._seq += 1
        rec = J_REC.pack(self._seq, pair_id, PHASE_CODES[phase], aux,
                         cursor, self.cluster.clock.now)
        cl = self.cluster
        for shard in shards:
            fid = self._fids.get(shard)
            if (fid is None or shard in cl._dead
                    or cl.route_of(shard) != shard):
                continue   # dead/demoted endpoints can't journal
            srv = cl.servers[shard]
            off = self._off[shard]
            srv.fs.ensure_capacity(fid, off + J_REC.size)
            pos = 0
            for phys, n in srv.fs.translate(fid, off, J_REC.size):
                srv.device.raw_write(phys, rec[pos:pos + n])
                pos += n
            self._off[shard] = off + J_REC.size

    def read(self, shard: int) -> list[dict]:
        """Parse ``shard``'s journal (tests + post-crash inspection)."""
        fid = self._fids.get(shard)
        if fid is None:
            return []
        srv = self.cluster.servers[shard]
        out = []
        for off in range(0, self._off.get(shard, 0), J_REC.size):
            buf = b"".join(srv.device.raw_read(phys, n)
                           for phys, n in
                           srv.fs.translate(fid, off, J_REC.size))
            seq, pid, code, aux, cursor, tick = J_REC.unpack(buf)
            out.append({"seq": seq, "pair": pid,
                        "phase": CODE_PHASES.get(code, "?"),
                        "aux": aux, "cursor": cursor, "tick": tick})
        return out


class _Flight:
    """One outstanding sync message (at most one per key per pair)."""

    __slots__ = ("key", "loc", "tokens", "msg", "due", "attempt")

    def __init__(self, key, loc, tokens, msg, due):
        self.key = key
        self.loc = loc
        self.tokens = tokens   # held client-ack request ids
        self.msg = msg
        self.due = due
        self.attempt = 0


class _MigrationPair:
    """Migration state for one (source, dest) shard pair."""

    def __init__(self, pid: int, source: int, dest: int,
                 conn: ShardConnection):
        self.pid = pid
        self.source = source
        self.dest = dest
        self.conn = conn
        self.queue: deque = deque()          # snapshot keys to stream
        self.flight: dict[int, _Flight] = {}  # rrid -> flight
        self.key_flight: dict = {}            # key -> rrid (single-flight)
        self.pending: dict = {}               # key -> [loc, value, tokens]
        self.acked_loc: dict = {}             # key -> last synced loc
        self.streamed: set = set()            # keys acked at least once
        self.responses: dict[int, tuple[int, bytes]] = {}
        self.dirty = False
        self.dropped = False
        self.acked = 0
        self.journaled = 0
        self.snapshot_n = 0
        self.keys_migrated = 0
        self.bytes_streamed = 0
        self.dual_routed = 0
        self.resent = 0
        self.failures = 0


class _SourceTap:
    """Installed as ``srv.migrator`` on each migration SOURCE.

    ``forward`` is called from the server's execute path with the final
    on-disk record bytes of every write — the same hook point as the
    replicator.  It parses the record (never touches the device from tap
    context), routes the key against the NEW ring, and offers the write
    to the matching pair.  Returning True holds the client ack until the
    destination acks the sync.
    """

    def __init__(self, rs: "Resharder", source: int):
        self.rs = rs
        self.source = source
        self.held: set[int] = set()   # client request ids we're holding

    def forward(self, rid: int, file_id: int, offset: int, data) -> bool:
        rs = self.rs
        if rs.phase in ("abort", "aborted", "done"):
            return False
        parsed = rs.app.parse_migration_record(self.source, file_id,
                                               offset, data)
        if parsed is None:
            return False   # not this shard's KV log (journal, replicas...)
        key, loc, value = parsed
        dest = rs.new_ring.shard_for(key)
        if dest == self.source:
            return False   # key not migrating
        pair = rs.pair_by.get((self.source, dest))
        if pair is None or pair.dropped:
            return False
        if rs.phase in ("setup", "stream"):
            # Stream phase: forward with known bytes but do NOT hold the
            # ack — the flip gate only opens once these are all acked.
            rs._offer(pair, key, known=(loc, value))
            return False
        return rs._offer(pair, key, token=rid, known=(loc, value))

    def holds(self, rid: int) -> bool:
        return rid in self.held

    def busy(self) -> bool:
        return bool(self.held)


class Resharder:
    """Drives one ring membership change end to end.

    Installed via ``DDSCluster.start_reshard``; the cluster pump calls
    :meth:`step` every tick.  ``pairs`` is the list of ``(source, dest)``
    shard pairs whose keys move; ``new_ring`` is the target ring that is
    committed atomically at flip; ``retire`` lists shards leaving the
    cluster (shrink).
    """

    def __init__(self, cluster, app, new_ring, pairs, tag: str,
                 retire=()):
        self.cluster = cluster
        self.app = app
        self.new_ring = new_ring
        self.tag = tag
        self.retire = tuple(retire)
        self._pair_specs = list(pairs)
        self.pairs: list[_MigrationPair] = []
        self.pair_by: dict[tuple[int, int], _MigrationPair] = {}
        self.taps: dict[int, _SourceTap] = {}
        self.journal = MigrationJournal(cluster, tag)
        self.phase = "setup"
        self.reason = ""            # populated on abort
        self._next_rrid = 1
        self._flip_tick = -1

    # -- driver ------------------------------------------------------------------

    def step(self) -> int:
        """One migration tick; returns >0 while the migration is live."""
        if self.phase in ("done", "aborted"):
            return 0
        cl = self.cluster
        if self.phase == "setup":
            self._setup()
        if self._scan_faults():
            return 1    # partition stall: resume when the wire heals
        if self.phase in ("done", "aborted"):
            return 1
        now = cl.clock.now
        if self.phase == "abort":
            self._step_abort(now)
            return 1
        if self.phase == "flip":
            self._apply_flip()
        for pair in self.pairs:
            if not pair.dropped:
                self._step_pair(pair, now)
        if self.phase == "stream" and all(
                not p.queue for p in self.pairs if not p.dropped):
            self.phase = "dual"
            for p in self.pairs:
                if not p.dropped:
                    self.journal.record((p.source, p.dest), p.pid,
                                        "dual", cursor=p.acked)
        elif self.phase == "dual" and self._flip_ready():
            # Journal the flip INTENT one tick before applying it: a
            # crash between the two leaves a journaled "flip" record on
            # both endpoints, and the crash matrix resolves it (source
            # death proceeds, destination death aborts).
            self.phase = "flip"
            for p in self.pairs:
                if not p.dropped:
                    self.journal.record((p.source, p.dest), p.pid,
                                        "flip", cursor=p.acked)
        elif self.phase == "cleanup":
            self._maybe_finalize(now)
        return 1

    # -- setup -------------------------------------------------------------------

    def _setup(self) -> None:
        cl = self.cluster
        # Port space disjoint from clients (10.0.*, 40000+) and the
        # replicators (10.1.*, 45000+); the generation term keeps flows
        # fresh across successive migrations (the PEP remembers dropped
        # connections' sequence state).
        gen = 4096 * len(cl.reshard_events)
        sources = set()
        for pid, (s, d) in enumerate(self._pair_specs):
            conn = ShardConnection(cl.servers[d], f"10.2.{s}.1",
                                   47000 + s * 64 + d + gen)
            pair = _MigrationPair(pid, s, d, conn)
            self.pairs.append(pair)
            self.pair_by[(s, d)] = pair
            sources.add(s)
            self.journal.attach(s)
            self.journal.attach(d)
            self.app.arm_shield(d)
        for s in sorted(sources):
            tap = _SourceTap(self, s)
            self.taps[s] = tap
            cl.servers[s].migrator = tap
            # Make every snapshot-time index loc durable so the driver
            # can read record bytes straight from device memory; any
            # write landing after this point carries its bytes through
            # the tap instead.
            cl.servers[s].device.drain()
        ring = self.new_ring
        for pair in self.pairs:
            keys = [k for k in self.app.migration_keys(pair.source)
                    if ring.shard_for(k) == pair.dest]
            pair.queue = deque(keys)
            pair.snapshot_n = len(keys)
            self.journal.record((pair.source, pair.dest), pair.pid,
                                "setup", aux=len(keys))
        self.phase = "stream"

    # -- fault scan --------------------------------------------------------------

    def _scan_faults(self) -> bool:
        """Apply the crash matrix; True means 'stall this tick'."""
        cl = self.cluster
        for pair in self.pairs:
            if pair.dropped:
                continue
            for shard in (pair.source, pair.dest):
                if (shard in cl._partitioned
                        and cl.route_of(shard) == shard):
                    # Partitioned but not failed over: the endpoint will
                    # heal with state intact — stall, don't abort.
                    return True
        for pair in self.pairs:
            if pair.dropped:
                continue
            src_gone = (pair.source in cl._dead
                        or cl.route_of(pair.source) != pair.source)
            dst_gone = (pair.dest in cl._dead
                        or cl.route_of(pair.dest) != pair.dest)
            if not (src_gone or dst_gone):
                continue
            if self.phase in ("setup", "stream", "dual", "abort"):
                if self.phase != "abort":
                    who = pair.source if src_gone else pair.dest
                    self._begin_abort(f"shard{who} lost pre-flip")
                return False
            if self.phase == "flip":
                if dst_gone:
                    # Destination lost before the ring swap: the copy is
                    # gone, ownership never moved — abort cleanly.
                    self._begin_abort(f"shard{pair.dest} lost at flip")
                    return False
                # Source lost at flip: proceed.  The flip gate already
                # guaranteed the destination holds every acked byte.
            elif self.phase == "cleanup":
                # Ownership already moved; a dead endpoint just ends
                # this pair's drain early.  Held acks are released — the
                # bytes were durable at the source before being held.
                self._drop_pair(pair)
        return False

    def _drop_pair(self, pair: "_MigrationPair") -> None:
        pair.dropped = True
        tap = self.taps.get(pair.source)
        if tap is not None:
            for fl in pair.flight.values():
                for t in fl.tokens:
                    tap.held.discard(t)
            for pend in pair.pending.values():
                for t in pend[2]:
                    tap.held.discard(t)
            srv = self.cluster.servers[pair.source]
            if srv.migrator is tap:
                srv.signal()
        pair.flight.clear()
        pair.key_flight.clear()
        pair.pending.clear()

    # -- sync plumbing ------------------------------------------------------------

    def _offer(self, pair: "_MigrationPair", key, token=None,
               known=None) -> bool:
        """Offer one key for sync; True if the client ack is now held.

        Per-key SINGLE FLIGHT: at most one outstanding sync per key.  A
        racing write for an in-flight key parks its (newer) bytes in
        ``pending`` and is refreshed when the flight resolves — the sync
        stream for a key is therefore ordered and ends at the latest
        source-side value, which makes reorder/duplication on the wire
        harmless.
        """
        held = False
        rrid = pair.key_flight.get(key)
        if rrid is not None:
            fl = pair.flight[rrid]
            if known is not None and known[0] != fl.loc:
                pend = pair.pending.get(key)
                if pend is None:
                    pair.pending[key] = pend = [known[0], known[1], []]
                else:
                    pend[0], pend[1] = known
                if token is not None:
                    pend[2].append(token)
                    held = True
            elif token is not None:
                fl.tokens.append(token)
                held = True
        elif key in pair.pending:
            pend = pair.pending[key]
            if known is not None:
                pend[0], pend[1] = known
            if token is not None:
                pend[2].append(token)
                held = True
        else:
            cur = known[0] if known is not None \
                else self.app.index_loc(pair.source, key)
            if pair.acked_loc.get(key, _UNSET) != cur:
                toks = [] if token is None else [token]
                self._send(pair, key, cur, toks,
                           value=known[1] if known is not None else _UNSET)
                held = token is not None
        if held:
            self.taps[pair.source].held.add(token)
            pair.dual_routed += 1
        return held

    def _send(self, pair: "_MigrationPair", key, loc, tokens,
              value=_UNSET) -> None:
        if value is _UNSET:
            value = (None if loc is None
                     else self.app.read_value(pair.source, key, loc))
        rrid = self._next_rrid
        self._next_rrid += 1
        if value is None:
            msg = self.app.encode_migration_del(rrid, key)
        else:
            msg = self.app.encode_migration_put(rrid, key, value)
        fl = _Flight(key, loc, list(tokens), msg,
                     self.cluster.clock.now + RESEND_TICKS)
        pair.flight[rrid] = fl
        pair.key_flight[key] = rrid
        pair.conn.enqueue(msg)
        pair.dirty = True
        pair.bytes_streamed += len(msg)
        if tokens:
            self.taps[pair.source].held.update(tokens)

    def _on_ack(self, pair: "_MigrationPair", rrid: int,
                status: int) -> None:
        fl = pair.flight.pop(rrid, None)
        if fl is None:
            return   # stale/duplicate response
        if pair.key_flight.get(fl.key) == rrid:
            del pair.key_flight[fl.key]
        if status in (wire.E_OK, wire.E_NOENT):
            if fl.key not in pair.streamed:
                pair.streamed.add(fl.key)
                pair.keys_migrated += 1
        else:
            pair.failures += 1
        pair.acked += 1
        pair.acked_loc[fl.key] = fl.loc
        if fl.tokens:
            tap = self.taps.get(pair.source)
            if tap is not None:
                for t in fl.tokens:
                    tap.held.discard(t)
                # Wake the source so its completion loop releases the
                # no-longer-held client acks this tick.
                self.cluster.servers[pair.source].signal()
        if pair.acked - pair.journaled >= 64:
            pair.journaled = pair.acked
            self.journal.record((pair.source, pair.dest), pair.pid,
                                self.phase if self.phase in PHASE_CODES
                                else "stream", cursor=pair.acked)
        pend = pair.pending.pop(fl.key, None)
        if pend is not None:
            loc, value, toks = pend
            self._send(pair, fl.key, loc, toks, value=value)

    def _step_pair(self, pair: "_MigrationPair", now: int) -> None:
        if self.phase == "stream" and pair.queue:
            budget = WINDOW - len(pair.flight)
            while budget > 0 and pair.queue:
                key = pair.queue.popleft()
                if key in pair.key_flight or key in pair.pending:
                    continue   # a tapped write already syncs this key
                cur = self.app.index_loc(pair.source, key)
                if pair.acked_loc.get(key, _UNSET) == cur:
                    continue
                self._send(pair, key, cur, [])
                budget -= 1
        conn = pair.conn
        if pair.dirty:
            pair.dirty = False
            conn.flush()
        resp = pair.responses
        conn.collect(resp)
        conn.arrival_order.clear()
        if resp:
            for rrid in list(resp):
                status, _body = resp.pop(rrid)
                self._on_ack(pair, rrid, status)
        if pair.flight:
            # A destination overload-shed never answers on the wire:
            # reconcile terminal marks into immediate resend deadlines.
            lt = conn.server.lifecycle
            for rrid, fl in pair.flight.items():
                if lt.take_terminal(conn.flow, rrid) is not None:
                    fl.due = now
            for rrid, fl in list(pair.flight.items()):
                if now < fl.due:
                    continue
                fl.attempt += 1
                if (fl.attempt > MAX_ATTEMPTS
                        and self.phase in ("stream", "dual")):
                    self._begin_abort(
                        f"sync to shard{pair.dest} exhausted "
                        f"{MAX_ATTEMPTS} attempts")
                    return
                # Same rrid on the same flow: the destination's dedup
                # cache replays the ack if the original applied.
                conn.enqueue(fl.msg)
                pair.dirty = True
                pair.resent += 1
                fl.due = now + (RESEND_TICKS << min(fl.attempt, 6))
            if pair.dirty:
                pair.dirty = False
                conn.flush()

    # -- flip & cleanup ------------------------------------------------------------

    def _flip_ready(self) -> bool:
        """The gate: every sync WITHOUT a held client ack has landed.

        Token-carrying flights may remain in the air — their client acks
        are still held, so a post-flip source crash cannot lose a write
        any client has seen.
        """
        for pair in self.pairs:
            if pair.dropped:
                continue
            if pair.queue:
                return False
            for fl in pair.flight.values():
                if not fl.tokens:
                    return False
            for pend in pair.pending.values():
                if not pend[2]:
                    return False
        return True

    def _apply_flip(self) -> None:
        cl = self.cluster
        # Invalidate the source DPU cache for every migrated key BEFORE
        # the ring swap: a predicate probe memo taken pre-flip sees the
        # table epoch move and re-resolves.
        for pair in self.pairs:
            if pair.dropped:
                continue
            src = pair.source
            if src in cl._dead or cl.route_of(src) != src:
                continue
            table = cl.servers[src].cache_table
            if table is not None:
                table.delete_many(pair.acked_loc.keys())
        moved = sum(p.keys_migrated for p in self.pairs)
        cl.commit_ring(self.new_ring, {
            "kind": self.tag, "pairs": [(p.source, p.dest)
                                        for p in self.pairs],
            "keys_moved": moved})
        cl.retired.update(self.retire)
        for pair in self.pairs:
            if not pair.dropped:
                self.journal.record((pair.source, pair.dest), pair.pid,
                                    "cleanup", cursor=pair.acked)
        self._flip_tick = cl.clock.now
        self.phase = "cleanup"

    def _maybe_finalize(self, now: int) -> None:
        if now < self._flip_tick + CLEANUP_GRACE:
            return
        for pair in self.pairs:
            if pair.dropped:
                continue
            if pair.flight or pair.pending:
                return
        for tap in self.taps.values():
            if tap.held:
                return
        cl = self.cluster
        for pair in self.pairs:
            if pair.dropped:
                continue
            src = pair.source
            if src in cl._dead or cl.route_of(src) != src:
                continue
            # Drop the source's copies (index + any table entries the
            # fence-passed grace traffic re-warmed).
            self.app.drop_source_keys(src, set(pair.acked_loc))
            self.journal.record((src, pair.dest), pair.pid, "done",
                                cursor=pair.acked)
        self._disarm()
        self.phase = "done"

    # -- abort --------------------------------------------------------------------

    def _begin_abort(self, reason: str) -> None:
        self.phase = "abort"
        self.reason = reason
        cl = self.cluster
        for pair in self.pairs:
            if pair.dropped:
                continue
            self.journal.record((pair.source, pair.dest), pair.pid,
                                "abort", cursor=pair.acked)
            tap = self.taps.get(pair.source)
            # Release every held client ack NOW: the bytes are durable
            # at the source, which keeps ownership after an abort.
            if tap is not None:
                for fl in pair.flight.values():
                    for t in fl.tokens:
                        tap.held.discard(t)
                    fl.tokens.clear()
                for pend in pair.pending.values():
                    for t in pend[2]:
                        tap.held.discard(t)
                srv = cl.servers[pair.source]
                if srv.migrator is tap:
                    srv.signal()
            pair.pending.clear()
            dst_gone = (pair.dest in cl._dead
                        or cl.route_of(pair.dest) != pair.dest)
            if dst_gone:
                # Nothing to drain or clean: the partial copy died with
                # the destination.
                pair.dropped = True
                pair.flight.clear()
                pair.key_flight.clear()

    def _step_abort(self, now: int) -> None:
        """Drain live destinations' in-flight syncs, then drop their
        partial copies.  Draining FIRST matters: a late-applying sync
        after the drop would resurrect a dropped key."""
        cl = self.cluster
        for pair in self.pairs:
            if pair.dropped:
                continue
            if (pair.dest in cl._dead
                    or cl.route_of(pair.dest) != pair.dest):
                pair.dropped = True
                pair.flight.clear()
                pair.key_flight.clear()
                continue
            if pair.flight:
                self._step_pair(pair, now)
        if any(p.flight for p in self.pairs if not p.dropped):
            return
        for pair in self.pairs:
            if pair.dropped:
                continue
            dropped_keys = pair.streamed | set(pair.acked_loc)
            if dropped_keys:
                self.app.drop_dest_keys(pair.dest, dropped_keys)
            self.journal.record((pair.source, pair.dest), pair.pid,
                                "aborted", cursor=pair.acked)
        self._disarm()
        self.phase = "aborted"

    def _disarm(self) -> None:
        cl = self.cluster
        for s, tap in self.taps.items():
            srv = cl.servers[s]
            if srv.migrator is tap:
                srv.migrator = None
        for pair in self.pairs:
            self.app.disarm_shield(pair.dest)

    # -- observability --------------------------------------------------------------

    def summary(self) -> dict:
        per_pair = [{
            "source": p.source, "dest": p.dest,
            "snapshot": p.snapshot_n,
            "keys_migrated": p.keys_migrated,
            "bytes_streamed": p.bytes_streamed,
            "dual_routed": p.dual_routed,
            "resent": p.resent,
            "failures": p.failures,
            "dropped": p.dropped,
        } for p in self.pairs]
        out = {
            "tag": self.tag, "phase": self.phase,
            "keys_migrated": sum(p.keys_migrated for p in self.pairs),
            "bytes_streamed": sum(p.bytes_streamed for p in self.pairs),
            "dual_routed": sum(p.dual_routed for p in self.pairs),
            "resent": sum(p.resent for p in self.pairs),
            "failures": sum(p.failures for p in self.pairs),
            "pairs": per_pair,
        }
        if self.reason:
            out["reason"] = self.reason
        return out
