"""Cluster client: per-shard batching + pipelining over the §8.1 wire format.

The single-server :class:`~repro_torch.core.dds_server.DDSClient` sends one network
message per call and blocks in ``wait``.  Serving heavy traffic needs the two
client-side techniques the paper's benchmark driver uses (§8.1):

  * **batching** — requests destined for the same shard are packed into one
    network message (``encode_batch``), so the traffic director runs its
    signature + predicate once per batch, not once per request;
  * **pipelining** — the client keeps issuing batches without waiting for
    responses; each shard's offload engine preserves per-connection request
    order (Fig 13), so responses stream back in issue order per shard.

Everything is cooperatively scheduled: ``pump()`` flushes pending batches,
steps every shard, and drains responses — tests can single-step the whole
cluster deterministically.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable

from repro_torch.core import wire
from repro_torch.core.dds_server import (_OP_KIND, DDSStorageServer,
                                   drain_client_flow, encode_app_read,
                                   encode_app_write, encode_batch)
from repro_torch.core.lifecycle import ClientLatency
from repro_torch.core.traffic import FLAG_SYN, FiveTuple, Packet
from repro_torch.core.vector import checksum64, scalar_mix

if TYPE_CHECKING:  # import cycle: distributed.cluster imports core
    from repro_torch.distributed.cluster import DDSCluster


@dataclass
class ClientStats:
    requests: int = 0
    batches_sent: int = 0
    messages_sent: int = 0
    responses: int = 0
    timeouts: int = 0        # tick deadlines that expired unanswered
    resends: int = 0         # requests re-sent from replay notes
    dup_responses: int = 0   # stale/duplicate wire responses discarded


class ShardConnection:
    """One PEP-terminated flow to one shard (non-blocking enqueue/flush)."""

    def __init__(self, server: DDSStorageServer, ip: str, port: int,
                 tenant: int = 0):
        self.server = server
        self.flow = FiveTuple(ip, port, "10.0.0.1", server.config.server_port,
                              tenant=tenant)
        self._resp_flow = self.flow.reversed()
        self._seq = 1  # after SYN
        self._pending: list[bytes] = []
        self._rx = bytearray()
        self.arrival_order: list[int] = []   # req ids in response order
        # Ring epoch stamped on every sent packet (-1 = untagged: standalone
        # and unreplicated traffic skips the director's epoch fence).
        self.epoch = -1
        server.director.ingress.push(Packet(self.flow, 0, b"", flags=FLAG_SYN))
        server.signal()
        server.director.step()

    def enqueue(self, msg: bytes) -> None:
        self._pending.append(msg)

    def flush(self) -> int:
        """Pack all pending messages into ONE network message (batching)."""
        if not self._pending:
            return 0
        payload = encode_batch(self._pending)
        n = len(self._pending)
        self._pending.clear()
        pkt = Packet(self.flow, self._seq, payload, epoch=self.epoch)
        if self.server.director.stamp_checksums:
            pkt.csum = checksum64(payload)
        self.server.director.ingress.push(pkt)
        self._seq += len(payload)
        self.server.signal()   # client send: mark the target shard runnable
        return n

    def collect(self, responses: dict[int, tuple[int, bytes]]) -> int:
        """Drain OUR flow's packets; reassemble the segmented response stream.

        The director's ``to_client`` wire is demuxed per flow, so this is an
        O(1) swap of our own queue — other clients' traffic is never touched
        (the old shared wire forced a pop-and-requeue scan past every other
        client's packets on every drain)."""
        return drain_client_flow(self.server.director, self._resp_flow,
                                 self._rx, responses, self.arrival_order)


class ClusterClient:
    """Batched, pipelined client for a :class:`DDSCluster`.

    Requests are routed by cluster-global file id through the cluster's
    consistent-hash placement (``cluster.locate``); applications with their
    own keys (e.g. the KV store) route via ``send_raw(shard, build_msg)``.
    """

    _next_base_port = 40000          # distinct flows per client by default
    _port_lock = threading.Lock()

    def __init__(self, cluster: "DDSCluster", ip: str = "10.0.0.9",
                 port: int | None = None, tenant: int = 0,
                 retry_attempts: int = 0, timeout_ticks: int = 0):
        self.cluster = cluster
        self.tenant = tenant
        self._ip = ip
        if port is None:
            # Each client needs its own source ports, or two clients' flows
            # (and therefore their responses) become indistinguishable.
            with ClusterClient._port_lock:
                port = ClusterClient._next_base_port
                ClusterClient._next_base_port += len(cluster.servers)
        self.conns = [ShardConnection(srv, ip, port + i, tenant)
                      for i, srv in enumerate(cluster.servers)]
        # Failover/reshard awareness, armed on replicated or elastic
        # clusters: packets are epoch-tagged, issued requests keep a replay
        # note, and an epoch bump (failover promotion or resharding flip)
        # transparently re-routes everything parked on the old owner.
        # Plain clusters pay one attribute test per pump.
        self._armed = cluster.supervisor is not None or cluster.elastic
        self._epoch_seen = cluster.epoch
        epoch = cluster.epoch if self._armed else -1
        for conn in self.conns:
            conn.epoch = epoch
        # Shed retry (bounded exponential backoff honoring the server's
        # ``retry_after`` hint): 0 = surface E_SHED to the caller directly.
        self.retry_attempts = retry_attempts
        # Lossy-wire recovery: a request unanswered for ``timeout_ticks``
        # is re-sent from its replay note with doubled backoff (the
        # server-side dedup cache makes resends exactly-once).  0 = off.
        self.timeout_ticks = timeout_ticks
        self._deadlines: dict[int, tuple[int, int]] = {}  # rid -> (due, attempt)
        self._replay_on = (self._armed or retry_attempts > 0
                           or timeout_ticks > 0)
        # rid -> ("op", kind, gfid, offset, arg) for fid-addressed requests
        # (MUST re-encode at replay: the promoted shard's adopted copy has a
        # different local fid) or ("raw", shard, msg, cls) for application
        # messages (key-addressed; the bytes stay valid on the new shard).
        self._replay: dict[int, tuple] = {}
        self._retries: dict[int, int] = {}        # rid -> shed retry count
        self._redirects_seen: dict[int, int] = {}  # rid -> redirect replays
        self._backoff: list[tuple[int, int]] = []  # (due tick, rid)
        self._next_rid = 1
        self._rid_shard: dict[int, int] = {}
        self._outstanding = 0          # issued, response not yet collected
        # Per-shard issued-minus-collected counts: ``poll`` harvests ONLY
        # shards with outstanding requests, and ``flush`` visits only dirty
        # (buffered-but-unsent) connections — client-side mirrors of the
        # cluster's ready-set scheduling, so idle shards cost nothing.
        self._shard_outstanding = [0] * len(self.conns)
        self._dirty: list[int] = []    # shard indices with pending messages
        self._dirty_flag = [False] * len(self.conns)
        self._lock = threading.Lock()
        self.responses: dict[int, tuple[int, bytes]] = {}
        self.stats = ClientStats()
        # End-to-end tick latency: issue stamps per rid (reads and writes
        # in separate dicts — the class is known at issue, so the drain
        # pays one dict pop, no cross-object classification).  The
        # offloaded-vs-host split for reads lives in the server-side
        # lifecycle histograms, where it is exact.  The cluster's shared
        # clock makes deltas comparable across shards.
        self._issued_r: dict[int, int] = {}
        self._issued_w: dict[int, int] = {}
        self.latency = ClientLatency()
        self._lat_pos = [0] * len(self.conns)  # arrival_order scan cursors

    # -- request issue (buffered until the next flush/pump) -------------------------
    def _enqueue(self, shard: int, msg: bytes) -> None:
        self.conns[shard].enqueue(msg)
        if not self._dirty_flag[shard]:
            self._dirty_flag[shard] = True
            self._dirty.append(shard)

    def reserve_rids(self, shards: list[int], cls="r") -> list[int]:
        """Reserve one rid per target shard in ONE lock round.

        The shared bulk-issue path under :meth:`submit` and application
        burst clients (e.g. the KV store's ``submit``): rid range,
        outstanding counters and the rid->shard map are all updated in
        bulk, so a pipeline round of thousands of requests skips the
        per-call lock + dict churn.  ``cls`` picks the issue-tick stamp
        class for the end-to-end latency histograms: either one 'r'/'w'
        for the whole burst, or a per-op sequence for mixed batches."""
        n = len(shards)
        if shards and max(shards) >= len(self.conns):
            self._grow_conns()
        rid_shard = self._rid_shard
        with self._lock:
            # The per-shard counters gate response harvesting (poll skips
            # shards reading 0), so their updates stay under the client
            # lock — a lost `+= 1` against a concurrent poll() decrement
            # would park a shard with a response still queued.
            first = self._next_rid
            self._next_rid += n
            self._outstanding += n
            outs = self._shard_outstanding
            rids = list(range(first, first + n))
            for rid, shard in zip(rids, shards):
                rid_shard[rid] = shard
                outs[shard] += 1
        now = self.cluster.clock.now
        if isinstance(cls, str):
            issued = self._issued_r if cls == "r" else self._issued_w
            for rid in rids:
                issued[rid] = now
        else:
            ir, iw = self._issued_r, self._issued_w
            for rid, c in zip(rids, cls):
                (ir if c == "r" else iw)[rid] = now
        self.stats.requests += n
        return rids

    def _grow_conns(self) -> None:
        """The cluster grew (elastic ``add_shard``): open flows to the new
        shards.  Ports come from the GLOBAL allocator — extending this
        client's original contiguous block would collide with whichever
        client allocated the next block."""
        cl = self.cluster
        n = len(cl.servers)
        if n <= len(self.conns):
            return
        add = n - len(self.conns)
        with ClusterClient._port_lock:
            base = ClusterClient._next_base_port
            ClusterClient._next_base_port += add
        epoch = cl.epoch if self._armed else -1
        for i in range(add):
            conn = ShardConnection(cl.servers[len(self.conns)],
                                   self._ip, base + i, self.tenant)
            conn.epoch = epoch
            self.conns.append(conn)
            self._lat_pos.append(0)
        with self._lock:
            while len(self._shard_outstanding) < n:
                self._shard_outstanding.append(0)
            while len(self._dirty_flag) < n:
                self._dirty_flag.append(False)

    def _rid(self, shard: int, cls: str = "r") -> int:
        if shard >= len(self.conns):
            self._grow_conns()
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            self._outstanding += 1
            self._shard_outstanding[shard] += 1
        self._rid_shard[rid] = shard
        issued = self._issued_r if cls == "r" else self._issued_w
        issued[rid] = self.cluster.clock.now
        self.stats.requests += 1
        return rid

    def _arm_timeout(self, rid: int) -> None:
        if self.timeout_ticks:
            self._deadlines[rid] = (self.cluster.clock.now
                                    + self.timeout_ticks, 0)

    def read(self, gfid: int, offset: int, nbytes: int) -> int:
        loc = self.cluster.locate(gfid)
        rid = self._rid(loc.shard)
        if self._replay_on:
            self._replay[rid] = ("op", "r", gfid, offset, nbytes)
            self._arm_timeout(rid)
        self._enqueue(loc.shard,
                      encode_app_read(rid, loc.local_fid, offset, nbytes))
        return rid

    # -- unified burst surface --------------------------------------------------------
    def submit(self, ops: list[tuple]) -> list[int]:
        """Issue a burst of operations; returns one handle (request id) per
        op, in order.  THE burst-issue surface — every legacy burst name
        (``read_many``/``write_many``/``wait_many``) is a thin deprecated
        wrapper over ``submit``/:meth:`harvest`.

        Ops are ``("r"|"read", gfid, offset, nbytes)`` or
        ``("w"|"write", gfid, offset, data)``; reads and writes mix freely
        in one batch (per-op latency classes ride the generalized
        :meth:`reserve_rids`).  The client's tenant binds once per
        connection and rides every flow — never passed per call.
        """
        locate = self.cluster.locate
        locs = []
        cls = []
        for op in ops:
            cls.append(_OP_KIND[op[0]])
            locs.append(locate(op[1]))
        rids = self.reserve_rids([loc.shard for loc in locs], cls)
        enqueue = self._enqueue
        replay = self._replay if self._replay_on else None
        for rid, loc, k, op in zip(rids, locs, cls, ops):
            if replay is not None:
                replay[rid] = ("op", k, op[1], op[2], op[3])
                self._arm_timeout(rid)
            if k == "r":
                enqueue(loc.shard,
                        encode_app_read(rid, loc.local_fid, op[2], op[3]))
            else:
                enqueue(loc.shard,
                        encode_app_write(rid, loc.local_fid, op[2], op[3]))
        return rids

    def read_many(self, reads: list[tuple[int, int, int]]) -> list[int]:
        """Deprecated: ``submit([("r", gfid, off, n), ...])``."""
        return self.submit([("r", gfid, offset, nbytes)
                            for gfid, offset, nbytes in reads])

    def write(self, gfid: int, offset: int, data: bytes) -> int:
        loc = self.cluster.locate(gfid)
        rid = self._rid(loc.shard, "w")
        if self._replay_on:
            self._replay[rid] = ("op", "w", gfid, offset, data)
            self._arm_timeout(rid)
        self._enqueue(loc.shard,
                      encode_app_write(rid, loc.local_fid, offset, data))
        return rid

    def write_many(self, writes: list[tuple[int, int, bytes]]) -> list[int]:
        """Deprecated: ``submit([("w", gfid, off, data), ...])``.

        Writes to one shard keep issue order, which the coalescing file
        service turns into adjacent scatter-gather runs."""
        return self.submit([("w", gfid, offset, data)
                            for gfid, offset, data in writes])

    def send_raw(self, shard: int, build_msg: Callable[[int], bytes],
                 cls: str = "r", key: bytes | None = None) -> int:
        """Route an application-defined message to an explicit shard.

        The shard is translated through the cluster's repair chain at
        issue time: after a failover the ring owner's route moves to the
        promoted replica and STAYS moved — even once the old primary
        heals and rejoins as a replica, sending to it directly would
        split-brain its application state.

        ``key`` (optional) is kept on the replay note: a resharding flip
        moves key OWNERSHIP without a failover, so a replay must re-hash
        the key against the current ring rather than follow the repair
        chain of the originally targeted shard."""
        shard = self.cluster.route_of(shard)
        rid = self._rid(shard, cls)
        msg = build_msg(rid)
        if self._replay_on:
            self._replay[rid] = ("raw", shard, msg, cls, key)
            self._arm_timeout(rid)
        self._enqueue(shard, msg)
        return rid

    def issue_many(self, shards: list[int],
                   build_msg: Callable[[int, int], bytes],
                   cls: str = "r", keys: list | None = None) -> list[int]:
        """Burst form of :meth:`send_raw`: the PUBLIC bulk-issue path for
        application clients (e.g. the KV store's ``get_many``).

        ``build_msg(rid, i)`` encodes the i-th message with its reserved
        request id.  One rid-range reservation covers the whole burst, and
        enqueueing stays inside this class so the dirty-connection and
        per-shard outstanding bookkeeping cannot be bypassed.  Target
        shards follow the cluster's repair chain (see :meth:`send_raw`);
        ``keys`` (optional, parallel to ``shards``) makes replays re-hash
        each key against the current ring (resharding flips)."""
        route_of = self.cluster.route_of
        shards = [route_of(s) for s in shards]
        rids = self.reserve_rids(shards, cls)
        enqueue = self._enqueue
        replay = self._replay if self._replay_on else None
        for i, (rid, shard) in enumerate(zip(rids, shards)):
            msg = build_msg(rid, i)
            if replay is not None:
                replay[rid] = ("raw", shard, msg,
                               cls if isinstance(cls, str) else cls[i],
                               keys[i] if keys is not None else None)
                self._arm_timeout(rid)
            enqueue(shard, msg)
        return rids

    # -- pipelined scheduling ---------------------------------------------------------
    def flush(self) -> int:
        """Send one batched message per DIRTY shard with buffered requests.

        Only connections that actually buffered messages since the last
        flush are visited (and their shards doorbell-signaled through
        ``ShardConnection.flush``) — on a 16-shard cluster with skewed
        traffic the old every-conn scan was pure idle cost."""
        if not self._dirty:
            return 0
        sent = 0
        dirty, self._dirty = self._dirty, []
        flags = self._dirty_flag
        for i in dirty:
            flags[i] = False
            n = self.conns[i].flush()
            if n:
                self.stats.batches_sent += 1
                self.stats.messages_sent += n
                sent += n
        return sent

    def pump(self) -> int:
        """One cooperative step: flush -> step every shard -> drain responses.

        On replicated clusters the step also reconciles failovers (a ring
        epoch bump re-routes and replays everything parked on the dead
        shard) and releases shed retries whose backoff expired."""
        work = self.flush()
        work += self.cluster.pump()
        if self._armed:
            work += self._sync_epoch()
        if self._backoff:
            work += self._pump_backoff()
        if self._deadlines:
            work += self._pump_timeouts()
        return work + self.poll()

    def poll(self) -> int:
        """Drain THIS client's responses without stepping the cluster.

        Harvests ONLY shards with outstanding requests (the per-shard
        issued-minus-collected counters): with several clients sharing a
        16-shard cluster, a client with traffic on two shards no longer
        peeks the other fourteen demuxed queues on every scheduling round.
        """
        responses = self.responses
        got = 0
        outs = self._shard_outstanding
        lat_pos = self._lat_pos
        collected: list[tuple[int, int]] = []
        rid_shard = self._rid_shard
        for i, conn in enumerate(self.conns):
            if not outs[i]:
                continue
            before = len(responses)
            conn.collect(responses)
            ao = conn.arrival_order
            if len(ao) > lat_pos[i]:
                # Exactly-once at the client: a resent request can be
                # answered twice (or a healed shard can flush a stale
                # ack).  A response whose rid is no longer booked was
                # already surfaced — discard it BEFORE the outstanding
                # accounting below, or the spurious decrement would park
                # a shard with responses still owed.
                # (pop, not del: a duplicated frame can land the same
                # rid twice in one drain window.)
                for rid in ao[lat_pos[i]:]:
                    if rid not in rid_shard and \
                            responses.pop(rid, None) is not None:
                        self.stats.dup_responses += 1
                self._record_latency(conn, ao, lat_pos[i])
                if len(ao) >= 1 << 16:
                    # Fully consumed: reset so a long-running client's
                    # arrival log cannot grow without bound.
                    conn.arrival_order = []
                    lat_pos[i] = 0
                else:
                    lat_pos[i] = len(ao)
            n = len(responses) - before
            if n:
                collected.append((i, n))
                got += n
        if got:
            # Decrement under the issue lock: `-=` is read-modify-write,
            # and racing a concurrent issuer's increment could lose one and
            # park the shard (poll would skip it forever).
            with self._lock:
                for i, n in collected:
                    outs[i] -= n
                self._outstanding -= got
            self.stats.responses += got
        return got

    def _record_latency(self, conn: ShardConnection, arrival_order: list,
                        pos: int) -> None:
        """End-to-end issue->drain ticks for newly arrived responses.

        Classified read/write from the issue-side stamp dicts (one pop on
        the common path); the offloaded-vs-host split for reads is exact in
        the serving shard's ``lifecycle`` histograms."""
        latency = self.latency
        now = self.cluster.clock.now
        wpop = self._issued_w.pop
        rpop = self._issued_r.pop
        radd = latency.hist_for("read").add
        wadd = latency.hist_for("write").add
        for rid in arrival_order[pos:]:
            t0 = rpop(rid, None)
            if t0 is not None:
                radd(now - t0)
                continue
            t0 = wpop(rid, None)
            if t0 is not None:
                wadd(now - t0)

    def _any_terminal(self) -> bool:
        """True iff any connected server holds a terminal mark."""
        conns = self.conns
        seen: set[int] = set()
        for conn in (conns.values() if hasattr(conns, "values") else conns):
            lc = conn.server.lifecycle
            if id(lc) in seen:
                continue
            seen.add(id(lc))
            if lc.has_terminal():
                return True
        return False

    def _check_terminal(self, rids) -> int:
        """Reconcile terminal server-side marks for ``rids``.

        A terminally marked request never gets a wire response; without
        this, ``wait`` and ``harvest`` would spin their whole iteration
        budget into a timeout heuristic.  Two mark kinds:

        ``E_SHED``
            Dropped under overload/admission — surfaced to the caller as a
            ``(E_SHED, hint)`` response (``harvest`` may then retry it
            under the bounded-backoff policy).

        ``E_REDIRECT``
            Refused by the epoch fence: the request was routed before a
            failover repaired the ring.  Replayed transparently against
            the repaired ring with the SAME request id (bounded per rid);
            surfaced terminally only past the cap or with no replay note.

        Each mark is reconciled against ITS OWN shard's outstanding counter
        exactly once — the rid->shard entry is consumed on surfacing, so a
        rid can never be double-decremented (or charged against another
        tenant's connection) even if callers probe it again."""
        found = 0
        responses = self.responses
        conns = self.conns
        rid_shard = self._rid_shard
        for rid in rids:
            shard = rid_shard.get(rid)
            if shard is None:
                continue
            conn = conns[shard]
            term = conn.server.lifecycle.take_terminal(conn.flow, rid)
            if term is None:
                continue
            code, hint = term
            if code == wire.E_REDIRECT:
                seen = self._redirects_seen.get(rid, 0)
                if rid in self._replay and seen < 8:
                    self._redirects_seen[rid] = seen + 1
                    self._sync_epoch()
                    if self._resubmit(rid):
                        found += 1
                        continue
                    continue  # _resubmit surfaced it terminally
            responses[rid] = (code, hint)
            rid_shard.pop(rid, None)
            self._issued_r.pop(rid, None)
            self._issued_w.pop(rid, None)
            with self._lock:
                self._shard_outstanding[shard] -= 1
                self._outstanding -= 1
            found += 1
        return found

    # -- failover reconciliation -------------------------------------------------------
    def _sync_epoch(self) -> int:
        """Adopt the cluster's ring epoch after a failover.

        Updates every connection's outgoing epoch tag and re-routes each
        unanswered request parked on a now-dead shard — the dead shard can
        never answer, so without this those rids would hang forever.
        Returns the number of requests moved (work, for pump loops)."""
        cur = self.cluster.epoch
        if cur == self._epoch_seen:
            return 0
        self._epoch_seen = cur
        self._grow_conns()   # an elastic add_shard bumps the epoch too
        for conn in self.conns:
            conn.epoch = cur
        dead = self.cluster._dead
        if not dead:
            return 0
        moved = 0
        responses = self.responses
        for rid, shard in list(self._rid_shard.items()):
            if shard not in dead or rid in responses:
                continue
            if self._resubmit(rid):
                moved += 1
        return moved

    def _replay_msg(self, rid: int, entry: tuple) -> tuple[int, bytes]:
        """Re-materialize a request against the CURRENT ring: fid-addressed
        ops re-encode (the promoted shard's adopted copy has a different
        local fid); raw application messages re-route by repaired shard."""
        if entry[0] == "op":
            _, kind, gfid, offset, arg = entry
            loc = self.cluster.locate(gfid)
            if kind == "r":
                return loc.shard, encode_app_read(rid, loc.local_fid,
                                                  offset, arg)
            return loc.shard, encode_app_write(rid, loc.local_fid,
                                               offset, arg)
        _, shard, msg, _cls, key = entry
        if key is not None:
            # Key-addressed: ownership may have MOVED at a resharding
            # flip — re-hash against the current ring (the repair chain
            # only tracks failover promotions, not migrations).
            return self.cluster.shard_for_key(key), msg
        return self.cluster.route_of(shard), msg

    def _resubmit(self, rid: int) -> bool:
        """Move a still-booked rid to its repaired shard and re-enqueue it.

        Counters stay booked (the request never surfaced); only the
        per-shard split moves.  A rid with no replay note — or whose
        repaired route is itself dead (unrecoverable group) — is surfaced
        terminally as ``(E_REDIRECT, current epoch)`` instead, so callers
        see a retryable error rather than a hang."""
        old = self._rid_shard.get(rid)
        if old is None:
            return False
        entry = self._replay.get(rid)
        shard = None
        if entry is not None:
            shard, msg = self._replay_msg(rid, entry)
        if shard is None or shard in self.cluster._dead:
            self.responses[rid] = (
                wire.E_REDIRECT, wire.encode_redirect_hint(self.cluster.epoch))
            self._rid_shard.pop(rid, None)
            self._issued_r.pop(rid, None)
            self._issued_w.pop(rid, None)
            with self._lock:
                self._shard_outstanding[old] -= 1
                self._outstanding -= 1
            return False
        if shard != old:
            with self._lock:
                self._shard_outstanding[old] -= 1
                self._shard_outstanding[shard] += 1
            self._rid_shard[rid] = shard
        self._enqueue(shard, msg)
        return True

    # -- shed retry with bounded exponential backoff ------------------------------------
    def _maybe_retry_shed(self, got: dict, pending: set) -> None:
        """Pull retryable E_SHED results back into ``pending``.

        Honors the server's ``retry_after`` hint scaled by an exponential
        per-attempt factor; after ``retry_attempts`` tries the E_SHED
        surfaces to the caller as the terminal answer."""
        if not self.retry_attempts:
            return
        for rid in list(got):
            code, hint = got[rid]
            if code != wire.E_SHED or rid not in self._replay:
                continue
            attempt = self._retries.get(rid, 0)
            if attempt >= self.retry_attempts:
                continue   # cap reached: surface the terminal error
            del got[rid]
            pending.add(rid)
            self._retries[rid] = attempt + 1
            _, retry_after = wire.decode_shed_hint(hint)
            # Deterministic per-rid jitter de-synchronizes retry storms:
            # without it every client shed in the same tick retries in
            # the same tick, re-colliding forever.  ``scalar_mix`` is a
            # pure function of (rid, attempt), so two same-seed runs
            # still pick identical deadlines.
            base = max(1, retry_after) << attempt
            jitter = scalar_mix(rid ^ (attempt << 56)) % base
            self._backoff.append(
                (self.cluster.clock.now + base + jitter, rid))

    def _pump_backoff(self) -> int:
        """Re-issue shed retries whose backoff deadline passed."""
        now = self.cluster.clock.now
        due = [rid for t, rid in self._backoff if t <= now]
        if not due:
            return 0
        self._backoff = [(t, rid) for t, rid in self._backoff if t > now]
        n = 0
        for rid in due:
            if self._rebook(rid):
                n += 1
        return n

    def _rebook(self, rid: int) -> bool:
        """Re-book a fully surfaced rid (counters were released when the
        E_SHED surfaced) and re-issue it along the repaired route."""
        entry = self._replay.get(rid)
        if entry is None:
            return False
        shard, msg = self._replay_msg(rid, entry)
        if shard in self.cluster._dead:
            return False
        cls = entry[1] if entry[0] == "op" else entry[3]
        with self._lock:
            self._outstanding += 1
            self._shard_outstanding[shard] += 1
        self._rid_shard[rid] = shard
        # Re-stamp the issue tick: the latency histogram records this
        # attempt's issue->drain, not time spent parked in backoff.
        issued = self._issued_r if cls == "r" else self._issued_w
        issued[rid] = self.cluster.clock.now
        self._arm_timeout(rid)   # re-booked requests regain loss protection
        self._enqueue(shard, msg)
        return True

    def _pump_timeouts(self) -> int:
        """Resend requests whose tick deadline expired unanswered.

        The resend re-materializes the request against the CURRENT ring
        (same request id — the server-side dedup cache suppresses the
        copy if the original survived, or replays the cached ack if only
        the ack was lost) and re-arms the deadline with doubled backoff.
        Deadlines for answered/surfaced rids are dropped lazily here."""
        now = self.cluster.clock.now
        due = [rid for rid, (t, _a) in self._deadlines.items() if t <= now]
        if not due:
            return 0
        n = 0
        tmo = self.timeout_ticks
        for rid in due:
            if rid in self.responses or rid not in self._rid_shard:
                self._deadlines.pop(rid, None)
                continue
            entry = self._replay.get(rid)
            if entry is None:
                self._deadlines.pop(rid, None)
                continue
            attempt = self._deadlines[rid][1]
            shard, msg = self._replay_msg(rid, entry)
            if shard in self.cluster._dead:
                # Repaired route still down: leave recovery to the
                # failover machinery, re-arm one plain window.
                self._deadlines[rid] = (now + tmo, attempt)
                continue
            old = self._rid_shard[rid]
            if shard != old:
                with self._lock:
                    self._shard_outstanding[old] -= 1
                    self._shard_outstanding[shard] += 1
                self._rid_shard[rid] = shard
            self._enqueue(shard, msg)
            self.stats.timeouts += 1
            self.stats.resends += 1
            self._deadlines[rid] = (now + (tmo << min(attempt + 1, 6)),
                                    attempt + 1)
            n += 1
        return n

    def _finalize(self, rid: int) -> None:
        """Drop replay/retry bookkeeping once a result reaches the caller."""
        self._replay.pop(rid, None)
        self._retries.pop(rid, None)
        self._redirects_seen.pop(rid, None)
        self._deadlines.pop(rid, None)

    def outstanding(self) -> int:
        """Issued-but-unanswered requests — an O(1) counter, not a dict scan."""
        return self._outstanding

    def _drain_busy_devices(self) -> None:
        """Settle device backlogs — only on shards whose device is busy
        (the old every-shard ``drain()`` was an idle-cost sweep)."""
        for srv in self.cluster.servers:
            if srv.device.busy():
                srv.device.drain()

    def run_until_idle(self, max_iters: int = 200_000) -> None:
        """Converge on ready-set emptiness + no outstanding requests.

        ``pump() == 0`` already certifies no shard is runnable or busy (the
        cluster verifies ``busy()`` on an empty ready set), so the common
        exit is a single zero-work round — no idle sweeps.  The bounded
        idle escape survives only for genuinely unanswerable requests
        (e.g. shed under overload)."""
        idle = 0
        for _ in range(max_iters):
            if self.pump():
                idle = 0
                continue
            if self.outstanding() == 0:
                return
            self._drain_busy_devices()
            # Reconcile terminal marks: a shed or epoch-refused request
            # will never produce wire work, so without this the
            # outstanding counters stay elevated forever and idle
            # convergence always burns the full 8-round escape hatch.
            if self._check_terminal(list(self._rid_shard)):
                continue
            if self._armed and any(s in self.cluster._dead
                                   for s in set(self._rid_shard.values())):
                # Requests parked on a crashed shard are not unanswerable —
                # the supervisor will promote a replica within its timeout;
                # keep pumping so detection and replay can run.
                idle = 0
                continue
            idle += 1
            if idle >= 8:
                return  # idle with requests genuinely unanswerable
        raise TimeoutError("cluster client did not go idle")

    # -- response access ----------------------------------------------------------------
    def wait(self, rid: int, max_iters: int = 200_000) -> tuple[int, bytes]:
        for _ in range(max_iters):
            if rid in self.responses:
                self._rid_shard.pop(rid, None)
                self._finalize(rid)
                return self.responses.pop(rid)
            if self.pump() == 0:
                self._drain_busy_devices()
                self._check_terminal((rid,))   # answered terminally
        raise TimeoutError(f"no response for request {rid}")

    def harvest(self, handles=None, block: bool = True,
                max_iters: int = 200_000) -> dict[int, tuple[int, bytes]]:
        """Collect responses: ``{handle: (status, body)}``.

        ``handles=None`` drains whatever has already arrived (one poll;
        never steps the cluster).  With explicit handles and ``block=True``
        this waits for ALL of them, harvesting whichever completes first:
        it pumps once per iteration while collecting every arrived handle —
        a serial per-handle ``wait`` loop would head-of-line block on the
        first one even when later handles (on other shards) had long
        completed.  Harvesting rides ``poll``'s outstanding-only scan, so
        only shards that still owe responses are touched.  On idle
        iterations, handles the servers marked SHED are answered terminally
        as ``(wire.E_SHED, hint)`` — a shed request can never produce a
        wire response, so waiting on a timeout heuristic would spin the
        whole iteration budget."""
        if handles is None:
            self.poll()
            out = dict(self.responses)
            rid_shard = self._rid_shard
            for rid in out:
                rid_shard.pop(rid, None)
                self._finalize(rid)
            self.responses.clear()
            return out
        got: dict[int, tuple[int, bytes]] = {}
        pending = set(handles)
        pending -= self._harvest(pending, got)
        if not block:
            self.poll()
            self._check_terminal(pending)
            pending -= self._harvest(pending, got)
            for rid in got:
                self._finalize(rid)
            return got
        for _ in range(max_iters):
            if not pending:
                for rid in got:
                    self._finalize(rid)
                return {rid: got[rid] for rid in handles}  # caller's order
            if self.pump() == 0:
                self._drain_busy_devices()
                self._check_terminal(pending)
            elif self._any_terminal():
                # Epoch-fence refusals can land while the cluster stays
                # busy for a long stretch (a live migration pumps work
                # through its whole cleanup grace).  Waiting for the
                # pump to go idle would stall the transparent replay
                # until retirement — reconcile as soon as any terminal
                # mark exists.  The probe is O(conns), so the common
                # no-terminal iteration stays cheap.
                self._check_terminal(pending)
            pending -= self._harvest(pending, got)
            if self.retry_attempts:
                self._maybe_retry_shed(got, pending)
        raise TimeoutError(f"no response for requests {sorted(pending)[:8]}...")

    def wait_many(self, rids: list[int],
                  max_iters: int = 200_000) -> dict[int, tuple[int, bytes]]:
        """Deprecated: ``harvest(rids)``."""
        return self.harvest(rids, max_iters=max_iters)

    def _harvest(self, pending: set[int],
                 got: dict[int, tuple[int, bytes]]) -> set[int]:
        """Move every already-answered rid out of ``self.responses``."""
        done = pending & self.responses.keys()
        for rid in done:
            got[rid] = self.responses.pop(rid)
            self._rid_shard.pop(rid, None)
        return done
