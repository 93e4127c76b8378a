"""DDS offload engine (§6): customizable read offloading on the DPU.

Users customize offloading with the four functions of Table 1:

  ``OffPred(Msg, CacheTable) -> (HostReqs, DPUReqs)``  — who serves a request
  ``OffFunc(Req, CacheTable) -> ReadOp | None``        — request -> file read
  ``Cache(WriteOp)   -> [(Key, CacheItem)]``           — cache-on-write
  ``Invalidate(ReadOp) -> [Key]``                      — invalidate-on-read

Execution follows Fig 13 exactly: a context ring book-keeps outstanding
reads in arrival order; if the ring is full the request (and the rest of the
batch) is bounced to the host via the traffic director; completions are
processed from the head and stop at the first still-pending context so
responses leave in request order.

Zero-copy (Fig 12): the engine pre-allocates a pool of DMA-accessible huge
pages.  A read's destination buffer is carved from the pool WITH HEADROOM for
the application response header, and the response "packets" reference slices
of that same buffer (indirect packet buffers) — data is written once by the
storage device and never copied again on its way to the wire.  A
``zero_copy=False`` mode performs the straw-man's two copies so the benefit
is measurable (Fig 23).
"""

from __future__ import annotations

import struct
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from repro_torch.core.cache_table import CacheTable
from repro_torch.core.file_service import SegmentFS
from repro_torch.core.traffic import FiveTuple, Packet, TrafficDirector
from repro_torch.core import wire

MTU = 1500
PKT_HEADROOM = 64  # L2-L4 placeholder space per packet buffer


@dataclass(slots=True)
class ReadOp:
    file_id: int
    offset: int
    size: int


@dataclass(slots=True)
class WriteOp:
    file_id: int
    offset: int
    data: bytes


@dataclass
class OffloadAPI:
    """The user-supplied customization (Table 1).  Nullable per the paper.

    ``response_header`` frames offloaded read responses for the application's
    wire protocol; ``host_handler`` lets the host application interpret
    non-default message types (integration hook, cf. §9's "hundreds of lines
    of code" adoption).  It returns one of:
      ('r', req_id, file_id, offset, nbytes)   -- host file read, then respond
      ('w', req_id, file_id, offset, data[, resp_body])
                                               -- host file write, then ack;
                                                  the optional 6th element is
                                                  the ack's response body
                                                  (e.g. a KV PUT returning
                                                  the record location, §9.2)
      ('resp', req_id, status, body)           -- immediate response
    """
    off_pred: Callable[[bytes, CacheTable | None], tuple[list[bytes], list[bytes]]]
    off_func: Callable[[bytes, CacheTable | None], ReadOp | None]
    cache: Callable[[WriteOp], list[tuple[object, object]]] | None = None
    invalidate: Callable[[ReadOp], list[object]] | None = None
    response_header: Callable[[bytes, "ReadOp", int], bytes] | None = None
    host_handler: Callable[[bytes], tuple] | None = None
    # Optional fused fast path: one call returning (ReadOp, ok_header) — or
    # None to fall back to the host — so the engine parses each request
    # header once instead of twice (OffFunc + response_header both unpack).
    prepare_read: Callable[[bytes, CacheTable | None],
                           tuple["ReadOp", bytes] | None] | None = None
    # Optional BURST form of ``prepare_read``: one call for the whole pull
    # returning one ``(ReadOp, ok_header) | None`` per request, so an app
    # can resolve every request of the burst with a single vectorized
    # cache-table probe (``lookup_many``) instead of a scalar lookup per
    # request.  Must be side-effect free: the engine may still bounce
    # individual prepared requests (ring full, read/write fence).
    prepare_read_many: Callable[[list, CacheTable | None], list] | None = None
    # Lifecycle classifier: the message TYPE BYTES that mean "read", used
    # by the server's LifecycleTracker to split host-path completion-tick
    # histograms into host-read vs write classes (a set probe per message,
    # not a call).  None => the server's default ({APP_READ}).
    read_types: frozenset | None = None
    # Request-id extractor for messages shed BEFORE any execution path
    # parses them (token-bucket admission at the director): msg -> req_id.
    # None => the server's default (u64 at byte offset 1, which both the
    # §8.1 app protocol and the KV protocol satisfy).
    req_id_of: Callable[[bytes], int] | None = None


SLAB_MIN_SHIFT = 6  # smallest size class: 64 B (one cache line)


class SlabPool:
    """Pool of DMA-accessible huge pages with a size-classed slab allocator.

    ``allocate`` returns ``(offset, memoryview)`` carved out of one large
    pinned region; the view is handed to the storage driver as the I/O
    destination and later referenced (not copied) by packet buffers.

    Requests are rounded up to power-of-two size classes (64 B minimum).
    Each class keeps a LIFO stack of freed offsets, so allocate and release
    are O(1): pop the class stack, else bump-allocate fresh space, else —
    only when both fail — fall back over the (constantly many, <= log2 size)
    larger classes.  A live-allocation map records each block's actual class,
    so a block borrowed from a larger class is returned to it intact and an
    allocate/release sequence can never corrupt a neighboring allocation.
    Replaces the old first-fit free list whose release path re-sorted and
    coalesced the whole list on EVERY call.
    """

    def __init__(self, size: int = 1 << 24):
        self.size = size
        self.buf = np.zeros(size, dtype=np.uint8)
        self._mv = memoryview(self.buf)
        self._nclasses = max((size - 1).bit_length() - SLAB_MIN_SHIFT + 1, 1)
        self._free: list[list[int]] = [[] for _ in range(self._nclasses)]
        self._live: dict[int, tuple[int, int]] = {}  # off -> (class, req n)
        self._bump = 0          # end of the slab-committed prefix
        self._lock = threading.Lock()
        self.allocs = 0
        self.failed = 0
        self._live_committed = 0  # class-rounded bytes of live blocks
        self._live_requested = 0  # caller-requested bytes of live blocks

    @staticmethod
    def class_for(n: int) -> int:
        """Index of the smallest size class holding ``n`` bytes."""
        return max((n - 1).bit_length() - SLAB_MIN_SHIFT, 0)

    @staticmethod
    def class_size(cls: int) -> int:
        return 1 << (SLAB_MIN_SHIFT + cls)

    def allocate(self, n: int) -> tuple[int, memoryview] | None:
        if n <= 0 or n > self.size:
            with self._lock:
                self.failed += 1
            return None
        cls = (n - 1).bit_length() - SLAB_MIN_SHIFT  # class_for(n), inlined
        if cls < 0:
            cls = 0
        cs = 1 << (SLAB_MIN_SHIFT + cls)
        with self._lock:
            free = self._free[cls]
            if free:
                off = free.pop()
            elif self._bump + cs <= self.size:
                off = self._bump
                self._bump += cs
            else:
                # Exhausted: borrow from a larger class (bounded scan over
                # at most log2(size) classes; blocks are NOT split, the map
                # below returns them to their true class on release).
                for c2 in range(cls + 1, self._nclasses):
                    if self._free[c2]:
                        off = self._free[c2].pop()
                        cls = c2
                        cs = 1 << (SLAB_MIN_SHIFT + c2)
                        break
                else:
                    if not self._live and cs <= self.size:
                        # Pool is COMPLETELY free but carved into smaller
                        # classes: reset the slab map (O(#classes)) so any
                        # class is satisfiable again.  Blocks are never
                        # split, so without this a small-read phase would
                        # permanently starve later large reads.
                        for fl in self._free:
                            fl.clear()
                        self._bump = 0
                        off = 0
                        self._bump = cs
                    else:
                        self.failed += 1
                        return None
            self._live[off] = (cls, n)
            self._live_committed += cs
            self._live_requested += n
            self.allocs += 1
            return off, self._mv[off : off + n]

    def allocate_many(self, count: int, n: int) -> list[tuple[int, memoryview]]:
        """Burst-allocate up to ``count`` blocks of ``n`` bytes: ONE lock round.

        Returns as many blocks as the freelist/bump region could satisfy
        without borrowing (possibly fewer than ``count``, possibly empty);
        callers fall back to per-item ``allocate`` — which may borrow from
        larger classes — for the remainder, so exhaustion behaviour is
        unchanged from the scalar path.
        """
        if count <= 0 or n <= 0 or n > self.size:
            return []
        cls = (n - 1).bit_length() - SLAB_MIN_SHIFT
        if cls < 0:
            cls = 0
        cs = 1 << (SLAB_MIN_SHIFT + cls)
        mv = self._mv
        entry = (cls, n)
        with self._lock:
            free = self._free[cls]
            take = min(count, len(free))
            if take:
                offs = free[len(free) - take:]
                del free[len(free) - take:]
            else:
                offs = []
            rem = count - take
            if rem:
                base = self._bump
                carve = min(rem, (self.size - base) // cs)
                if carve > 0:
                    offs.extend(range(base, base + carve * cs, cs))
                    self._bump = base + carve * cs
            live = self._live
            for off in offs:
                live[off] = entry
            got = len(offs)
            self._live_committed += cs * got
            self._live_requested += n * got
            self.allocs += got
        return [(off, mv[off : off + n]) for off in offs]

    def release(self, off: int, n: int) -> None:
        with self._lock:
            self._release_locked(off)

    def release_many(self, offs: list[int]) -> None:
        """Return a burst of blocks under ONE lock round (TX-batch reclaim)."""
        committed = requested = 0
        with self._lock:
            live = self._live
            free = self._free
            for off in offs:
                entry = live.pop(off, None)
                if entry is None:
                    raise ValueError(f"release of unallocated offset {off}")
                cls, req = entry
                free[cls].append(off)
                committed += 1 << (SLAB_MIN_SHIFT + cls)
                requested += req
            self._live_committed -= committed
            self._live_requested -= requested

    def _release_locked(self, off: int) -> None:
        entry = self._live.pop(off, None)
        if entry is None:
            raise ValueError(f"release of unallocated offset {off}")
        cls, req = entry
        self._free[cls].append(off)
        self._live_committed -= 1 << (SLAB_MIN_SHIFT + cls)
        self._live_requested -= req

    def in_use(self) -> int:
        with self._lock:
            return self._live_committed

    def occupancy(self) -> dict:
        """Fragmentation + per-class occupancy snapshot (observability)."""
        with self._lock:
            classes = {
                self.class_size(c): {"live": 0, "free": len(self._free[c])}
                for c in range(self._nclasses)
                if self._free[c]
            }
            for cls, _req in self._live.values():
                ent = classes.setdefault(self.class_size(cls),
                                         {"live": 0, "free": 0})
                ent["live"] += 1
            return {
                "classes": classes,
                "live_bytes": self._live_requested,
                "committed_bytes": self._live_committed,
                "internal_frag_bytes": (self._live_committed
                                        - self._live_requested),
                "bump_remaining": self.size - self._bump,
            }


# Backwards-compatible alias: the pool kept its public contract
# (``allocate -> (off, memoryview) | None``, ``release``, ``in_use``).
MemPool = SlabPool


PENDING = 0
COMPLETE = 1
FAILED = 2


@dataclass(slots=True)
class _Context:
    """One slot of the context ring (§6.2)."""
    client: FiveTuple | None = None
    read_op: ReadOp | None = None
    raw: bytes = b""         # the request message (error responses need it)
    status: int = COMPLETE   # empty slots look complete & consumed
    pool_off: int = 0
    pool_len: int = 0
    buf: memoryview | None = None
    app_hdr: bytes = b""
    consumed: bool = True
    open_tick: int = 0       # ingress tick (lifecycle stamp; plain int)

    def mark(self, err: int) -> None:
        """Device-completion callback (bound method: no per-op closure)."""
        self.status = COMPLETE if err == wire.E_OK else FAILED


@dataclass
class OffloadStats:
    offloaded: int = 0
    bounced_to_host: int = 0   # context ring full -> host path (Fig 13 l.5-7)
    completed: int = 0
    failed: int = 0
    packets: int = 0
    data_copies: int = 0       # nonzero only with zero_copy=False
    bytes_served: int = 0


class OffloadEngine:
    """Executes offloaded reads with the context ring + zero-copy pool."""

    def __init__(self, fs: SegmentFS, director: TrafficDirector,
                 api: OffloadAPI, cache_table: CacheTable | None = None,
                 ring_size: int = 256, pool_size: int = 1 << 24,
                 zero_copy: bool = True,
                 app_header: Callable[[bytes, ReadOp, int], bytes] | None = None,
                 mtu: int = MTU):
        self.fs = fs
        self.director = director
        self.api = api
        self.cache_table = cache_table
        self.ring_size = ring_size
        self.pool = SlabPool(pool_size)
        self.zero_copy = zero_copy
        self.app_header = app_header or (lambda req, op, err: b"")
        self.mtu = mtu
        self._ring = [_Context() for _ in range(ring_size)]
        self._head = 0
        self._tail = 0
        self.failed = False   # DPU failure injected: see ``fail()``
        self.stats = OffloadStats()
        # Request-lifecycle stamping, installed by the owning server.
        self.lifecycle = None
        # Optional read/write fence (ServerConfig.read_write_fence): a live
        # view of the file service's in-flight-write counts.  An offloaded
        # read of a file whose writes are still in the FILE-SERVICE
        # pipeline (held in a coalescing run, ring-queued, or at the
        # device) is bounced to the host, where the submission FIFO orders
        # it AFTER those writes.  The fence starts where the file service
        # accepts a write — a read demuxed in the same pump step as its
        # write (still on the host wire) is NOT fenced, exactly the window
        # the pre-overhaul FIFO device never ordered either; acked writes
        # are always visible regardless (acks follow device completion).
        self.busy_files: dict | None = None

    def fail(self) -> None:
        """Deterministic DPU failure: graceful degradation to the host path.

        Three things happen, none of which loses a request: (1) the
        director re-routes every future predicate-positive read straight
        to the host (``dpu_bypass`` — the PEP, admission and epoch fence
        stay in force, only the offload split is disabled); (2) requests
        already queued for the engine but not yet pulled bounce to the
        host now; (3) in-flight ring contexts complete normally — the
        device and pool are host-side resources the "DPU crash" does not
        take down, so their responses drain through ``complete_pending``.
        The server keeps serving at host-path throughput/latency
        (``DirectorStats.dpu_bypassed`` counts the degraded requests)."""
        if self.failed:
            return
        self.failed = True
        self.director.dpu_bypass = True
        queue = self.director.offload_queue
        while queue:
            for client, raw in queue.take(64):
                self._bounce_to_host(client, raw)

    def in_flight(self) -> bool:
        """True while context-ring slots await completion or consumption.

        A scheduler wakeup source: the owning server must stay runnable
        until every outstanding offloaded read has been completed AND its
        response packets pushed to the wire (``complete_pending``).
        """
        return self._head != self._tail

    # -- Fig 13 main loop --------------------------------------------------------------
    def step(self, max_requests: int = 64) -> int:
        """Pull requests from the traffic director and execute them.

        ``complete_pending`` runs once per batch (and again when the context
        ring fills up, to reclaim consumed slots before bouncing), not once
        per request — completions only materialize when the device polls.
        """
        work = 0
        queue = self.director.offload_queue
        if self.failed:
            # Degraded mode: anything that slipped into the queue after
            # ``fail()`` bounces to the host; in-flight contexts drain.
            n = 0
            while queue:
                for client, raw in queue.take(max_requests):
                    self._bounce_to_host(client, raw)
                    n += 1
            if self._head == self._tail:
                return n
            self.fs.device.poll()
            return n + self.complete_pending()
        if not queue:
            if self._head == self._tail:
                return 0  # nothing offloaded, nothing in flight
            self.fs.device.poll()
            return self.complete_pending()
        # Weighted-fair pull: the director's queue is demuxed per tenant,
        # so a flooding tenant's backlog yields this burst's slots to every
        # backlogged tenant in weight proportion (single-tenant: plain FIFO).
        reqs = queue.take(max_requests)
        # Hot loop: hoist per-request attribute lookups out of the loop and
        # fold per-request stats into ONE update after the batch.
        off_func = self.api.off_func
        prepare = self.api.prepare_read
        table = self.cache_table
        # Burst prepare: ONE call (and one vectorized cache-table probe)
        # resolves the whole pull; the loop below only consumes results.
        prepare_many = self.api.prepare_read_many
        prepped_list = None
        if prepare_many is not None and len(reqs) > 1:
            prepped_list = prepare_many([r for _, r in reqs], table)
        allocate = self.pool.allocate
        # Uniform-size burst alloc: when the whole pull wants one block size
        # (the storm shape), ONE pool lock round reserves every buffer; any
        # reserved-but-unused blocks (bounced requests) are released in one
        # round at the end.  Non-uniform pulls keep the per-item path.
        blocks: list[tuple[int, memoryview]] = []
        blk_n = 0
        if prepped_list is not None:
            sizes = {PKT_HEADROOM + p[0].size
                     for p in prepped_list if p is not None}
            if len(sizes) == 1:
                blk_n = sizes.pop()
                blocks = self.pool.allocate_many(
                    sum(p is not None for p in prepped_list), blk_n)
        app_header = self.app_header
        submit_read = self.fs.submit_read
        # Zero-copy submissions are DEFERRED and flushed as one
        # ``fs.submit_read_many`` burst — always before any device poll, so
        # queue order and completion order match the scalar submission loop.
        submit_read_many = self.fs.submit_read_many
        deferred: list = []
        ring, ring_size = self._ring, self.ring_size
        zero_copy = self.zero_copy
        lifecycle = self.lifecycle
        # One clock read covers the whole burst: the clock only ticks at
        # scheduling-step boundaries, never inside a step.
        now_tick = lifecycle.clock.now if lifecycle is not None else 0
        busy_files = self.busy_files
        tail = self._tail
        head = self._head
        for i, (client, raw) in enumerate(reqs):
            if tail - head >= ring_size:
                self._tail = tail
                if deferred:   # flush so in-flight reads can complete below
                    submit_read_many(deferred, priority=True)
                    deferred = []
                self.fs.device.poll()
                self.complete_pending()  # reclaim consumed contexts first
                head = self._head
                if tail - head >= ring_size:
                    # Ring fully occupied: send this and the REST to the host.
                    for c2, r2 in reqs[i:]:
                        self._bounce_to_host(c2, r2)
                    break
            if prepped_list is not None:
                prepped = prepped_list[i]
                if prepped is None:
                    self._bounce_to_host(client, raw)
                    continue
                read_op, ok_hdr = prepped
            elif prepare is not None:
                # fused path: ONE header parse yields the op and its header
                prepped = prepare(raw, table)
                if prepped is None:
                    self._bounce_to_host(client, raw)
                    continue
                read_op, ok_hdr = prepped
            else:
                read_op = off_func(raw, table)
                if read_op is None:
                    self._bounce_to_host(client, raw)
                    continue
                ok_hdr = None
            fid = read_op.file_id
            size = read_op.size
            if busy_files is not None and fid in busy_files:
                # Read/write fence: writes to this file are still in flight
                # on the host path — serve the read there too, so the file
                # service's submission FIFO orders it after them.
                self._bounce_to_host(client, raw)
                continue
            want = PKT_HEADROOM + size
            alloc = (blocks.pop() if blocks and want == blk_n
                     else allocate(want))
            if alloc is None:
                self._bounce_to_host(client, raw)
                continue
            off, view = alloc
            ctx = ring[tail % ring_size]
            ctx.client = client
            ctx.read_op = read_op
            ctx.raw = raw
            ctx.status = PENDING
            ctx.pool_off, ctx.pool_len = off, want
            ctx.buf = view
            ctx.app_hdr = (ok_hdr if ok_hdr is not None
                           else app_header(raw, read_op, wire.E_OK))
            ctx.consumed = False
            ctx.open_tick = now_tick
            tail += 1
            # Destination = pool memory; the device writes it exactly once.
            # Offloaded reads ride the device's PRIORITY queue: the
            # latency-critical path never waits behind host-path write runs
            # (the normal queue keeps a bounded interleave share).
            dest = view[PKT_HEADROOM:want]
            if not zero_copy:
                scratch = bytearray(size)

                def done(err: int, ctx=ctx, scratch=scratch):
                    if err == wire.E_OK:
                        ctx.buf[PKT_HEADROOM : PKT_HEADROOM + ctx.read_op.size] = scratch
                        self.stats.data_copies += 1
                    ctx.status = COMPLETE if err == wire.E_OK else FAILED

                self.fs.submit_read(read_op.file_id, read_op.offset,
                                    read_op.size, memoryview(scratch), done,
                                    priority=True)
            else:
                deferred.append((fid, read_op.offset, size, dest, ctx.mark))
            work += 1
        self._tail = tail
        if deferred:
            submit_read_many(deferred, priority=True)
        if blocks:   # reserved for requests that bounced instead
            self.pool.release_many([off for off, _ in blocks])
        self.stats.offloaded += work
        self.fs.device.poll()
        return work + self.complete_pending()

    def _bounce_to_host(self, client: FiveTuple, raw: bytes) -> None:
        # The bounced read re-enters the host path, where the host app's
        # in-flight meta stamps it — it finishes in the host_read class.
        conn = self.director._conn(client)
        self.director._send_to_host(conn, client, raw)
        self.stats.bounced_to_host += 1

    # -- ordered completion (Fig 13 CompletePending) --------------------------------
    def complete_pending(self) -> int:
        """Consume the completed prefix; responses leave in request order.

        Back-to-back completions for the SAME client are coalesced into one
        ``dpu_response`` burst (one sequence-stamp pass + one wire lock
        round per run of contexts instead of per response).
        """
        done = 0
        head, tail = self._head, self._tail
        if head == tail:
            return 0
        ring, ring_size = self._ring, self.ring_size
        stats = self.stats
        pool = self.pool
        lifecycle = self.lifecycle
        if lifecycle is not None:
            dpu_hist_add = lifecycle.hist["dpu_read"].add
            dpu_hist_bulk = lifecycle.hist["dpu_read"].add_many
            tenant_add = lifecycle.add_tenant
            now_tick = lifecycle.clock.now
        run_delta = run_n = 0  # run-length fold for untenanted completions
        completed = failed = bytes_served = pkt_count = 0
        burst_client = None
        burst: list[Packet] = []
        burst_n = 0
        dpu_response = self.director.dpu_response
        mtu = self.mtu
        burst_append = burst.append
        while head != tail:
            ctx = ring[head % ring_size]
            status = ctx.status
            if status == PENDING:
                break  # preserve response order
            if not ctx.consumed:
                client = ctx.client
                size = ctx.read_op.size
                if lifecycle is not None:
                    # Response-publish tick for this offloaded read.  Whole
                    # bursts share one publish tick and (usually) one open
                    # tick, so equal deltas are folded and counted once.
                    delta = now_tick - ctx.open_tick
                    t = client.tenant
                    if t:
                        dpu_hist_add(delta)
                        tenant_add(t, "dpu_read", delta)
                    elif delta == run_delta and run_n:
                        run_n += 1
                    else:
                        if run_n:
                            dpu_hist_bulk(run_delta, run_n)
                        run_delta, run_n = delta, 1
                if (status == COMPLETE
                        and (h := len(ctx.app_hdr)) + size <= mtu):
                    # Inlined ``_create_pkts`` common case — one indirect
                    # packet, header placed in the buffer headroom.
                    buf = ctx.buf
                    buf[PKT_HEADROOM - h:PKT_HEADROOM] = ctx.app_hdr
                    pkt = Packet(client, 0,
                                 buf[PKT_HEADROOM - h:PKT_HEADROOM + size])
                    pkt_count += 1
                    # Ownership rides on the (single) packet and is
                    # released at TX-consumption (Fig 12) — releasing here
                    # would let a later read overwrite a response the
                    # client has not drained yet.
                    pkt.pool_ref = (pool, ctx.pool_off, ctx.pool_len)
                    completed += 1
                    bytes_served += size
                    if client is burst_client:
                        burst_append(pkt)
                        burst_n += 1
                    else:
                        if burst:
                            dpu_response(burst_client, burst, burst_n)
                        burst_client, burst, burst_n = client, [pkt], 1
                        burst_append = burst.append
                else:
                    pkts = self._create_pkts(ctx)
                    if status == COMPLETE:
                        # Indirect packets reference pool memory: ownership
                        # rides on the last packet (Fig 12), as above.
                        pkts[-1].pool_ref = (pool, ctx.pool_off, ctx.pool_len)
                        completed += 1
                        bytes_served += size
                    else:
                        # Error responses carry only header bytes — the pool
                        # block is unreferenced and can be reclaimed now.
                        pool.release(ctx.pool_off, ctx.pool_len)
                        failed += 1
                    if client is burst_client:
                        burst.extend(pkts)
                        burst_n += 1
                    else:
                        if burst:
                            dpu_response(burst_client, burst, burst_n)
                        burst_client, burst, burst_n = client, pkts, 1
                        burst_append = burst.append
                ctx.consumed = True
                ctx.buf = None
                ctx.raw = b""
            head += 1
            done += 1
        self._head = head
        if run_n:
            dpu_hist_bulk(run_delta, run_n)
        if burst:
            dpu_response(burst_client, burst, burst_n)
        stats.completed += completed
        stats.failed += failed
        stats.bytes_served += bytes_served
        stats.packets += pkt_count
        return done

    def _create_pkts(self, ctx: _Context) -> list[Packet]:
        """Indirect packet buffers: header bytes + *references* into the pool.

        Data > MTU is segmented into multiple packets whose payloads are
        slices of the read buffer — no copy (Fig 12 step 3).
        """
        hdr = ctx.app_hdr
        if ctx.status != COMPLETE:
            # Frame the error from the ORIGINAL request so it carries the
            # real request id — a b"" fallback would answer req_id 0 and the
            # caller's wait() would never resolve.
            hdr = self.app_header(ctx.raw, ctx.read_op, wire.E_IO)
            pkt = Packet(ctx.client, 0, hdr)
            self.stats.packets += 1
            return [pkt]
        total = ctx.read_op.size
        # First packet carries the app header; place it in the buffer headroom
        # immediately before the data so header+data are one contiguous slice.
        h = len(hdr)
        assert h <= PKT_HEADROOM
        ctx.buf[PKT_HEADROOM - h : PKT_HEADROOM] = hdr
        if h + total <= self.mtu:  # common case: one indirect packet
            self.stats.packets += 1
            return [Packet(ctx.client, 0,
                           ctx.buf[PKT_HEADROOM - h : PKT_HEADROOM + total])]
        data = ctx.buf[PKT_HEADROOM : PKT_HEADROOM + total]
        pkts: list[Packet] = []
        first_len = min(self.mtu, h + total)
        pkts.append(Packet(ctx.client, 0,
                           ctx.buf[PKT_HEADROOM - h : PKT_HEADROOM - h + first_len]))
        sent = first_len - h
        while sent < total:
            n = min(self.mtu, total - sent)
            pkts.append(Packet(ctx.client, 0, data[sent : sent + n]))
            sent += n
        self.stats.packets += len(pkts)
        return pkts

    # -- cache-table maintenance (wired into the file service, §6.1/Table 2) -------
    def on_host_write(self, op: WriteOp) -> None:
        if self.api.cache and self.cache_table is not None:
            for key, item in self.api.cache(op):
                if item is None:
                    # Tombstone: the app logged a delete marker — drop the
                    # mapping instead of upserting it.
                    self.cache_table.delete(key)
                else:
                    self.cache_table.insert(key, item)

    def on_host_read(self, op: ReadOp) -> None:
        if self.api.invalidate and self.cache_table is not None:
            for key in self.api.invalidate(op):
                self.cache_table.delete(key)
