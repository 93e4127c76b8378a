"""Progressive lock-free DMA ring buffers (DDS §4.1, Figures 7-8).

Implements the paper's host<->DPU message rings:

  * ``ProgressiveRing``  — the DDS proposal.  A multi-producer single-consumer
    (request) / single-producer multi-consumer (response) byte ring with THREE
    pointers: ``head``, ``tail`` and the new ``progress`` pointer.  Producers
    atomically fetch-add the tail to reserve space, copy their message, then
    fetch-add progress to publish completion.  The consumer reads the whole
    ``[head, tail)`` range in ONE batch when ``progress == tail`` (Fig 8b) —
    the natural batching effect of §4.1.

  * ``LockRing``         — baseline (b) of Fig 17: the pointer update AND the
    message copy happen under a single lock.

  * ``FaRMStyleRing``    — baseline (a) of Fig 17: FaRM-style slot ring where
    each message carries a completion flag; the consumer polls each slot with
    a DMA read and releases it with a DMA write.  No batching.

Memory layout follows Fig 7 (right): a pointer area of cache-line-aligned
slots, physically ordered ``progress`` BEFORE ``tail`` so the consumer's
condition check (Fig 8b lines 1-2, highlighted) costs a SINGLE DMA read, and
a data area where messages are inserted.

Hardware adaptation (see DESIGN.md §2): host memory and DPU memory are two
NumPy regions; every cross-region access goes through :class:`DMAEngine`,
which counts operations and bytes and can model PCIe latency.  CPython has no
user-level CAS, so the two atomic fetch-adds are emulated with a micro
critical section *around the pointer arithmetic only* — the data path (the
``memcpy`` of the message, the batch read) never holds a lock, which is the
property the paper's design buys.
"""

from __future__ import annotations

import struct
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import vector
from repro_torch.core.lifecycle import TickHistogram

CACHE_LINE = 64

# Pointer-area offsets (Fig 7 right: progress precedes tail; head after).
OFF_PROG = 0 * CACHE_LINE
OFF_TAIL = 1 * CACHE_LINE
OFF_HEAD = 2 * CACHE_LINE
POINTER_AREA = 3 * CACHE_LINE


class Region:
    """A named flat memory region (host DRAM or DPU DDR)."""

    __slots__ = ("name", "buf", "_u64", "_mv")

    def __init__(self, name: str, size: int):
        self.name = name
        self.buf = np.zeros(size, dtype=np.uint8)
        # Cached u64 view of the buffer: pointer slots are cache-line
        # aligned, so u64 loads/stores index this view directly instead of
        # re-slicing + re-viewing on every access (the rings poll pointers
        # on every step).
        self._u64 = self.buf.view(np.uint64) if size % 8 == 0 else None
        # Cached byte view: memoryview slice-assignment copies straight
        # from any bytes-like source at C speed — no numpy ufunc dispatch
        # per (typically tiny) message copy.
        self._mv = memoryview(self.buf)

    def __len__(self) -> int:
        return len(self.buf)

    # Local (same-side) accessors -------------------------------------------------
    def load_u64(self, off: int) -> int:
        # fast path only for the aligned pointer slots; unaligned offsets
        # fall through rather than silently truncating off >> 3
        if self._u64 is not None and not off & 7:
            return int(self._u64[off >> 3])
        return int(self.buf[off : off + 8].view(np.uint64)[0])

    def store_u64(self, off: int, val: int) -> None:
        if self._u64 is not None and not off & 7:
            self._u64[off >> 3] = val
        else:
            self.buf[off : off + 8].view(np.uint64)[0] = np.uint64(val)

    def write(self, off: int, data) -> None:
        # Zero-copy staging: bytes, bytearray and (contiguous) memoryview
        # sources all copy straight into the backing buffer — no
        # intermediate bytes() materialization, no numpy dispatch.
        n = len(data)
        if n:
            self._mv[off : off + n] = data

    def read(self, off: int, n: int) -> bytes:
        return self.buf[off : off + n].tobytes()


@dataclass
class DMAStats:
    reads: int = 0
    writes: int = 0
    read_bytes: int = 0
    write_bytes: int = 0
    modeled_time_s: float = 0.0

    def snapshot(self) -> "DMAStats":
        return DMAStats(self.reads, self.writes, self.read_bytes,
                        self.write_bytes, self.modeled_time_s)

    def delta(self, before: "DMAStats") -> "DMAStats":
        return DMAStats(
            self.reads - before.reads,
            self.writes - before.writes,
            self.read_bytes - before.read_bytes,
            self.write_bytes - before.write_bytes,
            self.modeled_time_s - before.modeled_time_s,
        )


class DMAEngine:
    """DPU-issued DMA between host and DPU regions (BF-2 PCIe Gen4 model).

    Counts every transaction.  ``latency_s`` + ``bytes/bandwidth`` accumulate
    into modeled time (used by the calibrated benchmarks; never sleeps).
    """

    def __init__(self, latency_s: float = 1.5e-6, bandwidth_Bps: float = 24e9):
        self.latency_s = latency_s
        self.bandwidth_Bps = bandwidth_Bps
        self.stats = DMAStats()
        self._lock = threading.Lock()

    def _account(self, is_read: bool, nbytes: int) -> None:
        with self._lock:
            s = self.stats
            if is_read:
                s.reads += 1
                s.read_bytes += nbytes
            else:
                s.writes += 1
                s.write_bytes += nbytes
            s.modeled_time_s += self.latency_s + nbytes / self.bandwidth_Bps

    def read(self, src: Region, off: int, n: int) -> bytes:
        """DMA-read ``n`` bytes from a (host) region into the caller (DPU)."""
        self._account(True, n)
        return src.read(off, n)

    def write(self, dst: Region, off: int, data) -> None:
        """DMA-write bytes from the caller (DPU) into a (host) region."""
        self._account(False, len(data))
        dst.write(off, data)

    def read_u64_pair(self, src: Region, off: int) -> tuple[int, int]:
        """One DMA read covering two adjacent cache lines (P then T, Fig 7)."""
        raw = self.read(src, off, 2 * CACHE_LINE)
        a = struct.unpack_from("<Q", raw, 0)[0]
        b = struct.unpack_from("<Q", raw, CACHE_LINE)[0]
        return a, b

    def write_gather(self, dst: Region, items) -> None:
        """ONE accounted DMA transaction scattering ``(off, data)`` pairs.

        Models an SGL descriptor: the DPU posts a single DMA covering every
        element of a response burst, paying one PCIe transaction latency
        for the whole scatter list instead of one per message.
        """
        total = 0
        for _, d in items:
            total += len(d)
        self._account(False, total)
        for off, d in items:
            dst.write(off, d)

    def read_u64(self, src: Region, off: int) -> int:
        return struct.unpack("<Q", self.read(src, off, 8))[0]

    def write_u64(self, dst: Region, off: int, val: int) -> None:
        self.write(dst, off, struct.pack("<Q", val))


class _Atomics:
    """Micro critical sections emulating the CAS / fetch-add instructions.

    Only the pointer arithmetic runs under the lock (a handful of ns in HW);
    message copies happen outside.  See DESIGN.md §2 (CPython adaptation).
    ``ops`` counts atomic instructions for the contention model in
    benchmarks/fig17 (each would serialize for ~100 ns on real hardware).
    """

    def __init__(self, region: Region):
        self._region = region
        self._lock = threading.Lock()
        self.ops = 0

    def load(self, off: int) -> int:
        return self._region.load_u64(off)

    def store(self, off: int, val: int) -> None:
        with self._lock:
            self._region.store_u64(off, val)

    def fetch_add(self, off: int, inc: int) -> int:
        with self._lock:
            self.ops += 1
            old = self._region.load_u64(off)
            self._region.store_u64(off, old + inc)
            return old

    def compare_and_swap(self, off: int, expect: int, new: int) -> bool:
        with self._lock:
            self.ops += 1
            if self._region.load_u64(off) != expect:
                return False
            self._region.store_u64(off, new)
            return True


RETRY = "RETRY"
OK = "OK"


class ProgressiveRing:
    """The DDS progressive MPSC ring (Fig 7/8) over a host-memory region.

    ``capacity`` is the data-area size in bytes (power of two).  ``max_progress``
    is the paper's hyper-parameter M: the maximum in-flight (unconsumed) bytes,
    which bounds the batch the consumer picks up in one DMA read.
    """

    def __init__(self, capacity: int = 1 << 16, max_progress: int | None = None,
                 host_region: Region | None = None, base: int = 0,
                 name: str = "req-ring"):
        assert capacity & (capacity - 1) == 0, "capacity must be a power of 2"
        self.capacity = capacity
        self.max_progress = max_progress if max_progress is not None else capacity // 2
        assert self.max_progress <= capacity
        self.name = name
        total = POINTER_AREA + capacity
        self.host = host_region if host_region is not None else Region(f"host:{name}", total)
        self.base = base  # byte offset of this ring inside the host region
        self._atom = _Atomics(self.host)
        self._data0 = base + POINTER_AREA
        # Pointers start at 0 (monotonically increasing virtual offsets).
        # Work-signaled scheduling hook: fired AFTER a progress publish (the
        # moment inserted messages become consumable), so a producer thread
        # inserting into the ring marks the consuming server runnable — the
        # host->DPU mirror of the paper's doorbell DMA write.
        self.doorbell = None
        # Request-lifecycle instrumentation (repro_torch.core.lifecycle): when a
        # TickClock is installed, every publish is stamped and the consumer
        # records publish->consume tick residency — the host-submit ->
        # DPU-fetch segment of the request lifecycle.  One deque entry per
        # PUBLISHED CHUNK (not per message), so the cost is amortized over
        # the batch exactly like the doorbell.
        self.clock = None
        self.residency = None            # TickHistogram, lazily created
        self._pub_ticks: deque = deque()  # (progress-after-publish, tick)

    # -- producer side (host threads), Fig 8a --------------------------------
    def _reserve(self, n: int) -> int | None:
        """CAS-reserve ``[tail, tail+n)``; returns the old tail or None."""
        tail = self._atom.load(self.base + OFF_TAIL)
        head = self._atom.load(self.base + OFF_HEAD)
        if tail - head + n > self.max_progress:
            return None  # insertions are outpacing consumption
        while True:
            if not self._atom.compare_and_swap(self.base + OFF_TAIL, tail, tail + n):
                tail = self._atom.load(self.base + OFF_TAIL)
                head = self._atom.load(self.base + OFF_HEAD)
                if tail - head + n > self.max_progress:
                    return None
                continue
            return tail

    def _publish(self, n: int) -> None:
        """Fetch-add the progress pointer (publish) + ring the doorbell.

        With a TickClock installed, the publish is also stamped so the
        consumer can record publish->consume residency ticks — one stamp
        per published chunk, amortized like the doorbell itself."""
        old = self._atom.fetch_add(self.base + OFF_PROG, n)
        clk = self.clock
        if clk is not None:
            self._pub_ticks.append((old + n, clk.now))
        db = self.doorbell
        if db is not None:
            db()

    def try_insert(self, msg: bytes) -> str:
        n = len(msg)
        assert 0 < n <= self.max_progress, "message exceeds max allowable progress"
        tail = self._reserve(n)
        if tail is None:
            return RETRY
        self._copy_in(tail, msg)                      # lock-free data path
        self._publish(n)                               # publish completion
        return OK

    def try_insert_v(self, parts) -> str:
        """Gathered insert: copy each part of ONE message straight into the
        ring data area (wrap-aware), with a single reservation and a single
        progress publish.  Producers build a message from (frame header,
        request header, payload view) without ever joining them into an
        intermediate buffer — the ring copy is the only copy the host pays
        (§4.2: write data is inlined into the request, Fig 9)."""
        n = 0
        for p in parts:
            n += len(p)
        assert 0 < n <= self.max_progress, "message exceeds max allowable progress"
        tail = self._reserve(n)
        if tail is None:
            return RETRY
        voff = tail
        for p in parts:
            self._copy_in(voff, p)
            voff += len(p)
        self._publish(n)                               # publish completion
        return OK

    def insert(self, msg: bytes, spin: int = 1_000_000) -> None:
        for _ in range(spin):
            if self.try_insert(msg) == OK:
                return
        raise TimeoutError(f"ring {self.name}: insert retry budget exhausted")

    def insert_v(self, parts, spin: int = 1_000_000) -> None:
        for _ in range(spin):
            if self.try_insert_v(parts) == OK:
                return
        raise TimeoutError(f"ring {self.name}: insert retry budget exhausted")

    def insert_burst(self, msgs: list, spin: int = 1_000_000,
                     on_retry=None) -> None:
        """Insert a burst of gathered messages with ONE reservation.

        ``msgs`` is a list of part-tuples (each a complete framed message).
        The tail CAS and the progress publish are paid once per contiguous
        chunk instead of once per message — the §4.1 batching effect applied
        to the producer side.  Bursts larger than ``max_progress`` fall back
        to chunking: each chunk is reserved and published atomically, so
        consumers always see whole messages and FIFO order is preserved.

        ``on_retry`` is invoked when a reservation fails (ring full) —
        co-resident callers pass the DPU service's ``step`` so the consumer
        actually drains between retries instead of a blind spin.
        """
        i = 0
        n_msgs = len(msgs)
        while i < n_msgs:
            total = 0
            j = i
            while j < n_msgs:
                sz = 0
                for p in msgs[j]:
                    sz += len(p)
                if total and total + sz > self.max_progress:
                    break
                total += sz
                j += 1
            assert total <= self.max_progress, \
                "single message exceeds max allowable progress"
            tail = None
            for _ in range(spin):
                tail = self._reserve(total)
                if tail is not None:
                    break
                if on_retry is not None:
                    on_retry()
            if tail is None:
                raise TimeoutError(
                    f"ring {self.name}: insert retry budget exhausted")
            voff = tail
            for k in range(i, j):
                for p in msgs[k]:
                    self._copy_in(voff, p)
                    voff += len(p)
            self._publish(total)  # one doorbell/stamp per chunk, like the CAS
            i = j

    def _copy_in(self, voff: int, msg: bytes) -> None:
        cap = self.capacity
        pos = voff % cap  # capacity is a power of two
        n = len(msg)
        first = min(n, cap - pos)
        self.host.write(self._data0 + pos, msg[:first])
        if first < n:  # wrap
            self.host.write(self._data0, msg[first:])

    # -- consumer side (DPU thread), Fig 8b ----------------------------------
    def consume(self, dma: DMAEngine) -> bytes | None:
        """One consumer step: returns a batch of raw bytes, or None (RETRY)."""
        # One DMA read covers progress AND tail (physical order P, T — Fig 7).
        prog, tail = dma.read_u64_pair(self.host, self.base + OFF_PROG)
        head = self._atom.load(self.base + OFF_HEAD)  # consumer-owned
        if prog != tail or tail == head:
            return None  # some producer mid-insert, or empty
        n = tail - head
        batch = self._dma_read_range(dma, head, n)
        # IncHead: publish consumption so producers see free space (DMA write).
        dma.write_u64(self.host, self.base + OFF_HEAD, tail)
        # keep the atomics view coherent for local producers
        self._atom.store(self.base + OFF_HEAD, tail)
        self._note_consumed(tail)
        return batch

    def consume_batch(self, dma: DMAEngine, max_rounds: int = 8) -> list[bytes]:
        """Burst consume: drain every available ``[head, tail)`` batch and
        publish ONE IncHead doorbell for the whole burst.

        Each round still pays the single progress/tail pair read (Fig 8b
        line 1 — that read is the poll), but the consumption publish — the
        DMA write producers wait on — is issued once per burst instead of
        once per batch, and the consumer-side head bookkeeping is local
        until then.  Returns the list of raw batches (possibly empty).
        """
        head = self._atom.load(self.base + OFF_HEAD)  # consumer-owned
        start = head
        batches: list[bytes] = []
        for _ in range(max_rounds):
            prog, tail = dma.read_u64_pair(self.host, self.base + OFF_PROG)
            if prog != tail or tail == head:
                break  # some producer mid-insert, or nothing new
            batches.append(self._dma_read_range(dma, head, tail - head))
            head = tail
        if head != start:
            # One doorbell covers every batch consumed this burst.
            dma.write_u64(self.host, self.base + OFF_HEAD, head)
            self._atom.store(self.base + OFF_HEAD, head)
            self._note_consumed(head)
        return batches

    def _note_consumed(self, head: int) -> None:
        """Record publish->consume residency for every chunk now consumed."""
        pt = self._pub_ticks
        if not pt:
            return
        clk = self.clock
        if clk is None:
            pt.clear()
            return
        res = self.residency
        if res is None:
            res = self.residency = TickHistogram()
        now = clk.now
        while pt and pt[0][0] <= head:
            res.add(now - pt.popleft()[1])

    def _dma_read_range(self, dma: DMAEngine, voff: int, n: int) -> bytes:
        cap = self.capacity
        pos = voff % cap
        first = min(n, cap - pos)
        out = dma.read(self.host, self._data0 + pos, first)
        if first < n:
            out += dma.read(self.host, self._data0, n - first)
        return out

    # -- introspection --------------------------------------------------------
    @property
    def head(self) -> int:
        return self._atom.load(self.base + OFF_HEAD)

    @property
    def tail(self) -> int:
        return self._atom.load(self.base + OFF_TAIL)

    @property
    def progress(self) -> int:
        return self._atom.load(self.base + OFF_PROG)


class ResponseRing:
    """SPMC mirror of :class:`ProgressiveRing` (DPU producer, host consumers).

    The DPU DMA-writes a batch of responses and then publishes the new tail
    with a second DMA write.  Host threads claim disjoint ranges by CAS on a
    claim pointer (HEAD) and publish completion on PROG so the producer can
    reclaim space — symmetric to the request ring.
    """

    def __init__(self, capacity: int = 1 << 16, host_region: Region | None = None,
                 base: int = 0, name: str = "resp-ring"):
        assert capacity & (capacity - 1) == 0
        self.capacity = capacity
        self.name = name
        total = POINTER_AREA + capacity
        self.host = host_region if host_region is not None else Region(f"host:{name}", total)
        self.base = base
        self._atom = _Atomics(self.host)
        self._data0 = base + POINTER_AREA

    # -- DPU producer ----------------------------------------------------------
    def free_space(self, dma: DMAEngine) -> int:
        prog = dma.read_u64(self.host, self.base + OFF_PROG)
        tail = self._atom.load(self.base + OFF_TAIL)
        return self.capacity - (tail - prog)

    def produce(self, dma: DMAEngine, batch: bytes) -> bool:
        n = len(batch)
        if n == 0:
            return True
        if self.free_space(dma) < n:
            return False
        tail = self._atom.load(self.base + OFF_TAIL)
        cap = self.capacity
        pos = tail % cap
        first = min(n, cap - pos)
        dma.write(self.host, self._data0 + pos, batch[:first])
        if first < n:
            dma.write(self.host, self._data0, batch[first:])
        dma.write_u64(self.host, self.base + OFF_TAIL, tail + n)
        self._atom.store(self.base + OFF_TAIL, tail + n)
        return True

    def publish_batch(self, dma: DMAEngine, parts, total: int | None = None) -> bool:
        """Deliver a burst of response fragments with ONE gathered DMA write
        and ONE tail doorbell.

        ``parts`` is a flat sequence of bytes-like fragments (frame headers
        interleaved with response-buffer memoryviews); nothing is joined or
        copied on the DPU side — each fragment lands straight in the host
        ring (the response DMA is the only copy).  All-or-nothing: returns
        False without side effects when the burst exceeds free space.
        """
        if total is None:
            total = 0
            for p in parts:
                total += len(p)
        if total == 0:
            return True
        if self.free_space(dma) < total:
            return False
        tail = self._atom.load(self.base + OFF_TAIL)
        cap = self.capacity
        data0 = self._data0
        items = []
        voff = tail
        for p in parts:
            n = len(p)
            pos = voff % cap
            first = min(n, cap - pos)
            if first == n:
                items.append((data0 + pos, p))
            else:  # fragment wraps the ring
                mv = p if isinstance(p, memoryview) else memoryview(p)
                items.append((data0 + pos, mv[:first]))
                items.append((data0, mv[first:]))
            voff += n
        dma.write_gather(self.host, items)   # one accounted DMA transaction
        dma.write_u64(self.host, self.base + OFF_TAIL, tail + total)  # doorbell
        self._atom.store(self.base + OFF_TAIL, tail + total)
        return True

    # -- host consumers ---------------------------------------------------------
    def try_claim(self, max_bytes: int | None = None) -> tuple[int, bytes] | None:
        """Claim and read the next unclaimed range; returns (claim_off, data)."""
        while True:
            head = self._atom.load(self.base + OFF_HEAD)
            tail = self._atom.load(self.base + OFF_TAIL)
            if head == tail:
                return None
            n = tail - head
            if max_bytes is not None:
                n = min(n, max_bytes)
            if self._atom.compare_and_swap(self.base + OFF_HEAD, head, head + n):
                data = self._local_read(head, n)
                self._atom.fetch_add(self.base + OFF_PROG, n)
                return head, data

    def _local_read(self, voff: int, n: int) -> bytes:
        cap = self.capacity
        pos = voff % cap
        first = min(n, cap - pos)
        out = self.host.read(self._data0 + pos, first)
        if first < n:
            out += self.host.read(self._data0, n - first)
        return out

    @property
    def tail(self) -> int:
        return self._atom.load(self.base + OFF_TAIL)


# ---------------------------------------------------------------------------
# Baselines for Fig 17.
# ---------------------------------------------------------------------------


class LockRing:
    """Baseline: a ring whose producers hold a lock across the whole insert.

    ``lock_held_s`` accumulates time inside the critical section — the
    serialization a real multi-core host pays (hidden by the GIL here).
    """

    def __init__(self, capacity: int = 1 << 16, name: str = "lock-ring"):
        assert capacity & (capacity - 1) == 0
        self.capacity = capacity
        self.name = name
        self.host = Region(f"host:{name}", POINTER_AREA + capacity)
        self._lock = threading.Lock()
        self._data0 = POINTER_AREA
        self.lock_held_s = 0.0

    def try_insert(self, msg: bytes) -> str:
        n = len(msg)
        with self._lock:  # pointer update AND memcpy under the lock
            t0 = time.perf_counter()
            tail = self.host.load_u64(OFF_TAIL)
            head = self.host.load_u64(OFF_HEAD)
            if tail - head + n > self.capacity:
                self.lock_held_s += time.perf_counter() - t0
                return RETRY
            cap = self.capacity
            pos = tail % cap
            first = min(n, cap - pos)
            self.host.write(self._data0 + pos, msg[:first])
            if first < n:
                self.host.write(self._data0, msg[first:])
            self.host.store_u64(OFF_TAIL, tail + n)
            self.lock_held_s += time.perf_counter() - t0
        return OK

    def consume(self, dma: DMAEngine) -> bytes | None:
        tail = dma.read_u64(self.host, OFF_TAIL)
        head = self.host.load_u64(OFF_HEAD)
        if tail == head:
            return None
        n = tail - head
        cap = self.capacity
        pos = head % cap
        first = min(n, cap - pos)
        out = dma.read(self.host, self._data0 + pos, first)
        if first < n:
            out += dma.read(self.host, self._data0, n - first)
        dma.write_u64(self.host, OFF_HEAD, tail)
        with self._lock:
            self.host.store_u64(OFF_HEAD, tail)
        return out


class FaRMStyleRing:
    """Baseline: FaRM-style slot ring [26].

    Fixed-size slots; the producer writes the message then sets a completion
    flag.  The consumer polls EACH slot's flag with a DMA read, DMA-reads the
    message, and DMA-writes to clear the flag ("release the space").  No
    batching, and polling via PCIe is expensive — the effects Fig 17 shows.
    """

    def __init__(self, slots: int = 1024, slot_size: int = 64,
                 name: str = "farm-ring"):
        self.slots = slots
        self.slot_size = slot_size  # includes 1 flag byte + 2 len bytes
        self.name = name
        self.host = Region(f"host:{name}", slots * slot_size)
        self._lock = threading.Lock()
        self._next = 0  # producer slot cursor
        self._cons = 0  # consumer slot cursor (DPU-local)

    def try_insert(self, msg: bytes) -> str:
        n = len(msg)
        assert n + 3 <= self.slot_size
        with self._lock:  # claim a slot
            slot = self._next
            off = (slot % self.slots) * self.slot_size
            if self.host.buf[off] != 0:  # slot not yet released by DPU
                return RETRY
            self._next += 1
        rec = struct.pack("<H", n) + bytes(msg)
        self.host.write(off + 1, rec)
        self.host.buf[off] = 1  # completion flag last
        return OK

    def consume_one(self, dma: DMAEngine) -> bytes | None:
        off = (self._cons % self.slots) * self.slot_size
        flag = dma.read(self.host, off, 1)  # poll via DMA
        if flag[0] == 0:
            return None
        raw = dma.read(self.host, off + 1, self.slot_size - 1)
        (n,) = struct.unpack_from("<H", raw, 0)
        msg = raw[2 : 2 + n]
        dma.write(self.host, off, b"\x00")  # release slot via DMA write
        self._cons += 1
        return msg


# ---------------------------------------------------------------------------
# Message framing shared by the storage path (Fig 9 encodings sit on top).
# ---------------------------------------------------------------------------

FRAME_HDR = struct.Struct("<I")  # total size of the framed message


def frame(msg: bytes) -> bytes:
    return FRAME_HDR.pack(len(msg)) + msg


def unframe_batch(batch) -> list[memoryview]:
    """Split a consumed batch back into individual framed messages.

    Zero-copy: returns ``memoryview`` slices over the batch buffer (a
    consumer's whole ``[head, tail)`` DMA read is split without duplicating
    any message bytes).  Views compare equal to ``bytes`` and unpack in
    place; callers that store or hash a message materialize it themselves.

    Large fixed-stride batches (the common shape: one op size repeated)
    are split columnar — :func:`repro_torch.core.vector.uniform_stride` proves
    the stream uniform in one array compare, so no per-frame header
    unpack runs; irregular batches (and any remainder) take the scalar
    walk, which is also cheaper for short batches.
    """
    mv = batch if isinstance(batch, memoryview) else memoryview(batch)
    out = []
    off = 0
    n = len(mv)
    hdr = FRAME_HDR.size
    if n >= 512:
        u = vector.uniform_stride(mv, hdr, 0, min_frames=20)
        if u is not None:
            cnt, stride, _ = u
            out = [mv[i * stride + hdr:(i + 1) * stride] for i in range(cnt)]
            off = cnt * stride
    unpack = FRAME_HDR.unpack_from
    while off < n:
        (sz,) = unpack(mv, off)
        off += hdr
        out.append(mv[off : off + sz])
        off += sz
    return out
