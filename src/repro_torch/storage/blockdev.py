"""NVMe SSD model: a block device with submission/completion queues.

The container has no NVMe device, so this is a RAM- (or file-) backed block
store with an SPDK-like asynchronous interface: ``submit_read`` /
``submit_write`` enqueue an operation; completions are delivered by
``poll()`` (SPDK-style polling) in submission order per queue.  A service
time model (base latency + bytes/bandwidth, bounded queue depth) accumulates
*modeled* device time for the calibrated benchmarks; nothing ever sleeps.

Zero-copy contract (DDS §4.3/§6.2): ``submit_read`` takes a destination
``memoryview`` and the device writes bytes straight into it — the caller
points it at pre-allocated response/packet space, so no intermediate copy is
ever made.  ``submit_write`` reads from the caller's buffer view directly.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from repro_torch.core.lifecycle import TickClock, TickHistogram
from repro_torch.core.vector import block_checksums

# v5-era datacenter NVMe-ish constants (§8.1: 1 TB NVMe SSD, 100-200us access).
DEFAULT_READ_LATENCY_S = 90e-6
DEFAULT_WRITE_LATENCY_S = 25e-6
DEFAULT_BANDWIDTH_BPS = 3.2e9
DEFAULT_QUEUE_DEPTH = 128

STATUS_PENDING = -1
STATUS_OK = 0
STATUS_EINVAL = 22
STATUS_EIO = 5

# Integrity-checksum granularity (see ``enable_checksums``): one 64-bit
# position-salted checksum (repro_torch.core.vector.block_checksums) per 4 KiB of
# media, the protection-information block size of real datacenter NVMe.
CRC_BLOCK = 4096


@dataclass(slots=True)
class IoOp:
    kind: str                      # "read" | "write" | "writev"
    lba: int                       # byte offset on device
    nbytes: int
    buf: memoryview | bytes | list | None   # writev: list of buffer views
    on_complete: Callable[[int], None] | None
    status: int = STATUS_PENDING
    modeled_done_s: float = 0.0
    cookie: int | None = None      # completion-queue tag (see ``reap``)
    submit_tick: int = 0           # logical submission time (TickClock)


@dataclass
class BlockDeviceStats:
    reads: int = 0
    writes: int = 0
    read_bytes: int = 0
    write_bytes: int = 0
    modeled_busy_s: float = 0.0
    max_queue_depth_seen: int = 0
    # Submit -> complete latency in TICKS of the owning scheduler's clock
    # (deterministic; see repro_torch.core.lifecycle).  Split by queue so the
    # priority path's isolation — and the normal path's bounded starvation —
    # are both directly observable.
    completion_ticks: TickHistogram = field(default_factory=TickHistogram)
    prio_completion_ticks: TickHistogram = field(default_factory=TickHistogram)
    # Reads failed with EIO because the media bytes no longer matched their
    # stored block checksum (only with ``enable_checksums()``).
    crc_read_failures: int = 0


class BlockDevice:
    """RAM-backed block device with an async queue interface.

    Two NVMe-style submission queues (each completed strictly in order):

      * the NORMAL queue — host-path reads/writes (the file service), and
      * the PRIORITY queue — latency-critical offloaded reads
        (``submit_read(priority=True)``), which ``poll`` serves FIRST.

    Starvation is bounded by ``prio_interleave``: when the normal queue is
    non-empty, at least ``budget // prio_interleave`` (>= 1) of each poll's
    completion budget is reserved for it, so a sustained priority-read storm
    cannot park writes — they complete within a bounded number of polls of
    submission (property-tested in tests/test_latency.py).
    """

    def __init__(self, capacity: int, block_size: int = 4096,
                 read_latency_s: float = DEFAULT_READ_LATENCY_S,
                 write_latency_s: float = DEFAULT_WRITE_LATENCY_S,
                 bandwidth_Bps: float = DEFAULT_BANDWIDTH_BPS,
                 queue_depth: int = DEFAULT_QUEUE_DEPTH,
                 prio_interleave: int = 4):
        assert capacity % block_size == 0
        self.capacity = capacity
        self.block_size = block_size
        self.read_latency_s = read_latency_s
        self.write_latency_s = write_latency_s
        self.bandwidth_Bps = bandwidth_Bps
        self.queue_depth = queue_depth
        self.prio_interleave = max(1, prio_interleave)
        self._mem = np.zeros(capacity, dtype=np.uint8)
        self._memv = memoryview(self._mem)  # C-speed byte copies in poll()
        self._queue: deque[IoOp] = deque()
        self._pq: deque[IoOp] = deque()     # priority queue (offloaded reads)
        self._cookie_done: list[tuple[int, int]] = []  # completion queue
        self._lock = threading.Lock()
        self._clock_s = 0.0  # modeled device clock
        # Deterministic fault injection (see ``crash``/``inject_torn_writev``).
        self.crashed = False
        self._torn_writev: list[int] | None = None   # [ops_until_tear, chunks]
        self.stats = BlockDeviceStats()
        # Logical clock for submit->complete tick stamps; the owning server
        # (or cluster) replaces it with the shared scheduler clock.  The
        # device never ticks it — schedulers do, once per pump step.
        self.clock = TickClock()
        # Work-signaled scheduling hook: invoked on every submission (and
        # synchronous completion push) so the owning server is marked
        # runnable even when the submitter is not the server's own pump —
        # e.g. an application thread driving the host front-end directly.
        self.doorbell: Callable[[], None] | None = None
        # End-to-end integrity (opt-in): one checksum per CRC_BLOCK of
        # media, refreshed at every commit point and verified on every
        # read — the NVMe protection-information role.  None = disabled.
        self._crc: np.ndarray | None = None

    # -- integrity checksums ------------------------------------------------------
    def enable_checksums(self) -> None:
        """Turn on per-block media checksums (CRC_BLOCK granularity).

        The checksum array is (re)computed over the CURRENT media contents
        in one vectorized pass, then kept current by every commit point
        (``write``/``writev`` completion, the torn-writev prefix, and
        ``raw_write``).  Every subsequent read verifies the blocks it
        touches and completes ``STATUS_EIO`` — without copying bytes out —
        when the media no longer matches, so corruption is detected on the
        callback, burst and cookie read paths alike."""
        assert self.capacity % CRC_BLOCK == 0, "capacity must be CRC_BLOCK-aligned"
        nblk = self.capacity // CRC_BLOCK
        self._crc = block_checksums(self._mem, 0, nblk, CRC_BLOCK).copy()

    def _crc_update(self, lba: int, nbytes: int) -> None:
        """Refresh the stored checksums of every block touched by a commit."""
        if nbytes <= 0:
            return
        b0 = lba // CRC_BLOCK
        b1 = (lba + nbytes - 1) // CRC_BLOCK + 1
        self._crc[b0:b1] = block_checksums(self._mem, b0, b1 - b0, CRC_BLOCK)

    def verify_blocks(self, lba: int = 0, nbytes: int | None = None) -> int:
        """Recompute checksums over ``[lba, lba+nbytes)``; return the number
        of blocks whose media bytes no longer match (0 = clean)."""
        if self._crc is None:
            return 0
        if nbytes is None:
            nbytes = self.capacity - lba
        if nbytes <= 0:
            return 0
        b0 = lba // CRC_BLOCK
        b1 = (lba + nbytes - 1) // CRC_BLOCK + 1
        fresh = block_checksums(self._mem, b0, b1 - b0, CRC_BLOCK)
        return int((fresh != self._crc[b0:b1]).sum())

    def _crc_mismatch(self, lba: int, nbytes: int) -> bool:
        b0 = lba // CRC_BLOCK
        b1 = (lba + nbytes - 1) // CRC_BLOCK + 1
        return bool((block_checksums(self._mem, b0, b1 - b0, CRC_BLOCK)
                     != self._crc[b0:b1]).any())

    # -- submission --------------------------------------------------------------
    # deque.append is atomic under the GIL; poll() still serializes the
    # claim of completion bursts, so submission needs no lock round.
    #
    # Completion delivery is either a per-op ``on_complete`` callback OR a
    # ``cookie``: cookie-tagged completions are queued and handed back in
    # bulk by ``reap()`` — the NVMe completion-queue shape, which lets the
    # file service process a whole burst of completions without a Python
    # closure per submitted op.
    def _enqueue(self, op: IoOp, priority: bool = False) -> IoOp:
        if self.crashed:
            return op   # submission lost; status stays PENDING forever
        if op.lba < 0 or op.lba + op.nbytes > self.capacity:
            op.status = STATUS_EINVAL
            if op.on_complete:
                op.on_complete(STATUS_EINVAL)
            elif op.cookie is not None:
                self._cookie_done.append((op.cookie, STATUS_EINVAL))
                db = self.doorbell
                if db is not None:
                    db()   # a completion is pending: keep the owner runnable
            return op
        op.submit_tick = self.clock.now
        q = self._pq if priority else self._queue
        q.append(op)
        d = len(self._queue) + len(self._pq)
        if d > self.stats.max_queue_depth_seen:
            self.stats.max_queue_depth_seen = d
        db = self.doorbell
        if db is not None:
            db()
        return op

    def submit_read(self, lba: int, nbytes: int, dest: memoryview,
                    on_complete: Callable[[int], None] | None = None,
                    cookie: int | None = None,
                    priority: bool = False) -> IoOp:
        return self._enqueue(IoOp("read", lba, nbytes, dest, on_complete,
                                  cookie=cookie), priority)

    def submit_read_many(self, reads: list, priority: bool = False) -> None:
        """Burst read submission: ONE crash check / tick stamp / depth update /
        doorbell for the whole burst instead of one per op.

        ``reads`` items are ``(lba, nbytes, dest, on_complete)``.  Semantics
        match a loop of ``submit_read`` calls in order: each op is bounds-
        checked individually (EINVAL delivered via its callback), and ops
        land on the queue in list order, so completion order — and therefore
        the modeled clock accumulation — is identical to the scalar path.

        Burst reads skip the ``IoOp`` wrapper entirely: each queue entry is
        a plain ``(lba, nbytes, dest, cb, submit_tick)`` tuple, which costs
        a fraction of a dataclass construction and drops the attribute
        loads in ``poll``.  One entry still equals one device op, so claim
        accounting, queue-depth stats, and tick dynamics are byte-for-byte
        identical to the scalar path.  The op object is unobservable here
        anyway — this API returns ``None`` — and cookie completions are not
        supported on this path (callers pass callbacks).
        """
        if self.crashed:
            return
        now = self.clock.now
        q = self._pq if priority else self._queue
        append = q.append
        cap = self.capacity
        for lba, nbytes, dest, cb in reads:
            if lba < 0 or lba + nbytes > cap:
                if cb is not None:
                    cb(STATUS_EINVAL)
                continue
            append((lba, nbytes, dest, cb, now))
        d = len(self._queue) + len(self._pq)
        if d > self.stats.max_queue_depth_seen:
            self.stats.max_queue_depth_seen = d
        db = self.doorbell
        if db is not None:
            db()

    def submit_write(self, lba: int, data,
                     on_complete: Callable[[int], None] | None = None,
                     cookie: int | None = None) -> IoOp:
        return self._enqueue(IoOp("write", lba, len(data), data, on_complete,
                                  cookie=cookie))

    def submit_writev(self, lba: int, bufs: list,
                      on_complete: Callable[[int], None] | None = None,
                      cookie: int | None = None) -> IoOp:
        """Scatter-gather write: one device op covering ``bufs`` back to back.

        Models an NVMe SGL submission — one queue entry (one base latency)
        for a run of coalesced buffers; bytes stream from each view without
        an intermediate join.
        """
        nbytes = 0
        for b in bufs:
            nbytes += len(b)
        return self._enqueue(IoOp("writev", lba, nbytes, bufs, on_complete,
                                  cookie=cookie))

    def push_completion(self, cookie: int, status: int = STATUS_OK) -> None:
        """Synchronous completion for ops with no device work (empty I/O)."""
        self._cookie_done.append((cookie, status))
        db = self.doorbell
        if db is not None:
            db()

    # -- fault injection ---------------------------------------------------------
    def crash(self) -> None:
        """Power-fail NOW: queued ops and undelivered completions vanish.

        Bytes already executed stay durable in ``_mem`` (``raw_read`` still
        works, so a recovery mount can scan the journal), but nothing
        in-flight survives and the device accepts no further work.  The crash
        model all failover tests build on: an op is durable iff ``poll``
        executed it before the crash tick.
        """
        with self._lock:
            self.crashed = True
            self._queue.clear()
            self._pq.clear()
            self._cookie_done.clear()

    def inject_torn_writev(self, nth: int = 1, chunks: int = 1) -> None:
        """Arm a deterministic torn write: the ``nth`` writev executed from
        now applies only its first ``chunks`` gathered buffers to media and
        then the device power-fails mid-op (no completion, queued ops lost).
        Exercises the exact hazard journaling exists for: a coalesced run
        half-landed in place.
        """
        self._torn_writev = [max(1, nth), max(0, chunks)]

    def queue_len(self) -> int:
        with self._lock:
            return len(self._queue) + len(self._pq)

    def busy(self) -> bool:
        """True while ops are queued or completions await ``reap()``.

        A scheduler wakeup source: a server whose device is busy must stay
        runnable until the backlog is polled AND the completion queue is
        reaped.  All probes are lock-free peeks (cheap on the idle path).
        """
        if self.crashed:
            return False
        return bool(self._queue) or bool(self._pq) or bool(self._cookie_done)

    # -- completion --------------------------------------------------------------
    def poll(self, max_completions: int | None = None) -> int:
        """Execute + complete up to ``max_completions`` queued ops.

        PRIORITY ops are served first (each queue strictly in order); when
        the normal queue is non-empty it keeps a reserved share of the
        budget — ``budget // prio_interleave``, at least 1 — so host writes
        make bounded progress under sustained priority-read load.  The
        burst is claimed under ONE lock round; execution (and the
        completion callbacks) run outside the lock."""
        budget = max_completions if max_completions is not None else self.queue_depth
        if self.crashed:
            return 0
        if not self._queue and not self._pq:   # racy-but-safe peek: skip lock
            return 0
        with self._lock:
            q, pq = self._queue, self._pq
            if not q and not pq:
                return 0
            reserve = min(len(q), max(1, budget // self.prio_interleave)) \
                if pq else len(q)
            k_p = min(len(pq), budget - min(reserve, budget))
            k_n = min(len(q), budget - k_p)
            if k_p == len(pq):          # whole-queue claim: one C-level copy
                ops = list(pq)
                pq.clear()
            else:
                ops = [pq.popleft() for _ in range(k_p)]
            if k_n == len(q):
                ops += q
                q.clear()
            elif k_n:
                ops += [q.popleft() for _ in range(k_n)]
            k = k_p + k_n
        # Inline completion loop: per-op stats folded into one update.
        stats = self.stats
        memv = self._memv
        crc_arr = self._crc
        clock = self._clock_s
        inv_bw = 1.0 / self.bandwidth_Bps
        rlat, wlat = self.read_latency_s, self.write_latency_s
        reads = writes = read_bytes = write_bytes = 0
        cookie_done = self._cookie_done
        cookies_before = len(cookie_done)
        now_tick = self.clock.now
        torn = False
        lat_c = stats.prio_completion_ticks.counts  # inlined histogram add:
        run_d = None                                # the stamp rides every
        run_n = 0                                   # completion; runs of the
        for i, op in enumerate(ops):                # same tick delta (the
            if i == k_p:                            # burst norm) fold into
                if run_n:                           # ONE dict update
                    lat_c[run_d] = lat_c.get(run_d, 0) + run_n
                    run_n = 0
                lat_c = stats.completion_ticks.counts
            if type(op) is tuple:   # burst-read entry: (lba, n, dest, cb, tick)
                lba, n, dest, cb, st = op
                d = now_tick - st
                if d == run_d:
                    run_n += 1
                else:
                    if run_n:
                        lat_c[run_d] = lat_c.get(run_d, 0) + run_n
                    run_d = d
                    run_n = 1
                clock += rlat + n * inv_bw
                reads += 1
                read_bytes += n
                if crc_arr is not None and n and self._crc_mismatch(lba, n):
                    stats.crc_read_failures += 1
                    if cb is not None:
                        cb(STATUS_EIO)   # corrupt media: no bytes delivered
                    continue
                dest[:n] = memv[lba : lba + n]   # mv->mv: cheapest copy path
                if cb is not None:
                    cb(STATUS_OK)
                continue
            d = now_tick - op.submit_tick
            if d == run_d:
                run_n += 1
            else:
                if run_n:
                    lat_c[run_d] = lat_c.get(run_d, 0) + run_n
                run_d = d
                run_n = 1
            n = op.nbytes
            kind = op.kind
            st = STATUS_OK
            if kind == "read":
                clock += rlat + n * inv_bw
                reads += 1
                read_bytes += n
                if crc_arr is not None and n and self._crc_mismatch(op.lba, n):
                    stats.crc_read_failures += 1
                    st = STATUS_EIO   # corrupt media: no bytes delivered
                else:
                    # Write straight into the caller's view (zero-copy contract)
                    op.buf[:n] = memv[op.lba : op.lba + n]
            elif kind == "write":
                clock += wlat + n * inv_bw
                # Read straight from the caller's buffer view (zero-copy)
                memv[op.lba : op.lba + n] = op.buf
                writes += 1
                write_bytes += n
                if crc_arr is not None:
                    self._crc_update(op.lba, n)
            else:  # writev: one op, bytes streamed from each gathered view
                tw = self._torn_writev
                if tw is not None:
                    tw[0] -= 1
                    if tw[0] <= 0:
                        # Power-fail MID-op: a prefix of the gathered
                        # buffers reaches media; the rest — and the op's
                        # completion — never happen.
                        pos = op.lba
                        for b in op.buf[: tw[1]]:
                            ln = len(b)
                            memv[pos : pos + ln] = b
                            pos += ln
                        if crc_arr is not None:   # the prefix DID commit
                            self._crc_update(op.lba, pos - op.lba)
                        self._torn_writev = None
                        torn = True
                        break
                clock += wlat + n * inv_bw
                pos = op.lba
                for b in op.buf:
                    ln = len(b)
                    memv[pos : pos + ln] = b
                    pos += ln
                writes += 1
                write_bytes += n
                if crc_arr is not None:
                    self._crc_update(op.lba, n)
            op.modeled_done_s = clock
            op.status = st
            cb = op.on_complete
            if cb:
                cb(st)
            elif op.cookie is not None:
                cookie_done.append((op.cookie, st))
        if run_n:   # trailing histogram run (also flushed on a torn break)
            lat_c[run_d] = lat_c.get(run_d, 0) + run_n
        self._clock_s = clock
        stats.modeled_busy_s = clock
        stats.reads += reads
        stats.writes += writes
        stats.read_bytes += read_bytes
        stats.write_bytes += write_bytes
        if torn:
            self.crash()   # remaining claimed + queued ops vanish
            return k
        if len(cookie_done) > cookies_before:
            db = self.doorbell
            if db is not None:
                db()   # completions queued for reap: owner stays runnable
        return k

    def reap(self) -> list[tuple[int, int]]:
        """Drain the cookie completion queue: ``[(cookie, status), ...]``."""
        out = self._cookie_done
        if not out:
            return out
        self._cookie_done = []
        return out

    def drain(self) -> None:
        while self.poll(1_000_000):
            pass

    # -- raw access for metadata bootstrap ----------------------------------------
    def raw_read(self, lba: int, nbytes: int) -> bytes:
        return self._mem[lba : lba + nbytes].tobytes()

    def raw_write(self, lba: int, data: bytes) -> None:
        self._mem[lba : lba + len(data)] = np.frombuffer(data, dtype=np.uint8)
        if self._crc is not None:   # raw writes are commits too
            self._crc_update(lba, len(data))
