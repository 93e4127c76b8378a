r"""DDS storage server: wires rings + file service + director + offload engine.

This is the deployable unit of the paper (Fig 6): one storage server host
with a DPU.  It also defines the storage-disaggregated benchmark application
of §8.1 (random file I/O over the network, batched requests) whose OffPred /
OffFunc are the paper's 30/20-line examples — reads encode file id, offset
and size directly, so ``Cache``/``Invalidate`` are not needed; writes go to
the host.

Components and their threads (all cooperatively schedulable for tests):

  client --> director.ingress --(signature+predicate)--> offload engine --> SSD
         \-> (host-bound) --> split connection --> host app (DDS front end)
                                                     --> rings --> file service --> SSD

``DDSStorageServer.pump()`` drives every component one step; ``run_until_idle``
loops until no component has work, giving deterministic end-to-end tests.
"""

from __future__ import annotations

import struct
import threading
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import vector, wire
from repro_torch.core.cache_table import CacheTable
from repro_torch.core.file_service import FileServiceRunner, SegmentFS
from repro_torch.core.host_lib import DDSFrontEnd
from repro_torch.core.lifecycle import (ClientLatency, LifecycleTracker, TickClock,
                                  TickHistogram)
from repro_torch.core.offload import OffloadAPI, OffloadEngine, ReadOp, WriteOp
from repro_torch.core.qos import QoSProfile, TenantAdmission
from repro_torch.core.ring import DMAEngine
from repro_torch.core.traffic import (ApplicationSignature, FiveTuple, Packet,
                                TrafficDirector, FLAG_SYN)
from repro_torch.storage.blockdev import BlockDevice

# ---------------------------------------------------------------------------
# The benchmark application protocol (§8.1).
# ---------------------------------------------------------------------------

APP_READ = 1
APP_WRITE = 2
APP_HDR = struct.Struct("<BQIQI")        # type, req_id, file_id, offset, nbytes
APP_RESP_HDR = struct.Struct("<QII")     # req_id, status, nbytes


def encode_app_read(req_id: int, file_id: int, offset: int, nbytes: int) -> bytes:
    return APP_HDR.pack(APP_READ, req_id, file_id, offset, nbytes)


def encode_app_write(req_id: int, file_id: int, offset: int, data) -> bytes:
    """Encode a write request; ``data`` may be bytes or a memoryview.

    ``join`` consumes buffer views directly, so a memoryview source is
    copied exactly once — into the outgoing message — never materialized
    into an intermediate ``bytes`` first."""
    return b"".join((APP_HDR.pack(APP_WRITE, req_id, file_id, offset,
                                  len(data)), data))


def encode_batch(msgs: list[bytes]) -> bytes:
    """Batch several app messages into one network message (§6.1 batching).

    The generator join is the fast encode kernel on CPython: the
    array-at-a-time pack (:func:`repro_torch.core.vector.pack_frames`) only
    reaches parity around 4096 uniform frames (crossover measured by
    ``benchmarks/micro/kernels_ab.py``), so it is reserved for bursts of
    that scale and the join keeps every realistic batch.
    """
    if len(msgs) >= 4096:
        return bytes(vector.pack_frames(msgs))
    return b"".join(struct.pack("<I", len(m)) + m for m in msgs)


_BATCH_LEN = struct.Struct("<I")


def decode_batch(payload) -> list[memoryview]:
    """Split a batched network message into per-message ZERO-COPY views.

    Messages are ``memoryview`` slices of the packet buffer — header fields
    unpack in place (``Struct.unpack_from`` accepts views) and payload bytes
    are never duplicated on the decode path.  Callers that need a hashable
    key (cache-table lookups) convert just that field with ``bytes(...)``.

    A large fixed-stride batch is proven uniform with one array compare
    (:func:`repro_torch.core.vector.uniform_stride`) and sliced columnar — no
    per-message length unpack; anything irregular falls through to the
    scalar walk.
    """
    mv = payload if isinstance(payload, memoryview) else memoryview(payload)
    out, off, end = [], 0, len(mv)
    if end >= 512:
        u = vector.uniform_stride(mv, 4, 0, min_frames=20)
        if u is not None:
            cnt, stride, _ = u
            out = [mv[i * stride + 4:(i + 1) * stride] for i in range(cnt)]
            off = cnt * stride
    unpack = _BATCH_LEN.unpack_from
    while off < end:
        (n,) = unpack(mv, off)
        off += 4
        out.append(mv[off : off + n])
        off += n
    return out


def reassemble_responses(rx: bytearray, responses: dict,
                         order: list | None = None) -> int:
    """Peel complete APP_RESP_HDR-framed responses off a client rx buffer.

    Shared by every client (single-server and cluster shard connections) so
    the framing logic lives in exactly one place.  The buffer is parsed with
    a running offset and consumed bytes are trimmed ONCE at the end (the old
    per-response ``del rx[:total]`` made a buffer of n small responses cost
    O(n^2) byte moves); a trailing partial response is left for the next
    call.  Returns the number of responses extracted."""
    n = 0
    off, end = 0, len(rx)
    hdr_size = APP_RESP_HDR.size
    unpack = APP_RESP_HDR.unpack_from
    mv = memoryview(rx)
    if end >= 512:
        # Uniform-stride fast path: one structured-dtype view decodes the
        # req-id / status columns for the whole burst (the nbytes word at
        # offset 12 doubles as the stride proof); payload copies and dict
        # fills remain per-response, header unpacking does not.  A
        # trailing partial frame (or a differently-sized tail) falls
        # through to the scalar walk below.
        u = vector.uniform_stride(mv, hdr_size, 12, min_frames=20)
        if u is not None:
            cnt, stride, nbytes = u
            cols = np.frombuffer(mv, count=cnt, dtype=np.dtype(
                {"names": ["rid", "status"], "formats": ["<u8", "<u4"],
                 "offsets": [0, 8], "itemsize": stride}))
            rids = cols["rid"].tolist()
            stats = cols["status"].tolist()
            del cols   # drop the buffer export before the trim below
            # ONE strided gather peels every payload out of the burst; the
            # per-response work shrinks to a C-level bytes slice.
            blob = np.frombuffer(mv, dtype=np.uint8, count=cnt * stride) \
                .reshape(cnt, stride)[:, hdr_size:].tobytes()
            for i, rid in enumerate(rids):
                s = i * nbytes
                responses[rid] = (stats[i], blob[s:s + nbytes])
            if order is not None:
                order.extend(rids)
            off = cnt * stride
            n = cnt
    while end - off >= hdr_size:
        req_id, status, nbytes = unpack(mv, off)
        total = hdr_size + nbytes
        if end - off < total:
            break
        responses[req_id] = (status, bytes(mv[off + hdr_size : off + total]))
        if order is not None:
            order.append(req_id)
        off += total
        n += 1
    # A bytearray with an exported view cannot be resized: release first.
    mv.release()
    if off:
        del rx[:off]
    return n


def drain_client_flow(director, resp_flow, rx: bytearray, responses: dict,
                      order: list | None = None) -> int:
    """THE response-drain implementation every client shares.

    Takes this flow's (possibly segmented) packets off the director's
    demuxed ``to_client`` wire in one O(1) swap — no scanning past other
    clients' traffic — appends their payloads to the connection rx buffer,
    and reassembles completed responses.  Returns packets drained."""
    pkts = director.to_client.drain_flow(resp_flow)
    if not pkts:
        return 0
    release: list[int] = []
    pool = None
    payloads = []
    payload_append = payloads.append
    for pkt in pkts:
        if pkt.csum != -1 and vector.checksum64(pkt.payload) != pkt.csum:
            # Stamped checksum mismatch: the frame was damaged in flight.
            # Discard it as a loss — the client's timeout/resend machinery
            # recovers the response; delivering torn bytes would poison the
            # rx stream reassembly below.
            director.stats.corrupt_dropped += 1
            pkt.consumed()
            continue
        payload_append(pkt.payload)
        ref = pkt.pool_ref
        if ref is not None:   # TX-completion: reclaim the pool block
            pkt.pool_ref = None
            pool = ref[0]
            release.append(ref[1])
    # One join + one extend: n small bytearray appends would realloc the
    # rx buffer piecemeal and re-touch its tail n times.
    if payloads:
        rx += b"".join(payloads) if len(payloads) > 1 else payloads[0]
    if release:
        pool.release_many(release)  # one lock round for the whole drain
    reassemble_responses(rx, responses, order)
    return len(pkts)


def default_off_pred(payload: bytes, table) -> tuple[list[bytes], list[bytes]]:
    """The paper's simple example: reads -> DPU, writes -> host (§6.1).

    On a uniform batch the opcode bytes form one strided column; when they
    are ALL reads (the hot-path shape) the split is decided with a single
    array compare instead of a per-message branch.
    """
    mv = payload if isinstance(payload, memoryview) else memoryview(payload)
    end = len(mv)
    if end >= 512:
        u = vector.uniform_stride(mv, 4, 0, min_frames=20)
        if u is not None and u[0] * u[1] == end:
            cnt, stride, _ = u
            ops = np.frombuffer(mv, dtype=np.uint8,
                                count=cnt * stride).reshape(cnt, stride)[:, 4]
            if (ops == APP_READ).all():
                return [], [mv[i * stride + 4:(i + 1) * stride]
                            for i in range(cnt)]
    host, dpu = [], []
    for m in decode_batch(mv):
        if m and m[0] == APP_READ:
            dpu.append(m)
        else:
            host.append(m)
    return host, dpu


def default_off_func(msg: bytes, table) -> ReadOp | None:
    """File id/offset/size are encoded in the request (§8.2 footnote 4)."""
    typ, req_id, file_id, offset, nbytes = APP_HDR.unpack_from(msg, 0)
    if typ != APP_READ:
        return None
    return ReadOp(file_id, offset, nbytes)


def app_response_header(msg: bytes, op: ReadOp, err: int) -> bytes:
    if msg:
        _, req_id, *_ = APP_HDR.unpack_from(msg, 0)
    else:
        req_id = 0
    return APP_RESP_HDR.pack(req_id, err, op.size if err == wire.E_OK else 0)


def default_prepare_read(msg, table) -> tuple[ReadOp, bytes] | None:
    """Fused OffFunc + ok-response-header: ONE header parse per request."""
    typ, req_id, file_id, offset, nbytes = APP_HDR.unpack_from(msg, 0)
    if typ != APP_READ:
        return None
    return (ReadOp(file_id, offset, nbytes),
            APP_RESP_HDR.pack(req_id, wire.E_OK, nbytes))


# Lifecycle classifier for the §8.1 benchmark protocol: which message type
# bytes are reads (everything else counts as a write / mutation).
DEFAULT_READ_TYPES = frozenset({APP_READ})


@dataclass
class ServerConfig:
    """Structural sizing of one server + its scheduling/QoS policy.

    The per-feature scheduling knobs that accreted over PRs 3-5
    (``coalesce_ticks``, ``coalesce_cap``, ``prio_interleave``,
    ``deliver_ticks``, ``host_drain_slice``, ``read_write_fence``,
    ``device_queue_depth``) now live on :class:`~repro_torch.core.qos.QoSProfile`
    together with the tenancy controls (weights, token-bucket rates).
    ``qos`` accepts a profile instance or a preset name
    (``"latency"`` / ``"throughput"`` / ``"isolation"``).
    """

    device_capacity: int = 1 << 28          # 256 MiB RAM "SSD"
    segment_size: int = 1 << 20
    server_port: int = 5000
    director_cores: int = 1
    offload_ring: int = 256
    offload_pool: int = 1 << 24
    zero_copy: bool = True
    userspace_stack: bool = True             # TLDK vs Linux-on-DPU (Fig 19)
    cache_items: int = 1 << 16
    offload_enabled: bool = True             # False => all requests to host
    # Requests pulled per engine step (and ingress demux burst).  The
    # vectorized data plane amortizes its fixed numpy cost over this burst:
    # raise it for throughput-bound storms, keep the default for
    # latency-sensitive configs (a pulled request commits to this step).
    offload_burst: int = 64
    qos: QoSProfile | str = field(default_factory=QoSProfile)
    # Crash consistency: segments reserved for the SegmentFS redo journal
    # (0 disables journaling; silently disabled on devices too small to
    # hold metadata + journal + one data segment).
    journal_segments: int = 2
    # Replication factor for a DDSCluster built from this config: each
    # shard's acked writes are forwarded to this many ring-successor
    # replicas BEFORE the client sees the ack.  0 = unreplicated.
    replication: int = 0
    # Failover detection: ticks of heartbeat silence before the cluster
    # supervisor counts one missed window; promotion fires only after
    # ``heartbeat_miss_windows`` CONSECUTIVE missed windows, so a single
    # delayed/partitioned heartbeat blip cannot false-promote a live
    # primary.  Detection latency is
    # ``heartbeat_miss_windows * (heartbeat_timeout_ticks + 1)`` pumps.
    heartbeat_timeout_ticks: int = 16
    heartbeat_miss_windows: int = 2
    # Lossy-network survival (see README "Network fault model"): when set,
    # every wire frame (requests, host/DPU responses) is stamped with a
    # ``vector.checksum64`` of its payload and verified at the receive
    # edge — a bit-corrupted frame is discarded as a loss instead of
    # delivering torn bytes, and the client's timeout/resend recovers it.
    wire_checksums: bool = False
    # Exactly-once mutations: per-(flow, request-id) server-side dedup /
    # reply cache capacity (completed entries; in-flight markers are
    # bounded by the in-flight window).  A resent mutation whose original
    # is still executing is suppressed; one whose ack was already sent
    # replays the CACHED ack without re-executing.  0 disables.
    dedup_cache: int = 1024
    # End-to-end integrity: per-4KiB media checksums on the block device,
    # refreshed at every write commit (including the torn-writev prefix)
    # and verified on every read — a corrupted-media read completes E_IO
    # instead of returning garbage.  Journal records carry their own body
    # checksum regardless of this knob (replay always verifies).
    verify_checksums: bool = False

    def __post_init__(self):
        if self.journal_segments < 0 or self.replication < 0:
            raise ValueError("journal_segments/replication must be >= 0")
        if self.heartbeat_timeout_ticks < 1:
            raise ValueError("heartbeat_timeout_ticks must be >= 1")
        if self.heartbeat_miss_windows < 1:
            raise ValueError("heartbeat_miss_windows must be >= 1")
        if self.dedup_cache < 0:
            raise ValueError("dedup_cache must be >= 0")
        if isinstance(self.qos, str):
            self.qos = QoSProfile.preset(self.qos)
        elif isinstance(self.qos, dict):
            self.qos = QoSProfile.from_dict(self.qos)
        elif not isinstance(self.qos, QoSProfile):
            raise ValueError(f"ServerConfig.qos must be a QoSProfile, "
                             f"preset name, or dict; got {self.qos!r}")


# Admission sheds happen BEFORE any execution path parses the message, so
# the rid for the terminal mark comes from the protocol layout: both the
# §8.1 app header (<BQIQI) and the KV headers (<BQ...) carry req_id as a
# u64 at byte offset 1.
_REQ_ID_U64_AT_1 = struct.Struct("<Q")

# Dedup-cache miss sentinel: ``None`` is a real value (pending marker).
_DEDUP_MISS = object()


def default_req_id_of(msg) -> int:
    return _REQ_ID_U64_AT_1.unpack_from(msg, 1)[0]


class DDSStorageServer:
    """One storage server host + its DPU (Fig 6)."""

    def __init__(self, config: ServerConfig | None = None,
                 api: OffloadAPI | None = None):
        self.config = config or ServerConfig()
        cfg = self.config
        # Work-signaled scheduling (see distributed.cluster.DDSCluster):
        # ``signal()`` marks this server runnable in whatever scheduler owns
        # it.  Installed via ``set_doorbell``; standalone servers run with
        # no doorbell and ``signal`` is a no-op.
        self._doorbell = None
        # Deterministic request-lifecycle clock: ONE tick per pump step.  A
        # standalone server owns (and ticks) its own; a DDSCluster installs
        # its shared clock via ``adopt_clock`` and ticks once per cluster
        # pump instead.
        self.clock = TickClock()
        self._owns_clock = True
        q = cfg.qos
        self.device = BlockDevice(cfg.device_capacity,
                                  queue_depth=q.device_queue_depth,
                                  prio_interleave=q.prio_interleave)
        self.device.doorbell = self.signal
        self.device.clock = self.clock
        if cfg.verify_checksums:
            self.device.enable_checksums()
        js = cfg.journal_segments
        if cfg.device_capacity // cfg.segment_size < 2 + js:
            js = 0   # device too small for a journal: run unjournaled
        self.fs = SegmentFS(self.device, cfg.segment_size,
                            journal_segments=js)
        self.dma = DMAEngine()
        self.cache_table = CacheTable(cfg.cache_items)
        self.api = api or OffloadAPI(default_off_pred, default_off_func,
                                     prepare_read=default_prepare_read)
        self.lifecycle = LifecycleTracker(
            self.clock, self.api.read_types or DEFAULT_READ_TYPES)
        # Traffic director: signature matches any client talking to our port.
        sig = (ApplicationSignature(dst_port=cfg.server_port)
               if cfg.offload_enabled else
               ApplicationSignature(dst_port=-1))  # match nothing: host-only
        self.director = TrafficDirector(
            sig, self.api.off_pred, self.cache_table,
            ncores=cfg.director_cores, host_port=cfg.server_port,
            userspace_stack=cfg.userspace_stack)
        # Frame integrity: stamp responses (and have clients stamp
        # requests) with payload checksums; the receive edges verify and
        # discard corrupt frames as losses.
        self.director.stamp_checksums = cfg.wire_checksums
        # Tenancy: weighted-fair service on the offload queue and the host
        # wire's drain; token-bucket admission (when configured) sheds at
        # the demux via the lifecycle tracker's terminal marks.
        self.director.offload_queue.weight_of = q.weight_of
        self.director.to_host.weight_of = q.weight_of
        self.admission: TenantAdmission | None = None
        if q.admission_enabled():
            self.admission = TenantAdmission(q, self.clock)
            self.director.admit = self.admission.admit
            self.director.on_shed = self._on_admission_shed
        # File service with cache-on-write / invalidate-on-read hooks (§6.1).
        # Hooks are wired ONLY when the application actually installed the
        # Table-1 functions — the default §8.1 app has neither, and a None
        # hook lets the write path skip per-request cache bookkeeping.
        self.file_service = FileServiceRunner(
            self.fs, self.dma, zero_copy=cfg.zero_copy,
            cache_hook=(self._cache_on_write
                        if self.api.cache is not None else None),
            invalidate_hook=(self._invalidate_on_read
                             if self.api.invalidate is not None else None),
            clock=self.clock,
            coalesce_ticks=q.coalesce_ticks,
            deliver_ticks=q.deliver_ticks,
            coalesce_cap=q.coalesce_cap,
            shed_hook=self._on_shed)
        if q.read_write_fence:
            self.file_service.track_writes = True
        self.offload = OffloadEngine(
            self.fs, self.director, self.api, self.cache_table,
            ring_size=cfg.offload_ring, pool_size=cfg.offload_pool,
            zero_copy=cfg.zero_copy,
            app_header=self.api.response_header or app_response_header)
        self.offload.lifecycle = self.lifecycle
        if q.read_write_fence:
            self.offload.busy_files = self.file_service.write_inflight
        self._host_drain_slice = q.host_drain_slice
        self._offload_burst = cfg.offload_burst
        # The host storage application, adopting the DDS front-end library.
        # Its request rings ring our doorbell on every producer publish.
        self.frontend = DDSFrontEnd(self.file_service, doorbell=self.signal)
        self.host_app = _HostApp(self)
        self.host_cpu_busy_s = 0.0   # modeled host CPU seconds consumed
        # Primary-backup replication (installed by DDSCluster when
        # ``config.replication`` > 0): forwards acked writes to replica
        # shards and gates client write acks on replica acks.
        self.replicator = None
        # Live-migration tap (installed by the resharding driver while this
        # shard is a migration SOURCE): dual-routes writes for keys moving
        # to their new owner and can hold client acks until the destination
        # holds the bytes — the replicator's sibling on the same hooks.
        self.migrator = None

    # -- work-signaled scheduling hooks --------------------------------------------
    def set_doorbell(self, doorbell) -> None:
        """Install the scheduler's mark-runnable callback (cluster layer)."""
        self._doorbell = doorbell

    def adopt_clock(self, clock: TickClock) -> None:
        """Share a scheduler-owned tick clock (cluster layer): every stamp
        point — device, file service, rings, lifecycle — rebinds to it, and
        this server stops ticking in ``pump`` (the owner ticks, once per
        scheduling step, keeping tick latencies comparable across shards)."""
        self.clock = clock
        self._owns_clock = False
        self.device.clock = clock
        self.lifecycle.clock = clock
        self.file_service.adopt_clock(clock)
        if self.admission is not None:
            self.admission.clock = clock   # buckets refill on the shared clock
        if self.replicator is not None:
            self.replicator.clock = clock

    def _on_shed(self, frontend_rid: int) -> None:
        """A host-path request was shed (bounded E_NOSPC path gave up).

        Three things must happen or the system wedges in a busy-forever
        state with a client spinning on a timeout: the host app's in-flight
        entry is dropped, the front-end's booked op is cancelled (so
        ``any_outstanding`` clears), and the ORIGINAL application request is
        marked shed in the lifecycle tracker, where the client's ``wait``
        finds the terminal status."""
        info = self.host_app._inflight.pop(frontend_rid, None)
        self.frontend.cancel(frontend_rid)
        if info is None:
            # Either not an application op (a direct front-end user), or the
            # shed fired INSIDE frontend.submit_many (the ring-full
            # on_retry re-entrantly steps the file service) — before
            # _execute_burst could record the in-flight meta.  Park the rid:
            # the host app reconciles it right after booking, so the mark
            # is never lost and the meta never leaks.
            self.host_app._orphan_sheds.add(frontend_rid)
            return
        host_flow, _typ, req_id = info[:3]
        # The shed request will never complete: clear its dedup pending
        # marker so a client retry is executed as a fresh request instead
        # of being suppressed against an execution that died.
        self.host_app._dedup.pop((host_flow, req_id), None)
        client_flow = self.director._client_flow_of.get(host_flow, host_flow)
        # Overload sheds carry a minimal hint: the tenant plus retry-after 1
        # (the bounded E_NOSPC path gave up THIS tick; next tick may admit).
        self.lifecycle.mark_shed(
            client_flow, req_id,
            wire.encode_shed_hint(getattr(client_flow, "tenant", 0), 1))

    def _on_admission_shed(self, client_flow: FiveTuple, msg) -> None:
        """Token-bucket admission dropped ``msg`` at the director's demux.

        The request never reaches any execution path, so the terminal mark
        is made here — keyed by the ORIGINAL client flow and the request id
        extracted straight from the message header — with the shedding
        tenant's bucket state (retry-after ticks) as the E_SHED hint."""
        req_id_of = self.api.req_id_of or default_req_id_of
        hint = wire.encode_shed_hint(
            client_flow.tenant, self.admission.retry_after(client_flow.tenant))
        self.lifecycle.mark_shed(client_flow, req_id_of(msg), hint)

    def _on_stale_epoch(self, client_flow: FiveTuple, payload,
                        current_epoch: int) -> None:
        """A packet tagged with a pre-failover ring epoch hit the director.

        Its requests are refused wholesale with a retryable terminal
        redirect (the shed plumbing's sibling): each request id is marked
        ``E_REDIRECT`` in the lifecycle tracker with the CURRENT epoch as
        the hint, so the client re-routes on the repaired ring and
        resubmits the same ids."""
        req_id_of = self.api.req_id_of or default_req_id_of
        hint = wire.encode_redirect_hint(current_epoch)
        for m in decode_batch(payload):
            self.lifecycle.mark_redirect(client_flow, req_id_of(m), hint)

    def signal(self) -> None:
        """Mark this server runnable.  Called by every work producer: client
        sends into the director's ingress, ring inserts, block-device
        submissions/synchronous completions.  No-op standalone."""
        db = self._doorbell
        if db is not None:
            db()

    def busy(self) -> bool:
        """True while pumping this server could make progress.

        THE no-lost-wakeup predicate: the cluster scheduler re-arms a
        stepped server while this holds, so a server with queued ingress,
        undrained offload work, in-flight contexts, pending device
        completions, or host-path state can never be parked.  Quiescence
        (``pump() == 0``) is deliberately weaker — a shed request leaves an
        application op permanently outstanding without making the server
        non-idle — which is why ``run_until_idle`` keeps its idle-sweep
        escape hatch.  Ordered cheapest-first; every probe is lock-free.
        """
        return (self.device.busy()
                or self.offload.in_flight()
                or self.director.busy()
                or self.host_app.busy()
                or self.file_service.busy()
                or self.frontend.any_outstanding()
                or (self.replicator is not None and self.replicator.busy())
                or (self.migrator is not None and self.migrator.busy()))

    # -- §6.1 hooks: translate file-service ops into user Cache/Invalidate ----------
    # (called with plain header fields: the file service's data plane keeps
    # no per-request objects, see FileServiceRunner._submit_burst)
    def _cache_on_write(self, file_id: int, offset: int, payload) -> None:
        if self.api.cache is not None:
            self.offload.on_host_write(WriteOp(file_id, offset, payload))

    def _invalidate_on_read(self, file_id: int, offset: int, nbytes: int) -> None:
        if self.api.invalidate is not None:
            self.offload.on_host_read(ReadOp(file_id, offset, nbytes))

    # -- cooperative event loop ---------------------------------------------------------
    def pump(self) -> int:
        """One scheduling step, in PRIORITY order.

        The tick clock advances first (standalone servers; a cluster ticks
        its shared clock once per cluster pump).  Then the step is the
        early-priority-demux discipline: ingress is classified, the offload
        engine serves predicate-positive reads — which also ride the
        device's priority queue — BEFORE any host-path work runs, and the
        host wire is drained in a bounded slice so one hot flow cannot
        monopolize the step."""
        if self._owns_clock:
            self.clock.tick()
        burst = self._offload_burst
        work = self.director.step_n(burst)  # whole ingress burst, 1 lock round
        work += self.offload.step(burst)  # polls device + completes internally
        if self.replicator is not None:
            work += self.replicator.step()   # forwarded writes + replica acks
        host_work = self.host_app.step(self._host_drain_slice)
        # The host path (file service rings + completion polling) only runs
        # when it can have work; the offloaded fast path never pays for it.
        if host_work or self._host_path_busy():
            work += self.file_service.step()
            self.device.poll()
            work += self.offload.complete_pending()
            work += self.host_app.poll_completions()
        return work + host_work

    def latency_stats(self) -> dict:
        """Measured tick-latency distributions (see README)."""
        dev = self.device.stats
        out = {"classes": self.lifecycle.summary()}
        if self.admission is not None:
            out["admission"] = self.admission.summary()
        if self.replicator is not None:
            out["replication"] = self.replicator.summary()
        if self.fs.journal_replayed_records:
            out["journal_replay"] = {
                "records": self.fs.journal_replayed_records,
                "bytes": self.fs.journal_replayed_bytes}
        if dev.completion_ticks.n:
            out["device"] = dev.completion_ticks.summary()
        if dev.prio_completion_ticks.n:
            out["device_prio"] = dev.prio_completion_ticks.summary()
        res = TickHistogram()
        for g in self.file_service.groups.values():
            if g.req_ring.residency is not None:
                res.merge(g.req_ring.residency)
        if res.n:
            out["ring_residency"] = res.summary()
        ds = self.director.stats
        if ds.corrupt_dropped or ds.seq_resyncs or ds.dpu_bypassed:
            out["wire"] = {"corrupt_dropped": ds.corrupt_dropped,
                           "seq_resyncs": ds.seq_resyncs,
                           "dpu_bypassed": ds.dpu_bypassed}
        ha = self.host_app
        if ha.dup_suppressed or ha.replayed_acks:
            out["exactly_once"] = {"dup_suppressed": ha.dup_suppressed,
                                   "replayed_acks": ha.replayed_acks}
        return out

    def _host_path_busy(self) -> bool:
        return (self.host_app.busy()
                or self.frontend.any_outstanding()
                or self.file_service.busy())

    def run_until_idle(self, max_iters: int = 200_000) -> None:
        idle = 0
        for _ in range(max_iters):
            if self.pump() == 0:
                self.device.drain()
                idle += 1
                if idle >= 3:
                    return
            else:
                idle = 0
        raise TimeoutError("server did not go idle")


class _HostApp:
    """The storage application on the host, using the DDS front-end library.

    Executes host-bound requests (writes, non-offloadable reads) and replies
    through the traffic director.  Each request costs modeled host CPU time —
    this is what Figs 2/14 measure and what offloading eliminates.
    """

    # Modeled per-request host costs (µs), calibrated to §1/§8 (Fig 2:
    # network module dominates; 17 cores @156K pages/s ≈ 109 µs/page total).
    HOST_NET_US = 45.0     # DBMS network module + OS stack per request
    HOST_FS_US = 25.0      # OS file system / storage stack per request
    HOST_APP_US = 10.0     # request parsing, bookkeeping

    def __init__(self, server: DDSStorageServer):
        self.server = server
        self._inflight: dict[int, tuple] = {}  # rid -> (host_flow, app req)
        self._burst: list[tuple] = []          # (host_flow, msg) drained batch
        # Write acks gated on replication: locally durable, awaiting the
        # replica's ack (rid -> (host_flow, req_id, error, body, t0)).  The
        # client NEVER sees an ack for bytes a shard crash could lose.
        self._held_acks: dict[int, tuple] = {}
        # Rids shed during frontend.submit_many's re-entrant file-service
        # step, BEFORE their in-flight meta was recorded (see
        # DDSStorageServer._on_shed); reconciled right after booking.
        self._orphan_sheds: set[int] = set()
        self._files_ready = False
        # Exactly-once mutation dedup / reply cache (armed by
        # ``ServerConfig.dedup_cache``): (host_flow, req_id) -> None while
        # the original execution is in flight (a resend is suppressed; the
        # eventual ack answers both), or the completed ack bytes (a resend
        # replays the CACHED ack without re-executing — a resent KV PUT
        # must not append a second log record).  Only COMPLETED entries
        # enter the FIFO eviction queue; pending markers are bounded by
        # the in-flight window and removed on shed.
        self._dedup_cap = server.config.dedup_cache
        self._dedup: dict[tuple, bytes | None] = {}
        self._dedup_fifo: deque[tuple] = deque()
        self.dup_suppressed = 0
        self.replayed_acks = 0

    def _dedup_complete(self, key: tuple, resp: bytes) -> None:
        """Record a mutation's final ack for replay; FIFO-evict old acks."""
        if key not in self._dedup:
            return   # marker was shed/evicted: nothing to fill
        self._dedup[key] = resp
        fifo = self._dedup_fifo
        fifo.append(key)
        while len(fifo) > self._dedup_cap:
            old = fifo.popleft()
            # Only completed entries ride the FIFO, so eviction can never
            # kill a pending marker (a later completion with the same key
            # re-appends; the stale queue entry is then a no-op pop).
            if self._dedup.get(old) is not None:
                self._dedup.pop(old, None)

    def busy(self) -> bool:
        """True while host requests are in flight (pump must keep stepping)."""
        return bool(self._inflight) or bool(self._held_acks)

    def step(self, max_pkts: int | None = None) -> int:
        """Drain a bounded slice of the host wire, then execute the WHOLE
        burst in one pass.

        Collect-then-execute lets the file I/O of a burst issue through
        ``DDSFrontEnd.submit_many`` (bulk rid reservation + one ring
        reservation per group) instead of one ring round trip per message.
        ``max_pkts`` bounds the slice per pump step (tail-latency: a hot
        flow's backlog cannot delay other flows' responses a whole step —
        the remainder stays on the wire and the server stays runnable)."""
        n = self.server.director.drain_host_wire(self._collect, max_pkts)
        if self._burst:
            self._execute_burst()
        return n

    def _collect(self, host_flow: FiveTuple, payload) -> None:
        if not payload:
            return  # SYN/control packet hardware-forwarded to the host
        burst = self._burst
        if host_flow.src_ip == "dpu-proxy":
            # PEP split connection: one app message.  Keep it a zero-copy
            # view — write payloads ride it into the request ring untouched.
            burst.append((host_flow,
                          payload if isinstance(payload, memoryview)
                          else memoryview(payload)))
            return
        # hw-forwarded original batch; the HOST app owns its messages
        # (it indexes/hashes them), so materialize real bytes here —
        # host-path copies are exactly what offloading avoids.
        for m in decode_batch(payload):
            burst.append((host_flow, bytes(m)))

    def _execute_burst(self) -> None:
        msgs = self._burst
        self._burst = []
        srv = self.server
        handler = srv.api.host_handler
        hdr_size = APP_HDR.size
        # Lifecycle ingress stamp: rides the in-flight meta tuple (no
        # per-request tracker state).  Taken at burst execution, which runs
        # in the SAME pump step (same tick) as the director's demux unless
        # a bounded drain slice deferred the packet.
        now = srv.clock.now
        lt = srv.lifecycle
        read_types = lt.read_types
        dedup = self._dedup if self._dedup_cap else None
        req_id_of = srv.api.req_id_of or default_req_id_of
        submits: list[tuple] = []   # ("w"|"r", file_id, offset, data|nbytes)
        metas: list[tuple] = []  # (host_flow, typ, req_id, nbytes, ack, t0, dkey)
        responses: dict[FiveTuple, list] = {}  # immediate 'resp' actions
        n_resp = 0
        for host_flow, m in msgs:
            typ = m[0] if m else 0
            # Exactly-once mutations: the dedup check MUST run before the
            # handler — a KV PUT mutates index/log state inside the
            # handler, so a resent PUT reaching it would apply twice.
            dkey = None
            if dedup is not None and typ not in read_types and len(m) >= 9:
                dkey = (host_flow, req_id_of(m))
                prev = dedup.get(dkey, _DEDUP_MISS)
                if prev is not _DEDUP_MISS:
                    if prev is None:
                        # Original still executing: drop the resend; the
                        # eventual (single) ack answers both copies.
                        self.dup_suppressed += 1
                    else:
                        # Already acked: replay the CACHED ack verbatim.
                        self.replayed_acks += 1
                        n_resp += 1
                        responses.setdefault(host_flow, []).append(prev)
                    continue
                dedup[dkey] = None   # pending marker
            if typ not in (APP_READ, APP_WRITE) and handler is not None:
                action = handler(m)
                kind = action[0]
                if kind == "resp":
                    _, req_id, status, body = action
                    n_resp += 1
                    # Served inline this tick: a zero-delta completion.
                    cls = "host_read" if typ in read_types else "write"
                    lt.hist[cls].add(0)
                    if host_flow.tenant:
                        lt.add_tenant(host_flow.tenant, cls, 0)
                    resp = APP_RESP_HDR.pack(req_id, status, len(body)) + body
                    if dkey is not None:
                        self._dedup_complete(dkey, resp)
                    responses.setdefault(host_flow, []).append(resp)
                elif kind == "w":
                    # ('w', req_id, fid, off, data[, resp_body]) — the
                    # optional 6th element is echoed in the write ack (e.g.
                    # a KV PUT returning its on-disk location, §9.2).
                    _, req_id, file_id, offset, data = action[:5]
                    submits.append(("w", file_id, offset, data))
                    metas.append((host_flow, APP_WRITE, req_id, len(data),
                                  action[5] if len(action) > 5 else b"", now,
                                  dkey))
                else:
                    _, req_id, file_id, offset, nbytes = action
                    submits.append(("r", file_id, offset, nbytes))
                    metas.append((host_flow, APP_READ, req_id, nbytes, b"",
                                  now, dkey))
                continue
            typ, req_id, file_id, offset, nbytes = APP_HDR.unpack_from(m, 0)
            if typ == APP_WRITE:
                submits.append(("w", file_id, offset,
                                m[hdr_size : hdr_size + nbytes]))
            else:
                submits.append(("r", file_id, offset, nbytes))
            metas.append((host_flow, typ, req_id, nbytes, b"", now, dkey))
        # Modeled host CPU: network + app cost PER MESSAGE (batching the
        # simulator does not change what the host cores would burn), plus
        # the network cost of each immediate response.
        srv.host_cpu_busy_s += ((self.HOST_NET_US + self.HOST_APP_US)
                                * len(msgs) + self.HOST_NET_US * n_resp) * 1e-6
        for flow, batch in responses.items():
            srv.director.host_response_many(flow, batch)
        if submits:
            rids = srv.frontend.submit_many(submits)
            inflight = self._inflight
            for rid, meta in zip(rids, metas):
                inflight[rid] = meta
            repl = srv.replicator
            if repl is not None:
                # Primary-backup forward at the one point where the final
                # on-disk bytes are known (KV handlers rewrite payloads into
                # log records): the replica applies the identical bytes at
                # the identical file offset through its own host path.
                for rid, sub in zip(rids, submits):
                    if sub[0] == "w":
                        repl.forward(rid, sub[1], sub[2], sub[3])
            mig = srv.migrator
            if mig is not None:
                # Live migration dual-route: writes whose key already moved
                # (or is moving) to a new owner are synced to the
                # destination; during the dual-write phase the client ack is
                # additionally held until the destination acked.
                for rid, sub in zip(rids, submits):
                    if sub[0] == "w":
                        mig.forward(rid, sub[1], sub[2], sub[3])
            orphans = self._orphan_sheds
            if orphans:
                # A shed fired inside submit_many (re-entrant ring-full
                # step) before the meta above existed: finish the terminal
                # marking now so nothing leaks and clients see E_SHED.  An
                # orphan that does not match this burst was a direct
                # front-end user's op (never ours) — drop it.
                lt = srv.lifecycle
                cf_of = srv.director._client_flow_of
                for rid in orphans:
                    meta = inflight.pop(rid, None)
                    if meta is not None:
                        if meta[6] is not None:
                            self._dedup.pop(meta[6], None)
                        cf = cf_of.get(meta[0], meta[0])
                        lt.mark_shed(cf, meta[2], wire.encode_shed_hint(
                            getattr(cf, "tenant", 0), 1))
                orphans.clear()

    def poll_completions(self) -> int:
        srv = self.server
        inflight = self._inflight
        per_flow: dict[FiveTuple, list] = {}
        n = 0
        hist = srv.lifecycle.hist
        now = srv.clock.now
        r_add = hist["host_read"].add
        w_add = hist["write"].add
        tenant_add = srv.lifecycle.add_tenant
        repl = srv.replicator
        mig = srv.migrator
        for gid in list(srv.frontend._groups):
            for c in srv.frontend.poll_wait(gid, 0.0):
                info = inflight.pop(c.request_id, None)
                if info is None:
                    continue
                host_flow, typ, req_id, nbytes, ack_body, t0, dkey = info
                if (typ != APP_READ
                        and ((repl is not None and repl.holds(c.request_id))
                             or (mig is not None
                                 and mig.holds(c.request_id)))):
                    # Locally durable but the replica has not acked: HOLD
                    # the client ack (released below once the replica — or
                    # the supervisor dropping a dead replica — signs off).
                    body = ack_body if c.error == wire.E_OK else b""
                    self._held_acks[c.request_id] = (host_flow, req_id,
                                                     c.error, body, t0, dkey)
                    continue
                delta = now - t0
                if typ == APP_READ:
                    body = c.data if c.error == wire.E_OK else b""
                    r_add(delta)   # response-publish lifecycle stamp
                else:
                    body = ack_body if c.error == wire.E_OK else b""
                    w_add(delta)
                if host_flow.tenant:
                    tenant_add(host_flow.tenant,
                               "host_read" if typ == APP_READ else "write",
                               delta)
                resp = APP_RESP_HDR.pack(req_id, c.error, len(body)) + body
                if dkey is not None:
                    self._dedup_complete(dkey, resp)
                per_flow.setdefault(host_flow, []).append(resp)
                n += 1
        held = self._held_acks
        if held and (repl is not None or mig is not None):
            for rid in [r for r in held
                        if not (repl is not None and repl.holds(r))
                        and not (mig is not None and mig.holds(r))]:
                host_flow, req_id, err, body, t0, dkey = held.pop(rid)
                delta = now - t0
                w_add(delta)
                if host_flow.tenant:
                    tenant_add(host_flow.tenant, "write", delta)
                resp = APP_RESP_HDR.pack(req_id, err, len(body)) + body
                if dkey is not None:
                    self._dedup_complete(dkey, resp)
                per_flow.setdefault(host_flow, []).append(resp)
                n += 1
        if n:
            srv.host_cpu_busy_s += self.HOST_NET_US * 1e-6 * n  # response path
            for flow, batch in per_flow.items():
                srv.director.host_response_many(flow, batch)
        return n


# Unified-surface op spellings -> the wire batch kind ("r"/"w").
_OP_KIND = {"r": "r", "read": "r", "w": "w", "write": "w"}


class DDSClient:
    """A compute-server client for the benchmark app (batching, outstanding).

    ``tenant`` binds once per connection: every request issued through this
    client rides a flow carrying that tenant id, which the server's QoS
    layer (weighted-fair demux, token-bucket admission, per-tenant stats)
    keys on.  The unified burst surface is :meth:`submit` /
    :meth:`harvest`; ``write_many``/``send_batch`` remain as thin
    deprecated wrappers.
    """

    def __init__(self, server: DDSStorageServer, ip: str = "10.0.0.2",
                 port: int = 31337, tenant: int = 0,
                 timeout_ticks: int = 0):
        self.server = server
        self.flow = FiveTuple(ip, port, "10.0.0.1", server.config.server_port,
                              tenant=tenant)
        self.tenant = tenant
        self._resp_flow = self.flow.reversed()
        self._seq = 1  # after SYN
        self._next_req = 1
        self._lock = threading.Lock()
        self.responses: dict[int, tuple[int, bytes]] = {}
        self._rx_buf = bytearray()
        # Issue-tick stamps + end-to-end (issue -> drain) per-class latency
        # (read/write; the dpu/host split for reads is exact in the
        # server's lifecycle histograms).
        self._issued_r: dict[int, int] = {}
        self._issued_w: dict[int, int] = {}
        self.latency = ClientLatency()
        # Ring epoch this client believes in, stamped on every packet.  -1
        # (the default) means epoch-unaware: the director accepts untagged
        # packets unconditionally.  Epoch-aware clients (>= 0) additionally
        # keep each outstanding request's encoded message so an E_REDIRECT
        # can be answered by resubmitting the SAME request id.
        self.epoch = -1
        self._replay: dict[int, bytes] = {}
        # Lossy-wire recovery: after ``timeout_ticks`` of silence ``wait``
        # resends the request from its replay note with doubled backoff
        # (the server's dedup cache makes the resend exactly-once).  0 =
        # timeouts off (lossless-wire behavior, the default).
        self.timeout_ticks = timeout_ticks
        self.timeouts = 0
        self.resends = 0
        server.director.ingress.push(Packet(self.flow, 0, b"", flags=FLAG_SYN))
        server.signal()
        server.director.step()

    def _send(self, payload: bytes) -> None:
        pkt = Packet(self.flow, self._seq, payload, epoch=self.epoch)
        if self.server.director.stamp_checksums:
            pkt.csum = vector.checksum64(payload)
        self.server.director.ingress.push(pkt)
        self._seq += len(payload)
        self.server.signal()   # client sends are a scheduler wakeup source

    def read(self, file_id: int, offset: int, nbytes: int) -> int:
        with self._lock:
            rid = self._next_req
            self._next_req += 1
        self._issued_r[rid] = self.server.clock.now
        msg = encode_app_read(rid, file_id, offset, nbytes)
        if self.epoch >= 0 or self.timeout_ticks:
            self._replay[rid] = msg
        self._send(encode_batch([msg]))
        return rid

    def write(self, file_id: int, offset: int, data: bytes) -> int:
        with self._lock:
            rid = self._next_req
            self._next_req += 1
        self._issued_w[rid] = self.server.clock.now
        msg = encode_app_write(rid, file_id, offset, data)
        if self.epoch >= 0 or self.timeout_ticks:
            self._replay[rid] = msg
        self._send(encode_batch([msg]))
        return rid

    # -- unified burst surface --------------------------------------------------------
    def submit(self, ops: list[tuple]) -> list[int]:
        """Issue a burst of operations in ONE network message; returns one
        handle (request id) per op, in order.

        Ops are ``("r"|"read", file_id, offset, nbytes)`` or
        ``("w"|"write", file_id, offset, data)``.  The connection's tenant
        rides the flow, so tenant context is carried once per batch — never
        per call.  Harvest results with :meth:`harvest`.
        """
        return self.send_batch([(_OP_KIND[op[0]],) + tuple(op[1:])
                                for op in ops])

    def harvest(self, handles=None, block: bool = True,
                max_iters: int = 200_000) -> dict[int, tuple[int, bytes]]:
        """Collect responses: ``{handle: (status, body)}``.

        ``handles=None`` harvests whatever has already arrived (one drain;
        never pumps).  With explicit handles and ``block=True`` this pumps
        until EVERY handle resolves — requests the server shed terminally
        resolve as ``(wire.E_SHED, hint)`` where the hint decodes with
        :func:`repro_torch.core.wire.decode_shed_hint`.
        """
        self.collect()
        responses = self.responses
        if handles is None:
            out = dict(responses)
            responses.clear()
            return out
        out = {}
        lt = self.server.lifecycle
        pending = [rid for rid in handles if rid not in responses]
        for rid in handles:
            if rid in responses:
                out[rid] = responses.pop(rid)
        if not block:
            for rid in list(pending):
                term = lt.take_terminal(self.flow, rid)
                if term is not None:
                    self._issued_r.pop(rid, None)
                    self._issued_w.pop(rid, None)
                    self._replay.pop(rid, None)
                    out[rid] = term
                    pending.remove(rid)
            return out
        for rid in pending:
            out[rid] = self.wait(rid, max_iters)
        return {rid: out[rid] for rid in handles if rid in out}

    def send_batch(self, msgs: list[tuple]) -> list[int]:
        """msgs: list of ("r", fid, off, n) / ("w", fid, off, data).

        Deprecated spelling of :meth:`submit` (kept as a thin wrapper
        target; prefer ``submit``, which also accepts the long op names).
        """
        encoded, rids = [], []
        now = self.server.clock.now
        with self._lock:
            for m in msgs:
                rid = self._next_req
                self._next_req += 1
                rids.append(rid)
                if m[0] == "r":
                    encoded.append(encode_app_read(rid, m[1], m[2], m[3]))
                    self._issued_r[rid] = now
                else:
                    encoded.append(encode_app_write(rid, m[1], m[2], m[3]))
                    self._issued_w[rid] = now
        if self.epoch >= 0 or self.timeout_ticks:
            for rid, msg in zip(rids, encoded):
                self._replay[rid] = msg
        self._send(encode_batch(encoded))
        return rids

    def write_many(self, writes: list[tuple]) -> list[int]:
        """Issue a burst of ``(file_id, offset, data)`` writes in ONE
        network message — the write-side mirror of the cluster client's
        ``read_many``: one rid-range reservation, one batched send."""
        n = len(writes)
        with self._lock:
            first = self._next_req
            self._next_req += n
        rids = list(range(first, first + n))
        now = self.server.clock.now
        for rid in rids:
            self._issued_w[rid] = now
        self._send(encode_batch([encode_app_write(rid, fid, off, data)
                                 for rid, (fid, off, data)
                                 in zip(rids, writes)]))
        return rids

    # -- response collection ---------------------------------------------------------
    def collect(self) -> int:
        """Drain OUR flow's responses off the demuxed client wire (shared
        implementation with the cluster's shard connections)."""
        order: list[int] = []
        n = drain_client_flow(self.server.director, self._resp_flow,
                              self._rx_buf, self.responses, order)
        if order:
            self._record_latency(order)
        return n

    def _record_latency(self, rids: list[int]) -> None:
        """End-to-end issue->drain ticks, classified read/write at issue."""
        latency = self.latency
        now = self.server.clock.now
        reads = self._issued_r
        writes = self._issued_w
        for rid in rids:
            t0 = reads.pop(rid, None)
            if t0 is not None:
                latency.record("read", now - t0)
                continue
            t0 = writes.pop(rid, None)
            if t0 is not None:
                latency.record("write", now - t0)

    def wait(self, rid: int, max_iters: int = 200_000) -> tuple[int, bytes]:
        # ``pump()`` already polls the device whenever the offload engine or
        # the host path is busy; the old unconditional per-spin
        # ``device.poll()`` here was pure overhead on idle iterations.
        lt = self.server.lifecycle
        tmo = self.timeout_ticks
        clock = self.server.clock
        deadline = clock.now + tmo if tmo else None
        attempt = 0
        for _ in range(max_iters):
            self.collect()
            if rid in self.responses:
                self._replay.pop(rid, None)
                return self.responses.pop(rid)
            if deadline is not None and clock.now >= deadline:
                # Tick-based timeout: the request or its response was lost
                # on the wire.  Resend from the replay note with doubled
                # backoff — the server's dedup cache suppresses the copy
                # (or replays the cached ack) if the original survived.
                msg = self._replay.get(rid)
                if msg is not None:
                    self.timeouts += 1
                    self.resends += 1
                    self._send(encode_batch([msg]))
                attempt += 1
                deadline = clock.now + (tmo << min(attempt, 6))
            term = lt.take_terminal(self.flow, rid)
            if term is not None:
                code, hint = term
                if code == wire.E_REDIRECT and rid in self._replay:
                    # Retryable: adopt the repaired ring's epoch and
                    # resubmit the SAME request id (the old owner never
                    # answered it, so the id cannot alias).
                    self.epoch = max(self.epoch,
                                     wire.decode_redirect_hint(hint))
                    self._send(encode_batch([self._replay[rid]]))
                    continue
                # Terminal: the request was shed under overload or by
                # admission — no response will EVER arrive.  Surface it
                # (with the retry-after hint as the body) instead of
                # spinning the full iteration budget into a timeout.
                self._issued_r.pop(rid, None)
                self._issued_w.pop(rid, None)
                self._replay.pop(rid, None)
                return (code, hint)
            self.server.pump()
        raise TimeoutError(f"no response for request {rid}")
