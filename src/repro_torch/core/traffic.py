"""DDS traffic director (§5): bump-in-the-wire + PEP transport transparency.

No NIC exists inside a JAX container, so the transport is modeled with typed
packets on in-process wires — but the *semantics* the paper cares about are
implemented exactly:

  * **Application signature** (§5.1): a 5-tuple wildcard filter evaluated on
    packet headers.  Matching is "pushed down to the network interface": a
    non-matching packet is hardware-forwarded to the host with ZERO DPU-core
    latency added; only matching packets reach the director's cores.

  * **Offload predicate**: user code applied to packet payloads, producing a
    host list and a DPU list per network message (Table 1 ``OffPred``).

  * **PEP / TCP splitting** (§5.2): partial offloading breaks end-to-end
    sequence numbers (Fig 11) — if the DPU consumed bytes [132, 1064) of a
    flow, the host's TCP would see a gap and dup-ACK, forcing the client to
    resend everything that was offloaded.  The director therefore terminates
    the client connection at the DPU and opens a SECOND connection to the
    host with its own contiguous sequence space; host-bound requests are
    re-framed onto it.  ``TCPReceiver`` models the host stack so tests can
    show dup-ACKs with a naive splitter and none with the PEP.

  * **RSS** (§7): flows are mapped to director cores by a SYMMETRIC 5-tuple
    hash, so host responses in a split connection are handled by the same
    core that split it — no cross-core connection state.

Latency accounting is *modeled* (BF-2 measurements from §5.3: ~6 us to
forward a packet via an Arm core, ~10 us round trip for a matched packet
that fails the predicate); nothing sleeps.
"""

from __future__ import annotations

import bisect
import struct
import threading
from collections import deque
from dataclasses import dataclass, field
from itertools import repeat
from typing import Callable

from repro_torch.core.vector import checksum64

# Modeled BF-2 constants (§5.3).
ARM_FORWARD_LATENCY_S = 6e-6
PREDICATE_FAIL_RTT_S = 10e-6
TLDK_PER_PKT_S = 2e-6     # userspace stack per-packet cost on an Arm core
LINUX_TCP_PER_PKT_S = 25e-6  # kernel stack on the DPU (Fig 19: ~3x worse)

FLAG_SYN = 1
FLAG_ACK = 2
FLAG_FIN = 4


@dataclass(frozen=True)
class FiveTuple:
    """Flow identity: the classic 5-tuple plus a first-class ``tenant`` id.

    The tenant rides the flow (it is part of identity and hashing): a
    client binds its tenant once at connection time, and every request,
    split host connection, and response inherits it — the wire format
    the QoS layer (weighted-fair demux, token-bucket admission, per-tenant
    histograms) keys on.  ``tenant == 0`` is the untenanted default.
    """

    src_ip: str
    src_port: int
    dst_ip: str
    dst_port: int
    proto: str = "tcp"
    tenant: int = 0

    def __post_init__(self):
        # Flows key every hot-path dict (connections, demux queues); caching
        # the hash beats re-tupling six fields on each lookup.
        object.__setattr__(self, "_hash", hash(
            (self.src_ip, self.src_port, self.dst_ip, self.dst_port,
             self.proto, self.tenant)))

    def __hash__(self) -> int:
        return self._hash

    def reversed(self) -> "FiveTuple":
        return FiveTuple(self.dst_ip, self.dst_port, self.src_ip,
                         self.src_port, self.proto, self.tenant)


def _flow_order(ft: FiveTuple) -> tuple:
    """Deterministic total order over flows (fair drains iterate sorted)."""
    return (ft.tenant, ft.src_ip, ft.src_port, ft.dst_ip, ft.dst_port,
            ft.proto)


@dataclass(slots=True)
class Packet:
    flow: FiveTuple
    seq: int                 # first byte's sequence number
    payload: bytes | memoryview
    flags: int = 0
    ack: int = 0
    # Indirect-packet buffer ownership (Fig 12): ``(pool, off, len)`` set on
    # the LAST packet referencing a pool allocation.  The wire consumer
    # releases it AFTER copying the payload out — like a NIC TX-completion —
    # so pool memory is never rewritten under an in-flight packet.
    pool_ref: tuple | None = None
    # Ring epoch the sender routed under (-1 = untagged: standalone clients
    # and control traffic skip epoch fencing entirely).  A tagged packet
    # older than the receiving director's current epoch is answered with a
    # terminal redirect instead of being served — post-failover, the keys it
    # addressed may live on a different shard.
    epoch: int = -1
    # Frame checksum (``vector.checksum64`` of the payload; -1 = unstamped).
    # Stamped by senders when wire checksums are armed; a receiver that
    # finds a mismatch DISCARDS the frame — a corrupt frame is a lost
    # frame, recovered by the client's timeout/resend layer, never parsed.
    csum: int = -1

    @property
    def nbytes(self) -> int:
        return len(self.payload)

    def consumed(self) -> None:
        """Release the backing pool block (no-op for direct packets)."""
        ref = self.pool_ref
        if ref is not None:
            self.pool_ref = None
            ref[0].release(ref[1], ref[2])


@dataclass
class ApplicationSignature:
    """5-tuple wildcard filter; None = match-any (§5.1 example)."""
    src_ip: str | None = None
    src_port: int | None = None
    dst_ip: str | None = None
    dst_port: int | None = None
    proto: str | None = "tcp"

    def matches(self, ft: FiveTuple) -> bool:
        return ((self.src_ip is None or self.src_ip == ft.src_ip)
                and (self.src_port is None or self.src_port == ft.src_port)
                and (self.dst_ip is None or self.dst_ip == ft.dst_ip)
                and (self.dst_port is None or self.dst_port == ft.dst_port)
                and (self.proto is None or self.proto == ft.proto))


class Wire:
    """A unidirectional link: thread-safe packet queue."""

    def __init__(self, name: str):
        self.name = name
        self._q: deque[Packet] = deque()
        self._lock = threading.Lock()

    def push(self, pkt: Packet) -> None:
        with self._lock:
            self._q.append(pkt)

    def push_many(self, pkts: list[Packet]) -> None:
        """Append a burst under a single lock round."""
        with self._lock:
            self._q.extend(pkts)

    def pop(self) -> Packet | None:
        with self._lock:
            return self._q.popleft() if self._q else None

    def pop_many(self, n: int) -> list[Packet]:
        """Pop up to ``n`` packets under ONE lock round (burst processing)."""
        if not self._q:   # racy-but-safe emptiness peek: skip the lock
            return []
        with self._lock:
            q = self._q
            if not q:
                return []
            k = min(n, len(q))
            return [q.popleft() for _ in range(k)]

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)

    def __bool__(self) -> bool:
        # Lock-free emptiness peek (same contract as ``pop_many``'s): the
        # scheduler's busy-predicates probe wires on every idle check, where
        # a lock round per probe would double the cost of being idle.
        return bool(self._q)


class FlowDemuxWire:
    """A wire demultiplexed by destination flow: per-flow FIFO queues.

    The director's response wire carries every client's packets; a single
    shared queue forces each client to pop-and-requeue everyone else's
    traffic (O(clients x packets) per drain).  Demuxing gives each client an
    O(1) ``pop_flow``/``drain_flow`` on its own queue while per-flow FIFO
    order — the only order TCP guarantees — is preserved.
    """

    def __init__(self, name: str):
        self.name = name
        self._q: dict[FiveTuple, deque[Packet]] = {}
        self._lock = threading.Lock()
        self._len = 0
        # Tenant service weights for the fair drain (``pop_many``); None
        # means every tenant weighs ``1``.  Installed by the owning server
        # from its QoSProfile.
        self.weight_of: Callable[[int], int] | None = None
        self._next_tenant = 0   # fair-drain resume point (bounded starvation)

    def push(self, pkt: Packet) -> None:
        with self._lock:
            dq = self._q.get(pkt.flow)
            if dq is None:
                dq = self._q[pkt.flow] = deque()
            dq.append(pkt)
            self._len += 1

    def push_many(self, flow: FiveTuple, pkts: list[Packet]) -> None:
        """Append a burst for one flow under a single lock round."""
        with self._lock:
            dq = self._q.get(flow)
            if dq is None:
                dq = self._q[flow] = deque()
            dq.extend(pkts)
            self._len += len(pkts)

    def pop_flow(self, flow: FiveTuple) -> Packet | None:
        if not self._q.get(flow):   # racy-but-safe emptiness peek
            return None
        with self._lock:
            dq = self._q.get(flow)
            if not dq:
                return None
            self._len -= 1
            return dq.popleft()

    def drain_flow(self, flow: FiveTuple) -> list[Packet]:
        """Take EVERY queued packet for ``flow`` in one O(1) swap."""
        if not self._q.get(flow):   # racy-but-safe emptiness peek
            return []
        with self._lock:
            dq = self._q.get(flow)
            if not dq:
                return []
            out = list(dq)
            dq.clear()
            self._len -= len(out)
            return out

    def pop(self) -> Packet | None:
        """Pop from any non-empty flow (per-flow FIFO; cross-flow unordered)."""
        with self._lock:
            for dq in self._q.values():
                if dq:
                    self._len -= 1
                    return dq.popleft()
            return None

    def pop_many(self, n: int) -> list[Packet]:
        """Pop up to ``n`` packets, weighted-fairly ACROSS TENANTS.

        Per-flow FIFO (the only order TCP guarantees) is always preserved.
        With one backlogged flow this is exactly a FIFO burst pop; with
        several, service rotates tenant-by-tenant — each backlogged tenant
        takes up to ``weight_of(tenant)`` packets per round, its flows
        round-robined one packet at a time — so a flooding tenant's backlog
        cannot monopolize a drain slice.  The rotation resumes where the
        previous call stopped (``_next_tenant``), bounding starvation
        across calls even when ``n`` is smaller than the tenant count.
        """
        if self._len == 0 or n <= 0:
            return []
        with self._lock:
            live = [f for f, dq in self._q.items() if dq]
            if not live:
                return []
            if len(live) == 1:
                dq = self._q[live[0]]
                k = min(n, len(dq))
                out = [dq.popleft() for _ in range(k)]
                self._len -= k
                return out
            live.sort(key=_flow_order)
            # Group the (sorted) flows by tenant, preserving flow order.
            tenants: list[int] = []
            flows_of: dict[int, list[deque]] = {}
            for f in live:
                g = flows_of.get(f.tenant)
                if g is None:
                    g = flows_of[f.tenant] = []
                    tenants.append(f.tenant)
                g.append(self._q[f])
            # Rotate so service resumes after the last tenant served.
            i = bisect.bisect_left(tenants, self._next_tenant)
            tenants = tenants[i:] + tenants[:i]
            weight_of = self.weight_of
            out: list[Packet] = []
            budget = n
            while budget > 0 and tenants:
                alive: list[int] = []
                for ti, t in enumerate(tenants):
                    quantum = weight_of(t) if weight_of is not None else 1
                    if quantum > budget:
                        quantum = budget
                    group = flows_of[t]
                    took = 1
                    while quantum > 0 and took:
                        took = 0
                        for dq in group:
                            if not dq:
                                continue
                            out.append(dq.popleft())
                            took += 1
                            quantum -= 1
                            if quantum <= 0:
                                break
                    if any(group):
                        alive.append(t)
                    budget = n - len(out)
                    if budget <= 0:
                        nxt = tenants[ti + 1] if ti + 1 < len(tenants) \
                            else tenants[0]
                        self._next_tenant = nxt
                        break
                else:
                    tenants = alive
                    continue
                break
            self._len -= len(out)
            return out

    def flows(self) -> list[FiveTuple]:
        with self._lock:
            return [f for f, dq in self._q.items() if dq]

    def __len__(self) -> int:
        with self._lock:
            return self._len

    def __bool__(self) -> bool:
        return self._len > 0   # racy-but-safe peek (int read is atomic)


class TenantFairQueue:
    """The director's offload queue, demultiplexed per tenant.

    PR 5's priority demux put offloaded reads ahead of host work — but the
    offload queue itself was one FIFO, so a flooding tenant's GETs filled
    it and a well-behaved tenant's reads queued behind ALL of them.  This
    queue keys requests by ``flow.tenant`` and serves them weighted
    round-robin: each ``take`` round gives every backlogged tenant up to
    ``weight_of(tenant)`` requests, resuming across calls where the last
    take stopped, so no tenant is ever starved and the queue stays
    work-conserving (an idle tenant's share flows to the backlogged ones).

    Single-tenant behavior is EXACTLY the old FIFO (same pop order), so
    untenanted deployments keep byte-identical schedules.  Items are the
    director's ``(flow, msg)`` pairs.  Single-threaded by design: the
    queue is only touched from the owning server's pump (same discipline
    as the plain deque it replaces).
    """

    __slots__ = ("weight_of", "_q", "_next_tenant", "_len")

    def __init__(self, weight_of: Callable[[int], int] | None = None):
        self.weight_of = weight_of
        self._q: dict[int, deque] = {}
        self._next_tenant = 0
        self._len = 0

    def append(self, item: tuple[FiveTuple, bytes]) -> None:
        t = item[0].tenant
        dq = self._q.get(t)
        if dq is None:
            dq = self._q[t] = deque()
        dq.append(item)
        self._len += 1

    def extend_flow(self, flow: FiveTuple, msgs: list) -> None:
        """Enqueue one flow's whole message burst: one tenant lookup, and
        the (flow, msg) pairs are built by C-level ``zip`` instead of a
        Python tuple per message."""
        t = flow.tenant
        dq = self._q.get(t)
        if dq is None:
            dq = self._q[t] = deque()
        dq.extend(zip(repeat(flow), msgs))
        self._len += len(msgs)

    def take(self, budget: int) -> list[tuple[FiveTuple, bytes]]:
        """Take up to ``budget`` requests, weighted-fairly across tenants."""
        if self._len == 0 or budget <= 0:
            return []
        q = self._q
        active = [t for t in q if q[t]]
        if len(active) == 1:
            dq = q[active[0]]
            if len(dq) <= budget:
                out = list(dq)
                dq.clear()
            else:
                out = [dq.popleft() for _ in range(budget)]
            self._len -= len(out)
            return out
        active.sort()
        i = bisect.bisect_left(active, self._next_tenant)
        active = active[i:] + active[:i]
        weight_of = self.weight_of
        out: list = []
        while active and len(out) < budget:
            alive: list[int] = []
            exhausted = False
            for ti, t in enumerate(active):
                dq = q[t]
                quantum = weight_of(t) if weight_of is not None else 1
                k = min(quantum, budget - len(out), len(dq))
                for _ in range(k):
                    out.append(dq.popleft())
                if dq:
                    alive.append(t)
                if len(out) >= budget:
                    self._next_tenant = (active[ti + 1]
                                         if ti + 1 < len(active)
                                         else active[0])
                    exhausted = True
                    break
            if exhausted:
                break
            active = alive
        self._len -= len(out)
        return out

    def tenants(self) -> list[int]:
        """Backlogged tenant ids (observability/tests)."""
        return sorted(t for t, dq in self._q.items() if dq)

    def clear(self) -> None:
        self._q.clear()
        self._len = 0

    def __len__(self) -> int:
        return self._len

    def __bool__(self) -> bool:
        # Lock-free peek, same contract as Wire.__bool__ (busy-predicates).
        return self._len > 0


class TCPReceiver:
    """Host TCP receive model: detects sequence gaps and duplicate-ACKs.

    This exists to demonstrate (and regression-test) Fig 11: with a naive
    bump-in-the-wire that silently consumes offloaded bytes, the host sees a
    gap and dup-ACKs, forcing client retransmission of offloaded data.
    """

    def __init__(self):
        self.expected_seq = 0
        self.dup_acks = 0
        self.delivered: list[bytes] = []
        self.acked: int = 0

    def receive(self, pkt: Packet) -> tuple[bool, int]:
        """Returns (accepted, ack_number)."""
        if pkt.flags & FLAG_SYN:
            self.expected_seq = pkt.seq + 1
            self.acked = self.expected_seq
            return True, self.acked
        if pkt.seq != self.expected_seq:
            self.dup_acks += 1          # fast-recovery trigger
            return False, self.acked    # duplicate ACK of the old edge
        self.expected_seq += pkt.nbytes
        self.acked = self.expected_seq
        self.delivered.append(bytes(pkt.payload))
        return True, self.acked


def rss_core(ft: FiveTuple, ncores: int) -> int:
    """Symmetric RSS hash: both directions of a flow land on one core (§7)."""
    a = (ft.src_ip, ft.src_port)
    b = (ft.dst_ip, ft.dst_port)
    lo, hi = (a, b) if a <= b else (b, a)
    h = hash((lo, hi, ft.proto)) & 0x7FFFFFFF
    return h % max(1, ncores)


@dataclass
class _PEPConnection:
    """State for one split client connection (client<->DPU, DPU<->host)."""
    client_flow: FiveTuple
    client_next_seq: int = 0     # next byte expected from the client
    client_resp_seq: int = 0     # next byte we send toward the client
    host_next_seq: int = 0       # next byte on the DPU->host connection
    core: int = 0
    resp_flow: FiveTuple | None = None  # cached reversed flow (response dst)


@dataclass
class DirectorStats:
    hw_forwarded: int = 0         # packets bypassing DPU cores (NIC match miss)
    inspected: int = 0
    to_host: int = 0              # messages re-framed to the host connection
    to_dpu: int = 0               # messages handed to the offload engine
    resp_from_host: int = 0
    resp_from_dpu: int = 0
    admission_shed: int = 0       # requests dropped by token-bucket admission
    corrupt_dropped: int = 0      # checksum-failed frames discarded as losses
    seq_resyncs: int = 0          # PEP resyncs past a gap left by lost frames
    dpu_bypassed: int = 0         # messages host-routed because the DPU failed
    modeled_time_s: float = 0.0
    per_core_pkts: dict[int, int] = field(default_factory=dict)


class TrafficDirector:
    """The DDS bump-in-the-wire packet processor."""

    def __init__(self, signature: ApplicationSignature,
                 off_pred: Callable[[bytes, object], tuple[list[bytes], list[bytes]]],
                 cache_table: object | None = None,
                 ncores: int = 1,
                 host_port: int = 9999,
                 userspace_stack: bool = True):
        self.signature = signature
        self.off_pred = off_pred
        self.cache_table = cache_table
        self.ncores = ncores
        self.host_port = host_port
        self.per_pkt_cost = TLDK_PER_PKT_S if userspace_stack else LINUX_TCP_PER_PKT_S
        # Wires: ingress (from NIC), to-host, to-client, and the offload
        # queue.  ``to_host`` is flow-demuxed so its drain is tenant-fair
        # (same per-flow FIFO guarantee a TCP connection provides); the
        # offload queue is tenant-demuxed with weighted round-robin take.
        self.ingress = Wire("nic-ingress")
        self.to_host = FlowDemuxWire("dpu->host")
        self.from_host = Wire("host->dpu")
        self.to_client = FlowDemuxWire("dpu->client")
        self.offload_queue = TenantFairQueue()
        # Tenancy hooks, installed by the owning server when admission is
        # configured (QoSProfile): ``admit(tenant, n) -> granted`` and
        # ``on_shed(client_flow, msg)`` for each dropped request.  None
        # means admit-all (the untenanted default pays one attribute test).
        self.admit: Callable[[int, int], int] | None = None
        self.on_shed: Callable[[FiveTuple, bytes], None] | None = None
        # Ring-epoch fence, installed by the owning server when it joins a
        # replicated cluster: ``epoch_of() -> int`` is the current ring
        # epoch; a tagged packet with an older epoch is handed WHOLE to
        # ``on_stale_epoch(client_flow, payload, current)`` (the server
        # marks each request terminally redirected) and never served.  The
        # director stays policy-free: it only compares integers.
        self.epoch_of: Callable[[], int] | None = None
        self.on_stale_epoch: Callable[[FiveTuple, object, int], None] | None = None
        # Wire-checksum stamping for response frames (armed by the owning
        # server when ``ServerConfig.wire_checksums`` is set).  Ingress
        # verification needs no flag: a stamped frame (``csum != -1``) is
        # always verified, an unstamped one never is.
        self.stamp_checksums = False
        # DPU-failure bypass: when the offload engine dies
        # (``OffloadEngine.fail()``), every message the predicate would
        # have offloaded is re-routed to the host path instead, counted in
        # ``stats.dpu_bypassed``.  PEP, admission and the epoch fence stay
        # in force — only the DPU leg is gone.
        self.dpu_bypass = False
        self._conns: dict[FiveTuple, _PEPConnection] = {}
        self._host_flow_of: dict[FiveTuple, FiveTuple] = {}
        self._client_flow_of: dict[FiveTuple, FiveTuple] = {}  # reverse map
        self.stats = DirectorStats()
        self._lock = threading.Lock()

    # -- connection management ------------------------------------------------------
    def _conn(self, ft: FiveTuple) -> _PEPConnection:
        c = self._conns.get(ft)
        if c is None:
            c = _PEPConnection(ft, core=rss_core(ft, self.ncores),
                               resp_flow=ft.reversed())
            self._conns[ft] = c
            # Second connection of the split: DPU -> host, own seq space.
            # The client's tenant rides onto it, so host-path scheduling
            # and per-tenant stats stay attributable after the split.
            host_flow = FiveTuple("dpu-proxy", 40000 + len(self._conns),
                                  "host", self.host_port, ft.proto,
                                  tenant=ft.tenant)
            self._host_flow_of[ft] = host_flow
            self._client_flow_of[host_flow] = ft
        return c

    def busy(self) -> bool:
        """True while the director holds undelivered DPU-side work.

        This is one wakeup source of the cluster's work-signaled scheduler
        (see ``DDSCluster``): a server whose director has queued ingress
        packets, undrained offload requests, or host-bound packets must stay
        runnable.  All three probes are lock-free emptiness peeks — the
        predicate is evaluated on every idle re-arm check.  ``to_client`` is
        deliberately NOT included: undrained responses are the *client's*
        work, and pumping the server cannot make progress on them.
        """
        return bool(self.ingress) or bool(self.offload_queue) or bool(self.to_host)

    # -- ingress processing ---------------------------------------------------------
    def step(self) -> bool:
        """Process ONE ingress packet (kept for single-step tests)."""
        return self.step_n(1) > 0

    def step_n(self, budget: int = 64) -> int:
        """Process an ingress burst under one lock round (§6.1 batching).

        Per-packet accounting (inspected/hw-forwarded counts, modeled Arm
        time) is accumulated locally and folded into ``stats`` once per
        burst, so the bookkeeping cost is amortized across the batch.
        Returns the number of packets processed.
        """
        pkts = self.ingress.pop_many(budget)
        if not pkts:
            return 0
        st = self.stats
        off_q = self.offload_queue
        admit = self.admit
        inspected = hw_forwarded = to_dpu = adm_shed = 0
        modeled = 0.0
        for pkt in pkts:
            # Stage 0: wire-checksum verify.  A stamped frame that fails is
            # DISCARDED before any state is touched — corrupt frames behave
            # exactly like lost frames (the seq gap below resyncs past it
            # and the client's timeout layer resends the request).
            if pkt.csum != -1 and checksum64(pkt.payload) != pkt.csum:
                st.corrupt_dropped += 1
                continue
            # Stage 1: application signature, evaluated in NIC hardware (§5.3).
            if not self.signature.matches(pkt.flow):
                hw_forwarded += 1
                self.to_host.push(pkt)  # line-rate forward; no Arm latency
                continue
            conn = self._conn(pkt.flow)
            inspected += 1
            st.per_core_pkts[conn.core] = (
                st.per_core_pkts.get(conn.core, 0) + 1)
            modeled += self.per_pkt_cost
            if pkt.flags & FLAG_SYN:
                conn.client_next_seq = pkt.seq + 1
                continue
            if pkt.seq != conn.client_next_seq:
                if pkt.seq < conn.client_next_seq:
                    continue  # dup / stale retransmit: PEP suppresses it
                # Sequence GAP: frames were lost (or corrupt-discarded)
                # below the PEP.  The PEP models TCP's receive edge — the
                # lost request bytes are unrecoverable at this layer, so
                # resync to the new edge and let the client's timeout
                # resend the affected requests (under fresh seq numbers).
                st.seq_resyncs += 1
                conn.client_next_seq = pkt.seq
            conn.client_next_seq += pkt.nbytes
            if pkt.epoch >= 0 and self.epoch_of is not None:
                cur = self.epoch_of()
                if pkt.epoch < cur:
                    # Stale ring epoch: the sender routed before a failover
                    # repaired the ring.  Refuse the whole batch — serving
                    # it could apply writes to a demoted replica set.
                    if self.on_stale_epoch is not None:
                        self.on_stale_epoch(pkt.flow, pkt.payload, cur)
                    continue
            # Stage 2: the offload predicate inspects the payload (zero-copy:
            # the predicate sees the packet buffer itself, never a copy).
            host_msgs, dpu_msgs = self.off_pred(pkt.payload, self.cache_table)
            if dpu_msgs and self.dpu_bypass:
                # DPU path is down: everything the predicate offloaded is
                # served by the host instead (graceful degradation).
                st.dpu_bypassed += len(dpu_msgs)
                host_msgs = (host_msgs + dpu_msgs) if host_msgs else dpu_msgs
                dpu_msgs = []
            if admit is not None and (host_msgs or dpu_msgs):
                # Token-bucket admission, applied at the demux — BEFORE a
                # request can occupy a context-ring slot or device queue
                # entry.  Offloaded (latency-critical) requests draw tokens
                # first; everything over the grant is shed terminally via
                # ``on_shed`` (the server marks it E_SHED with a
                # retry-after hint for the client).
                n_off = len(host_msgs) + len(dpu_msgs)
                granted = admit(pkt.flow.tenant, n_off)
                if granted < n_off:
                    keep_dpu = min(granted, len(dpu_msgs))
                    keep_host = granted - keep_dpu
                    on_shed = self.on_shed
                    if on_shed is not None:
                        for m in dpu_msgs[keep_dpu:]:
                            on_shed(pkt.flow, m)
                        for m in host_msgs[keep_host:]:
                            on_shed(pkt.flow, m)
                    adm_shed += n_off - granted
                    dpu_msgs = dpu_msgs[:keep_dpu]
                    host_msgs = host_msgs[:keep_host]
            if host_msgs:
                self._send_to_host_many(conn, pkt.flow, host_msgs)
            if dpu_msgs:
                to_dpu += len(dpu_msgs)
                off_q.extend_flow(pkt.flow, dpu_msgs)
            elif host_msgs:
                # matched the signature but fully host-bound: paid the round trip
                modeled += PREDICATE_FAIL_RTT_S - self.per_pkt_cost
        st.hw_forwarded += hw_forwarded
        st.inspected += inspected
        st.to_dpu += to_dpu
        st.admission_shed += adm_shed
        st.modeled_time_s += modeled
        return len(pkts)

    def _send_to_host(self, conn: _PEPConnection, client_flow: FiveTuple,
                      msg: bytes) -> None:
        """Re-frame a host-bound message onto the split DPU->host connection.

        The host connection's sequence numbers stay CONTIGUOUS even though
        the DPU consumed some client bytes — transport transparency.
        """
        host_flow = self._host_flow_of[client_flow]
        self.to_host.push(Packet(host_flow, conn.host_next_seq, msg))
        conn.host_next_seq += len(msg)
        self.stats.to_host += 1
        self.stats.modeled_time_s += ARM_FORWARD_LATENCY_S

    def _send_to_host_many(self, conn: _PEPConnection, client_flow: FiveTuple,
                           msgs: list) -> None:
        """Burst form of ``_send_to_host``: each message still becomes its
        own packet on the split connection (same protocol, same per-message
        modeled Arm forwarding cost), but the wire is taken once."""
        host_flow = self._host_flow_of[client_flow]
        seq = conn.host_next_seq
        pkts = []
        for m in msgs:
            pkts.append(Packet(host_flow, seq, m))
            seq += len(m)
        conn.host_next_seq = seq
        self.to_host.push_many(host_flow, pkts)
        self.stats.to_host += len(msgs)
        self.stats.modeled_time_s += ARM_FORWARD_LATENCY_S * len(msgs)

    # -- response paths -----------------------------------------------------------------
    def host_response(self, host_flow: FiveTuple, msg: bytes) -> None:
        """A response from the host app on the second connection.

        The split connection is resolved with an O(1) reverse lookup; a flow
        with no split (hardware-forwarded) responds on the client flow.
        """
        client_flow = self._client_flow_of.get(host_flow, host_flow)
        self._respond_to_client(client_flow, msg)
        self.stats.resp_from_host += 1

    def host_response_many(self, host_flow: FiveTuple, msgs: list) -> None:
        """A burst of host responses for ONE split connection.

        Sequence numbers are stamped in one pass and the packets enqueued
        on the client's demuxed queue under a single lock round — the
        response-side mirror of ``dpu_response``'s burst handling."""
        client_flow = self._client_flow_of.get(host_flow, host_flow)
        conn = self._conn(client_flow)
        resp_flow = conn.resp_flow
        seq = conn.client_resp_seq
        stamp = self.stamp_checksums
        pkts = []
        for msg in msgs:
            pkts.append(Packet(resp_flow, seq, msg,
                               csum=checksum64(msg) if stamp else -1))
            seq += len(msg)
        conn.client_resp_seq = seq
        self.to_client.push_many(resp_flow, pkts)
        self.stats.resp_from_host += len(msgs)

    def dpu_response(self, client_flow: FiveTuple, packets: list[Packet],
                     responses: int = 1) -> None:
        """Responses produced by the offload engine (already segmented).

        A burst may carry the packets of several back-to-back responses for
        one flow (``responses`` keeps the per-response stat exact): the
        whole burst is stamped with contiguous sequence numbers and enqueued
        on the client's demuxed queue in one lock round.
        """
        conn = self._conn(client_flow)
        resp_flow = conn.resp_flow
        seq = conn.client_resp_seq
        stamp = self.stamp_checksums
        for p in packets:
            p.flow = resp_flow
            p.seq = seq
            seq += len(p.payload)
            if stamp:
                p.csum = checksum64(p.payload)
        conn.client_resp_seq = seq
        self.to_client.push_many(resp_flow, packets)
        self.stats.resp_from_dpu += responses

    def _respond_to_client(self, client_flow: FiveTuple, msg: bytes) -> None:
        conn = self._conn(client_flow)
        self.to_client.push(Packet(
            conn.resp_flow, conn.client_resp_seq, msg,
            csum=checksum64(msg) if self.stamp_checksums else -1))
        conn.client_resp_seq += len(msg)

    def drain_host_wire(self, deliver: Callable[[FiveTuple, bytes], None],
                        max_pkts: int | None = None) -> int:
        """Pump packets that crossed to the host into the host application.

        Payloads are handed over as-is (possibly ``memoryview`` slices of
        the client's packet buffer): whether to materialize is the host
        application's call — the write path rides views all the way into
        the request ring (zero-copy end to end).

        ``max_pkts`` bounds the drain slice: one hot flow's backlog cannot
        monopolize a whole pump step — the remainder stays queued (and
        ``busy()`` keeps the server runnable), so other flows' already-
        completed work gets its response-publish turn this step."""
        n = 0
        while True:
            budget = 64 if max_pkts is None else min(64, max_pkts - n)
            if budget <= 0:
                return n
            pkts = self.to_host.pop_many(budget)
            if not pkts:
                return n
            for pkt in pkts:
                deliver(pkt.flow, pkt.payload)
            n += len(pkts)


class NaiveSplitter:
    """A broken bump-in-the-wire WITHOUT the PEP, for the Fig 11 test.

    Offloaded bytes are silently consumed; host-bound packets keep their
    ORIGINAL client sequence numbers, so the host receiver sees gaps.
    """

    def __init__(self, off_pred):
        self.off_pred = off_pred
        self.offloaded: list[bytes] = []

    def process(self, pkt: Packet, host: TCPReceiver) -> tuple[bool, int]:
        host_msgs, dpu_msgs = self.off_pred(bytes(pkt.payload), None)
        if dpu_msgs and not host_msgs:
            self.offloaded.append(bytes(pkt.payload))
            return True, host.acked  # consumed on the DPU; host never sees it
        return host.receive(pkt)     # gap => dup-ACK
