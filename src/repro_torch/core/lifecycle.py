"""Deterministic request-lifecycle clock + tick-latency accounting.

The paper's headline claim is *latency* (§8, Figs 14a/15a: offloaded reads
complete in 780 us vs 11 ms on the host path) — but wall-clock latency of a
cooperative simulator measures the Python interpreter, not the system.  This
module provides the deterministic alternative:

``TickClock``
    A logical clock advanced ONCE per scheduling step — ``DDSCluster.pump``
    (every shard of a cluster shares its cluster's clock) or a standalone
    ``DDSStorageServer.pump`` / ``FileServiceRunner.step``.  Nothing reads
    wall time, so two identical runs produce byte-identical latency
    distributions (regression-tested).

``TickHistogram``
    An exact integer histogram (dict of tick-delta -> count) with
    deterministic ``percentile``; no sampling, no binning error.

``LifecycleTracker``
    Per-server request stamping across the whole data plane:

      client issue      (clients stamp their own ``issue`` ticks)
      wire ingress +    the ingress tick rides EXISTING per-request state —
      offload decision  the context-ring slot (a plain int) for offloaded
                        reads, the host app's in-flight meta tuple for
                        host-bound requests — so no stamp allocates
      device submit/    ``BlockDevice`` stamps every op (completion-latency
      complete          histogram in its stats)
      response publish  deltas land in the per-class histogram: offloaded
                        GET (``dpu_read``), host-served read (``host_read``)
                        or ``write``
      response drain    clients record end-to-end issue->drain ticks,
                        classified read/write at issue time (the
                        offloaded-vs-host split for reads lives in the
                        server-side histograms, where it is exact)

    A request shed under overload (the file service's bounded E_NOSPC
    emergency path gave up) gets a terminal ``shed`` mark instead of
    silently vanishing — clients surface it from ``take_shed`` rather than
    spinning into a timeout heuristic.

Everything here is deliberately allocation-light (int ticks, plain dicts)
because the stamps ride the hot path; a component whose ``lifecycle`` is
``None`` pays a single attribute test.
"""

from __future__ import annotations

from . import wire


class TickClock:
    """Monotonic logical clock; one tick per scheduling step."""

    __slots__ = ("now",)

    def __init__(self) -> None:
        self.now = 0

    def tick(self) -> int:
        self.now += 1
        return self.now


class TickHistogram:
    """Exact integer-delta histogram with deterministic percentiles.

    Deliberately nothing but the counts dict: an ``add`` is two dict ops
    (the stamp rides every completion on the data plane); sample count,
    total and mean are derived on demand.
    """

    __slots__ = ("counts",)

    def __init__(self) -> None:
        self.counts: dict[int, int] = {}

    def add(self, delta: int) -> None:
        c = self.counts
        c[delta] = c.get(delta, 0) + 1

    def add_many(self, delta: int, k: int) -> None:
        """Fold ``k`` samples of one delta (run-length burst completions)."""
        c = self.counts
        c[delta] = c.get(delta, 0) + k

    def merge(self, other: "TickHistogram") -> None:
        c = self.counts
        for d, k in other.counts.items():
            c[d] = c.get(d, 0) + k

    @property
    def n(self) -> int:
        return sum(self.counts.values())

    @property
    def total(self) -> int:
        return sum(d * k for d, k in self.counts.items())

    def percentile(self, p: float) -> int:
        """Smallest delta covering ``p`` percent of samples (exact)."""
        n = self.n
        if not n:
            return 0
        need = -(-n * p // 100)  # ceil(n * p / 100), integer math
        cum = 0
        d = 0
        for d in sorted(self.counts):
            cum += self.counts[d]
            if cum >= need:
                return d
        return d

    def mean(self) -> float:
        n = self.n
        return self.total / n if n else 0.0

    def as_dict(self) -> dict[str, int]:
        """JSON-stable exact histogram (sorted keys, str-keyed)."""
        return {str(d): self.counts[d] for d in sorted(self.counts)}

    def summary(self) -> dict:
        n = self.n
        return {
            "count": n,
            "mean": round(self.total / n, 3) if n else 0.0,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
            "max": max(self.counts) if self.counts else 0,
        }


# Terminal serving-path classes.
DPU_READ = "dpu_read"
HOST_READ = "host_read"
WRITE = "write"


class LifecycleTracker:
    """Per-server request stamping + per-class completion-tick histograms.

    The tracker itself keeps NO per-request state: ingress ticks ride
    existing per-request structures — the offload engine's context-ring
    slot for DPU reads (a plain int) and the host app's in-flight meta
    tuple for host-bound requests — so completion just computes a delta
    and bumps an exact histogram.  Only terminal SHED marks are stored
    here (there is no other structure left to carry them).
    """

    __slots__ = ("clock", "read_types", "_terminal", "hist", "sheds",
                 "redirects", "tenant_hist", "tenant_sheds")

    def __init__(self, clock: TickClock, read_types=None):
        self.clock = clock
        # Type bytes (msg[0]) that classify a message as a READ — a set
        # membership test instead of a per-message classifier call (the
        # stamp rides the host-path data plane).  The server passes the
        # §8.1 default; the KV app passes {KV_GET}.
        self.read_types = frozenset(read_types or ())
        # (flow, rid) -> (status code, hint bytes).  Terminal marks: no
        # response will ever arrive for these; the client synthesizes the
        # status.  E_SHED = dropped under overload/admission (hint = shed
        # hint); E_REDIRECT = stale ring epoch after a failover (hint =
        # redirect hint; retryable with the same request id).
        self._terminal: dict[tuple, tuple[int, bytes]] = {}
        self.hist: dict[str, TickHistogram] = {
            DPU_READ: TickHistogram(),
            HOST_READ: TickHistogram(),
            WRITE: TickHistogram(),
        }
        self.sheds = 0
        self.redirects = 0
        # Per-tenant split, recorded ONLY for nonzero tenants (tenant 0 is
        # the untenanted default and lives purely in the aggregate above),
        # so single-tenant deployments pay one int test per completion.
        self.tenant_hist: dict[int, dict[str, TickHistogram]] = {}
        self.tenant_sheds: dict[int, int] = {}

    # -- per-tenant completion stamps ---------------------------------------------
    def tenant_hist_for(self, tenant: int, cls: str) -> TickHistogram:
        per = self.tenant_hist.get(tenant)
        if per is None:
            per = self.tenant_hist[tenant] = {}
        h = per.get(cls)
        if h is None:
            h = per[cls] = TickHistogram()
        return h

    def add_tenant(self, tenant: int, cls: str, delta: int) -> None:
        self.tenant_hist_for(tenant, cls).add(delta)

    # -- terminal request status -------------------------------------------------
    def mark_shed(self, flow, rid: int, hint: bytes = b"") -> None:
        """The request was SHED (bounded E_NOSPC overload path gave up, or
        token-bucket admission refused it): no response will ever arrive.
        Clients poll ``take_shed`` instead of timing out.  ``hint`` is the
        retry-after body the client's E_SHED response will carry."""
        self._terminal[(flow, rid)] = (wire.E_SHED, hint)
        self.sheds += 1
        t = getattr(flow, "tenant", 0)
        if t:
            self.tenant_sheds[t] = self.tenant_sheds.get(t, 0) + 1

    def mark_redirect(self, flow, rid: int, hint: bytes = b"") -> None:
        """The request's routing is stale — it carried a pre-failover ring
        epoch, or its target shard died before answering.  ``hint`` is the
        redirect body (current ring epoch); the client retries the same
        request id against the repaired ring."""
        self._terminal[(flow, rid)] = (wire.E_REDIRECT, hint)
        self.redirects += 1

    def take_shed(self, flow, rid: int) -> bytes | None:
        """The shed hint for ``(flow, rid)``, or None if it was not shed.

        Distinguish with ``is not None`` — an empty hint is still a shed.
        Leaves non-shed terminal marks (redirects) in place for
        ``take_terminal`` consumers.
        """
        key = (flow, rid)
        entry = self._terminal.get(key)
        if entry is None or entry[0] != wire.E_SHED:
            return None
        del self._terminal[key]
        return entry[1]

    def take_terminal(self, flow, rid: int) -> tuple[int, bytes] | None:
        """Pop any terminal ``(status, hint)`` for ``(flow, rid)``."""
        return self._terminal.pop((flow, rid), None)

    def has_terminal(self) -> bool:
        """Whether ANY request is terminally marked (cheap probe)."""
        return bool(self._terminal)

    def summary(self) -> dict:
        out = {cls: h.summary() for cls, h in self.hist.items() if h.n}
        if self.sheds:
            out["sheds"] = self.sheds
        if self.redirects:
            out["redirects"] = self.redirects
        tenants = self._tenant_summary()
        if tenants:
            out["tenants"] = tenants
        return out

    def _tenant_summary(self) -> dict:
        out: dict[int, dict] = {}
        for t, per in sorted(self.tenant_hist.items()):
            ent = {cls: h.summary() for cls, h in per.items() if h.n}
            if ent:
                out[t] = ent
        for t, n in sorted(self.tenant_sheds.items()):
            out.setdefault(t, {})["sheds"] = n
        return out

    def histograms(self) -> dict:
        """Exact per-class histograms (determinism tests compare these)."""
        return {cls: h.as_dict() for cls, h in self.hist.items()}


class ClientLatency:
    """Client-side end-to-end (issue tick -> drain tick) per-class stats.

    Deltas are computed by the caller against its own clock reference (so
    clock adoption never needs to rebuild this object); this is just the
    per-class histogram bag."""

    __slots__ = ("hist",)

    def __init__(self) -> None:
        self.hist: dict[str, TickHistogram] = {}

    def hist_for(self, cls: str) -> TickHistogram:
        """The class histogram, created on first use (hoistable: callers on
        a hot drain loop bind ``hist_for(cls).add`` once per burst)."""
        h = self.hist.get(cls)
        if h is None:
            h = self.hist[cls] = TickHistogram()
        return h

    def record(self, cls: str, delta: int) -> None:
        self.hist_for(cls).add(delta)

    def summary(self) -> dict:
        return {cls: h.summary() for cls, h in sorted(self.hist.items())
                if h.n}

    def histograms(self) -> dict:
        return {cls: h.as_dict() for cls, h in sorted(self.hist.items())
                if h.n}
