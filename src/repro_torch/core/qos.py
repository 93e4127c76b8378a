"""Multi-tenant QoS policy: the collapsed server tuning surface + admission.

PRs 3-5 grew ``ServerConfig`` one knob at a time (write coalescing, response
delivery age, device priority interleave, host drain slice, read/write
fence).  This module collapses them — plus the tenancy controls introduced
with first-class ``tenant_id`` — into ONE validated, frozen dataclass with
named presets, so a deployment picks a *policy* instead of re-deriving six
interacting integers:

``QoSProfile``
    Every scheduling/batching knob the server honors, validated on
    construction (``from_dict`` additionally rejects unknown fields, so a
    typo'd config key is an error instead of a silently ignored default).

    Presets (``QoSProfile.preset(name)`` / ``ServerConfig(qos="latency")``):

      * ``latency``    — flush everything immediately: no write-run or
        response aging, small drain slices, a large normal-queue reserve so
        nothing sits behind a priority burst.
      * ``throughput`` — batch aggressively: long coalescing runs, deep
        device polls, wide drain slices.
      * ``isolation``  — the defaults plus tenancy enforcement ON: every
        tenant is weighted equally and admission-limited by a per-tenant
        token bucket, so an adversarial neighbor sheds instead of queueing.

``TokenBucket`` / ``TenantAdmission``
    Per-tenant admission control at the traffic director: each admitted
    request costs one token; buckets refill at ``rate`` tokens per tick of
    the deterministic scheduler clock up to ``burst``.  Over-limit requests
    are shed EARLY — at the demux, before they occupy a context-ring slot
    or a device queue entry — and the client sees a terminal ``E_SHED``
    carrying the bucket's retry-after hint.  Conservation holds exactly:
    ``granted + shed == offered`` (property-tested).

Weights (weighted-fair demux share) and rates (admission) are independent:
weights divide *service order* among backlogged tenants; rates bound how
much work a tenant may have admitted at all.  ``rate == 0`` means
unlimited (no bucket), the single-tenant default.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields, replace


@dataclass(frozen=True)
class QoSProfile:
    """Validated scheduling/batching/tenancy policy for one storage server.

    All knobs that tune the *data plane's* scheduling live here; structural
    sizing (device capacity, ring sizes, pool sizes) stays on
    :class:`~repro_torch.core.dds_server.ServerConfig`.
    """

    # -- device scheduling (PR 5) -------------------------------------------
    device_queue_depth: int = 128      # per-poll completion budget
    prio_interleave: int = 4           # normal-queue reserve: budget // N
    # -- write coalescing + response delivery (PR 3/5) ----------------------
    coalesce_ticks: int = 2            # held write-run age bound
    coalesce_cap: int = 256            # max requests per coalesced run
    deliver_ticks: int = 2             # completed-response age bound
    host_drain_slice: int = 256        # host-wire packets per pump step
    read_write_fence: bool = False     # bounce reads of write-busy files
    # -- tenancy: weighted-fair service share -------------------------------
    default_weight: int = 1
    tenant_weights: dict = field(default_factory=dict)   # tenant -> weight
    # -- tenancy: token-bucket admission (0 == unlimited) -------------------
    default_rate: float = 0.0          # tokens (requests) per tick
    default_burst: float = 0.0         # bucket cap; 0 -> 8x rate
    tenant_rates: dict = field(default_factory=dict)     # tenant -> rate
    tenant_bursts: dict = field(default_factory=dict)    # tenant -> burst

    def __post_init__(self):
        for name in ("device_queue_depth", "prio_interleave", "coalesce_cap",
                     "host_drain_slice", "default_weight"):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"QoSProfile.{name} must be an int >= 1, "
                                 f"got {v!r}")
        for name in ("coalesce_ticks", "deliver_ticks"):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 0:
                raise ValueError(f"QoSProfile.{name} must be an int >= 0, "
                                 f"got {v!r}")
        for name in ("default_rate", "default_burst"):
            v = getattr(self, name)
            if not isinstance(v, (int, float)) or v < 0:
                raise ValueError(f"QoSProfile.{name} must be >= 0, got {v!r}")
        # Normalize the per-tenant maps into plain (copied) dicts so a
        # caller mutating its argument cannot skew a live profile.
        for name, lo in (("tenant_weights", 1), ("tenant_rates", 0),
                         ("tenant_bursts", 0)):
            m = getattr(self, name)
            if not isinstance(m, dict):
                raise ValueError(f"QoSProfile.{name} must be a dict, "
                                 f"got {m!r}")
            clean = {}
            for t, v in m.items():
                if not isinstance(t, int) or t < 0:
                    raise ValueError(f"QoSProfile.{name}: tenant ids must "
                                     f"be ints >= 0, got {t!r}")
                if not isinstance(v, (int, float)) or v < lo:
                    raise ValueError(f"QoSProfile.{name}[{t}] must be "
                                     f">= {lo}, got {v!r}")
                clean[t] = v
            object.__setattr__(self, name, clean)

    # -- per-tenant effective values ----------------------------------------
    def weight_of(self, tenant: int) -> int:
        return int(self.tenant_weights.get(tenant, self.default_weight))

    def rate_of(self, tenant: int) -> float:
        return float(self.tenant_rates.get(tenant, self.default_rate))

    def burst_of(self, tenant: int) -> float:
        b = float(self.tenant_bursts.get(tenant, self.default_burst))
        if b <= 0:
            # A bucket with no explicit cap absorbs 8 ticks of its rate —
            # enough to ride out a pipelined batch without admitting an
            # unbounded backlog.
            b = max(self.rate_of(tenant) * 8.0, 1.0)
        return b

    def admission_enabled(self) -> bool:
        return self.default_rate > 0 or any(
            r > 0 for r in self.tenant_rates.values())

    def fairness_enabled(self) -> bool:
        """True when any tenant's service share differs from the default."""
        return bool(self.tenant_weights)

    # -- presets ------------------------------------------------------------
    @classmethod
    def preset(cls, name: str) -> "QoSProfile":
        try:
            build = _PRESETS[name]
        except KeyError:
            raise ValueError(
                f"unknown QoS preset {name!r}; "
                f"known: {sorted(_PRESETS)}") from None
        return build()

    @classmethod
    def latency(cls) -> "QoSProfile":
        return cls(coalesce_ticks=0, deliver_ticks=0, host_drain_slice=128,
                   prio_interleave=2)

    @classmethod
    def throughput(cls) -> "QoSProfile":
        return cls(coalesce_ticks=8, coalesce_cap=512, deliver_ticks=4,
                   host_drain_slice=1024, prio_interleave=8,
                   device_queue_depth=256)

    @classmethod
    def isolation(cls) -> "QoSProfile":
        return cls(default_rate=8.0, default_burst=64.0)

    @classmethod
    def from_dict(cls, d: dict) -> "QoSProfile":
        """Build a profile from a config mapping, rejecting unknown fields.

        An optional ``"profile"`` key names a preset to start from; every
        other key must be a :class:`QoSProfile` field and overrides it.
        """
        d = dict(d)
        base_name = d.pop("profile", None)
        known = {f.name for f in fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"unknown QoSProfile field(s): {unknown}; "
                             f"known: {sorted(known)}")
        base = cls.preset(base_name) if base_name is not None else cls()
        return replace(base, **d) if d else base


_PRESETS = {
    "latency": QoSProfile.latency,
    "throughput": QoSProfile.throughput,
    "isolation": QoSProfile.isolation,
}


class TokenBucket:
    """One tenant's admission bucket against the deterministic tick clock.

    Lazy refill: tokens accrue ``rate`` per elapsed tick (capped at
    ``burst``) on the next ``grant`` — no per-tick bookkeeping, which
    matters because buckets are probed on the director's ingress hot path.
    """

    __slots__ = ("rate", "burst", "tokens", "last_tick")

    def __init__(self, rate: float, burst: float):
        self.rate = rate
        self.burst = burst
        self.tokens = burst          # a fresh tenant may burst immediately
        self.last_tick = 0

    def _refill(self, now: int) -> None:
        if now > self.last_tick:
            self.tokens = min(self.burst,
                              self.tokens + (now - self.last_tick) * self.rate)
            self.last_tick = now

    def grant(self, now: int, n: int) -> int:
        """Take up to ``n`` whole tokens; returns how many were granted."""
        self._refill(now)
        g = min(n, int(self.tokens))
        if g > 0:
            self.tokens -= g
        return g

    def retry_after(self, now: int) -> int:
        """Ticks until at least one token will be available (>= 1 when dry)."""
        self._refill(now)
        if self.tokens >= 1.0:
            return 0
        need = 1.0 - self.tokens
        return max(1, int(-(-need // self.rate)))  # ceil(need / rate)


class TenantAdmission:
    """Per-tenant token-bucket admission for one server's traffic director.

    Installed on the director as a pair of callbacks (``admit``/``on_shed``)
    so :mod:`repro_torch.core.traffic` stays policy-free.  Conservation counters
    (``offered == granted + shed``) make over- and under-counting sheds a
    testable invariant rather than a log-diving exercise.
    """

    def __init__(self, profile: QoSProfile, clock):
        self.profile = profile
        self.clock = clock           # rebound by DDSStorageServer.adopt_clock
        self._buckets: dict[int, TokenBucket | None] = {}
        self.offered = 0
        self.granted = 0
        self.shed = 0
        self.tenant_shed: dict[int, int] = {}

    def _bucket(self, tenant: int) -> TokenBucket | None:
        try:
            return self._buckets[tenant]
        except KeyError:
            rate = self.profile.rate_of(tenant)
            b = (TokenBucket(rate, self.profile.burst_of(tenant))
                 if rate > 0 else None)    # None == unlimited
            self._buckets[tenant] = b
            return b

    def admit(self, tenant: int, n: int) -> int:
        """How many of ``n`` offered requests this tenant may enter NOW."""
        self.offered += n
        b = self._bucket(tenant)
        g = n if b is None else b.grant(self.clock.now, n)
        self.granted += g
        if g < n:
            dropped = n - g
            self.shed += dropped
            self.tenant_shed[tenant] = (
                self.tenant_shed.get(tenant, 0) + dropped)
        return g

    def retry_after(self, tenant: int) -> int:
        b = self._bucket(tenant)
        return 0 if b is None else b.retry_after(self.clock.now)

    def summary(self) -> dict:
        out = {"offered": self.offered, "granted": self.granted,
               "shed": self.shed}
        if self.tenant_shed:
            out["tenant_shed"] = dict(sorted(self.tenant_shed.items()))
        return out
