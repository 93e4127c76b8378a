"""Fault tolerance: heartbeats, stragglers, restart — and cluster failover.

Components:

``HeartbeatMonitor``
    Tracks per-host heartbeats (monotonic step + timestamp).  A host whose
    heartbeat is older than ``timeout_s`` is declared dead.  The timeout's
    UNIT follows the injected ``now`` callable: wall seconds under the
    default ``time.monotonic``, logical TICKS when constructed via
    :meth:`HeartbeatMonitor.on_ticks` against the deterministic
    :class:`~repro_torch.core.lifecycle.TickClock` (the storage cluster's mode —
    wall time would make failover timing depend on interpreter speed).

``StragglerDetector``
    Collects per-host step durations and flags hosts slower than
    ``threshold x`` the fleet median over a sliding window.  Duration units
    are caller-defined (wall seconds for training fleets, ticks for the
    storage cluster's replication-lag feed) — the detector only compares
    ratios, so it is clock-agnostic by construction.

``ClusterSupervisor``
    The storage data plane's failure detector: beats every live shard of a
    replicated ``DDSCluster`` on the shared tick clock, declares a shard
    dead after ``heartbeat_timeout_ticks`` of silence, and drives replica
    promotion + ring repair (``DDSCluster._failover``).

``TrainSupervisor``
    Drives a Trainer with failure injection hooks: on a detected failure it
    restores the latest DDS checkpoint (write-behind saves mean at most
    ``ckpt_every`` steps are replayed) and continues — optionally on a
    SHRUNKEN data-parallel world (elastic restart).  Its liveness clock is
    the trainer's deterministic STEP counter, not wall time — the run loop
    is cooperative, so wall-clock silence says nothing about host death.

All timing here is injected (``now`` callables) so tests are deterministic.
"""

from __future__ import annotations

import statistics
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Callable


@dataclass
class HostState:
    host: str
    last_step: int = -1
    last_beat_s: float = 0.0
    alive: bool = True


class HeartbeatMonitor:
    """Liveness by heartbeat age; ``timeout_s`` is in ``now``'s units."""

    def __init__(self, hosts: list[str], timeout_s: float = 60.0,
                 now: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self.now = now
        self.hosts = {h: HostState(h, last_beat_s=now()) for h in hosts}

    @classmethod
    def on_ticks(cls, hosts: list[str], clock,
                 timeout_ticks: int) -> "HeartbeatMonitor":
        """Tick-based monitor on a ``TickClock`` — deterministic timeouts
        (two same-seed runs detect a death at the identical tick)."""
        return cls(hosts, timeout_s=timeout_ticks, now=lambda: clock.now)

    def beat(self, host: str, step: int) -> None:
        st = self.hosts[host]
        st.last_step = step
        st.last_beat_s = self.now()
        st.alive = True

    def dead_hosts(self) -> list[str]:
        t = self.now()
        dead = []
        for st in self.hosts.values():
            if t - st.last_beat_s > self.timeout_s:
                st.alive = False
                dead.append(st.host)
        return dead

    def remove(self, host: str) -> None:
        self.hosts.pop(host, None)

    def watch(self, host: str) -> None:
        """(Re-)monitor ``host`` with a fresh beat — a healed partitioned
        shard rejoining the fleet after its removal at promotion."""
        self.hosts[host] = HostState(host, last_beat_s=self.now())


class StragglerDetector:
    """Flags hosts whose step time exceeds threshold x fleet median."""

    def __init__(self, threshold: float = 1.5, window: int = 16,
                 min_samples: int = 4):
        self.threshold = threshold
        self.window = window
        self.min_samples = min_samples
        self._samples: dict[str, deque] = defaultdict(
            lambda: deque(maxlen=window))

    def record(self, host: str, step_time_s: float) -> None:
        self._samples[host].append(step_time_s)

    def host_median(self, host: str) -> float | None:
        s = self._samples.get(host)
        if not s or len(s) < self.min_samples:
            return None
        return statistics.median(s)

    def stragglers(self) -> list[tuple[str, float]]:
        meds = {h: m for h in self._samples
                if (m := self.host_median(h)) is not None}
        if len(meds) < 2:
            return []
        fleet = statistics.median(meds.values())
        return [(h, m / fleet) for h, m in meds.items()
                if m > self.threshold * fleet]


@dataclass
class FailureEvent:
    step: int
    kind: str          # "crash" | "straggler" | "heartbeat"
    host: str
    action: str        # "restart" | "restart_shrunk" | "promote:shardN" | ...


class ClusterSupervisor:
    """Failure detector + failover driver for a replicated ``DDSCluster``.

    Wired into the cluster pump when ``ServerConfig.replication`` > 0:
    every pump beats each LIVE shard on the shared tick clock (a crashed
    shard's heartbeat goes silent at its crash tick).  ``poll`` counts one
    MISSED WINDOW each time a shard's silence exceeds ``timeout_ticks``,
    then re-arms the window; only after ``miss_windows`` CONSECUTIVE
    missed windows (default 2) does it declare death and drive the
    cluster's replica promotion and ring repair.  A single delayed or
    partitioned heartbeat blip therefore cannot false-promote a live
    primary — the shard gets a full second window to beat again, and any
    real beat resets the count.  Detection latency is exactly
    ``miss_windows * (timeout_ticks + 1)`` pumps, deterministic across
    runs.

    The straggler detector is fed per-shard replication-lag means (ticks
    between a primary's forward and the replica's ack): a replica whose
    lag grows against the fleet is the disaggregated analogue of the slow
    host a training fleet would checkpoint-exclude.
    """

    def __init__(self, cluster, timeout_ticks: int = 16,
                 miss_windows: int = 2):
        self.cluster = cluster
        self.clock = cluster.clock
        self.miss_windows = max(1, miss_windows)
        names = [self._name(i) for i in range(cluster.num_shards)]
        self.monitor = HeartbeatMonitor.on_ticks(names, self.clock,
                                                 timeout_ticks)
        self.detector = StragglerDetector()
        self.events: list[FailureEvent] = []
        self._misses: dict[str, int] = {}   # consecutive missed windows
        self._lag_seen = [(0, 0)] * cluster.num_shards  # (n, total) deltas

    @staticmethod
    def _name(shard: int) -> str:
        return f"shard{shard}"

    def beat_live(self) -> None:
        """One heartbeat per live shard, stamped with the current tick.

        A real beat resets the shard's consecutive-missed-window count:
        a blip that recovers within the grace windows leaves no trace.
        """
        beat = self.monitor.beat
        now = self.clock.now
        dead = self.cluster._dead
        misses = self._misses
        for i in range(self.cluster.num_shards):
            if i not in dead:
                name = self._name(i)
                beat(name, now)
                if misses:
                    misses.pop(name, None)

    def poll(self) -> list[FailureEvent]:
        """Detect newly dead shards; fail each over.  Returns new events."""
        out: list[FailureEvent] = []
        for name in self.monitor.dead_hosts():
            misses = self._misses.get(name, 0) + 1
            if misses < self.miss_windows:
                # Grace window: note the miss and re-arm the timeout —
                # promotion waits for consecutive silence, so a single
                # delay/partition blip cannot split-brain a live primary.
                self._misses[name] = misses
                self.monitor.beat(name, self.clock.now)
                continue
            self._misses.pop(name, None)
            self.monitor.remove(name)
            shard = int(name[len("shard"):])
            promoted = self.cluster._failover(shard)
            ev = FailureEvent(self.clock.now, "heartbeat", name,
                              f"promote:{self._name(promoted)}"
                              if promoted is not None else "unrecoverable")
            self.events.append(ev)
            out.append(ev)
        self._feed_stragglers()
        return out

    def add_shard(self, shard: int) -> None:
        """Monitor a newly provisioned shard (elastic growth): fresh
        heartbeat state plus a straggler-feed slot for its replicator."""
        self.monitor.watch(self._name(shard))
        self._lag_seen.append((0, 0))

    def _feed_stragglers(self) -> None:
        """Record each live primary's mean replication lag since last poll."""
        cl = self.cluster
        for i, srv in enumerate(cl.servers):
            repl = srv.replicator
            if repl is None or i in cl._dead:
                continue
            n, tot = repl.lag.n, repl.lag.total
            pn, pt = self._lag_seen[i]
            if n > pn:
                self.detector.record(self._name(i), (tot - pt) / (n - pn))
                self._lag_seen[i] = (n, tot)


class TrainSupervisor:
    """Checkpoint/restart orchestration around a Trainer.

    ``inject_failure(step)`` may be set by tests/chaos tooling: returning a
    host name at a step simulates that host dying mid-step.
    """

    def __init__(self, trainer, hosts: list[str],
                 monitor: HeartbeatMonitor | None = None,
                 detector: StragglerDetector | None = None,
                 inject_failure: Callable[[int], str | None] = lambda s: None,
                 heartbeat_timeout_steps: int = 25):
        self.trainer = trainer
        self.hosts = list(hosts)
        # Step-counted liveness by default: the supervisor's run loop is
        # cooperative and deterministic, so the trainer's step counter is
        # the clock — the old wall-clock default could declare every host
        # dead across an interpreter pause.
        self.monitor = monitor or HeartbeatMonitor(
            hosts, timeout_s=heartbeat_timeout_steps,
            now=lambda: float(self.trainer.step))
        self.detector = detector or StragglerDetector()
        self.inject_failure = inject_failure
        self.events: list[FailureEvent] = []
        self.restarts = 0

    def run(self, target_step: int) -> list[dict]:
        """Drive training until ``trainer.step`` REACHES target_step —
        crashes rewind to the last checkpoint and the lost steps replay."""
        while self.trainer.step < target_step:
            failed = self.inject_failure(self.trainer.step)
            if failed is not None:
                self._handle_failure(failed, "crash")
                continue
            self.trainer.run(1)
            for h in self.hosts:
                self.monitor.beat(h, self.trainer.step)
        return self.trainer.history

    def _handle_failure(self, host: str, kind: str) -> None:
        """Lose ``host``: restore the latest checkpoint and continue on the
        surviving world (elastic shrink)."""
        self.restarts += 1
        if host in self.hosts:
            self.hosts.remove(host)
        self.monitor.remove(host)
        action = "restart_shrunk" if self.hosts else "restart"
        self.events.append(FailureEvent(self.trainer.step, kind, host, action))
        restored = self.trainer.restore_latest()
        if not restored:
            # No checkpoint yet: restart from step 0 (params already in
            # memory are considered lost; re-init deterministically).
            from repro_torch.train.loop import init_train_state
            (self.trainer.params, self.trainer.opt, self.trainer.comp,
             self.trainer.axes) = init_train_state(self.trainer.api,
                                                   self.trainer.tcfg)
            self.trainer.step = 0
