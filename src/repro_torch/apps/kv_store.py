"""Sharded KV store on the DDS cluster — the §9.2 workload, scaled out.

Each shard of a :class:`~repro_torch.distributed.cluster.DDSCluster` holds one
append-only record log.  The four Table-1 functions per shard:

  * ``OffPred``   — a GET whose key is in the DPU cache table goes to the
    DPU; everything else (PUT/DEL, cold GETs) goes to the host.
  * ``OffFunc``   — key -> cached ``(file, offset, size)`` -> ``ReadOp``.
  * ``Cache``     — cache-on-write: when the host appends records to the
    log, their locations are inserted, so subsequent GETs are served
    entirely on the DPU (zero host CPU).
  * ``Invalidate``— invalidate-on-read: when the host pulls a record back
    (DELETE / read-modify-write), its cache entry is dropped before the
    host proceeds — the DPU can never serve a record the host is mutating.

``PUT`` executes on the host (§2: writes need the big cores + memory) and
its ack carries the record's on-disk location ``(file_id, offset, size)``.
Overwrites append a fresh record; ``Cache`` upserts the key to the new
location, and ``Invalidate`` ignores stale log offsets so an overwrite can
never knock out the newer mapping.

Routing is by consistent-hashing the KEY over the cluster ring, so the
same thin :class:`~repro_torch.core.client.ClusterClient` pipelining applies.
"""

from __future__ import annotations

import bisect
import struct
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np

from repro_torch.core import vector, wire
from repro_torch.core.client import ClusterClient
from repro_torch.core.dds_server import APP_RESP_HDR, ServerConfig, decode_batch
from repro_torch.core.offload import OffloadAPI, ReadOp, WriteOp
from repro_torch.distributed.cluster import DDSCluster
from repro_torch.distributed.resharding import Resharder

# -- network message formats (batched with the §8.1 framing) -------------------------
KV_PUT = 16
KV_GET = 17
KV_DEL = 18
KV_MPUT = 19   # migration sync PUT (elastic resharding; shield-checked)
KV_MDEL = 20   # migration sync DEL
PUT_HDR = struct.Struct("<BQII")   # type, req_id, klen, vlen
GET_HDR = struct.Struct("<BQI")    # type, req_id, klen
REC_HDR = struct.Struct("<II")     # klen, vlen (on-disk record header)
LOC = struct.Struct("<IQI")        # file_id, offset, size (PUT ack body)

# A DELETE appends a TOMBSTONE record (header flag bit in vlen, key, no
# value bytes): deletes ride the same log/replication/ack-hold path as
# PUTs, so a replica promotion can no longer resurrect a deleted key.
TOMBSTONE = 1 << 31
_VLEN_MASK = TOMBSTONE - 1

# Unified-surface op spellings -> latency class for the issue-tick stamp.
_KV_CLS = {"get": "r", "put": "w", "delete": "w"}


def encode_put(req_id: int, key: bytes, value: bytes) -> bytes:
    return PUT_HDR.pack(KV_PUT, req_id, len(key), len(value)) + key + value


def encode_get(req_id: int, key: bytes) -> bytes:
    return GET_HDR.pack(KV_GET, req_id, len(key)) + key


def encode_del(req_id: int, key: bytes) -> bytes:
    return GET_HDR.pack(KV_DEL, req_id, len(key)) + key


def decode_record(data: bytes) -> tuple[bytes, bytes | None]:
    klen, vlen = REC_HDR.unpack_from(data, 0)
    k = data[REC_HDR.size : REC_HDR.size + klen]
    if vlen & TOMBSTONE:
        return k, None
    v = data[REC_HDR.size + klen : REC_HDR.size + klen + vlen]
    return k, v


class KVLocation(NamedTuple):
    """Immutable record location; a NamedTuple (C-speed construction —
    one is minted per PUT on the cache-on-write path)."""
    file_id: int
    offset: int
    size: int

    @staticmethod
    def decode(body: bytes) -> "KVLocation":
        return KVLocation(*LOC.unpack_from(body, 0))

    def encode(self) -> bytes:
        return LOC.pack(self.file_id, self.offset, self.size)


@dataclass
class _ShardState:
    """Host-side per-shard state (the storage application on that host)."""
    log_fid: int = -1                 # shard-LOCAL file id of the record log
    log_off: int = 0                  # append tail
    index: dict = field(default_factory=dict)      # key -> KVLocation
    at_offset: dict = field(default_factory=dict)  # log offset -> (key, size)
    offsets: list = field(default_factory=list)    # sorted (log appends only)
    # Replication: where OUR log is mirrored (replica shard -> its local
    # fid), and the log copies WE adopted at a promotion — local fid ->
    # (at_offset, offsets) invalidation view.  Adopted logs are read-only
    # (new PUTs for adopted keys append to our OWN log), so each fid's
    # offset space stays internally consistent.
    replica_fids: dict = field(default_factory=dict)
    adopted: dict = field(default_factory=dict)
    adopted_records: int = 0
    adopted_bytes: int = 0
    puts: int = 0
    dels: int = 0
    host_gets: int = 0
    # Elastic resharding: per-key heat sketch (bounded, halve-on-overflow)
    # for hot-shard detection, the migration-destination write SHIELD
    # (keys directly written while a migration is armed — a late resent
    # sync for one is stale by construction and must not apply), and the
    # applied/skipped sync counters.
    heat: dict = field(default_factory=dict)
    shield: set | None = None
    mig_puts: int = 0
    mig_dels: int = 0
    mig_skipped: int = 0


class ShardedKVStore:
    """N-shard KV service; every shard is a full DDS storage server."""

    def __init__(self, num_shards: int = 2,
                 config: ServerConfig | None = None, vnodes: int = 64,
                 elastic: bool = False):
        self._states = [_ShardState() for _ in range(num_shards)]
        self._heat_base = [0] * num_shards
        self.cluster = DDSCluster(num_shards, config,
                                  api_factory=self._api_for, vnodes=vnodes,
                                  elastic=elastic)
        for st, srv in zip(self._states, self.cluster.servers):
            st.log_fid = srv.frontend.create_file("kvlog")
            srv.run_until_idle()
        if self.cluster.replication:
            # Mirror every record log onto its ring successors: a PUT ack
            # releases only after the replicas hold the record, and a crash
            # promotes a replica (``_on_promote`` rebuilds the index from
            # the adopted log copy).
            for s, st in enumerate(self._states):
                st.replica_fids = self.cluster.replicate_file(
                    s, st.log_fid, "kvlog")
            self.cluster.on_promote = self._on_promote
            self.cluster.on_rejoin = self._on_rejoin

    def shard_for_key(self, key: bytes) -> int:
        return self.cluster.shard_for_key(key)

    def _on_promote(self, dead: int, promoted: int) -> None:
        """Adopt the dead shard's log copy on the promoted shard.

        Scans the replica log (every record the dead primary ever acked is
        in it — acks were held on replication), rebuilding the host index
        with later records winning, and registers an invalidation view so
        the DPU can never serve an adopted record the host is mutating.
        DPU cache entries for adopted keys are dropped-then-warmed so a
        stale mapping can never survive the promotion.

        Deletes are logged as TOMBSTONE records, so a key deleted on the
        dead primary after its last PUT stays deleted here: the scan's
        later-wins rule resolves it to the tombstone, which drops the
        key instead of adopting it.
        """
        fid = self._states[dead].replica_fids.get(promoted, -1)
        if fid < 0:
            return
        st = self._states[promoted]
        srv = self.cluster.servers[promoted]
        size = srv.fs.file_size(fid)
        data = srv.frontend.read_sync(fid, 0, size) if size else b""
        adopted_index: dict[bytes, KVLocation | None] = {}
        at_offset: dict = {}
        offsets: list = []
        pos = 0
        while pos + REC_HDR.size <= len(data):
            klen, vlen = REC_HDR.unpack_from(data, pos)
            total = REC_HDR.size + klen + (vlen & _VLEN_MASK)
            if pos + total > len(data):
                break   # torn tail record: never acked, drop it
            key = bytes(data[pos + REC_HDR.size : pos + REC_HDR.size + klen])
            # later wins; a tombstone resolves the key to DELETED
            adopted_index[key] = None if vlen & TOMBSTONE \
                else KVLocation(fid, pos, total)
            at_offset[pos] = (key, total)
            offsets.append(pos)
            pos += total
        st.adopted[fid] = (at_offset, offsets)
        st.adopted_records += len(offsets)
        st.adopted_bytes += pos
        table = srv.cache_table
        for key, loc in adopted_index.items():
            if table is not None:
                table.delete(key)     # a stale pre-failover mapping
            if loc is None:
                st.index.pop(key, None)   # tombstoned on the dead primary
                continue
            st.index[key] = loc   # key spaces are ring-disjoint: no clobber
            if table is not None:
                table.insert(key, loc)  # warm: post-failover GETs DPU-serve

    def _on_rejoin(self, healed: int, primary: int) -> None:
        """Re-silver the promoted primary's record log onto a healed shard.

        A partitioned shard that missed enough heartbeat windows was failed
        over; when its network comes back, ``DDSCluster._heal`` demotes it
        to a replica of ``primary`` and re-arms the replication connection.
        The cluster re-silvers its OWN file table, but the KV record logs
        are application files — so copy the primary's log (which now also
        carries every post-promotion PUT for the healed shard's adopted
        keys) and register the mapping so future appends mirror before the
        ack releases, restoring the redundancy the failover spent."""
        pst = self._states[primary]
        psrv = self.cluster.servers[primary]
        hsrv = self.cluster.servers[healed]
        prepl = psrv.replicator
        if prepl is None:
            return
        # A pre-partition copy may already exist (the healed shard was a
        # ring successor of the primary from construction) but its
        # forwarding was dropped at the promotion — the log is append-only,
        # so top up the missed tail and re-register the mapping.
        rlfid = pst.replica_fids.get(healed)
        if rlfid is None:
            rlfid = hsrv.frontend.create_file(f"kvlog:r{primary}")
        have = hsrv.fs.file_size(rlfid)
        psize = psrv.fs.file_size(pst.log_fid)
        if psize > have:
            data = psrv.frontend.read_sync(pst.log_fid, have, psize - have)
            hsrv.frontend.write_sync(rlfid, have, data)
            hsrv.run_until_idle()
        prepl.map_file(healed, pst.log_fid, rlfid)
        pst.replica_fids[healed] = rlfid

    # -- Table 1 functions, closed over one shard's state ---------------------------
    def _api_for(self, shard: int) -> OffloadAPI:
        st = self._states[shard]
        # Single-probe handoff: the predicate's burst probe already resolved
        # every DPU-bound GET, so its results ride to ``prepare_read_many``
        # keyed by message identity (the SAME view objects flow demux ->
        # fair queue -> engine).  Entries hold (msg, loc): the reference
        # keeps the view alive, so an id() can never be reused while its
        # entry exists, and the ``is`` check at pop time makes a hit exact.
        # ``epoch`` guards staleness — ANY table mutation between probe and
        # use invalidates the memo and the engine re-probes, preserving
        # scalar re-probe semantics bit-for-bit.
        probe_memo: dict[int, tuple] = {}
        memo_state = [-1]   # table.epoch the memo entries were probed at

        def off_pred(payload: bytes, table) -> tuple[list[bytes], list[bytes]]:
            """Route a network batch: cached GETs -> DPU, the rest -> host.

            The whole batch's GET keys are probed with ONE
            :meth:`~repro_torch.core.cache_table.CacheTable.lookup_many` burst
            (single stats round) instead of a lock/stats round per key;
            relative message order within each output list is preserved
            (PUT-then-DEL of one key must reach the host in order).

            A uniform all-GET batch (one key size repeated — the GET-storm
            shape) is routed columnar: the opcode and klen columns are
            checked with two array compares, keys are sliced at fixed
            strides, and only the key materialization and the burst probe
            remain per-message work."""
            mv = payload if isinstance(payload, memoryview) \
                else memoryview(payload)
            end = len(mv)
            if table is not None and end >= 512:
                u = vector.uniform_stride(mv, 4, 0, min_frames=20)
                if u is not None and u[0] * u[1] == end:
                    cnt, stride, _ = u
                    a = np.frombuffer(mv, dtype=np.uint8,
                                      count=end).reshape(cnt, stride)
                    # frame offset 4 = opcode; 13..17 = GET_HDR klen word
                    if (a[:, 4] == KV_GET).all() \
                            and (a[:, 13:17] == a[0, 13:17]).all():
                        klen = int.from_bytes(mv[13:17], "little")
                        k0 = 4 + GET_HDR.size
                        if k0 + klen <= stride:
                            keys = [bytes(mv[i * stride + k0:
                                             i * stride + k0 + klen])
                                    for i in range(cnt)]
                            hits = table.lookup_many(keys)
                            msgs = [mv[i * stride + 4:(i + 1) * stride]
                                    for i in range(cnt)]
                            ep = table.epoch
                            if ep != memo_state[0] \
                                    or len(probe_memo) > 16384:
                                probe_memo.clear()
                                memo_state[0] = ep
                            if all(h is not None for h in hits):
                                for m, h in zip(msgs, hits):
                                    probe_memo[id(m)] = (m, h)
                                return [], msgs
                            host, dpu = [], []
                            for m, h in zip(msgs, hits):
                                if h is not None:
                                    probe_memo[id(m)] = (m, h)
                                    dpu.append(m)
                                else:
                                    host.append(m)
                            return host, dpu
            msgs = decode_batch(mv)
            # decode_batch hands out memoryviews; the cache table needs a
            # hashable key, so materialize ONLY the keys.
            keys = []
            hdr = GET_HDR.size
            for m in msgs:
                if m and m[0] == KV_GET:
                    klen = GET_HDR.unpack_from(m, 0)[2]
                    keys.append(bytes(m[hdr : hdr + klen]))
            hits = iter(table.lookup_many(keys)) if (table is not None and keys) \
                else iter(())
            host, dpu = [], []
            for m in msgs:
                if m and m[0] == KV_GET and table is not None:
                    if next(hits) is not None:
                        dpu.append(m)
                        continue
                host.append(m)
            return host, dpu

        def off_func(msg: bytes, table) -> ReadOp | None:
            if not msg or msg[0] != KV_GET:
                return None
            _, rid, klen = GET_HDR.unpack_from(msg, 0)
            key = bytes(msg[GET_HDR.size : GET_HDR.size + klen])
            loc: KVLocation | None = table.lookup(key) if table else None
            if loc is None:
                return None
            return ReadOp(loc.file_id, loc.offset, loc.size)

        def prepare_read(msg, table) -> tuple[ReadOp, bytes] | None:
            """Fused OffFunc + ok-response-header (one parse per GET),
            mirroring the default app's fast path."""
            if not msg or msg[0] != KV_GET:
                return None
            _, rid, klen = GET_HDR.unpack_from(msg, 0)
            key = bytes(msg[GET_HDR.size : GET_HDR.size + klen])
            loc: KVLocation | None = table.lookup(key) if table else None
            if loc is None:
                return None
            return (ReadOp(loc.file_id, loc.offset, loc.size),
                    APP_RESP_HDR.pack(rid, wire.E_OK, loc.size))

        def prepare_read_many(msgs: list, table) -> list:
            """Burst form of ``prepare_read``: ONE ``lookup_many`` probe
            covers every GET the offload engine pulled this step (the
            engine previously re-probed the table once per request on top
            of the predicate's burst probe — the single hottest scalar
            loop on the offloaded-GET path).

            Uniform bursts (every message a GET of one frame size — the
            storm shape) decode columnar: one join, one structured-dtype
            view for the rid/klen columns, and one preassembled response-
            header arena instead of a ``Struct.pack`` per request."""
            hdr = GET_HDR.size
            n = len(msgs)
            keys: list = []
            if table is not None and n >= 8:
                ln = len(msgs[0])
                if ln > hdr and all(len(m) == ln for m in msgs):
                    buf = b"".join(msgs)
                    cols = np.frombuffer(buf, dtype={
                        "names": ["op", "rid", "klen"],
                        "formats": ["u1", "<u8", "<u4"],
                        "offsets": [0, 1, 9], "itemsize": ln})
                    if ((cols["op"] == KV_GET).all()
                            and (cols["klen"] == ln - hdr).all()):
                        end = n * ln
                        # Batch-pack the OK response headers: fill the rid /
                        # status / nbytes columns of one arena, then slice.
                        arena = np.zeros(n, dtype={
                            "names": ["rid", "status", "nbytes"],
                            "formats": ["<u8", "<u4", "<u4"],
                            "offsets": [0, 8, 12], "itemsize": 16})
                        arena["rid"] = cols["rid"]
                        arena["status"] = wire.E_OK
                        locs = None
                        if probe_memo and table.epoch == memo_state[0]:
                            # Predicate probe still valid: consume it.  The
                            # memo holds only HITS, so the miss branches
                            # vanish from the fill below.
                            locs = []
                            pop = probe_memo.pop
                            for m in msgs:
                                e = pop(id(m), None)
                                if e is None or e[0] is not m:
                                    locs = None
                                    break
                                locs.append(e[1])
                        # KVLocation IS the read op (same file_id / offset /
                        # size fields the engine reads): returning it
                        # directly skips a per-request ReadOp construction.
                        if locs is not None:
                            arena["nbytes"] = [l.size for l in locs]
                            ab = arena.tobytes()
                            return [(l, ab[i16:i16 + 16])
                                    for l, i16 in zip(
                                        locs, range(0, 16 * n, 16))]
                        keys = [buf[o + hdr:o + ln]
                                for o in range(0, end, ln)]
                        locs = table.lookup_many(keys)
                        arena["nbytes"] = [0 if l is None else l.size
                                           for l in locs]
                        ab = arena.tobytes()
                        return [None if loc is None else
                                (loc, ab[i16:i16 + 16])
                                for loc, i16 in zip(locs,
                                                    range(0, 16 * n, 16))]
            metas: list = []
            for m in msgs:
                if m and m[0] == KV_GET:
                    _, rid, klen = GET_HDR.unpack_from(m, 0)
                    keys.append(bytes(m[hdr:hdr + klen]))
                    metas.append(rid)
                else:
                    metas.append(None)
            locs = iter(table.lookup_many(keys)) if (table is not None
                                                     and keys) else iter(())
            pack = APP_RESP_HDR.pack
            ok = wire.E_OK
            out: list = []
            for rid in metas:
                if rid is None:
                    out.append(None)
                    continue
                loc = next(locs)
                out.append(None if loc is None else
                           (loc, pack(rid, ok, loc.size)))
            return out

        def cache(op: WriteOp) -> list[tuple[object, object]]:
            if op.file_id != st.log_fid:
                return []
            out, pos = [], 0
            while pos + REC_HDR.size <= len(op.data):
                klen, vlen = REC_HDR.unpack_from(op.data, pos)
                total = REC_HDR.size + klen + (vlen & _VLEN_MASK)
                key = bytes(op.data[pos + REC_HDR.size
                                    : pos + REC_HDR.size + klen])
                # A tombstone record maps the key to None: cache-on-write
                # becomes invalidate-on-write for deletes (the DPU drops
                # the mapping before the delete's ack can release).
                out.append((key, None) if vlen & TOMBSTONE else
                           (key, KVLocation(op.file_id, op.offset + pos,
                                            total)))
                pos += total
            return out

        def invalidate(op: ReadOp) -> list[object]:
            """Host pulled [offset, offset+size) of the log back: drop the
            cache entries of records in that range — UNLESS the index
            already points the key at a newer offset outside the range
            (an overwrite must not invalidate its own fresh mapping).

            ``offsets`` is sorted (logs only append), so the scan is a
            bisect plus the overlapped window; records whose mapping is
            resolved here are tombstoned out of ``at_offset`` so no read
            pays for them twice.  The view is picked per fid: our own log,
            or a log copy adopted at a replica promotion."""
            if op.file_id == st.log_fid:
                at_offset, offsets = st.at_offset, st.offsets
            else:
                view = st.adopted.get(op.file_id)
                if view is None:
                    return []
                at_offset, offsets = view
            keys = []
            j = max(bisect.bisect_right(offsets, op.offset) - 1, 0)
            while j < len(offsets):
                off = offsets[j]
                j += 1
                if off >= op.offset + op.size:
                    break
                ent = at_offset.get(off)
                if ent is None:
                    continue  # tombstoned by an earlier invalidation
                key, size = ent
                if off + size <= op.offset:
                    continue  # record just before the range; no overlap
                cur: KVLocation | None = st.index.get(key)
                if cur is not None and (
                        cur.file_id != op.file_id
                        or not (cur.offset < op.offset + op.size
                                and cur.offset + cur.size > op.offset)):
                    # Key lives elsewhere now — a newer offset, or a fresh
                    # record in a DIFFERENT log (a post-promotion overwrite
                    # of an adopted key): keep its fresh mapping, and this
                    # stale record can never matter again — prune it.
                    del at_offset[off]
                    continue
                keys.append(key)
                del at_offset[off]
            return keys

        def response_header(msg: bytes, op: ReadOp, err: int) -> bytes:
            req_id = GET_HDR.unpack_from(msg, 0)[1] if msg else 0
            return APP_RESP_HDR.pack(req_id, err,
                                     op.size if err == wire.E_OK else 0)

        def heat_touch(key: bytes) -> None:
            """Bounded per-key heat sketch: halve-and-prune on overflow so
            a long Zipf run keeps only the genuinely hot tail."""
            h = st.heat
            h[key] = h.get(key, 0) + 1
            if len(h) > 128:
                for k, v in list(h.items()):
                    v >>= 1
                    if v:
                        h[k] = v
                    else:
                        del h[k]

        def append_record(req_id: int, key: bytes,
                          rec: bytes, body: bytes) -> tuple:
            loc = KVLocation(st.log_fid, st.log_off, len(rec))
            st.log_off += len(rec)
            st.at_offset[loc.offset] = (key, loc.size)
            st.offsets.append(loc.offset)   # log appends: stays sorted
            return ("w", req_id, loc.file_id, loc.offset, rec, body)

        def host_handler(msg: bytes) -> tuple:
            typ = msg[0] if msg else 0
            if typ == KV_PUT:
                _, req_id, klen, vlen = PUT_HDR.unpack_from(msg, 0)
                # msg may be a zero-copy view: the index key must be real
                # bytes; the record join consumes the value view directly.
                key = bytes(msg[PUT_HDR.size : PUT_HDR.size + klen])
                value = msg[PUT_HDR.size + klen : PUT_HDR.size + klen + vlen]
                rec = b"".join((REC_HDR.pack(klen, vlen), key, value))
                loc = KVLocation(st.log_fid, st.log_off, len(rec))
                st.log_off += len(rec)
                st.index[key] = loc
                st.at_offset[loc.offset] = (key, loc.size)
                st.offsets.append(loc.offset)   # log appends: stays sorted
                st.puts += 1
                heat_touch(key)
                if st.shield is not None:
                    st.shield.add(key)
                # Append to the log; Cache() fires on the write -> next GET
                # for this key is DPU-served.  The ack returns the location.
                return ("w", req_id, loc.file_id, loc.offset, rec, loc.encode())
            if typ == KV_GET:
                _, req_id, klen = GET_HDR.unpack_from(msg, 0)
                key = bytes(msg[GET_HDR.size : GET_HDR.size + klen])
                loc = st.index.get(key)
                st.host_gets += 1
                heat_touch(key)
                if loc is None:
                    return ("resp", req_id, wire.E_NOENT, b"")
                return ("r", req_id, loc.file_id, loc.offset, loc.size)
            if typ == KV_DEL:
                _, req_id, klen = GET_HDR.unpack_from(msg, 0)
                key = bytes(msg[GET_HDR.size : GET_HDR.size + klen])
                heat_touch(key)
                if st.shield is not None:
                    st.shield.add(key)
                if st.index.pop(key, None) is None:
                    return ("resp", req_id, wire.E_NOENT, b"")
                st.dels += 1
                # Tombstone append: the delete rides the same log write /
                # replication / ack-hold path as a PUT, and Cache() drops
                # the DPU mapping when the record lands (a promoted
                # replica's log scan sees the delete too — no
                # resurrection).
                rec = REC_HDR.pack(klen, TOMBSTONE) + key
                return append_record(req_id, key, rec, b"")
            if typ == KV_MPUT:
                # Migration sync from the resharding source.  If this key
                # was directly written here since the shield armed, the
                # sync is STALE (every migration value predates the
                # ownership flip; every direct write postdates it) — ack
                # it without applying.
                _, req_id, klen, vlen = PUT_HDR.unpack_from(msg, 0)
                key = bytes(msg[PUT_HDR.size : PUT_HDR.size + klen])
                if st.shield is not None and key in st.shield:
                    st.mig_skipped += 1
                    return ("resp", req_id, wire.E_OK, b"")
                value = msg[PUT_HDR.size + klen : PUT_HDR.size + klen + vlen]
                rec = b"".join((REC_HDR.pack(klen, vlen), key, value))
                loc = KVLocation(st.log_fid, st.log_off, len(rec))
                st.index[key] = loc
                st.mig_puts += 1
                return append_record(req_id, key, rec, loc.encode())
            if typ == KV_MDEL:
                _, req_id, klen = GET_HDR.unpack_from(msg, 0)
                key = bytes(msg[GET_HDR.size : GET_HDR.size + klen])
                if st.shield is not None and key in st.shield:
                    st.mig_skipped += 1
                    return ("resp", req_id, wire.E_OK, b"")
                if st.index.pop(key, None) is None:
                    return ("resp", req_id, wire.E_NOENT, b"")
                st.mig_dels += 1
                rec = REC_HDR.pack(klen, TOMBSTONE) + key
                return append_record(req_id, key, rec, b"")
            return ("resp", 0, wire.E_INVAL, b"")

        return OffloadAPI(off_pred, off_func, cache=cache,
                          invalidate=invalidate,
                          response_header=response_header,
                          host_handler=host_handler,
                          prepare_read=prepare_read,
                          prepare_read_many=prepare_read_many,
                          # Lifecycle classifier: GETs are reads; PUT/DEL
                          # are writes (mutations) in the latency stats.
                          read_types=frozenset({KV_GET}))

    # -- elastic membership (online resharding) -----------------------------------------
    def add_shard(self) -> int:
        """Grow the cluster by one shard and start a LIVE migration of the
        keys the new ring assigns to it.  Returns the new shard id; the
        migration runs inside the cluster pump (``run_until_idle`` or any
        client traffic drives it) and flips ownership atomically once the
        destination holds every migrating byte."""
        cl = self.cluster
        if cl.resharder is not None:
            raise RuntimeError("a resharding migration is already active")
        new = len(cl.servers)
        # State first: the ``_api_for`` closure binds by index at server
        # construction, so the slot must exist before ``cl.add_shard``.
        self._states.append(_ShardState())
        self._heat_base.append(0)
        try:
            cl.add_shard()
        except Exception:
            self._states.pop()
            self._heat_base.pop()
            raise
        st = self._states[new]
        srv = cl.servers[new]
        st.log_fid = srv.frontend.create_file("kvlog")
        srv.run_until_idle()
        pending = cl.ring.copy()
        pending.add_node(new)
        if cl.replication:
            st.replica_fids = cl.replicate_file(new, st.log_fid, "kvlog",
                                                ring=pending)
        sources = sorted({cl.route_of(n) for n in cl.ring.nodes()}
                         - {new} - cl._dead)
        cl.start_reshard(Resharder(cl, self, pending,
                                   [(s, new) for s in sources],
                                   tag=f"add:{new}"))
        return new

    def remove_shard(self, shard: int) -> None:
        """Drain ``shard`` out of the ring: stream its keys to their new
        owners, then flip.  The server keeps running until the flip (it
        must serve reads and dual-route writes during the migration); it
        is marked retired afterwards."""
        cl = self.cluster
        if cl.resharder is not None:
            raise RuntimeError("a resharding migration is already active")
        if shard not in cl.ring.nodes():
            raise ValueError(f"shard {shard} is not a ring member")
        src = cl.route_of(shard)
        if src in cl._dead:
            raise ValueError(f"shard {shard} has no live server")
        pending = cl.ring.copy()
        pending.remove_node(shard)
        dests = sorted(set(pending.nodes()) - {src} - cl._dead)
        cl.start_reshard(Resharder(cl, self, pending,
                                   [(src, d) for d in dests],
                                   tag=f"remove:{shard}", retire=(shard,)))

    # -- resharding adapter (driven by distributed.resharding.Resharder) ----------------
    def migration_keys(self, shard: int) -> list:
        """Deterministic snapshot of the keys ``shard`` currently owns."""
        return sorted(self._states[shard].index)

    def index_loc(self, shard: int, key: bytes):
        return self._states[shard].index.get(key)

    def read_value(self, shard: int, key: bytes, loc: KVLocation) -> bytes:
        """Read a record's value bytes straight from device memory.

        The front-end's synchronous read helper would eat concurrent host
        completions on a busy shard (and its invalidate-on-read hook
        would evict the source's own DPU entries for streamed keys) — the
        migration driver instead translates through the fs map and reads
        the committed bytes raw.  Safe by construction: the driver only
        reads snapshot-time locations, made durable by a device drain at
        migration setup; every later write carries its bytes through the
        source tap."""
        srv = self.cluster.servers[shard]
        data = b"".join(srv.device.raw_read(phys, n) for phys, n in
                        srv.fs.translate(loc.file_id, loc.offset, loc.size))
        return decode_record(data)[1]

    def parse_migration_record(self, shard: int, file_id: int, offset: int,
                               data) -> tuple | None:
        """Parse a tapped write into ``(key, loc, value)``; None if the
        write is not this shard's KV log (journal, replica copies...).
        Tombstones parse to ``(key, None, None)``."""
        st = self._states[shard]
        if file_id != st.log_fid or len(data) < REC_HDR.size:
            return None
        klen, vlen = REC_HDR.unpack_from(data, 0)
        key = bytes(data[REC_HDR.size : REC_HDR.size + klen])
        if vlen & TOMBSTONE:
            return key, None, None
        total = REC_HDR.size + klen + (vlen & _VLEN_MASK)
        return (key, KVLocation(file_id, offset, total),
                bytes(data[REC_HDR.size + klen : total]))

    @staticmethod
    def encode_migration_put(rrid: int, key: bytes, value: bytes) -> bytes:
        return PUT_HDR.pack(KV_MPUT, rrid, len(key), len(value)) + key + value

    @staticmethod
    def encode_migration_del(rrid: int, key: bytes) -> bytes:
        return GET_HDR.pack(KV_MDEL, rrid, len(key)) + key

    def arm_shield(self, shard: int) -> None:
        self._states[shard].shield = set()

    def disarm_shield(self, shard: int) -> None:
        if shard < len(self._states):
            self._states[shard].shield = None

    def _drop_keys(self, shard: int, keys) -> None:
        st = self._states[shard]
        table = self.cluster.servers[shard].cache_table
        for k in keys:
            st.index.pop(k, None)
            if table is not None:
                table.delete(k)

    def drop_source_keys(self, shard: int, keys) -> None:
        """Post-flip cleanup: the source sheds its copies of migrated
        keys (index + any DPU entries fence-passed traffic re-warmed)."""
        self._drop_keys(shard, keys)

    def drop_dest_keys(self, shard: int, keys) -> None:
        """Abort: the destination sheds the partial copy it streamed."""
        self._drop_keys(shard, keys)

    # -- hot-shard detection -------------------------------------------------------------
    def shard_heat(self) -> list[int]:
        """Per-shard ops since the previous call (PUT+GET+DEL, host and
        DPU paths) — the skew signal ``hot_shards`` thresholds against."""
        out = []
        for i, (st, srv) in enumerate(zip(self._states,
                                          self.cluster.servers)):
            total = (st.puts + st.dels + st.host_gets
                     + srv.offload.stats.completed)
            out.append(total - self._heat_base[i])
            self._heat_base[i] = total
        return out

    def hot_shards(self, factor: float = 2.0,
                   min_ops: int = 64) -> list[int]:
        """Shards whose heat exceeds ``factor``x the live-shard mean (and
        ``min_ops`` absolute) — candidates for an ``add_shard`` rebalance."""
        heat = self.shard_heat()
        cl = self.cluster
        live = [h for i, h in enumerate(heat)
                if i not in cl._dead and i not in cl.retired]
        if not live:
            return []
        mean = sum(live) / len(live)
        floor = max(float(min_ops), factor * mean)
        return [i for i, h in enumerate(heat)
                if h >= floor and i not in cl._dead
                and i not in cl.retired]

    # -- observability -----------------------------------------------------------------
    def dpu_served_gets(self) -> int:
        return sum(s.offload.stats.completed for s in self.cluster.servers)

    def host_served_gets(self) -> int:
        return sum(st.host_gets for st in self._states)

    def shard_stats(self) -> list[dict]:
        """Per-shard stats, including the DPU cache table's counters.

        ``cache`` surfaces :class:`~repro_torch.core.cache_table.CacheTableStats`
        (lookups/hits on the director's predicate path, inserts from
        cache-on-write, deletes from invalidate-on-read, cuckoo kicks), so
        an operator can see hit rate and insert pressure per shard."""
        out = []
        for st, srv in zip(self._states, self.cluster.servers):
            ent = {"puts": st.puts, "dels": st.dels,
                   "host_gets": st.host_gets,
                   "dpu_gets": srv.offload.stats.completed,
                   "log_bytes": st.log_off,
                   "cache": srv.cache_table.stats.as_dict(),
                   "cache_items": len(srv.cache_table),
                   "latency": srv.lifecycle.summary()}
            if st.adopted_records:
                ent["adopted_records"] = st.adopted_records
                ent["adopted_bytes"] = st.adopted_bytes
            if st.heat:
                top = sorted(st.heat.items(), key=lambda kv: -kv[1])[:4]
                ent["hot_keys"] = [
                    (k.decode("latin1") if isinstance(k, (bytes, bytearray))
                     else str(k), v) for k, v in top]
            if st.mig_puts or st.mig_dels or st.mig_skipped:
                ent["migration"] = {"applied_puts": st.mig_puts,
                                    "applied_dels": st.mig_dels,
                                    "stale_skipped": st.mig_skipped}
            if st.shield is not None:
                ent["migration_shielded"] = len(st.shield)
            if srv.replicator is not None:
                ent["replication"] = srv.replicator.summary()
            ha = srv.host_app
            if ha.dup_suppressed or ha.replayed_acks:
                ent["exactly_once"] = {"dup_suppressed": ha.dup_suppressed,
                                       "replayed_acks": ha.replayed_acks}
            if srv.director.stats.dpu_bypassed:
                ent["dpu_bypassed"] = srv.director.stats.dpu_bypassed
            out.append(ent)
        return out

    def latency_stats(self) -> dict:
        """Cluster-wide measured tick-latency per class (see README)."""
        return self.cluster.latency_stats()


class KVClient:
    """Key-routed client: batches/pipelines PUT/GET/DEL across shards.

    ``tenant`` binds once per client; every shard connection underneath
    carries it, so the servers' QoS layer (fair demux, admission, per-
    tenant stats) attributes all of this client's traffic without any
    per-call tenant argument.  The unified burst surface is
    :meth:`submit` / :meth:`harvest`; ``get_many``/``put_many``/
    ``delete_many`` remain as thin deprecated wrappers.
    """

    def __init__(self, store: ShardedKVStore, ip: str = "10.0.0.9",
                 port: int | None = None, shard_cache: int = 1 << 16,
                 tenant: int = 0, retry_attempts: int = 0,
                 timeout_ticks: int = 0):
        self.store = store
        self.tenant = tenant
        self.net = ClusterClient(store.cluster, ip=ip, port=port,
                                 tenant=tenant,
                                 retry_attempts=retry_attempts,
                                 timeout_ticks=timeout_ticks)
        # Consistent-hash placement is stable WITHIN a ring epoch, so the
        # key->shard mapping is cacheable: repeat traffic skips the blake2b
        # ring walk (bounded to keep pathological key churn from growing
        # without limit).  A failover's epoch bump flushes the cache — the
        # dead shard's keys now route to the promoted replica.
        self._shard_of: dict[bytes, int] = {}
        self._shard_cache = shard_cache
        self._epoch_seen = store.cluster.epoch

    def _shard(self, key: bytes) -> int:
        cl = self.store.cluster
        if cl.epoch != self._epoch_seen:
            self._epoch_seen = cl.epoch
            self._shard_of.clear()
        shard = self._shard_of.get(key)
        if shard is None:
            shard = self.store.shard_for_key(key)
            if len(self._shard_of) >= self._shard_cache:
                self._shard_of.clear()
            self._shard_of[key] = shard
        return shard

    def put(self, key: bytes, value: bytes) -> int:
        return self.net.send_raw(self._shard(key),
                                 lambda rid: encode_put(rid, key, value),
                                 cls="w", key=key)

    def get(self, key: bytes) -> int:
        return self.net.send_raw(self._shard(key),
                                 lambda rid: encode_get(rid, key), key=key)

    def delete(self, key: bytes) -> int:
        return self.net.send_raw(self._shard(key),
                                 lambda rid: encode_del(rid, key),
                                 cls="w", key=key)

    # -- unified burst surface --------------------------------------------------------
    def submit(self, ops: list[tuple]) -> list[int]:
        """Issue a burst of KV operations; one handle (request id) per op,
        in order.  Ops are ``("get", key)``, ``("put", key, value)`` or
        ``("delete", key)`` and mix freely in one batch (one rid-range
        reservation, one flush round).  Harvest with :meth:`harvest`;
        ``get_many``/``put_many``/``delete_many`` are thin deprecated
        wrappers over this."""
        shard = self._shard
        shards = [shard(op[1]) for op in ops]
        cls = [_KV_CLS[op[0]] for op in ops]

        def build(rid: int, i: int) -> bytes:
            op = ops[i]
            kind = op[0]
            if kind == "get":
                return encode_get(rid, op[1])
            if kind == "put":
                return encode_put(rid, op[1], op[2])
            return encode_del(rid, op[1])

        return self.net.issue_many(shards, build, cls=cls,
                                   keys=[op[1] for op in ops])

    def harvest(self, handles=None, block: bool = True,
                max_iters: int = 200_000) -> dict[int, tuple[int, bytes]]:
        """Collect raw ``{handle: (status, body)}`` responses — see
        :meth:`ClusterClient.harvest`.  Shed requests resolve terminally as
        ``(wire.E_SHED, hint)``; typed decoding stays with ``wait_put`` /
        ``wait_value``."""
        return self.net.harvest(handles, block=block, max_iters=max_iters)

    def _send_many(self, keys: list, encode, cls: str = "r") -> list[int]:
        shard = self._shard
        return self.net.issue_many([shard(k) for k in keys],
                                   lambda rid, i: encode(rid, keys[i]),
                                   cls=cls, keys=keys)

    def get_many(self, keys: list) -> list[int]:
        """Deprecated: ``submit([("get", k), ...])``."""
        return self._send_many(keys, encode_get)

    def delete_many(self, keys: list) -> list[int]:
        """Deprecated: ``submit([("delete", k), ...])``."""
        return self._send_many(keys, encode_del, cls="w")

    def put_many(self, items: list) -> list[int]:
        """Deprecated: ``submit([("put", k, v), ...])``."""
        shard = self._shard
        return self.net.issue_many(
            [shard(k) for k, _ in items],
            lambda rid, i: encode_put(rid, items[i][0], items[i][1]),
            cls="w", keys=[k for k, _ in items])

    # -- scheduling + typed waits -----------------------------------------------------
    @property
    def latency(self):
        """End-to-end read/write tick latency (issue -> drain).  The
        DPU-vs-host split for GETs lives in ``store.latency_stats()``,
        where it is exact."""
        return self.net.latency

    def flush(self) -> int:
        return self.net.flush()

    def pump(self) -> int:
        return self.net.pump()

    def run_until_idle(self) -> None:
        self.net.run_until_idle()

    def wait_put(self, rid: int) -> KVLocation:
        status, body = self.net.wait(rid)
        if status != wire.E_OK:
            raise IOError(f"PUT failed with status {status}")
        return KVLocation.decode(body)

    def wait_value(self, rid: int) -> bytes | None:
        status, body = self.net.wait(rid)
        if status == wire.E_NOENT:
            return None
        if status != wire.E_OK:
            raise IOError(f"GET failed with status {status}")
        return decode_record(body)[1]
