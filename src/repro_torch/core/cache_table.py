"""DDS cache table (§6.1): cuckoo hashing with chained buckets.

The cache table maps application object keys (page id, KV key, ...) to the
user's cache items (file id / offset / size / version ...).  Requirements
(paper Table 2):

  * File service performs inserts/deletes at millions of op/s (bounded by the
    storage device).
  * Offload engine + traffic director perform lookups at up to tens of
    millions of op/s — lookups must be worst-case constant time and must not
    block behind writers.

Design, following the paper:

  * **Cuckoo hashing** with two hash functions — a key lives in one of two
    buckets, so a lookup probes at most two buckets (worst-case constant).
  * **Chained items within a bucket** — each bucket has ``slots`` in-line
    entries plus an overflow chain, which absorbs insert collisions without
    triggering cuckoo kicks on every conflict (reduces "the impact of
    collisions on insertions").
  * **Pre-reserved capacity** — the user declares the maximum number of cache
    items; the table never resizes at runtime.

Readers proceed without taking the writer lock: buckets are versioned with a
seqlock (even = stable); a reader retries if the version moved under it.
Writers (file service) serialize on a single mutex — there is exactly one
file-service writer thread in DDS, so this is not a scalability limit.

Backing-store layout (the vectorized data plane): fingerprints, versions
and chain occupancy live in flat contiguous numpy arrays —

  * ``_keys_np``   uint64, shape (nbuckets * slots,): slot fingerprints,
    ``_EMPTY`` marks a free slot; bucket ``b`` owns ``[b*slots, (b+1)*slots)``.
  * ``_fulls_np`` / ``_vals_np``  object, same shape: the full keys and the
    cached values (object refs; gathers are C loops, not interpreter loops).
  * ``_versions_np`` uint64, shape (nbuckets,): the seqlock word per bucket.
  * ``_chain_np``  int64, shape (nbuckets,): overflow-chain population, so a
    burst can prove "no chain to consult" array-wise.

Scalar probes still walk plain Python list mirrors (``_keys`` etc.) — a
single-element numpy index costs a boxing per probe, ~10x a list index —
so every writer mutation updates BOTH stores inside the same seqlock-odd
window.  The seqlock-over-arrays rule for vectorized readers: gather the
version column, gather whatever else you need, gather the version column
again — a burst element is trusted only if both snapshots are equal and
even; everything else retries on the scalar path.
"""

from __future__ import annotations

import threading
from dataclasses import asdict, dataclass
from typing import Any, Iterable, Iterator

import numpy as np

from repro_torch.core import vector

_EMPTY = 0xFFFFFFFFFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF

# 64-bit mix (splitmix64 finalizer) — cheap, good avalanche.  Pure-int
# arithmetic: the table sits on BOTH hot paths (a lookup per directed
# request in the offload predicate, an insert per cache-on-write), where a
# numpy-scalar mix — ufunc dispatch + an errstate context manager per call —
# cost ~10x the hash itself.  ``vector.mix64`` is the bit-identical batch
# form used by ``lookup_many``.
_M1 = 0xBF58476D1CE4E5B9
_M2 = 0x94D049BB133111EB


def _mix(x: int, seed: int) -> int:
    # callers pass 64-bit non-negative ints; xor/shift stay in range, only
    # the multiplies need masking back to 64 bits
    x ^= seed
    x ^= x >> 30
    x = (x * _M1) & _MASK64
    x ^= x >> 27
    x = (x * _M2) & _MASK64
    x ^= x >> 31
    return x


# Bursts shorter than this stay on the scalar path: the fixed cost of the
# vectorized probe (a dozen ufunc dispatches) only amortizes past it.
# Burst size below which the scalar probe loop beats the vectorized one
# (fixed numpy dispatch cost vs ~2us/key scalar work; crossover measured
# at ~44-48 keys by benchmarks/micro/kernels_ab.py on CPython 3.11).
_VEC_MIN = 48


@dataclass
class CacheTableStats:
    inserts: int = 0
    deletes: int = 0
    lookups: int = 0
    hits: int = 0
    kicks: int = 0        # cuckoo relocations
    chain_inserts: int = 0
    full_rejections: int = 0
    batched_lookups: int = 0   # lookup_many bursts served
    locked_probes: int = 0     # seqlock retry budget exhausted -> locked read

    def as_dict(self) -> dict:
        """Plain-dict snapshot for app-level stats surfaces (e.g. the KV
        store's per-shard stats)."""
        return asdict(self)


class CacheTable:
    """Fixed-capacity cuckoo hash table with per-bucket chaining."""

    def __init__(self, max_items: int, slots_per_bucket: int = 4,
                 load_factor: float = 0.5):
        if max_items <= 0:
            raise ValueError("max_items must be positive")
        # Reserve memory up front to avoid runtime resizing (paper §6.1).
        want = int(max_items / max(load_factor, 1e-3))
        nbuckets = 1
        while nbuckets * slots_per_bucket < want:
            nbuckets <<= 1
        self.nbuckets = nbuckets
        self.slots = slots_per_bucket
        self.max_items = max_items
        self._mask = nbuckets - 1
        # In-line slot lists (keys as 64-bit int fingerprints of the full
        # key).  Plain lists, not numpy rows: slot probes are single-element
        # int compares, where numpy scalar indexing costs a boxing per probe.
        self._keys: list[list[int]] = [[_EMPTY] * slots_per_bucket
                                       for _ in range(nbuckets)]
        self._vals: list[list[Any]] = [[None] * slots_per_bucket for _ in range(nbuckets)]
        self._full_keys: list[list[Any]] = [[None] * slots_per_bucket for _ in range(nbuckets)]
        self._chains: list[dict[Any, Any]] = [dict() for _ in range(nbuckets)]
        self._versions = [0] * nbuckets  # seqlock (even = stable)
        # Flat contiguous mirrors for the vectorized burst path (layout in
        # the module docstring).  Writers keep both stores coherent inside
        # one seqlock-odd window.
        self._keys_np = np.full(nbuckets * slots_per_bucket, _EMPTY,
                                dtype=np.uint64)
        self._fulls_np = np.empty(nbuckets * slots_per_bucket, dtype=object)
        self._vals_np = np.empty(nbuckets * slots_per_bucket, dtype=object)
        self._versions_np = np.zeros(nbuckets, dtype=np.uint64)
        self._chain_np = np.zeros(nbuckets, dtype=np.int64)
        self._slot_iota = np.arange(slots_per_bucket, dtype=np.int64)
        self._count = 0
        self._wlock = threading.Lock()
        self.stats = CacheTableStats()
        # Mutation epoch: bumped on every bucket write window.  Lets callers
        # that probed a batch earlier in the SAME scheduling step (the
        # offload predicate) reuse their results iff nothing changed since,
        # instead of paying a second full probe per burst.
        self.epoch = 0

    # -- hashing ---------------------------------------------------------------
    def _hash_key(self, key: Any) -> int:
        if isinstance(key, int):
            return _mix(key & _MASK64, 0)
        return _mix(hash(key) & _MASK64, 0)

    def _buckets_for(self, hk: int) -> tuple[int, int]:
        # ``hk`` is already splitmix-finalized, so its low and high halves
        # are independently avalanche-mixed: deriving the two cuckoo
        # buckets from disjoint bit ranges costs ZERO extra mixes (the
        # old per-seed re-mix tripled the hashing cost of every
        # lookup/insert/delete on the predicate hot path).
        b1 = hk & self._mask
        b2 = (hk >> 32) & self._mask
        if b2 == b1:
            b2 = (b1 + 1) & self._mask
        return b1, b2

    # -- read path (lock-free via seqlock) --------------------------------------
    def _lookup_one(self, key: Any, hk: int) -> tuple[bool, Any]:
        """Authoritative single-key probe; shared by ``lookup`` and the
        ``lookup_many`` fallback.  Does NOT touch stats (callers fold).

        The value is bound ONLY under the version-stable check — an
        unstable probe can never leak a value from a bucket a writer was
        mid-mutation in.  If the seqlock retry budget runs dry (a writer
        spinning on this bucket), the probe falls back to a brief LOCKED
        read instead of reporting a false miss: present keys stay present
        under any writer schedule.
        """
        versions = self._versions
        for b in self._buckets_for(hk):
            for _ in range(64):  # seqlock retry budget
                v0 = versions[b]
                if v0 & 1:
                    continue  # writer active in this bucket
                found, val = self._probe(b, hk, key)
                if versions[b] == v0:
                    if found:
                        return True, val   # version-stable hit
                    break                  # version-stable miss here
            else:
                # Budget exhausted with the writer still live: take the
                # writer lock for one authoritative probe rather than
                # treating "couldn't read" as "absent".
                with self._wlock:
                    found, val = self._probe(b, hk, key)
                self.stats.locked_probes += 1
                if found:
                    return True, val
        return False, None

    def lookup(self, key: Any) -> Any | None:
        self.stats.lookups += 1
        found, val = self._lookup_one(key, self._hash_key(key))
        if found:
            self.stats.hits += 1
            return val
        return None

    def lookup_many(self, keys: list) -> list:
        """Burst lookup: ONE vectorized probe for the whole batch.

        The director's offload predicate probes the table once per message
        of a network batch.  The burst is resolved array-at-a-time — one
        splitmix mix, a two-bucket fingerprint gather and an equality
        reduce over the flat backing store — with the seqlock honored
        array-wise: the version column is gathered before and after the
        data gathers, and only elements whose buckets were even-and-equal
        in both snapshots are trusted.  Unstable elements, fingerprint
        collisions and chained buckets retry on the scalar path
        (:meth:`_lookup_one`), which also shields them from writer
        starvation via the locked-probe fallback.  Returns one value (or
        ``None``) per key, in key order; stats fold once per burst.
        """
        n = len(keys)
        st = self.stats
        st.lookups += n
        st.batched_lookups += 1
        if n < _VEC_MIN:
            hits = 0
            out: list = []
            hash_key = self._hash_key
            lookup_one = self._lookup_one
            for key in keys:
                found, val = lookup_one(key, hash_key(key))
                out.append(val if found else None)
                hits += found
            st.hits += hits
            return out

        hk = vector.hash_keys(keys)
        mask = np.uint64(self._mask)
        b1 = (hk & mask).astype(np.int64)
        b2 = ((hk >> np.uint64(32)) & mask).astype(np.int64)
        same = b1 == b2
        if same.any():
            b2[same] = (b1[same] + 1) & self._mask
        slots = self.slots
        vnp = self._versions_np
        knp = self._keys_np
        # Seqlock over arrays: version snapshot -> data gathers -> version
        # snapshot.  (CPython bytecode boundaries give the same atomicity
        # the scalar reader relies on.)
        v0_1 = vnp[b1]
        v0_2 = vnp[b2]
        rows1 = knp[(b1 * slots)[:, None] + self._slot_iota]
        rows2 = knp[(b2 * slots)[:, None] + self._slot_iota]
        eq1 = rows1 == hk[:, None]
        eq2 = rows2 == hk[:, None]
        hit1 = eq1.any(axis=1)
        hit2 = eq2.any(axis=1)
        chained = (self._chain_np[b1] > 0) | (self._chain_np[b2] > 0)
        # Candidate hits: gather full keys + values for fingerprint matches
        # (object gathers are C loops over refs, not interpreter loops).
        only1 = hit1 & ~hit2
        flat = np.where(only1, b1 * slots + eq1.argmax(axis=1),
                        b2 * slots + eq2.argmax(axis=1))
        cand = only1 | (hit2 & ~hit1)
        cidx = np.nonzero(cand)[0]
        if cidx.size:
            cfulls = self._fulls_np[flat[cidx]]
            cvals = self._vals_np[flat[cidx]]
        # Close the seqlock window AFTER every data gather.
        v1_1 = vnp[b1]
        v1_2 = vnp[b2]
        one = np.uint64(1)
        stable = ((v0_1 == v1_1) & (v0_2 == v1_2)
                  & ((v0_1 & one) == 0) & ((v0_2 & one) == 0))
        out_np = np.empty(n, dtype=object)
        hits = 0
        resolved_hit = np.zeros(n, dtype=bool)
        if cidx.size:
            ckeys = np.empty(cidx.size, dtype=object)
            ckeys[:] = [keys[i] for i in cidx]
            good = (cfulls == ckeys) & stable[cidx]
            gsel = cidx[good]
            out_np[gsel] = cvals[good]
            resolved_hit[gsel] = True
            hits += int(good.sum())
        # Resolved misses: stable, no fingerprint match, no chain to consult.
        # Everything else — unstable buckets, fingerprint collisions (full
        # key mismatched), double-bucket matches, chained buckets — retries
        # on the scalar path.
        resolved_miss = stable & ~hit1 & ~hit2 & ~chained
        fallback = np.nonzero(~(resolved_hit | resolved_miss))[0]
        if fallback.size:
            lookup_one = self._lookup_one
            for i in fallback:
                i = int(i)
                found, val = lookup_one(keys[i], int(hk[i]))
                if found:
                    out_np[i] = val
                    hits += 1
        st.hits += hits
        return out_np.tolist()

    def _probe(self, b: int, hk: int, key: Any) -> tuple[bool, Any]:
        row = self._keys[b]
        full = self._full_keys[b]
        for s, k in enumerate(row):
            if k == hk and full[s] == key:
                return True, self._vals[b][s]
        chain = self._chains[b]
        if key in chain:
            return True, chain[key]
        return False, None

    def __contains__(self, key: Any) -> bool:
        return self.lookup(key) is not None

    def __len__(self) -> int:
        return self._count

    # -- write path (single writer: the file service) ---------------------------
    def _bucket_begin(self, b: int) -> None:
        # Both version stores go odd BEFORE either data store is touched.
        self.epoch += 1
        self._versions_np[b] += 1
        self._versions[b] += 1  # odd: writer active

    def _bucket_end(self, b: int) -> None:
        self._versions[b] += 1  # even: stable
        self._versions_np[b] += 1

    def _set_slot(self, b: int, s: int, hk: int, key: Any, value: Any) -> None:
        """Mutate one in-line slot in BOTH backing stores (seqlock held odd)."""
        self._keys[b][s] = hk
        self._full_keys[b][s] = key
        self._vals[b][s] = value
        flat = b * self.slots + s
        self._keys_np[flat] = hk
        self._fulls_np[flat] = key
        self._vals_np[flat] = value

    def insert(self, key: Any, value: Any) -> bool:
        """Insert or update.  Returns False iff the table is at capacity."""
        with self._wlock:
            hk = self._hash_key(key)
            b1, b2 = self._buckets_for(hk)
            # ONE pass over both buckets: find an in-place update target and
            # remember the first free slot for the (common) fresh-insert case.
            free_b = free_s = -1
            for b in (b1, b2):
                row = self._keys[b]
                full = self._full_keys[b]
                for s, k in enumerate(row):
                    if k == hk and full[s] == key:
                        self._bucket_begin(b)
                        self._vals[b][s] = value
                        self._vals_np[b * self.slots + s] = value
                        self._bucket_end(b)
                        self.stats.inserts += 1
                        return True
                    if k == _EMPTY and free_b < 0:
                        free_b, free_s = b, s
                if key in self._chains[b]:
                    self._bucket_begin(b)
                    self._chains[b][key] = value
                    self._bucket_end(b)
                    self.stats.inserts += 1
                    return True
            if self._count >= self.max_items:
                self.stats.full_rejections += 1
                return False
            # Take the empty in-line slot spotted during the update scan.
            if free_b >= 0:
                self._place(free_b, free_s, hk, key, value)
                self._count += 1
                self.stats.inserts += 1
                return True
            # Cuckoo kicks with a bounded path; on failure, chain in-bucket.
            if self._kick_insert(b1, hk, key, value, budget=32):
                self._count += 1
                self.stats.inserts += 1
                return True
            self._chain_put(b1, key, value)
            self.stats.chain_inserts += 1
            self._count += 1
            self.stats.inserts += 1
            return True

    def _chain_put(self, b: int, key: Any, value: Any) -> None:
        self._bucket_begin(b)
        self._chains[b][key] = value
        self._chain_np[b] = len(self._chains[b])
        self._bucket_end(b)

    def _free_slot(self, b: int) -> int | None:
        row = self._keys[b]
        for s in range(self.slots):
            if row[s] == _EMPTY:
                return s
        return None

    def _place(self, b: int, s: int, hk: int, key: Any, value: Any) -> None:
        self._bucket_begin(b)
        self._set_slot(b, s, hk, key, value)
        self._bucket_end(b)

    def _kick_insert(self, b: int, hk: int, key: Any, value: Any,
                     budget: int) -> bool:
        cur = (b, hk, key, value)
        for i in range(budget):
            b, hk, key, value = cur
            s = self._free_slot(b)
            if s is not None:
                self._place(b, s, hk, key, value)
                return True
            # Evict the slot this path landed on (round-robin by budget step).
            s = i % self.slots
            vk = self._keys[b][s]
            vfk, vv = self._full_keys[b][s], self._vals[b][s]
            self._place(b, s, hk, key, value)
            self.stats.kicks += 1
            vb1, vb2 = self._buckets_for(vk)
            nb = vb2 if vb1 == b else vb1
            cur = (nb, vk, vfk, vv)
        # Could not re-home the last victim: chain it in its bucket.
        b, hk, key, value = cur
        self._chain_put(b, key, value)
        self.stats.chain_inserts += 1
        return True

    def delete(self, key: Any) -> bool:
        with self._wlock:
            hk = self._hash_key(key)
            b1, b2 = self._buckets_for(hk)
            for b in (b1, b2):
                row = self._keys[b]
                full = self._full_keys[b]
                for s in range(self.slots):
                    if row[s] == hk and full[s] == key:
                        self._bucket_begin(b)
                        self._set_slot(b, s, _EMPTY, None, None)
                        self._bucket_end(b)
                        self._count -= 1
                        self.stats.deletes += 1
                        return True
                if key in self._chains[b]:
                    self._bucket_begin(b)
                    del self._chains[b][key]
                    self._chain_np[b] = len(self._chains[b])
                    self._bucket_end(b)
                    self._count -= 1
                    self.stats.deletes += 1
                    return True
            return False

    def delete_many(self, keys: Iterable[Any]) -> int:
        """Drop a batch of keys (live-migration range invalidation).

        Each hit bumps its bucket's seqlock — and therefore the table
        ``epoch`` — so predicate probe memos taken before an ownership
        flip can never serve a migrated key from a stale mapping.
        Returns the number of keys actually removed."""
        n = 0
        for k in keys:
            if self.delete(k):
                n += 1
        return n

    def items(self) -> Iterator[tuple[Any, Any]]:
        """Stable snapshot of every (key, value) pair.

        The whole table is materialized UNDER the writer lock and an
        iterator over the snapshot returned.  The previous implementation
        was a generator that scanned lazily while holding the lock: items
        relocated by cuckoo kicks between ``next()`` calls could be yielded
        twice or skipped, and any insert from the consuming thread's
        call chain would deadlock on the non-reentrant writer lock.
        """
        with self._wlock:
            out: list[tuple[Any, Any]] = []
            for b in range(self.nbuckets):
                row = self._keys[b]
                full = self._full_keys[b]
                vals = self._vals[b]
                for s in range(self.slots):
                    if row[s] != _EMPTY:
                        out.append((full[s], vals[s]))
                out.extend(self._chains[b].items())
        return iter(out)
