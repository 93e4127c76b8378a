"""DDS DPU file service (§4.3): segment file system + zero-copy execution.

Two layers live here:

``SegmentFS``
    The paper's minimal DPU file system: SSD space is divided into
    fixed-length segments (aligned to the disk block size); a bitmap tracks
    availability; files are allocated space by segments and grouped in flat
    directories; segment 0 persistently stores directory/file metadata and
    the *file mapping* (the vector of segments allocated to each file).
    ``translate`` converts a (file, offset, size) range into physical disk
    runs via the file mapping.

``FileServiceRunner``
    The DPU-side execution engine for host-issued file operations:

    * A dedicated DMA thread consumes request batches from each notification
      group's request ring (Fig 8b) into a DPU-side *request buffer* whose
      size is >= the host ring, so outstanding requests never overlap and the
      storage driver can consume request payloads IN PLACE — no request copy
      (§4.3 "Eliminating data copies").

    * Responses are pre-allocated in a DPU-side *response buffer* governed by
      three tails (§4.3 "Ordered execution"):
        TailA(llocated)  — end of pre-allocated response space,
        TailB(uffered)   — end of the completed-response prefix,
        TailC(ompleted)  — end of responses delivered to the host ring.
      The device writes read data straight into the pre-allocated response
      space (status starts E_PENDING) — no response copy.  TailB only
      advances over a contiguous completed prefix, preserving request order;
      a DMA write delivers [TailC, TailB) once it reaches the delivery batch
      size.

    The same ``submit`` entry point is used by the offload engine (§6.2) for
    DPU-local reads, with the destination pointing into ITS pre-allocated
    packet memory instead.

    * Execution is BATCHED end to end (the PR-3 host-path overhaul):
      ``consume_batch`` drains every available ring batch under one IncHead
      doorbell; a burst's requests are decoded inline (no per-request
      object); adjacent same-file writes coalesce into scatter-gather
      ``submit_writev`` runs; completions arrive through a flat
      cookie -> slots in-flight table reaped in bulk from the device's
      completion queue (no per-op closure); and delivery publishes a run of
      responses with one gathered DMA write + one doorbell
      (``publish_batch``).  See README "Host path & write model".

The runner is cooperatively scheduled (``step()``) so tests and benchmarks
are deterministic; ``start()`` wraps it in a thread for the live system.
"""

from __future__ import annotations

import json
import struct
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from repro_torch.core import wire
from repro_torch.core.lifecycle import TickClock
from repro_torch.core.ring import (FRAME_HDR, DMAEngine, ProgressiveRing, Region,
                             ResponseRing, frame, unframe_batch)
from repro_torch.core.vector import checksum64
from repro_torch.storage.blockdev import STATUS_PENDING, BlockDevice

META_SEGMENT = 0

# ---- redo journal (crash-consistent writes) ---------------------------------
# Record header: magic(u32) commit(u32) seq(u64) file_id(u32) offset(u64)
# nbytes(u32) new_size(u64) nsegs(u32) crc(u64), then nsegs * u32 segment
# ids (the file mapping AT SUBMIT TIME — replay needs no metadata sync),
# then the run's payload bytes, then an 8-byte zero terminator that
# clobbers any stale record header behind this one.  ``commit`` is written
# 0 with the record and flipped to 1 by a separate single-slot device
# write — the ordered metadata flip that makes the whole run atomic under
# power loss.  ``crc`` is :func:`repro_torch.core.vector.checksum64` over the
# record body (segment ids + payload): replay refuses a committed record
# whose body no longer matches — a torn/bit-rotted journal replays as
# garbage otherwise, silently corrupting the file it meant to repair.
JOURNAL_MAGIC = 0x4A444453          # "SDDJ"
_JREC = struct.Struct("<IIQIQIQIQ")
_JCOMMIT_OFF = 4                    # byte offset of ``commit`` in the header
_JCOMMIT_ONE = (1).to_bytes(4, "little")
_JTERM = bytes(8)


class FSError(Exception):
    def __init__(self, errno: int, msg: str = ""):
        super().__init__(msg or f"fs error {errno}")
        self.errno = errno


@dataclass
class FileMeta:
    file_id: int
    name: str
    dir_id: int
    size: int = 0
    segments: list[int] = field(default_factory=list)  # the file mapping


@dataclass
class DirMeta:
    dir_id: int
    name: str
    files: list[int] = field(default_factory=list)


class SegmentFS:
    """Segment-granular file system over a :class:`BlockDevice`."""

    def __init__(self, device: BlockDevice, segment_size: int = 1 << 20,
                 journal_segments: int = 0):
        assert segment_size % device.block_size == 0
        self.device = device
        self.segment_size = segment_size
        self.num_segments = device.capacity // segment_size
        if self.num_segments < 2 + journal_segments:
            raise ValueError("device too small for SegmentFS")
        self.bitmap = np.zeros(self.num_segments, dtype=bool)
        self.bitmap[META_SEGMENT] = True  # reserved for metadata
        self.files: dict[int, FileMeta] = {}
        self.dirs: dict[int, DirMeta] = {0: DirMeta(0, "/")}
        self._next_file_id = 1
        self._next_dir_id = 1
        self._lock = threading.Lock()
        # Redo journal: ``journal_segments`` segments after META_SEGMENT
        # hold a circular log of committed write runs.  0 disables
        # journaling (writes land in place directly, the pre-PR7 behavior).
        self.journal_segments = journal_segments
        self._journal_start = (META_SEGMENT + 1) * segment_size
        self._journal_len = journal_segments * segment_size
        self._journal_head = 0        # next append offset within the region
        self._journal_tail = 0        # oldest byte still awaiting in-place
        self._journal_seq = 1
        # cookie -> (record_start, record_end): reclaimed when the run's
        # in-place writev completes (``journal_reaped``).
        self._journal_pending: dict[int, tuple[int, int]] = {}
        self.journal_replayed_records = 0
        self.journal_replayed_bytes = 0
        # Committed records whose body failed its checksum at recovery —
        # each one stopped the replay scan (everything after it is suspect).
        self.journal_crc_failures = 0
        for s in range(journal_segments):
            self.bitmap[META_SEGMENT + 1 + s] = True

    # -- metadata persistence (segment 0) ----------------------------------------
    def sync_metadata(self) -> None:
        doc = {
            "files": {str(f.file_id): [f.name, f.dir_id, f.size, f.segments]
                      for f in self.files.values()},
            "dirs": {str(d.dir_id): [d.name, d.files] for d in self.dirs.values()},
            "next_file_id": self._next_file_id,
            "next_dir_id": self._next_dir_id,
            "bitmap": self.bitmap.tobytes().hex(),
        }
        blob = json.dumps(doc).encode()
        if len(blob) + 8 > self.segment_size:
            raise FSError(wire.E_NOSPC, "metadata exceeds metadata segment")
        hdr = len(blob).to_bytes(8, "little")
        self.device.raw_write(META_SEGMENT * self.segment_size, hdr + blob)

    @classmethod
    def mount(cls, device: BlockDevice, segment_size: int = 1 << 20,
              journal_segments: int = 0) -> "SegmentFS":
        fs = cls(device, segment_size, journal_segments)
        raw = device.raw_read(META_SEGMENT * segment_size, 8)
        n = int.from_bytes(raw, "little")
        if n == 0:
            return fs  # fresh device
        blob = device.raw_read(META_SEGMENT * segment_size + 8, n)
        doc = json.loads(blob.decode())
        fs.bitmap = np.frombuffer(bytes.fromhex(doc["bitmap"]), dtype=bool).copy()
        for s in range(journal_segments):   # journal stays reserved regardless
            fs.bitmap[META_SEGMENT + 1 + s] = True
        fs.files = {int(k): FileMeta(int(k), v[0], v[1], v[2], list(v[3]))
                    for k, v in doc["files"].items()}
        fs.dirs = {int(k): DirMeta(int(k), v[0], list(v[1]))
                   for k, v in doc["dirs"].items()}
        fs._next_file_id = doc["next_file_id"]
        fs._next_dir_id = doc["next_dir_id"]
        return fs

    # -- control plane --------------------------------------------------------------
    def create_dir(self, name: str) -> int:
        with self._lock:
            did = self._next_dir_id
            self._next_dir_id += 1
            self.dirs[did] = DirMeta(did, name)
            return did

    def create_file(self, name: str, dir_id: int = 0) -> int:
        with self._lock:
            if dir_id not in self.dirs:
                raise FSError(wire.E_NOENT, f"no dir {dir_id}")
            fid = self._next_file_id
            self._next_file_id += 1
            self.files[fid] = FileMeta(fid, name, dir_id)
            self.dirs[dir_id].files.append(fid)
            return fid

    def delete_file(self, file_id: int) -> None:
        with self._lock:
            f = self.files.pop(file_id, None)
            if f is None:
                raise FSError(wire.E_NOENT)
            for s in f.segments:
                self.bitmap[s] = False
            self.dirs[f.dir_id].files.remove(file_id)

    def list_dir(self, dir_id: int) -> list[str]:
        d = self.dirs.get(dir_id)
        if d is None:
            raise FSError(wire.E_NOENT)
        return [self.files[f].name for f in d.files if f in self.files]

    def file_size(self, file_id: int) -> int:
        f = self.files.get(file_id)
        if f is None:
            raise FSError(wire.E_NOENT)
        return f.size

    # -- space management --------------------------------------------------------
    def _alloc_segment(self) -> int:
        free = np.flatnonzero(~self.bitmap)
        if len(free) == 0:
            raise FSError(wire.E_NOSPC, "device full")
        s = int(free[0])
        self.bitmap[s] = True
        return s

    def ensure_capacity(self, file_id: int, new_size: int) -> None:
        with self._lock:
            f = self.files.get(file_id)
            if f is None:
                raise FSError(wire.E_NOENT)
            need = -(-new_size // self.segment_size)  # ceil
            while len(f.segments) < need:
                f.segments.append(self._alloc_segment())
            if new_size > f.size:
                f.size = new_size

    def truncate(self, file_id: int, new_size: int) -> None:
        with self._lock:
            f = self.files.get(file_id)
            if f is None:
                raise FSError(wire.E_NOENT)
            keep = -(-new_size // self.segment_size)
            for s in f.segments[keep:]:
                self.bitmap[s] = False
            f.segments = f.segments[:keep]
            f.size = new_size

    # -- address translation (the file mapping) ------------------------------------
    def translate(self, file_id: int, offset: int, size: int) -> list[tuple[int, int]]:
        """(file, offset, size) -> [(device_byte_addr, nbytes), ...] runs."""
        f = self.files.get(file_id)
        if f is None:
            raise FSError(wire.E_NOENT)
        if offset + size > len(f.segments) * self.segment_size:
            raise FSError(wire.E_INVAL, "range beyond allocation")
        runs: list[tuple[int, int]] = []
        seg_sz = self.segment_size
        while size > 0:
            seg_idx = offset // seg_sz
            seg_off = offset % seg_sz
            n = min(size, seg_sz - seg_off)
            phys = f.segments[seg_idx] * seg_sz + seg_off
            if runs and runs[-1][0] + runs[-1][1] == phys:
                runs[-1] = (runs[-1][0], runs[-1][1] + n)  # coalesce
            else:
                runs.append((phys, n))
            offset += n
            size -= n
        return runs

    # -- data plane (async, zero-copy destinations) ---------------------------------
    def submit_read(self, file_id: int, offset: int, size: int,
                    dest: memoryview, on_complete: Callable[[int], None],
                    priority: bool = False) -> None:
        """``priority=True`` rides the device's priority submission queue —
        the offload engine's latency-critical path (§6.2) never queues
        behind host-path write runs."""
        f = self.files.get(file_id)
        if f is None or offset + size > f.size:
            on_complete(wire.E_INVAL if f else wire.E_NOENT)
            return
        seg_sz = self.segment_size
        if size > 0 and offset // seg_sz == (offset + size - 1) // seg_sz:
            # Fast path: the range lives in ONE segment — a single device op,
            # no run list, no multi-completion state, no adapter closure
            # (device status codes coincide with wire error codes: 0 == E_OK,
            # nonzero values are failures either way).
            phys = f.segments[offset // seg_sz] * seg_sz + offset % seg_sz
            self.device.submit_read(phys, size, dest, on_complete,
                                    priority=priority)
            return
        runs = self.translate(file_id, offset, size)
        state = {"left": len(runs), "err": wire.E_OK}

        def done_one(status: int) -> None:
            if status != 0:
                state["err"] = wire.E_IO
            state["left"] -= 1
            if state["left"] == 0:
                on_complete(state["err"])

        pos = 0
        for phys, n in runs:
            self.device.submit_read(phys, n, dest[pos : pos + n], done_one,
                                    priority=priority)
            pos += n

    def submit_read_many(self, reads: list, priority: bool = False) -> None:
        """Burst read submission: array-at-a-time address translation.

        ``reads`` items are ``(file_id, offset, size, dest, on_complete)``.
        The storm shape — many single-segment reads of a few files — is
        translated with one segment-map gather per file and handed to the
        device as ONE burst (one tick stamp / doorbell round).  Anything
        irregular (invalid range, zero size, multi-segment span) falls back
        to ``submit_read``; pending burst items are flushed first so the
        device queue order matches a scalar submission loop exactly —
        completion order, and therefore the modeled clock, are unchanged.
        """
        n = len(reads)
        if n < 4:
            for fid, off, size, dest, cb in reads:
                self.submit_read(fid, off, size, dest, cb, priority=priority)
            return
        seg_sz = self.segment_size
        offs = np.fromiter((r[1] for r in reads), dtype=np.int64, count=n)
        sizes = np.fromiter((r[2] for r in reads), dtype=np.int64, count=n)
        fid0 = reads[0][0]
        one_fid = all(r[0] == fid0 for r in reads)
        if one_fid:
            # Storm shape: every read targets ONE file (the shard's log) —
            # translate the whole burst with a single segment-map gather.
            f = self.files.get(fid0)
            if f is not None and f.segments:
                si = offs // seg_sz
                so = offs - si * seg_sz
                segarr = np.asarray(f.segments, dtype=np.int64)
                good = (sizes > 0) & (offs + sizes <= f.size) \
                    & (so + sizes <= seg_sz)
                si_safe = np.minimum(si, len(segarr) - 1)  # guard gather
                phys = segarr[si_safe] * seg_sz + so
                ok = good
            else:
                phys = np.zeros(n, dtype=np.int64)
                ok = np.zeros(n, dtype=bool)
            if ok.all():
                pl = phys.tolist()
                self.device.submit_read_many(
                    [(pl[i], r[2], r[3], r[4]) for i, r in enumerate(reads)],
                    priority=priority)
                return
        else:
            phys = np.zeros(n, dtype=np.int64)
            ok = np.zeros(n, dtype=bool)
            by_fid: dict[int, list[int]] = {}
            for i, r in enumerate(reads):
                by_fid.setdefault(r[0], []).append(i)
            for fid, idxs in by_fid.items():
                f = self.files.get(fid)
                if f is None or not f.segments:
                    continue
                ii = np.asarray(idxs, dtype=np.int64)
                o = offs[ii]
                s = sizes[ii]
                si = o // seg_sz
                so = o - si * seg_sz
                segarr = np.asarray(f.segments, dtype=np.int64)
                good = (s > 0) & (o + s <= f.size) & (so + s <= seg_sz)
                si_safe = np.minimum(si, len(segarr) - 1)  # guard gather
                phys[ii] = segarr[si_safe] * seg_sz + so
                ok[ii] = good
        dev = self.device
        pending: list[tuple[int, int, memoryview, Callable[[int], None]]] = []
        for i, (fid, off, size, dest, cb) in enumerate(reads):
            if ok[i]:
                pending.append((int(phys[i]), size, dest, cb))
            else:
                if pending:   # keep device queue order identical to scalar
                    dev.submit_read_many(pending, priority=priority)
                    pending = []
                self.submit_read(fid, off, size, dest, cb, priority=priority)
        if pending:
            dev.submit_read_many(pending, priority=priority)

    def submit_write(self, file_id: int, offset: int, data,
                     on_complete: Callable[[int], None]) -> None:
        try:
            self.ensure_capacity(file_id, offset + len(data))
            runs = self.translate(file_id, offset, len(data))
        except FSError as e:
            on_complete(e.errno)
            return
        state = {"left": len(runs), "err": wire.E_OK}

        def done_one(status: int) -> None:
            if status != 0:
                state["err"] = wire.E_IO
            state["left"] -= 1
            if state["left"] == 0:
                on_complete(state["err"])

        pos = 0
        mv = memoryview(data)
        for phys, n in runs:
            self.device.submit_write(phys, mv[pos : pos + n], done_one)
            pos += n

    # -- cookie-based data plane (closure-free burst execution) ----------------------
    #
    # The runner's burst pipeline uses these instead of the callback forms:
    # completion arrives through the device's completion queue
    # (``device.reap()``) tagged with ``cookie``.  The device completes ops
    # of one queue IN ORDER, so a multi-run operation rides its cookie on
    # the LAST run only — when it pops out of the completion queue every
    # earlier run has already executed.  Returns ``wire.E_OK`` when
    # submitted (a completion WILL arrive) or an errno when rejected
    # synchronously (no completion follows).

    def submit_read_c(self, file_id: int, offset: int, size: int,
                      dest: memoryview, cookie: int) -> int:
        f = self.files.get(file_id)
        if f is None:
            return wire.E_NOENT
        if offset + size > f.size:
            return wire.E_INVAL
        seg_sz = self.segment_size
        if size > 0 and offset // seg_sz == (offset + size - 1) // seg_sz:
            phys = f.segments[offset // seg_sz] * seg_sz + offset % seg_sz
            self.device.submit_read(phys, size, dest, cookie=cookie)
            return wire.E_OK
        if size == 0:
            self.device.push_completion(cookie)
            return wire.E_OK
        runs = self.translate(file_id, offset, size)
        pos = 0
        last = len(runs) - 1
        for i, (phys, n) in enumerate(runs):
            op = self.device.submit_read(phys, n, dest[pos : pos + n],
                                         cookie=cookie if i == last else None)
            if op.status != STATUS_PENDING and i != last:
                # A non-final run rejected synchronously would otherwise be
                # invisible (its cookie-less rejection notifies no one and
                # the final run would complete the op E_OK): fail the whole
                # op on the cookie and submit nothing further.
                self.device.push_completion(cookie, op.status)
                return wire.E_OK
            pos += n
        return wire.E_OK

    def submit_writev(self, file_id: int, offset: int, bufs: list,
                      cookie: int) -> int:
        """Gathered write: ``bufs`` land back to back at ``offset``.

        One capacity check + one translate for the WHOLE run, then one
        scatter-gather device submission per physical (segment-aligned)
        run — a burst of k coalesced request payloads costs O(runs) device
        ops instead of O(k).  Buffer views are never joined: each run's
        slice list streams straight into the device (zero-copy).
        """
        total = 0
        for b in bufs:
            total += len(b)
        try:
            self.ensure_capacity(file_id, offset + total)
            runs = self.translate(file_id, offset, total)
        except FSError as e:
            return e.errno
        if not runs:
            self.device.push_completion(cookie)
            return wire.E_OK
        if self.journal_segments:
            # Crash-consistent apply: journal the WHOLE run (record with
            # commit=0), flip the commit word with one ordered single-slot
            # write, THEN land the bytes in place.  The device completes
            # its normal queue strictly in order, so a crash at any point
            # leaves the file either fully pre-run (commit never landed —
            # recovery ignores the record and the in-place writev never
            # executed) or fully post-run (committed — recovery replays it
            # idempotently over whatever prefix landed in place).
            self._journal_append(file_id, offset, total, bufs, cookie)
        bi = 0       # current buffer index / position for the run walk
        bpos = 0
        last = len(runs) - 1
        for ri, (phys, n) in enumerate(runs):
            chunks = []
            need = n
            while need > 0:
                b = bufs[bi]
                avail = len(b) - bpos
                if bpos == 0 and avail <= need:
                    chunks.append(b)          # whole buffer: no slicing at all
                    need -= avail
                    bi += 1
                    continue
                mv = b if isinstance(b, memoryview) else memoryview(b)
                take = avail if avail <= need else need
                chunks.append(mv[bpos : bpos + take])
                need -= take
                if take == avail:
                    bi += 1
                    bpos = 0
                else:
                    bpos += take
            op = self.device.submit_writev(phys, chunks,
                                           cookie=cookie if ri == last else None)
            if op.status != STATUS_PENDING and ri != last:
                # Same shared-fate rule as submit_read_c: a rejected
                # non-final run fails the whole op on the cookie.
                self.device.push_completion(cookie, op.status)
                return wire.E_OK
        return wire.E_OK

    # -- redo journal ---------------------------------------------------------------
    def _journal_append(self, file_id: int, offset: int, total: int,
                        bufs: list, cookie: int) -> None:
        f = self.files[file_id]
        seg_blob = np.asarray(f.segments, dtype=np.uint32).tobytes()
        rec_len = _JREC.size + len(seg_blob) + total + len(_JTERM)
        if rec_len > self._journal_len:
            raise FSError(wire.E_NOSPC, "write run exceeds journal capacity")
        head, tail = self._journal_head, self._journal_tail
        wrapped = head + rec_len > self._journal_len
        pos = 0 if wrapped else head
        if self._journal_pending:
            # Unapplied region is [tail, head) (circularly).  The append
            # must not clobber it: if it would, force every outstanding
            # in-place write to media first — after a drain the whole
            # region is reclaimable.
            if tail > head:          # occupied wraps around the region end
                conflict = wrapped or head + rec_len > tail
            else:                    # occupied is the linear [tail, head)
                conflict = wrapped and rec_len > tail
            if conflict:
                self.device.drain()
                self._journal_pending.clear()
        if not self._journal_pending:
            self._journal_tail = pos
        # Body checksum: one vectorized pass over the logical record body
        # (mapping + payload), exactly what recovery reads back contiguously.
        crc = checksum64(seg_blob + b"".join(bufs))
        hdr = _JREC.pack(JOURNAL_MAGIC, 0, self._journal_seq, file_id,
                         offset, total, f.size, len(f.segments), crc)
        lba = self._journal_start + pos
        self.device.submit_writev(lba, [hdr + seg_blob, *bufs, _JTERM])
        self.device.submit_write(lba + _JCOMMIT_OFF, _JCOMMIT_ONE)
        self._journal_seq += 1
        self._journal_head = pos + rec_len
        self._journal_pending[cookie] = (pos, pos + rec_len)

    def journal_reaped(self, cookie: int) -> None:
        """The run under ``cookie`` finished its in-place writev: its
        journal record is reclaimable (the runner calls this from its bulk
        completion reap)."""
        pend = self._journal_pending
        if not pend or pend.pop(cookie, None) is None:
            return
        self._journal_tail = (next(iter(pend.values()))[0] if pend
                              else self._journal_head)

    def recover_journal(self) -> dict:
        """Replay committed journal records after a crash (idempotent).

        Scans from the region start: records of the latest pass sit there
        back to back with strictly increasing ``seq``; the scan stops at
        the first bad magic (the zero terminator), non-increasing seq
        (stale tail of an earlier wrap) or uncommitted record (its in-place
        writev — and everything after it — never executed, and the record
        itself may be torn).  Each committed record carries its own file
        mapping + size, so replay needs no trust in the possibly-stale
        metadata segment.  Returns ``{"records": n, "bytes": b}``.
        """
        out = {"records": 0, "bytes": 0}
        if not self.journal_segments:
            return out
        dev = self.device
        base = self._journal_start
        pos = 0
        prev_seq = 0
        while pos + _JREC.size <= self._journal_len:
            (magic, commit, seq, fid, off, nbytes, new_size, nsegs,
             crc) = _JREC.unpack(dev.raw_read(base + pos, _JREC.size))
            rec_len = _JREC.size + nsegs * 4 + nbytes + len(_JTERM)
            if (magic != JOURNAL_MAGIC or seq <= prev_seq or not commit
                    or pos + rec_len > self._journal_len):
                break
            seg_raw = dev.raw_read(base + pos + _JREC.size, nsegs * 4)
            payload = dev.raw_read(base + pos + _JREC.size + nsegs * 4, nbytes)
            if checksum64(seg_raw + payload) != crc:
                # Committed but corrupt: replaying it would write garbage
                # over good data, and every later record is suspect too —
                # stop the scan and surface the failure.
                self.journal_crc_failures += 1
                break
            segs = np.frombuffer(seg_raw, dtype=np.uint32).tolist()
            self._replay_record(fid, off, nbytes, new_size, segs, payload)
            out["records"] += 1
            out["bytes"] += nbytes
            prev_seq = seq
            pos += rec_len
        self._journal_head = pos
        self._journal_tail = pos
        self._journal_seq = prev_seq + 1
        self._journal_pending.clear()
        if out["records"]:
            self.sync_metadata()
        self.journal_replayed_records += out["records"]
        self.journal_replayed_bytes += out["bytes"]
        return out

    def _replay_record(self, fid: int, off: int, nbytes: int, new_size: int,
                       segs: list, payload: bytes) -> None:
        f = self.files.get(fid)
        if f is None:
            # Created after the last metadata sync: resurrect it from the
            # record (name is lost — only the id routes data-plane ops).
            f = FileMeta(fid, f"recovered-{fid}", 0)
            self.files[fid] = f
            self.dirs[0].files.append(fid)
            self._next_file_id = max(self._next_file_id, fid + 1)
        if len(segs) > len(f.segments):
            f.segments = list(segs)
        for s in f.segments:
            self.bitmap[s] = True
        if new_size > f.size:
            f.size = new_size
        seg_sz = self.segment_size
        pos = 0
        while pos < nbytes:    # address through the record's OWN mapping
            seg_off = (off + pos) % seg_sz
            n = min(nbytes - pos, seg_sz - seg_off)
            phys = segs[(off + pos) // seg_sz] * seg_sz + seg_off
            self.device.raw_write(phys, payload[pos : pos + n])
            pos += n


# ---------------------------------------------------------------------------
# The DPU-side runner for host-issued file operations.
# ---------------------------------------------------------------------------


@dataclass(slots=True)
class _PendingResp:
    """A pre-allocated response slot in the DPU response buffer.

    ``done`` is the in-memory mirror of the §4.3 E_PENDING protocol: a slot
    starts pending and flips when its response header (real error code) is
    written by ``_finish`` — the delivery scan checks the flag instead of
    DMA-reading the status word back out of the response buffer.
    """
    group_id: int
    off: int           # start offset in the group's response buffer (virtual)
    size: int          # full response size (header + payload)
    request_id: int
    pad: bool = False  # wrap-padding slot: space only, never delivered
    done: bool = False
    done_tick: int = 0    # tick the slot completed (age-based delivery)
    # Write bookkeeping: ``wfid >= 0`` marks a write slot — the in-flight-
    # write count for that file is decremented at completion, and (when a
    # cache hook is installed) the §6.1 cache-on-write fires THEN, not at
    # submission: a DPU cache entry must never point at bytes the device
    # has not written yet (the priority read queue would happily overtake
    # the write otherwise).
    wfid: int = -1
    woff: int = 0
    wdata: object = None  # zero-copy view of the write payload (cache hook)


@dataclass
class _GroupState:
    group_id: int
    req_ring: ProgressiveRing
    resp_ring: ResponseRing
    # DPU request buffer: >= host ring size => outstanding requests never overlap.
    req_buf: Region = None  # type: ignore[assignment]
    req_buf_tail: int = 0
    # DPU response buffer with the three tails of §4.3.
    resp_buf: Region = None  # type: ignore[assignment]
    tail_a: int = 0  # allocated
    tail_b: int = 0  # buffered (completed prefix)
    tail_c: int = 0  # delivered to host
    pending: deque = field(default_factory=deque)  # _PendingResp, alloc order
    ready: deque = field(default_factory=deque)    # completed, undelivered
    interrupt: Callable[[], None] | None = None  # "DPU driver interrupt"
    # Held coalesced write run (latency-adaptive batching): adjacent
    # same-file writes accumulate ACROSS ring batches and flush when a
    # read/control op needs the barrier, the run outgrows the cap, the run
    # is older than the tick budget, or the ring goes idle.
    wv_file: int = -1
    wv_off: int = 0
    wv_end: int = 0
    wv_bufs: list = field(default_factory=list)
    wv_slots: list = field(default_factory=list)
    wv_tick: int = 0   # tick the held run was started


@dataclass
class FileServiceStats:
    requests: int = 0
    reads: int = 0
    writes: int = 0
    control_ops: int = 0
    read_bytes: int = 0
    write_bytes: int = 0
    response_batches: int = 0
    responses_delivered: int = 0
    request_copies: int = 0   # nonzero only with zero_copy=False
    response_copies: int = 0
    shed_requests: int = 0    # dropped under un-drained-ring overload
    write_submits: int = 0    # gathered writev submissions issued
    coalesced_writes: int = 0  # write requests that rode an earlier submit
    completion_batches: int = 0  # non-empty device completion reaps


class FileServiceRunner:
    """Executes host file requests on the DPU with zero copies (§4.3)."""

    def __init__(self, fs: SegmentFS, dma: DMAEngine | None = None,
                 resp_buf_size: int = 1 << 22,
                 delivery_batch: int = 1,
                 zero_copy: bool = True,
                 cache_hook: Callable[[int, int, object], None] | None = None,
                 invalidate_hook: Callable[[int, int, int], None] | None = None,
                 clock: TickClock | None = None,
                 coalesce_ticks: int = 2,
                 deliver_ticks: int = 2,
                 coalesce_cap: int = 256,
                 shed_hook: Callable[[int], None] | None = None):
        self.fs = fs
        self.dma = dma or DMAEngine()
        self.resp_buf_size = resp_buf_size
        self.delivery_batch = delivery_batch
        self.zero_copy = zero_copy
        self.cache_hook = cache_hook
        self.invalidate_hook = invalidate_hook
        # Deterministic lifecycle clock: standalone runners own (and tick)
        # their own; a DDSStorageServer/DDSCluster installs the shared one
        # and ticks it once per pump step.
        self.clock = clock if clock is not None else TickClock()
        self._owns_clock = clock is None
        # Latency-adaptive write coalescing: a held run flushes when it is
        # ``coalesce_ticks`` old, when the ring goes idle, when a read or
        # control op needs the device-order barrier, or at ``coalesce_cap``
        # requests — batching never waits on an unbounded "full burst".
        self.coalesce_ticks = coalesce_ticks
        self.deliver_ticks = deliver_ticks
        self.coalesce_cap = coalesce_cap
        # In-flight write counts per file id (held + queued + at device):
        # the offload engine's read/write fence probes this, and it feeds
        # the cache-on-write-at-completion discipline.  Tracking is paid
        # only when someone needs it — a cache hook is installed or the
        # owning server enabled the read/write fence.
        self.write_inflight: dict[int, int] = {}
        self.track_writes = cache_hook is not None
        # Invoked with the request id of a SHED request (the bounded
        # E_NOSPC emergency path gave up) — the owning server surfaces a
        # terminal "shed" status to clients through the lifecycle tracker.
        self.shed_hook = shed_hook
        self.groups: dict[int, _GroupState] = {}
        self.stats = FileServiceStats()
        # Flat in-flight table: completion cookie -> (group, ((slot, req), ...)).
        # Replaces the per-op ``on_done`` lambda closures: the device's
        # completion queue is reaped in bulk and each cookie finishes its
        # whole run of response slots in one grouped pass.
        self._inflight: dict[int, tuple] = {}
        self._cookie = 1
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        # step() may be entered from the service thread AND from a
        # co-resident producer's ring-full on_retry (host_lib.submit_many):
        # serialize whole steps so the pipeline never runs two consumers.
        self._step_lock = threading.Lock()

    # -- clock adoption (cluster layer) --------------------------------------------
    def adopt_clock(self, clock: TickClock) -> None:
        """Rebind every stamp point to a scheduler-owned shared clock and
        stop self-ticking (the owner ticks once per scheduling step).  The
        rebinding knowledge lives HERE, next to the state it mutates — a
        future clock consumer inside the runner only needs updating in
        this one place."""
        self.clock = clock
        self._owns_clock = False
        for g in self.groups.values():
            g.req_ring.clock = clock

    # -- registration (host lib calls this when a notification group is made) -----
    def register_group(self, group_id: int, req_ring: ProgressiveRing,
                       resp_ring: ResponseRing,
                       interrupt: Callable[[], None] | None = None) -> None:
        g = _GroupState(group_id, req_ring, resp_ring)
        # Lifecycle instrumentation: the request ring records host-publish ->
        # DPU-consume residency ticks against the service's clock.
        req_ring.clock = self.clock
        # Request buffer sized >= the host ring: no outstanding request overlaps.
        g.req_buf = Region(f"dpu:req{group_id}", max(req_ring.capacity, 1 << 12))
        g.resp_buf = Region(f"dpu:resp{group_id}", self.resp_buf_size)
        g.interrupt = interrupt
        with self._lock:
            self.groups[group_id] = g

    # -- cooperative scheduling -----------------------------------------------------
    def step(self) -> int:
        """One iteration: fetch -> submit -> complete -> deliver. Returns work."""
        with self._step_lock:
            if self._owns_clock:
                self.clock.tick()   # standalone runner: step == tick
            work = 0
            with self._lock:
                groups = list(self.groups.values())
            for g in groups:
                work += self._fetch_and_submit(g)
            self.fs.device.poll()
            work += self._reap_completions()
            for g in groups:
                work += self._deliver(g)
            return work

    def run_until_idle(self, max_iters: int = 100_000) -> None:
        idle = 0
        for _ in range(max_iters):
            if self.step() == 0:
                self.fs.device.drain()
                if self.step() == 0:
                    idle += 1
                    if idle >= 2 and not self._any_pending():
                        return
            else:
                idle = 0
        raise TimeoutError("file service did not go idle")

    def _any_pending(self) -> bool:
        return any(g.pending or g.ready for g in self.groups.values())

    def busy(self) -> bool:
        """True while responses are pending or awaiting delivery.

        Scheduler wakeup source: probed on every idle re-arm check, so the
        common busy case (device ops in flight) short-circuits on the flat
        cookie table before paying the per-group pending/ready scan."""
        return bool(self._inflight) or self._any_pending()

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="dds-file-service")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            if self.step() == 0:
                self._stop.wait(50e-6)

    # -- request path -----------------------------------------------------------------
    def _fetch_and_submit(self, g: _GroupState) -> int:
        """Consume EVERY available batch in one burst (single IncHead
        doorbell), splitting each batch zero-copy and submitting the whole
        decoded run through the coalescing write pipeline.

        A trailing run of adjacent writes is HELD across batches (and
        steps) so consecutive ring batches coalesce into one scatter-gather
        submission — but the hold is latency-bounded: the run flushes as
        soon as the ring goes idle this step, it reaches ``coalesce_ticks``
        of age, or it hits ``coalesce_cap`` requests.  Reads and control
        ops still flush it first (device-order barrier), so read-your-
        writes is preserved exactly as before."""
        batches = g.req_ring.consume_batch(self.dma)
        for batch in batches:
            # Land the batch in the DPU request buffer (the DMA destination).
            # Size >= host ring guarantees in-flight requests never overlap.
            cap = len(g.req_buf.buf)
            pos = g.req_buf_tail % cap
            n = len(batch)
            first = min(n, cap - pos)
            mv = memoryview(batch)
            g.req_buf.write(pos, mv[:first])
            if first < n:
                g.req_buf.write(0, mv[first:])
            g.req_buf_tail += n
            self._submit_burst(g, unframe_batch(batch))
        work = len(batches)
        if g.wv_slots and (
                not batches   # ring idle: nothing to batch against — flush now
                or self.clock.now - g.wv_tick >= self.coalesce_ticks):
            self._flush_held(g)
            work += 1
        return work

    def _submit_burst(self, g: _GroupState, raws: list) -> None:
        """Execute a burst of raw framed requests.

        Headers are unpacked inline (no per-request ``Request`` object on
        the data plane) and write payloads stay zero-copy views of the
        consumed batch.  Adjacent same-file writes (``offset == previous
        end``) coalesce into ONE :meth:`SegmentFS.submit_writev`
        scatter-gather submission — each request still gets its own
        pre-allocated response slot (acks stay per-request and ordered),
        but a run of k appends costs one capacity check, one translate and
        O(segment runs) device ops instead of k.  The trailing run is HELD
        on the group (``_fetch_and_submit`` flushes it on idle/age/cap) so
        adjacent writes from consecutive batches merge too.  A read or
        control op flushes the pending run first, so device submission
        order — and therefore read-your-writes within and across bursts —
        is preserved.  Cache-on-write (§6.1) fires at write COMPLETION (see
        ``_finish``), never here: a cache entry must not point at
        un-written bytes while offloaded reads can overtake writes via the
        device's priority queue.
        """
        stats = self.stats
        stats.requests += len(raws)
        zero_copy = self.zero_copy
        cache_hook = self.cache_hook
        invalidate_hook = self.invalidate_hook
        unpack = wire.REQ_HDR.unpack_from
        hdr_size = wire.REQ_HDR.size
        resp_hdr_size = wire.RESP_HDR.size
        wif = self.write_inflight
        track = self.track_writes
        for raw in raws:
            op, rid, fid, off, nbytes = unpack(raw, 0)
            if op == wire.OP_WRITE:
                slot = self._alloc_slot(g, rid, resp_hdr_size)
                if slot is None:
                    continue  # E_NOSPC backpressure, completed inline
                data = raw[hdr_size : hdr_size + nbytes]
                stats.writes += 1
                stats.write_bytes += nbytes
                if not zero_copy:
                    data = bytes(data)  # defensive copy zero-copy mode avoids
                    stats.request_copies += 1
                if track:
                    slot.wfid = fid
                    slot.woff = off
                    if cache_hook is not None:
                        slot.wdata = data  # cache-on-write, hooked at completion
                    wif[fid] = wif.get(fid, 0) + 1
                if g.wv_slots and fid == g.wv_file and off == g.wv_end:
                    g.wv_bufs.append(data)
                    g.wv_slots.append(slot)
                    g.wv_end += nbytes
                else:
                    if g.wv_slots:
                        self._flush_held(g)
                    g.wv_file, g.wv_off = fid, off
                    g.wv_end = off + nbytes
                    g.wv_bufs = [data]
                    g.wv_slots = [slot]
                    g.wv_tick = self.clock.now
                if len(g.wv_slots) >= self.coalesce_cap:
                    self._flush_held(g)
                continue
            # Reads/control ops must hit the device AFTER writes queued
            # before them in the burst: flush the pending run first.
            if g.wv_slots:
                self._flush_held(g)
            if op == wire.OP_READ:
                slot = self._alloc_slot(g, rid, resp_hdr_size + nbytes)
                if slot is None:
                    continue
                stats.reads += 1
                stats.read_bytes += nbytes
                if not zero_copy:
                    # Straw-man: read into scratch, copy to the response later.
                    scratch = bytearray(nbytes)

                    def on_done(err: int, g=g, slot=slot, nbytes=nbytes,
                                scratch=scratch):
                        if err == wire.E_OK:
                            view = self._resp_payload_view(g, slot.off, nbytes)
                            view[:] = scratch  # the copy zero-copy removes
                            self.stats.response_copies += 1
                        self._finish(g, slot, err)

                    self.fs.submit_read(fid, off, nbytes,
                                        memoryview(scratch), on_done)
                else:
                    dest = self._resp_payload_view(g, slot.off, nbytes)
                    ck = self._cookie
                    self._cookie = ck + 1
                    err = self.fs.submit_read_c(fid, off, nbytes, dest, ck)
                    if err != wire.E_OK:
                        self._finish(g, slot, err)
                    else:
                        self._inflight[ck] = (g, (slot,))
                if invalidate_hook:
                    invalidate_hook(fid, off, nbytes)  # invalidate-on-read
            else:
                req = wire.Request(op, rid, fid, off, nbytes,
                                   raw[hdr_size:])
                slot = self._alloc_slot(g, rid, wire.response_size_for(req))
                if slot is not None:
                    self._control_op(g, slot, req)
        # The trailing write run stays HELD on the group — the next batch
        # may extend it; ``_fetch_and_submit`` bounds the hold by idle/age.

    def _flush_held(self, g: _GroupState) -> None:
        """Submit the group's held coalesced write run (one cookie)."""
        bufs, slots = g.wv_bufs, g.wv_slots
        file_id, offset = g.wv_file, g.wv_off
        g.wv_bufs, g.wv_slots = [], []
        g.wv_file = -1
        self._flush_writev(g, file_id, offset, bufs, slots)

    def _alloc_slot(self, g: _GroupState, rid: int,
                    resp_size: int) -> _PendingResp | None:
        """Advance TailA over a pre-allocated response slot (§4.3).

        Returns None when the response-buffer ring is out of space — the
        request was answered inline with E_NOSPC (backpressure path)."""
        cap = len(g.resp_buf.buf)
        # Keep each response contiguous: pad TailA to the wrap boundary when
        # the slot would cross it (pad slots occupy space, deliver nothing).
        pos = g.tail_a % cap
        if pos + resp_size > cap:
            pad = cap - pos
            if g.tail_a + pad - g.tail_c > cap:
                self._complete_inline(g, rid, wire.E_NOSPC, b"")
                return None
            g.pending.append(_PendingResp(g.group_id, g.tail_a, pad,
                                          0, pad=True, done=True))
            g.tail_a += pad
        # Backpressure: the response buffer is a ring in virtual offsets.
        if g.tail_a + resp_size - g.tail_c > cap:
            self._complete_inline(g, rid, wire.E_NOSPC, b"")
            return None
        off = g.tail_a
        g.tail_a += resp_size  # pre-allocate response space (advance TailA)
        slot = _PendingResp(g.group_id, off, resp_size, rid)
        g.pending.append(slot)
        return slot

    def _flush_writev(self, g: _GroupState, file_id: int, offset: int,
                      bufs: list, slots: list) -> None:
        """Submit a coalesced write run under ONE completion cookie."""
        ck = self._cookie
        self._cookie = ck + 1
        err = self.fs.submit_writev(file_id, offset, bufs, ck)
        if err != wire.E_OK:
            # Rejected synchronously (no completion follows): the whole run
            # shares the verdict — coalesced appends have a shared fate.
            for slot in slots:
                self._finish(g, slot, err)
            return
        self._inflight[ck] = (g, tuple(slots))
        self.stats.write_submits += 1
        self.stats.coalesced_writes += len(slots) - 1

    def _reap_completions(self) -> int:
        """Batch-poll device completions into grouped ``_finish`` runs."""
        done = self.fs.device.reap()
        if not done:
            return 0
        inflight = self._inflight
        finish = self._finish
        journaled = self.fs.journal_segments
        for cookie, status in done:
            g, slots = inflight.pop(cookie)
            if journaled:
                self.fs.journal_reaped(cookie)   # run landed in place
            err = (wire.E_OK if status == 0 else
                   wire.E_INVAL if status == wire.E_INVAL else wire.E_IO)
            for slot in slots:
                finish(g, slot, err)
        self.stats.completion_batches += 1
        return len(done)

    def _control_op(self, g: _GroupState, slot: _PendingResp,
                    req: wire.Request) -> None:
        self.stats.control_ops += 1
        err, payload = wire.E_OK, b""
        try:
            if req.op == wire.OP_CREATE_FILE:
                fid = self.fs.create_file(bytes(req.payload).decode(),
                                          req.file_id)
                payload = fid.to_bytes(4, "little")
            elif req.op == wire.OP_CREATE_DIR:
                did = self.fs.create_dir(bytes(req.payload).decode())
                payload = did.to_bytes(4, "little")
            elif req.op == wire.OP_DELETE_FILE:
                self.fs.delete_file(req.file_id)
            elif req.op == wire.OP_TRUNCATE:
                self.fs.truncate(req.file_id, req.offset)
            elif req.op == wire.OP_FSYNC:
                self.fs.sync_metadata()
            elif req.op == wire.OP_LIST_DIR:
                names = json.dumps(self.fs.list_dir(req.file_id)).encode()[:4096]
                payload = names.ljust(4096, b"\x00")
            else:
                err = wire.E_INVAL
        except FSError as e:
            err = e.errno
        expect = slot.size - wire.RESP_HDR.size
        payload = payload.ljust(expect, b"\x00")
        view = self._resp_payload_view(g, slot.off, expect)
        view[:] = payload
        self._finish(g, slot, err)

    def _complete_inline(self, g: _GroupState, rid: int, err: int,
                         payload: bytes, spin: int = 100_000) -> None:
        """Emergency completion bypassing pre-allocation (backpressure path).

        Bounded: if the host never drains its response ring, the request is
        SHED (load shedding, counted) rather than deadlocking the service
        thread — the host library surfaces the gap as a timeout."""
        resp = wire.Response(rid, err, len(payload), payload).encode()
        for _ in range(spin):
            if g.resp_ring.produce(self.dma, frame(resp)):
                if g.interrupt:
                    g.interrupt()
                return
        self.stats.shed_requests += 1
        if self.shed_hook is not None:
            # Surface the terminal state: no response will ever arrive for
            # this request id — the server marks it shed in its lifecycle
            # tracker so clients stop waiting instead of timing out.
            self.shed_hook(rid)

    # -- response-buffer helpers -------------------------------------------------------
    def _resp_view(self, g: _GroupState, voff: int, n: int) -> memoryview:
        cap = len(g.resp_buf.buf)
        pos = voff % cap
        assert pos + n <= cap, "response crosses buffer wrap (sized to avoid)"
        return g.resp_buf._mv[pos : pos + n]

    def _resp_payload_view(self, g: _GroupState, off: int, n: int) -> memoryview:
        return self._resp_view(g, off + wire.RESP_HDR.size, n)

    def _write_resp_header(self, g: _GroupState, off: int, rid: int, err: int,
                           nbytes: int) -> None:
        hdr = wire.RESP_HDR.pack(rid, err, nbytes)
        self._resp_view(g, off, wire.RESP_HDR.size)[:] = hdr

    def _finish(self, g: _GroupState, slot: _PendingResp, err: int) -> None:
        """I/O completion: write the final response header and flip the
        slot's pending flag (the in-memory E_PENDING -> status transition
        of §4.3) so the delivery scan picks it up in order.

        Write slots additionally release their in-flight-write count and —
        only now, with the bytes durably on the device — fire the §6.1
        cache-on-write hook, so the DPU cache can never map a key to data
        a priority-queue read could observe before it exists."""
        self._write_resp_header(g, slot.off, slot.request_id, err,
                                slot.size - wire.RESP_HDR.size)
        slot.done = True
        slot.done_tick = self.clock.now
        fid = slot.wfid
        if fid >= 0:
            slot.wfid = -1
            wif = self.write_inflight
            c = wif.get(fid, 0) - 1
            if c > 0:
                wif[fid] = c
            else:
                wif.pop(fid, None)
            data = slot.wdata
            if data is not None:
                slot.wdata = None
                if err == wire.E_OK:
                    self.cache_hook(fid, slot.woff, data)

    # -- delivery (TailB/TailC discipline) ------------------------------------------
    def _deliver(self, g: _GroupState) -> int:
        # Advance TailB over the contiguous completed prefix (ordered
        # execution); completed slots queue for delivery in order.
        pending = g.pending
        while pending:
            slot = pending[0]
            if not slot.done:
                break
            pending.popleft()
            g.tail_b = slot.off + slot.size
            if not slot.pad:
                g.ready.append(slot)
        if not g.ready:
            return 0
        if (g.tail_b - g.tail_c < self.delivery_batch
                and self.clock.now - g.ready[0].done_tick < self.deliver_ticks):
            # Latency-adaptive delivery: batch responses for DMA efficiency
            # (``delivery_batch`` > 1), but never hold a completed response
            # past ``deliver_ticks`` — the age of the OLDEST ready slot
            # bounds the wait, so a trickle of responses still flushes.
            return 0
        # ONE gathered DMA write + ONE doorbell deliver as many ready
        # responses as the host ring accepts: frame headers interleave with
        # memoryviews of the response buffer, so response bytes move exactly
        # once (DPU response buffer -> host ring).  TailC advances to the
        # end of the delivered prefix.
        space = g.resp_ring.free_space(self.dma)
        hdr_n = FRAME_HDR.size
        used = 0
        take = 0
        last = None
        sizes: list = []
        for slot in g.ready:
            need = used + hdr_n + slot.size
            if need > space:
                break
            sizes.append(slot.size)
            used = need
            take += 1
            last = slot
        if not take:
            return 0  # host ring full; retry next step
        # Batch header-fill: every frame-length word of the burst lands in
        # ONE preallocated header arena with a single array store; the
        # parts list interleaves arena views with response-buffer views, so
        # the publish stays one gathered DMA write (and response bytes
        # still move exactly once).
        arena = bytearray(take * hdr_n)
        np.frombuffer(arena, dtype="<u4")[:] = sizes
        amv = memoryview(arena)
        parts: list = []
        i = 0
        for slot in g.ready:
            if i >= take:
                break
            parts.append(amv[i * hdr_n:(i + 1) * hdr_n])
            parts.append(self._resp_view(g, slot.off, slot.size))
            i += 1
        if not g.resp_ring.publish_batch(self.dma, parts, used):
            return 0
        g.tail_c = last.off + last.size
        for _ in range(take):
            g.ready.popleft()
        self.stats.response_batches += 1
        self.stats.responses_delivered += take
        if g.interrupt:
            g.interrupt()
        return 1
