"""DDS host front-end file library (§4.2).

A userspace library that storage applications link against instead of the OS
file system.  It offers a familiar file API — ``CreateDirectory``,
``CreateFile``, ``ReadFile``/``WriteFile`` (plus scattered reads & gathered
writes), ``CreatePoll``/``PollAdd``/``PollWait`` — while every operation is
encoded per Fig 9 and shipped to the DPU file service over the DMA rings of
§4.1.  All operations except ``PollWait`` are non-blocking.

``PollWait`` supports the paper's two modes:
  * non-blocking (``timeout_s=0``): returns immediately with whatever
    completions are available, letting the caller keep computing;
  * sleeping (``timeout_s>0``): the caller sleeps on an event that the "DPU
    driver interrupt" (fired by the file service after a response DMA-write)
    sets — zero CPU burned while waiting.
"""

from __future__ import annotations

import struct
import threading
from dataclasses import dataclass, field
from typing import Sequence

from repro_torch.core import wire
from repro_torch.core.file_service import FileServiceRunner
from repro_torch.core.ring import (FRAME_HDR, ProgressiveRing, ResponseRing, frame,
                             unframe_batch)

INVALID_HANDLE = -1

# Frame length + request header, packed in ONE struct call ("<I" + "<BQIQI";
# little-endian structs concatenate without padding, so the fused bytes are
# identical to frame-then-header).  Guard the duplication: a change to
# either canonical struct must fail loudly here, not desync the wire.
_FRAMED_REQ = struct.Struct(FRAME_HDR.format + wire.REQ_HDR.format.lstrip("<"))
_REQ_SIZE = wire.REQ_HDR.size
assert _FRAMED_REQ.size == FRAME_HDR.size + _REQ_SIZE


@dataclass(slots=True)
class _Op:
    """Book-kept in its notification group until the completion is polled."""
    request_id: int
    op: int
    file_id: int
    offset: int
    nbytes: int
    scatter: Sequence[bytearray] | None = None  # destinations for scattered reads
    done: bool = False
    error: int = wire.E_PENDING
    data: bytes = b""


@dataclass(slots=True)
class Completion:
    request_id: int
    op: int
    file_id: int
    error: int
    nbytes: int
    data: bytes = b""


class NotificationGroup:
    """An epoll-like completion group with its own request/response rings."""

    def __init__(self, group_id: int, req_ring: ProgressiveRing,
                 resp_ring: ResponseRing):
        self.group_id = group_id
        self.req_ring = req_ring
        self.resp_ring = resp_ring
        self.files: set[int] = set()
        self._ops: dict[int, _Op] = {}
        self._lock = threading.Lock()
        self._event = threading.Event()  # set by the DPU driver interrupt
        self._next_rid = 1

    def interrupt(self) -> None:
        self._event.set()

    def book(self, op: _Op) -> None:
        with self._lock:
            self._ops[op.request_id] = op

    def next_request_id(self) -> int:
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            return rid

    def next_request_ids(self, n: int) -> int:
        """Reserve ``n`` consecutive request ids in one lock round."""
        with self._lock:
            first = self._next_rid
            self._next_rid += n
            return first

    def book_many(self, ops: list[_Op]) -> None:
        with self._lock:
            book = self._ops
            for op in ops:
                book[op.request_id] = op

    def _drain_ring(self) -> list[Completion]:
        got: list[Completion] = []
        unpack = wire.RESP_HDR.unpack_from
        hdr = wire.RESP_HDR.size
        pop = self._ops.pop
        while True:
            claimed = self.resp_ring.try_claim()
            if claimed is None:
                break
            _, raw = claimed
            msgs = unframe_batch(raw)
            # One header unpack per message, ONE lock round per claimed
            # chunk to pop the whole batch's bookkeeping.
            heads = [unpack(m, 0) for m in msgs]
            with self._lock:
                ops = [pop(h[0], None) for h in heads]
            for (rid, err, nbytes), msg, op in zip(heads, msgs, ops):
                if op is None:
                    continue  # response for an op another thread owns? (popped)
                data = bytes(msg[hdr : hdr + nbytes]) if nbytes else b""
                if op.op == wire.OP_READ and op.scatter is not None:
                    pos = 0  # scattered read: split into destination buffers
                    for buf in op.scatter:
                        n = min(len(buf), len(data) - pos)
                        buf[:n] = data[pos : pos + n]
                        pos += n
                got.append(Completion(rid, op.op, op.file_id, err, nbytes,
                                      data if op.scatter is None else b""))
        return got

    def poll_wait(self, timeout_s: float = 0.0) -> list[Completion]:
        comps = self._drain_ring()
        if comps or timeout_s == 0.0:
            return comps  # non-blocking mode
        # Sleeping mode: wait for the driver interrupt, no spinning.
        self._event.clear()
        deadline = timeout_s
        if self._event.wait(deadline):
            comps = self._drain_ring()
        return comps

    def cancel(self, rid: int) -> bool:
        """Drop a booked op whose completion will never arrive (shed)."""
        with self._lock:
            return self._ops.pop(rid, None) is not None

    @property
    def outstanding(self) -> int:
        return len(self._ops)  # atomic len read; no lock on the poll path


class DDSFrontEnd:
    """The host file library.  One per storage application process."""

    def __init__(self, service: FileServiceRunner,
                 ring_capacity: int = 1 << 18,
                 max_progress: int | None = None,
                 doorbell=None):
        self.service = service
        self.ring_capacity = ring_capacity
        self.max_progress = max_progress
        # Work-signaled scheduling: every request ring this library creates
        # fires ``doorbell`` when a producer publishes messages, so inserts
        # from any thread mark the owning server runnable (no lost wakeups
        # even when the producer is not the server's own pump loop).
        self.doorbell = doorbell
        self._groups: dict[int, NotificationGroup] = {}
        self._file_group: dict[int, int] = {}
        self._next_group = 1
        self._lock = threading.Lock()
        # A default control group for applications that never create one.
        self._control_group = self.create_poll()

    # -- notification groups -------------------------------------------------------
    def create_poll(self) -> int:
        with self._lock:
            gid = self._next_group
            self._next_group += 1
        req = ProgressiveRing(self.ring_capacity, self.max_progress,
                              name=f"req-g{gid}")
        req.doorbell = self.doorbell
        resp = ResponseRing(self.ring_capacity, name=f"resp-g{gid}")
        group = NotificationGroup(gid, req, resp)
        # Rings are pre-registered to the DPU driver for DMA at creation time.
        self.service.register_group(gid, req, resp, interrupt=group.interrupt)
        with self._lock:
            self._groups[gid] = group
        return gid

    def poll_add(self, poll: int, file_handle: int) -> None:
        g = self._groups[poll]
        g.files.add(file_handle)
        self._file_group[file_handle] = poll

    def poll_wait(self, poll: int, timeout_s: float = 0.0) -> list[Completion]:
        return self._groups[poll].poll_wait(timeout_s)

    def any_outstanding(self) -> bool:
        """True while any notification group has un-polled operations."""
        for g in self._groups.values():
            if g.outstanding:
                return True
        return False

    def cancel(self, rid: int) -> bool:
        """Un-book a request whose completion will never arrive.

        The file service reports SHED requests (bounded E_NOSPC emergency
        path exhausted) through its ``shed_hook``; without cancellation the
        booked op would hold ``any_outstanding()`` true forever and wedge
        the owning server in a busy-but-unpumpable state."""
        for g in self._groups.values():
            if g.cancel(rid):
                return True
        return False

    # -- control plane ----------------------------------------------------------------
    def _sync_call(self, req: wire.Request) -> Completion:
        g = self._groups[self._control_group]
        req.request_id = g.next_request_id()
        g.book(_Op(req.request_id, req.op, req.file_id, req.offset, req.nbytes))
        g.req_ring.insert(frame(req.encode()))
        for _ in range(1_000_000):
            self.service.step()  # cooperative: drive the DPU when co-resident
            comps = g.poll_wait(0.0)
            if comps:
                return comps[0]
        raise TimeoutError("control op did not complete")

    def create_directory(self, name: str) -> int:
        c = self._sync_call(wire.Request(wire.OP_CREATE_DIR, 0, 0, 0, 0,
                                         name.encode()))
        if c.error != wire.E_OK:
            raise OSError(c.error, f"CreateDirectory({name})")
        return int.from_bytes(c.data[:4], "little")

    def create_file(self, name: str, directory: int = 0) -> int:
        c = self._sync_call(wire.Request(wire.OP_CREATE_FILE, 0, directory, 0, 0,
                                         name.encode()))
        if c.error != wire.E_OK:
            raise OSError(c.error, f"CreateFile({name})")
        return int.from_bytes(c.data[:4], "little")

    def delete_file(self, file_handle: int) -> None:
        c = self._sync_call(wire.Request(wire.OP_DELETE_FILE, 0, file_handle, 0, 0))
        if c.error != wire.E_OK:
            raise OSError(c.error, "DeleteFile")

    def fsync(self) -> None:
        c = self._sync_call(wire.Request(wire.OP_FSYNC, 0, 0, 0, 0))
        if c.error != wire.E_OK:
            raise OSError(c.error, "Fsync")

    # -- data plane (non-blocking) -------------------------------------------------
    def _group_for(self, file_handle: int) -> NotificationGroup:
        gid = self._file_group.get(file_handle, self._control_group)
        return self._groups[gid]

    def read_file(self, file_handle: int, offset: int, nbytes: int) -> int:
        """Non-blocking single read; returns the request id."""
        g = self._group_for(file_handle)
        rid = g.next_request_id()
        g.book(_Op(rid, wire.OP_READ, file_handle, offset, nbytes))
        g.req_ring.insert_v((
            _FRAMED_REQ.pack(_REQ_SIZE, wire.OP_READ, rid, file_handle,
                             offset, nbytes),))
        return rid

    def read_file_scatter(self, file_handle: int, offset: int,
                          bufs: Sequence[bytearray]) -> int:
        """Scattered read: one file I/O, results split across ``bufs``."""
        g = self._group_for(file_handle)
        rid = g.next_request_id()
        total = sum(len(b) for b in bufs)
        g.book(_Op(rid, wire.OP_READ, file_handle, offset, total, scatter=bufs))
        g.req_ring.insert_v((
            _FRAMED_REQ.pack(_REQ_SIZE, wire.OP_READ, rid, file_handle,
                             offset, total),))
        return rid

    def write_file(self, file_handle: int, offset: int, data) -> int:
        """Non-blocking single write; data inlined in the request (Fig 9).

        ``data`` may be ``bytes`` or a ``memoryview``: the gathered ring
        insert copies it exactly once — straight into the request ring (the
        DMA source).  No defensive copy, no header+payload join."""
        g = self._group_for(file_handle)
        rid = g.next_request_id()
        n = len(data)
        g.book(_Op(rid, wire.OP_WRITE, file_handle, offset, n))
        g.req_ring.insert_v((
            _FRAMED_REQ.pack(_REQ_SIZE + n, wire.OP_WRITE, rid, file_handle,
                             offset, n),
            data))
        return rid

    def submit_many(self, ops: Sequence[tuple]) -> list[int]:
        """Issue a burst of data-plane ops with ONE ring reservation per
        notification group.

        ``ops`` entries are ``("w", file_handle, offset, data)`` or
        ``("r", file_handle, offset, nbytes)``.  Request ids are reserved in
        bulk, bookkeeping is appended in bulk, and each group's messages go
        through :meth:`ProgressiveRing.insert_burst` — one tail CAS and one
        progress publish per burst chunk instead of per request.  Returns
        the request ids in op order.
        """
        per_group: dict[int, tuple[NotificationGroup, list, list, list]] = {}
        order: list[tuple[NotificationGroup, tuple]] = []
        for op in ops:
            gid = self._file_group.get(op[1], self._control_group)
            ent = per_group.get(gid)
            if ent is None:
                ent = per_group[gid] = (self._groups[gid], [], [], [0])
            ent[3][0] += 1
            order.append((ent[0], op))
        rid_of: dict[int, int] = {}
        for gid, (g, msgs, books, count) in per_group.items():
            rid_of[gid] = g.next_request_ids(count[0])
        rids: list[int] = []
        pack = _FRAMED_REQ.pack
        hdr_size = _REQ_SIZE
        for g, op in order:
            gid = g.group_id
            rid = rid_of[gid]
            rid_of[gid] = rid + 1
            rids.append(rid)
            kind, fh, offset, arg = op
            _, msgs, books, _n = per_group[gid]
            if kind == "w":
                n = len(arg)
                books.append(_Op(rid, wire.OP_WRITE, fh, offset, n))
                msgs.append((pack(hdr_size + n, wire.OP_WRITE, rid, fh,
                                  offset, n), arg))
            else:
                books.append(_Op(rid, wire.OP_READ, fh, offset, arg))
                msgs.append((pack(hdr_size, wire.OP_READ, rid, fh,
                                  offset, arg),))
        for g, msgs, books, _n in per_group.values():
            g.book_many(books)
            # Co-resident backpressure: when a burst chunk finds the ring
            # full, step the DPU service so the consumer drains (a blind
            # spin would deadlock a cooperative single-thread setup).
            g.req_ring.insert_burst(msgs, on_retry=self.service.step)
        return rids

    def write_file_gather(self, file_handle: int, offset: int,
                          bufs: Sequence[bytes]) -> int:
        """Gathered write: an array of source buffers, one file I/O.

        True scatter-gather — every buffer is copied once into the request
        ring; they are never joined into an intermediate buffer."""
        g = self._group_for(file_handle)
        rid = g.next_request_id()
        total = sum(len(b) for b in bufs)
        g.book(_Op(rid, wire.OP_WRITE, file_handle, offset, total))
        g.req_ring.insert_v((
            _FRAMED_REQ.pack(_REQ_SIZE + total, wire.OP_WRITE, rid,
                             file_handle, offset, total),
            *bufs))
        return rid

    # -- convenience synchronous wrappers (drive the co-resident service) ----------
    def _max_io(self, file_handle: int) -> int:
        """Largest single request: bounded by the ring's allowable progress
        (requests inline write data, Fig 9) and the response ring capacity."""
        g = self._group_for(file_handle)
        return min(g.req_ring.max_progress, g.resp_ring.capacity // 2) - 256

    def read_sync(self, file_handle: int, offset: int, nbytes: int) -> bytes:
        chunk = self._max_io(file_handle)
        parts = []
        for off in range(0, nbytes, chunk):
            n = min(chunk, nbytes - off)
            rid = self.read_file(file_handle, offset + off, n)
            parts.append(self._wait_one(file_handle, rid).data)
        return b"".join(parts)

    def write_sync(self, file_handle: int, offset: int, data: bytes) -> None:
        chunk = self._max_io(file_handle)
        for off in range(0, len(data), chunk):
            rid = self.write_file(file_handle, offset + off,
                                  data[off : off + chunk])
            c = self._wait_one(file_handle, rid)
            if c.error != wire.E_OK:
                raise OSError(c.error, "WriteFile")

    def _wait_one(self, file_handle: int, rid: int) -> Completion:
        g = self._group_for(file_handle)
        stash: list[Completion] = []
        for _ in range(1_000_000):
            self.service.step()
            for c in g.poll_wait(0.0):
                if c.request_id == rid:
                    if c.error != wire.E_OK and c.op == wire.OP_READ:
                        raise OSError(c.error, "ReadFile")
                    return c
                stash.append(c)
            self.service.fs.device.poll()
        raise TimeoutError(f"request {rid} did not complete")
