"""Request/response encodings on the DDS rings (paper Figure 9).

A *request* is a fixed header followed, for writes, by the inlined data so
the entire request moves host->DPU in a single DMA read.  A *response* is a
fixed header followed, for reads, by the read data.  Control-plane operations
(file/directory management) use the same header with op-specific payloads —
the paper optimizes the data plane; control ops are rare.

All integers little-endian.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

# ---- op codes ---------------------------------------------------------------
OP_READ = 1
OP_WRITE = 2
OP_CREATE_FILE = 3
OP_CREATE_DIR = 4
OP_DELETE_FILE = 5
OP_TRUNCATE = 6
OP_FSYNC = 7
OP_LIST_DIR = 8

DATA_PLANE_OPS = (OP_READ, OP_WRITE)

# ---- error codes --------------------------------------------------------------
E_PENDING = 0xFFFFFFFF  # response space pre-allocated, I/O not yet complete
E_OK = 0
E_NOENT = 2
E_IO = 5
E_INVAL = 22
E_NOSPC = 28
# Terminal client-side status for a request SHED under overload: the file
# service's bounded E_NOSPC emergency path gave up — or token-bucket
# admission refused it at the demux — so no response will ever arrive.
# Never travels on the wire — clients synthesize it from the lifecycle
# tracker's shed marks instead of spinning into a timeout.  The response
# BODY is a shed hint (see ``encode_shed_hint``) carrying the shedding
# tenant's bucket state, not empty bytes: the client learns WHEN a retry
# can be admitted instead of just that it was dropped.
E_SHED = 131
# Terminal client-side status for a request addressed to a shard the ring
# no longer routes there: the packet carried a stale ring epoch (or the
# owning shard died before responding) and a failover re-homed the keys.
# Like ``E_SHED`` it never travels on the wire — the director (or the
# cluster supervisor, for requests parked on a dead shard) marks the
# request terminally in the lifecycle tracker and the client synthesizes
# the status.  The body is a redirect hint (``encode_redirect_hint``)
# carrying the CURRENT ring epoch, so one retry against the repaired ring
# is guaranteed fresh.  Retryable: clients resubmit the same request id to
# the new owner (the old owner is dead or refused it, so the id cannot
# alias).
E_REDIRECT = 132

# Shed-hint body: tenant(u32) retry_after_ticks(u32).  ``retry_after`` is
# the shedding bucket's estimate of when one token will be available
# (admission sheds) or 1 (overload sheds: retry next tick is admissible).
SHED_HINT = struct.Struct("<II")

# Redirect-hint body: ring epoch(u32) after the repair that obsoleted the
# request's routing.  A client that re-routes with an epoch >= this value
# is acting on the post-failover ring.
REDIRECT_HINT = struct.Struct("<I")


def encode_redirect_hint(epoch: int) -> bytes:
    return REDIRECT_HINT.pack(min(max(epoch, 0), 0xFFFFFFFF))


def decode_redirect_hint(body: bytes | memoryview) -> int:
    """Decode an ``E_REDIRECT`` body -> current ring epoch (0 if absent)."""
    if len(body) < REDIRECT_HINT.size:
        return 0
    return REDIRECT_HINT.unpack_from(body, 0)[0]


def encode_shed_hint(tenant: int, retry_after: int) -> bytes:
    return SHED_HINT.pack(tenant & 0xFFFFFFFF,
                          min(max(retry_after, 0), 0xFFFFFFFF))


def decode_shed_hint(body: bytes | memoryview) -> tuple[int, int]:
    """Decode an ``E_SHED`` body -> ``(tenant, retry_after_ticks)``.

    Tolerates an empty body (legacy/unattributed sheds) as ``(0, 0)``.
    """
    if len(body) < SHED_HINT.size:
        return (0, 0)
    return SHED_HINT.unpack_from(body, 0)

# request header: op(u8) request_id(u64) file_id(u32) offset(u64) nbytes(u32)
REQ_HDR = struct.Struct("<BQIQI")
# response header: request_id(u64) error(u32) nbytes(u32)
RESP_HDR = struct.Struct("<QII")


@dataclass(slots=True)
class Request:
    op: int
    request_id: int
    file_id: int
    offset: int
    nbytes: int
    payload: bytes | memoryview = b""

    def encode(self) -> bytes:
        # join() accepts memoryview payloads without materializing them first
        return b"".join((REQ_HDR.pack(self.op, self.request_id, self.file_id,
                                      self.offset, self.nbytes), self.payload))


def decode_request(raw: bytes | memoryview) -> Request:
    """Decode a request; the payload stays a zero-copy view of ``raw``.

    The consumer's whole-batch DMA read owns the bytes; write payloads ride
    as ``memoryview`` slices all the way into ``submit_writev`` (§4.3
    "Eliminating data copies").  Callers needing ``str``/hashable payloads
    (control ops) materialize explicitly.
    """
    op, rid, fid, off, nbytes = REQ_HDR.unpack_from(raw, 0)
    payload = (raw if isinstance(raw, memoryview) else memoryview(raw))[REQ_HDR.size:]
    return Request(op, rid, fid, off, nbytes, payload)


@dataclass(slots=True)
class Response:
    request_id: int
    error: int
    nbytes: int
    payload: bytes = b""

    def encode(self) -> bytes:
        return RESP_HDR.pack(self.request_id, self.error, self.nbytes) + self.payload


def decode_response(raw: bytes | memoryview) -> Response:
    rid, err, nbytes = RESP_HDR.unpack_from(raw, 0)
    payload = bytes(raw[RESP_HDR.size : RESP_HDR.size + nbytes])
    return Response(rid, err, nbytes, payload)


def response_size_for(req: Request) -> int:
    """Expected response size — derivable in advance (§4.3 pre-allocation)."""
    if req.op == OP_READ:
        return RESP_HDR.size + req.nbytes
    if req.op in (OP_CREATE_FILE, OP_CREATE_DIR):
        return RESP_HDR.size + 4          # returns the new id
    if req.op == OP_LIST_DIR:
        return RESP_HDR.size + 4096       # bounded listing
    return RESP_HDR.size                   # write/others: header only
