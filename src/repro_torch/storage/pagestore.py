"""Page store + KV store on DDS — the paper's two production integrations (§9).

``PageStore`` mirrors the Azure SQL Hyperscale page server (§9.1):

  * pages live in one RBPEX-like file on the storage server;
  * the host "replays log records" by writing whole pages (host path);
  * a ``GetPage@LSN`` network request is offloaded to the DPU iff the cache
    table says its cached LSN >= the requested LSN (``OffPred``), otherwise
    it is forwarded to the host, which serves the freshest copy;
  * ``Cache`` (cache-on-write) keys {page_id -> (file, offset, size, lsn)}
    parsed from the page header; ``Invalidate`` (invalidate-on-read) drops
    entries the host pulls back for modification.

``KVStoreServer`` mirrors the FASTER integration (§9.2): an append-only
record log whose tail lives in host memory (in-place updates / RMW on the
host) and whose older records are flushed to an IDevice implemented with the
DDS front-end library.  Flushing caches {key -> (file, offset, size)} so GET
requests for on-disk records are served entirely by the DPU.

Both classes needed only the four Table-1 functions plus a file — the
"hundreds of lines of code" adoption story of the paper.
"""

from __future__ import annotations

import struct
import threading
from dataclasses import dataclass, field

from repro_torch.core import wire
from repro_torch.core.dds_server import DDSStorageServer, ServerConfig
from repro_torch.core.offload import OffloadAPI, ReadOp, WriteOp

# -- network message formats --------------------------------------------------------
# GetPage@LSN: type, req_id, page_id, lsn
PAGE_GET = 3
PAGE_GET_HDR = struct.Struct("<BQQQ")
# KV GET: type, req_id, klen, key
KV_GET = 4
KV_GET_HDR = struct.Struct("<BQI")
# page on disk: [lsn u64][payload ...]
PAGE_HDR = struct.Struct("<Q")


@dataclass
class PageItem:
    file_id: int
    offset: int
    size: int
    lsn: int


class PageStore:
    """A DDS-backed page server (GetPage@LSN semantics)."""

    def __init__(self, page_size: int = 8192, num_pages: int = 4096,
                 config: ServerConfig | None = None):
        self.page_size = page_size
        self.payload_size = page_size - PAGE_HDR.size
        api = OffloadAPI(self._off_pred, self._off_func,
                         cache=self._cache, invalidate=self._invalidate,
                         response_header=self._resp_header,
                         host_handler=self._host_handler)
        cfg = config or ServerConfig(
            device_capacity=max(1 << 28, 2 * page_size * num_pages))
        self.server = DDSStorageServer(cfg, api)
        self.file_id = self.server.frontend.create_file("rbpex")
        self.server.fs.ensure_capacity(self.file_id, page_size * num_pages)
        self.host_served = 0     # reads that fell back to the host (stale cache)

    # -- Table 1 functions -------------------------------------------------------------
    def _off_pred(self, payload: bytes, table) -> tuple[list[bytes], list[bytes]]:
        from repro_torch.core.dds_server import decode_batch
        host, dpu = [], []
        for m in decode_batch(payload):
            if m and m[0] == PAGE_GET:
                _, rid, page_id, lsn = PAGE_GET_HDR.unpack_from(m, 0)
                item: PageItem | None = table.lookup(page_id) if table else None
                # Offload iff the DPU's view of the page is fresh enough (§9.1).
                if item is not None and item.lsn >= lsn:
                    dpu.append(m)
                else:
                    host.append(m)
            else:
                host.append(m)
        return host, dpu

    def _off_func(self, msg: bytes, table) -> ReadOp | None:
        if not msg or msg[0] != PAGE_GET:
            return None
        _, rid, page_id, lsn = PAGE_GET_HDR.unpack_from(msg, 0)
        item: PageItem | None = table.lookup(page_id) if table else None
        if item is None:
            return None
        return ReadOp(item.file_id, item.offset, item.size)

    def _cache(self, op: WriteOp) -> list[tuple[object, object]]:
        """cache-on-write: every aligned page fully covered by the write."""
        out = []
        if op.offset % self.page_size != 0:
            return out  # unaligned partial write: leave cache alone (host-fresh)
        pos = 0
        while pos + self.page_size <= len(op.data):
            off = op.offset + pos
            (lsn,) = PAGE_HDR.unpack_from(op.data, pos)
            page_id = off // self.page_size
            out.append((page_id, PageItem(op.file_id, off, self.page_size, lsn)))
            pos += self.page_size
        return out

    def _invalidate(self, op: ReadOp) -> list[object]:
        """invalidate-on-read: the host pulled these pages back to modify."""
        first = op.offset // self.page_size
        last = (op.offset + op.size - 1) // self.page_size
        return list(range(first, last + 1))

    def _resp_header(self, msg: bytes, op: ReadOp, err: int) -> bytes:
        from repro_torch.core.dds_server import APP_RESP_HDR
        req_id = PAGE_GET_HDR.unpack_from(msg, 0)[1] if msg else 0
        return APP_RESP_HDR.pack(req_id, err, op.size if err == wire.E_OK else 0)

    def _host_handler(self, msg: bytes) -> tuple:
        """Host serves GetPage when the DPU cache is stale (partial offload)."""
        if msg and msg[0] == PAGE_GET:
            _, req_id, page_id, lsn = PAGE_GET_HDR.unpack_from(msg, 0)
            self.host_served += 1
            return ("r", req_id, self.file_id, page_id * self.page_size,
                    self.page_size)
        return ("resp", 0, wire.E_INVAL, b"")

    # -- host-side page replay (log apply writes whole pages) ---------------------------
    def replay(self, page_id: int, lsn: int, payload: bytes) -> None:
        assert len(payload) <= self.payload_size
        page = PAGE_HDR.pack(lsn) + payload.ljust(self.payload_size, b"\x00")
        self.server.frontend.write_sync(self.file_id, page_id * self.page_size,
                                        page)
        self.server.run_until_idle()

    def host_read_for_update(self, page_id: int) -> bytes:
        """Host reads a page to modify it -> invalidate-on-read fires."""
        data = self.server.frontend.read_sync(self.file_id,
                                              page_id * self.page_size,
                                              self.page_size)
        self.server.run_until_idle()
        return data

    @staticmethod
    def encode_get(req_id: int, page_id: int, lsn: int) -> bytes:
        return PAGE_GET_HDR.pack(PAGE_GET, req_id, page_id, lsn)

    @staticmethod
    def decode_page(data: bytes) -> tuple[int, bytes]:
        (lsn,) = PAGE_HDR.unpack_from(data, 0)
        return lsn, data[PAGE_HDR.size:]


@dataclass
class KVItem:
    file_id: int
    offset: int
    size: int


class KVStoreServer:
    """FASTER-like disaggregated KV service with DDS offloading (§9.2)."""

    REC_HDR = struct.Struct("<II")  # klen, vlen

    def __init__(self, memory_budget: int = 1 << 20,
                 config: ServerConfig | None = None):
        api = OffloadAPI(self._off_pred, self._off_func,
                         cache=self._cache, invalidate=None,
                         response_header=self._resp_header,
                         host_handler=self._host_handler)
        self.server = DDSStorageServer(config or ServerConfig(), api)
        self.file_id = self.server.frontend.create_file("kvlog")
        self.memory_budget = memory_budget
        self._tail: dict[bytes, bytes] = {}        # in-memory mutable log tail
        self._tail_bytes = 0
        self._index: dict[bytes, KVItem] = {}      # host hash index (disk part)
        self._log_off = 0
        self._pending_flush: dict[int, bytes] = {}  # offset -> key (Cache needs it)
        self._lock = threading.Lock()

    # -- Table 1 functions ---------------------------------------------------------------
    def _off_pred(self, payload: bytes, table) -> tuple[list[bytes], list[bytes]]:
        from repro_torch.core.dds_server import decode_batch
        host, dpu = [], []
        for m in decode_batch(payload):
            if m and m[0] == KV_GET:
                _, rid, klen = KV_GET_HDR.unpack_from(m, 0)
                # decode_batch returns memoryviews; the table key must hash
                key = bytes(m[KV_GET_HDR.size : KV_GET_HDR.size + klen])
                if table is not None and table.lookup(key) is not None:
                    dpu.append(m)      # on-disk record: the DPU serves it
                else:
                    host.append(m)     # in the mutable tail (or missing)
            else:
                host.append(m)
        return host, dpu

    def _off_func(self, msg: bytes, table) -> ReadOp | None:
        if not msg or msg[0] != KV_GET:
            return None
        _, rid, klen = KV_GET_HDR.unpack_from(msg, 0)
        key = bytes(msg[KV_GET_HDR.size : KV_GET_HDR.size + klen])
        item: KVItem | None = table.lookup(key) if table else None
        if item is None:
            return None
        return ReadOp(item.file_id, item.offset, item.size)

    def _cache(self, op: WriteOp) -> list[tuple[object, object]]:
        """cache-on-write: parse flushed records, cache their locations."""
        out = []
        pos = 0
        while pos + self.REC_HDR.size <= len(op.data):
            klen, vlen = self.REC_HDR.unpack_from(op.data, pos)
            total = self.REC_HDR.size + klen + vlen
            key = bytes(op.data[pos + self.REC_HDR.size : pos + self.REC_HDR.size + klen])
            out.append((key, KVItem(op.file_id, op.offset + pos, total)))
            pos += total
        return out

    def _resp_header(self, msg: bytes, op: ReadOp, err: int) -> bytes:
        from repro_torch.core.dds_server import APP_RESP_HDR
        req_id = KV_GET_HDR.unpack_from(msg, 0)[1] if msg else 0
        return APP_RESP_HDR.pack(req_id, err, op.size if err == wire.E_OK else 0)

    def _host_handler(self, msg: bytes) -> tuple:
        """GETs for tail-resident records execute on the host (§9.2/§2)."""
        if msg and msg[0] == KV_GET:
            _, req_id, klen = KV_GET_HDR.unpack_from(msg, 0)
            # msg may be a zero-copy view; dict keys must be real bytes
            key = bytes(msg[KV_GET_HDR.size : KV_GET_HDR.size + klen])
            with self._lock:
                val = self._tail.get(key)
            if val is not None:
                body = self.REC_HDR.pack(len(key), len(val)) + key + val
                return ("resp", req_id, wire.E_OK, body)
            item = self._index.get(key)
            if item is not None:  # not yet in the DPU cache table
                return ("r", req_id, item.file_id, item.offset, item.size)
            return ("resp", req_id, wire.E_NOENT, b"")
        return ("resp", 0, wire.E_INVAL, b"")

    # -- host operations -----------------------------------------------------------------
    def upsert(self, key: bytes, value: bytes) -> None:
        with self._lock:
            old = self._tail.get(key)
            self._tail[key] = value
            self._tail_bytes += len(key) + len(value) - (
                len(old) + len(key) if old is not None else 0)
        if self._tail_bytes > self.memory_budget:
            self.flush()

    def rmw(self, key: bytes, fn) -> bytes:
        """Read-modify-write executes on the host (warm data, big cache: §2)."""
        with self._lock:
            cur = self._tail.get(key)
        if cur is None:
            item = self._index.get(key)
            if item is not None:
                raw = self.server.frontend.read_sync(item.file_id, item.offset,
                                                     item.size)
                klen, vlen = self.REC_HDR.unpack_from(raw, 0)
                cur = raw[self.REC_HDR.size + klen:]
        new = fn(cur)
        self.upsert(key, new)
        return new

    def flush(self) -> None:
        """Flush the tail to the IDevice (DDS front-end) — fires Cache()."""
        with self._lock:
            recs, keys = [], []
            for k, v in self._tail.items():
                recs.append(self.REC_HDR.pack(len(k), len(v)) + k + v)
                keys.append(k)
            blob = b"".join(recs)
            base = self._log_off
            self._log_off += len(blob)
            self._tail.clear()
            self._tail_bytes = 0
        if not blob:
            return
        self.server.frontend.write_sync(self.file_id, base, blob)
        # Update the host index to the on-disk location as well.
        pos = 0
        for r, k in zip(recs, keys):
            self._index[k] = KVItem(self.file_id, base + pos, len(r))
            pos += len(r)
        self.server.run_until_idle()

    def get_local(self, key: bytes) -> bytes | None:
        with self._lock:
            if key in self._tail:
                return self._tail[key]
        item = self._index.get(key)
        if item is None:
            return None
        raw = self.server.frontend.read_sync(item.file_id, item.offset, item.size)
        klen, vlen = self.REC_HDR.unpack_from(raw, 0)
        return raw[self.REC_HDR.size + klen:]

    @staticmethod
    def encode_get(req_id: int, key: bytes) -> bytes:
        return KV_GET_HDR.pack(KV_GET, req_id, len(key)) + key

    @staticmethod
    def decode_record(data: bytes) -> tuple[bytes, bytes]:
        klen, vlen = KVStoreServer.REC_HDR.unpack_from(data, 0)
        k = data[KVStoreServer.REC_HDR.size : KVStoreServer.REC_HDR.size + klen]
        v = data[KVStoreServer.REC_HDR.size + klen :
                 KVStoreServer.REC_HDR.size + klen + vlen]
        return k, v
