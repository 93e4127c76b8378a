"""Serving engine: continuous batching + DDS-backed KV-block offloading.

Port of ``repro.serve.engine`` (``make_serve_fns``, the mesh-sharded entry
points, waits for the multi-GPU slice).

``PagedKVEngine`` is the DDS integration: KV blocks of a long context are
pages in a store.  Hot/recent blocks live on the card (the pool that the
paged-attention kernel reads through its block table); cold blocks spill to
the DDS page store (storage server) and are fetched back through the
OFFLOAD path — cold, simple, read-only reads, exactly what the paper
offloads — while writes (new KV blocks) take the host path.

``BatchScheduler`` is a minimal continuous-batching front: requests join or
leave decode slots between steps.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.dds_server import DDSClient, encode_batch
from repro_torch.models.registry import ModelAPI
from repro_torch.storage.pagestore import PageStore

# ---------------------------------------------------------------------------
# DDS-backed paged KV offloading.
# ---------------------------------------------------------------------------


@dataclass
class KVBlockMeta:
    seq_id: int
    layer: int
    block: int
    version: int


class PagedKVEngine:
    """Device block pool + DDS page store spillover for long-context decode.

    The pool holds ``hbm_blocks`` KV pages; a block table maps
    (sequence, logical block) -> pool slot.  When the pool overflows, the
    coldest blocks are written to the DDS page store (HOST path — writes
    belong on the host, §3) and their slots recycled.  A query that needs a
    cold block triggers a fetch via the OFFLOAD path (DPU-served read).
    """

    def __init__(self, page_store: PageStore, block_bytes: int,
                 hbm_blocks: int):
        self.store = page_store
        self.block_bytes = block_bytes
        self.hbm_blocks = hbm_blocks
        self.pool: dict[int, tuple[int, int, int]] = {}  # slot -> (seq,layer,blk)
        self.where: dict[tuple[int, int, int], int] = {}  # key -> slot
        self.lru: deque = deque()
        self.versions: dict[tuple[int, int, int], int] = {}
        self.spills = 0
        self.fetches = 0
        self.hits = 0
        self._client: DDSClient | None = None
        self._page_ids: dict[tuple[int, int, int], int] = {}

    def _page_id(self, key: tuple[int, int, int]) -> int:
        """Dense page ids (the page store's file is offset = id * page_size)."""
        pid = self._page_ids.get(key)
        if pid is None:
            pid = len(self._page_ids)
            self._page_ids[key] = pid
        return pid

    def put_block(self, seq: int, layer: int, blk: int, data: bytes) -> int:
        """New KV block (decode write).  Returns the pool slot."""
        key = (seq, layer, blk)
        ver = self.versions.get(key, 0) + 1
        self.versions[key] = ver
        if len(self.pool) >= self.hbm_blocks:
            self._evict_one()
        slot = self._free_slot()
        self.pool[slot] = key
        self.where[key] = slot
        self.lru.append(key)
        # Write-through to the store on the HOST path (durable + cacheable).
        self.store.replay(self._page_id(key), ver, data[: self.store.payload_size])
        return slot

    def _free_slot(self) -> int:
        used = set(self.pool)
        for s in range(self.hbm_blocks):
            if s not in used:
                return s
        raise RuntimeError("pool full after eviction")

    def _evict_one(self) -> None:
        while self.lru:
            key = self.lru.popleft()
            slot = self.where.get(key)
            if slot is not None and self.pool.get(slot) == key:
                del self.pool[slot]
                del self.where[key]
                self.spills += 1
                return

    def get_block(self, seq: int, layer: int, blk: int) -> bytes | None:
        """Fetch a block; cold blocks come back via the DPU offload path."""
        key = (seq, layer, blk)
        if key in self.where:
            self.hits += 1
            self.lru.append(key)  # refresh
            return None  # already in the pool; caller uses the block table
        if self._client is None:
            self._client = DDSClient(self.store.server)
        rid = self._client._next_req
        self._client._next_req += 1
        msg = PageStore.encode_get(rid, self._page_id(key),
                                   self.versions.get(key, 0))
        self._client._send(encode_batch([msg]))
        status, body = self._client.wait(rid)
        self.fetches += 1
        if status != 0:
            return None
        _, payload = PageStore.decode_page(body)
        return payload


# ---------------------------------------------------------------------------
# Continuous batching (minimal).
# ---------------------------------------------------------------------------


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    generated: list[int] = field(default_factory=list)
    done: bool = False


class BatchScheduler:
    """Slot-based continuous batching over a fixed decode batch.

    Keeps the reference's behaviour exactly: one ``kv_len`` is shared by
    all slots, only ``prompt[-1]`` is fed, and there is no prefill.
    """

    def __init__(self, api: ModelAPI, params, slots: int, cache_len: int):
        self.api = api
        self.params = params
        self.slots = slots
        self.cache_len = cache_len
        self.queue: deque[Request] = deque()
        self.active: list[Request | None] = [None] * slots
        self.kv_len = 0
        self.cache = api.init_cache(slots, cache_len)
        self.tokens = np.zeros((slots, 1), np.int32)

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        for i in range(self.slots):
            if self.active[i] is None and self.queue:
                req = self.queue.popleft()
                self.active[i] = req
                self.tokens[i, 0] = int(req.prompt[-1])

    @torch.inference_mode()
    def step(self) -> int:
        """One decode step for all active slots; returns #completed."""
        self._admit()
        if not any(self.active):
            return 0
        token = torch.from_numpy(self.tokens).to(self.api.device)
        logits, self.cache = self.api.decode_step(
            self.params, self.cache, self.kv_len, token)
        self.kv_len = min(self.kv_len + 1, self.cache_len - 1)
        nxt = logits.argmax(-1).cpu().numpy()
        done = 0
        for i, req in enumerate(self.active):
            if req is None:
                continue
            tok = int(nxt[i])
            req.generated.append(tok)
            self.tokens[i, 0] = tok
            if len(req.generated) >= req.max_new:
                req.done = True
                self.active[i] = None
                done += 1
        return done
