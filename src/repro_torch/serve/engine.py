"""Serving engine: continuous batching + DDS-backed KV-block offloading.

Port of ``repro.serve.engine``.  ``make_serve_fns`` builds the serve entry
points on a ``DeviceMesh``: prefill and the decode step on DTensors placed
by the sharding rules, run eagerly under an ``activation_sharding_scope``.

``PagedKVEngine`` is the DDS integration: KV blocks of a long context are
pages in a store.  Hot/recent blocks live on the card (the pool that the
paged-attention kernel reads through its block table); cold blocks spill to
the DDS page store (storage server) and are fetched back through the
OFFLOAD path — cold, simple, read-only reads, exactly what the paper
offloads — while writes (new KV blocks) take the host path.

``BatchScheduler`` is a minimal continuous-batching front: requests join or
leave decode slots between steps.  On a card it replays its decode step
from a CUDA graph (``DecodeGraph``, the port of the reference's
``jax.jit(api.decode_step)``); on the CPU it calls the step eagerly.
``DecodeGraph`` also captures the sharded decode step of ``make_serve_fns``
(the reference's jit with in/out shardings) on DTensors placed by its
``in_specs``.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import obs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.dds_server import DDSClient, encode_batch
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import P
from repro_torch.models.registry import ModelAPI
from repro_torch.storage.pagestore import PageStore
from repro_torch.tree import leaves as tree_leaves
from repro_torch.tree import tree_clone

PREFILL_2D_BYTES = 4 << 30   # 1D-TP weights above this per rank -> go 2D


def make_serve_fns(api: ModelAPI, mesh, axes_tree, shape: ShapeConfig,
                   pshapes=None):
    """Returns (prefill_jit, decode_jit): each takes an example of its
    input (a batch, a cache) and gives a callable with explicit shardings.

    DECODE always uses 2D weight sharding (model TP x data FSDP), and its
    cache is placed by ``cache_specs``.  PREFILL uses 1D TP weights unless
    they pass ``PREFILL_2D_BYTES`` a rank, then 2D as decode.  Prefill runs
    under the scope's "train" mode where the config pins prefill
    activations (``pin_prefill``), else "decode", as the reference's dry
    run scopes it.  Both calls are eager; their outputs stay DTensors
    (decode's logits and cache placed as its inputs).  Prefill also takes
    ``api.prefill``'s ``cache_len``, which the reference's jitted call
    cannot.  Each callable has ``in_specs``: prefill's (params, batch),
    decode's (params, cache, token) specs; inputs placed so are used as
    they are (``DecodeGraph`` captures decode on such inputs).
    """
    if pshapes is None:
        from repro_torch.train.loop import abstract_init
        pshapes, _ = abstract_init(api)
    model_size = sh.mesh_shape(mesh).get("model", 1)
    params_1d = sum(p.numel() * 2 for p in tree_leaves(pshapes)) // max(1, model_size)
    prefill_fsdp = params_1d > PREFILL_2D_BYTES
    pspecs_prefill = sh.sanitize_tree(
        sh.param_specs(axes_tree, mesh, api.cfg, fsdp=prefill_fsdp),
        pshapes, mesh)
    pspecs = sh.sanitize_tree(
        sh.param_specs(axes_tree, mesh, api.cfg, fsdp=True), pshapes, mesh)
    dp = sh.dp_axes(mesh)
    tok_spec = P(dp if shape.global_batch >= _ndp(mesh) else None, None)
    prefill_mode = "train" if api.cfg.pin_prefill else "decode"

    def decode_jit(cache_like):
        cspecs = sh.cache_specs(cache_like, mesh, api.cfg, shape)

        def run(params, cache, kv_len, token):
            params = sh.place(params, pspecs, mesh)
            cache = sh.place(cache, cspecs, mesh)
            token = sh.place(token, tok_spec, mesh)
            with sh.activation_sharding_scope(mesh, "decode"), implicit_replication():
                logits, cache = api.decode_step(params, cache, kv_len, token)
            return sh.place(logits, tok_spec, mesh), sh.place(cache, cspecs, mesh)

        run.in_specs = (pspecs, cspecs, tok_spec)
        return run

    def prefill_jit(batch_like):
        bspecs = sh.batch_specs(mesh, shape, api.cfg)
        in_b = {k: bspecs.get(k, P(dp, None)) for k in batch_like}

        def run(params, batch, cache_len=None):
            params = sh.place(params, pspecs_prefill, mesh)
            batch = sh.place(batch, {k: in_b[k] for k in batch}, mesh)
            with sh.activation_sharding_scope(mesh, prefill_mode), implicit_replication():
                return api.prefill(params, batch, cache_len)

        run.in_specs = (pspecs_prefill, {k: in_b[k] for k in batch_like})
        return run

    return prefill_jit, decode_jit


def _ndp(mesh) -> int:
    n = 1
    sizes = sh.mesh_shape(mesh)
    for a in sh.dp_axes(mesh):
        n *= sizes[a]
    return n


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

    A block larger than the store's page payload spans ``parts`` store
    pages, written and fetched in order: the store's pages stay the size
    its host path writes whole (a page larger than one write request of the
    storage server is split on the way and never cached for the DPU, so it
    could not be offloaded).  ``fetches`` counts blocks, the store's
    offload counters pages.
    """

    def __init__(self, page_store: PageStore, block_bytes: int,
                 hbm_blocks: int):
        self.store = page_store
        self.block_bytes = block_bytes
        self.parts = max(1, -(-block_bytes // page_store.payload_size))
        self.hbm_blocks = hbm_blocks
        self.pool: dict[int, tuple[int, int, int]] = {}  # slot -> (seq,layer,blk)
        self.where: dict[tuple[int, int, int], int] = {}  # key -> slot
        self.lru: deque = deque()
        self.versions: dict[tuple[int, int, int], int] = {}
        self.spills = 0
        self.fetches = 0
        self.hits = 0
        self._client: DDSClient | None = None
        self._page_ids: dict[tuple[tuple[int, int, int], int], int] = {}

    def _page_id(self, key: tuple[int, int, int], part: int = 0) -> int:
        """Dense page ids of a block's parts (the page store's file is
        offset = id * page_size)."""
        pid = self._page_ids.get((key, part))
        if pid is None:
            pid = len(self._page_ids)
            self._page_ids[(key, part)] = pid
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
        size = self.store.payload_size
        for part in range(self.parts):
            self.store.replay(self._page_id(key, part), ver,
                              data[part * size:(part + 1) * size])
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
        self.fetches += 1
        payloads = []
        for part in range(self.parts):
            rid = self._client._next_req
            self._client._next_req += 1
            msg = PageStore.encode_get(rid, self._page_id(key, part),
                                       self.versions.get(key, 0))
            self._client._send(encode_batch([msg]))
            status, body = self._client.wait(rid)
            if status != 0:
                return None
            payloads.append(PageStore.decode_page(body)[1])
        return b"".join(payloads)


# ---------------------------------------------------------------------------
# The captured decode step.
# ---------------------------------------------------------------------------


def _signature(tree) -> tuple:
    """What a graph holds fixed of a tree: each tensor's address, shape and
    dtype (a DTensor's of its local shard, beside its placements and
    mesh: a DTensor's own ``data_ptr`` is 0), and every other leaf's
    value."""
    def one(t):
        if isinstance(t, DTensor):
            return one(t.to_local()) + (tuple(t.placements), t.device_mesh)
        if isinstance(t, torch.Tensor):
            return (t.data_ptr(), tuple(t.shape), t.dtype)
        return t
    return tuple(one(t) for t in tree_leaves(tree))


def _cuda_device(cache) -> torch.device:
    """The one CUDA device that holds every tensor of ``cache`` (a
    DTensor's local shard); raises for any other placement."""
    devices = {sh.local(t).device for t in tree_leaves(cache)
               if isinstance(t, torch.Tensor)}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"DecodeGraph needs a cache on one CUDA device, "
                         f"not {sorted(map(str, devices))}")
    return devices.pop()


def write_back(step, params, cache, kv_len, token):
    """One decode step that leaves its new state in ``cache``: the body a
    ``DecodeGraph`` captures.  Runs on any device.

    The dense and paged caches and the attention caches of the hybrid are
    written in place by the step; every state tensor it returns new (the
    RWKV6 tuple, the hybrid's Mamba carries) is copied into ``cache``'s.
    A DTensor is written in its own placements.  Returns the logits.
    """
    logits, new = step(params, cache, kv_len, token)
    for dst, src in zip(tree_leaves(cache), tree_leaves(new), strict=True):
        if isinstance(dst, torch.Tensor) and src is not dst:
            dst.copy_(sh.like(src, dst))
    return logits


class DecodeGraph:
    """A decode step captured in a CUDA graph and replayed: the port of the
    reference's ``jax.jit(api.decode_step)``.

    Built on a step function ``(params, cache, kv_len, token) -> (logits,
    cache)``, the params and the cache it serves; called like the step.
    The first call captures ``write_back`` of the step into one graph for
    this batch and cache; every call fills the static ``(B, 1)`` token and
    0-d int32 ``kv_len`` buffers and replays it.  It returns the static
    logits, which the next call overwrites (a caller that keeps them clones
    them), and the cache, whose tensors hold the new state.

    Before the capture the step runs a few times on a side stream on
    clones of the cache: that builds and loads the kernels, sets their
    launch attributes and sets up cuBLAS, none of which may happen inside a
    capture, and leaves the cache as it was, so the first replay is the
    first step.  Params or a cache other than the captured ones (another
    tensor, shape or dtype at any leaf, or a token of another shape) raise:
    a replay reads and writes the captured addresses only.  Kernel wrappers
    count the launches of the warm-up and of the capture, never a
    replay's.  Needs a CUDA device; on the CPU call the step itself.
    The capture's node range of each of the program's spans goes to
    ``obs.maps``.

    It also takes the sharded step, ``make_serve_fns(...)[1](cache)``, on
    DTensors: give it params, cache and tokens already placed by that
    step's ``in_specs``, so that placing them costs nothing inside the
    graph.  The warm-up steps then also let DTensor plan each op (its
    sharding propagation runs on the host and caches its plans), and a
    DTensor leaf is held to its local shard's address, shape and dtype and
    to its placements and mesh.
    """

    WARMUP = 3

    def __init__(self, step, params, cache):
        self.step, self.params, self.cache = step, params, cache
        self.device = _cuda_device(cache)
        self._sig = (_signature(params), _signature(cache))
        self.graph = None

    @torch.no_grad()   # not inference_mode: DTensor views refuse it
    def __call__(self, params, cache, kv_len, token):
        if (_signature(params), _signature(cache)) != self._sig:
            raise ValueError("DecodeGraph called with params or a cache other "
                             "than the ones it was built on")
        if self.graph is None:
            self._capture(token)
        elif token.shape != self._token.shape:
            raise ValueError(f"DecodeGraph captured tokens of shape "
                             f"{tuple(self._token.shape)}, got {tuple(token.shape)}")
        sh.local(self._token).copy_(sh.local(token))
        if isinstance(kv_len, torch.Tensor):
            self._kv_len.copy_(kv_len)
        else:
            self._kv_len.fill_(kv_len)
        self.graph.replay()
        return self.logits, self.cache

    def _capture(self, token) -> None:
        if isinstance(token, DTensor):
            self._token = sh.from_local_like(torch.zeros_like(token.to_local()),
                                             token.device_mesh, token.placements,
                                             token)
        else:
            self._token = torch.zeros_like(token, device=self.device)
        self._kv_len = torch.zeros((), dtype=torch.int32, device=self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            scratch = tree_clone(self.cache)
            for _ in range(self.WARMUP):
                write_back(self.step, self.params, scratch, self._kv_len,
                           self._token)
        torch.cuda.current_stream(self.device).wait_stream(side)
        del scratch
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph), obs.capture():
            self.logits = write_back(self.step, self.params, self.cache,
                                     self._kv_len, self._token)
        self.graph = graph


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
    all slots, only ``prompt[-1]`` is fed, and there is no prefill.  As the
    reference compiles its step once (``jax.jit``), ``self._decode`` is a
    ``DecodeGraph`` over ``api.decode_step``, the params and the cache on a
    card, and ``api.decode_step`` itself on the CPU.
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
        self._decode = (DecodeGraph(api.decode_step, params, self.cache)
                        if api.device.type == "cuda" else api.decode_step)

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
        kv_len = torch.full((), self.kv_len, dtype=torch.int32,
                            device=self.api.device)
        logits, self.cache = self._decode(self.params, self.cache, kv_len,
                                          token)
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
