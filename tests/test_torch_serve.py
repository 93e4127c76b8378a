"""Port's serving engine against ``repro.serve.engine``: continuous batching
(greedy tokens equal to the JAX scheduler's) and DDS KV paging (spill,
offloaded fetch, versions), mirrored from tests/test_serve.py.

Both schedulers run JAX-initialised parameters cast to float32, so bf16
argmax ties cannot flip; the tokens must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models.registry import build_model as jax_build_model
from repro.serve.engine import BatchScheduler as JaxBatchScheduler
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs import get_config, reduced_config
from repro_torch.interop import to_torch
from repro_torch.models import transformer as TF
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import BatchScheduler, PagedKVEngine, Request
from repro_torch.storage.pagestore import PageStore

CPU = "cpu"


@pytest.fixture(scope="module")
def small_lm():
    changes = dict(num_layers=2, vocab_size=512)
    cfg = dataclasses.replace(reduced_config(get_config("tinyllama_1p1b")),
                              **changes)
    jcfg = dataclasses.replace(
        jax_reduced_config(jax_get_config("tinyllama_1p1b")), **changes)
    japi = jax_build_model(jcfg)
    jparams, _ = japi.init(jax.random.PRNGKey(0))
    jparams = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jparams)
    tparams = to_torch(jax.device_get(jparams), device=CPU)
    return build_model(cfg, device=CPU), tparams, japi, jparams


def _serve(sched_cls, req_cls, api, params, prompts, max_new, slots=4,
           cache_len=64):
    sched = sched_cls(api, params, slots=slots, cache_len=cache_len)
    reqs = [req_cls(i, p, max_new=max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        sched.submit(r)
    done = steps = 0
    while done < len(reqs) and steps < 500:
        done += sched.step()
        steps += 1
    return reqs, done, steps


def test_continuous_batching_completes(small_lm):
    api, params, _, _ = small_lm
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, size=4) for _ in range(10)]
    reqs, done, steps = _serve(BatchScheduler, Request, api, params, prompts, 5)
    assert done == 10
    assert all(len(r.generated) == 5 for r in reqs)
    # 10 requests over 4 slots need at least ceil(10/4)*5 steps
    assert steps >= 15


def test_greedy_tokens_equal_jax_scheduler(small_lm):
    api, params, japi, jparams = small_lm
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, size=4) for _ in range(6)]
    treqs, _, tsteps = _serve(BatchScheduler, Request, api, params, prompts, 4)
    jreqs, _, jsteps = _serve(JaxBatchScheduler, JaxRequest, japi, jparams,
                              prompts, 4)
    assert tsteps == jsteps
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]


def test_paged_kv_spill_and_fetch():
    store = PageStore(page_size=4096, num_pages=256)
    eng = PagedKVEngine(store, block_bytes=1024, hbm_blocks=4)
    blobs = {}
    for blk in range(12):
        data = bytes([blk]) * 1024
        blobs[blk] = data
        eng.put_block(0, 0, blk, data)
    assert eng.spills == 8                       # 12 blocks, 4 slots
    # cold fetch goes through the DPU offload path and returns page bytes
    before = store.server.offload.stats.completed
    got = eng.get_block(0, 0, 0)
    assert got[:1024] == blobs[0]
    assert store.server.offload.stats.completed == before + 1
    # hot block: pool hit, no store traffic
    assert eng.get_block(0, 0, 11) is None
    assert eng.hits == 1


def test_kv_block_versions_respected():
    store = PageStore(page_size=4096, num_pages=256)
    eng = PagedKVEngine(store, block_bytes=1024, hbm_blocks=2)
    eng.put_block(1, 0, 0, b"v1" * 512)
    eng.put_block(1, 0, 0, b"v2" * 512)          # rewrite bumps version
    eng.put_block(1, 0, 1, b"xx" * 512)
    eng.put_block(1, 0, 2, b"yy" * 512)          # evicts block 0
    got = eng.get_block(1, 0, 0)
    assert got[:1024] == b"v2" * 512             # freshest version came back


def test_real_kv_pages_survive_spill_and_offloaded_fetch(small_lm):
    """K pages of a decoded pool go to the store and come back bit-exact
    (the CPU rehearsal of chip_smoke.py's PagedKVEngine phase)."""
    api, params, _, _ = small_lm
    cfg = api.cfg
    paged = TF.lm_init_paged_cache(cfg, batch=2, max_len=16, page=4,
                                   device=CPU)
    tok = torch.from_numpy(np.random.default_rng(2).integers(0, 512, (2, 16)))
    for t in range(16):
        TF.lm_decode_step_paged(params, cfg, paged, t, tok[:, t:t + 1])
    pages = paged["k_pool"].to(torch.bfloat16)       # (L, P, page, KV, hd)
    page_bytes = pages[0, 0].numel() * pages.element_size()
    store = PageStore(page_size=page_bytes + 8, num_pages=64)
    eng = PagedKVEngine(store, block_bytes=page_bytes, hbm_blocks=2)
    blocks = [(l, p) for l in range(pages.shape[0]) for p in range(pages.shape[1])]
    for l, p in blocks:
        eng.put_block(0, l, p, pages[l, p].contiguous().view(torch.uint8)
                      .numpy().tobytes())
    assert eng.spills == len(blocks) - 2
    before = store.server.offload.stats.completed
    cold = blocks[:-2]
    for l, p in cold:
        got = eng.get_block(0, l, p)
        back = torch.frombuffer(bytearray(got[:page_bytes]), dtype=torch.bfloat16)
        assert torch.equal(back.view_as(pages[l, p]), pages[l, p])
    assert store.server.offload.stats.completed == before + len(cold)
    assert eng.fetches == len(cold)


def test_kv_block_larger_than_a_store_page_spans_several():
    """A 256 KiB block (one qwen2_vl_72b K page: 128 positions x 8 heads x
    128 x bf16) over a store of 64 KiB pages: written as 4 pages, every one
    cached for the DPU, fetched back whole and bit-exact through 4
    offloaded reads.  A store page of the block's own size is larger than
    one write request of the storage server, which splits it and caches
    none of it for the DPU: its read goes to the host, whose 256 KiB
    response never comes back."""
    rng = np.random.default_rng(3)
    blocks = [rng.integers(0, 256, 1 << 18, dtype=np.uint8).tobytes()
              for _ in range(3)]
    store = PageStore(page_size=(1 << 16) + 8, num_pages=12)
    eng = PagedKVEngine(store, block_bytes=1 << 18, hbm_blocks=1)
    assert eng.parts == 4
    for blk, data in enumerate(blocks):
        eng.put_block(0, 0, blk, data)
    before = store.server.offload.stats.completed
    for blk in (0, 1):
        assert eng.get_block(0, 0, blk)[:1 << 18] == blocks[blk]
    assert store.server.offload.stats.completed == before + 8
    assert eng.fetches == 2 and store.host_served == 0
    assert eng.get_block(0, 0, 2) is None and eng.hits == 1

    whole = PageStore(page_size=(1 << 18) + 8, num_pages=3)
    eng = PagedKVEngine(whole, block_bytes=1 << 18, hbm_blocks=1)
    assert eng.parts == 1
    for blk, data in enumerate(blocks[:2]):
        eng.put_block(0, 0, blk, data)
    before = whole.server.offload.stats.completed
    with pytest.raises(TimeoutError):
        eng.get_block(0, 0, 0)
    assert whole.server.offload.stats.completed == before
    assert whole.host_served == 1
