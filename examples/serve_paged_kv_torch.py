"""Serving example on the PyTorch port: continuous-batched decode +
DDS-backed KV-block paging.

Two parts:
  1. ``BatchScheduler`` serves a small LM with slot-based continuous
     batching (requests join/leave between decode steps).
  2. ``PagedKVEngine`` demonstrates the DDS integration for long contexts:
     KV blocks spill from the device pool to the page store (HOST path) and
     cold blocks are fetched back through the DPU OFFLOAD path.

Run:  PYTHONPATH=src python examples/serve_paged_kv_torch.py [--device cpu]
      [--no-reduced]   (the card is the default device)
"""

import argparse
import dataclasses
import sys

import numpy as np

sys.path.insert(0, "src")

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import BatchScheduler, PagedKVEngine, Request
from repro_torch.storage.pagestore import PageStore


def continuous_batching(device: torch.device, reduced: bool) -> None:
    cfg = get_config("tinyllama_1p1b")
    if reduced:
        cfg = dataclasses.replace(reduced_config(cfg), num_layers=2,
                                  vocab_size=512)
    api = build_model(cfg, device)
    params, _ = api.init(torch.Generator(device=device).manual_seed(0))
    sched = BatchScheduler(api, params, slots=4, cache_len=64)
    rng = np.random.default_rng(0)
    for rid in range(8):  # 8 requests over 4 slots
        sched.submit(Request(rid, rng.integers(0, cfg.vocab_size, size=4),
                             max_new=6))
    steps = done = 0
    while done < 8 and steps < 200:
        done += sched.step()
        steps += 1
    print(f"continuous batching ({cfg.name}, {device}): 8 requests over 4 "
          f"slots, {steps} decode steps, all done={done == 8}")


def kv_paging() -> None:
    store = PageStore(page_size=4096, num_pages=512)
    engine = PagedKVEngine(store, block_bytes=2048, hbm_blocks=8)
    blob = bytes(range(256)) * 8  # one KV block's bytes
    # A long sequence produces 32 KV blocks; only 8 fit in the pool.
    for blk in range(32):
        engine.put_block(seq=0, layer=0, blk=blk, data=blob)
    print(f"kv paging: spilled {engine.spills} cold blocks to the store "
          f"(host path)")
    # Attention over an old context region: cold blocks come back through
    # the DPU offload path.
    for blk in range(4):
        data = engine.get_block(0, 0, blk)
        assert data is not None and data[:16] == blob[:16]
    print(f"kv paging: fetched {engine.fetches} cold blocks via DPU offload "
          f"(offloaded reads so far: {store.server.offload.stats.completed})")
    engine.get_block(0, 0, 31)   # still resident in the pool
    print(f"kv paging: hot block hit in the pool (hits={engine.hits})")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    args = ap.parse_args()
    continuous_batching(resolve_device(args.device), args.reduced)
    kv_paging()


if __name__ == "__main__":
    main()
