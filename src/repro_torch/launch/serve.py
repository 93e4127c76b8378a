"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> ...``

Stands up the continuous-batching scheduler for an architecture and serves
synthetic requests, reporting decode throughput and the DDS KV-paging
statistics when --paged is set.  Runs on the card unless ``--device cpu``;
``--no-reduced`` serves the architecture at full width.  On the card the
decode step is captured in a CUDA graph and replayed; on the CPU it runs
eagerly; the first line printed says which.  ``qwen2_vl_72b`` serves its
reduced config; at full width its 80 layers (about 145 GB of bf16
weights) fit no one 80 GB card, and there is no depth flag, as in the
reference's launcher (chip_smoke.py serves 24 of them).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import BatchScheduler, PagedKVEngine, Request
from repro_torch.storage.pagestore import PageStore


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="tinyllama_1p1b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--paged", action="store_true",
                    help="demonstrate DDS KV-block paging")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = reduced_config(get_config(args.arch)) if args.reduced else \
        get_config(args.arch)
    api = build_model(cfg, device)
    params, _ = api.init(torch.Generator(device=device).manual_seed(0))
    sched = BatchScheduler(api, params, slots=args.slots,
                           cache_len=args.cache_len)
    print("decode step: " + ("captured in a CUDA graph, replayed every step "
                             f"({device.type})" if device.type == "cuda"
                             else f"eager ({device.type})"))
    rng = np.random.default_rng(0)
    for rid in range(args.requests):
        sched.submit(Request(rid, rng.integers(0, cfg.vocab_size, size=4),
                             max_new=args.max_new))
    t0 = time.time()
    done = steps = 0
    while done < args.requests and steps < 10_000:
        done += sched.step()
        steps += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "CPU")
    toks = args.requests * args.max_new
    print(f"arch={cfg.name}: {args.requests} requests x {args.max_new} "
          f"tokens over {args.slots} slots: {steps} steps, "
          f"{toks / dt:,.0f} tok/s ({where})")

    if args.paged:
        store = PageStore(page_size=4096, num_pages=256)
        eng = PagedKVEngine(store, block_bytes=2048, hbm_blocks=8)
        for blk in range(24):
            eng.put_block(0, 0, blk, bytes(2048))
        for blk in range(4):
            eng.get_block(0, 0, blk)
        print(f"kv paging: spills={eng.spills} offload_fetches={eng.fetches} "
              f"hbm_hits={eng.hits}")


if __name__ == "__main__":
    main()
